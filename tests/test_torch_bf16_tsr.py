"""The table-structure models in bf16 (SLANet, TableMaster, MtlTabNet,
LGPMA) against the JAX package's bf16 models on the trees and inputs of
their f32 tests (tests/test_torch_slanet.py, tests/test_torch_table_master.py
and tests/test_torch_lgpma.py at their tiny configs), on the CPU. The bf16
head of each (SLANet's neck map and TableMaster's encoder map, whose f32
decoders are unchanged; LGPMA's outputs) is held to the yardstick of
tests/test_torch_dtype_policy.py; the decisions are equal up to the first
near-tie, a choice whose margin in JAX's bf16 output is within twice the
measured port-vs-JAX gap: the greedy structure tokens, LGPMA's cells. Each
runs the port in f32 too, which must fail the yardstick; TableMaster's
encoder is held block by block as tests/test_torch_dtype_policy.py says.
The measured gaps print under ``pytest -s``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import pdf_table_tpu.tasks.table_structure as jts
from pdf_table_tpu.models.lgpma import LGPMA as JLGPMA
from pdf_table_tpu.models.lgpma import LgpmaConfig as JLgpmaConfig
from pdf_table_tpu.models.slanet import SLANet as JSLANet
from pdf_table_tpu.models.slanet import SLANetConfig as JSLANetConfig
from pdf_table_tpu.models.table_master import TableMaster as JTableMaster
from pdf_table_tpu.models.table_master import TableMasterConfig as JTMConfig
from pdf_table_tpu_torch.convert.flax_bridge import load_flax_variables
from pdf_table_tpu_torch.models.lgpma.config import LgpmaConfig
from pdf_table_tpu_torch.models.lgpma.model import LGPMA
from pdf_table_tpu_torch.models.slanet.config import SLANetConfig
from pdf_table_tpu_torch.models.slanet.model import SLANet
from pdf_table_tpu_torch.models.table_master.config import TableMasterConfig
from pdf_table_tpu_torch.models.table_master.model import TableMaster
from pdf_table_tpu_torch.tasks.table_structure import OcrTableStructureTask
from test_torch_dtype_policy import (INDEPENDENT, assert_f32_fails, decided,
                                     hold_bf16)
from test_torch_lgpma import REGIONS, _page, _same_cells
from test_torch_lgpma import TINY as LGPMA_TINY
from test_torch_lgpma import setup  # noqa: F401
from test_torch_slanet import TINY as SLANET_TINY
from test_torch_slanet import slanet_tree
from test_torch_table_master import (MTL_TINY, jax_positions,  # noqa: F401
                                     master_tree)
from test_torch_table_master import TINY as MASTER_TINY

torch.set_num_threads(1)

BF16 = dict(dtype="bfloat16")
DTYPES = ("bfloat16", "float32")
# TableMaster's encoder blocks in the order they run ("P": a 2x2 max pool)
MASTER_BLOCKS = ("c1", "c2", "P", "layer1_0", "c3", "P", "layer2_0",
                 "layer2_1", "c4", "P", *(f"layer3_{i}" for i in range(5)),
                 "c5", *(f"layer4_{i}" for i in range(3)), "c6")
# each block fed JAX's bf16 input: the least share of its output equal to
# JAX's bf16 output bit for bit (measured 0.897, layer3_4, where one
# flipped rounding among the 16 values of a context block's channel-add
# moves whole channels; every other block 0.999 or more; the port in f32
# 0.534 at the most)
BLOCK_EQUAL_MIN = 0.75


def _tree(v):
    return jax.tree.map(jnp.asarray, v)


def assert_tokens_equal(got, want, gap):
    """Greedy tokens (B, T, V probabilities) equal up to each crop's first
    step where they differ, and that step is a near-tie in JAX's bf16
    probabilities (top-1 ahead of top-2 by at most ``2 * gap``)."""
    gi, wi = got.argmax(-1), want.argmax(-1)
    for b in range(len(gi)):
        diff = np.flatnonzero(gi[b] != wi[b])
        if len(diff):
            t = diff[0]
            assert not decided(want[b, t], 2.0 * gap), (b, t)


def _nets(cls, cfg_cls, v, **kw):
    """The port's model in bf16 and in f32 on the flax tree ``v``."""
    nets = {}
    for d in DTYPES:
        nets[d] = cls(cfg_cls(**kw, dtype=d)).eval()
        load_flax_variables(nets[d], v)
    return nets


def _inputs(hw, n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, *hw, 3)).astype(np.float32)


def test_slanet_bf16_matches_jax():
    x = _inputs((64, 64), 3, seed=0)
    v = slanet_tree(SLANetConfig(**SLANET_TINY), x)
    want = {d: {k: np.asarray(a) for k, a in JSLANet(JSLANetConfig(
        **SLANET_TINY, dtype=d)).apply(_tree(v), jnp.asarray(x),
                                       train=False).items()}
            for d in ("float32", "bfloat16")}
    jmem = {d: _jax_memory(JSLANet(JSLANetConfig(**SLANET_TINY, dtype=d)),
                           v, x, ("neck",)) for d in ("float32", "bfloat16")}
    nets = _nets(SLANet, SLANetConfig, v, **SLANET_TINY)
    net = nets["bfloat16"]
    with torch.no_grad():
        mem = net.encode(torch.from_numpy(x))
        got = {k: a.numpy() for k, a in net.head(mem).items()}
        mem32 = nets["float32"].encode(torch.from_numpy(x))
    assert mem.dtype == torch.float32
    line = hold_bf16(mem.permute(0, 2, 3, 1).numpy(), jmem["bfloat16"],
                     jmem["float32"])
    assert_f32_fails([(mem32.permute(0, 2, 3, 1).numpy(), jmem["bfloat16"],
                       jmem["float32"])])
    _hold_tokens("SLANet", got, want, line)


def _hold_tokens(name, got, want, mem_lines):
    """The tokens to a near-tie, at the gap of the probabilities up to
    the first step where the greedy decodes part (after it they decode
    other inputs)."""
    p16 = want["bfloat16"]["structure_probs"]
    g = got["structure_probs"]
    same = g.argmax(-1) == p16.argmax(-1)
    t = int(np.argmin(np.concatenate([same.all(0), [False]])))
    assert t >= 1, "the first tokens differ"
    gap = float(np.abs(g[:, :t] - p16[:, :t]).max())
    assert_tokens_equal(g, p16, gap)
    print(f"\n{name}: memory {mem_lines}; probabilities of the first {t} "
          f"steps off by {gap:.3e}")


def _jax_blocks(module, v, x):
    """JAX's TableMaster encoder blocks' outputs (in f32) by name."""
    _, st = module.apply(_tree(v), jnp.asarray(x), train=False,
                         capture_intermediates=True,
                         mutable=["intermediates"])
    enc = st["intermediates"]["encoder"]
    return {k: np.asarray(jnp.asarray(enc[k]["__call__"][0])
                          .astype(jnp.float32))
            for k in MASTER_BLOCKS if k != "P"}


def _block_shares(encoder, blocks, x):
    """Each block of the port's ``encoder`` fed JAX's bf16 input (the
    model input, or the previous block's output, max-pooled where the
    encoder pools): the share of its output equal to JAX's ``blocks``."""
    prev = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    dtype = encoder.c1.conv.weight.dtype
    shares = {}
    for name in MASTER_BLOCKS:
        if name == "P":
            prev = F.max_pool2d(prev, 2)
            continue
        with torch.no_grad():
            out = getattr(encoder, name)(prev.to(dtype)).float()
        shares[name] = float((out.permute(0, 2, 3, 1).numpy()
                              == blocks[name]).mean())
        prev = torch.from_numpy(blocks[name]).permute(0, 3, 1, 2).to(
            torch.bfloat16)
    return shares


def _jax_memory(module, v, x, encoder):
    """JAX's encoder output (the bf16 head of a token model, before the
    f32 decoder) per dtype."""
    _, st = module.apply(_tree(v), jnp.asarray(x), train=False,
                         capture_intermediates=True,
                         mutable=["intermediates"])
    out = st["intermediates"]
    for k in encoder:
        out = out[k]
    out = out["__call__"][0]
    return np.asarray(jnp.asarray(out[-1] if isinstance(out, tuple)
                                  else out).astype(jnp.float32))


@pytest.mark.parametrize("kw", [MASTER_TINY, MTL_TINY],
                         ids=["TableMaster", "MtlTabNet"])
def test_table_master_bf16_matches_jax(kw):
    x = _inputs((64, 64), 2, seed=1)
    v = master_tree(TableMasterConfig(**kw), x)
    want = {d: {k: np.asarray(a) for k, a in JTableMaster(JTMConfig(
        **kw, dtype=d)).apply(_tree(v), jnp.asarray(x), train=False).items()}
            for d in ("float32", "bfloat16")}
    jmem = {d: _jax_memory(JTableMaster(JTMConfig(**kw, dtype=d)), v, x,
                           ("encoder",)) for d in ("float32", "bfloat16")}
    nets = _nets(TableMaster, TableMasterConfig, v, **kw)
    net = nets["bfloat16"]
    nhwc = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        feat = net.encoder(nhwc.to(torch.bfloat16))
        mem = net.memory(torch.from_numpy(x))
        got = {k: a.numpy() for k, a in net.decode(mem).items()}
        feat32 = nets["float32"].encoder(nhwc)
    assert feat.dtype == torch.bfloat16 and mem.dtype == torch.float32
    # the encoder's summation order flips roundings that spread: its blocks
    # bit for bit on JAX's inputs, the whole at independent round-off
    line = hold_bf16(feat.float().permute(0, 2, 3, 1).numpy(),
                     jmem["bfloat16"], jmem["float32"], factor=INDEPENDENT)
    assert_f32_fails([(feat32.permute(0, 2, 3, 1).numpy(), jmem["bfloat16"],
                       jmem["float32"])], factor=INDEPENDENT)
    blocks = _jax_blocks(JTableMaster(JTMConfig(**kw, dtype="bfloat16")), v,
                         x)
    shares = {d: _block_shares(n.encoder, blocks, x)
              for d, n in nets.items()}
    assert min(shares["bfloat16"].values()) >= BLOCK_EQUAL_MIN, shares
    assert max(shares["float32"].values()) < BLOCK_EQUAL_MIN, shares
    line += (f"; blocks on JAX's inputs equal on at least "
             f"{min(shares['bfloat16'].values()):.4f} (f32 at most "
             f"{max(shares['float32'].values()):.4f})")
    _hold_tokens(kw.get("variant", "table_master"), got, want, line)


def test_lgpma_bf16_matches_jax(setup, monkeypatch):
    _, _, v, _, x, _ = setup
    outs = ("cls_probs", "det_boxes", "lpma_masks", "gpma_seg", "gpma_reg")
    want = {d: JLGPMA(JLgpmaConfig(**LGPMA_TINY, dtype=d)).apply(
        v, x, train=False) for d in ("float32", "bfloat16")}
    nets = _nets(LGPMA, LgpmaConfig, v, **LGPMA_TINY)
    with torch.no_grad():
        got = nets["bfloat16"](torch.from_numpy(x))
        got32 = nets["float32"](torch.from_numpy(x))
    same_props = np.array_equal(got["proposals"].numpy(),
                                np.asarray(want["bfloat16"]["proposals"]))
    lines, control = [], []
    for k in outs:
        if k in ("cls_probs", "det_boxes", "lpma_masks") and not same_props:
            continue
        assert got[k].dtype == torch.float32
        j16, j32 = (np.asarray(want[d][k]) for d in ("bfloat16", "float32"))
        lines.append(f"{k}: " + hold_bf16(got[k].numpy(), j16, j32))
        if k in ("gpma_seg", "gpma_reg"):
            control.append((got32[k].numpy(), j16, j32))
    assert_f32_fails(control)
    # the task on the first region: the same cells as JAX's bf16 task
    monkeypatch.setattr(jts, "load_or_init",
                        lambda *a, **k: jax.tree.map(np.asarray, v))
    jtask = jts.OcrTableStructureTask(
        model="Lgpma", config=JLgpmaConfig(**LGPMA_TINY, dtype="bfloat16"))
    ttask = OcrTableStructureTask(
        model="Lgpma", device="cpu", variables=v,
        config=LgpmaConfig(**LGPMA_TINY, **BF16))
    _, (x1, y1, x2, y2) = REGIONS[0]
    crop = np.ascontiguousarray(_page()[y1:y2, x1:x2])
    # the cell boxes within the bf16 box gap (in px of the model input)
    box_gap = float(np.abs(got["det_boxes"].numpy() - np.asarray(
        want["bfloat16"]["det_boxes"])).max())
    _same_cells(ttask(crop), jtask(crop), 2.0 * max(box_gap, 1e-3))
    print(f"\nLGPMA (proposals equal: {same_props}):", *lines, sep="\n  ")
