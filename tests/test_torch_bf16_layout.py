"""PicoDet (full width, the tree and pages of tests/test_torch_picodet.py)
and the 0/180 PP-LCNet classifier (the tree and images of
tests/test_torch_cls.py) in bf16 against the JAX package's bf16 models on
the CPU: every head held to the yardstick of
tests/test_torch_dtype_policy.py, PicoDet's NMS survivors (the port's
decode and NMS on both sides' heads) and the classes equal up to the first
near-tie, a choice whose margin in JAX's bf16 output is within twice the
measured port-vs-JAX gap. Each runs the port in f32 too, which must fail
the yardstick. The measured gaps print under ``pytest -s``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pdf_table_tpu.models.cls.config import ClsPulcConfig as JClsCfg
from pdf_table_tpu.models.cls.model import PPLCNetClassifier as JCls
from pdf_table_tpu.models.picodet.config import PicoDetConfig as JPicoCfg
from pdf_table_tpu.models.picodet.model import PicoDet as JPicoDet
from pdf_table_tpu_torch.convert.flax_bridge import load_flax_variables
from pdf_table_tpu_torch.models.cls.config import ClsPulcConfig
from pdf_table_tpu_torch.models.cls.model import PPLCNetClassifier
from pdf_table_tpu_torch.models.picodet import processor as tproc
from pdf_table_tpu_torch.models.picodet.config import PicoDetConfig
from pdf_table_tpu_torch.models.picodet.model import PicoDet
from test_torch_cls import TASK, _images, cls_tree
from test_torch_dtype_policy import assert_f32_fails, decided, hold_bf16
from test_torch_picodet import HW, X, picodet_tree

torch.set_num_threads(1)

BF16 = dict(dtype="bfloat16")


def _tree(v):
    return jax.tree.map(jnp.asarray, v)


def test_picodet_bf16_heads_and_nms_match_jax():
    cfg = PicoDetConfig(task_type="en", img_height=HW[0], img_width=HW[1])
    v = picodet_tree(cfg, X)
    jcfg = {d: JPicoCfg(task_type="en", img_height=HW[0], img_width=HW[1],
                        dtype=d) for d in ("float32", "bfloat16")}
    want = {d: JPicoDet(c).apply(_tree(v), jnp.asarray(X))
            for d, c in jcfg.items()}
    nets = {}
    for d in ("bfloat16", "float32"):
        nets[d] = PicoDet(PicoDetConfig(task_type="en", img_height=HW[0],
                                        img_width=HW[1], dtype=d)).eval()
        load_flax_variables(nets[d], v)
    with torch.no_grad():
        got = nets["bfloat16"](torch.from_numpy(X))
        got32 = nets["float32"](torch.from_numpy(X))
    lines, control = [], []
    for k in ("scores", "boxes"):
        for g, g32, j16, j32 in zip(got[k], got32[k], want["bfloat16"][k],
                                    want["float32"][k]):
            assert g.dtype == torch.float32
            lines.append(hold_bf16(g.numpy(), j16, j32))
            control.append((g32.numpy(), j16, j32))
    assert_f32_fails(control)
    # the port's decode + NMS on both sides' bf16 heads
    raw = {k: [torch.from_numpy(np.array(a)) for a in want["bfloat16"][k]]
           for k in got}
    cfg16 = PicoDetConfig(task_type="en", img_height=HW[0], img_width=HW[1],
                          score_threshold=0.05, **BF16)
    packs = []
    for heads in (got, raw):
        b, s = tproc._decode_topk(heads, cfg16)
        packs.append(tproc.device_nms_pack(b, s, cfg16).numpy())
    gap = max(float(np.abs(g.numpy() - np.asarray(j)).max())
              for g, j in zip(got["scores"], want["bfloat16"]["scores"]))
    compared = 0
    for mine, ref in zip(packs[0].reshape(-1, *packs[0].shape[-2:]),
                         packs[1].reshape(-1, *packs[1].shape[-2:])):
        # survivors in score order up to the first near-tie: a score
        # within 2 x gap of the threshold or of the next survivor's
        s = ref[:, 4]
        n = int((s > 0).sum())
        close = np.flatnonzero((s[:n] <= cfg16.score_threshold + 2 * gap)
                               | (np.abs(np.diff(s[:n + 1])) <= 2 * gap))
        t = int(close[0]) if len(close) else n
        np.testing.assert_allclose(mine[:t, 4], s[:t], rtol=0, atol=gap)
        np.testing.assert_allclose(mine[:t, :4], ref[:t, :4], rtol=0,
                                   atol=2.0 * HW[0] * gap)
        compared += t
    assert compared, "no survivors to compare"
    print(f"\nPicoDet ({compared} survivors compared):", *lines,
          sep="\n  ")


def test_cls_bf16_probs_match_jax():
    cfg = ClsPulcConfig.for_task(TASK)
    v = cls_tree(cfg)
    x = _images(2)
    want = {d: np.asarray(JCls(JClsCfg.for_task(TASK, dtype=d)).apply(
        v, jnp.asarray(x))) for d in ("float32", "bfloat16")}
    nets = {}
    for d in ("bfloat16", "float32"):
        nets[d] = PPLCNetClassifier(ClsPulcConfig.for_task(TASK,
                                                          dtype=d)).eval()
        load_flax_variables(nets[d], v)
    with torch.no_grad():
        got = nets["bfloat16"](torch.from_numpy(x)).numpy()
        got32 = nets["float32"](torch.from_numpy(x)).numpy()
    line = hold_bf16(got, want["bfloat16"], want["float32"])
    assert_f32_fails([(got32, want["bfloat16"], want["float32"])])
    gap = float(np.abs(got - want["bfloat16"]).max())
    ok = decided(want["bfloat16"], 2.0 * gap)
    np.testing.assert_array_equal(got.argmax(-1)[ok],
                                  want["bfloat16"].argmax(-1)[ok])
    print(f"\nPP-LCNet: {line}")
