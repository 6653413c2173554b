"""TableMaster and MtlTabNet in the port against the JAX package on the
CPU, on the same flax tree: the vocab (V = 43) and alphabets, the
post-processor, the model at ``tiny_cfg`` of tests/test_table_master.py
(64x64, D 32, 4 heads, ff 64, N 1) and at full width (480x480, D 512, 8
heads, ff 2024, N 3) with T 8.

The MtlTabNet cell branch and the task's paths are in
tests/test_torch_table_master_task.py.

The trees: ``init_table_master`` with BatchNorm statistics calibrated on
the inputs and every variance then times VAR_GAIN
(``scale_batch_variances``): calibrated as is, the random residual
encoder amplifies f32 rounding to 1e-4 of its output (1e-5 at 480x480
with the variances doubled, 4e-6 at 4x); the class generator's matrix times MASTER_GAIN
(tests/test_torch_slanet.py says why a gain; at SLANet's 30 the
full-width encoder's few 1e-6 from XLA's reach 1.4e-5 of a probability,
at 10 they stay under 1e-5) and its bias at <UKN>, <SOS> and
<PAD> lowered by SPECIAL_BIAS (random weights otherwise emit <SOS>, which
the post-processor skips, at every step). Tolerances as there:
teacher-forced probabilities and locs within 1e-5, greedy ids up to the
first near-tie.

The positional table differs from JAX's by the last bit of ``exp``
(``div``, within 1 ulp; XLA's and torch's exp round differently), which
the positions of the 60x60 memory at full width carry to some 1e-4 of a
sin/cos; ``test_positions_match_jax`` holds that, and the model tests
give the port JAX's table (``jax_positions``), so that they hold the rest
of the arithmetic to 1e-5 (ROADMAP.md, recorded differences)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdf_table_tpu.models.table_master import \
    MasterStructureVocab as JVocab
from pdf_table_tpu.models.table_master import TableMaster as JTableMaster
from pdf_table_tpu.models.table_master import \
    TableMasterConfig as JConfig
from pdf_table_tpu.models.table_master import \
    TableMasterPostProcessor as JPost
from pdf_table_tpu.models.table_master import \
    load_pubtabnet_structure_alphabet as j_structure_alphabet
from pdf_table_tpu.models.table_master import \
    load_pubtabnet_textline_alphabet as j_textline_alphabet
from pdf_table_tpu_torch.convert.flax_bridge import (load_flax_variables,
                                                     tree_leaves)
from pdf_table_tpu_torch.engine.params import (calibrate_batch_stats,
                                               init_table_master,
                                               scale_batch_variances)
from pdf_table_tpu_torch.models.table_master.config import \
    TableMasterConfig
from pdf_table_tpu_torch.models.table_master import model as tm_model
from pdf_table_tpu_torch.models.table_master.model import (
    TableMaster, interleaved_positions)
from pdf_table_tpu_torch.models.table_master.processor import \
    TableMasterPostProcessor
from pdf_table_tpu_torch.models.table_master.vocab import (
    MasterStructureVocab, load_pubtabnet_structure_alphabet,
    load_pubtabnet_textline_alphabet)
from test_torch_slanet import TOL, assert_greedy_equal

torch.set_num_threads(1)

TINY = dict(img_size=(64, 64), d_model=32, decoder_layers=1, heads=4,
            ff_dim=64, max_structure_len=6)
FULL = dict(max_structure_len=8)
MTL_TINY = dict(TINY, variant="mtl_tabnet", decoder_layers=2,
                cell_vocab_size=281, cell_slots=3, max_cell_len=5)
SPECIAL_BIAS = -100.0
MASTER_GAIN = 10.0
VAR_GAIN = 4.0
POS_TOL = 2e-4          # the table at 3600 positions, from exp's last bit


@pytest.fixture(autouse=True)
def jax_positions(request, monkeypatch):
    """The port's model takes JAX's positional table (not in
    ``test_positions_match_jax``)."""
    if request.node.name.startswith("test_positions"):
        return
    from pdf_table_tpu.models.table_master.model import \
        interleaved_positions as j_positions

    monkeypatch.setattr(
        tm_model, "interleaved_positions",
        lambda n, d, device=None: torch.from_numpy(
            np.asarray(j_positions(n, d))).to(device))


def master_tree(cfg: TableMasterConfig, x: np.ndarray, seed: int = 0):
    """Seeded, statistics calibrated on ``x`` with the variances times
    VAR_GAIN, the class logits spread by MASTER_GAIN, the specials but <EOS>
    lowered."""
    model = TableMaster(cfg)
    model.forward = model.memory
    tree = scale_batch_variances(calibrate_batch_stats(
        model, init_table_master(cfg, seed), torch.from_numpy(x)), VAR_GAIN)
    tree["params"]["fc_cls"] *= MASTER_GAIN
    v = MasterStructureVocab()
    tree["params"]["fc_cls_b"][[v.unknown_id, v.sos_id, v.pad_id]] = \
        SPECIAL_BIAS
    return tree


def _inputs(hw, n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, *hw, 3)).astype(np.float32)


def _port(cfg, tree, x, **kw):
    model = TableMaster(cfg).eval()
    load_flax_variables(model, tree)
    with torch.no_grad():
        out = model(torch.from_numpy(x), **kw)
    return {k: v.numpy() if torch.is_tensor(v) else v
            for k, v in out.items()}


def _jax(kw, tree, x, **call):
    out = JTableMaster(JConfig(**kw)).apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x), train=False,
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in call.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def test_vocab_and_alphabets_match_jax():
    v, jv = MasterStructureVocab(), JVocab()
    assert v.tokens == jv.tokens and len(v) == 43
    assert (v.unknown_id, v.sos_id, v.eos_id, v.pad_id) == \
        (jv.unknown_id, jv.sos_id, jv.eos_id, jv.pad_id) == (39, 40, 41, 42)
    assert v.ignored_ids == jv.ignored_ids
    assert all(v.is_td(t) == jv.is_td(t) for t in v.tokens + ["<td>"])
    rng = np.random.default_rng(0)
    for _ in range(20):
        ids = rng.integers(0, len(v), 12).tolist()
        assert v.decode(ids) == jv.decode(ids)
    assert load_pubtabnet_structure_alphabet() == \
        j_structure_alphabet()
    assert load_pubtabnet_textline_alphabet() == j_textline_alphabet()
    assert len(load_pubtabnet_textline_alphabet()) + 4 == 281


def test_positions_match_jax():
    """``div`` within an ulp of JAX's; sin/cos of the same arguments within
    2e-7; the tables within POS_TOL (the ulp times up to 3600 positions)."""
    import math

    from pdf_table_tpu.models.table_master.model import \
        interleaved_positions as j_positions

    for n, d in ((501, 512), (3600, 512), (7, 32)):
        arg = torch.arange(0, d, 2, dtype=torch.float32) \
            * (-math.log(10000.0) / d)
        np.testing.assert_array_max_ulp(
            torch.exp(arg).numpy(), np.asarray(jnp.exp(arg.numpy())), 1)
        x = torch.arange(n, dtype=torch.float32)[:, None] * torch.exp(arg)
        np.testing.assert_allclose(torch.sin(x).numpy(),
                                   np.asarray(jnp.sin(x.numpy())),
                                   atol=2e-7, rtol=0)
        np.testing.assert_allclose(interleaved_positions(n, d).numpy(),
                                   np.asarray(j_positions(n, d)),
                                   atol=POS_TOL, rtol=0)


def test_postprocessor_matches_jax():
    v = MasterStructureVocab()
    rng = np.random.default_rng(1)
    shapes = [(128, 128, 0.5, 0.5, 64, 64), (300, 200, 1.6, 1.6, 480, 480),
              (90, 400, 1.2, 1.2, 0, 0)]
    charset = load_pubtabnet_textline_alphabet()
    for i in range(8):
        T = 12
        probs = rng.random((T, len(v))).astype(np.float32)
        probs[rng.integers(1, T), v.eos_id] = 5.0
        probs[:, v.token_to_id["<td></td>"]] += 0.6
        locs = rng.random((T, 4)).astype(np.float32)
        raw = {"structure_probs": probs[None], "loc_preds": locs[None]}
        if i % 2:
            raw.update(cell_ids=rng.integers(0, 281, (1, 3, 5)),
                       cell_valid=np.array([[True, True, i % 4 == 1]]),
                       cell_eos_id=279)
        meta = {"shape_list": shapes[i % 3]}
        cfg = TableMasterConfig(**TINY)
        got = TableMasterPostProcessor(cfg, cell_charset=charset)(raw, meta)
        want = JPost(JConfig(**TINY), cell_charset=charset)(raw, meta)
        assert got == want


@pytest.mark.parametrize("kw,hw", [(TINY, (64, 64)), (FULL, (480, 480)),
                                   (MTL_TINY, (64, 64))],
                         ids=["tiny", "full_width", "mtl_tabnet"])
def test_tree_matches_flax_init(kw, hw):
    x = jnp.zeros((1, *hw, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: JTableMaster(JConfig(**kw)).init(
        jax.random.PRNGKey(0), x))
    want = {p: tuple(a.shape) for p, a in tree_leaves(shapes)}
    got = {p: np.shape(a) for p, a in
           tree_leaves(init_table_master(TableMasterConfig(**kw)))}
    assert got == want
    assert ("params", "mem_proj", "kernel") in got or kw is FULL


def test_tiny_teacher_forced_matches_flax():
    cfg = TableMasterConfig(**TINY)
    x = _inputs((64, 64), 3)
    tree = master_tree(cfg, x)
    teacher = np.random.default_rng(5).integers(0, 43, (3, 6))
    got = _port(cfg, tree, x, teacher_tokens=torch.from_numpy(teacher))
    want = _jax(TINY, tree, x, teacher_tokens=teacher)
    for k in ("structure_probs", "loc_preds"):
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0,
                                   err_msg=k)


def test_tiny_greedy_matches_flax():
    cfg = TableMasterConfig(**dict(TINY, decoder_layers=3,
                                   max_structure_len=12))
    x = _inputs((64, 64), 3, seed=1)
    tree = master_tree(cfg, x)
    got = _port(cfg, tree, x)
    want = _jax(dict(TINY, decoder_layers=3, max_structure_len=12), tree, x)
    assert_greedy_equal(got, want, min_prefix=4)


@pytest.fixture(scope="module")
def full_width():
    """One crop at 480x480 through both models, teacher-forced and
    greedy."""
    cfg = TableMasterConfig(**FULL)
    x = _inputs((480, 480), 1, seed=2)
    # statistics of the same noise at a quarter of the pixels: one
    # full-width forward less
    tree = master_tree(cfg, x[:, :240, :240])
    teacher = np.random.default_rng(6).integers(0, 43, (1, 8))
    model = TableMaster(cfg).eval()
    load_flax_variables(model, tree)
    with torch.no_grad():
        mem = model.memory(torch.from_numpy(x))
        got = {k: {n: v.numpy() for n, v in out.items()} for k, out in (
            ("teacher", model.decode(mem, torch.from_numpy(teacher))),
            ("greedy", model.decode(mem)))}
    jm = JTableMaster(JConfig(**FULL))
    jv = jax.tree.map(jnp.asarray, tree)

    @jax.jit
    def both(v, xx, tt):
        return (jm.apply(v, xx, train=False, teacher_tokens=tt),
                jm.apply(v, xx, train=False))

    t_out, g_out = both(jv, jnp.asarray(x), jnp.asarray(teacher))
    want = {"teacher": {k: np.asarray(v) for k, v in t_out.items()},
            "greedy": {k: np.asarray(v) for k, v in g_out.items()}}
    return got, want


def test_full_width_teacher_forced_matches_flax(full_width):
    got, want = full_width
    for k in ("structure_probs", "loc_preds"):
        assert got["teacher"][k].shape == want["teacher"][k].shape
        np.testing.assert_allclose(got["teacher"][k], want["teacher"][k],
                                   atol=TOL, rtol=0, err_msg=k)


def test_full_width_greedy_matches_flax(full_width):
    got, want = full_width
    assert got["greedy"]["structure_probs"].shape == (1, 8, 43)
    assert_greedy_equal(got["greedy"], want["greedy"], min_prefix=2)
