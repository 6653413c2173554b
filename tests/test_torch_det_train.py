"""The DBNet quick trainer and the CTC loss of the port against the JAX
package on the CPU: ``make_db_targets`` bit for bit, each loss and its
gradient against ``jax.value_and_grad``, and ``train_quick_detector``
(PP-OCRv4 det at 64 px, batch 2) from JAX's own initial tree: its first
step's gradient, params and statistics, three steps' losses, the
optimizer against optax. BatchNorm's batch mode and DBNet's training
heads are held in tests/test_torch_dbnet_train_heads.py.

Tolerances, relative to each output's (each leaf's) largest magnitude:
- the DB loss pieces 1e-6, their gradients 1e-5;
- ``ctc_loss`` 1e-5 on feasible alignments, its gradients 1e-4;
- the trainer's first loss 1e-5; its three steps' losses in float64
  within 1e-6 of JAX's in float64, the last f32 loss within 1e-5 of JAX's
  float64 or no farther from it than JAX's f32 (test_quick_trainer_
  matches_jax says why), and 1e-3 from JAX's f32;
- one step's gradients 1e-4, its statistics 1e-5, its params 1e-4 where
  the gradient is well above round-off: each held by ``_held`` against
  JAX in float64 (``jax.enable_x64``, the config's dtype float64), with
  the port in float64 within 1e-6 of it (gradients, statistics; one
  step's update within 1e-5 of lr, ``F64_STEP_TOL`` says why), so that the
  yardstick owes nothing to the port.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pdf_table_tpu.data.det_targets import make_db_targets as jtargets
from pdf_table_tpu.engine.params import init_params as jinit_params
from pdf_table_tpu.models.dbnet import DBNet as JDBNet
from pdf_table_tpu.models.dbnet.config import DbNetConfig as JDbNetConfig
from pdf_table_tpu.models.rec_ctc.config import RecConfig as JRecConfig
from pdf_table_tpu.models.rec_ctc.model import CTCRecModel as JCTCRecModel
from pdf_table_tpu.train import losses as jlosses
from pdf_table_tpu.train import quick_det as jquick
from pdf_table_tpu_torch.convert.flax_bridge import (load_flax_variables,
                                                     model_variables,
                                                     state_dict_to_flax,
                                                     transposed_modules,
                                                     tree_leaves)
from pdf_table_tpu_torch.data.det_targets import make_db_targets
from pdf_table_tpu_torch.engine.params import scale_batch_variances
from pdf_table_tpu_torch.models.dbnet.config import DbNetConfig
from pdf_table_tpu_torch.models.dbnet.model import DBNet, inference_variables
from pdf_table_tpu_torch.models.rec_ctc.config import RecConfig
from pdf_table_tpu_torch.models.rec_ctc.model import CTCRecModel
from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask
from pdf_table_tpu_torch.train import losses
from pdf_table_tpu_torch.train import quick_det
from pdf_table_tpu_torch.train.optim import ClipAdamW, constant_schedule
from pdf_table_tpu_torch.train.train_step import TrainState, make_train_step
from test_torch_rec_model import VARIANTS, _crops, rec_tree

torch.set_num_threads(1)

LOSS_TOL = 1e-6
LOSS_GRAD_TOL = 1e-5
CTC_TOL = 1e-5
CTC_GRAD_TOL = 1e-4
# the port in float64 against JAX in float64 (the models round their
# outputs to f32 on both sides): gradients, statistics and forwards of each
# leaf's scale; the losses relative; one step's update of lr. The port's
# optimizer keeps its moments and bias corrections in f32 whatever the
# params' dtype, as optax does for f32 params: 1 - 0.999 in f32 is 1.3e-5
# off, so every update is 6.4e-6 of lr off JAX's in float64
F64_TOL = 1e-6
F64_LOSS_TOL = 1e-6
F64_STEP_TOL = 1e-5
FWD_TOL = 1e-5
STATS_TOL = 1e-5
STEP_LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
GRAD_TOL = 1e-4
# the port in float64 against JAX in float64 (the models round their
# outputs to f32 on both sides): gradients, statistics and forwards of each
# leaf's scale; the losses relative; one step's update of lr. The port's
# optimizer keeps its moments and bias corrections in f32 whatever the
# params' dtype, as optax does for f32 params: 1 - 0.999 in f32 is 1.3e-5
# off, so every update is 6.4e-6 of lr off JAX's in float64
F64_TOL = 1e-6
F64_LOSS_TOL = 1e-6
F64_STEP_TOL = 1e-5


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max()) / scale
    assert err < tol, (what, err)


def _held(got, exact, want, truth, tol, scale, what, f64_tol=None,
          spread=1.0):
    """The port against JAX in float64 and in f32. ``exact`` (the port in
    float64) within ``f64_tol * scale`` of ``truth`` (JAX in float64,
    ``jax.enable_x64``): a fault in the port's model shows there, where
    round-off does not. ``got`` (the port's f32) within ``tol * scale`` of
    ``truth``, or within ``spread`` times ``want``'s (JAX's f32) distance
    from it: the random trees here are ill-conditioned in f32, and the
    bound is JAX's own distance, whatever the port does."""
    f64_tol = F64_TOL if f64_tol is None else f64_tol
    e64 = float(np.abs(exact - truth).max())
    assert e64 <= f64_tol * scale, (what, "float64", e64 / scale)
    bound = max(tol * scale,
                spread * float(np.abs(want - truth).max()))
    e32 = float(np.abs(got - truth).max())
    assert e32 <= bound, (what, "f32", e32 / scale, bound / scale)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32)).requires_grad_(True)


# -- targets ------------------------------------------------------------------


def _boxes(seed, kind):
    rng = np.random.default_rng(seed)
    n = 12
    x1 = rng.uniform(-10, 60, n)
    y1 = rng.uniform(-10, 50, n)
    w = rng.uniform(0.5, 30, n)
    h = rng.uniform(0.5, 12, n)
    if kind == "degenerate":
        w[::3] = rng.uniform(0, 2, len(w[::3]))     # w < 2: skipped
        h[1::4] = 1.5
    elif kind == "inside":
        x1, y1 = np.abs(x1) % 30, np.abs(y1) % 20
    return np.stack([x1, y1, x1 + w, y1 + h], 1)


@pytest.mark.parametrize("kind", ["inside", "off_map", "degenerate"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_db_targets_bit_equal(kind, seed):
    boxes = _boxes(seed, kind)
    for hw in ((48, 64), (64, 64)):
        got, want = make_db_targets(boxes, hw), jtargets(boxes, hw)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert make_db_targets(boxes, (64, 64))["gt"].any()


# -- the DB loss --------------------------------------------------------------


def _db_inputs(seed, pos_frac):
    rng = np.random.default_rng(seed)
    shape = (2, 24, 20)
    gt = (rng.random(shape) < pos_frac).astype(np.float32)
    return {"prob": rng.uniform(0.01, 0.99, shape).astype(np.float32),
            "thresh": rng.uniform(0.2, 0.8, shape).astype(np.float32),
            "binary": rng.uniform(0.01, 0.99, shape).astype(np.float32),
            "gt": gt,
            "gt_mask": (rng.random(shape) > 0.1).astype(np.float32),
            "thresh_map": rng.uniform(0.3, 0.7, shape).astype(np.float32),
            "thresh_mask": (rng.random(shape) > 0.5).astype(np.float32)}


PIECES = {
    "balanced_bce": (("prob", "gt", "gt_mask"), "balanced_bce"),
    "dice_loss": (("binary", "gt", "gt_mask"), "dice_loss"),
    "masked_l1": (("thresh", "thresh_map", "thresh_mask"), "masked_l1"),
}


# pos_frac 0.1: the negatives capped at 3 x n_pos; 0.4: all of them kept;
# 0.0: no positive, so no negative either
@pytest.mark.parametrize("pos_frac", [0.1, 0.4, 0.0])
@pytest.mark.parametrize("piece", list(PIECES))
def test_db_loss_pieces_match(piece, pos_frac):
    d = _db_inputs(3, pos_frac)
    keys, name = PIECES[piece]
    pred = _t(d[keys[0]])
    got = getattr(losses, name)(pred, *[torch.from_numpy(d[k])
                                        for k in keys[1:]])
    (g,) = torch.autograd.grad(got, [pred])
    want, wg = jax.value_and_grad(
        lambda p: getattr(jlosses, name)(p, *[d[k] for k in keys[1:]]))(
        jnp.asarray(d[keys[0]]))
    _close(float(got), float(want), LOSS_TOL, piece)
    _close(g.numpy(), np.asarray(wg), LOSS_GRAD_TOL, piece)


@pytest.mark.parametrize("pos_frac", [0.1, 0.4])
def test_db_loss_matches(pos_frac):
    d = _db_inputs(4, pos_frac)
    outs = {k: _t(d[k]) for k in ("prob", "thresh", "binary")}
    batch = {k: torch.from_numpy(d[k]) for k in
             ("gt", "gt_mask", "thresh_map", "thresh_mask")}
    got = losses.db_loss(outs, batch)
    grads = torch.autograd.grad(got["loss"], list(outs.values()))

    def jloss(o):
        r = jlosses.db_loss(o, {k: d[k] for k in batch})
        return r["loss"], r

    (_, want), wg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(d[k]) for k in outs})
    for k in ("loss", "bce", "l1", "dice"):
        _close(float(got[k]), float(want[k]), LOSS_TOL, k)
    for k, g in zip(outs, grads):
        _close(g.numpy(), np.asarray(wg[k]), LOSS_GRAD_TOL, k)


# -- the CTC loss -------------------------------------------------------------


def _ctc_case(seed, B=4, T=20, C=12, S=6):
    """Feasible labels: lengths 1..S, repeats included, padded with 0."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (B, T, C)).astype(np.float32)
    labels = np.zeros((B, S), np.int32)
    pads = np.ones((B, S), np.float32)
    for b in range(B):
        n = 1 + b % S
        lab = rng.integers(1, C, n)
        if n > 2:
            lab[1] = lab[0]             # a repeat: needs a blank between
        labels[b, :n] = lab
        pads[b, :n] = 0.0
    return logits, labels, pads


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_loss_matches(seed):
    logits, labels, pads = _ctc_case(seed)
    x = _t(logits)
    got = losses.ctc_loss(x, torch.from_numpy(labels),
                          torch.from_numpy(pads))
    (g,) = torch.autograd.grad(got, [x])
    want, wg = jax.value_and_grad(
        lambda lg: jlosses.ctc_loss(lg, jnp.asarray(labels),
                                    jnp.asarray(pads)))(jnp.asarray(logits))
    _close(float(got), float(want), CTC_TOL)
    _close(g.numpy(), np.asarray(wg), CTC_GRAD_TOL)


def test_ctc_infeasible_alignment_is_inf():
    """Six labels with two repeats need 8 frames; with 5, optax returns a
    large finite loss (log-epsilon -1e5) and the port ``inf``
    (ROADMAP, recorded differences)."""
    logits = np.random.default_rng(5).normal(0, 1, (1, 5, 6)) \
        .astype(np.float32)
    labels = np.array([[1, 1, 2, 2, 3, 4]], np.int32)
    pads = np.zeros((1, 6), np.float32)
    got = float(losses.ctc_loss(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                torch.from_numpy(pads)))
    want = float(jlosses.ctc_loss(jnp.asarray(logits), jnp.asarray(labels),
                                  jnp.asarray(pads)))
    assert got == float("inf")
    assert np.isfinite(want) and want > 1e4


def test_ctc_recognizer_param_gradients_match():
    """The CTC loss of the narrow SVTR-LCNet recognizer (inference-mode
    BatchNorm, as the JAX task runs it) against ``jax.value_and_grad``
    (float(loss) read detached):
    every params leaf within 1e-4 of its largest magnitude."""
    kw = VARIANTS["narrow"]
    cfg = RecConfig(**kw)
    # the variances doubled: on the calibrated tree as it is the gradient
    # of the first blocks is chaotic (each f32 side 7e-3 of its largest
    # magnitude from f64, the two 4e-3 apart); doubled, both sides are
    # within 1e-5 of f64
    tree = scale_batch_variances(rec_tree(cfg), 2.0)
    x = _crops(7, n=2)
    model = CTCRecModel(cfg)
    load_flax_variables(model, tree)
    rng = np.random.default_rng(8)
    labels = rng.integers(1, cfg.vocab_size, (2, 6)).astype(np.int32)
    pads = np.zeros((2, 6), np.float32)
    pads[1, 4:] = 1.0
    params = dict(model.named_parameters())
    loss = losses.ctc_loss(model(torch.from_numpy(x)),
                           torch.from_numpy(labels), torch.from_numpy(pads))
    grads = torch.autograd.grad(loss, list(params.values()))
    got = state_dict_to_flax(dict(zip(params, grads)),
                             {"params": tree["params"]})["params"]
    jm = JCTCRecModel(JRecConfig(**kw))
    jv = jax.tree.map(jnp.asarray, tree)

    def jloss(p):
        lg = jm.apply({"params": p, "batch_stats": jv["batch_stats"]},
                      jnp.asarray(x), train=False)
        return jlosses.ctc_loss(lg, jnp.asarray(labels), jnp.asarray(pads))

    want, wg = jax.jit(jax.value_and_grad(jloss))(jv["params"])
    _close(float(loss), float(want), CTC_TOL)
    wg = dict(tree_leaves(jax.tree.map(np.asarray, wg)))
    for path, g in tree_leaves(got):
        _close(g.numpy(), wg[path], CTC_GRAD_TOL, path)


# -- the quick trainer --------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_tree(items, size):
    return jax.tree.map(np.asarray, jinit_params(
        JDBNet(JDbNetConfig(**dict(items))),
        np.zeros((1, size, size, 3), np.float32), train=True))


def _jax_train_tree(cfg_kw, size=64):
    """JAX's own initial training tree (seed 0), host arrays."""
    return copy.deepcopy(_jax_tree(tuple(sorted(cfg_kw.items())), size))


# ---------------------------------------------------------


def bar_page(rng, size):
    """bench.py's training page (dark bars on white, their xyxy boxes), at
    the test's size."""
    img = np.full((size, size, 3), 255, np.uint8)
    boxes = []
    y = int(rng.integers(4, 10))
    while y < size - 12:
        x = int(rng.integers(2, 8))
        for _ in range(int(rng.integers(1, 3))):
            w = int(rng.integers(10, 30))
            if x + w > size - 4:
                break
            h = int(rng.integers(5, 8))
            img[y:y + h, x:x + w] = int(rng.integers(20, 60))
            boxes.append([x, y, x + w, y + h])
            x += w + int(rng.integers(4, 8))
        y += int(rng.integers(10, 16))
    return img, boxes


CFG = dict(backbone="mobilenetv3", inner_channels=96)
SIZE, BATCH, STEPS, SEED = 64, 2, 3, 11
LR = 1e-3


def _run_port(tree, steps):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(quick_det, "init_dbnet", lambda cfg, seed, train: tree)
        return quick_det.train_quick_detector(
            DbNetConfig(**CFG), bar_page, steps=steps, size=SIZE,
            batch_size=BATCH, lr=LR, rng=np.random.default_rng(SEED),
            device="cpu")


def _run_jax(steps):
    return jquick.train_quick_detector(
        JDbNetConfig(**CFG), bar_page, steps=steps, size=SIZE,
        batch_size=BATCH, lr=LR, rng=np.random.default_rng(SEED))


def _pool(steps):
    """The trainer's batch pool: ``min(steps, 16)`` batches from ``rng`` in
    JAX's order (train/quick_det.py::make_batch, JAX's own inline)."""
    rng = np.random.default_rng(SEED)
    return [quick_det.make_batch(bar_page, rng, SIZE, BATCH)
            for _ in range(min(steps, 16))]


def _port_f64_run(tree, steps):
    """The port's trainer step (its own pieces: the model in batch mode,
    ``db_loss``, train/optim.py as ``optax.adamw``) on the same tree and
    pages in float64: (each step's loss, the variables by path after the
    first step)."""
    model = DBNet(DbNetConfig(**CFG), train=True)
    load_flax_variables(model, tree)
    model = model.double()
    model.dtype = torch.float64
    tx = ClipAdamW(constant_schedule(LR), float("inf"), weight_decay=1e-4)
    state = TrainState.create(model, tx)
    step = make_train_step(lambda b: model(b["image"], train=True),
                           losses.db_loss, tx)
    pool = _pool(steps)
    out, first = [], None
    for s in range(steps):
        state, ls = step(state, {k: torch.from_numpy(v).double()
                                 for k, v in pool[s % len(pool)].items()})
        out.append(float(ls["loss"]))
        if first is None:
            first = {p: a.numpy().copy() for p, a in tree_leaves(
                model_variables(model, tree))}
    return out, first


def _jax_f64_run(tree, steps):
    """JAX's trainer step (pdf_table_tpu/train/quick_det.py's: flax's batch
    mode, JAX's ``db_loss``, ``optax.adamw(lr)``) in float64, under
    ``jax.enable_x64`` with the config's dtype float64, on the same tree
    and pages: (each step's loss, the variables by path after the first
    step). The yardstick of the port's f32 trainer, made without the
    port."""
    with jax.enable_x64(True):
        jm = JDBNet(JDbNetConfig(**CFG, dtype="float64"))
        tx = optax.adamw(LR)

        @jax.jit
        def step(params, bstats, opt, batch):
            def loss_fn(p):
                out, mut = jm.apply({"params": p, "batch_stats": bstats},
                                    batch["image"], train=True,
                                    mutable=["batch_stats"])
                return jlosses.db_loss(out, batch)["loss"], \
                    mut["batch_stats"]

            (lv, bs), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
            up, opt = tx.update(g, opt, params)
            return optax.apply_updates(params, up), bs, opt, lv

        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
        p, bs = v["params"], v["batch_stats"]
        opt = tx.init(p)
        pool = [{k: jnp.asarray(a, jnp.float64) for k, a in b.items()}
                for b in _pool(steps)]
        out, first = [], None
        for s in range(steps):
            p, bs, opt, lv = step(p, bs, opt, pool[s % len(pool)])
            out.append(float(lv))
            if first is None:
                first = dict(tree_leaves(jax.tree.map(
                    np.asarray, {"params": p, "batch_stats": bs})))
        return out, first


@pytest.fixture(scope="module")
def trained():
    """JAX's and the port's trainers from JAX's initial tree on the same
    pages, three steps."""
    tree = _jax_train_tree(CFG, SIZE)
    return tree, _run_port(tree, STEPS), _run_jax(STEPS)


@pytest.fixture(scope="module")
def f64_runs():
    """The port's and JAX's same three steps in float64."""
    tree = _jax_train_tree(CFG, SIZE)
    return _port_f64_run(tree, STEPS), _jax_f64_run(tree, STEPS)


def test_quick_trainer_matches_jax(trained, f64_runs):
    """The first loss (step 0) within 1e-5 of JAX's. The same three steps
    in float64 on both sides agree within 1e-6 relative (up to 3.8e-7 here:
    ``F64_STEP_TOL`` says why). The last f32 loss (step 2) moves with f32
    round-off: Adam turns each gradient element's round-off into up to
    +-lr wherever the gradient is small (the biases that feed a
    batch-statistics BatchNorm have none at all), and the loss follows.
    So it is held against JAX's float64 run: within 1e-5 of it, or no
    farther from it than JAX's own f32 trainer is (JAX 4.0e-4, the port
    9.1e-5 on this tree); and within 1e-3 of JAX's f32. One step's params
    and statistics are held in the next test, each gradient in the one
    after, the optimizer against optax below."""
    tree, (gv, gfirst, glast), (wv, wfirst, wlast) = trained
    _close(gfirst, wfirst, STEP_LOSS_TOL, "first")
    (exact, _), (truth, _) = f64_runs
    for i, (e, t) in enumerate(zip(exact, truth)):
        _close(e, t, F64_LOSS_TOL, f"float64 step {i}")
    _close(gfirst, truth[0], STEP_LOSS_TOL, "first vs float64")
    assert abs(glast - truth[-1]) <= max(STEP_LOSS_TOL * abs(truth[-1]),
                                         abs(wlast - truth[-1]))
    _close(glast, wlast, 1e-3, "last")
    assert glast < gfirst
    want = dict(tree_leaves(jax.tree.map(np.asarray, wv)))
    got = dict(tree_leaves(gv))
    assert set(got) == set(want) == {p for p, _ in tree_leaves(tree)}


def _f64_step(tree):
    """The port's float64 gradient of the first batch's loss by params
    path, and the statistics that one batch-statistics forward leaves, by
    batch_stats path."""
    model = DBNet(DbNetConfig(**CFG), train=True)
    load_flax_variables(model, tree)
    model = model.double()
    model.dtype = torch.float64
    batch = {k: torch.from_numpy(v).double() for k, v in _pool(1)[0].items()}
    params = dict(model.named_parameters())
    loss = losses.db_loss(model(batch["image"], train=True), batch)["loss"]
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    sd = {k: t.detach() for k, t in model.state_dict().items()}
    sd.update(grads)
    out = state_dict_to_flax(sd, tree, transposed_modules(model))
    return {p: a.numpy() for p, a in tree_leaves(out)}


def _jax_step(tree, f64):
    """``jax.grad`` of JAX's step on the first batch by params path, and
    the statistics its forward leaves, by batch_stats path; in float64
    (``jax.enable_x64``, the config's dtype float64) or in f32."""
    b = _pool(1)[0]
    with jax.enable_x64(f64):
        dt = jnp.float64 if f64 else jnp.float32
        jm = JDBNet(JDbNetConfig(**CFG, dtype=jnp.dtype(dt).name))
        v = jax.tree.map(lambda a: jnp.asarray(a, dt), tree)
        batch = {k: jnp.asarray(a, dt) for k, a in b.items()}

        def jloss(p):
            out, mut = jm.apply({"params": p,
                                 "batch_stats": v["batch_stats"]},
                                batch["image"], train=True,
                                mutable=["batch_stats"])
            return jlosses.db_loss(out, batch)["loss"], mut["batch_stats"]

        g, bs = jax.jit(jax.grad(jloss, has_aux=True))(v["params"])
        return dict(tree_leaves(jax.tree.map(
            np.asarray, {"params": g, "batch_stats": bs})))


@pytest.fixture(scope="module")
def first_step():
    """JAX's initial tree; the first step's gradient and statistics from
    the port in float64, from JAX in float64 and from JAX in f32."""
    tree = _jax_train_tree(CFG, SIZE)
    return (tree, _f64_step(tree), _jax_step(tree, True),
            _jax_step(tree, False))


def _stats_scale(stats, path):
    """A statistic's scale: the larger of its largest magnitude and the
    root of its variance (a mean near 0 is read against its spread)."""
    return max(float(np.abs(stats[path]).max()), float(np.sqrt(np.abs(
        stats[path[:-1] + ("var",)]).max())))


def test_quick_trainer_first_step_matches_jax(first_step, f64_runs):
    """One step from JAX's tree, held against the same step in float64 by
    JAX (``_jax_f64_run``). The port's step in float64 agrees with it: each
    param's update within 1e-5 of lr where JAX's float64 gradient is over
    1e-6 (100 times Adam's eps; below, Adam's step amplifies the last
    digits of the gradient, and the step is held within 2 lr as the f32
    sides are), each statistic within 1e-6 of its leaf's scale.
    The trainer's f32 step: every batch statistic within 1e-5 of its
    leaf's scale of JAX's float64, or no farther from it than JAX's f32;
    every param within 1e-4 of its leaf's largest magnitude of JAX's
    float64 step where JAX's float64 gradient is large (over 1e-2 of the
    leaf's largest and 1e-6), so that Adam's step is its sign times lr.
    Elsewhere the step is Adam's eps-normalized round-off, at most lr in
    size, so at most 2 lr from float64's (XLA's f32 gradient has the wrong
    sign even on some of the large elements). The first loss is held to
    JAX's trainer in the test above."""
    tree, _, truth, want = first_step
    gv, _, _ = _run_port(tree, 1)
    (_, exact), (_, step64) = f64_runs
    got = dict(tree_leaves(gv))
    n_sure = n_all = 0
    for path, t in step64.items():
        g = got[path].numpy()
        scale = float(np.abs(t).max())
        if path[0] == "batch_stats":
            # JAX's f32 statistics of the same forward (``_jax_step``)
            _held(g, exact[path], want[path], t, STATS_TOL,
                  _stats_scale(step64, path), path)
            continue
        gr = np.abs(truth[path])
        # where the gradient is within some 100 eps of zero Adam's step
        # turns the gradient's last digits into up to +-lr
        big = gr > 1e-6
        assert np.abs(exact[path] - t)[big].max(initial=0.0) \
            <= F64_STEP_TOL * LR, path
        sure = (gr > 1e-2 * gr.max()) & big
        assert np.abs(g - t)[sure].max(initial=0.0) <= PARAM_TOL * scale, \
            path
        for side in (g, exact[path]):
            # +-lr against -+lr where the f32 gradient's sign is wrong
            assert np.abs(side - t).max() <= 2 * LR * (1 + 1e-4 * scale) \
                + 1e-7, path
        n_sure += int(sure.sum())
        n_all += sure.size
    assert n_sure > 0.3 * n_all


def test_first_step_gradients_match_jax(first_step):
    """Every params leaf's gradient of the trainer's loss (batch
    statistics in every BatchNorm), and the statistics its forward leaves,
    against ``jax.grad`` of JAX's step in float64 (``_held``): the port in
    float64 within 1e-6 of each leaf's largest magnitude (both round
    ``prob`` and ``thresh`` to f32 where the model returns them, so the
    loss is f32-exact only); the port in f32 within 1e-4 of it, or no
    farther from it than JAX's f32.
    On this random tree XLA's f32 gradient is that far at nearly every
    leaf (up to a tenth of a leaf's largest magnitude, on the first
    blocks' BatchNorm scales), and the port's f32 a quarter of that at
    most.
    The leaves whose float64 gradient is zero (the transposed-conv biases
    and the MobileNetV3 ``project`` BatchNorm biases, which feed a
    batch-statistics BatchNorm through linear layers only) get round-off
    on every side."""
    tree, exact, truth, want = first_step
    model = DBNet(DbNetConfig(**CFG), train=True)
    load_flax_variables(model, tree)
    params = dict(model.named_parameters())
    batch = {k: torch.from_numpy(v) for k, v in _pool(1)[0].items()}
    loss = losses.db_loss(model(batch["image"], train=True), batch)["loss"]
    grads = torch.autograd.grad(loss, list(params.values()))
    sd = {k: t.detach() for k, t in model.state_dict().items()}
    sd.update(dict(zip(params, grads)))
    got = {p: a.numpy() for p, a in tree_leaves(state_dict_to_flax(
        sd, tree, transposed_modules(model)))}
    top = max(float(np.abs(t).max()) for p, t in truth.items()
              if p[0] == "params")
    null = set()
    for path, t in truth.items():
        g, e, w = got[path], exact[path], want[path]
        if path[0] == "batch_stats":
            _held(g, e, w, t, STATS_TOL, _stats_scale(truth, path), path)
        elif np.abs(t).max() < 1e-9 * top:
            null.add(path[1:])
            for side in (g, e, w):
                assert np.abs(side).max() < 1e-6 * top, path
        else:
            _held(g, e, w, t, GRAD_TOL, float(np.abs(t).max()), path)
    assert {p[-2] for p in null} == {"up1", "bn"}


def test_adamw_matches_optax():
    """train/optim.py with no clipping and weight decay 1e-4 is
    ``optax.adamw(lr)``: three updates on the same gradients."""
    import optax

    rng = np.random.default_rng(4)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=5).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * 10 ** -i
              for k, v in params.items()} for i in range(3)]
    tx = optax.adamw(LR)
    jp, js = {k: jnp.asarray(v) for k, v in params.items()}, None
    js = tx.init(jp)
    opt = ClipAdamW(constant_schedule(LR), float("inf"), weight_decay=1e-4)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    for g in grads:
        up, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, up)
        tu, ts = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ts, tp)
        for k in tp:
            tp[k] += tu[k]
    for k in tp:
        # within two ulps of the largest param: the two sum the update's
        # terms in another order
        ulp = float(np.spacing(np.abs(params[k]).max()))
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=2 * ulp)


def test_trained_tree_loads_into_the_detection_task(trained):
    _, (gv, _, _), _ = trained
    task = OcrDetectionTask(model="PP-OCRv4_det", device="cpu",
                            variables=gv, **{k: v for k, v in CFG.items()
                                             if k != "backbone"})
    assert task.model.thresh is None
    sd = task.model.state_dict()
    np.testing.assert_array_equal(
        sd["binarize.bn1.running_var"].numpy(),
        gv["batch_stats"]["binarize"]["bn1"]["var"].numpy())
    assert set(inference_variables(gv)["params"]) == \
        set(gv["params"]) - {"thresh"}


def test_quick_trainer_needs_f32():
    with pytest.raises(ValueError, match="f32"):
        quick_det.train_quick_detector(
            DbNetConfig(**CFG, dtype="bfloat16"), bar_page, steps=1,
            size=SIZE, device="cpu")
