"""The port's LORE training path against the JAX package on the CPU, at the
tiny dla34 config: WTW targets and the dataset, the LORE loss,
``train_forward``, every parameter's gradient, the learning-rate schedules
and three trainer steps against optax; then the trainer's own behaviour
(gradient accumulation, remat, bit-exact resume, the non-blocking
checkpoint, ``fit`` with its eval hook), as tests/test_train_eval.py holds
the JAX trainer's.

Both sides load one flax-layout tree: ``init_lore`` with its offset convs
perturbed (so the deform convs sample between pixels) and BatchNorm
statistics from ``calibrate_batch_stats``, every variance then doubled.
Calibrated as it is, the random DLA stack is chaotic: two f32 runs that sum
in another order differ by 1e-3 at the heads; with the doubled variances
each layer shrinks its input's spread a little and they agree to 1e-5,
while the heads still move with the input."""

import copy
import json

import cv2
import jax
import numpy as np
import pytest
import torch

from pdf_table_tpu.data import wtw as jwtw
from pdf_table_tpu.models.lore import LoreModel as JLoreModel
from pdf_table_tpu.models.lore.config import LoreConfig as JLoreConfig
from pdf_table_tpu.models.lore.processor import \
    LorePreProcessor as JLorePreProcessor
from pdf_table_tpu.train import losses as jlosses
from pdf_table_tpu.train import lore_trainer as jtrainer
from pdf_table_tpu.train.lore_loss import lore_loss as jlore_loss
from pdf_table_tpu.train.train_step import TrainState as JTrainState
from pdf_table_tpu_torch.convert.flax_bridge import (flax_to_state_dict,
                                                     load_flax_variables,
                                                     state_dict_to_flax,
                                                     tree_leaves)
from pdf_table_tpu_torch.data import wtw
from pdf_table_tpu_torch.data.synthetic import make_table_sample
from pdf_table_tpu_torch.engine.params import (calibrate_batch_stats,
                                               init_lore,
                                               perturb_conv_offset_mask,
                                               scale_batch_variances,
                                               wait_for_async_saves)
from pdf_table_tpu_torch.models.lore.config import LoreConfig
from pdf_table_tpu_torch.models.lore.dla import DeformConvBlock
from pdf_table_tpu_torch.models.lore.model import LoreModel
from pdf_table_tpu_torch.models.lore.processor import LorePreProcessor
from pdf_table_tpu_torch.train import losses
from pdf_table_tpu_torch.train.lore_loss import lore_loss
from pdf_table_tpu_torch.train.lore_trainer import (LoreTrainArgs,
                                                    LoreTrainer,
                                                    build_lr_schedule,
                                                    remat_stages)
from pdf_table_tpu_torch.train.train_step import value_and_grad

torch.set_num_threads(1)

TINY = dict(resolution=(64, 64), max_objs=8, hidden_size=32, head_conv=16,
            tsfm_layers=1, stacking_layers=1, num_heads=4, max_fmp_size=64,
            d_ff=64)
FMAP = (16, 16)
VAR_GAIN = 2.0
# relative to each output's (each leaf's) largest magnitude: f32 on both
# sides, sums in another order
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
KEY_BIAS_ABS = 1e-7    # the attention key biases' gradients, round-off
LOSS_TOL = 1e-6        # the loss terms on the same outputs
STEP_LOSS_TOL = 1e-5   # each trainer step's loss
MOMENT_TOL = 1e-5      # Adam's mu and nu after three steps
# the three-step run: poly with a 2-step warm-up (step 1 at lr 0), the clip
# triggered (the gradient norm is far above CLIP)
LR = 1e-3
CLIP = 1.0
WEIGHT_DECAY = 1e-2
STEPS = 3


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max()) / scale
    assert err < tol, err


def _tables(n, seed, with_corners=False, size=128):
    """n synthetic tables drawn at ``size`` px, preprocessed to 64x64 by the
    port, with their targets: a numpy batch."""
    cfg = LoreConfig.wtw(**TINY)
    pre = LorePreProcessor(cfg)
    items = []
    for i in range(n):
        img, quads, logic = make_table_sample(
            np.random.default_rng(seed * 1000 + i), size)
        p = pre(img)
        scale = p["meta"]["out_w"] / p["meta"]["s"]
        t = wtw.make_lore_targets(quads * scale, logic, FMAP,
                                  cfg.max_objs, with_corners)
        t["image"] = p["image"][0]
        items.append(t)
    return wtw.stack_items(items)


def _tree(batch):
    cfg = LoreConfig.wtw(**TINY)
    v = perturb_conv_offset_mask(init_lore(cfg, seed=0), seed=1)
    m = LoreModel(cfg)
    m.forward = m.heads
    return scale_batch_variances(
        calibrate_batch_stats(m, v, torch.from_numpy(batch["image"])),
        VAR_GAIN)


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long()
            if np.issubdtype(np.asarray(v).dtype, np.integer)
            else torch.from_numpy(np.asarray(v, np.float32))
            for k, v in batch.items()}


def _jax_forward(jm, v, batch, cc_match=None):
    return jm.apply(v, batch["image"], batch["hm_ind"].astype(np.int32),
                    batch["gt_dets"], batch["hm_mask"], cc_match=cc_match,
                    method=JLoreModel.train_forward)


@pytest.fixture(scope="module")
def setup():
    batch = _tables(2, seed=0)
    v = _tree(batch)
    jm = JLoreModel(JLoreConfig.wtw(**TINY))
    return batch, v, jm


@pytest.fixture(scope="module")
def jax_grads(setup):
    """jax.value_and_grad of the JAX trainer's loss on the batch: (losses,
    grads), computed once."""
    batch, v, jm = setup

    def loss(params):
        out = _jax_forward(jm, {"params": params,
                                "batch_stats": v["batch_stats"]}, batch)
        ls = jlore_loss(out, batch, wiz_stacking=True)
        return ls["loss"], ls

    (_, ls), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(np.asarray, v["params"]))
    return ls, grads


# -- targets and the dataset -------------------------------------------------


def _quads():
    """Cells in feature-map px: a 3x3 grid sharing vertices (fractional
    corners), a tilted quad, one beyond the map (clipped) and one thinner
    than a pixel (skipped)."""
    xs, ys = [1.3, 5.0, 9.6, 14.2], [2.0, 6.5, 11.25]
    quads = [[xs[c], ys[r], xs[c + 1], ys[r], xs[c + 1], ys[r + 1], xs[c],
              ys[r + 1]] for r in range(2) for c in range(3)]
    quads += [[3.2, 12.1, 8.7, 12.9, 8.1, 15.4, 2.6, 14.8],
              [12.0, 13.0, 19.0, 13.5, 18.5, 17.0, 11.5, 16.0],
              [4.0, 4.0, 4.5, 4.0, 4.5, 9.0, 4.0, 9.0]]
    logic = [[r, r, c, c] for r in range(2) for c in range(3)] \
        + [[2, 2, 0, 1], [2, 2, 2, 2], [0, 1, 1, 1]]
    return np.asarray(quads, np.float32), np.asarray(logic, np.float32)


@pytest.mark.parametrize("with_corners", [False, True])
@pytest.mark.parametrize("max_objs", [6, 16])
def test_targets_bit_equal(with_corners, max_objs):
    quads, logic = _quads()
    got = wtw.make_lore_targets(quads, logic, FMAP, max_objs, with_corners)
    want = jwtw.make_lore_targets(quads, logic, FMAP, max_objs,
                                  with_corners)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_gaussian_helpers_equal():
    for size in ((3, 4), (10.0, 20.0), (1, 30), (7.5, 7.5)):
        assert wtw.gaussian_radius(size) == jwtw.gaussian_radius(size)
    got, want = np.zeros((12, 10), np.float32), np.zeros((12, 10),
                                                           np.float32)
    for center, r in (((3.7, 4.2), 3), ((9, 11), 2), ((0, 0), 5),
                      ((20, 3), 1)):
        wtw.draw_gaussian(got, center, r)
        jwtw.draw_gaussian(want, center, r)
    np.testing.assert_array_equal(got, want)


def _read_rgb(path):
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


def _grey(norm):
    """Normalized image -> 0..255 before the normalize."""
    return (norm * LorePreProcessor.STD + LorePreProcessor.MEAN) * 255.0


def test_dataset_batch_matches_jax(tmp_path):
    """COCO json + images the test writes (PNG, read back by cv2): targets
    equal, images equal at scale 1 and within 0.5 grey level when
    scaled."""
    rng = np.random.default_rng(7)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    shapes = {"same.png": (64, 64), "wide.png": (77, 93),
              "tall.png": (130, 101)}
    images, anns = [], []
    for i, (name, (h, w)) in enumerate(shapes.items()):
        im = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        im[h // 3] = 0
        cv2.imwrite(str(img_dir / name), im)
        images.append({"id": i, "file_name": name, "width": w, "height": h})
        for j in range(3):
            x0, y0 = 4 + 9 * j, 5 + 7 * j
            anns.append({"id": 10 * i + j, "image_id": i,
                         "segmentation": [[x0, y0, x0 + 20.5, y0,
                                           x0 + 20.5, y0 + 14, x0,
                                           y0 + 14]],
                         "logic_axis": [[j, j, 0, 1]]})
    label = tmp_path / "coco.json"
    label.write_text(json.dumps({"images": images, "annotations": anns}))
    ds = wtw.WtwDataset(str(img_dir), str(label),
                        config=LoreConfig.wtw(**TINY), reader=_read_rgb)
    jds = jwtw.WtwDataset(str(img_dir), str(label),
                          config=JLoreConfig.wtw(**TINY))
    assert len(ds) == len(jds) == 3
    got, want = ds.batch([0, 1, 2]), jds.batch([0, 1, 2])
    assert set(got) == set(want)
    for k in want:
        if k != "image":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["image"].dtype == np.float32
    np.testing.assert_array_equal(got["image"][0], want["image"][0])
    assert float(np.abs(_grey(got["image"]) - _grey(want["image"])).max()) \
        < 0.5
    with pytest.raises(ValueError, match="reader"):
        wtw.WtwDataset(str(img_dir), str(label))[0]


@pytest.mark.parametrize("upper_left", [True, False])
def test_preprocess_matches_cv2(upper_left):
    """LorePreProcessor without cv2 against the JAX one (cv2.warpAffine)."""
    rng = np.random.default_rng(8)
    img = (rng.random((101, 87, 3)) * 255).astype(np.uint8)
    cfg = dict(TINY, upper_left=upper_left)
    got = LorePreProcessor(LoreConfig.wtw(**cfg))(img)
    want = JLorePreProcessor(JLoreConfig.wtw(**cfg))(img)
    assert got["image"].shape == want["image"].shape == (1, 64, 64, 3)
    assert float(np.abs(_grey(got["image"]) - _grey(want["image"])).max()) \
        < 0.5
    for k in want["meta"]:
        np.testing.assert_array_equal(got["meta"][k], want["meta"][k])


@pytest.mark.parametrize("hw", [(1000, 700), (170, 130)])
@pytest.mark.parametrize("upper_left", [False, True])
def test_preprocess_matches_jax_to_1e4_grey_levels(hw, upper_left):
    """The centred and corner-anchored warps at 96^2 from a 1000x700 and a
    170x130 page, against the JAX pre-processor (cv2.warpAffine): equal,
    and so is the bare warp against cv2.warpAffine (OpenCV 5.0.0's sample
    points and blend, F17)."""
    from pdf_table_tpu_torch.models.lore.processor import warp_affine_linear

    img = (np.random.default_rng(0).random((*hw, 3)) * 255).astype(np.uint8)
    cfg = dict(resolution=(96, 96), upper_left=upper_left)
    got = LorePreProcessor(LoreConfig.wtw(**cfg))(img)["image"]
    want = JLorePreProcessor(JLoreConfig.wtw(**cfg))(img)["image"]
    np.testing.assert_array_equal(got, want)
    h, w = hw
    s = 96 / max(h, w)
    mat = np.array([[s, 0, 48 - s * w / 2], [0, s, 48 - s * h / 2]],
                   np.float32)
    src = img.astype(np.float32)
    np.testing.assert_array_equal(
        warp_affine_linear(src, mat, (96, 96)),
        cv2.warpAffine(src, mat, (96, 96), flags=cv2.INTER_LINEAR))


# -- the loss ------------------------------------------------------------------


def _outputs(seed):
    rng = np.random.default_rng(seed)
    B, (H, W), M = 2, FMAP, TINY["max_objs"]
    return {"heads": {"wh": rng.normal(0, 3, (B, H, W, 8)),
                      "st": rng.normal(0, 3, (B, H, W, 8)),
                      "reg": rng.random((B, H, W, 2))},
            "hm": rng.uniform(0.001, 0.999, (B, H, W, 2)),
            "logi": rng.uniform(0, 4, (B, M, 4)),
            "stacked_logi": rng.uniform(0, 4, (B, M, 4))}


def _to(tree, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("branch", ["centre", "pairloss", "corner_reg"])
def test_lore_loss_matches(branch):
    """The three branches: the centre channel only; both channels and the
    cycle-pairing loss; the centre and corner offsets joined."""
    batch = _tables(2, seed=1, with_corners=branch != "centre")
    outputs = _to(_outputs(2), lambda a: np.asarray(a, np.float32))
    pair = branch == "pairloss"
    want = jlore_loss(outputs, batch, wiz_pairloss=pair)
    got = lore_loss(_to(outputs, torch.from_numpy), _torch(batch),
                    wiz_pairloss=pair)
    assert set(got) == set(want)
    assert ("st_l" in got) == pair
    for k in want:
        _close(float(got[k]), float(want[k]), LOSS_TOL)


def test_loss_primitives_match():
    rng = np.random.default_rng(3)
    pred = rng.uniform(0, 1, (2, 9, 7)).astype(np.float32)
    gt = rng.uniform(0, 1, (2, 9, 7)).astype(np.float32)
    gt[0, 3, 4] = gt[1, 0, 0] = 1.0
    _close(float(losses.focal_loss(torch.from_numpy(pred),
                                   torch.from_numpy(gt))),
           float(jlosses.focal_loss(pred, gt)), LOSS_TOL)
    p = rng.normal(size=(2, 5, 3)).astype(np.float32)
    g = rng.normal(size=(2, 5, 3)).astype(np.float32)
    for m in ((rng.random((2, 5)) > 0.4).astype(np.float32),
              (rng.random((2, 5, 3)) > 0.4).astype(np.float32)):
        _close(float(losses.reg_l1_loss(*map(torch.from_numpy, (p, g, m)))),
               float(jlosses.reg_l1_loss(p, g, m)), LOSS_TOL)


# -- forward and gradients -----------------------------------------------------


@pytest.mark.parametrize("corners", [False, True], ids=["gt_dets", "cc_match"])
def test_train_forward_matches(setup, corners):
    """Features at the ground-truth centres and corners (rounded gt_dets, or
    cc_match), the regressor masked by hm_mask; BatchNorm on its stored
    statistics in train mode too."""
    _, v, jm = setup
    batch = _tables(2, seed=0, with_corners=corners)
    cc = batch["cc_match"].astype(np.int32) if corners else None
    want = _jax_forward(jm, v, batch, cc)
    tm = LoreModel(LoreConfig.wtw(**TINY))
    load_flax_variables(tm, v)
    tb = _torch(batch)
    args = (tb["image"], tb["hm_ind"], tb["gt_dets"], tb["hm_mask"],
            tb.get("cc_match"))
    with torch.no_grad():
        got = tm.train().train_forward(*args)
        again = tm.eval().train_forward(*args)
    for k in ("hm", "logi", "stacked_logi"):
        _close(got[k].numpy(), want[k], FWD_TOL)
        assert torch.equal(got[k], again[k])
    assert set(got["heads"]) == set(want["heads"])
    for k in want["heads"]:
        _close(got["heads"][k].numpy(), want["heads"][k], FWD_TOL)


def test_param_gradients_match(setup, jax_grads):
    """Every params leaf's gradient within GRAD_TOL of jax.grad's; the
    trainable set is the flax params tree, and the statistics get none.
    The st head is not in the loss (no pairing loss): zero on both sides."""
    batch, v, _ = setup
    j_losses, j_grads = jax_grads
    tr = LoreTrainer(LoreConfig.wtw(**TINY), LoreTrainArgs(), device="cpu")
    tr.init_state(v)
    assert set(tr.state.params) == set(flax_to_state_dict(
        {"params": v["params"]}))
    assert not any(b.requires_grad for b in tr.state.buffers.values())
    losses_, grads = value_and_grad(tr.apply, tr.loss, tr.state.params,
                                    tr.to_device(batch))
    for k in j_losses:
        _close(float(losses_[k]), float(j_losses[k]), FWD_TOL)
    unreached = {k for k, g in grads.items() if g is None}
    grads = {k: torch.zeros_like(tr.state.params[k]) if g is None else g
             for k, g in grads.items()}
    got = state_dict_to_flax(grads, {"params": v["params"]})["params"]
    want = dict(tree_leaves(jax.tree.map(np.asarray, j_grads)))
    zero = set()
    for path, g in tree_leaves(got):
        w = want[path]
        if not np.abs(w).max():
            zero.add(path)
            assert not g.abs().max(), path
        elif path[-2:] == ("k_linear", "bias"):
            # softmax does not see a bias added to every key: both sides
            # hold round-off only
            assert float(np.abs(w).max()) < KEY_BIAS_ABS
            assert float(g.abs().max()) < KEY_BIAS_ABS
        else:
            _close(g.numpy(), w, GRAD_TOL)
    # what the loss does not reach: the st head and the level-2 trees'
    # projections, which the DLA tree computes and never uses
    assert unreached == {k for k in grads if any(
        tuple(k.split(".")[:len(p) - 1]) == p[:-1] for p in zero)}
    assert all(".heads.st" in k or ".project." in k for k in unreached)
    assert any(".heads.st" in k for k in unreached)


# -- optimizer and trainer steps -----------------------------------------------


@pytest.mark.parametrize("kind", ["poly", "step", "constant"])
def test_schedule_matches_optax(kind):
    args = dict(learning_rate=3e-4, warmup_steps=7, total_steps=40,
                lr_schedule=kind, step_lr_drops=(0.25, 0.5))
    got = build_lr_schedule(LoreTrainArgs(**args))
    want = jtrainer.build_lr_schedule(jtrainer.LoreTrainArgs(**args))
    for count in range(45):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=1e-12)
    if kind == "poly":
        assert got(0) == 0.0
    if kind == "step":   # scaled at the boundary count itself
        assert got(10) == pytest.approx(3e-5) and got(9) == 3e-4


def _args(tmp_path, **kw):
    base = dict(learning_rate=LR, batch_size=2, warmup_steps=2,
                total_steps=10, grad_clip=CLIP, weight_decay=WEIGHT_DECAY,
                save_every=0, log_every=100, output_dir=str(tmp_path))
    base.update(kw)
    return base


def test_three_steps_match_optax(setup, tmp_path, monkeypatch,
                                 record_property):
    """The JAX trainer (its optax chain and jitted step, started from the
    same tree) against the port's, three steps on three batches. Adam
    turns a gradient that differs in round-off into a full lr step, so the
    parameters are held within 2 * lr * steps, and the count of entries
    beyond 1e-6 is recorded."""
    _, v, _ = setup
    batches = [_tables(2, seed=s) for s in (0, 1, 2)]
    monkeypatch.setattr("pdf_table_tpu.engine.params.init_params",
                        lambda *a, **k: v)
    jt = jtrainer.LoreTrainer(JLoreConfig.wtw(**TINY),
                              jtrainer.LoreTrainArgs(**_args(tmp_path)))
    jt.init_state(batches[0])
    jt.state = JTrainState.create(jax.tree.map(np.asarray, v), jt.tx)
    tr = LoreTrainer(LoreConfig.wtw(**TINY), LoreTrainArgs(**_args(tmp_path)),
                     device="cpu")
    tr.init_state(v)
    norms = []
    for b in batches:
        _, g = value_and_grad(tr.apply, tr.loss, tr.state.params,
                              tr.to_device(b))
        norms.append(float(torch.sqrt(sum((x * x).sum() for x in g.values()
                                          if x is not None))))
        want = jt.train_step(b)
        got = tr.train_step(b)
        for k in want:
            _close(got[k], want[k], STEP_LOSS_TOL)
    assert min(norms) > CLIP, norms
    assert tr.state.step == int(jt.state.step) == STEPS
    adam = jt.state.opt_state[1][0]
    assert tr.state.opt_state["count"] == int(adam.count) == STEPS
    for name in ("mu", "nu"):
        got = state_dict_to_flax(tr.state.opt_state[name],
                                 {"params": v["params"]})["params"]
        want = dict(tree_leaves(jax.tree.map(np.asarray, getattr(adam,
                                                                 name))))
        bound = KEY_BIAS_ABS ** (1 if name == "mu" else 2)
        for path, g in tree_leaves(got):
            if path[-2:] == ("k_linear", "bias"):
                assert float(np.abs(want[path]).max()) < bound
                assert float(g.abs().max()) < bound
            elif np.abs(want[path]).max():
                _close(g.numpy(), want[path], MOMENT_TOL)
            else:
                assert not g.abs().max(), path
    got = dict(tree_leaves(tr.variables()["params"]))
    want = dict(tree_leaves(jax.tree.map(np.asarray, jt.state.params)))
    diffs = np.concatenate([np.abs(got[p].numpy() - want[p]).ravel()
                            for p in want])
    record_property("params_beyond_1e-6", int((diffs > 1e-6).sum()))
    record_property("params_total", int(diffs.size))
    assert float(diffs.max()) <= 2 * LR * STEPS


def _trainer(v, tmp_path, **kw):
    tr = LoreTrainer(LoreConfig.wtw(**TINY),
                     LoreTrainArgs(**_args(tmp_path, **kw)), device="cpu")
    tr.init_state(v)
    return tr


def _grads_close(a, b, tol):
    """Adam's first moments after one step (0.1 x the clipped gradient) of
    two trainers, leaf by leaf; the attention key biases (round-off only)
    absolutely."""
    for k, m in a.state.opt_state["mu"].items():
        want = b.state.opt_state["mu"][k]
        if k.endswith("k_linear.bias"):
            assert float(m.abs().max()) < KEY_BIAS_ABS
            assert float(want.abs().max()) < KEY_BIAS_ABS
        else:
            _close(m.numpy(), want.numpy(), tol)


def test_grad_accum_matches_full_batch(setup, tmp_path):
    """grad_accum_steps=2 over a batch of two different tables with the
    same count of valid slots and heatmap peaks, so that each microbatch's
    mean is its share of the full-batch mean: the same loss and gradient as
    one full-batch step. The two tables' own losses differ, so a step that
    dropped a microbatch would differ too."""
    batch, v, _ = setup
    assert not np.array_equal(batch["image"][0], batch["image"][1])
    for key in ("hm_mask", "hm"):
        n = (batch[key][..., 0] if key == "hm" else batch[key]) >= 1.0
        assert n[0].sum() == n[1].sum() > 0, key
    runs = [_trainer(v, tmp_path, lr_schedule="constant",
                     grad_accum_steps=n) for n in (1, 2)]
    halves = [value_and_grad(runs[0].apply, runs[0].loss,
                             runs[0].state.params,
                             runs[0].to_device({k: a[i:i + 1] for k, a
                                                in batch.items()}))[0]["loss"]
              for i in (0, 1)]
    assert abs(float(halves[0] - halves[1])) > 1e-3 * abs(float(halves[0]))
    m = [tr.train_step(batch) for tr in runs]
    for k in m[0]:
        _close(m[1][k], m[0][k], 1e-5)
    _close(m[1]["loss"], float(sum(halves)) / 2, 1e-5)
    _grads_close(runs[1], runs[0], 1e-5)
    one = {k: a[:1] for k, a in batch.items()}
    with pytest.raises(ValueError, match="microbatches"):
        _trainer(v, tmp_path, grad_accum_steps=2).train_step(one)


def test_remat_matches_plain(setup, tmp_path):
    """remat=True (the forward checkpointed stage by stage): the same
    loss and gradients as the plain step."""
    batch, v, _ = setup
    one = {k: a[:1] for k, a in batch.items()}
    runs = [_trainer(v, tmp_path, lr_schedule="constant", batch_size=1,
                     remat=r) for r in (False, True)]
    m = [tr.train_step(one) for tr in runs]
    assert m[0] == m[1]
    _grads_close(runs[1], runs[0], 1e-6)


def test_remat_keeps_only_stage_inputs(setup, tmp_path):
    """Under remat the forward keeps for the backward only what lies
    between the checkpointed stages: every deform-conv block is a stage,
    and the activations the step holds (distinct storages, parameters
    aside) fall to under a tenth."""
    batch, v, _ = setup
    kept = []
    for remat in (False, True):
        tr = _trainer(v, tmp_path, lr_schedule="constant", remat=remat)
        params = {p.untyped_storage().data_ptr()
                  for p in tr.model.parameters()}
        storages = {}

        def pack(t):
            st = t.untyped_storage()
            if st.data_ptr() not in params:
                storages[st.data_ptr()] = st.nbytes()
            return t

        db = tr.to_device(batch)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tr.loss(tr.apply(db), db)["loss"]
        kept.append(sum(storages.values()))
    assert kept[1] < kept[0] / 10, kept
    n_dcn = sum(isinstance(m, DeformConvBlock) for m in tr.model.modules())
    assert n_dcn == 16
    assert sum(isinstance(m, DeformConvBlock)
               for m in remat_stages(tr.model)) == n_dcn


def test_full_state_resume_bit_exact(setup, tmp_path):
    """2 steps + save_train_state + 2 steps equals a fresh trainer restored
    from the file + 2 steps, bit for bit (moments, count, schedule
    position)."""
    batch, v, _ = setup
    one = {k: a[:1] for k, a in batch.items()}
    a = _trainer(v, tmp_path, batch_size=1, warmup_steps=3)
    a.train_step(one)
    a.train_step(one)
    ck = a.save_train_state(str(tmp_path / "ts"))
    a.train_step(one)
    a.train_step(one)
    b = LoreTrainer(LoreConfig.wtw(**TINY),
                    LoreTrainArgs(**_args(tmp_path, batch_size=1,
                                          warmup_steps=3)), device="cpu")
    b.restore_train_state(ck)
    assert b.state.step == 2 and b.state.opt_state["count"] == 2
    b.train_step(one)
    b.train_step(one)
    for k, p in a.state.params.items():
        assert torch.equal(p, b.state.params[k]), k
        for name in ("mu", "nu"):
            assert torch.equal(a.state.opt_state[name][k],
                               b.state.opt_state[name][k]), k


def test_async_checkpoint_roundtrip(setup, tmp_path):
    """save_checkpoint(blocking=False) writes on a thread while training
    goes on; after the wait the restored params are the saved ones, and the
    checkpoint loads into a LoreModel through the weight bridge."""
    batch, v, _ = setup
    one = {k: a[:1] for k, a in batch.items()}
    tr = _trainer(v, tmp_path, batch_size=1, lr_schedule="constant")
    tr.train_step(one)
    ck = tr.save_checkpoint(str(tmp_path / "ck"), blocking=False)
    saved = {k: p.detach().clone() for k, p in tr.state.params.items()}
    tr.train_step(one)
    wait_for_async_saves()
    assert any(not torch.equal(saved[k], p)
               for k, p in tr.state.params.items())
    tr.restore_checkpoint(ck)
    for k, p in tr.state.params.items():
        assert torch.equal(saved[k], p), k
    m = LoreModel(LoreConfig.wtw(**TINY))
    load_flax_variables(m, tr.variables())
    for k, p in m.state_dict().items():
        assert torch.equal(p, {**saved, **tr.state.buffers}[k]), k


def test_fit_prefetch_and_eval_hook(setup, tmp_path):
    """fit(): prefetch-threaded batches, the eval hook every 2 steps and the
    full train state saved at the best eval metric."""
    batch, v, _ = setup
    items = [{k: a[i] for k, a in batch.items()} for i in range(2)]

    class Stub:
        def __len__(self):
            return 4

        def batch(self, idx):
            return wtw.stack_items([items[i % 2] for i in idx])

    tr = _trainer(v, tmp_path, batch_size=1, lr_schedule="constant")
    evals = []

    def eval_fn(trainer):
        evals.append(trainer.state.step)
        return {"loss": trainer.history[-1]["loss"]}

    hist = tr.fit(Stub(), steps=5, eval_fn=eval_fn, eval_every=2)
    assert len(hist) == 5 and evals == [3, 5]
    assert sum("eval_loss" in h for h in hist) == 2
    assert (tmp_path / "best_model" / "tree.pt").is_file()
    assert tr.best_loss == min(h["loss"] for h in hist)


def test_trainer_refuses_bf16_and_a_missing_card():
    with pytest.raises(ValueError, match="f32"):
        LoreTrainer(LoreConfig.wtw(**dict(TINY, dtype="bfloat16")),
                    device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LoreTrainer(LoreConfig.wtw(**TINY))


def test_bridge_round_trip(setup):
    """state_dict_to_flax inverts flax_to_state_dict, leaf for leaf."""
    _, v, _ = setup
    sd = flax_to_state_dict(v)
    back = state_dict_to_flax(sd, v)
    want = dict(tree_leaves(v))
    got = dict(tree_leaves(back))
    assert set(got) == set(want)
    for p, a in want.items():
        np.testing.assert_array_equal(got[p].numpy(), a, err_msg=str(p))
    assert copy.deepcopy(back) is not None


def test_cli_trains_and_resumes(tmp_path, monkeypatch, capsys):
    """python -m pdf_table_tpu_torch.train on two images the test writes
    (the tiny config in place of the full wtw one, cv2's imread as the
    reader), then again from its train state."""
    from pdf_table_tpu_torch.train import __main__ as cli

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(9)
    images, anns = [], []
    for i in range(2):
        img, quads, logic = make_table_sample(rng, 96)
        cv2.imwrite(str(img_dir / f"t{i}.png"), img)
        images.append({"id": i, "file_name": f"t{i}.png"})
        anns += [{"id": 100 * i + j, "image_id": i,
                  "segmentation": [q.tolist()], "logic_axis": [l.tolist()]}
                 for j, (q, l) in enumerate(zip(quads, logic))]
    label = tmp_path / "train.json"
    label.write_text(json.dumps({"images": images, "annotations": anns}))
    monkeypatch.setattr(LoreConfig, "wtw",
                        classmethod(lambda cls, **kw: cls(**TINY, **kw)))
    out = tmp_path / "run"
    common = ["--image_dir", str(img_dir), "--label_path", str(label),
              "--reader", "cv2:imread", "--batch_size", "1", "--device",
              "cpu", "--output_dir", str(out)]
    assert cli.main(common + ["--steps", "2"]) == 0
    assert len(json.loads((out / "history.json").read_text())) == 2
    assert (out / "checkpoint" / "tree.pt").is_file()
    assert cli.main(common + ["--steps", "1", "--resume",
                              str(out / "train_state")]) == 0
    text = capsys.readouterr().out
    assert "dataset: 2 images" in text and "resumed at step 2" in text
    with pytest.raises(ValueError, match="MODULE:FUNCTION"):
        cli.load_reader("cv2.imread")


def test_fit_raises_the_producers_error(setup, tmp_path):
    """A batch that fails on the prefetch thread fails fit(), which does
    not wait for it forever."""
    _, v, _ = setup

    class Broken:
        def __len__(self):
            return 2

        def batch(self, idx):
            raise OSError("unreadable image")

    tr = _trainer(v, tmp_path, batch_size=1)
    with pytest.raises(OSError, match="unreadable"):
        tr.fit(Broken(), steps=3)
    assert tr.state.step == 0


def test_loss_decreases_and_checkpoint_restores(setup, tmp_path):
    """Five steps on one batch lower the loss; the checkpoint restores the
    params it saved (as the JAX trainer's two-step test)."""
    batch, v, _ = setup
    one = {k: a[:1] for k, a in batch.items()}
    tr = _trainer(v, tmp_path, batch_size=1, lr_schedule="constant")
    first = tr.train_step(one)["loss"]
    for _ in range(4):
        last = tr.train_step(one)["loss"]
    assert last < first
    ck = tr.save_checkpoint(str(tmp_path / "ck"))
    saved = {k: p.detach().clone() for k, p in tr.state.params.items()}
    tr.train_step(one)
    tr.restore_checkpoint(ck)
    for k, p in tr.state.params.items():
        assert torch.equal(p, saved[k]), k
