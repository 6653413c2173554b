"""The train step's model-parallel axes against the JAX package on the CPU:
``tp`` (column-parallel layers, parallel/tensor_parallel.py) and ``sp``
(row-sharded layers, parallel/spatial.py), on one 4-rank gloo group
(tests/torch_dist_worker.py, ``case_tp_sp``, fresh interpreters that
import no JAX) while this process runs the JAX side:

(a) the rule: the params the port shards equal the leaves JAX's
    ``make_param_shardings`` puts on "tp", mapped through the weight
    bridge, for ``LoreConfig.wtw()`` at full width (85 leaves), the
    resnet18 LORE and the tiny config at ``min_shard_dim`` 16;
(b) the row-window deform conv: rows ``[o0, o1)`` of the whole call,
    forward and every gradient, for the plain version and the kernel's
    autograd Function (its launch replaced by the plain version);
(c) the layers: a stack of the sp region's layers at sp = 4 (3x3/1,
    3x3/2, 7x7/1, DLA's pool, ResNet's padded max pool, the 4x4/2
    transposed conv, the depthwise upsample, a 1x1/2 conv) on each rank's
    rows gives the unsharded outputs, input and weight gradients to 1e-6
    (in f64);
(d) the step: the tiny dla34 config of tests/test_torch_lore_train.py on
    meshes (1, 2, 2), (2, 2, 1) and (2, 1, 2) at ``min_shard_dim`` 256
    and 16, with remat, with two accumulation steps and on a 96x96 batch
    (the coarsest level's 3 rows split 1 : 2), equals JAX's one-device
    trainer step on the global batch (losses within 1e-5, Adam's first
    moments within 1e-4 of each leaf's largest magnitude, the params
    within 2 lr), the replicated leaves bit-equal on every rank and the
    shards on their tp peers; JAX's own resnet18 3-axis config
    (tests/test_train_eval.py:409) on a (1, 2, 2) mesh equals JAX's
    one-device step, and its losses JAX's ``make_train_step(mesh=)`` on a
    (1, 2, 2) mesh of its CPU devices. (That sharded step's gradients are
    not its own one-device step's: with sp > 1 XLA's partitioned
    backward puts Adam's first moments up to 0.86 of a leaf's largest
    magnitude away from it, while tp alone agrees to 2e-6; the port's
    step agrees with the one-device step on every mesh. ROADMAP.md
    records it among the differences from the reference.)
(e) resume: a train state saved at (1, 2, 2) is the whole, meshless
    tree; restored there, the next step is bit-equal to the one taken
    straight through, and a meshless trainer resumes from it;
(f) the runner and the service on a (2, 2, 1) mesh split their pages
    over dp only and equal the meshless run.
"""

import os
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pdf_table_tpu.engine.params import init_params as jinit_params
from pdf_table_tpu.models.lore import LoreModel as JLoreModel
from pdf_table_tpu.models.lore.config import LoreConfig as JLoreConfig
from pdf_table_tpu.train import lore_trainer as jtrainer
from pdf_table_tpu.train.train_step import TrainState as JTrainState
from pdf_table_tpu.train.train_step import \
    make_param_shardings as jmake_param_shardings
from pdf_table_tpu_torch import serve
from pdf_table_tpu_torch.convert.flax_bridge import (state_dict_name,
                                                     state_dict_to_flax,
                                                     transposed_modules,
                                                     tree_leaves)
from pdf_table_tpu_torch.data import wtw
from pdf_table_tpu_torch.data.synthetic import make_table_sample
from pdf_table_tpu_torch.engine.params import (calibrate_batch_stats,
                                               init_lore, load_params,
                                               scale_batch_variances)
from pdf_table_tpu_torch.models.lore.config import LoreConfig
from pdf_table_tpu_torch.models.lore.model import LoreModel
from pdf_table_tpu_torch.models.lore.processor import LorePreProcessor
from pdf_table_tpu_torch.ops import deform_conv as tdc
from pdf_table_tpu_torch.parallel.tensor_parallel import make_param_shardings
from pdf_table_tpu_torch.pipeline.system import OcrSystemConfig
from pdf_table_tpu_torch.train.lore_trainer import LoreTrainArgs, LoreTrainer
from test_torch_lore_train import TINY, VAR_GAIN, _close, _tables, _tree
from test_torch_pipeline import (DET, DET_BENCH, LAYOUT, LAYOUT_BENCH, LINES,
                                 LORE_TINY, PAGES, REC, build_trees,
                                 port_pipeline)
from test_torch_serve import _digital_pdf_bytes, _png, same_answer
from torch_dist_worker import LAYER_STACK, Group, layer_stack

torch.set_num_threads(1)

LR = 1e-3
STEP_LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
KEY_BIAS_ABS = 1e-7
LAYER_TOL = 1e-6
WINDOW_TOL = 1e-6
# tests/test_train_eval.py::TestSpatialShardedTrainStep's config
RESNET = dict(backbone="resnet18", resolution=(64, 64), max_objs=4,
              hidden_size=32, head_conv=16, tsfm_layers=1, stacking_layers=1,
              num_heads=4, max_fmp_size=64)
TINY96 = dict(TINY, resolution=(96, 96))
# the three meshes at both thresholds, one of them under remat and one
# with two accumulation steps; the resume (e) follows the first run
RUNS = [dict(mesh=(1, 2, 2), min_shard_dim=256, resume="b64_next"),
        dict(mesh=(2, 2, 1), min_shard_dim=256),
        dict(mesh=(2, 1, 2), min_shard_dim=256),
        dict(mesh=(1, 2, 2), min_shard_dim=16, remat=True),
        dict(mesh=(2, 2, 1), min_shard_dim=16),
        dict(mesh=(2, 1, 2), min_shard_dim=16, accum=2),
        dict(mesh=(1, 2, 2), min_shard_dim=16, config="tiny96",
             batch="b96"),
        dict(mesh=(1, 2, 2), config="resnet18", batch="resnet")]
for _r in RUNS:
    _r.setdefault("config", "tiny")
    _r.setdefault("batch", "b64")
# JAX's one-device reference step of each run: (config, batch,
# accumulation steps)
REFERENCE = {i: (r["config"], r["batch"], r.get("accum", 1))
             for i, r in enumerate(RUNS)}
RUNNER_PAGES = PAGES[:2]


class MeshShape:
    """A stand-in of a mesh's axis sizes for the rule (no process
    group)."""

    mesh_dim_names = ("dp", "tp", "sp")

    def __init__(self, *sizes):
        self.sizes = sizes

    def size(self, i):
        return self.sizes[i]


def _train_args():
    return dict(learning_rate=LR, lr_schedule="constant", batch_size=4,
                grad_clip=1.0, weight_decay=1e-2, save_every=0,
                log_every=100)


def _tables96(n, seed):
    """_tables at 96x96 (a 24x24 map): n synthetic tables."""
    cfg = LoreConfig.wtw(**TINY96)
    pre = LorePreProcessor(cfg)
    items = []
    for i in range(n):
        img, quads, logic = make_table_sample(
            np.random.default_rng(seed * 1000 + i), 160)
        p = pre(img)
        scale = p["meta"]["out_w"] / p["meta"]["s"]
        t = wtw.make_lore_targets(quads * scale, logic, (24, 24),
                                  cfg.max_objs, False)
        t["image"] = p["image"][0]
        items.append(t)
    return wtw.stack_items(items)


def _resnet_batch():
    """tests/test_train_eval.py:424-437's batch (dp = 1)."""
    rng = np.random.default_rng(0)
    batch = {
        "image": rng.normal(size=(1, 64, 64, 3)).astype(np.float32),
        "hm": np.zeros((1, 16, 16, 2), np.float32),
        "hm_ind": np.zeros((1, 4), np.int64),
        "hm_mask": np.ones((1, 4), np.float32),
        "wh": np.ones((1, 4, 8), np.float32),
        "reg": np.zeros((1, 4, 2), np.float32),
        "logic": np.ones((1, 4, 4), np.float32),
        "gt_dets": np.ones((1, 4, 8), np.float32),
    }
    batch["hm"][:, 4, 4, 0] = 1.0
    return batch


def _resnet_tree(batch):
    cfg = LoreConfig(**RESNET)
    m = LoreModel(cfg)
    m.forward = m.heads
    return scale_batch_variances(
        calibrate_batch_stats(m, init_lore(cfg, seed=0),
                              torch.from_numpy(batch["image"])), VAR_GAIN)


def _layer_inputs():
    rng = np.random.default_rng(7)
    c = 4
    weights = []
    for kind in LAYER_STACK:
        if kind.startswith("conv"):
            k = int(kind[4])
            cin = 3 if not weights else c
            weights += [rng.normal(size=(c, cin, k, k)) / (cin * k * k) ** .5,
                        rng.normal(size=(c,)) * 0.1]
        elif kind == "deconv4x4/2":
            weights.append(rng.normal(size=(c, c, 4, 4)) / 8.0)
        elif kind == "depthwise_up2":
            weights.append(rng.normal(size=(c, 1, 4, 4)) / 2.0)
    # f64, so that the ranks' partial sums of a weight's gradient meet the
    # unsharded sum to far below the tolerance
    x = rng.normal(size=(2, 3, 24, 11))
    y = layer_stack(torch.from_numpy(x),
                    [torch.from_numpy(w) for w in weights])
    gout = rng.normal(size=tuple(y.shape))
    return {"x": x, "weights": weights, "gout": gout}


def _jax_config(name):
    return JLoreConfig(**RESNET) if name == "resnet18" else \
        JLoreConfig.wtw(**(TINY96 if name == "tiny96" else TINY))


def _jax_step(cfg, batch, tree, accum=1, mesh=None):
    """JAX's trainer step on the global batch from ``tree``: (metrics,
    trainer); on ``mesh`` its sharded step (``shard_state``,
    ``make_train_step(mesh=)``)."""
    args = jtrainer.LoreTrainArgs(**dict(
        _train_args(), grad_accum_steps=accum,
        batch_size=len(batch["image"])))
    tree = jax.tree.map(np.asarray, tree)
    with mock.patch("pdf_table_tpu.engine.params.init_params",
                    lambda *a, **k: tree):
        jt = jtrainer.LoreTrainer(cfg, args, mesh=mesh)
        jt.init_state(batch)
    if mesh is None:
        jt.state = JTrainState.create(tree, jt.tx)
        return jt.train_step(batch), jt
    with mesh:
        return jt.train_step(batch), jt


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every input, the group (started here, beside this process's JAX
    steps, which compile on a thread of their own); ``ranks()`` waits for
    the group's results."""
    tmp = tmp_path_factory.mktemp("tp_sp")
    b64 = _tables(4, seed=3)
    tree = _tree(b64)
    resnet = _resnet_batch()
    batches = {"b64": b64, "b96": _tables96(4, seed=5), "resnet": resnet,
               "b64_next": _tables(4, seed=4)}
    # each tree's statistics calibrated on its own batch (uncalibrated, the
    # 96x96 maps put the port's meshless step 2e-3 from JAX's)
    trees = {"tiny": tree, "tiny96": _tree(batches["b96"]),
             "resnet18": _resnet_tree(resnet)}
    runner_trees = build_trees()
    inputs = {
        "layers": _layer_inputs(), "side_dir": str(tmp),
        "configs": {"tiny": TINY, "tiny96": TINY96, "resnet18": RESNET},
        "train_args": _train_args(), "trees": trees, "batches": batches,
        "runs": RUNS,
        "runner": {"trees": runner_trees, "pages": RUNNER_PAGES,
                   "kw": {"det": dict(DET, **DET_BENCH),
                          "layout": dict(LAYOUT_BENCH, **LAYOUT),
                          "rec": REC, "lore": LORE_TINY, "lines": LINES},
                   "payloads": [("image", _png(RUNNER_PAGES[0])),
                                ("pdf", _digital_pdf_bytes(2))]}}
    group = Group("tp_sp", 4, inputs, str(tmp), timeout=600.0)
    pool = ThreadPoolExecutor(1)
    refs = {}
    for key in sorted(set(REFERENCE.values()), key=str):
        name, batch, accum = key
        refs[key] = pool.submit(_jax_step, _jax_config(name), batches[batch],
                                trees[name], accum)
    mesh = Mesh(np.array(jax.devices("cpu")[:4]).reshape(1, 2, 2),
                axis_names=("dp", "tp", "sp"))
    refs["resnet18_mesh"] = pool.submit(_jax_step, _jax_config("resnet18"),
                                        resnet, trees["resnet18"], 1, mesh)
    done = []

    def ranks():
        if not done:
            done.append(group.results())
        return done[0]

    yield {"inputs": inputs, "tmp": tmp, "ranks": ranks, "refs": refs,
           "runner_trees": runner_trees}
    pool.shutdown()
    ranks()


# -- (a) the rule ---------------------------------------------------------------

def _jax_tp_leaves(cfg, image_hw, min_shard_dim):
    """{flax path: shape} of the leaves JAX's rule puts on "tp", and every
    leaf's shape, by ``jax.eval_shape`` of the init."""
    model = JLoreModel(cfg)
    shapes = jax.eval_shape(lambda: jinit_params(
        model, np.zeros((1,) + image_hw + (3,), np.float32)))["params"]
    mesh = Mesh(np.array(jax.devices("cpu")[:4]).reshape(1, 2, 2),
                axis_names=("dp", "tp", "sp"))
    sh = jmake_param_shardings(mesh, shapes, min_shard_dim)
    leaves = dict(tree_leaves(shapes))
    tp = {path for path, s in tree_leaves(jax.tree.map(
        lambda v: tuple(v.spec), sh, is_leaf=lambda v: hasattr(v, "spec")))
        if s and s[-1] == "tp"}
    return tp, leaves


@pytest.mark.parametrize("name,min_shard_dim,want", [
    ("wtw", 256, 85), ("resnet18", 256, None), ("tiny", 16, None)])
def test_the_rule_equals_jaxs(name, min_shard_dim, want):
    kw = {"wtw": {}, "resnet18": RESNET, "tiny": TINY}[name]
    jcfg = JLoreConfig(**kw) if name == "resnet18" \
        else JLoreConfig.wtw(**kw)
    cfg = _config(name, kw)
    jax_tp, leaves = _jax_tp_leaves(jcfg, (64, 64), min_shard_dim)
    model = LoreModel(cfg)
    dims = make_param_shardings(model, MeshShape(1, 2, 2), min_shard_dim)
    params = dict(model.named_parameters())
    assert set(dims) == {state_dict_name(p) for p in leaves}
    got = {p for p in leaves if dims[state_dict_name(p)] is not None}
    assert got == jax_tp
    for p in got:
        t = params[state_dict_name(p)]
        assert t.shape[dims[state_dict_name(p)]] == leaves[p].shape[-1]
    if want is not None:
        assert len(got) == want
    # at tp = 3 no width divides: nothing is sharded, as in JAX
    assert not any(make_param_shardings(model, MeshShape(1, 3, 1),
                                        min_shard_dim).values())


# -- (b) the row-window deform conv --------------------------------------------

WINDOW_CASES = {"s1": ((1, 1), (1, 1), [(0, 3), (3, 7), (7, 9), (4, 4)]),
                "s2": ((2, 2), (1, 1), [(0, 1), (1, 5), (2, 3)])}


def _window_inputs(stride, padding, seed):
    rng = np.random.default_rng(seed)
    B, H, W, C, Co = 2, 9, 7, 4, 5
    Ho, Wo = tdc._out_hw(H, W, 3, 3, stride, padding, (1, 1))
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=(B, H, W, C)),
        rng.normal(size=(B, Ho, Wo, 18)) * 2.0,
        rng.uniform(size=(B, Ho, Wo, 9)),
        rng.normal(size=(3, 3, C, Co)) / 6.0,
        rng.normal(size=(Co,)))]


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_row_window_equals_the_whole_calls_rows(case):
    """The plain DCN over rows [o0, o1): its output, and autograd's
    gradients of every input, against the whole call's rows (the
    window's offsets and mask are the whole's rows; the whole call's
    gradient is zero outside them); deform_conv2d_backward_plain on the
    window against autograd of the whole."""
    stride, padding, windows = WINDOW_CASES[case]
    base = _window_inputs(stride, padding, seed=1)
    xs = [t.clone().requires_grad_() for t in base]
    whole = tdc.deform_conv2d_plain(*xs, stride, padding)
    gout = torch.from_numpy(np.random.default_rng(2).normal(
        size=tuple(whole.shape)).astype(np.float32))
    for o0, o1 in windows:
        ho = o1 - o0
        g = torch.zeros_like(gout)
        g[:, o0:o1] = gout[:, o0:o1]
        want = torch.autograd.grad(whole, xs, g, retain_graph=True)
        x, off, m, w, b = [t.clone().requires_grad_() for t in (
            base[0], base[1][:, o0:o1], base[2][:, o0:o1], base[3],
            base[4])]
        got = tdc.deform_conv2d_plain(x, off, m, w, b, stride, padding,
                                      h0=o0, ho=ho)
        if not ho:
            assert got.shape == (2, 0) + tuple(whole.shape[2:])
            continue
        _close(got.detach(), whole.detach()[:, o0:o1], WINDOW_TOL)
        gg = torch.autograd.grad(got, [x, off, m, w, b], gout[:, o0:o1])
        for a, e in zip(gg, (want[0], want[1][:, o0:o1],
                             want[2][:, o0:o1], want[3], want[4])):
            _close(a, e, WINDOW_TOL)
        bw = tdc.deform_conv2d_backward_plain(
            gout[:, o0:o1].contiguous(), base[0], base[1][:, o0:o1],
            base[2][:, o0:o1], base[3], base[4], stride, padding, (1, 1),
            False, o0, ho)
        for a, e in zip(bw, gg):
            _close(a, e, WINDOW_TOL)


def test_row_window_function_plumbing(monkeypatch):
    """DeformConv2dFunction with a window (its launch replaced by the
    plain version of its mode, as tests/test_torch_train_dcn.py does):
    the window reaches the launch and the backward."""
    calls = []

    def launch(flat_kc, x, offset, mask, weight, bias, stride, padding,
               dilation, *window):
        calls.append(window)
        return tdc.deform_conv2d_plain(x, offset, mask, weight, bias,
                                       stride, padding, dilation, *window)

    monkeypatch.setattr(tdc, "_launch", launch)
    base = _window_inputs((1, 1), (1, 1), seed=3)
    whole = tdc.deform_conv2d_plain(*base)
    o0, o1 = 2, 6
    xs = [base[0].clone().requires_grad_(),
          base[1][:, o0:o1].clone().requires_grad_(),
          base[2][:, o0:o1].clone().requires_grad_(),
          base[3].clone().requires_grad_(), base[4].clone().requires_grad_()]
    out = tdc.DeformConv2dFunction.apply(*xs, (1, 1), (1, 1), (1, 1), False,
                                         o0, o1 - o0)
    assert calls == [(o0, o1 - o0)]
    _close(out.detach(), whole[:, o0:o1], WINDOW_TOL)
    gout = torch.ones_like(out)
    got = torch.autograd.grad(out, xs, gout)
    want = tdc.deform_conv2d_backward_plain(
        gout, base[0], base[1][:, o0:o1].contiguous(),
        base[2][:, o0:o1].contiguous(), base[3], base[4], (1, 1), (1, 1),
        (1, 1), False, o0, o1 - o0)
    for a, e in zip(got, want):
        assert torch.equal(a, e)
    with pytest.raises(ValueError, match="row window"):
        tdc.deform_conv2d_plain(base[0], base[1], base[2], base[3], None,
                                h0=5, ho=9)


# -- (c) the layers --------------------------------------------------------------

def test_row_sharded_layers_equal_the_unsharded(world):
    inp = world["inputs"]["layers"]
    x = torch.from_numpy(inp["x"]).requires_grad_()
    weights = [torch.from_numpy(w).requires_grad_() for w in inp["weights"]]
    y = layer_stack(x, weights)
    want = torch.autograd.grad((y * torch.from_numpy(inp["gout"])).sum(),
                               [x] + weights)
    ranks = [r["layers"] for r in world["ranks"]()]
    assert [r["y"].shape[2] for r in ranks] == [1, 2, 1, 2]
    _close(np.concatenate([r["y"] for r in ranks], 2), y.detach(),
           LAYER_TOL)
    _close(np.concatenate([r["grads"][0] for r in ranks], 2), want[0],
           LAYER_TOL)
    for i, w in enumerate(want[1:], 1):
        _close(np.sum([r["grads"][i] for r in ranks], 0), w, LAYER_TOL)
        # each rank holds a partial sum, not the whole
        assert not np.allclose(ranks[0]["grads"][i], w.numpy())


# -- (d) the step ----------------------------------------------------------------

def _flax(sd, like, cfg):
    """Whole state_dict-named arrays as {flax path: tensor}."""
    return dict(tree_leaves(state_dict_to_flax(
        {k: torch.from_numpy(np.asarray(a)) for k, a in sd.items()},
        {"params": like["params"]},
        transposed_modules(LoreModel(cfg)))["params"]))


def _config(name, kw):
    return LoreConfig(**kw) if name == "resnet18" else LoreConfig.wtw(**kw)


@pytest.mark.parametrize("i", range(len(RUNS)),
                         ids=[f"{r['config']}-{'x'.join(map(str, r['mesh']))}"
                              f"-{r.get('min_shard_dim', 256)}"
                              f"{'-remat' if r.get('remat') else ''}"
                              f"{'-accum' if r.get('accum') else ''}"
                              for r in RUNS])
def test_mesh_step_equals_jaxs_step(world, i):
    run = RUNS[i]
    want, jt = world["refs"][REFERENCE[i]].result()
    ranks = world["ranks"]()
    tree = world["inputs"]["trees"][run["config"]]
    meshed = world["refs"]["resnet18_mesh"].result()[0] \
        if run["config"] == "resnet18" else want
    for res in ranks:
        assert not res["jax_imported"] and not res["pdf_table_tpu_imported"]
        for k in want:
            _close(res["runs"][i]["losses"][k], want[k], STEP_LOSS_TOL)
            _close(res["runs"][i]["losses"][k], meshed[k], STEP_LOSS_TOL)
    got = torch.load(os.path.join(world["tmp"], f"run{i}.pt"),
                     weights_only=False)
    adam = jt.state.opt_state[1][0]
    want_mu = dict(tree_leaves(jax.tree.map(np.asarray, adam.mu)))
    cfg = _config(run["config"], world["inputs"]["configs"][run["config"]])
    for path, g in _flax(got["mu"], tree, cfg).items():
        if path[-2:] == ("k_linear", "bias"):
            assert float(g.abs().max()) < KEY_BIAS_ABS
            assert float(np.abs(want_mu[path]).max()) < KEY_BIAS_ABS
        elif np.abs(want_mu[path]).max():
            _close(g.numpy(), want_mu[path], GRAD_TOL)
        else:
            assert not g.abs().max(), path
    want_p = dict(tree_leaves(jax.tree.map(np.asarray, jt.state.params)))
    for path, p in _flax(got["params"], tree, cfg).items():
        assert float(np.abs(p.numpy() - want_p[path]).max()) <= 2 * LR, path


@pytest.mark.parametrize("i", range(len(RUNS)))
def test_mesh_step_shards_and_replicas(world, i):
    """The sharded params are the rule's, held as their tp columns; the
    replicated ones bit-equal on every rank, the shards on their tp peers;
    the sp ranks ran the detector on their rows."""
    run = RUNS[i]
    dp, tp, sp = run["mesh"]
    recs = [r["runs"][i] for r in world["ranks"]()]
    model = LoreModel(_config(run["config"],
                              world["inputs"]["configs"][run["config"]]))
    rule = make_param_shardings(model, MeshShape(dp, tp, sp),
                                run.get("min_shard_dim", 256))
    whole = {k: tuple(v.shape) for k, v in model.named_parameters()}
    want = sorted(k for k, d in rule.items() if d is not None) \
        if tp > 1 else []
    for rec in recs:
        assert rec["sharded"] == want
        assert rec["coords"]["tp"][1] == tp and rec["coords"]["sp"][1] == sp
        for k, shape in rec["shapes"].items():
            d = rule[k] if k in want else None
            expect = list(whole[k])
            if d is not None:
                expect[d] //= tp
            assert list(shape) == expect, k
        assert rec["rows_split"] == (sp > 1)
        assert (rec["calls"].get("gather_from_tp", 0) > 0) == (tp > 1)
    for k in recs[0]["crc"]:
        peers = {}
        for rec in recs:
            key = rec["coords"]["tp"][0] if k in want else 0
            peers.setdefault(key, set()).add(rec["crc"][k])
        assert all(len(v) == 1 for v in peers.values()), k
        if k in want:
            assert len(peers) == tp, k


# -- (e) resume ------------------------------------------------------------------

def test_mesh_resume_is_bit_exact_and_meshless(world, tmp_path):
    res = [r["resume"] for r in world["ranks"]()]
    for r in res:
        assert r["resumed"] == r["through"] and r["params_equal"]
        assert r["step"] == 2
    inp = world["inputs"]
    saved = load_params(res[0]["path"])
    assert set(saved) == {"params", "batch_stats", "opt_state", "step"}
    tr = LoreTrainer(LoreConfig.wtw(**TINY),
                     LoreTrainArgs(**_train_args(), output_dir=str(tmp_path)),
                     device="cpu")
    tr.init_state(inp["trees"]["tiny"])
    tr.restore_train_state(res[0]["path"])
    assert tr.state.step == 1
    # every leaf whole, as the meshless trainer's own save
    own = tr.variables()
    for col in ("params", "batch_stats"):
        for path, v in tree_leaves(own[col]):
            node = saved[col]
            for k in path:
                node = node[k]
            assert tuple(node.shape) == tuple(v.shape), path
    metrics = tr.train_step(inp["batches"]["b64_next"])
    for k, v in metrics.items():
        _close(v, res[0]["through"][k], STEP_LOSS_TOL)


# -- (f) the runner and the service ---------------------------------------------

def test_runner_and_service_split_over_dp_only(world):
    ranks = [r["runner"] for r in world["ranks"]()]
    solo = ranks[0]["solo"]
    for res in ranks:
        # each dp row (two ranks, tp 0 and 1) ran one of the two pages
        assert res["own_stats_pages"] == 1.0
        assert len(res["pages"]) == len(solo) == len(RUNNER_PAGES)
        for got, want in zip(res["pages"], solo):
            assert got["page"] == want["page"]
            np.testing.assert_array_equal(got["quads"], want["quads"])
            assert got["texts"] == want["texts"]
            assert got["table_html"] == want["table_html"]
            assert got["page_html"] == want["page_html"]
    svc = serve.ExtractionService(OcrSystemConfig(), batch_pages=4,
                                  max_wait_ms=50.0, device="cpu")
    svc.pipeline = port_pipeline(world["runner_trees"], True)
    try:
        want = [svc.submit(kind, payload) for kind, payload
                in world["inputs"]["runner"]["payloads"]]
    finally:
        svc.close()
    assert all("served" not in r for r in ranks[1:])
    for g, w in zip(ranks[0]["served"], want):
        same_answer((200, g), (200, w))
