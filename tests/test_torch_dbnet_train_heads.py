"""DBNet's training side against flax on the CPU: BatchNorm's batch mode
(``models/layers.py::batch_statistics``) against ``nn.BatchNorm(
use_running_average=False, momentum=0.9)``, the ``thresh`` heads' trees
against flax's ``init(..., train=True)``, and ``forward(train=True)`` with
its updated statistics against ``apply(train=True, mutable=...)``.
Tolerances as in tests/test_torch_det_train.py, whose helpers this file
shares."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from pdf_table_tpu.models.dbnet import DBNet as JDBNet
from pdf_table_tpu.models.dbnet.config import DbNetConfig as JDbNetConfig
from pdf_table_tpu_torch.convert.flax_bridge import (load_flax_variables,
                                                     model_variables,
                                                     tree_leaves)
from pdf_table_tpu_torch.engine.params import init_dbnet
from pdf_table_tpu_torch.models.dbnet.config import DbNetConfig
from pdf_table_tpu_torch.models.dbnet.model import DBNet
from pdf_table_tpu_torch.models.layers import BatchNorm, batch_statistics
from test_torch_det_train import (FWD_TOL, LOSS_GRAD_TOL, STATS_TOL, _close,
                                  _held, _jax_train_tree, _stats_scale, _t)

torch.set_num_threads(1)


# -- BatchNorm's batch mode ---------------------------------------------------


def test_batch_norm_batch_mode_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 2.0, (3, 5, 6, 4)).astype(np.float32)   # NHWC
    scale = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    bias = rng.normal(0, 0.2, 4).astype(np.float32)
    mean0 = rng.normal(0, 0.3, 4).astype(np.float32)
    var0 = rng.uniform(0.5, 2, 4).astype(np.float32)
    up = rng.normal(size=x.shape).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5)
    jv = {"params": {"scale": scale, "bias": bias},
          "batch_stats": {"mean": mean0, "var": var0}}

    def jf(xx, p):
        y, mut = jbn.apply({"params": p, "batch_stats": jv["batch_stats"]},
                           xx, mutable=["batch_stats"])
        return jnp.sum(y * up), (y, mut["batch_stats"])

    (_, (wy, wstats)), (wgx, wgp) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jv["params"])

    bn = BatchNorm(4).train()
    load_flax_variables(bn, jv)
    xt = _t(x.transpose(0, 3, 1, 2))
    with batch_statistics(bn):
        y = bn(xt)
    assert not bn.use_batch_stats
    (y.permute(0, 2, 3, 1) * torch.from_numpy(up)).sum().backward()
    _close(y.detach().permute(0, 2, 3, 1).numpy(), wy, FWD_TOL)
    _close(xt.grad.permute(0, 2, 3, 1).numpy(), wgx, LOSS_GRAD_TOL)
    _close(bn.weight.grad.numpy(), wgp["scale"], LOSS_GRAD_TOL)
    _close(bn.bias.grad.numpy(), wgp["bias"], LOSS_GRAD_TOL)
    _close(bn.running_mean.numpy(), wstats["mean"], STATS_TOL)
    _close(bn.running_var.numpy(), wstats["var"], STATS_TOL)
    # outside the block the running statistics are used, whatever
    # ``training`` says, and stay as they are
    before = bn.running_var.clone()
    with torch.no_grad():
        y2 = bn(xt)
    want2 = (x - np.asarray(wstats["mean"])) / np.sqrt(
        np.asarray(wstats["var"]) + 1e-5) * scale + bias
    _close(y2.permute(0, 2, 3, 1).numpy(), want2, FWD_TOL)
    assert torch.equal(bn.running_var, before)


# -- DBNet's training heads ---------------------------------------------------


BACKBONES = ["mobilenetv3", "proxylessnas", "resnet18"]
FWD_SIZE = 64


def _jcfg(backbone, **kw):
    return JDbNetConfig(backbone=backbone, **kw)


@pytest.mark.parametrize("backbone", BACKBONES + ["resnet50"])
def test_train_tree_matches_flax_train_init(backbone):
    kw = dict(inner_channels=64) if backbone != "proxylessnas" else {}
    shapes = jax.eval_shape(lambda: JDBNet(_jcfg(backbone, **kw)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=True))
    want = {p: tuple(a.shape) for p, a in tree_leaves(shapes)}
    got = {p: np.shape(a) for p, a in tree_leaves(
        init_dbnet(DbNetConfig(backbone=backbone, **kw), train=True))}
    assert got == want
    assert ("params", "thresh", "up2", "kernel") in got
    infer = {p for p, _ in tree_leaves(init_dbnet(
        DbNetConfig(backbone=backbone, **kw)))}
    assert infer == {p for p in got if p[1] != "thresh"}


@pytest.mark.parametrize("backbone", BACKBONES)
def test_train_forward_matches_flax(backbone):
    """``forward(train=True)``: prob, thresh and binary, and the updated
    statistics, against flax's ``apply(train=True, mutable=...)`` in
    float64 (``jax.enable_x64``, the config's dtype float64) by ``_held``:
    the port in float64 within 1e-6 of it, the port's f32 within 1e-5 of
    each output's largest magnitude of it, or no farther from it than
    flax's f32 (XLA's f32 sits 0.5-1.4e-5 from float64 on the prob maps of
    these random trees; ``binary`` multiplies the gap by up to k / 4)."""
    kw = dict(backbone=backbone, inner_channels=64) \
        if backbone != "proxylessnas" else dict(backbone=backbone)
    tree = _jax_train_tree(kw, FWD_SIZE)
    x = np.random.default_rng(1).normal(0, 1, (2, FWD_SIZE, FWD_SIZE, 3)) \
        .astype(np.float32)
    flax_runs = {}
    for f64 in (False, True):
        with jax.enable_x64(f64):
            dt = jnp.float64 if f64 else jnp.float32
            jm = JDBNet(JDbNetConfig(**kw, dtype=jnp.dtype(dt).name))
            out, mut = jax.jit(lambda v, xx: jm.apply(
                v, xx, train=True, mutable=["batch_stats"]))(
                jax.tree.map(lambda a: jnp.asarray(a, dt), tree),
                jnp.asarray(x, dt))
            flax_runs[f64] = ({k: np.asarray(v, np.float64)
                               for k, v in out.items()},
                              dict(tree_leaves(jax.tree.map(
                                  np.asarray, mut["batch_stats"]))))
    runs = {}
    for dt in (torch.float32, torch.float64):
        model = DBNet(DbNetConfig(**kw), train=True)
        load_flax_variables(model, tree)
        model = model.to(dt)
        model.dtype = dt
        with torch.no_grad():
            out = model(torch.from_numpy(x), train=True)
        runs[dt] = ({k: v.double().numpy() for k, v in out.items()},
                    {p: a.double().numpy() for p, a in tree_leaves(
                        model_variables(model, tree)["batch_stats"])})
    (got, stats), (exact, stats64) = runs[torch.float32], runs[torch.float64]
    (want, wstats), (truth, tstats) = flax_runs[False], flax_runs[True]
    for k in ("prob", "thresh", "binary"):
        _held(got[k], exact[k], want[k], truth[k], FWD_TOL,
              np.abs(truth[k]).max(), k)
    for path, t in tstats.items():
        _held(stats[path], stats64[path], wstats[path], t, STATS_TOL,
              _stats_scale(tstats, path), path)
    with pytest.raises(ValueError, match="thresh"):
        DBNet(DbNetConfig(**kw))(torch.from_numpy(x), train=True)
