"""TableMaster's teacher-forced gradients and batch statistics against the
JAX package on the CPU, as tests/test_table_master.py:98-150 trains it
(every BatchNorm on its batch's statistics): the tree, inputs, loss,
tolerances and float64 runs of tests/test_torch_token_grads.py, whose
docstring says how both sides are held. A file of its own because JAX's
float64 run of the encoder takes some 30 s on one CPU core."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pdf_table_tpu_torch.convert.flax_bridge import (model_variables,
                                                     tree_leaves)
from test_torch_det_train import _held
from test_torch_token_grads import (F64_TOL, GRAD_TOL, JAX_F32_SPREAD,
                                    LOSS_TOL, NULL_REL, STATS_TOL, _as_flax,
                                    _close, _jax_float64, _master_jax64_grads,
                                    _master_jax_loss, _master_loss,
                                    _master_port, _port_grads, master)

torch.set_num_threads(1)

assert master  # the fixture, imported for pytest


def test_table_master_teacher_forced_gradients_match(master):
    x, ids, jm, tree = master
    jv = jax.tree.map(jnp.asarray, tree)
    (want, wstats), wg = jax.jit(jax.value_and_grad(
        _master_jax_loss(jm, jv["batch_stats"], x, ids), has_aux=True))(
        jv["params"])
    model, params = _master_port(tree)
    got, grads = _port_grads(model, params,
                             lambda: _master_loss(model, x, ids))
    _close(got, float(want), LOSS_TOL, "loss")
    truth, tstats = _master_jax64_grads(tree, x, ids)
    with _jax_float64():
        m64, p64 = _master_port(tree, torch.float64)
        _, g64 = _port_grads(m64, p64, lambda: _master_loss(m64, x, ids))
    exact = {k: v.numpy() for k, v in _as_flax(m64, g64, tree).items()}
    wg = dict(tree_leaves(jax.tree.map(np.asarray, wg)))
    got_g = _as_flax(model, grads, tree)
    assert set(got_g) == set(wg) == set(truth)
    top = max(float(np.abs(t).max()) for t in truth.values())
    null = set()
    for path, t in truth.items():
        g = got_g[path].numpy()
        if np.abs(t).max() < 1e-9 * top:
            # no gradient in float64: round-off on every side
            null.add(path)
            for side in (g, wg[path], exact[path]):
                assert np.abs(side).max() < NULL_REL * top, path
        else:
            _held(g, exact[path], wg[path], t, GRAD_TOL,
                  float(np.abs(t).max()), path, f64_tol=F64_TOL,
                  spread=JAX_F32_SPREAD)
    # the structure loss does not reach the location branch (its decoder
    # layer and head); softmax does not see a bias added to every key, nor
    # the global context block's one bias on its spatial attention logits
    blocks = ("2_0", "2_1", "3_0", "3_1", "3_2", "3_3", "3_4", "4_0", "4_1",
              "4_2")
    assert null == (
        {p for p in got_g if p[0].startswith(("bbox_", "fc_loc"))}
        | {(f"{n}_{b}",) for n in ("l0", "cls") for b in ("kb", "ckb")}
        | {("encoder", f"layer{i}", "context", "conv_mask", "bias")
           for i in blocks})
    stats = dict(tree_leaves(model_variables(model, tree)["batch_stats"]))
    stats64 = dict(tree_leaves(model_variables(m64, tree)["batch_stats"]))
    wstats = dict(tree_leaves(jax.tree.map(np.asarray, wstats)))
    assert set(stats) == set(wstats) == set(tstats)
    for path, t in tstats.items():
        _held(stats[path].numpy(), stats64[path].numpy(), wstats[path], t,
              STATS_TOL, float(np.abs(t).max()), path, f64_tol=F64_TOL,
              spread=JAX_F32_SPREAD)
        assert not np.array_equal(
            wstats[path], dict(tree_leaves(tree["batch_stats"]))[path])
