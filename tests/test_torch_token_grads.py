"""The token models' teacher-forced gradients against the JAX package on
the CPU: the loss of JAX's overfit tests, ``-mean(log(structure_probs +
1e-9))`` at the teacher tokens, under ``jax.value_and_grad`` on the same
tree, then the same loss over a few Adam steps (``optax.adam``, here
train/optim.py with no clipping and no weight decay).

- SLANet as in tests/test_slanet.py:115-155: the tiny config (64 px,
  hidden 32, 6 steps), inference BatchNorm (``train=False``), JAX's own
  seeded tree;
- TableMaster as in tests/test_table_master.py:98-150: ``tiny_cfg(
  decoder_layers=2)`` with every BatchNorm on its batch's statistics
  (``train=True``, ``mutable=["batch_stats"]``; the port's
  models/layers.py::batch_statistics), the statistics updated at each
  step, JAX's own seeded tree and positional table.

Tolerances: the loss within 1e-5 relative; each params leaf's gradient
within 1e-4 of the leaf's largest magnitude; the updated statistics within
1e-5 of each leaf's largest magnitude; each of SLANet's Adam steps' losses
within 1e-5 relative. TableMaster in batch mode on JAX's random tree is
ill-conditioned in f32 (its first convs' gradients), so there both sides
are also run in float64: JAX under ``jax.enable_x64`` with the config's
dtype float64 and its model module's f32 and int32 literals (its decoder
caches, the encoder's output cast, the positional table, the token ids)
read as 64-bit, the port with its model cast to float64. The port in
float64 must agree with JAX in float64 within 1e-10 of each leaf's scale:
a fault in the port's model shows there. Its f32 must lie within the
tolerance of JAX's float64, or within JAX_F32_SPREAD times JAX's own f32
distance from it (a bound that owes nothing to the port); the leaves with
no gradient in float64 (its key biases, its context blocks' mask bias)
get round-off only, on every side."""

import contextlib
import copy
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pdf_table_tpu.engine.params import init_params as jinit_params
from pdf_table_tpu.models.slanet import SLANet as JSLANet
from pdf_table_tpu.models.slanet import SLANetConfig as JSLANetConfig
from pdf_table_tpu.models.table_master import TableMaster as JTableMaster
from pdf_table_tpu.models.table_master import TableMasterConfig as JConfig
from pdf_table_tpu.models.table_master import model as jtm_model
from pdf_table_tpu.models.table_master.model import \
    interleaved_positions as j_positions
from pdf_table_tpu_torch.convert.flax_bridge import (load_flax_variables,
                                                     state_dict_to_flax,
                                                     tree_leaves)
from pdf_table_tpu_torch.models.layers import batch_statistics
from pdf_table_tpu_torch.models.slanet.config import SLANetConfig
from pdf_table_tpu_torch.models.slanet.model import SLANet
from pdf_table_tpu_torch.models.table_master import model as tm_model
from pdf_table_tpu_torch.models.table_master.config import \
    TableMasterConfig
from pdf_table_tpu_torch.models.table_master.model import TableMaster
from pdf_table_tpu_torch.models.table_master.vocab import \
    MasterStructureVocab
from pdf_table_tpu_torch.train.optim import ClipAdamW, constant_schedule

torch.set_num_threads(1)

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STATS_TOL = 1e-5
STEPS = 4
NULL_REL = 1e-6
# the port in float64 against JAX in float64, of each leaf's scale (4e-13
# on TableMaster's gradients here)
F64_TOL = 1e-10
# two f32 runs of an ill-conditioned gradient sit at random distances from
# float64: the port's may be a few times JAX's on a leaf, and on others the
# other way round (on TableMaster's tree here the ratio reaches 1.8 on one
# leaf)
JAX_F32_SPREAD = 4.0
SECOND_STEP_TOL = 1e-3

SLANET = dict(table_max_len=64, hidden_size=32, max_structure_len=6)
MASTER = dict(img_size=(64, 64), d_model=32, decoder_layers=2, heads=4,
              ff_dim=64, max_structure_len=6)


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max()) / scale
    assert err < tol, (what, err)


def _ce(probs, ids):
    """JAX's overfit loss on the port's side."""
    logp = torch.log(probs + 1e-9)
    return -torch.gather(logp, -1, ids[..., None].long()).mean()


def _jce(probs, ids):
    logp = jnp.log(probs + 1e-9)
    return -jnp.take_along_axis(logp, ids[..., None], -1).mean()


def _port_grads(model, params, loss_fn):
    """(loss, gradient by state_dict name); a param the loss does not
    reach (the location heads) gets zeros, as under ``jax.grad``."""
    loss = loss_fn()
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return float(loss.detach()), {
        k: torch.zeros_like(params[k]) if g is None else g
        for k, g in zip(params, grads)}


def _as_flax(model, grads, tree):
    return dict(tree_leaves(state_dict_to_flax(
        grads, {"params": tree["params"]})["params"]))


# -- SLANet ----------------------------------------------------------------


@pytest.fixture(scope="module")
def slanet():
    x = np.random.default_rng(0).standard_normal((1, 64, 64, 3)) \
        .astype(np.float32)
    toks = np.array([[1, 7, 8, 30, 49, 49]], np.int32)
    jm = JSLANet(JSLANetConfig(**SLANET))
    tree = jax.tree.map(np.asarray, jinit_params(jm, jnp.asarray(x)))
    return x, toks, jm, tree


def _slanet_jax_loss(jm, tree, x, toks):
    def loss_fn(p):
        o = jm.apply({"params": p, "batch_stats": tree["batch_stats"]},
                     jnp.asarray(x), train=False,
                     teacher_tokens=jnp.asarray(toks))
        return _jce(o["structure_probs"], jnp.asarray(toks))
    return loss_fn


def _slanet_port(tree):
    model = SLANet(SLANetConfig(**SLANET)).eval()
    load_flax_variables(model, tree)
    return model, dict(model.named_parameters())


def test_slanet_teacher_forced_gradients_match(slanet):
    x, toks, jm, tree = slanet
    want, wg = jax.jit(jax.value_and_grad(_slanet_jax_loss(
        jm, tree, x, toks)))(jax.tree.map(jnp.asarray, tree["params"]))
    model, params = _slanet_port(tree)
    t = torch.from_numpy(toks)
    got, grads = _port_grads(model, params, lambda: _ce(
        model(torch.from_numpy(x), teacher_tokens=t)["structure_probs"], t))
    _close(got, float(want), LOSS_TOL, "loss")
    wg = dict(tree_leaves(jax.tree.map(np.asarray, wg)))
    got_g = _as_flax(model, grads, tree)
    assert set(got_g) == set(wg)
    for path, g in got_g.items():
        _close(g.numpy(), wg[path], GRAD_TOL, path)


def test_slanet_adam_steps_match(slanet):
    """``optax.adam(3e-3)`` over STEPS steps, as the JAX overfit test
    trains: each step's loss within 1e-5 relative, and the loss falls."""
    x, toks, jm, tree = slanet
    tx = optax.adam(3e-3)
    loss_fn = _slanet_jax_loss(jm, tree, x, toks)

    @jax.jit
    def step(p, opt):
        lv, g = jax.value_and_grad(loss_fn)(p)
        up, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, up), opt, lv

    p = jax.tree.map(jnp.asarray, tree["params"])
    opt = tx.init(p)
    want = []
    for _ in range(STEPS):
        p, opt, lv = step(p, opt)
        want.append(float(lv))
    model, params = _slanet_port(tree)
    adam = ClipAdamW(constant_schedule(3e-3), float("inf"),
                     weight_decay=0.0)
    state = adam.init(params)
    t = torch.from_numpy(toks)
    got = []
    for _ in range(STEPS):
        lv, grads = _port_grads(model, params, lambda: _ce(
            model(torch.from_numpy(x), teacher_tokens=t)["structure_probs"],
            t))
        up, state = adam.update(grads, state, params)
        with torch.no_grad():
            for k, u in up.items():
                params[k].add_(u)
        got.append(lv)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, LOSS_TOL, f"step {i}")
    assert got[-1] < got[0]


# -- TableMaster -----------------------------------------------------------


@pytest.fixture
def master(monkeypatch):
    """JAX's positional table in the port's model (their ``exp`` round
    differently: tests/test_torch_table_master.py)."""
    monkeypatch.setattr(
        tm_model, "interleaved_positions",
        lambda n, d, device=None: torch.from_numpy(
            np.array(j_positions(n, d))).to(device))
    v = MasterStructureVocab()
    x = np.random.default_rng(0).normal(0, 1, (2, 64, 64, 3)) \
        .astype(np.float32)
    ids = np.tile(np.array([v.token_to_id["<tr>"],
                            v.token_to_id["<td></td>"],
                            v.token_to_id["</tr>"], v.eos_id,
                            v.eos_id, v.eos_id], np.int32), (2, 1))
    jm = JTableMaster(JConfig(**MASTER))
    return x, ids, jm, copy.deepcopy(_master_tree())


@functools.lru_cache(maxsize=None)
def _master_tree():
    return jax.tree.map(np.asarray, jinit_params(
        JTableMaster(JConfig(**MASTER)), jnp.zeros((2, 64, 64, 3))))


def _master_jax_loss(jm, bstats, x, ids):
    def loss_fn(p):
        out, mut = jm.apply({"params": p, "batch_stats": bstats},
                            jnp.asarray(x), train=True,
                            teacher_tokens=jnp.asarray(ids),
                            mutable=["batch_stats"])
        return _jce(out["structure_probs"], jnp.asarray(ids)), \
            mut["batch_stats"]
    return loss_fn


def _master_port(tree, dtype=torch.float32):
    """The port's model on ``tree``; in float64 for the yardstick."""
    model = TableMaster(TableMasterConfig(**MASTER)).eval()
    load_flax_variables(model, tree)
    if dtype == torch.float64:
        model = model.double()
        model.dtype = dtype
    return model, dict(model.named_parameters())


@contextlib.contextmanager
def _jax_float64():
    """JAX in float64: ``jax.enable_x64``, and JAX's TableMaster module
    reading ``jnp.float32`` and ``jnp.int32`` as their 64-bit types (its
    decoder caches, its cast of the encoder's output and its positional
    table are f32 literals, its token ids int32). The port's f64 run reads
    the positional table inside the block too, so both sides get it in
    float64."""
    f64 = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                   if not k.startswith("__")})
    f64.float32, f64.int32 = jnp.float64, jnp.int64
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jtm_model, "jnp", f64)
        yield


def _master_jax64_grads(tree, x, ids):
    """JAX's gradient and statistics in float64, by path."""
    with _jax_float64():
        jm = JTableMaster(JConfig(**MASTER, dtype="float64"))
        jv = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
        (_, stats), g = jax.jit(jax.value_and_grad(_master_jax_loss(
            jm, jv["batch_stats"], np.asarray(x, np.float64), ids),
            has_aux=True))(jv["params"])
        return (dict(tree_leaves(jax.tree.map(np.asarray, g))),
                dict(tree_leaves(jax.tree.map(np.asarray, stats))))


def _master_loss(model, x, ids):
    t = torch.from_numpy(ids)
    with batch_statistics(model):
        out = model(torch.from_numpy(x).to(model.dtype), teacher_tokens=t)
    return _ce(out["structure_probs"], t)
