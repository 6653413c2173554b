"""TableMaster's teacher-forced loss over a few Adam steps against the JAX
package on the CPU, as tests/test_table_master.py:98-150 trains it
(``optax.adam(2e-3)``, every BatchNorm on its batch's statistics, the
statistics updated at each step), on JAX's own seeded tree; the tree,
inputs and loss of tests/test_torch_token_grads.py. The port's float64
run that the second step is held to is itself held to JAX's float64 run
within 1e-10 of each gradient leaf's scale in
tests/test_torch_master_grads.py."""

import jax
import jax.numpy as jnp
import optax
import torch

from pdf_table_tpu_torch.train.optim import ClipAdamW, constant_schedule
from test_torch_token_grads import (LOSS_TOL, SECOND_STEP_TOL, STEPS,
                                    _close, _master_jax_loss, _master_loss,
                                    _master_port, _port_grads, master)

torch.set_num_threads(1)

assert master  # the fixture, imported for pytest


def test_table_master_adam_steps_match(master):
    """``optax.adam(2e-3)`` over STEPS steps with the statistics updated
    each step, as the JAX overfit test trains. The first step's loss within
    1e-5 relative of JAX's. Adam moves every element by about lr whatever
    its gradient's size, so an element whose gradient sits at round-off (a
    conv kernel's entry near a sign change) steps +-lr differently on each
    side, and the losses follow: the second step's is held on both f32
    sides within 1e-3 of the port's same two steps in float64 (JAX's f32
    held there too, a fault of the port's model would show as JAX's
    distance); from the third on
    the runs (JAX f32, the port in f32 and in f64) part by percents on this
    tree, so there the loss must fall on both f32 sides."""
    x, ids, jm, tree = master
    tx = optax.adam(2e-3)

    @jax.jit
    def step(p, bstats, opt):
        (lv, bs), g = jax.value_and_grad(
            _master_jax_loss(jm, bstats, x, ids), has_aux=True)(p)
        up, opt = tx.update(g, opt)
        return optax.apply_updates(p, up), bs, opt, lv

    jv = jax.tree.map(jnp.asarray, tree)
    p, bs = jv["params"], jv["batch_stats"]
    opt = tx.init(p)
    want = []
    for _ in range(STEPS):
        p, bs, opt, lv = step(p, bs, opt)
        want.append(float(lv))
    runs = {}
    for dt, n in ((torch.float32, STEPS), (torch.float64, 2)):
        model, params = _master_port(tree, dt)
        adam = ClipAdamW(constant_schedule(2e-3), float("inf"),
                         weight_decay=0.0)
        state = adam.init(params)
        losses = []
        for _ in range(n):
            lv, grads = _port_grads(model, params,
                                    lambda: _master_loss(model, x, ids))
            up, state = adam.update(grads, state, params)
            with torch.no_grad():
                for k, u in up.items():
                    params[k].add_(u.to(params[k].dtype))
            losses.append(lv)
        runs[dt] = losses
    got, exact = runs[torch.float32], runs[torch.float64]
    _close(got[0], want[0], LOSS_TOL, "step 0")
    # the second step: both f32 sides within 1e-3 of float64 (the port
    # 2.4e-4, JAX 1.1e-4 on this tree)
    _close(got[1], exact[1], SECOND_STEP_TOL, "port step 1")
    _close(want[1], exact[1], SECOND_STEP_TOL, "jax step 1")
    assert got[-1] < got[0] and want[-1] < want[0]
