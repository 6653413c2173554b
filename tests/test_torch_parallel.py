"""The port's parallel/ package against the JAX package's on the CPU: the
multi-process sharding math (every n in 0..40 over 1-5 processes), the
dp mesh, its placements, ``shard_batch`` and ``replicate_params`` on a
2-rank gloo group (and the dp coordinate of meshes with tp and sp axes), and GPipe over a 4-rank pp group against
``sequential_apply`` and JAX's ``gpipe_apply`` on a 4-device pp mesh (the
stack of tests/test_parallel_pp.py), forward and gradients to 1e-5.

The groups run in fresh interpreters (tests/torch_dist_worker.py), which
import no JAX; their joins and collectives are bounded, and a group that
fails or hangs is killed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pdf_table_tpu.parallel import mesh as jmesh
from pdf_table_tpu.parallel import multihost as jmh
from pdf_table_tpu.parallel.pipeline import gpipe_apply as jgpipe_apply
from pdf_table_tpu.parallel.pipeline import \
    sequential_apply as jsequential_apply
from pdf_table_tpu_torch import parallel
from pdf_table_tpu_torch.parallel import mesh as tmesh
from pdf_table_tpu_torch.parallel import multihost as tmh
from pdf_table_tpu_torch.parallel.pipeline import sequential_apply
from torch_dist_worker import Group, mlp_stage

torch.set_num_threads(1)

TOL = 1e-5
L, D, HD = 4, 16, 24


def _stack():
    """tests/test_parallel_pp.py's stack (its ``stack`` fixture) and its two
    microbatch streams."""
    rng = np.random.default_rng(0)
    params = {
        "w1": (rng.normal(size=(L, D, HD)) * 0.3).astype(np.float32),
        "b1": (rng.normal(size=(L, HD)) * 0.1).astype(np.float32),
        "w2": (rng.normal(size=(L, HD, D)) * 0.3).astype(np.float32),
        "b2": (rng.normal(size=(L, D)) * 0.1).astype(np.float32),
    }
    mb = rng.normal(size=(6, 5, D)).astype(np.float32)
    more = np.random.default_rng(1).normal(size=(9, 3, D)).astype(np.float32)
    return params, {"six": mb, "nine": more}


BATCH = {"x": np.arange(5 * 3, dtype=np.float32).reshape(5, 3),
         "y": np.arange(5, dtype=np.int64)}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both groups started together: (mesh results, gpipe results), one
    entry per rank."""
    tmp = str(tmp_path_factory.mktemp("groups"))
    params, streams = _stack()
    mesh_group = Group("mesh", 2, {"batch": BATCH}, tmp)
    gpipe_group = Group("gpipe", 4, {"params": params, "streams": streams},
                        tmp)
    return mesh_group.results(), gpipe_group.results()


# -- multihost -----------------------------------------------------------------

@pytest.mark.parametrize("count", [1, 2, 3, 4, 5])
def test_shard_math_equals_jax(count):
    for n in range(41):
        pages = [f"p{i}" for i in range(n)]
        shards = []
        for i in range(count):
            assert tmh.shard_bounds(n, i, count) == \
                jmh.shard_bounds(n, i, count)
            shards.append(tmh.shard_pages(pages, i, count))
            assert shards[-1] == jmh.shard_pages(pages, i, count)
        assert tmh.merge_sharded_results(shards) == pages == \
            jmh.merge_sharded_results(shards)
    for bad in (-1, count):
        with pytest.raises(ValueError, match="out of range"):
            tmh.shard_bounds(3, bad, count)


def test_initialize_single_process_is_a_noop(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmh.initialize(device="cpu") == (0, 1)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        tmh.initialize(num_processes=2, device="cpu")


def test_pad_to_multiple_equals_jax():
    a = np.arange(7 * 2, dtype=np.float32).reshape(7, 2)
    for m in (1, 2, 3, 8):
        for axis in (0, 1):
            np.testing.assert_array_equal(
                parallel.pad_to_multiple(a, m, axis),
                jmesh.pad_to_multiple(a, m, axis))


def test_exports_match_jax():
    import pdf_table_tpu.parallel as jparallel

    assert parallel.__all__ == jparallel.__all__


# -- the dp mesh on two ranks --------------------------------------------------

def test_mesh_on_two_ranks(groups):
    mesh_res, _ = groups
    for r, res in enumerate(mesh_res):
        assert res["shape"] == (2,) and res["names"] == ("dp",)
        assert res["dp"] == (r, 2)
        assert res["data_sharding"] == ["S(0)"]
        assert res["replicated"] == ["R"]
        assert not res["jax_imported"] and not res["pdf_table_tpu_imported"]


def test_shard_batch_takes_its_padded_rows(groups):
    mesh_res, _ = groups
    padded = {k: jmesh.pad_to_multiple(v, 2) for k, v in BATCH.items()}
    for r, res in enumerate(mesh_res):
        assert res["n"] == 5
        for k, v in padded.items():
            np.testing.assert_array_equal(res["rows"][k], v[r * 3:r * 3 + 3])


def test_replicate_params_takes_rank0s_tree(groups):
    mesh_res, _ = groups
    r0, r1 = mesh_res
    assert not all(np.array_equal(r0["before"][k], r1["before"][k])
                   for k in r0["before"])
    for res in mesh_res:
        for k, v in r0["before"].items():
            np.testing.assert_array_equal(res["after"][k], v)
        np.testing.assert_array_equal(res["tree"][0], np.zeros(2))
        assert res["tree"][1] == 0


def test_tp_and_sp_axes_raise_naming_item_18(groups):
    """A mesh with tp or sp axes gives the dp coordinate (the train step's
    axes, tests/test_torch_tp_sp.py); another axis name still raises. (The
    name is kept from when these axes raised, naming item 18, which is
    done.)"""
    mesh_res, _ = groups
    for r, res in enumerate(mesh_res):
        assert res["taken"] == {"dp/tp": (r, 2), "dp/sp": (0, 1),
                                "tp/dp": (r, 2)}
        assert set(res["refusals"]) == {"dp/pp"}
        assert "'pp'" in res["refusals"]["dp/pp"]


def test_mesh_needs_the_group_for_several_processes():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(2, device="cpu")


# -- GPipe on four ranks -------------------------------------------------------

def _jax_run(params, mb):
    """JAX's gpipe_apply on a 4-device pp mesh: outputs, loss gradients."""
    pp_mesh = Mesh(np.array(jax.devices("cpu")[:L]), axis_names=("pp",))
    p = jax.tree.map(jnp.asarray, params)
    x = jnp.asarray(mb)

    def loss(p):
        y = jgpipe_apply(
            lambda q, v: jnp.tanh(v @ q["w1"] + q["b1"]) @ q["w2"] + q["b2"],
            p, x, pp_mesh)
        return jnp.mean((y - 1.0) ** 2), y

    # one jitted program: run op by op, the pipeline takes seconds
    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(p)
    return np.asarray(y), jax.tree.map(np.asarray, g)


@pytest.mark.parametrize("stream", ["six", "nine"])
def test_gpipe_equals_sequential_and_jax(groups, stream):
    """Both streams against the sequential stack; the six-microbatch one
    also against JAX's gpipe_apply, the nine against JAX's
    sequential_apply."""
    _, gpipe_res = groups
    params, streams = _stack()
    mb = streams[stream]
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    seq = sequential_apply(mlp_stage, tp, torch.tensor(mb))
    ((seq - 1.0) ** 2).mean().backward()
    jseq = np.asarray(jsequential_apply(
        lambda q, v: jnp.tanh(v @ q["w1"] + q["b1"]) @ q["w2"] + q["b2"],
        jax.tree.map(jnp.asarray, params), jnp.asarray(mb)))
    np.testing.assert_allclose(seq.detach().numpy(), jseq, rtol=TOL,
                               atol=TOL)
    if stream == "six":
        jy, jg = _jax_run(params, mb)
    else:
        jy, jg = jseq, {k: tp[k].grad.numpy() for k in params}
    for res in gpipe_res:
        assert not res["jax_imported"]
        got = res[stream]
        np.testing.assert_allclose(got["y"], seq.detach().numpy(),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["y"], jy, rtol=TOL, atol=TOL)
    for k in params:
        # each rank's gradient is its own stage's slice; their sum is the
        # whole stack's
        per_rank = [res[stream]["grads"][k] for res in gpipe_res]
        for r, g in enumerate(per_rank):
            others = np.delete(g, r, axis=0)
            assert not np.abs(others).max(), (k, r)
        total = np.sum(per_rank, axis=0)
        np.testing.assert_allclose(total, tp[k].grad.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=k)
        np.testing.assert_allclose(total, jg[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_gpipe_one_stage_needs_no_group():
    """At L = 1 gpipe_apply sends nothing: a one-stage mesh stand-in (no
    process group) gives the sequential outputs."""
    from pdf_table_tpu_torch.parallel.pipeline import gpipe_apply

    class OneStage:
        mesh_dim_names = ("dp",)

    params, streams = _stack()
    one = {k: torch.tensor(v[:1]) for k, v in params.items()}
    x = torch.tensor(streams["six"])
    np.testing.assert_array_equal(
        gpipe_apply(mlp_stage, one, x, OneStage()).numpy(),
        sequential_apply(mlp_stage, one, x).numpy())
