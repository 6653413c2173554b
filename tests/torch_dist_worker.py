"""One rank of a gloo process group for the port's parallel tests
(tests/test_torch_parallel.py, tests/test_torch_parallel_runner.py,
tests/test_torch_tp_sp.py).

    python tests/torch_dist_worker.py CASE RANK WORLD PORT IN_FILE OUT_FILE

The test process writes the case's inputs (``torch.save``) to IN_FILE and
starts WORLD of these in fresh interpreters; each joins the group at
127.0.0.1:PORT, runs CASE and writes its results to OUT_FILE. This module
imports no JAX: the JAX side of each comparison runs in the test process.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

GROUP_TIMEOUT_S = 120


def add_lines(quads, shapes, lines=8):
    """bench.py's line grid after the detected quads, as
    tests/test_torch_pipeline.py::add_lines draws it."""
    out = []
    for (h, w), q in zip(shapes, quads):
        rng = np.random.default_rng(int(h) * 7 + int(w))
        grid = []
        y = 60
        while y < h - 80 and len(grid) < lines:
            x = 70
            ww = int(rng.integers(120, 360))
            grid.append([[x, y], [x + ww, y], [x + ww, y + 22], [x, y + 22]])
            y += 36
        out.append(np.concatenate([np.asarray(q).reshape(-1, 4, 2),
                                   np.asarray(grid, np.float32)], axis=0))
    return out


def inject_lines(bp, lines=8):
    orig = bp._boxes_finish

    def boxes_finish_with_lines(packed, shapes, bucket_hw, prob_hw):
        return add_lines(orig(packed, shapes, bucket_hw, prob_hw), shapes,
                         lines)

    bp._boxes_finish = boxes_finish_with_lines


def build_pipeline(inp, mesh):
    """The runner of tests/test_torch_pipeline.py::port_pipeline (LORE,
    the 0/180 classifier, crops from the resident canvases) on ``mesh``,
    its tasks built on the mesh in one order on every rank."""
    from pdf_table_tpu_torch.models.lore.config import LoreConfig
    from pdf_table_tpu_torch.pipeline.batch_runner import BatchPipeline
    from pdf_table_tpu_torch.pipeline.system import OcrSystemConfig
    from pdf_table_tpu_torch.tasks.cls_pulc import ClsImagePulcTask
    from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask
    from pdf_table_tpu_torch.tasks.layout import OcrLayoutTask
    from pdf_table_tpu_torch.tasks.recognition import OcrRecognitionTask
    from pdf_table_tpu_torch.tasks.table_structure import \
        OcrTableStructureTask

    trees, kw = inp["trees"], inp["kw"]
    cfg = OcrSystemConfig(use_layout=True, use_table=True,
                          use_orientation_cls=False, use_textline_cls=True)
    bp = BatchPipeline(cfg, mesh=mesh, batch_pages=2, device="cpu",
                       device_crops=True)
    s = bp.system
    s._det = OcrDetectionTask(model="PP-OCRv4_det", device="cpu", mesh=mesh,
                              variables=trees["det"], **kw["det"])
    s._layout = OcrLayoutTask(model="picodet", device="cpu", mesh=mesh,
                              variables=trees["layout"], **kw["layout"])
    s._rec = OcrRecognitionTask(model="PP-OCRv4_rec", device="cpu",
                                mesh=mesh, variables=trees["rec"],
                                **kw["rec"])
    s._tsr = OcrTableStructureTask(
        model="Lore", task_type="wireless", device="cpu", mesh=mesh,
        config=LoreConfig.wireless(**kw["lore"]), variables=trees["lore"])
    s._line_cls = ClsImagePulcTask("textline_orientation", device="cpu",
                                   mesh=mesh, variables=trees["cls"])
    inject_lines(bp, kw["lines"])
    return bp


def page_summary(out):
    """What the tests hold of a page: quads, texts and scores, layout
    cells, table and page HTML, the metric."""
    return {"page": out.page, "metric": dict(out.metric or {}),
            "image_shape": tuple(out.image_shape or ()),
            "quads": np.asarray([c.poly for c in out.text_cells],
                                np.float32),
            "texts": [c.text for c in out.text_cells],
            "scores": [float(c.score) for c in out.text_cells],
            "layout": [(c.label, c.text, c.cell_type.name)
                       for c in out.layout_cells],
            "layout_boxes": [tuple(c.bbox) for c in out.layout_cells],
            "layout_scores": [float(c.score) for c in out.layout_cells],
            "table_html": list(out.table_html),
            "page_html": out.page_html}


# -- cases ---------------------------------------------------------------------

def case_mesh(rank, world, inp):
    """make_mesh, the placements, shard_batch and replicate_params on a
    1-D dp mesh; the dp coordinate on meshes with tp and sp axes, and the
    refusal of an unknown axis."""
    from pdf_table_tpu_torch.parallel import (data_sharding, make_mesh,
                                              replicate_params,
                                              replicated_sharding,
                                              shard_batch)
    from pdf_table_tpu_torch.parallel.mesh import dp_rank_and_size

    mesh = make_mesh(device="cpu")
    rows, n = shard_batch(inp["batch"], mesh)
    torch.manual_seed(rank)            # each rank starts from its own tree
    model = torch.nn.Sequential(torch.nn.Linear(4, 3),
                                torch.nn.BatchNorm1d(3))
    with torch.no_grad():
        model[1].running_mean.uniform_()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    replicate_params(model, mesh)
    tree = {"w": torch.full((2,), float(rank)), "b": [torch.tensor(rank)]}
    replicate_params(tree, mesh)
    taken, refusals = {}, {}
    for axes, devices in ((("dp", "tp"), np.arange(world)[:, None]),
                          (("dp", "sp"), np.arange(world)[None]),
                          (("tp", "dp"), np.arange(world)[None])):
        sub = make_mesh(axis_names=axes, devices=devices, device="cpu")
        taken["/".join(axes)] = dp_rank_and_size(sub)
    for axes in (("dp", "pp"),):
        sub = make_mesh(axis_names=axes, devices=np.arange(world)[None],
                        device="cpu")
        try:
            dp_rank_and_size(sub)
        except ValueError as e:
            refusals["/".join(axes)] = str(e)
    return {"shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
            "dp": dp_rank_and_size(mesh), "n": n,
            "rows": {k: v.numpy() for k, v in rows.items()},
            "data_sharding": [str(p) for p in data_sharding(mesh)],
            "replicated": [str(p) for p in replicated_sharding(mesh)],
            "before": {k: v.numpy() for k, v in before.items()},
            "after": {k: v.numpy() for k, v in model.state_dict().items()},
            "tree": (tree["w"].numpy(), int(tree["b"][0])),
            "taken": taken, "refusals": refusals}


def mlp_stage(params, x):
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def case_gpipe(rank, world, inp):
    """gpipe_apply over a pp mesh of every rank: the outputs and each
    rank's gradient of the mean squared error against ones, per stream."""
    from pdf_table_tpu_torch.parallel import make_mesh
    from pdf_table_tpu_torch.parallel.pipeline import gpipe_apply

    mesh = make_mesh(axis_names=("pp",), device="cpu")
    out = {}
    for name, mb in inp["streams"].items():
        params = {k: torch.tensor(v, requires_grad=True)
                  for k, v in inp["params"].items()}
        x = torch.tensor(mb)
        y = gpipe_apply(mlp_stage, params, x, mesh)
        loss = ((y - torch.ones_like(y)) ** 2).mean()
        loss.backward()
        out[name] = {"y": y.detach().numpy(), "loss": float(loss),
                     "grads": {k: p.grad.numpy() for k, p in params.items()}}
    return out


def runner_and_service(rank, inp, mesh):
    """The runner on ``inp["pages"]`` and the service on
    ``inp["payloads"]`` over ``mesh``; rank 0 also runs the meshless
    runner on the same tasks (``solo``) and submits the payloads, the
    other ranks serve."""
    from pdf_table_tpu_torch import serve
    from pdf_table_tpu_torch.pipeline.batch_runner import BatchPipeline
    from pdf_table_tpu_torch.pipeline.system import OcrSystemConfig

    bp = build_pipeline(inp, mesh)
    pages = [{"image": p, "page": i} for i, p in enumerate(inp["pages"])]
    res = {"pages": [page_summary(o) for o in bp.run(pages)],
           "own_stats_pages": bp.last_stats["n_pages"]}
    if rank == 0:
        # the meshless runner on the same tasks: every page in one process
        solo = BatchPipeline(bp.system.config, batch_pages=2, device="cpu",
                             device_crops=True)
        solo.system = bp.system
        inject_lines(solo, inp["kw"]["lines"])
        res["solo"] = [page_summary(o) for o in solo.run(pages)]

    svc = serve.ExtractionService(OcrSystemConfig(), batch_pages=4,
                                  max_wait_ms=50.0, mesh=mesh, device="cpu")
    svc.pipeline = bp
    if rank == 0:
        try:
            res["served"] = [svc.submit(kind, payload)
                             for kind, payload in inp["payloads"]]
        finally:
            svc.close()
    else:
        svc.serve_worker()
    return res


def case_runner(rank, world, inp):
    """The dp runner on the pages, the dp service on the payloads, the dp
    LORE step on the global batch."""
    from pdf_table_tpu_torch.models.lore.config import LoreConfig
    from pdf_table_tpu_torch.parallel import make_mesh
    from pdf_table_tpu_torch.train.lore_trainer import (LoreTrainArgs,
                                                        LoreTrainer)

    mesh = make_mesh(device="cpu")
    res = runner_and_service(rank, inp, mesh)
    tr = LoreTrainer(LoreConfig.wtw(**inp["lore_tiny"]),
                     LoreTrainArgs(**inp["train_args"]), mesh=mesh,
                     device="cpu")
    tr.init_state(inp["lore_tree"])
    res["step"] = tr.train_step(inp["train_batch"])
    res["mu"] = {k: v.numpy() for k, v in tr.state.opt_state["mu"].items()}
    res["params"] = {k: v.detach().numpy()
                     for k, v in tr.state.params.items()}
    return res


LAYER_STACK = ("conv3x3/1", "conv3x3/2", "conv7x7/1", "dla_pool",
               "resnet_pool", "deconv4x4/2", "depthwise_up2", "conv1x1/2")


def layer_stack(x, weights, rows=None):
    """The row-sharded layers of the sp region one after another
    (LAYER_STACK, each followed by tanh): the plain ops with ``rows``
    None, on this rank's rows in an enabled sp region."""
    from pdf_table_tpu_torch.parallel import spatial

    w = iter(weights)
    for kind in LAYER_STACK:
        if kind.startswith("conv"):
            k, s = (int(v) for v in kind[4:].replace("x", "/").split("/")
                    [1:])
            x = spatial.conv2d(x, next(w), next(w), (s, s), (k // 2,) * 2,
                               (1, 1), 1, rows)
        elif kind == "dla_pool":
            x = spatial.max_pool2d(x, 2, 2, 0, rows)
        elif kind == "resnet_pool":
            x = spatial.max_pool2d(x, 3, 2, 1, rows)
        elif kind == "deconv4x4/2":
            # conv_transpose_same(C, C, 4, 2): torch padding 1, no output
            # padding
            x = spatial.conv_transpose2d(x, next(w), None, (2, 2), (1, 1),
                                         (0, 0), 1, (1, 1), rows)
        else:
            wd = next(w)
            x = spatial.conv_transpose2d(x, wd, None, (2, 2), (1, 1),
                                         (0, 0), wd.shape[0], (1, 1), rows)
        x = torch.tanh(x)
    return x


def _crc(t):
    import zlib

    return zlib.crc32(t.detach().contiguous().numpy().tobytes())


def _lore_config(inp, name):
    from pdf_table_tpu_torch.models.lore.config import LoreConfig

    kw = inp["configs"][name]
    return LoreConfig(**kw) if name == "resnet18" else LoreConfig.wtw(**kw)


def _mesh3(dims):
    from pdf_table_tpu_torch.parallel import make_mesh

    return make_mesh(axis_names=("dp", "tp", "sp"),
                     devices=np.arange(int(np.prod(dims))).reshape(dims),
                     device="cpu")


def _trainer(inp, run, mesh, out_dir):
    from pdf_table_tpu_torch.train.lore_trainer import (LoreTrainArgs,
                                                        LoreTrainer)

    args = dict(inp["train_args"], output_dir=out_dir,
                remat=run.get("remat", False),
                grad_accum_steps=run.get("accum", 1))
    tr = LoreTrainer(_lore_config(inp, run["config"]),
                     LoreTrainArgs(**args), mesh=mesh, device="cpu",
                     min_shard_dim=run.get("min_shard_dim", 256))
    tr.init_state(inp["trees"][run["config"]])
    return tr


def case_tp_sp(rank, world, inp):
    """The tp and sp axes: (c) the layer stack at sp = 4, each rank's
    output rows and gradients; (d) each run of ``inp["runs"]`` (a LORE
    step on a dp x tp x sp mesh: its losses, its whole params and Adam
    first moments, written by rank 0 beside the results, the checksums of
    this rank's params); (e) after the run marked ``resume``, a save /
    restore / resume against the next step taken through; (f) the runner
    and the service on a (2, 2, 1) mesh."""
    from pdf_table_tpu_torch.parallel.collectives import (
        collective_bytes, collective_calls, reset_collective_counts,
        split_rows)
    from pdf_table_tpu_torch.parallel.mesh import axis_rank_and_size
    from pdf_table_tpu_torch.parallel.spatial import Rows

    out = {}
    lay = inp["layers"]
    mesh = _mesh3((1, 1, world))
    rows = Rows(mesh)
    x = torch.from_numpy(lay["x"])
    starts = split_rows(x.shape[2], world)
    xl = x[:, :, starts[rank]:starts[rank + 1]].clone().requires_grad_()
    weights = [torch.from_numpy(w).requires_grad_() for w in lay["weights"]]
    with rows.region(True):
        y = layer_stack(xl, weights, rows)
        so = split_rows(lay["gout"].shape[2], world)
        g = torch.from_numpy(lay["gout"])[:, :, so[rank]:so[rank + 1]]
        grads = torch.autograd.grad((y * g).sum(), [xl] + weights)
    out["layers"] = {"y": y.detach().numpy(),
                     "grads": [t.numpy() for t in grads]}

    out["runs"] = []
    side = inp["side_dir"]
    for i, run in enumerate(inp["runs"]):
        mesh = _mesh3(run["mesh"])
        tr = _trainer(inp, run, mesh, os.path.join(side, f"run{i}"))
        reset_collective_counts()
        losses = tr.train_step(inp["batches"][run["batch"]])
        calls, nbytes = dict(collective_calls), dict(collective_bytes)
        params = tr.whole(tr.state.params)
        mu = tr.whole(tr.state.opt_state["mu"])
        if rank == 0:
            torch.save({"params": {k: v.numpy() for k, v in params.items()},
                        "mu": {k: v.numpy() for k, v in mu.items()}},
                       os.path.join(side, f"run{i}.pt"))
        out["runs"].append({
            "losses": losses, "calls": calls, "bytes": nbytes,
            "coords": {a: axis_rank_and_size(mesh, a)
                       for a in ("dp", "tp", "sp")},
            "sharded": sorted(tr.state.sharding.dims),
            "shapes": {k: tuple(v.shape) for k, v in
                       tr.state.params.items()},
            "crc": {k: _crc(v) for k, v in tr.state.params.items()},
            "rows_split": tr.rows is not None and "halo_rows" in calls})
        if run.get("resume"):
            # (e) the next step straight through, and again from the
            # train state saved before it
            b2 = inp["batches"][run["resume"]]
            saved = tr.save_train_state(os.path.join(side, "train_state"))
            through = tr.train_step(b2)
            want = {k: _crc(v) for k, v in tr.state.params.items()}
            tr2 = _trainer(inp, run, mesh, os.path.join(side, "resume"))
            tr2.restore_train_state(saved)
            resumed = tr2.train_step(b2)
            out["resume"] = {
                "through": through, "resumed": resumed,
                "step": tr2.state.step, "path": saved,
                "params_equal": want == {
                    k: _crc(v) for k, v in tr2.state.params.items()}}

    # (f) the runner and the service split their pages over dp only
    out["runner"] = runner_and_service(rank, inp["runner"],
                                       _mesh3((2, 2, 1)))
    return out


CASES = {"mesh": case_mesh, "gpipe": case_gpipe, "runner": case_runner,
         "tp_sp": case_tp_sp}


# -- the test process's side ---------------------------------------------------

class Group:
    """WORLD worker processes of one case, started at once; ``results()``
    waits for them (at most ``timeout`` seconds in all), kills every one
    left when one fails or the time is up, and returns each rank's
    results."""

    def __init__(self, case, world, inputs, tmp_dir, timeout=240.0):
        import socket
        import subprocess
        import time

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        in_file = os.path.join(tmp_dir, f"{case}_in.pt")
        torch.save(inputs, in_file)
        self.outs = [os.path.join(tmp_dir, f"{case}_out{r}.pt")
                     for r in range(world)]
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PDF_TABLE_TPU_ALLOW_RANDOM_INIT="quiet")
        self.deadline = time.monotonic() + timeout
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(r),
             str(world), str(port), in_file, self.outs[r]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]

    def results(self):
        import subprocess
        import time

        logs = []
        try:
            for p in self.procs:
                left = max(self.deadline - time.monotonic(), 0.1)
                logs.append(p.communicate(timeout=left)[0].decode(
                    errors="replace"))
                if p.returncode:
                    raise RuntimeError(f"rank {len(logs) - 1} exited "
                                       f"{p.returncode}:\n{logs[-1]}")
        except subprocess.TimeoutExpired:
            raise RuntimeError("the process group timed out") from None
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return [torch.load(f, weights_only=False) for f in self.outs]


def main(argv):
    case, rank, world, port, in_file, out_file = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    os.environ.setdefault("PDF_TABLE_TPU_ALLOW_RANDOM_INIT", "quiet")
    import torch.distributed as dist

    from pdf_table_tpu_torch.parallel.multihost import initialize

    assert initialize(f"127.0.0.1:{port}", world, rank, device="cpu",
                      timeout=GROUP_TIMEOUT_S) == (rank, world)
    try:
        inp = torch.load(in_file, weights_only=False)
        out = CASES[case](rank, world, inp)
        out["jax_imported"] = "jax" in sys.modules
        out["pdf_table_tpu_imported"] = any(
            m == "pdf_table_tpu" or m.startswith("pdf_table_tpu.")
            for m in sys.modules)
        torch.save(out, out_file)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
