#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (pdf_table_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles the deform-conv kernel from ops/kernels/csrc with nvcc;
  3. kernels: the deform-conv kernel against its plain PyTorch version at
     every LORE DCN shape (768^2 crops and the 384/512 buckets, B=2), bf16
     and one f32 shape; then at the main path's own shapes (the slice's
     one sub-batch of 8 crops at 768^2), timed beside each call's bound;
  4. slice: OcrTableStructureTask(model="Lore", task_type="wireless",
     dtype="bfloat16") at full LORE width over 4 synthetic 1224x950 pages
     with 2 table regions each, on numpy-seeded weights (offset convs
     perturbed), down to per-table HTML; the launch count shows the path
     went through the kernel; a yardstick LoreModel(plain_dcn=True) on the
     same weights and crops holds its outputs.
Prints the card line, one {"kernels": [...]} line, and as the last line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
REPLACES = "pdf_table_tpu/ops/pallas/deform_blend.py:190"
SOURCE = "pdf_table_tpu_torch/ops/kernels/csrc/deform_conv.cu"
# every LORE DCN at a 768^2 crop: (side, Cin, Cout, calls per forward)
DCN_SHAPES_768 = [(192, 64, 64, 5), (96, 128, 64, 4), (96, 128, 128, 2),
                  (48, 256, 128, 2), (48, 256, 256, 1), (48, 256, 64, 1),
                  (24, 512, 256, 1)]
MAIN_BATCH = 8   # the slice below runs its 8 crops as one sub-batch
# max |err| / max |plain out|: both sides take the same operands and sum
# in f32, in another order, in either dtype
TOL = {"bfloat16": 1e-4, "float32": 1e-4}
# yardstick run (bf16 model, deform conv kernel vs plain): both sum the DCN
# in f32 in another order, so bf16 roundings of activations flip and spread
# through ~40 layers
HEADS_TOL = 5e-2        # max |diff| / max |head| per head
MATCH_MIN = 0.9         # share of valid slots found in both runs
DETS_TOL = 0.25         # feature-map px, on slots valid in both runs
LOGI_TOL = 5e-2         # max |diff| / max |logi|, same slots
# random weights put the cell heatmap near sigmoid(-2.19) = 0.10, so the
# smoke lowers the threshold for valid cells to exist
VIS_THRESH = 0.1


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def make_page(seed: int, h: int = 1224, w: int = 950):
    """Synthetic text-like page: dark line bars on white (bench.py)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 255, np.uint8)
    y = 60
    while y < h - 60:
        n_words = rng.integers(3, 8)
        x = 70
        for _ in range(n_words):
            ww = int(rng.integers(60, 160))
            if x + ww > w - 70:
                break
            img[y:y + 16, x:x + ww] = rng.integers(20, 60)
            x += ww + 18
        y += int(rng.integers(26, 40))
    return img


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dcn_bound(b, hw, cin, cout, dtype: str):
    """Least time for one call: max(ops / peak, compulsory bytes / rate)."""
    esize = 2 if dtype == "bfloat16" else 4
    px = b * hw * hw
    flops = 2 * px * 9 * cin * cout
    nbytes = (px * cin * esize + px * 18 * 4 + px * 9 * 4
              + 9 * cin * cout * esize + cout * 4 + px * cout * 4)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops, t_bytes


def phase_kernels(gen):
    import torch

    from pdf_table_tpu_torch.ops.deform_conv import (deform_conv2d,
                                                     deform_conv2d_plain)
    from pdf_table_tpu_torch.ops.kernels import launch_counts

    dev = torch.device("cuda")
    # (crop side, fmap side, Cin, Cout, calls per forward, dtype, batch)
    cases = [(768, hw, ci, co, n, "bfloat16", 2)
             for hw, ci, co, n in DCN_SHAPES_768]
    for side in (384, 512):
        cases += [(side, hw * side // 768, ci, co, n, "bfloat16", 2)
                  for hw, ci, co, n in DCN_SHAPES_768]
    cases.append((768, 48, 256, 128, 2, "float32", 2))
    cases += [(768, hw, ci, co, n, "bfloat16", MAIN_BATCH)
              for hw, ci, co, n in DCN_SHAPES_768]
    rows = []
    for crop, hw, cin, cout, calls, dname, B in cases:
        dt = getattr(torch, dname)
        x = torch.randn(B, hw, hw, cin, device=dev, generator=gen).to(dt)
        off = torch.randn(B, hw, hw, 18, device=dev, generator=gen) * 3.0
        mask = torch.rand(B, hw, hw, 9, device=dev, generator=gen)
        w = (torch.randn(3, 3, cin, cout, device=dev, generator=gen)
             * (2.0 / (9 * cin)) ** 0.5).to(dt)
        bias = torch.randn(cout, device=dev, generator=gen)
        n0 = launch_counts["deform_conv2d"]
        got = deform_conv2d(x, off, mask, w, bias)
        torch.cuda.synchronize()
        check(launch_counts["deform_conv2d"] == n0 + 1,
              "deform_conv2d did not count its launch")
        want = deform_conv2d_plain(x, off, mask, w, bias)
        abs_err = float((got - want).abs().max())
        rel = abs_err / float(want.abs().max())
        check(rel < TOL[dname], f"deform_conv2d {crop} {hw}^2 {cin}->{cout} "
              f"{dname} B={B}: rel err {rel:.3g} >= {TOL[dname]}")
        row = {"crop": crop, "hw": hw, "cin": cin, "cout": cout, "batch": B,
               "dtype": dname, "calls_per_forward": calls,
               "max_abs_err": abs_err, "rel_err": rel}
        if B == MAIN_BATCH or dname == "float32":
            bound, t_ops, t_bytes = dcn_bound(B, hw, cin, cout, dname)
            row.update(
                ms=cuda_ms(lambda: deform_conv2d(x, off, mask, w, bias), 20),
                plain_ms=cuda_ms(
                    lambda: deform_conv2d_plain(x, off, mask, w, bias), 3, 1),
                bound_ms=bound, ops_ms=t_ops, bytes_ms=t_bytes,
                bound_by="operations" if t_ops >= t_bytes else "bytes")
        rows.append(row)
    return rows


def kernels_line(rows, launches: int) -> dict:
    """One entry per kernel. Times are summed over the 16 DCN calls of one
    forward of the main path's sub-batch (B=8 at 768^2, bf16); ``shapes``
    lists every checked shape with its error and, where timed, its times."""
    main = [r for r in rows
            if r["batch"] == MAIN_BATCH and r["dtype"] == "bfloat16"]

    def total(key):
        return sum(r[key] * r["calls_per_forward"] for r in main)

    return {"kernels": [{
        "name": "deform_conv2d", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if total("ops_ms") >= total("bytes_ms")
        else "bytes",
        "library_ms": None, "shapes": rows}]}


def compare_runs(task, plain, pages, regions):
    """The task's model against the plain-deform-conv yardstick ``plain``
    on the same crops: heads, then valid slots matched by feature-map
    index."""
    import torch

    worst = {"heads": 0.0, "dets_px": 0.0, "logi": 0.0, "match": 1.0,
             "valid_slots": 0}
    with torch.inference_mode():
        for sub, _metas, x in task.sub_batches(pages, regions):
            ha, hb = task.model.heads(x), plain.heads(x)
            for k in ha:
                rel = float((ha[k] - hb[k]).abs().max()
                            / hb[k].abs().max().clamp_min(1e-6))
                worst["heads"] = max(worst["heads"], rel)
            fa, fb = task.model.features(x), plain.features(x)
            pa, pb = task.model.proc_pack(fa), plain.proc_pack(fb)
            for j in range(len(sub)):
                va = fa["valid"][j].nonzero().flatten().tolist()
                vb = fb["valid"][j].nonzero().flatten().tolist()
                ia = {int(fa["inds"][j, s]): s for s in va}
                ib = {int(fb["inds"][j, s]): s for s in vb}
                common = sorted(set(ia) & set(ib))
                worst["valid_slots"] += len(va)
                if ia or ib:
                    worst["match"] = min(worst["match"], len(common)
                                         / max(len(ia), len(ib)))
                if not common:
                    continue
                sa = torch.tensor([ia[i] for i in common])
                sb = torch.tensor([ib[i] for i in common])
                dd = (fa["dets"][j, sa] - fb["dets"][j, sb]).abs().max()
                worst["dets_px"] = max(worst["dets_px"], float(dd))
                la, lb = pa[j, sa, 16:20], pb[j, sb, 16:20]
                rel = float((la - lb).abs().max()
                            / lb.abs().max().clamp_min(1e-6))
                worst["logi"] = max(worst["logi"], rel)
    return worst


SLICE_KW = dict(dtype="bfloat16", vis_thresh=VIS_THRESH)


def slice_setup(device="cuda"):
    """The smoke's slice: the bf16 wireless LORE task at full width on
    seeded weights, 4 synthetic pages, 2 table regions each.
    Returns (task, variables, pages, regions)."""
    import numpy as np

    from pdf_table_tpu_torch.engine.params import (init_lore,
                                                   perturb_conv_offset_mask)
    from pdf_table_tpu_torch.tasks.table_structure import (
        OcrTableStructureTask, lore_config)

    cfg = lore_config("wireless", **SLICE_KW)
    variables = perturb_conv_offset_mask(init_lore(cfg, seed=0), seed=1)
    # random heads put every cell corner on its center, and the post filter
    # drops cells under 1 px: give the corners a fixed 6 feature-map px
    # offset and widen the logical regressor's output 10x, so tables carry
    # cells and a grid (the tests shape their weights the same way)
    prm = variables["params"]
    prm["detector"]["heads"]["wh_out"]["bias"] = np.array(
        [6, 6, -6, 6, -6, -6, 6, -6], np.float32)
    prm["processor"]["stacker"]["tsfm"]["decoder"]["linear_2"]["kernel"] *= 10
    task = OcrTableStructureTask(model="Lore", task_type="wireless",
                                 device=device, variables=variables,
                                 res_buckets="auto", **SLICE_KW)
    pages = np.stack([make_page(i) for i in range(4)])
    regions = [(pi, box) for pi in range(4)
               for box in ((70, 100, 880, 560), (70, 620, 880, 1150))]
    return task, variables, pages, regions


def phase_slice(card):
    import numpy as np
    import torch

    from pdf_table_tpu_torch.convert.flax_bridge import load_flax_variables
    from pdf_table_tpu_torch.models.lore.model import LoreModel
    from pdf_table_tpu_torch.ops.kernels import (launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.tasks.table_to_html import OcrTableToHtmlTask

    t0 = time.perf_counter()
    task, variables, pages, regions = slice_setup()
    build_s = time.perf_counter() - t0
    n_sub = sum(1 for _ in task.sub_batches(pages, regions))

    # the main path, counted
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results = task.batch_infer_from_pages(pages, regions)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = launch_counts["deform_conv2d"]
    check(launches == 16 * n_sub,
          f"deform_conv2d launched {launches} times, expected {16 * n_sub}")
    htmls = [OcrTableToHtmlTask()(r, []) for r in results]
    check(len(results) == len(regions), "one result per region")
    check(all(isinstance(r.get("cells"), list) for r in results),
          "every result carries a cell list")
    check(all(h.startswith("<table") for h in htmls), "table HTML")
    for r in results:
        for c in r["cells"]:
            check(all(np.isfinite(c["bbox"])) and len(c["logic"]) == 4,
                  "cells are finite with 4 logical coords")

    # steady state: each run ends in the packed output's download
    torch.cuda.reset_peak_memory_stats()
    run_s = []
    for _ in range(10):
        t0 = time.perf_counter()
        task.batch_infer_from_pages(pages, regions)
        run_s.append(time.perf_counter() - t0)
    per_run = statistics.median(run_s)
    peak = torch.cuda.max_memory_allocated()

    plain = LoreModel(task.model_config, plain_dcn=True).eval()
    load_flax_variables(plain, variables)
    plain.to("cuda")
    before = launch_counts["deform_conv2d"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for _sub, _metas, x in task.sub_batches(pages, regions):
            plain.proc_pack(plain.features(x)).cpu()
    plain_run = time.perf_counter() - t0
    check(launch_counts["deform_conv2d"] == before,
          "the plain yardstick launched the kernel")
    cmp = compare_runs(task, plain, pages, regions)
    summary = {
        "card": card, "crops": len(regions), "sub_batches": n_sub,
        "dcn_launches": launches, "model_build_s": build_s,
        "first_run_s": first_s, "run_s_median": per_run,
        "run_s_min": min(run_s), "run_s_max": max(run_s), "runs": len(run_s),
        "crops_per_s": len(regions) / per_run,
        "ms_per_crop": per_run * 1e3 / len(regions),
        "peak_mem_gib": peak / 2 ** 30,
        "plain_dcn_run_s": plain_run,
        "cells_per_table": [len(r["cells"]) for r in results],
        "html_bytes": [len(h) for h in htmls], "yardstick": cmp,
    }
    print(json.dumps({"slice": summary}))
    check(cmp["valid_slots"] > 0, "no valid slots to compare")
    check(cmp["heads"] < HEADS_TOL, f"heads differ: {cmp['heads']:.3g}")
    check(cmp["match"] >= MATCH_MIN, f"valid slots differ: {cmp['match']}")
    check(cmp["dets_px"] < DETS_TOL, f"dets differ: {cmp['dets_px']:.3g}")
    check(cmp["logi"] < LOGI_TOL, f"logi differ: {cmp['logi']:.3g}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pdf_table_tpu_torch.engine.device import set_float_precision
    from pdf_table_tpu_torch.ops.kernels import build

    set_float_precision()
    card = card_line()
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = build.build("deform_conv")
    print(json.dumps({"build_s": time.perf_counter() - t0}))
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas deform_conv: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = phase_kernels(gen)
    launches = phase_slice(card)
    check("jax" not in sys.modules and "pdf_table_tpu" not in sys.modules,
          "the port imported JAX or the JAX package")
    print(card)
    print(json.dumps(kernels_line(rows, launches)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
