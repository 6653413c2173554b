#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (pdf_table_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles both kernels from ops/kernels/csrc, one nvcc each,
     started together;
  3. kernels: the deform-conv kernel against its plain PyTorch version at
     every LORE DCN shape (768^2 crops and the 384/512 buckets, B=2), bf16
     and one f32 shape; then at the main path's own shapes (the slice's
     one sub-batch of 8 crops at 768^2), timed beside each call's bound;
     the resize+normalize kernel against its plain version at the three
     page buckets' detector sizes (N = 1 and 8), one upscale and both
     norm styles, timed at the detection slice's shape beside its bound
     and F.interpolate + normalize;
  4. LORE slice: OcrTableStructureTask(model="Lore", task_type="wireless",
     dtype="bfloat16") at full LORE width over 4 synthetic 1224x950 pages
     with 2 table regions each, on numpy-seeded weights (offset convs
     perturbed), down to per-table HTML; the launch count shows the path
     went through the kernel; a yardstick LoreModel(plain_dcn=True) on the
     same weights and crops holds its outputs;
  5. detection slice: OcrDetectionTask(model="PP-OCRv4_det") at full
     width, f32, over 8 synthetic 1224x950 pages (one chunk: bucket
     1280x960, detector input 960x720) down to page quads, with the
     bench's detection overrides; the launch count shows the chunk went
     through the resize kernel; a yardstick run (the same model on
     resize_normalize_plain's input) holds the input, the prob maps and
     the uint8 maps, and the device boxes match the CPU's; stage times and
     the device's idle share.
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
RN_REPLACES = "pdf_table_tpu/ops/pallas/resize_norm.py:61"
RN_SOURCE = "pdf_table_tpu_torch/ops/kernels/csrc/resize_norm.cu"
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
# resize+normalize: (N, canvas H, W) -> detector (Ho, Wo); the three page
# buckets at their PP-OCRv4 sizes, N = 1 and the slice's chunk of 8, and
# one upscale. The first 8-canvas case is the slice's shape.
RN_CASES = [(n, hw, det) for hw, det in (((1280, 960), (960, 720)),
                                         ((1600, 1280), (960, 768)),
                                         ((2048, 1536), (960, 720)))
            for n in (8, 1)] + [(2, (480, 360), (960, 720))]
# both sides compute in f32 and differ only in summation order
RN_TOL = 1e-5
# F.interpolate computes the source coordinate in f32 (the tap tables in
# f64), so its weights differ by ~1e-4 near the canvas' far edge
RN_LIBRARY_TOL = 1e-2
# detection yardstick (f32 model on the kernel's vs the plain version's
# input, which differ by <= RN_TOL): prob maps and the share of uint8 map
# pixels that may differ (rounding boundaries)
DET_PROB_TOL = 1e-4
DET_U8_SHARE = 1e-4
# device boxes on the card vs the CPU: the mean-prob column is an f32 sum
# taken in another order
CC_MEAN_RTOL = 1e-6
# the bench's detection overrides (bench.py:76-78): random weights find no
# text at the PP-OCRv4 defaults
DET_KW = dict(thresh=0.45, box_thresh=0.0, max_candidates=48)
DET_PAGES = 8


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


def host_ms(fn, iters: int = 5) -> float:
    """Host clock around ``iters`` calls that end in a synchronize, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


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


def rn_bound(n, hw, det):
    """Least time for one resize_normalize call: max(ops / f32 peak,
    compulsory bytes / rate). Bytes: the uint8 canvases read once, the f32
    output written once, the two tap tables; operations: a 2x2 blend (4
    multiply-adds) and the normalize (2) per output value."""
    (H, W), (Ho, Wo) = hw, det
    nbytes = n * H * W * 3 + n * Ho * Wo * 3 * 4 + (Ho + Wo) * 12
    flops = n * Ho * Wo * 3 * 10
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops, t_bytes


def rn_library(norm):
    """The PyTorch calls for the same function: F.interpolate (bilinear,
    half-pixel, clamped) + normalize, as fn(u8, det). Timed beside the
    kernel only."""
    import torch
    import torch.nn.functional as F

    mean = torch.tensor(norm["mean"], device="cuda")[:, None, None]
    std = torch.tensor(norm["std"], device="cuda")[:, None, None]

    def fn(u8, det):
        x = u8.permute(0, 3, 1, 2)
        if norm["reverse_channels"]:
            x = x.flip(1)
        y = F.interpolate(x.float() * norm["scale"], size=det,
                          mode="bilinear", align_corners=False,
                          antialias=False)
        return ((y - mean) / std).permute(0, 2, 3, 1)
    return fn


def phase_resize(gen):
    import torch

    from pdf_table_tpu_torch.ops.kernels import launch_counts
    from pdf_table_tpu_torch.ops.resize_norm import (resize_normalize,
                                                     resize_normalize_plain)
    from pdf_table_tpu_torch.tasks.detection import NORM

    rows = []
    for i, (n, hw, det) in enumerate(RN_CASES):
        u8 = torch.randint(0, 256, (n, *hw, 3), device="cuda",
                           generator=gen, dtype=torch.uint8)
        for style, norm in NORM.items():
            n0 = launch_counts["resize_normalize"]
            got = resize_normalize(u8, det, **norm)
            torch.cuda.synchronize()
            check(launch_counts["resize_normalize"] == n0 + 1,
                  "resize_normalize did not count its launch")
            want = resize_normalize_plain(u8, det, **norm)
            err = float((got - want).abs().max())
            check(err <= RN_TOL, f"resize_normalize {n}x{hw}->{det} "
                  f"{style}: max abs err {err:.3g} > {RN_TOL}")
            row = {"batch": n, "canvas": list(hw), "det": list(det),
                   "style": style, "max_abs_err": err}
            if i == 0 and style == "imagenet":   # the slice's shape
                library = rn_library(norm)
                lib = library(u8, det)
                bound, t_ops, t_bytes = rn_bound(n, hw, det)
                row.update(
                    ms=cuda_ms(lambda: resize_normalize(u8, det, **norm), 50),
                    plain_ms=cuda_ms(
                        lambda: resize_normalize_plain(u8, det, **norm), 10),
                    library_ms=cuda_ms(lambda: library(u8, det), 20),
                    library_max_abs_err=float((lib - want).abs().max()),
                    bound_ms=bound, ops_ms=t_ops, bytes_ms=t_bytes,
                    bound_by="operations" if t_ops >= t_bytes else "bytes")
                check(row["library_max_abs_err"] <= RN_LIBRARY_TOL,
                      "F.interpolate + normalize computes another function")
            rows.append(row)
    return rows


def kernels_line(rows, launches: int, rn_rows, rn_launches: int) -> dict:
    """One entry per kernel. deform_conv2d's times are summed over the 16
    DCN calls of one forward of the main path's sub-batch (B=8 at 768^2,
    bf16); resize_normalize's are one call at the detection slice's chunk
    (8 canvases 1280x960 -> 960x720). ``shapes`` lists every checked shape
    with its error and, where timed, its times."""
    main = [r for r in rows
            if r["batch"] == MAIN_BATCH and r["dtype"] == "bfloat16"]

    def total(key):
        return sum(r[key] * r["calls_per_forward"] for r in main)

    rn = next(r for r in rn_rows if "ms" in r)
    return {"kernels": [{
        "name": "deform_conv2d", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if total("ops_ms") >= total("bytes_ms")
        else "bytes",
        "library_ms": None, "shapes": rows}, {
        "name": "resize_normalize", "route": "cuda", "source": RN_SOURCE,
        "replaces": RN_REPLACES, "launches": rn_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rn_rows),
        "ms": rn["ms"], "plain_ms": rn["plain_ms"],
        "bound_ms": rn["bound_ms"], "bound_by": rn["bound_by"],
        "library_ms": rn["library_ms"], "shapes": rn_rows}]}


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


def det_setup(device="cuda"):
    """The smoke's detection slice: PP-OCRv4 at full width, f32, seeded
    weights, the bench's overrides, 8 synthetic pages (one chunk).
    Returns (task, pages)."""
    from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask

    task = OcrDetectionTask(model="PP-OCRv4_det", device=device, **DET_KW)
    return task, [make_page(i) for i in range(DET_PAGES)]


def det_stages(task, pages) -> dict:
    """The chunk's stages, each timed alone (host_ms), and torch.profiler
    over one batch_infer_from_pages: device busy time, wall time, idle
    share and the top ops by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    (_idx, shapes, bucket, canv), = list(task.chunks(pages))
    det_hw = task.det_size(bucket)
    prob_hw = task.prob_size(det_hw)
    dev = task.device
    with torch.inference_mode():
        canvas = torch.from_numpy(canv).to(dev)
        valid = torch.from_numpy(
            task._valid_extents(shapes, bucket, prob_hw)).to(dev)
        x = task.normalize(canvas, det_hw)
        prob = task.model(x)["prob"]
        packed = task.boxes(task.quantize(prob), valid)
        packed_np = packed.cpu().numpy()
        stages = {
            "canvas_upload": host_ms(lambda: torch.from_numpy(canv).to(dev)),
            "resize_normalize": host_ms(
                lambda: task.normalize(canvas, det_hw)),
            "dbnet": host_ms(lambda: task.model(x)),
            "pool_quantize_cc": host_ms(
                lambda: task.boxes(task.quantize(prob), valid)),
            "download": host_ms(lambda: packed.cpu()),
            "host_finish": host_ms(lambda: task._boxes_finish(
                packed_np, shapes, bucket, prob_hw)),
        }
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        task.batch_infer_from_pages(pages)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op's own event carries its kernels'
    # time too and would count it twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    return {"stage_ms": stages, "profile": {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "top_ops": [{"name": e.key[:80],
                     "device_ms": e.self_device_time_total / 1e3,
                     "calls": e.count} for e in top]}}


def det_yardstick(task, pages) -> dict:
    """The task's model on the kernel's input against the same model on
    resize_normalize_plain's input, per chunk: worst input and prob
    difference, share of uint8 map pixels that differ. Then the device
    boxes on the card against the same function on the CPU, on the
    chunk's uint8 maps, at the task's threshold and at the maps' 80th
    percentile (many components on random weights): boxes and areas
    equal, means within CC_MEAN_RTOL."""
    import torch

    from pdf_table_tpu_torch.ops.connected_components import \
        batch_component_boxes_u8
    from pdf_table_tpu_torch.ops.resize_norm import resize_normalize_plain
    from pdf_table_tpu_torch.tasks.detection import CC_ITERS, MAX_COMPONENTS

    worst = {"input": 0.0, "prob": 0.0, "u8_share": 0.0, "cc_equal": True,
             "cc_mean_rel": 0.0, "cc_components": []}
    with torch.inference_mode():
        for _idx, shapes, bucket, canv in task.chunks(pages):
            canvas = torch.from_numpy(canv).to(task.device)
            det_hw = task.det_size(bucket)
            xk = task.normalize(canvas, det_hw)
            xp = resize_normalize_plain(canvas, det_hw, **task.norm)
            pk, pp = task.model(xk)["prob"], task.model(xp)["prob"]
            uk, up = task.quantize(pk), task.quantize(pp)
            worst["input"] = max(worst["input"],
                                 float((xk - xp).abs().max()))
            worst["prob"] = max(worst["prob"], float((pk - pp).abs().max()))
            worst["u8_share"] = max(worst["u8_share"],
                                    float((uk != up).float().mean()))
            valid = torch.from_numpy(task._valid_extents(
                shapes, bucket, task.prob_size(det_hw)))
            for thr in (int(round(task.model_config.thresh * 255)),
                        int(uk.float().quantile(0.8))):
                a = batch_component_boxes_u8(
                    uk, thr, valid.to(task.device), MAX_COMPONENTS,
                    CC_ITERS).cpu()
                b = batch_component_boxes_u8(uk.cpu(), thr, valid,
                                             MAX_COMPONENTS, CC_ITERS)
                cols = [0, 1, 2, 3, 5]
                worst["cc_equal"] &= torch.equal(a[..., cols], b[..., cols])
                rel = ((a[..., 4] - b[..., 4]).abs()
                       / b[..., 4].abs().clamp_min(1e-12)).max()
                worst["cc_mean_rel"] = max(worst["cc_mean_rel"], float(rel))
                worst["cc_components"].append(int((b[..., 5] > 0).sum()))
    return worst


def phase_detection(card):
    import numpy as np
    import torch

    from pdf_table_tpu_torch.ops.kernels import (launch_counts,
                                                 reset_launch_counts)

    t0 = time.perf_counter()
    task, pages = det_setup()
    build_s = time.perf_counter() - t0
    n_chunks = sum(1 for _ in task.chunks(pages))

    # the main path, counted
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    quads = task.batch_infer_from_pages(pages)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = launch_counts["resize_normalize"]
    check(launches == n_chunks, f"resize_normalize launched {launches} "
          f"times, expected {n_chunks}")
    check(len(quads) == len(pages), "one quad array per page")
    check(sum(len(q) for q in quads) > 0, "no text boxes on any page")
    for q, page in zip(quads, pages):
        h, w = page.shape[:2]
        check(q.dtype == np.float32 and q.shape[1:] == (4, 2),
              "quads are (n, 4, 2) f32")
        check(bool(np.isfinite(q).all()), "quads are finite")
        check(bool((q[..., 0] >= 0).all() and (q[..., 0] <= w).all()
                   and (q[..., 1] >= 0).all() and (q[..., 1] <= h).all()),
              "quads lie inside their page")

    # steady state: each run ends in the packed boxes' download
    torch.cuda.reset_peak_memory_stats()
    run_s = []
    for _ in range(10):
        t0 = time.perf_counter()
        task.batch_infer_from_pages(pages)
        run_s.append(time.perf_counter() - t0)
    per_run = statistics.median(run_s)
    peak = torch.cuda.max_memory_allocated()

    stages = det_stages(task, pages)
    cmp = det_yardstick(task, pages)
    summary = {
        "card": card, "pages": len(pages), "chunks": n_chunks,
        "resize_launches": launches, "model_build_s": build_s,
        "first_run_s": first_s, "run_s_median": per_run,
        "run_s_min": min(run_s), "run_s_max": max(run_s), "runs": len(run_s),
        "pages_per_s": len(pages) / per_run,
        "ms_per_page": per_run * 1e3 / len(pages),
        "peak_mem_gib": peak / 2 ** 30,
        "quads_per_page": [len(q) for q in quads], "yardstick": cmp,
        **stages,
    }
    print(json.dumps({"detection": summary}))
    check(cmp["input"] <= RN_TOL, f"det input differs: {cmp['input']:.3g}")
    check(cmp["prob"] <= DET_PROB_TOL, f"prob differs: {cmp['prob']:.3g}")
    check(cmp["u8_share"] <= DET_U8_SHARE,
          f"u8 maps differ in {cmp['u8_share']:.3g} of pixels")
    check(cmp["cc_equal"], "device boxes differ from the CPU's")
    check(cmp["cc_mean_rel"] <= CC_MEAN_RTOL,
          f"device box means differ: {cmp['cc_mean_rel']:.3g}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pdf_table_tpu_torch.engine.device import set_float_precision
    from pdf_table_tpu_torch.ops.kernels import KERNELS, build

    set_float_precision()
    card = card_line()
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = build.build_all(KERNELS.values())
    print(json.dumps({"build_s": time.perf_counter() - t0}))
    for name, lib in libs.items():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = phase_kernels(gen)
    rn_rows = phase_resize(gen)
    launches = phase_slice(card)
    rn_launches = phase_detection(card)
    check("jax" not in sys.modules and "pdf_table_tpu" not in sys.modules,
          "the port imported JAX or the JAX package")
    print(card)
    print(json.dumps(kernels_line(rows, launches, rn_rows, rn_launches)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
