#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (pdf_table_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles the three kernels from ops/kernels/csrc, one nvcc
     each, started together;
  3. kernels: the deform-conv kernel (K1) against its plain PyTorch
     version at every LORE DCN shape (768^2 crops and the 384/512 buckets,
     B=2), bf16 and one f32 shape; then at the main paths' own shapes (one
     sub-batch of 8 crops at 768^2 and at 1024^2), timed beside each
     call's bound; at the 1024^2 stride-4 shape also the flat-kc route
     (deform_conv2d_chunked: quad gather + K2) beside K1; the flat-kc
     kernel (K2) against its plain version at the wtw slice's two chunk
     shapes and two small ones, timed beside its bound and torch.matmul of
     the pre-scaled bf16 rows; the resize+normalize kernel (K3) against its
     plain version at the three page buckets' detector sizes (N = 1 and
     8), one upscale and both norm styles, timed at the detection slice's
     shape beside its bound and F.interpolate + normalize;
  4. LORE wireless slice: OcrTableStructureTask(model="Lore",
     task_type="wireless", dtype="bfloat16") at full LORE width over 4
     synthetic 1224x950 pages with 2 table regions each, on numpy-seeded
     weights (offset convs perturbed), down to per-table HTML; the launch
     count shows the path went through K1; a yardstick
     LoreModel(plain_dcn=True) on the same weights and crops holds its
     outputs;
  5. LORE wtw slice: the same with task_type="wtw" (1024^2, corner
     decode, dense vertex refine): the 8 crops run as one 1024^2
     sub-batch, whose forward launches K2 10 times (the five stride-4 DCNs,
     two tap chunks each) and K1 11 times; snapped vertices and valid
     cells are counted, the yardstick holds its outputs, the refine on the
     card equals the CPU's on the task's own decode, crops/s, peak
     memory and the device's idle share (from a device-only trace of one
     run) are printed;
  6. detection slice: OcrDetectionTask(model="PP-OCRv4_det") at full
     width, f32, over 8 synthetic 1224x950 pages (one chunk: bucket
     1280x960, detector input 960x720) down to page quads, with the
     bench's detection overrides; the launch count shows the chunk went
     through K3; a yardstick run (the same model on
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
BM_REPLACES = "pdf_table_tpu/ops/pallas/deform_blend.py:83"
BM_SOURCE = "pdf_table_tpu_torch/ops/kernels/csrc/blend_matmul.cu"
RN_REPLACES = "pdf_table_tpu/ops/pallas/resize_norm.py:61"
RN_SOURCE = "pdf_table_tpu_torch/ops/kernels/csrc/resize_norm.cu"
# every LORE DCN at a 768^2 crop: (side, Cin, Cout, calls per forward)
DCN_SHAPES_768 = [(192, 64, 64, 5), (96, 128, 64, 4), (96, 128, 128, 2),
                  (48, 256, 128, 2), (48, 256, 256, 1), (48, 256, 64, 1),
                  (24, 512, 256, 1)]
# every LORE DCN at a 1024^2 crop (the wtw slice); the first level takes
# the flat-kc route at B=8
DCN_SHAPES_1024 = [(256, 64, 64, 5), (128, 128, 64, 4), (128, 128, 128, 2),
                   (64, 256, 128, 2), (64, 256, 256, 1), (64, 256, 64, 1),
                   (32, 512, 256, 1)]
MAIN_BATCH = 8   # both LORE slices run their 8 crops as one sub-batch
# the flat-kc route against the f32 plain DCN: it rounds w4 and the blended
# product to bf16 (2^-9 relative each) before an f32 contraction
ROUTE_TOL = 1e-2
# K2 cases (rows, taps T, Cin, Cout): the wtw slice's two chunks of one
# stride-4 DCN (5 + 4 taps of 8 x 256^2 pixels), then two small ones (one
# ragged in rows and channels)
WTW_ROWS = MAIN_BATCH * 256 * 256
BM_CASES = [(WTW_ROWS, 5, 64, 64), (WTW_ROWS, 4, 64, 64), (512, 1, 32, 16),
            (1000, 9, 64, 72)]
BM_CALLS = 5     # stride-4 DCNs per wtw forward, one launch per chunk each
# max |err| / max |plain out|: the same bf16 products on both sides, summed
# in f32 in another order
BM_TOL = 1e-4
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
# wtw: the corner heatmap sits at the same level, so corners count from
# 0.1; cells the refine penalizes (x 0.4, <= 2 snap events) fall to ~0.04,
# so valid cells count from there
WTW_VIS_THRESH = 0.04
WTW_VIS_CORNER = 0.1
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
                                                     deform_conv2d_chunked,
                                                     deform_conv2d_plain,
                                                     deform_conv2d_tap,
                                                     flat_kc_route)
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
    cases += [(1024, hw, ci, co, n, "bfloat16", MAIN_BATCH)
              for hw, ci, co, n in DCN_SHAPES_1024]
    rows = []
    for crop, hw, cin, cout, calls, dname, B in cases:
        dt = getattr(torch, dname)
        x = torch.randn(B, hw, hw, cin, device=dev, generator=gen).to(dt)
        off = torch.randn(B, hw, hw, 18, device=dev, generator=gen) * 3.0
        mask = torch.rand(B, hw, hw, 9, device=dev, generator=gen)
        w = (torch.randn(3, 3, cin, cout, device=dev, generator=gen)
             * (2.0 / (9 * cin)) ** 0.5).to(dt)
        bias = torch.randn(cout, device=dev, generator=gen)
        args = (x, off, mask, w, bias)
        flat_kc = flat_kc_route(B, hw, hw, cin, 9, cout, dt)
        # K1 itself at every shape, the flat-kc route's included
        k1 = deform_conv2d_tap if flat_kc else deform_conv2d
        n0 = launch_counts["deform_conv2d"]
        got = k1(*args)
        torch.cuda.synchronize()
        check(launch_counts["deform_conv2d"] == n0 + 1,
              "deform_conv2d did not count its launch")
        want = deform_conv2d_plain(*args)
        abs_err = float((got - want).abs().max())
        rel = abs_err / float(want.abs().max())
        check(rel < TOL[dname], f"deform_conv2d {crop} {hw}^2 {cin}->{cout} "
              f"{dname} B={B}: rel err {rel:.3g} >= {TOL[dname]}")
        row = {"crop": crop, "hw": hw, "cin": cin, "cout": cout, "batch": B,
               "dtype": dname, "calls_per_forward": calls,
               "route": "flat_kc" if flat_kc else "tap",
               "max_abs_err": abs_err, "rel_err": rel}
        if B == MAIN_BATCH or dname == "float32":
            bound, t_ops, t_bytes = dcn_bound(B, hw, cin, cout, dname)
            row.update(
                ms=cuda_ms(lambda: k1(*args), 20),
                plain_ms=cuda_ms(lambda: deform_conv2d_plain(*args), 3, 1),
                bound_ms=bound, ops_ms=t_ops, bytes_ms=t_bytes,
                bound_by="operations" if t_ops >= t_bytes else "bytes")
        if flat_kc:
            # what the dispatcher runs here: the quad gather + K2 per chunk
            n0 = launch_counts["blend_matmul"]
            got = deform_conv2d(*args)
            torch.cuda.synchronize()
            check(launch_counts["blend_matmul"] > n0,
                  "the flat-kc route did not launch blend_matmul")
            r_err = float((got - want).abs().max())
            check(r_err / float(want.abs().max()) < ROUTE_TOL,
                  f"flat-kc route {hw}^2 {cin}->{cout}: rel err "
                  f"{r_err / float(want.abs().max()):.3g} >= {ROUTE_TOL}")
            row.update(route_max_abs_err=r_err,
                       route_rel_err=r_err / float(want.abs().max()),
                       route_ms=cuda_ms(
                           lambda: deform_conv2d_chunked(*args), 10))
        rows.append(row)
    return rows


def bm_bound(np_, t, cin, cout):
    """Least time for one blend_matmul call: max(ops / bf16 peak,
    compulsory bytes / rate). Bytes: g2, w4 and wrep read once, the f32
    output written once; operations: the blend multiply and the
    contraction's multiply-adds."""
    kc = t * 4 * cin
    nbytes = np_ * kc * 2 + np_ * t * 4 * 2 + kc * cout * 2 + np_ * cout * 4
    flops = np_ * kc + 2 * np_ * kc * cout
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops, t_bytes


def phase_blend_matmul(gen):
    import torch

    from pdf_table_tpu_torch.ops.blend_matmul import (blend_matmul,
                                                      blend_matmul_plain)
    from pdf_table_tpu_torch.ops.kernels import launch_counts

    rows = []
    for np_, t, cin, cout in BM_CASES:
        kc = t * 4 * cin
        g2 = torch.randn(np_, kc, device="cuda", generator=gen).bfloat16()
        w4 = torch.rand(np_, t * 4, device="cuda", generator=gen).bfloat16()
        wrep = (torch.randn(kc, cout, device="cuda", generator=gen)
                * (1.0 / kc) ** 0.5).bfloat16()
        args = (g2, w4, wrep, cin)
        n0 = launch_counts["blend_matmul"]
        got = blend_matmul(*args)
        torch.cuda.synchronize()
        check(launch_counts["blend_matmul"] == n0 + 1,
              "blend_matmul did not count its launch")
        want = blend_matmul_plain(*args)
        abs_err = float((got - want).abs().max())
        rel = abs_err / float(want.abs().max())
        check(rel < BM_TOL, f"blend_matmul {np_}x{kc}->{cout}: rel err "
              f"{rel:.3g} >= {BM_TOL}")
        row = {"rows": np_, "taps": t, "cin": cin, "kc": kc, "cout": cout,
               "max_abs_err": abs_err, "rel_err": rel}
        if np_ == WTW_ROWS:
            # the library yardstick: one bf16 matmul of the rows already
            # scaled and rounded (the blend is not in it)
            gm = (g2.float() * torch.repeat_interleave(
                w4.float(), cin, dim=1)).bfloat16()
            bound, t_ops, t_bytes = bm_bound(np_, t, cin, cout)
            row.update(
                calls_per_forward=BM_CALLS,
                ms=cuda_ms(lambda: blend_matmul(*args), 20),
                plain_ms=cuda_ms(lambda: blend_matmul_plain(*args), 3, 1),
                library_ms=cuda_ms(lambda: torch.matmul(gm, wrep), 20),
                bound_ms=bound, ops_ms=t_ops, bytes_ms=t_bytes,
                bound_by="operations" if t_ops >= t_bytes else "bytes")
            del gm
        rows.append(row)
        del g2, w4, wrep, got, want
    torch.cuda.empty_cache()
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


def kernels_line(rows, launches: dict, bm_rows, bm_launches: int,
                 rn_rows, rn_launches: int) -> dict:
    """One entry per kernel. deform_conv2d's times are summed over the 16
    DCN calls of one forward of the wireless slice's sub-batch (B=8 at
    768^2, bf16), and its launches over both LORE slices' counted runs
    (``launches`` by path); blend_matmul's over its 10 calls in one
    forward of the wtw slice's sub-batch (B=8 at 1024^2: 5 stride-4 DCNs
    x chunks of 5 and 4 taps); resize_normalize's are one call at the
    detection slice's chunk (8 canvases 1280x960 -> 960x720). ``shapes``
    lists every checked shape with its error and, where timed, its
    times."""
    main = [r for r in rows if r["batch"] == MAIN_BATCH
            and r["crop"] == 768 and r["dtype"] == "bfloat16"]

    def total(rs, key):
        return sum(r[key] * r["calls_per_forward"] for r in rs)

    bm = [r for r in bm_rows if "ms" in r]
    rn = next(r for r in rn_rows if "ms" in r)
    return {"kernels": [{
        "name": "deform_conv2d", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": total(main, "ms"), "plain_ms": total(main, "plain_ms"),
        "bound_ms": total(main, "bound_ms"),
        "bound_by": "operations"
        if total(main, "ops_ms") >= total(main, "bytes_ms") else "bytes",
        "library_ms": None, "shapes": rows}, {
        "name": "blend_matmul", "route": "cuda", "source": BM_SOURCE,
        "replaces": BM_REPLACES, "launches": bm_launches,
        "max_abs_err": max(r["max_abs_err"] for r in bm_rows),
        "ms": total(bm, "ms"), "plain_ms": total(bm, "plain_ms"),
        "bound_ms": total(bm, "bound_ms"),
        "bound_by": "operations"
        if total(bm, "ops_ms") >= total(bm, "bytes_ms") else "bytes",
        "library_ms": total(bm, "library_ms"), "shapes": bm_rows}, {
        "name": "resize_normalize", "route": "cuda", "source": RN_SOURCE,
        "replaces": RN_REPLACES, "launches": rn_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rn_rows),
        "ms": rn["ms"], "plain_ms": rn["plain_ms"],
        "bound_ms": rn["bound_ms"], "bound_by": rn["bound_by"],
        "library_ms": rn["library_ms"], "shapes": rn_rows}]}


def _match(a, b, j):
    """Valid slots of crop ``j`` in both runs, matched by feature-map
    index: (slots in a, slots in b, valid in a, valid in b)."""
    import torch

    ia = {i: s for s, i in enumerate(a["inds"][j].tolist())
          if bool(a["valid"][j, s])}
    ib = {i: s for s, i in enumerate(b["inds"][j].tolist())
          if bool(b["valid"][j, s])}
    common = sorted(set(ia) & set(ib))
    return (torch.tensor([ia[i] for i in common], dtype=torch.long),
            torch.tensor([ib[i] for i in common], dtype=torch.long),
            len(ia), len(ib))


def compare_runs(task, plain, pages, regions):
    """The task's model against the plain-deform-conv yardstick ``plain``
    on the same crops: heads, then valid slots matched by feature-map
    index (dets, and the regressor's logical coordinates). ``dets_px`` and
    ``logi`` are the worst slot.

    Under wiz_rev the slots are the decoded cells before the vertex
    refine, and both regressors run on the task model's refined slots:
    snapping a vertex is a choice among corner detections, so a near-tie
    that the kernels' bf16 roundings tip moves a vertex by up to a cell
    side. The refine itself is held exactly: ``refine_sort`` on the card
    against the same function on the CPU, on the task's own decode
    (``refine_exact``). ``refined`` then gives, for information, the share
    of common slots within DETS_TOL and LOGI_TOL when each run refines its
    own decode."""
    import torch

    from pdf_table_tpu_torch.models.lore.corner_refine import refine_sort

    cfg = task.model_config
    k = cfg.max_objs
    worst = {"heads": 0.0, "dets_px": 0.0, "logi": 0.0, "match": 1.0,
             "valid_slots": 0, "common_slots": 0}
    refined = {"common_slots": 0, "dets_share": 0.0, "logi_share": 0.0}

    def decoded(dd):
        cells = dd["dc_packed"][:, :k]
        return {"dets": cells[..., :8], "inds": cells[..., 9].long(),
                "valid": cells[..., 8] >= cfg.vis_thresh}

    def chain(model, dd, rs=None):
        """refine_sort (unless given) + gather_logical: the slots (dets,
        inds, valid) and the packed output."""
        if rs is None:
            rs = refine_sort(dd["dc_packed"], k, cfg.vis_thresh,
                             cfg.vis_thresh_corner)
        packed = model.gather_logical(dd["ax_flat"], dd["cr_map"], *rs)
        return {"dets": rs[0], "inds": rs[1],
                "valid": rs[2] >= cfg.vis_thresh}, packed

    if cfg.wiz_rev:
        worst["refine_exact"] = True
    with torch.inference_mode():
        for sub, _metas, x in task.sub_batches(pages, regions):
            ha, hb = task.model.heads(x), plain.heads(x)
            for name in ha:
                rel = float((ha[name] - hb[name]).abs().max()
                            / hb[name].abs().max().clamp_min(1e-6))
                worst["heads"] = max(worst["heads"], rel)
            if cfg.wiz_rev:
                da, db = task.model.detect_decode(x), plain.detect_decode(x)
                dc = da["dc_packed"]
                rs = refine_sort(dc, k, cfg.vis_thresh,
                                 cfg.vis_thresh_corner)
                rs_cpu = refine_sort(dc.cpu(), k, cfg.vis_thresh,
                                     cfg.vis_thresh_corner)
                worst["refine_exact"] &= all(
                    torch.equal(a.cpu(), b) for a, b in zip(rs, rs_cpu))
                fa, pa = chain(task.model, da, rs)
                _, gb = chain(plain, db, rs)
                keep = pa[..., 9] > 0.5
                la, lb = pa[..., 16:20][keep], gb[..., 16:20][keep]
                worst["logi"] = max(worst["logi"], float(
                    (la - lb).abs().max() / lb.abs().max().clamp_min(1e-6)))
                fb, pb = chain(plain, db)
                sa_, sb_ = decoded(da), decoded(db)
            else:
                fa, fb = task.model.features(x), plain.features(x)
                pa, pb = task.model.proc_pack(fa), plain.proc_pack(fb)
                sa_, sb_ = fa, fb
            for j in range(len(sub)):
                sa, sb, na, nb = _match(sa_, sb_, j)
                worst["valid_slots"] += na
                if na or nb:
                    worst["match"] = min(worst["match"],
                                         len(sa) / max(na, nb))
                if not len(sa):
                    continue
                worst["common_slots"] += len(sa)
                dd = (sa_["dets"][j, sa] - sb_["dets"][j, sb]).abs().max()
                worst["dets_px"] = max(worst["dets_px"], float(dd))
                if not cfg.wiz_rev:
                    la, lb = pa[j, sa, 16:20], pb[j, sb, 16:20]
                    rel = float((la - lb).abs().max()
                                / lb.abs().max().clamp_min(1e-6))
                    worst["logi"] = max(worst["logi"], rel)
                    continue
                # each run refining its own decode: information only
                sa, sb, _, _ = _match(fa, fb, j)
                if not len(sa):
                    continue
                ddr = (fa["dets"][j, sa] - fb["dets"][j, sb]).abs().amax(-1)
                la, lb = pa[j, sa, 16:20], pb[j, sb, 16:20]
                lr = (la - lb).abs().amax(-1) / lb.abs().max().clamp_min(1e-6)
                refined["common_slots"] += len(sa)
                refined["dets_share"] += int((ddr < DETS_TOL).sum())
                refined["logi_share"] += int((lr < LOGI_TOL).sum())
    if cfg.wiz_rev:
        n = max(refined["common_slots"], 1)
        refined["dets_share"] /= n
        refined["logi_share"] /= n
        worst["refined"] = refined
    return worst


SLICE_KW = dict(dtype="bfloat16", vis_thresh=VIS_THRESH)
WTW_KW = dict(dtype="bfloat16", vis_thresh=WTW_VIS_THRESH,
              vis_thresh_corner=WTW_VIS_CORNER)


def slice_setup(device="cuda", task_type="wireless"):
    """The smoke's LORE slices: the bf16 ``task_type`` task at full width on
    seeded weights, 4 synthetic pages, 2 table regions each (all larger
    than 512 px, so one sub-batch of 8 at the config's resolution).
    Returns (task, variables, pages, regions)."""
    import numpy as np

    from pdf_table_tpu_torch.engine.params import (init_lore,
                                                   perturb_conv_offset_mask)
    from pdf_table_tpu_torch.tasks.table_structure import (
        OcrTableStructureTask, lore_config)

    kw = WTW_KW if task_type == "wtw" else SLICE_KW
    cfg = lore_config(task_type, **kw)
    variables = perturb_conv_offset_mask(init_lore(cfg, seed=0), seed=1)
    # random heads put every cell corner on its center, and the post filter
    # drops cells under 1 px: give the corners a fixed 6 feature-map px
    # offset and widen the logical regressor's output 10x, so tables carry
    # cells and a grid (the tests shape their weights the same way); wtw
    # corner group boxes get +-3 px, so cell quads hold them and vertices
    # snap
    prm = variables["params"]
    heads = prm["detector"]["heads"]
    heads["wh_out"]["bias"] = np.array(
        [6, 6, -6, 6, -6, -6, 6, -6], np.float32)
    if task_type == "wtw":
        heads["st_out"]["bias"] = np.array(
            [3, 3, -3, 3, -3, -3, 3, -3], np.float32)
    prm["processor"]["stacker"]["tsfm"]["decoder"]["linear_2"]["kernel"] *= 10
    task = OcrTableStructureTask(model="Lore", task_type=task_type,
                                 device=device, variables=variables,
                                 res_buckets="auto", **kw)
    pages = np.stack([make_page(i) for i in range(4)])
    regions = [(pi, box) for pi in range(4)
               for box in ((70, 100, 880, 560), (70, 620, 880, 1150))]
    return task, variables, pages, regions


def _trace(fn, activities):
    """torch.profiler over one ``fn()`` that ends in a synchronize: wall
    ms of that run and its device-side events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile

    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op's own event carries its kernels'
    # time too and would count it twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    return wall_ms, events


def profile_run(fn) -> dict:
    """Two traces of one ``fn()`` each. The light one records device
    activity only, so its wall time carries little of the profiler's host
    cost: device busy time, wall time and the idle share of that one run.
    The full one (host ops too) gives the top ops by device time, and its
    own busy, wall and idle share."""
    from torch.profiler import ProfilerActivity

    wall, events = _trace(fn, [ProfilerActivity.CUDA])
    busy = sum(e.self_device_time_total for e in events) / 1e3
    full_wall, full = _trace(fn, [ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
    full_busy = sum(e.self_device_time_total for e in full) / 1e3
    top = sorted(full, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall) if busy else None,
            "full_trace": {"wall_ms": full_wall, "device_busy_ms": full_busy,
                           "idle_share": max(0.0, 1.0 - full_busy
                                             / full_wall)},
            "top_ops": [{"name": e.key[:80],
                         "device_ms": e.self_device_time_total / 1e3,
                         "calls": e.count} for e in top]}


# kernel launches per sub-batch of 8 full-resolution crops: the wireless
# forward runs its 16 DCNs on K1; the wtw forward (1024^2) its five
# stride-4 DCNs on the flat-kc route (two tap chunks, one K2 launch each)
# and the other 11 on K1
SLICE_LAUNCHES = {"wireless": {"deform_conv2d": 16, "blend_matmul": 0},
                  "wtw": {"deform_conv2d": 11, "blend_matmul": 10}}


def count_snaps(task, pages, regions) -> int:
    """Vertices of cells above threshold that the corner refine moved, over
    the slice's sub-batches."""
    import torch

    from pdf_table_tpu_torch.models.lore.corner_refine import \
        refine_vertices_by_corners

    cfg = task.model_config
    k = cfg.max_objs
    snapped = 0
    with torch.inference_mode():
        for _sub, _metas, x in task.sub_batches(pages, regions):
            dc = task.model.detect_decode(x)["dc_packed"]
            dets = dc[:, :k, :8]
            refined, _ = refine_vertices_by_corners(
                dets, dc[:, :k, 8], dc[:, k:, :8], dc[:, k:, 8:10],
                dc[:, k:, 10], cfg.vis_thresh, cfg.vis_thresh_corner)
            moved = (refined != dets).reshape(*dets.shape[:2], 4, 2).any(-1)
            snapped += int(moved[dc[:, :k, 8] >= cfg.vis_thresh].sum())
    return snapped


def phase_slice(card, task_type="wireless"):
    import numpy as np
    import torch

    from pdf_table_tpu_torch.convert.flax_bridge import load_flax_variables
    from pdf_table_tpu_torch.models.lore.model import LoreModel
    from pdf_table_tpu_torch.ops.kernels import (launch_counts,
                                                 reset_launch_counts)
    from pdf_table_tpu_torch.tasks.table_to_html import OcrTableToHtmlTask

    t0 = time.perf_counter()
    task, variables, pages, regions = slice_setup(task_type=task_type)
    build_s = time.perf_counter() - t0
    res = task.model_config.resolution
    plan = [x.shape for _s, _m, x in task.sub_batches(pages, regions)]
    n_sub = len(plan)
    check(all(tuple(p[1:3]) == tuple(res) for p in plan),
          f"{task_type}: sub-batches {plan} are not at {res}")

    # the main path, counted
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results = task.batch_infer_from_pages(pages, regions)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: launch_counts[k] for k in SLICE_LAUNCHES[task_type]}
    for k, n in SLICE_LAUNCHES[task_type].items():
        check(launches[k] == n * n_sub, f"{task_type}: {k} launched "
              f"{launches[k]} times, expected {n * n_sub}")
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
    prof = profile_run(lambda: task.batch_infer_from_pages(pages, regions))

    plain = LoreModel(task.model_config, plain_dcn=True).eval()
    load_flax_variables(plain, variables)
    plain.to("cuda")
    before = dict(launch_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for _sub, _metas, x in task.sub_batches(pages, regions):
            plain.forward_packed(x).cpu()
    plain_run = time.perf_counter() - t0
    check(dict(launch_counts) == before,
          "the plain yardstick launched a kernel")
    cmp = compare_runs(task, plain, pages, regions)
    cells = [len(r["cells"]) for r in results]
    summary = {
        "card": card, "task_type": task_type, "resolution": list(res),
        "crops": len(regions), "sub_batches": n_sub,
        "launches": launches, "model_build_s": build_s,
        "first_run_s": first_s, "run_s_median": per_run,
        "run_s_min": min(run_s), "run_s_max": max(run_s), "runs": len(run_s),
        "crops_per_s": len(regions) / per_run,
        "ms_per_crop": per_run * 1e3 / len(regions),
        "peak_mem_gib": peak / 2 ** 30,
        "plain_dcn_run_s": plain_run,
        "cells_per_table": cells, "valid_cells": sum(cells),
        "html_bytes": [len(h) for h in htmls], "yardstick": cmp,
        "profile": prof,
    }
    if task_type == "wtw":
        summary["snapped_vertices"] = count_snaps(task, pages, regions)
    print(json.dumps({"slice" if task_type == "wireless"
                      else f"{task_type}_slice": summary}))
    check(cmp["valid_slots"] > 0, "no valid slots to compare")
    check(cmp["heads"] < HEADS_TOL, f"heads differ: {cmp['heads']:.3g}")
    check(cmp["match"] >= MATCH_MIN, f"valid slots differ: {cmp['match']}")
    check(cmp["dets_px"] < DETS_TOL, f"dets differ: {cmp['dets_px']:.3g}")
    check(cmp["logi"] < LOGI_TOL, f"logi differ: {cmp['logi']:.3g}")
    if task_type == "wtw":
        check(cmp["refine_exact"], "wtw: the refine on the card differs "
              "from the CPU's on the same decode")
        check(summary["valid_cells"] > 0, "wtw: no valid cells")
        check(summary["snapped_vertices"] > 0, "wtw: no vertex snapped")
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
    return {"stage_ms": stages,
            "profile": profile_run(lambda: task.batch_infer_from_pages(pages))}


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
    bm_rows = phase_blend_matmul(gen)
    rn_rows = phase_resize(gen)
    wireless = phase_slice(card, "wireless")
    wtw = phase_slice(card, "wtw")
    rn_launches = phase_detection(card)
    check("jax" not in sys.modules and "pdf_table_tpu" not in sys.modules,
          "the port imported JAX or the JAX package")
    launches = {"lore_wireless": wireless["deform_conv2d"],
                "lore_wtw": wtw["deform_conv2d"]}
    print(card)
    print(json.dumps(kernels_line(rows, launches, bm_rows,
                                  wtw["blend_matmul"], rn_rows,
                                  rn_launches)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
