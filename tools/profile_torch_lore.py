"""Where the PyTorch port's LORE slice spends its time on a CUDA card.

    python tools/profile_torch_lore.py [--out chiprun_out/profile_torch_lore]

Runs chip_smoke.py's slice (bf16 wireless LORE at full width, 8 table crops
of 4 synthetic 1224x950 pages, one sub-batch) and prints one JSON line:

- run_ms: one ``batch_infer_from_pages``, host clock around work that ends
  in a synchronize (mean of 5 after a warm-up);
- stage_ms: the same sub-batch split into crop sampling, detector heads,
  features (heads + decode + feature gathers), the regressor + pack, and
  the host post-processing of the packed output, each timed alone;
- profile: torch.profiler over one run: device busy time, the wall time of
  that run, the idle share, and the top ops by self device time.

The Chrome trace goes to ``--out``. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _timed(fn, iters: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/profile_torch_lore")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_lore: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from pdf_table_tpu_torch.engine.device import set_float_precision
    from pdf_table_tpu_torch.models.lore.model import unpack_lore

    set_float_precision()
    card = cs.card_line()
    task, _vars, pages, regions = cs.slice_setup()
    model = task.model
    run_ms = _timed(lambda: task.batch_infer_from_pages(pages, regions))

    with torch.inference_mode():
        (sub, metas, x), = list(task.sub_batches(pages, regions))
        fo = model.features(x)
        packed = model.proc_pack(fo).cpu().numpy()

        def post():
            for j, meta in enumerate(metas):
                task.post(unpack_lore(packed[j:j + 1]), meta)

        crops = _timed(lambda: list(task.sub_batches(pages, regions)))
        heads = _timed(lambda: model.heads(x))
        feats = _timed(lambda: model.features(x))
        regressor = _timed(lambda: model.proc_pack(fo))
        t0 = time.perf_counter()
        for _ in range(5):
            post()
        host_post = (time.perf_counter() - t0) * 1e3 / 5

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        task.batch_infer_from_pages(pages, regions)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, "trace.json"))

    from torch.autograd import DeviceType

    def dev_us(e):
        return e.self_device_time_total

    # device-side events only (kernels, copies): an aten op's own event
    # carries its kernels' time too and would count it twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:15]
    print(json.dumps({"profile_torch_lore": {
        "card": card, "crops": len(regions), "run_ms": run_ms,
        "stage_ms": {"crop_sampling": crops, "detector_heads": heads,
                     "features": feats, "regressor_and_pack": regressor,
                     "host_post": host_post},
        "profile": {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "top_ops": [{"name": e.key[:80], "device_ms": dev_us(e) / 1e3,
                         "calls": e.count} for e in top]}}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
