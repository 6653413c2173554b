"""Time the DCN kernel's f32 body (K1 on f32 tensors) on a CUDA card.

    python tools/time_dcn_f32.py [--root DIR] [--iters 20] [--label NAME]

Imports ``pdf_table_tpu_torch`` from ``--root`` (default: this checkout),
so that two checkouts, for example a commit and its parent unpacked with
``git archive``, can be timed in turns within one session on one card.
Builds the kernels there at first use. For every LORE DCN of a sub-batch
of 8 crops (the wireless shapes at 768^2, 512^2 and 384^2, the wtw shapes
at 1024^2) it times ``deform_conv2d_tap`` on seeded f32 inputs (CUDA
events over ``--iters`` calls after a warm-up, inputs warm in L2) and
prints one JSON line: the card's name and power limit, the per-shape ms,
and each crop size's forward ms (every DCN times its calls per forward).
Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (fmap side at a 768^2 crop, Cin, Cout, calls per forward): LORE's DCNs
SHAPES_768 = [(192, 64, 64, 5), (96, 128, 64, 4), (96, 128, 128, 2),
              (48, 256, 128, 2), (48, 256, 256, 1), (48, 256, 64, 1),
              (24, 512, 256, 1)]
BATCH = 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("time_dcn_f32: no CUDA device", file=sys.stderr)
        return 1
    from pdf_table_tpu_torch.ops.deform_conv import deform_conv2d_tap

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, forward = [], {}
    for crop in (768, 512, 384, 1024):
        forward[crop] = 0.0
        for side, cin, cout, calls in SHAPES_768:
            hw = side * crop // 768
            x = torch.randn(BATCH, hw, hw, cin, device="cuda", generator=gen)
            off = torch.randn(BATCH, hw, hw, 18, device="cuda",
                              generator=gen) * 3.0
            mask = torch.rand(BATCH, hw, hw, 9, device="cuda", generator=gen)
            wt = torch.randn(3, 3, cin, cout, device="cuda", generator=gen) \
                * (2.0 / (9 * cin)) ** 0.5
            bias = torch.randn(cout, device="cuda", generator=gen)
            for _ in range(2):
                deform_conv2d_tap(x, off, mask, wt, bias)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.iters):
                deform_conv2d_tap(x, off, mask, wt, bias)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / args.iters
            forward[crop] += ms * calls
            rows.append({"crop": crop, "hw": hw, "cin": cin, "cout": cout,
                         "calls_per_forward": calls, "ms": ms})
            del x, off, mask, wt, bias
    print(json.dumps({"label": args.label, "root": args.root, "card": card,
                      "device": torch.cuda.get_device_name(0),
                      "forward_ms": {str(c): v for c, v in forward.items()},
                      "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
