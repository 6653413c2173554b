"""Reproduce oneDNN's bf16 conv2d NaN on the CPU with plain PyTorch.

A 256 -> 512 channel 3x3 conv, stride 2, pad 1, no bias, on a bf16
(1, 256, 4, 2) input (the shape ResNet-18's ``layer4`` first conv meets on
a 64x32 image) returns NaN on output row 1 now and then. Whether it does
depends on the heap's history, not on the data: freeing NaN-filled tensors
just before each conv (``--poison``) moves the rate. With oneDNN switched off
(``torch.backends.mkldnn.flags(enabled=False)``) and at 4x4 or 8x4 inputs
the same draws stay finite.

    python tools/repro_onednn_bf16_conv.py [--draws 300] [--poison]

Prints, for each setting, how many fresh draws gave a NaN, and exits 1 if
the default setting (oneDNN on, 4x2) gave any.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F


def nan_draws(draws: int, hw=(4, 2), mkldnn: bool = True,
              poison: bool = False) -> int:
    """The number of seeds ``0..draws-1`` whose bf16 conv output has a
    NaN."""
    bad = 0
    with torch.backends.mkldnn.flags(enabled=mkldnn), torch.no_grad():
        for seed in range(draws):
            g = torch.Generator().manual_seed(seed)
            x = torch.randn((1, 256) + tuple(hw), generator=g)
            w = torch.randn(512, 256, 3, 3, generator=g) * 0.02
            if poison:
                # NaN-filled blocks freed just before the conv
                junk = [torch.full((1, 512, 2, 1), float("nan"),
                                   dtype=torch.bfloat16) for _ in range(8)]
                del junk
            y = F.conv2d(x.bfloat16(), w.bfloat16(), None, 2, 1)
            bad += int(torch.isnan(y).any())
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=300)
    ap.add_argument("--poison", action="store_true",
                    help="free NaN-filled tensors before each conv")
    a = ap.parse_args(argv)
    print(f"torch {torch.__version__}, oneDNN "
          f"{torch.backends.mkldnn.is_available()}")
    first = None
    for mkldnn, hw in ((True, (4, 2)), (False, (4, 2)), (True, (4, 4)),
                       (True, (8, 4))):
        n = nan_draws(a.draws, hw, mkldnn, a.poison)
        first = n if first is None else first
        print(f"oneDNN {'on ' if mkldnn else 'off'} input {hw}: "
              f"{n} of {a.draws} draws NaN")
    return 1 if first else 0


if __name__ == "__main__":
    sys.exit(main())
