"""Hand-written Hopper kernels (sources in ``csrc/``, built by ``build.py``).

``launch_counts`` counts each kernel's launches by name: a wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
path went through the kernels. ``KERNELS`` maps each count's name to its
source under ``csrc/``.
"""

from __future__ import annotations

from collections import Counter

KERNELS = {"deform_conv2d": "deform_conv", "blend_matmul": "blend_matmul",
           "resize_normalize": "resize_norm"}

launch_counts: Counter = Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()
