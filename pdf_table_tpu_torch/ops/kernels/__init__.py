"""Hand-written Hopper kernels (sources in ``csrc/``, built by ``build.py``).

``launch_counts`` counts each kernel's launches by name: a wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
path went through the kernels. ``KERNELS`` maps each count's name to its
source under ``csrc/``: one name per TPU kernel that the source replaces,
so the deform-conv source carries two, ``deform_conv2d`` (its tap mode,
for the tap-major TPU kernel) and ``deform_conv2d_flat_kc`` (its flat-kc
mode, for the flat-kc TPU kernel).
"""

from __future__ import annotations

from collections import Counter

KERNELS = {"deform_conv2d": "deform_conv",
           "deform_conv2d_flat_kc": "deform_conv",
           "resize_normalize": "resize_norm"}

launch_counts: Counter = Counter()
# the same launches by (name, output columns): the deform-conv kernel's
# launches at each Cout (a tp-sharded DCN runs at its shard's columns)
launch_columns: Counter = Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()
    launch_columns.clear()
