"""Hand-written Hopper kernels (sources in ``csrc/``, built by ``build.py``).

``launch_counts`` counts each kernel's launches by name: a wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
path went through the kernels.
"""

from __future__ import annotations

from collections import Counter

launch_counts: Counter = Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()
