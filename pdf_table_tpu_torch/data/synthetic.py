"""Synthetic wired tables with exact cell and logical-coordinate targets
(counterpart of tools/demo_train_lore.py:23-75): random row and column
counts, a grid of 2-px lines drawn with numpy slices, some cells shaded.
Training needs no download with them."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..models.lore.processor import LorePreProcessor
from .wtw import make_lore_targets, stack_items


def make_table_sample(rng: np.random.Generator, size: int = 256):
    """A random grid table, (size, size, 3) uint8 RGB, with its cell quads
    (N, 8) and logical coordinates (N, 4) in image px."""
    img = np.full((size, size, 3), 255, np.uint8)
    n_rows = int(rng.integers(2, 5))
    n_cols = int(rng.integers(2, 5))
    x0, y0 = rng.integers(10, 40, 2)
    x1 = int(rng.integers(size - 60, size - 10))
    y1 = int(rng.integers(size - 60, size - 10))
    xs = np.linspace(x0, x1, n_cols + 1).astype(int)
    ys = np.linspace(y0, y1, n_rows + 1).astype(int)
    for y in ys:
        img[y - 1:y + 1, xs[0]:xs[-1] + 1] = 0
    for x in xs:
        img[ys[0]:ys[-1] + 1, x - 1:x + 1] = 0
    quads, logic = [], []
    for r in range(n_rows):
        for c in range(n_cols):
            qx1, qx2 = xs[c], xs[c + 1]
            qy1, qy2 = ys[r], ys[r + 1]
            quads.append([qx1, qy1, qx2, qy1, qx2, qy2, qx1, qy2])
            logic.append([r, r, c, c])
            # light cell shading gives the net texture
            if rng.random() < 0.3:
                img[qy1 + 2:qy2 - 2, qx1 + 2:qx2 - 2] = int(
                    rng.integers(200, 250))
    return img, np.asarray(quads, np.float32), np.asarray(logic, np.float32)


class SyntheticTableDataset:
    """``n`` synthetic tables at the config's resolution, each item drawn
    from its own seed (``seed * 100003 + idx``), preprocessed and with its
    LORE targets, as :class:`..wtw.WtwDataset` gives them."""

    def __init__(self, config, n: int = 512, seed: int = 0):
        self.config = config
        self.n = n
        self.seed = seed
        self.pre = LorePreProcessor(config)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        img, quads, logic = make_table_sample(rng, self.config.resolution[0])
        pre = self.pre(img)
        meta = pre["meta"]
        scale = meta["out_w"] / meta["s"]
        targets = make_lore_targets(quads * scale, logic,
                                    (meta["out_h"], meta["out_w"]),
                                    self.config.max_objs)
        targets["image"] = pre["image"][0]
        return targets

    def batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        return stack_items([self[i] for i in indices])
