"""CTC greedy decoding on tensors (counterpart of pdf_table_tpu/ops/ctc.py):
argmax, collapse repeats and drop blanks as masked tensor ops; the host
only maps ids to characters."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def ctc_greedy_decode(logits: torch.Tensor, blank_id: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (B, T, V) -> (ids (B, T) int64, keep (B, T) bool, conf (B,)).

    ``ids`` holds the argmax labels (the first maximum at a tie); ``keep``
    marks the positions that survive collapse-repeats and drop-blank, in
    order; ``conf`` is the mean probability of the kept positions (0 where
    none is kept)."""
    probs = torch.softmax(logits.float(), dim=-1)
    pmax, ids = probs.max(dim=-1)
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    keep = (ids != blank_id) & (ids != prev)
    conf_sum = (pmax * keep).sum(dim=1)
    conf_cnt = keep.sum(dim=1).clamp_min(1)
    return ids, keep, conf_sum / conf_cnt


def ids_to_text(ids, mask, charset: Sequence[str], blank_id: int = 0
                ) -> List[str]:
    """Host-side vocabulary mapping. ``charset``: id -> str (index 0 is
    the blank)."""
    ids = np.asarray(ids)
    mask = np.asarray(mask)
    n_chars = len(charset)
    return ["".join(charset[i] for i, m in zip(ids[b], mask[b])
                    if m and 0 <= i < n_chars and i != blank_id)
            for b in range(ids.shape[0])]
