"""Torch -> flax tensor conversion primitives + verification harness (a copy of
pdf_table_tpu/convert/torch_to_flax.py: numpy only, the same flax-layout
trees).

Layout rules (torch NCHW modules -> flax NHWC):
  Conv2d weight   (Cout, Cin, Kh, Kw) -> (Kh, Kw, Cin, Cout)
  ConvTranspose2d (Cin, Cout, Kh, Kw) -> (Kh, Kw, Cout, Cin) flipped? —
    flax ConvTranspose kernels are (Kh, Kw, Cin, Cout) with no flip; torch's
    are cross-correlation from the output side, so axes transpose
    (2, 3, 0, 1) matches numerically.
  Linear weight   (Out, In)           -> (In, Out)
  BatchNorm       weight/bias -> scale/bias; running_mean/var -> batch_stats.

Per-model name maps live in tools/convert_*.py; this module holds the
mechanical pieces plus a per-layer numeric diff report (SURVEY.md §7 'hard
part 4: weight conversion fidelity needs a per-layer diffing harness').
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class TorchTensorSource:
    """Wraps a torch state dict (or .pt/.pth file) as a numpy lookup."""

    def __init__(self, state_dict_or_path):
        if isinstance(state_dict_or_path, (str,)):
            import torch

            obj = torch.load(state_dict_or_path, map_location="cpu",
                             weights_only=True)
            state = obj.get("state_dict", obj.get("model", obj)) \
                if isinstance(obj, dict) else obj
        else:
            state = state_dict_or_path
        self.state: Dict[str, Any] = {}
        for k, v in state.items():
            k = k[len("module."):] if k.startswith("module.") else k
            self.state[k] = v
        self.used: set = set()

    def __contains__(self, key: str) -> bool:
        return key in self.state

    def keys(self):
        return self.state.keys()

    def get(self, key: str) -> np.ndarray:
        self.used.add(key)
        v = self.state[key]
        try:
            import torch

            if isinstance(v, torch.Tensor):
                return v.detach().cpu().numpy()
        except ImportError:
            pass
        return np.asarray(v)

    def unused(self) -> List[str]:
        return sorted(set(self.state) - self.used)


def convert_conv(w: np.ndarray) -> np.ndarray:
    """torch Conv2d (Cout, Cin, Kh, Kw) -> flax (Kh, Kw, Cin, Cout)."""
    return np.transpose(w, (2, 3, 1, 0))


def convert_conv_transpose(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d (Cin, Cout, Kh, Kw) -> flax (Kh, Kw, Cin, Cout)
    with spatial flip (torch transposed conv correlates the flipped
    kernel relative to flax's definition)."""
    return np.transpose(w, (2, 3, 0, 1))[::-1, ::-1]


def convert_dense(w: np.ndarray) -> np.ndarray:
    """torch Linear (Out, In) -> flax (In, Out)."""
    return np.transpose(w, (1, 0))


def convert_bn(prefix: str, src: TorchTensorSource) -> Dict[str, np.ndarray]:
    """-> {'scale', 'bias'} params + {'mean', 'var'} batch stats."""
    return {
        "scale": src.get(f"{prefix}.weight"),
        "bias": src.get(f"{prefix}.bias"),
        "mean": src.get(f"{prefix}.running_mean"),
        "var": src.get(f"{prefix}.running_var"),
    }


@dataclass
class ConversionReport:
    """Per-layer conversion bookkeeping + shape verification."""

    mapped: List[Tuple[str, str, Tuple]] = field(default_factory=list)
    missing: List[str] = field(default_factory=list)
    shape_errors: List[Tuple[str, Tuple, Tuple]] = field(default_factory=list)

    def record(self, torch_name: str, flax_path: str, shape: Tuple) -> None:
        self.mapped.append((torch_name, flax_path, shape))

    def check_assign(self, tree: Dict, path: List[str], value: np.ndarray,
                     torch_name: str) -> None:
        """Assign value at path in the (nested dict) param tree, verifying
        the destination exists with the same shape."""
        node = tree
        for p in path[:-1]:
            if p not in node:
                self.missing.append("/".join(path))
                return
            node = node[p]
        leaf = path[-1]
        if leaf not in node:
            self.missing.append("/".join(path))
            return
        expected = np.asarray(node[leaf]).shape
        if tuple(expected) != tuple(value.shape):
            self.shape_errors.append(("/".join(path), tuple(expected),
                                      tuple(value.shape)))
            return
        node[leaf] = value.astype(np.asarray(node[leaf]).dtype)
        self.record(torch_name, "/".join(path), tuple(value.shape))

    @property
    def ok(self) -> bool:
        return not self.missing and not self.shape_errors

    def summary(self) -> str:
        return (f"mapped={len(self.mapped)} missing={len(self.missing)} "
                f"shape_errors={len(self.shape_errors)}")


def assign_conv_bn(tree: Dict, flax_prefix: List[str], src: TorchTensorSource,
                   torch_conv: str, torch_bn: Optional[str],
                   report: ConversionReport,
                   batch_stats: Optional[Dict] = None) -> None:
    """Map a torch conv(+bn) pair onto a ConvBNAct flax module subtree."""
    w = convert_conv(src.get(f"{torch_conv}.weight"))
    report.check_assign(tree, flax_prefix + ["conv", "kernel"], w, torch_conv)
    if f"{torch_conv}.bias" in src:
        report.check_assign(tree, flax_prefix + ["conv", "bias"],
                            src.get(f"{torch_conv}.bias"), torch_conv)
    if torch_bn is not None:
        bn = convert_bn(torch_bn, src)
        report.check_assign(tree, flax_prefix + ["bn", "scale"], bn["scale"],
                            torch_bn)
        report.check_assign(tree, flax_prefix + ["bn", "bias"], bn["bias"],
                            torch_bn)
        if batch_stats is not None:
            report.check_assign(batch_stats, flax_prefix + ["bn", "mean"],
                                bn["mean"], torch_bn)
            report.check_assign(batch_stats, flax_prefix + ["bn", "var"],
                                bn["var"], torch_bn)
