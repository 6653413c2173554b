"""Device and compute-dtype policy (counterpart of
pdf_table_tpu/engine/device.py).

Entry points run on ``cuda`` by default. Without a GPU they raise unless the
caller asked for the CPU explicitly: the port never falls back silently.

The compute dtype of the models that the JAX package builds through its
registry follows :func:`default_dtype`: ``PDFTABLE_COMPUTE_DTYPE`` (bf16
unless set) on the card, f32 on the CPU, as JAX's ``compute_dtype`` gives
it per backend.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Union

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the values PDFTABLE_COMPUTE_DTYPE takes; its default is the JAX package's
# (utils/constants.py: COMPUTE_DTYPE)
_POLICY_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
                  "float32": torch.float32, "fp32": torch.float32}
DEFAULT_COMPUTE_DTYPE = "bfloat16"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def default_backend(device: Optional[Union[str, torch.device]] = None
                    ) -> str:
    """The platform of the resolved device as JAX names its backends:
    ``"gpu"`` for ``cuda``, else ``"cpu"`` (what the service's
    ``/healthz`` reports)."""
    return "gpu" if resolve_device(device).type == "cuda" else "cpu"


def on_device(pages, device: torch.device) -> torch.Tensor:
    """``pages`` (a numpy array or a tensor) as a tensor on ``device``; a
    tensor already there is returned as it is, not copied."""
    t = torch.as_tensor(pages)
    here = t.device.type == device.type and device.index in (
        None, t.device.index)
    return t if here else t.to(device)


def compute_dtype(name: Optional[str] = None,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> torch.dtype:
    """The model's compute dtype by its config name; the deform-conv kernel
    takes these two. Without a name, the policy's dtype on the resolved
    device (:func:`default_dtype`), which is what JAX's ``compute_dtype()``
    gives for its backend."""
    if name is None:
        return default_dtype(resolve_device(device))
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown compute dtype {name!r}") from None


def default_dtype(device: Union[str, torch.device]) -> torch.dtype:
    """The compute dtype for a model on ``device`` whose caller names none:
    f32 on a CPU device, else ``PDFTABLE_COMPUTE_DTYPE`` ("bfloat16" or
    "bf16", "float32" or "fp32"; bf16 when unset). A value the port does
    not run (``float16``, a typo) raises."""
    name = os.environ.get("PDFTABLE_COMPUTE_DTYPE",
                          DEFAULT_COMPUTE_DTYPE).lower()
    if name not in _POLICY_DTYPES:
        raise ValueError(f"PDFTABLE_COMPUTE_DTYPE={name!r}: the port runs "
                         f"{sorted(_POLICY_DTYPES)}")
    if torch.device(device).type == "cpu":
        return torch.float32
    return _POLICY_DTYPES[name]


def with_default_dtype(kw: Dict[str, Any], device: torch.device
                       ) -> Dict[str, Any]:
    """``kw`` (config fields) with ``dtype`` set by :func:`default_dtype`
    where the caller gave none, as the JAX registry's ``get_config``
    does."""
    if "dtype" in kw:
        return kw
    dt = default_dtype(device)
    return dict(kw, dtype="bfloat16" if dt == torch.bfloat16 else "float32")


def set_float_precision() -> None:
    """Full-precision f32: cuDNN convolutions default to TF32 otherwise."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
