"""Device and compute-dtype policy (counterpart of
pdf_table_tpu/engine/device.py).

Entry points run on ``cuda`` by default. Without a GPU they raise unless the
caller asked for the CPU explicitly: the port never falls back silently.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def on_device(pages, device: torch.device) -> torch.Tensor:
    """``pages`` (a numpy array or a tensor) as a tensor on ``device``; a
    tensor already there is returned as it is, not copied."""
    t = torch.as_tensor(pages)
    here = t.device.type == device.type and device.index in (
        None, t.device.index)
    return t if here else t.to(device)


def compute_dtype(name: str) -> torch.dtype:
    """The model's compute dtype by its config name; the deform-conv kernel
    takes these two."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown compute dtype {name!r}") from None


def set_float_precision() -> None:
    """Full-precision f32: cuDNN convolutions default to TF32 otherwise."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
