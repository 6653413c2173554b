"""Model FLOP counts and the card's peaks, for MFU (counterpart of
pdf_table_tpu/utils/flops.py, which walks jaxprs).

:func:`count_flops` runs a function eagerly under a ``TorchDispatchMode`` of
its own and counts each contraction the dispatcher sees (``mm``, ``addmm``,
``bmm``, ``baddbmm``, the convolutions and the attention ops, with
``torch.utils.flop_counter``'s formulas). Elementwise and reduction work is
ignored, as JAX's walk ignores it, so an MFU from these counts is a slight
underestimate.

A deform conv launches its kernel through ctypes, which the dispatcher
never sees, so :func:`hand_counted` adds its model FLOPs by hand,
``2·B·Ho·Wo·K·Cin·Cout``, whichever route runs (the kernel's tap or flat-kc
mode, or a plain version, whose own products are then not counted a second
time). That is the figure JAX's CPU route counts (one dot over
``K·Cin``). JAX's TPU route counts its Pallas bodies instead, a 4·Cin
contraction per tap with the corner blend inside: the port counts model
FLOPs, not the work a kernel body does.

Three differences from JAX's counts, recorded and not repaired:

- a transposed conv counts over its input's spatial size, the work of a
  direct implementation (``torch.utils.flop_counter``); JAX counts over
  the lhs-dilated input, out/in spatial times more (``stride_h·stride_w``
  where the output is the input times the stride);
- a loop counts every step it runs, where JAX counts a ``while`` body
  once;
- only what runs is counted: JAX's walk also counts traced work whose
  result nothing uses, which XLA drops (the ``project`` conv of DLA-34's
  parent trees, which the port does not run).
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Dict, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# dense datasheet peaks (FLOP/s) of the cards the port measures on, by
# torch.cuda.get_device_name(): NVIDIA's H100 SXM figures, no sparsity
PEAK_FLOPS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.4e12, "tf32": 494.7e12,
                              "f32": 66.9e12},
}

_state = threading.local()


def _active() -> list:
    """The counts open on this thread, outermost first; none inside a
    hand-counted call."""
    if getattr(_state, "suspended", 0):
        return []
    return getattr(_state, "stack", None) or []


class _FlopMode(TorchDispatchMode):
    def __init__(self, counter: list):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        formula = flop_registry.get(func._overloadpacket)
        if formula is None:
            # under inference mode the mode meets composite ops (matmul,
            # conv2d, linear) before their decomposition: decompose them
            # with the mode on, so that their products are seen
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if formula is not None and not getattr(_state, "suspended", 0):
            self.counter[0] += int(formula(*args, **kwargs, out_val=out))
        return out


def count_flops(fn: Callable, *args, **kwargs):
    """(FLOPs, result) of ``fn(*args, **kwargs)``, run eagerly: 2·M·N·K per
    matrix product, the usual count per convolution and attention op, the
    hand count of every deform conv. Counts nest: an outer count includes
    an inner one's."""
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = _state.stack = []
    counter = [0]
    stack.append(counter)
    try:
        with _FlopMode(counter):
            result = fn(*args, **kwargs)
    finally:
        stack.pop()
    return counter[0], result


def hand_counted(flops_of: Callable[..., int]):
    """Decorate a function whose work the dispatcher cannot see (or should
    not count op by op): while a count is open, ``flops_of(*args,
    **kwargs)`` is added once and nothing inside the call is counted."""
    def wrap(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            counters = _active()
            if not counters:
                return fn(*args, **kwargs)
            n = int(flops_of(*args, **kwargs))
            for c in counters:
                c[0] += n
            _state.suspended = getattr(_state, "suspended", 0) + 1
            try:
                return fn(*args, **kwargs)
            finally:
                _state.suspended -= 1
        return counted
    return wrap


def peak_flops(dtype: Union[torch.dtype, str],
               device: Union[str, torch.device, None] = None) -> float:
    """The card's dense peak FLOP/s for ``dtype``: bf16 (or fp16) on the
    tensor cores, ``"tf32"``, or ``torch.float32`` outside them (the peak
    that applies where f32 convs run with TF32 off). A card the table does
    not hold raises, rather than guess."""
    name = torch.cuda.get_device_name(device)
    if name not in PEAK_FLOPS:
        raise KeyError(f"no peak FLOP/s known for {name!r}")
    if dtype in (torch.bfloat16, torch.float16):
        key = "bf16"
    elif dtype == torch.float32:
        key = "f32"
    elif dtype == "tf32":
        key = "tf32"
    else:
        raise ValueError(f"no peak for dtype {dtype!r}")
    return PEAK_FLOPS[name][key]
