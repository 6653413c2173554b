"""Deterministic numpy-seeded initialization in the flax layout.

:func:`init_lore` and :func:`init_dbnet` return a ``{"params",
"batch_stats"}`` tree with the paths and shapes the JAX package's
``LoreModel.init`` / ``DBNet.init`` give, filled with the flax initializers'
kinds: lecun-normal conv / transposed-conv / dense kernels, zero biases,
BN scale/bias 1/0 and statistics 0/1; for LORE also he-normal DCN weights,
the bilinear upsample kernel, a zero ``conv_offset_mask`` and the -2.19
``hm_out`` bias. The numbers differ from a JAX PRNG init (another
generator); the structure is the same, so the weight bridge moves either
tree.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..convert.flax_bridge import tree_leaves
from ..models.dbnet.config import DbNetConfig
from ..models.layers import BatchNorm
from ..models.lore.config import LoreConfig
from ..models.lore.dla import (DeformConvBlock, DepthwiseUpsample,
                               bilinear_up_kernel)
from ..models.lore.processor_model import RefNorm


def _set(tree: Dict[str, Any], path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _normal(rng: np.random.Generator, shape, fan_in: int,
            gain: float = 1.0) -> np.ndarray:
    return (rng.standard_normal(shape) * np.sqrt(gain / fan_in)) \
        .astype(np.float32)


def _set_batch_norm(params, stats, path, c: int) -> None:
    _set(params, path + ("scale",), np.ones((c,), np.float32))
    _set(params, path + ("bias",), np.zeros((c,), np.float32))
    _set(stats, path + ("mean",), np.zeros((c,), np.float32))
    _set(stats, path + ("var",), np.ones((c,), np.float32))


def init_lore(cfg: LoreConfig, seed: int = 0) -> Dict[str, Any]:
    from ..models.lore.model import LoreModel

    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        model = LoreModel(cfg)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def normal(shape, fan_in, gain=1.0):
        return _normal(rng, shape, fan_in, gain)

    for mname, mod in model.named_modules():
        path = tuple(mname.split(".")) if mname else ()
        name = path[-1] if path else ""
        if isinstance(mod, nn.Conv2d):
            o, i, kh, kw = mod.weight.shape
            kern = np.zeros((kh, kw, i, o), np.float32) \
                if name == "conv_offset_mask" else \
                normal((kh, kw, i, o), kh * kw * i)
            _set(params, path + ("kernel",), kern)
            if mod.bias is not None:
                b = np.full((o,), -2.19 if name == "hm_out" else 0.0,
                            np.float32)
                _set(params, path + ("bias",), b)
        elif isinstance(mod, nn.Linear):
            o, i = mod.weight.shape
            _set(params, path + ("kernel",), normal((i, o), i))
            _set(params, path + ("bias",), np.zeros((o,), np.float32))
        elif isinstance(mod, nn.Embedding):
            v, d = mod.weight.shape
            _set(params, path + ("embedding",), normal((v, d), v))
        elif isinstance(mod, BatchNorm):
            _set_batch_norm(params, stats, path, mod.weight.shape[0])
        elif isinstance(mod, DeformConvBlock):
            kh, kw, i, o = mod.weight.shape
            _set(params, path + ("weight",),
                 normal((kh, kw, i, o), kh * kw * i, gain=2.0))
            _set(params, path + ("bias",), np.zeros((o,), np.float32))
        elif isinstance(mod, DepthwiseUpsample) and mod.factor != 1:
            c, _, k, _ = mod.weight.shape
            base = bilinear_up_kernel(mod.factor).numpy()
            _set(params, path + ("kernel",), np.ascontiguousarray(
                np.broadcast_to(base[:, :, None, None], (k, k, 1, c))))
        elif isinstance(mod, RefNorm):
            _set(params, path + ("alpha",), np.ones((mod.dim,), np.float32))
            _set(params, path + ("bias",), np.zeros((mod.dim,), np.float32))
    return {"params": params, "batch_stats": stats}


def init_dbnet(cfg: DbNetConfig, seed: int = 0) -> Dict[str, Any]:
    """The DBNet tree: conv kernels (kh, kw, In/groups, Out), transposed-conv
    kernels (kh, kw, In, Out), SE biases zero, BatchNorm leaves."""
    from ..models.dbnet.model import DBNet

    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        model = DBNet(cfg)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for mname, mod in model.named_modules():
        path = tuple(mname.split(".")) if mname else ()
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            if isinstance(mod, nn.Conv2d):
                o, i, kh, kw = mod.weight.shape
            else:
                i, o, kh, kw = mod.weight.shape
            _set(params, path + ("kernel",),
                 _normal(rng, (kh, kw, i, o), kh * kw * i))
            if mod.bias is not None:
                _set(params, path + ("bias",), np.zeros((o,), np.float32))
        elif isinstance(mod, BatchNorm):
            _set_batch_norm(params, stats, path, mod.weight.shape[0])
    return {"params": params, "batch_stats": stats}


# noise scale of perturb_conv_offset_mask: kernel std gain / sqrt(fan_in),
# and the bias std in feature-map px (offsets reach a few px)
OFFSET_KERNEL_GAIN = 0.5
OFFSET_BIAS_STD = 1.5


def perturb_conv_offset_mask(variables: Dict[str, Any], seed: int = 0
                             ) -> Dict[str, Any]:
    """Copy of ``variables`` with seeded noise on every DCN
    ``conv_offset_mask`` kernel and bias. The init zeroes them, so every
    deform conv would sample integer points only; with the noise offsets
    reach a few pixels, out-of-bounds samples included, and the bilinear
    path runs."""
    rng = np.random.default_rng(seed)
    out: Dict[str, Any] = {}
    for path, arr in tree_leaves(variables):
        a = np.asarray(arr, np.float32)
        if "conv_offset_mask" in path:
            if path[-1] == "kernel":
                fan_in = a.shape[0] * a.shape[1] * a.shape[2]
                a = a + (rng.standard_normal(a.shape) * OFFSET_KERNEL_GAIN
                         / np.sqrt(fan_in)).astype(np.float32)
            else:
                a = a + (rng.standard_normal(a.shape)
                         * OFFSET_BIAS_STD).astype(np.float32)
        _set(out, path, a)
    return out
