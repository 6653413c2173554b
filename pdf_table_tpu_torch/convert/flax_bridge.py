"""Weight bridge: the JAX package's flax variables -> the port's state_dict.

The port's modules carry the flax submodule names as attribute names, so the
path maps one to one (``params/detector/base/level3/...`` ->
``detector.base.level3...``). Leaf layouts (the inverse of
pdf_table_tpu/convert/torch_to_flax.py):

- conv ``kernel`` HWIO -> ``weight`` OIHW; a depthwise kernel
  (kh, kw, 1, C) takes the same transpose to (C, 1, kh, kw), the grouped
  ``nn.Conv2d`` weight and LORE's ``conv_transpose2d`` upsample weight;
- a flax ``nn.ConvTranspose`` ``kernel`` (kh, kw, In, Out) -> the
  ``nn.ConvTranspose2d`` ``weight`` (In, Out, kh, kw), flipped in space:
  flax dilates the input and correlates with the kernel as it is, which
  for DBNet's 2x2/2 "SAME" upsample puts ``kernel[1 - dy, 1 - dx]`` where
  torch puts ``weight[..., dy, dx]``;
- dense ``kernel`` (In, Out) -> ``weight`` (Out, In);
- embed ``embedding`` -> ``weight``, unchanged;
- BatchNorm ``scale``/``bias`` + ``batch_stats`` ``mean``/``var`` ->
  ``weight``/``bias``/``running_mean``/``running_var``; LayerNorm
  ``scale``/``bias`` -> ``weight``/``bias``;
- the DCN ``weight`` (3, 3, Cin, Cout) keeps the JAX layout, which the
  deform-conv function takes as it is; ``bias`` and RefNorm ``alpha`` too,
  and the other raw leaves (PReLU ``negative_slope``, ConvNext ``gamma``,
  ``pos_embed``, DBNet's ``depthwise_kernel`` / ``depthwise_bias``);
- flax's ``OptimizedLSTMCell`` pair of a bidirectional LSTM
  (``fwd_cell`` / ``bwd_cell`` under one parent, gates ``i{g}`` on the
  input without a bias, ``h{g}`` on the hidden state with one, g in i, f,
  g, o) -> the parent's ``lstm`` (an ``nn.LSTM``): ``weight_ih_l0`` the
  four input kernels stacked in that order, ``weight_hh_l0`` and
  ``bias_hh_l0`` the hidden ones, ``bias_ih_l0`` zero; ``bwd_cell`` is the
  ``_reverse`` half (:func:`fuse_lstm_cells`).

Inputs are nested dicts of numpy-convertible arrays; nothing here imports
JAX. :func:`state_dict_to_flax` goes the other way (the trainer keeps its
checkpoints in the flax layout, so that the inference tasks load them).
"""

from __future__ import annotations

from typing import AbstractSet, Any, Dict, Iterator, Mapping, Tuple

import re

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}
_LSTM_LEAF = re.compile(
    r"^(.*)\.(fwd|bwd)_cell\.([ih])([ifgo])\.(weight|bias)$")


def tree_leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
                ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from tree_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_leaf_to_torch(leaf: str, a: np.ndarray, transposed: bool = False
                       ) -> np.ndarray:
    """The array of the flax param named ``leaf`` in the torch layout;
    ``transposed`` marks the kernel of a flax ``nn.ConvTranspose``."""
    if leaf == "kernel" and transposed:
        return a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    if leaf == "kernel":
        return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
    return a


def torch_leaf_to_flax(leaf: str, t: torch.Tensor, transposed: bool = False
                       ) -> torch.Tensor:
    """The inverse of :func:`flax_leaf_to_torch`."""
    if leaf == "kernel" and transposed:
        return t.flip(2, 3).permute(2, 3, 0, 1)
    if leaf == "kernel":
        return t.permute(2, 3, 1, 0) if t.dim() == 4 else t.T
    return t


def state_dict_name(path: Tuple[str, ...], collection: str = "params"
                    ) -> str:
    """The state_dict key of the flax leaf at ``path`` in ``collection``."""
    if collection == "batch_stats":
        name = _STATS[path[-1]]
    else:
        name = "weight" if path[-1] in ("kernel", "scale", "embedding") \
            else path[-1]
    return ".".join(path[:-1] + (name,))


def state_dict_to_flax(sd: Mapping[str, torch.Tensor],
                       like: Mapping[str, Any],
                       transposed: AbstractSet[str] = frozenset()
                       ) -> Dict[str, Any]:
    """state_dict-named tensors -> a flax variables tree shaped like
    ``like`` (its "params" and, where present, "batch_stats"), each leaf a
    contiguous tensor in the flax layout on its own device. Every leaf of
    ``like`` must be in ``sd``."""
    out: Dict[str, Any] = {}
    for col in ("params", "batch_stats"):
        for path, _ in tree_leaves(like.get(col, {})):
            t = sd[state_dict_name(path, col)]
            if col == "params":
                t = torch_leaf_to_flax(path[-1], t,
                                       ".".join(path[:-1]) in transposed)
            node = out.setdefault(col, {})
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t.contiguous()
    return out


def flax_to_state_dict(variables: Mapping[str, Any],
                       transposed: AbstractSet[str] = frozenset()
                       ) -> Dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} -> a state_dict (f32 tensors).
    ``transposed`` names the modules (dotted paths) that are flax
    ``nn.ConvTranspose``."""
    out: Dict[str, torch.Tensor] = {}
    for col in ("params", "batch_stats"):
        for path, arr in tree_leaves(variables.get(col, {})):
            a = np.asarray(arr, np.float32)
            if col == "params":
                a = flax_leaf_to_torch(path[-1], a,
                                       ".".join(path[:-1]) in transposed)
            out[state_dict_name(path, col)] = torch.from_numpy(
                np.array(a, np.float32, order="C"))
    return out


def fuse_lstm_cells(sd: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """``sd`` with each flax LSTM cell's per-gate leaves (already in the
    torch layout, ``{parent}.{fwd,bwd}_cell.{i,h}{i,f,g,o}.{weight,bias}``)
    replaced by the packed ``{parent}.lstm`` weights of ``nn.LSTM``."""
    cells: Dict[Tuple[str, str], Dict[str, torch.Tensor]] = {}
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        m = _LSTM_LEAF.match(k)
        if m is None:
            out[k] = v
            continue
        parent, direction, side, gate, leaf = m.groups()
        cells.setdefault((parent, direction), {})[side + gate + leaf] = v
    for (parent, direction), g in cells.items():
        sfx = "_l0" if direction == "fwd" else "_l0_reverse"
        w_ih = torch.cat([g[f"i{c}weight"] for c in "ifgo"])
        out[f"{parent}.lstm.weight_ih{sfx}"] = w_ih
        out[f"{parent}.lstm.weight_hh{sfx}"] = torch.cat(
            [g[f"h{c}weight"] for c in "ifgo"])
        out[f"{parent}.lstm.bias_ih{sfx}"] = torch.zeros(w_ih.shape[0])
        out[f"{parent}.lstm.bias_hh{sfx}"] = torch.cat(
            [g[f"h{c}bias"] for c in "ifgo"])
    return out


def transposed_modules(model: torch.nn.Module) -> AbstractSet[str]:
    """The dotted paths of ``model``'s ``nn.ConvTranspose2d`` modules."""
    return {name for name, m in model.named_modules()
            if isinstance(m, torch.nn.ConvTranspose2d)}


def model_variables(model: torch.nn.Module, like: Mapping[str, Any]
                    ) -> Dict[str, Any]:
    """``model``'s parameters and statistics as a flax variables tree
    shaped like ``like`` (detached tensors on the model's device)."""
    sd = {k: t.detach() for k, t in model.state_dict().items()}
    return state_dict_to_flax(sd, like, transposed_modules(model))


def load_flax_variables(model: torch.nn.Module,
                        variables: Mapping[str, Any]) -> None:
    """Copy a flax variables tree into ``model`` in place, keeping each
    parameter's device and dtype. Every key must match both ways."""
    sd = fuse_lstm_cells(flax_to_state_dict(variables,
                                            transposed_modules(model)))
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"flax tree does not match the model: missing "
                       f"{missing[:5]}, unexpected {extra[:5]}")
    for k, v in sd.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: model {tuple(own[k].shape)} vs flax "
                             f"{tuple(v.shape)}")
    model.load_state_dict(sd)
