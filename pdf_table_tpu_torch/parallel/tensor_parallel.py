"""Column-parallel layers: the ``tp`` axis of the train step's mesh.

JAX's rule (``pdf_table_tpu/train/train_step.py::_tp_spec_for_param``)
shards the last dim of every flax param with at least 2 dims, at least
``min_shard_dim`` (256) entries there and a multiple of ``tp``: the output
channels of the wide kernels. Everything else is replicated: biases,
BatchNorm, the 27-channel offset convs, the 2-channel heads. Under GSPMD
that is an annotation; here each such layer holds its rank's columns and
computes

    y = gather_from_tp(layer(copy_to_tp(x), weight shard)) + bias

so that it returns the whole channels, as the one-device layer does, with
the bias replicated and added after the gather (``collectives.py``).

:func:`make_param_shardings` decides on the flax shape, through the weight
bridge's layouts (``convert/flax_bridge.py``): a conv or dense kernel's
last flax axis is torch dim 0 (``nn.Conv2d``, ``nn.Linear`` and the
depthwise ``DepthwiseUpsample``, whose groups then split too), a
transposed conv's dim 1, the DCN weight ``(3, 3, Cin, Cout)`` and an
embedding's their last. :func:`shard_model` swaps the column-parallel
classes into a built model, slicing its current (replicated) weights;
:func:`shard_state` places a :class:`train_step.TrainState` on the mesh
(JAX's signature): the params, and Adam's moments beside them.
:class:`ParamSharding` gathers shards back into the meshless tree, which
checkpoints hold.

JAX keeps Adam's moments replicated (its ``shard_state`` computes their
shardings and places them with ``P()``); here they follow their params'
shards. The values are the same.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..convert.flax_bridge import flax_last_axis
from ..models.lore.dla import DeformConvBlock, DepthwiseUpsample
from . import spatial
from .collectives import Axis, all_gather, copy_to_tp, gather_from_tp
from .mesh import axis_size


def _flax_leaf(module: nn.Module, pname: str):
    """(the flax leaf name, whether it is a transposed conv's kernel) of
    ``module``'s param ``pname``."""
    if pname == "weight":
        if isinstance(module, nn.ConvTranspose2d):
            return "kernel", True
        if isinstance(module, (nn.Conv2d, nn.Linear, DepthwiseUpsample)):
            return "kernel", False
    return pname, False


def make_param_shardings(model: nn.Module, mesh=None,
                         min_shard_dim: int = 256
                         ) -> Dict[str, Optional[int]]:
    """Each param's ``state_dict`` name -> the torch dim JAX's rule shards
    over ``tp`` (the flax leaf's last axis), or None where it replicates
    it. ``mesh=None`` reads as ``tp`` of size 1."""
    tp = axis_size(mesh, "tp")
    dims: Dict[str, Optional[int]] = {}
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            leaf, transposed = _flax_leaf(m, pname)
            d = flax_last_axis(leaf, p.dim(), transposed)
            ok = p.dim() >= 2 and p.shape[d] >= min_shard_dim \
                and p.shape[d] % tp == 0
            dims[f"{mname}.{pname}" if mname else pname] = d if ok else None
    return dims


class ColumnConv2d(spatial.RowConv2d):
    """An ``nn.Conv2d`` holding its rank's output channels (row-sharded
    too in the sp region)."""

    tp: Axis

    def forward(self, x):
        y = spatial.conv2d(copy_to_tp(x, self.tp), self.weight, None,
                           self.stride, self.padding, self.dilation,
                           self.groups, self.rows)
        y = gather_from_tp(y, 1, self.tp)
        return y if self.bias is None else y + self.bias.reshape(-1, 1, 1)


class ColumnConvTranspose2d(spatial.RowConvTranspose2d):
    """An ``nn.ConvTranspose2d`` holding its rank's output channels (its
    weight's dim 1)."""

    tp: Axis

    def forward(self, x):
        y = spatial.conv_transpose2d(copy_to_tp(x, self.tp), self.weight,
                                     None, self.stride, self.padding,
                                     self.output_padding, self.groups,
                                     self.dilation, self.rows)
        y = gather_from_tp(y, 1, self.tp)
        return y if self.bias is None else y + self.bias.reshape(-1, 1, 1)


class ColumnLinear(nn.Linear):
    """An ``nn.Linear`` holding its rank's output features."""

    tp: Axis

    def forward(self, x):
        y = gather_from_tp(F.linear(copy_to_tp(x, self.tp), self.weight),
                           -1, self.tp)
        return y if self.bias is None else y + self.bias


class ColumnEmbedding(nn.Embedding):
    """An ``nn.Embedding`` holding its rank's feature columns."""

    tp: Axis

    def forward(self, ids):
        return gather_from_tp(super().forward(ids), -1, self.tp)


class ColumnDepthwiseUpsample(DepthwiseUpsample):
    """The depthwise upsample holding its rank's channels: each rank
    upsamples its slice of the input's channels."""

    tp: Axis

    def forward(self, x):
        f = self.factor
        c = self.weight.shape[0]
        xs = copy_to_tp(x, self.tp).narrow(1, self.tp.rank * c, c)
        y = spatial.conv_transpose2d(xs, self.weight, None, (f, f),
                                     (f // 2, f // 2), (0, 0), c, (1, 1),
                                     self.rows)
        return gather_from_tp(y, 1, self.tp)


class ColumnDeformConvBlock(DeformConvBlock):
    """The deform-conv block whose DCN weight holds its rank's output
    columns: the kernel runs on ``Cout / tp`` columns, the bias is added
    after the gather."""

    tp: Axis

    def deform(self, x, offset, mask, h0: int) -> torch.Tensor:
        tp = self.tp
        y = self.dcn(copy_to_tp(x, tp), copy_to_tp(offset, tp),
                     copy_to_tp(mask, tp), self.weight, None, h0=h0,
                     ho=offset.shape[1])
        return gather_from_tp(y, -1, tp) + self.bias


# the column-parallel class of each module class the rule can shard, in
# the order they are tested (a subclass before its base)
_COLUMN = ((DeformConvBlock, ColumnDeformConvBlock),
           (DepthwiseUpsample, ColumnDepthwiseUpsample),
           (nn.ConvTranspose2d, ColumnConvTranspose2d),
           (nn.Conv2d, ColumnConv2d),
           (nn.Linear, ColumnLinear),
           (nn.Embedding, ColumnEmbedding))


class ParamSharding:
    """Which params are sharded over ``tp`` (``dims``: name -> torch dim,
    None where replicated), and the moves between shards and the whole."""

    def __init__(self, dims: Mapping[str, Optional[int]], axis: Axis):
        self.axis = axis
        self.dims = {k: d for k, d in dims.items()
                     if d is not None and axis.size > 1}

    def shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's columns of the whole ``t`` (``t`` itself where the
        param is replicated)."""
        d = self.dims.get(name)
        if d is None:
            return t
        k = t.shape[d] // self.axis.size
        return t.narrow(d, self.axis.rank * k, k).clone()

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole param from every rank's shard ``t`` (a collective over
        tp where it is sharded)."""
        d = self.dims.get(name)
        if d is None:
            return t
        return all_gather(t, d, (t.shape[d],) * self.axis.size,
                          self.axis.group)

    def shard_tree(self, tensors: Mapping[str, torch.Tensor]):
        return {k: self.shard(k, v) for k, v in tensors.items()}

    def gather_tree(self, tensors: Mapping[str, torch.Tensor]):
        return {k: self.gather(k, v) for k, v in tensors.items()}


def shard_model(model: nn.Module, mesh, min_shard_dim: int = 256
                ) -> ParamSharding:
    """Swap the column-parallel classes into ``model`` where the rule
    shards a weight (:func:`make_param_shardings`), each keeping this
    rank's columns of its current weight; every rank must hold the same
    weights (``mesh.replicate_params``). Nothing changes where ``tp`` is
    1."""
    sharding = ParamSharding(make_param_shardings(model, mesh,
                                                  min_shard_dim),
                             Axis(mesh, "tp"))
    for mname, m in model.named_modules():
        for pname, p in list(m.named_parameters(recurse=False)):
            name = f"{mname}.{pname}" if mname else pname
            if name not in sharding.dims:
                continue
            cls = next((c for base, c in _COLUMN if isinstance(m, base)),
                       None)
            if cls is None or pname != "weight" \
                    or getattr(m, "groups", 1) != 1:
                raise NotImplementedError(
                    f"{name}: no column-parallel {type(m).__name__}")
            m.__class__ = cls
            m.tp = sharding.axis
            setattr(m, pname, nn.Parameter(sharding.shard(name, p.detach()),
                                           requires_grad=p.requires_grad))
    return sharding


def shard_state(state, mesh, min_shard_dim: int = 256):
    """``state`` (a ``train_step.TrainState`` of a meshless model, its
    params replicated on every rank) placed on the mesh by the rule: the
    model's wide layers become column-parallel, the params and Adam's
    moments their rank's shards. Returns the new state."""
    from ..train.train_step import TrainState

    sharding = shard_model(state.model, mesh, min_shard_dim)
    opt = dict(state.opt_state)
    for k in ("mu", "nu"):
        if k in opt:
            opt[k] = sharding.shard_tree(opt[k])
    return TrainState(step=state.step,
                      params=dict(state.model.named_parameters()),
                      buffers=dict(state.model.named_buffers()),
                      opt_state=opt, model=state.model, sharding=sharding)
