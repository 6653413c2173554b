"""Device mesh and sharding utilities (counterpart of
pdf_table_tpu/parallel/mesh.py).

The scaling story is data parallelism over pages and crops: a "dp" axis,
the batch split over it, the parameters replicated. The train step also
takes JAX's two model-parallel axes: ``tp`` (the output channels of wide
layers, ``tensor_parallel.py``) and ``sp`` (image rows,
``spatial.py``). On the card the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group, one process per card (``multihost.initialize`` or ``torchrun``):
where JAX's single program places shards on devices, each process here
takes its own rows or columns and the results meet in a collective.

A mesh's axes are ``dp``, ``tp`` and ``sp``, in any subset; another name
raises where the mesh is used. The runner and the service split their
pages over ``dp`` only: the ``tp`` and ``sp`` ranks of a dp row run that
row's pages, as JAX replicates the inference programs over those axes.

A mesh's device type follows the group's backend: ``cuda`` over NCCL,
``cpu`` over gloo (the CPU tests, and several processes sharing one card,
which NCCL refuses).
"""

from __future__ import annotations

import socket
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from .multihost import backend_for


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp",),
              devices=None, device=None) -> DeviceMesh:
    """A mesh over the process group's ranks, 1-D by default.

    ``n_devices=None`` spans every process; a mesh spans the whole group,
    so another count raises. Multi-axis layouts pass ``axis_names`` and a
    matching ``devices`` array of ranks. Where no group exists and the mesh
    is one process, a one-rank group is made here (NCCL on ``device``'s
    card, gloo on ``device="cpu"``), as JAX's mesh of one device needs no
    distributed runtime."""
    if not dist.is_initialized():
        if n_devices not in (None, 1) or (devices is not None
                                          and np.asarray(devices).size > 1):
            raise RuntimeError("a mesh of several processes needs the "
                               "process group first "
                               "(parallel.multihost.initialize or torchrun)")
        dist.init_process_group(backend_for(device),
                                init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0)
    world = dist.get_world_size()
    if devices is None:
        if len(axis_names) != 1:
            raise ValueError("multi-axis mesh requires explicit devices "
                             "array")
        n = world if n_devices is None else n_devices
        devices = np.arange(n)
    devices = np.asarray(devices)
    if devices.size != world:
        raise ValueError(f"a mesh spans every process of the group: "
                         f"{devices.size} ranks asked, {world} in the group")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.as_tensor(devices),
                      mesh_dim_names=tuple(axis_names))


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """The mesh's size along ``axis``; 1 without a mesh or that axis (JAX's
    ``mesh.shape.get(axis, 1)``)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


MESH_AXES = ("dp", "tp", "sp")


def check_axes(mesh: Optional[DeviceMesh]) -> None:
    """Raise unless every axis of ``mesh`` is ``dp``, ``tp`` or ``sp``."""
    names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
    bad = [n for n in names if n not in MESH_AXES]
    if bad or len(set(names)) != len(names):
        raise ValueError(f"a mesh's axes are among {MESH_AXES}, each once; "
                         f"got {names}")


def axis_rank_and_size(mesh: Optional[DeviceMesh], axis: str
                       ) -> Tuple[int, int]:
    """(this process's index along ``axis``, the axis size); (0, 1)
    without a mesh or that axis."""
    size = axis_size(mesh, axis)
    return (mesh.get_local_rank(axis) if size > 1 else 0), size


def dp_rank_and_size(mesh: Optional[DeviceMesh]) -> Tuple[int, int]:
    """(this process's index along ``dp``, the dp size); (0, 1) without a
    mesh or a dp axis. An axis but ``dp``, ``tp`` and ``sp`` raises."""
    check_axes(mesh)
    return axis_rank_and_size(mesh, "dp")


def sp_split(t, rank: int, size: int):
    """Rank ``rank``'s rows of a batch leaf split ``size`` ways over its
    dim 1 (JAX's ``spec_for``, ``train_step.py:129``): a leaf of 4 or more
    dims whose dim 1 ``size`` divides; any other leaf whole, as JAX
    replicates it. Returns (the leaf, whether it was split)."""
    if size > 1 and getattr(t, "ndim", 0) >= 4 and t.shape[1] % size == 0:
        m = t.shape[1] // size
        return t[:, rank * m:(rank + 1) * m], True
    return t, False


def data_sharding(mesh: DeviceMesh, axis: str = "dp",
                  ndim: int = 4) -> Tuple[Any, ...]:
    """Dim 0 split over ``axis``, replicated over the other mesh axes: the
    DTensor placements, one per mesh axis (JAX's ``P(axis, None, ...)`` for
    an ``ndim``-d array)."""
    if ndim < 1:
        raise ValueError("a sharded array has a leading dim")
    return tuple(Shard(0) if name == axis else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated_sharding(mesh: DeviceMesh) -> Tuple[Any, ...]:
    return (Replicate(),) * mesh.ndim


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0
                    ) -> np.ndarray:
    """Zero-pad ``axis`` up to a multiple (device-count divisibility)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, rem)
    return np.pad(arr, pad)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def shard_batch(arrays, mesh: DeviceMesh, axis: str = "dp"):
    """This process's rows of host arrays split over ``axis``, after
    zero-padding dim 0 to a multiple of the axis size. Returns (tensors,
    original batch): each leaf a host tensor, which the caller moves to
    its card. Accepts a single array or a dict / list / tuple tree; all
    leaves must share dim-0 length."""
    n = np.asarray(_leaves(arrays)[0]).shape[0]
    size = axis_size(mesh, axis)
    r = mesh.get_local_rank(axis) if size > 1 else 0

    def rows(leaf):
        a = pad_to_multiple(np.asarray(leaf), size, axis=0)
        m = a.shape[0] // size
        return torch.as_tensor(np.ascontiguousarray(a[r * m:(r + 1) * m]))

    return _tree_map(rows, arrays), n


def _broadcast(t: torch.Tensor, src: int) -> None:
    """``t`` in place from rank ``src``; over gloo a card's tensor goes
    through the host."""
    if t.device.type == "cuda" and dist.get_backend() != "nccl":
        host = t.detach().cpu()
        dist.broadcast(host, src)
        with torch.no_grad():
            t.copy_(host)
    else:
        dist.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t,
                       src)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the group's ranks, in place; over gloo a card's
    tensor goes through the host."""
    if t.device.type == "cuda" and dist.get_backend(group) != "nccl":
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def replicate_params(params, mesh: DeviceMesh):
    """Every rank of the mesh takes rank 0's parameters and buffers, so
    that all compute with the same tree. ``params`` is a module (its
    state, in place) or a tree of tensors; returns it."""
    src = int(mesh.mesh.flatten()[0])
    if isinstance(params, torch.nn.Module):
        tensors = list(params.state_dict(keep_vars=True).values())
    else:
        tensors = [t for t in _leaves(params) if isinstance(t, torch.Tensor)]
    if dist.get_world_size() > 1:
        for t in tensors:
            _broadcast(t, src)
    return params
