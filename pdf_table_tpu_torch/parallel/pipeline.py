"""Pipeline parallelism (pp): a GPipe-style microbatch pipeline over a mesh
axis (counterpart of pdf_table_tpu/parallel/pipeline.py).

Each process of the ``pp`` axis holds one stage's slice of a stacked
parameter tree and runs M + L - 1 ticks: stage 0 takes microbatch t at
tick t, stage L - 1 emits it at tick t + L - 1, and between ticks every
stage's activation hops to the next process by a point-to-point send
(bubble fraction (L - 1) / (M + L - 1)). The hop is an autograd Function
whose backward is the reverse ring, as ``lax.ppermute``'s VJP is, so
``torch.autograd`` through the pipeline gives the sequential gradients.
The last stage's outputs reach every process, as JAX's closing ``psum``
does. With one stage there is no communication.
"""

from __future__ import annotations

from typing import Callable, List

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import _leaves, _tree_map, axis_size


def _peer(mesh: DeviceMesh, axis_name: str, index: int) -> int:
    """The global rank at ``index`` along ``axis_name`` with this process's
    other coordinates."""
    coord = list(mesh.get_coordinate())
    coord[mesh.mesh_dim_names.index(axis_name)] = index
    return int(mesh.mesh[tuple(coord)])


def _exchange(send: torch.Tensor, dst: int, src: int) -> torch.Tensor:
    """Send ``send`` to rank ``dst`` and receive a tensor of its shape from
    rank ``src``."""
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send.contiguous(), dst),
           dist.P2POp(dist.irecv, recv, src)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _Shift(torch.autograd.Function):
    """One hop of the ring: y to the next stage, the previous stage's y
    back; the backward sends the cotangent the other way round."""

    @staticmethod
    def forward(ctx, y, nxt, prv):
        ctx.nxt, ctx.prv = nxt, prv
        return _exchange(y.detach(), nxt, prv)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.prv, ctx.nxt), None, None


class _Ingest(torch.autograd.Function):
    """Stage 0's input: the fresh microbatch, with the ring's buffer kept
    in the graph (a zero cotangent), so that every process takes part in
    every hop's backward."""

    @staticmethod
    def forward(ctx, fresh, buf):
        return fresh.clone()

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros_like(g)


class _FromLast(torch.autograd.Function):
    """The last stage's outputs broadcast to every process of the axis; the
    cotangent is the last stage's own (every process holds the same
    replicated value). ``tail``, this process's activation of the last
    tick, ties the whole ring into every process's graph (a zero
    cotangent): the backward of every hop then runs on every process, in
    the same order."""

    @staticmethod
    def forward(ctx, outputs, tail, src, group, is_src):
        ctx.is_src, ctx.tail_shape = is_src, tail.shape
        out = outputs.detach().clone()
        dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return ((g if ctx.is_src else None), torch.zeros(
            ctx.tail_shape, dtype=g.dtype, device=g.device), None, None,
            None)


def gpipe_apply(stage_fn: Callable, stacked_params, microbatches: torch.Tensor,
                mesh: DeviceMesh, axis_name: str = "pp") -> torch.Tensor:
    """Run ``y = stage_{L-1}(... stage_0(x))`` for every microbatch, with
    the L stages spread over the mesh's ``axis_name`` axis.

    stage_fn: (params, x) -> y, with y.shape == x.shape (a uniform stack).
    stacked_params: a tree (dict / list / tuple) of tensors whose leading
        dim is L == the axis size; each process uses its own slice, so its
        gradient is nonzero in that slice only (summed over the axis, the
        gradients are the whole stack's).
    microbatches: (M, mb, ...) input stream, the same on every process.
    Returns (M, mb, ...) outputs, on every process of the axis.
    """
    L = axis_size(mesh, axis_name)
    idx = mesh.get_local_rank(axis_name) if L > 1 else 0
    params = _tree_map(lambda a: a[idx], stacked_params)
    M = microbatches.shape[0]
    if L == 1:
        return torch.stack([stage_fn(params, microbatches[t])
                            for t in range(M)])
    nxt = _peer(mesh, axis_name, (idx + 1) % L)
    prv = _peer(mesh, axis_name, (idx - 1) % L)
    buf = torch.zeros_like(microbatches[0])
    outs: List[torch.Tensor] = []
    for t in range(M + L - 1):
        if idx == 0:
            fresh = microbatches[t] if t < M \
                else torch.zeros_like(microbatches[0])
            x = _Ingest.apply(fresh, buf)
        else:
            x = buf
        y = stage_fn(params, x)
        if idx == L - 1 and t >= L - 1:
            outs.append(y)
        if t < M + L - 2:
            buf = _Shift.apply(y, nxt, prv)
    last = idx == L - 1
    outputs = torch.stack(outs) if last else torch.zeros(
        (M,) + tuple(y.shape), dtype=y.dtype, device=y.device)
    return _FromLast.apply(outputs, y, _peer(mesh, axis_name, L - 1),
                           mesh.get_group(axis_name), last)


def sequential_apply(stage_fn: Callable, stacked_params,
                     microbatches: torch.Tensor) -> torch.Tensor:
    """Reference semantics of :func:`gpipe_apply` in one process."""
    L = _leaves(stacked_params)[0].shape[0]

    def run_one(x):
        for i in range(L):
            x = stage_fn(_tree_map(lambda a: a[i], stacked_params), x)
        return x

    return torch.stack([run_one(x) for x in microbatches])
