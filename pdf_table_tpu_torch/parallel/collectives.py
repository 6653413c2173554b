"""The model-parallel axes' collectives, differentiable: plain
``torch.distributed`` calls inside ``torch.autograd.Function``s. JAX's
GSPMD writes these into the one-device program from its sharding
annotations (``pdf_table_tpu/train/train_step.py``); here each layer calls
them where its shards meet.

| function | forward | backward |
|---|---|---|
| :func:`copy_to_tp` | identity | all-reduce over tp |
| :func:`gather_from_tp` | all-gather channels | own slice |
| :func:`halo_rows` | the rows a layer needs from the ranks that own them, the layer's fill past the image's edges | the halo rows' gradients summed back into their owners' rows |
| :func:`gather_rows_for_dcn` | all-gather rows | sum over sp, own rows |
| :func:`gather_rows_replicated` | all-gather rows | own rows, no sum |

The two row gathers differ in their backward only, and that is the point:
a deform conv's downstream differs on every rank (each computes its own
output rows from the whole input), so the input's gradient is a sum over
the ranks; the heads' gathered maps feed a replicated downstream, whose
gradient every rank already holds whole, so a sum would count it ``sp``
times.

Over gloo a card's tensor goes through the host, as ``mesh.all_reduce_sum``
does. ``collective_calls`` and ``collective_bytes`` count each function's
calls and the bytes of its results on this process, forward and backward
(``name`` and ``name.backward``), as ``ops.kernels.launch_counts`` counts
launches.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

collective_calls: Counter = Counter()
collective_bytes: Counter = Counter()


def reset_collective_counts() -> None:
    collective_calls.clear()
    collective_bytes.clear()


def _count(name: str, t: torch.Tensor) -> None:
    collective_calls[name] += 1
    collective_bytes[name] += t.numel() * t.element_size()


def _via_host(t: torch.Tensor, group) -> bool:
    return t.device.type == "cuda" and dist.get_backend(group) != "nccl"


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: ``t`` summed over the group's ranks."""
    if _via_host(t, group):
        host = t.detach().cpu()
        dist.all_reduce(host, group=group)
        return host.to(t.device)
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def all_gather(t: torch.Tensor, dim: int, sizes: Sequence[int],
               group) -> torch.Tensor:
    """The ranks' tensors concatenated along ``dim``, rank ``i``'s
    ``sizes[i]`` long there (unequal sizes are padded to the largest for
    the call)."""
    m = max(sizes)
    src = t.detach()
    if src.shape[dim] < m:
        pad = list(src.shape)
        pad[dim] = m - src.shape[dim]
        src = torch.cat([src, src.new_zeros(pad)], dim)
    host = _via_host(t, group)
    src = (src.cpu() if host else src).contiguous()
    parts = [torch.empty_like(src) for _ in sizes]
    dist.all_gather(parts, src, group=group)
    out = torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)],
                    dim)
    return out.to(t.device) if host else out


class Axis:
    """One mesh axis as the collectives see it: this process's index along
    it, its size and its process group."""

    def __init__(self, mesh, name: str):
        from .mesh import axis_rank_and_size

        self.name = name
        self.rank, self.size = axis_rank_and_size(mesh, name)
        self.group = mesh.get_group(name) if self.size > 1 else None


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _count("copy_to_tp.backward", g)
        return all_reduce(g, ctx.axis.group), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; backward: the own slice of the gradient,
    summed over the ranks first where ``sum_grads``."""

    @staticmethod
    def forward(ctx, x, dim, sizes, axis, sum_grads, name):
        ctx.meta = (dim, sizes, axis, sum_grads, name)
        out = all_gather(x, dim, sizes, axis.group)
        _count(name, out)
        return out

    @staticmethod
    def backward(ctx, g):
        dim, sizes, axis, sum_grads, name = ctx.meta
        if sum_grads:
            g = all_reduce(g, axis.group)
            _count(name + ".backward", g)
        start = sum(sizes[:axis.rank])
        return (g.narrow(dim, start, sizes[axis.rank]).contiguous(), None,
                None, None, None, None)


def copy_to_tp(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x``, replicated over tp, as the input of a column-parallel layer:
    each rank's shard adds its part of ``x``'s gradient, so the backward
    all-reduces it over tp."""
    if axis.size == 1:
        return x
    return _CopyToTP.apply(x, axis)


def gather_from_tp(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """The whole channels of a column-parallel layer's output, each rank's
    ``x`` its shard along ``dim``; the backward takes the own slice."""
    if axis.size == 1:
        return x
    return _Gather.apply(x, dim, (x.shape[dim],) * axis.size, axis, False,
                         "gather_from_tp")


def _counts(starts: Sequence[int]) -> Tuple[int, ...]:
    return tuple(b - a for a, b in zip(starts, starts[1:]))


def gather_rows_for_dcn(x: torch.Tensor, dim: int, starts: Sequence[int],
                        axis: Axis) -> torch.Tensor:
    """A deform conv's whole input from its row shards (rank ``i`` holds
    rows ``[starts[i], starts[i + 1])`` along ``dim``); the backward sums
    the gradient over sp and takes the own rows (a reduce-scatter)."""
    return _Gather.apply(x, dim, _counts(starts), axis, True,
                         "gather_rows_for_dcn")


def gather_rows_replicated(x: torch.Tensor, dim: int,
                           starts: Sequence[int], axis: Axis
                           ) -> torch.Tensor:
    """Whole maps from their row shards (as :func:`gather_rows_for_dcn`),
    for a downstream that every sp rank computes alike; the backward takes
    the own rows, no sum."""
    return _Gather.apply(x, dim, _counts(starts), axis, False,
                         "gather_rows_replicated")


def row_heights(h: int, axis: Axis, device) -> List[int]:
    """Every sp rank's row count of a row-sharded tensor (this rank's is
    ``h``)."""
    dev = device if dist.get_backend(axis.group) == "nccl" else "cpu"
    t = torch.tensor([h], dtype=torch.int64, device=dev)
    out = all_gather(t, 0, (1,) * axis.size, axis.group)
    _count("row_heights", out)
    return [int(v) for v in out.tolist()]


class _Halo(torch.autograd.Function):
    """:func:`halo_rows` as one node, so that its backward (and its
    all-reduce) runs on every rank, whichever rows each rank's window
    takes from the others."""

    @staticmethod
    def forward(ctx, x, starts, lo, hi, depth, fill, axis):
        r = axis.rank
        H = starts[-1]
        own0, own1 = starts[r], starts[r + 1]
        h = own1 - own0
        n = min(depth, h)

        def fill_rows(k):
            shape = list(x.shape)
            shape[2] = k
            return x.new_full(shape, fill)

        def from_others(a, b):
            """Indices into the gathered edges of rows [a, b) of other
            ranks: a rank below sent its first rows, one above its
            last."""
            idx = []
            for j in range(a, b):
                q = next(q for q in range(axis.size)
                         if starts[q] <= j < starts[q + 1])
                i = j - starts[q] if q > r else j - (starts[q + 1] - depth)
                if not 0 <= i < depth:
                    raise RuntimeError(f"row {j} lies past the halo depth "
                                       f"{depth} of rank {q}")
                idx.append(q * 2 * depth + i + (depth if q < r else 0))
            return torch.tensor(idx, dtype=torch.long, device=x.device)

        gathered = None
        if depth:
            first, last = x.narrow(2, 0, n), x.narrow(2, h - n, n)
            if n < depth:
                pad = fill_rows(depth - n)
                first, last = torch.cat([first, pad], 2), \
                    torch.cat([pad, last], 2)
            slab = torch.cat([first, last], 2)
            gathered = all_gather(slab, 2, (2 * depth,) * axis.size,
                                  axis.group)
            _count("halo_rows", gathered)
        # the window's segments, in row order: (kind, rows, source)
        segs = [("fill", max(min(hi, 0) - lo, 0), None)]
        a, b = max(lo, 0), min(hi, own0)
        segs.append(("halo", max(b - a, 0), from_others(a, b)
                     if b > a else None))
        a, b = max(lo, own0), min(hi, own1)
        segs.append(("own", max(b - a, 0), a - own0))
        a, b = max(lo, own1), min(hi, H)
        segs.append(("halo", max(b - a, 0), from_others(a, b)
                     if b > a else None))
        segs.append(("fill", max(hi - max(lo, H), 0), None))
        pieces = []
        for kind, k, src in segs:
            if not k:
                continue
            if kind == "fill":
                pieces.append(fill_rows(k))
            elif kind == "own":
                pieces.append(x.narrow(2, src, k))
            else:
                pieces.append(gathered.index_select(2, src))
        ctx.meta = (segs, depth, n, h, axis)
        ctx.gathered_shape = None if gathered is None else gathered.shape
        return torch.cat(pieces, 2)

    @staticmethod
    def backward(ctx, g):
        segs, depth, n, h, axis = ctx.meta
        shape = list(g.shape)
        shape[2] = h
        gx = g.new_zeros(shape)
        gslab = None if ctx.gathered_shape is None \
            else g.new_zeros(ctx.gathered_shape)
        off = 0
        for kind, k, src in segs:
            if kind == "own" and k:
                gx.narrow(2, src, k).add_(g.narrow(2, off, k))
            elif kind == "halo" and k:
                gslab.index_add_(2, src, g.narrow(2, off, k))
            off += k
        if gslab is not None:
            gslab = all_reduce(gslab, axis.group)
            _count("halo_rows.backward", gslab)
            mine = gslab.narrow(2, axis.rank * 2 * depth, 2 * depth)
            gx.narrow(2, 0, n).add_(mine.narrow(2, 0, n))
            gx.narrow(2, h - n, n).add_(mine.narrow(2, 2 * depth - n, n))
        return gx, None, None, None, None, None, None


def halo_rows(x: torch.Tensor, starts: Sequence[int], lo: int, hi: int,
              depth: int, fill: float, axis: Axis) -> torch.Tensor:
    """Rows ``[lo, hi)`` of the image-wide tensor whose rows ``x`` (N, C,
    h, W) holds ``[starts[r], starts[r + 1])`` of on this rank ``r``. Rows
    past the image's edges are ``fill``; rows of other ranks come from
    them: every rank contributes its first and last ``depth`` rows (the
    deepest any rank reaches past its own rows, the same on every rank) in
    one all-gather, and the backward sums the halo rows' gradients back to
    their owners in one all-reduce. ``depth`` 0 sends nothing."""
    return _Halo.apply(x, tuple(starts), lo, hi, depth, fill, axis)


def split_rows(n: int, size: int) -> Tuple[int, ...]:
    """Where each of ``size`` ranks' rows of ``n`` start, and ``n``: rank
    ``r`` owns ``[floor(r n / size), floor((r + 1) n / size))``."""
    return tuple(r * n // size for r in range(size + 1))


__all__ = ["Axis", "all_gather", "all_reduce", "collective_bytes",
           "collective_calls", "copy_to_tp", "gather_from_tp",
           "gather_rows_for_dcn", "gather_rows_replicated", "halo_rows",
           "reset_collective_counts", "row_heights", "split_rows"]
