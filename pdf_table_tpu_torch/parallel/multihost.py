"""Multi-process input sharding for the page corpus (counterpart of
pdf_table_tpu/parallel/multihost.py).

One process drives one card, PyTorch's idiom: ``torchrun`` starts them, or
each calls :func:`initialize` with the coordinator's address, the count and
its own index. The page corpus is split over the processes in contiguous
shards: each renders and uploads only its own pages. The sharding helpers
are pure functions of (process_index, process_count), copied from the JAX
package, so their arithmetic is the same and testable without processes.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def backend_for(device=None) -> str:
    """NCCL for a CUDA device, gloo for the CPU (``device`` as
    ``engine/device.py::resolve_device`` reads it, so ``None`` is CUDA and
    raises without a card)."""
    from ..engine.device import resolve_device

    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               backend: Optional[str] = None,
               timeout: Optional[float] = None) -> Tuple[int, int]:
    """Join the default process group; returns (process_index,
    process_count).

    With ``num_processes > 1`` the group is made at ``coordinator``
    (``"host:port"`` of process 0) with this ``process_id``. Without it,
    a launcher's environment (``torchrun``: ``WORLD_SIZE`` > 1, with
    ``MASTER_ADDR`` / ``MASTER_PORT``, ``RANK``) is read; a single process
    makes no group, as ``jax.distributed.initialize`` is not called for
    one host. An existing group is kept. The backend is NCCL on a card and
    gloo on ``device="cpu"`` unless ``backend`` names one; on NCCL each
    process takes the card of its local rank (``LOCAL_RANK``, else its
    rank modulo the cards). A failed init raises: nothing falls back to
    another backend or to one process. ``timeout`` (seconds) bounds the
    group's collectives."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if (num_processes or 1) <= 1 and env_world <= 1:
        return 0, 1
    backend = backend or backend_for(device)
    kw = {}
    if timeout is not None:
        kw["timeout"] = timedelta(seconds=timeout)
    if num_processes is not None and num_processes > 1:
        if coordinator is None or process_id is None:
            raise ValueError("num_processes > 1 needs the coordinator's "
                             "address and this process_id")
        addr = coordinator if "://" in coordinator \
            else f"tcp://{coordinator}"
        rank, world = process_id, num_processes
        kw.update(init_method=addr, world_size=world, rank=rank)
    else:
        rank, world = int(os.environ["RANK"]), env_world
        kw.update(init_method="env://")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, **kw)
    return dist.get_rank(), dist.get_world_size()


def shard_bounds(n_items: int, process_index: int,
                 process_count: int) -> Tuple[int, int]:
    """Contiguous [lo, hi) bounds of this process's shard. Remainder pages
    go to the LEADING processes one each, so shard sizes differ by at most
    1 and every page is owned by exactly one process."""
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} out of range "
                         f"[0, {process_count})")
    base, rem = divmod(n_items, process_count)
    lo = process_index * base + min(process_index, rem)
    hi = lo + base + (1 if process_index < rem else 0)
    return lo, hi


def shard_pages(pages: Sequence, process_index: int,
                process_count: int) -> List:
    """This process's contiguous slice of the page corpus (contiguous keeps
    per-PDF locality: a document's pages land on one process so its
    pdf_doc handle opens once)."""
    lo, hi = shard_bounds(len(pages), process_index, process_count)
    return list(pages[lo:hi])


def merge_sharded_results(per_host: Sequence[Sequence]) -> List:
    """Concatenate per-process result lists back into corpus order
    (processes hold contiguous shards, so plain concatenation is
    order-preserving)."""
    out: List = []
    for chunk in per_host:
        out.extend(chunk)
    return out
