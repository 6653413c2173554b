"""Parallelism (counterpart of pdf_table_tpu/parallel): the dp mesh over
one process per card (``mesh.py``), the page corpus's shards over
processes (``multihost.py``) and the GPipe microbatch pipeline
(``pipeline.py``)."""

from .mesh import (
    make_mesh,
    data_sharding,
    replicated_sharding,
    shard_batch,
    replicate_params,
    pad_to_multiple,
)

__all__ = [
    "make_mesh",
    "data_sharding",
    "replicated_sharding",
    "shard_batch",
    "replicate_params",
    "pad_to_multiple",
]
