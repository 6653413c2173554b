"""Parallelism (counterpart of pdf_table_tpu/parallel): the mesh of dp, tp
and sp over one process per card (``mesh.py``), the page corpus's shards
over processes (``multihost.py``), the GPipe microbatch pipeline
(``pipeline.py``), and the train step's model-parallel axes, which JAX
leaves to GSPMD: differentiable collectives (``collectives.py``),
column-parallel layers (``tensor_parallel.py``) and row-sharded layers
(``spatial.py``)."""

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
