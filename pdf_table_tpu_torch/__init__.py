"""PyTorch/CUDA port of pdf_table_tpu for NVIDIA Hopper.

The JAX package ``pdf_table_tpu`` stays the reference; this package imports
nothing of it (nor JAX). Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``. Each kernel the JAX package wrote in Pallas is a
hand-written Hopper kernel here (``ops/kernels/csrc``), with a plain
PyTorch version beside it that the CPU path and the tests use.
"""

__version__ = "0.1.0"

__all__ = ["__version__", "read_pdf", "OcrSystemTask", "OcrSystemConfig",
           "BatchPipeline"]


def __getattr__(name):
    """Lazy re-exports of the public API, as the JAX package's."""
    if name == "read_pdf":
        from .pdf_table import read_pdf
        return read_pdf
    if name in ("OcrSystemTask", "OcrSystemConfig"):
        from .pipeline import system
        return getattr(system, name)
    if name == "BatchPipeline":
        from .pipeline.batch_runner import BatchPipeline
        return BatchPipeline
    raise AttributeError(name)
