"""PyTorch/CUDA port of pdf_table_tpu for NVIDIA Hopper.

The JAX package ``pdf_table_tpu`` stays the reference; this package imports
nothing of it (nor JAX). Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``. Each kernel the JAX package wrote in Pallas is a
hand-written Hopper kernel here (``ops/kernels/csrc``), with a plain
PyTorch version beside it that the CPU path and the tests use.

The public names are the JAX package's: every package exports what its
JAX counterpart exports, so that code written against ``pdf_table_tpu``
runs on the port by the package name alone
(``tests/test_torch_api_surface.py`` holds the claim).
"""

from ._lazy import lazy_exports
from .version import __version__

__all__ = ["__version__", "read_pdf", "OcrSystemTask", "OcrSystemConfig",
           "BatchPipeline", "ExtractionService"]

__getattr__, __dir__ = lazy_exports(
    __name__,
    {"read_pdf": ".pdf_table",
     "OcrSystemTask": ".pipeline.system",
     "OcrSystemConfig": ".pipeline.system",
     "BatchPipeline": ".pipeline.batch_runner",
     "ExtractionService": ".serve"},
    submodules=("entity", "utils", "models", "tasks", "pipeline",
                "pdf_table", "ops", "eval", "data", "train", "convert",
                "pdfio", "parallel"))
