"""Process-wide constants from the environment (counterpart of
pdf_table_tpu/utils/constants.py), read once under the same
``PDFTABLE_*`` names and defaults: the base, output, model-cache,
page-cache and log directories, the log level, the render DPI and the
debug switch. ``PDFTABLE_COMPUTE_DTYPE`` is read where the dtype policy
lives, at each call (engine/device.py::default_dtype).

The XLA compile-cache directory of the JAX package has no counterpart: the
port runs eagerly, and its kernels build into ``ops/kernels/build/``.
"""

from __future__ import annotations

import os
from pathlib import Path


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


def _env_bool(name: str, default: bool = False) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in {"1", "true", "yes", "on"}


class Constants:
    """Process-wide configuration constants (env-overridable)."""

    HOME = str(Path.home())

    # root for everything written outside a run's output directory
    BASE_DIR = _env("PDFTABLE_BASE_DIR", os.path.join(HOME, ".pdf_table_tpu"))
    # output of pipeline runs (HTML, debug renders, metrics JSON)
    OUTPUT_DIR = _env("PDFTABLE_OUTPUT_DIR", os.path.join(BASE_DIR, "outputs"))
    # converted model weights (models/registry.py::weights_dir)
    MODEL_CACHE_DIR = _env("PDFTABLE_MODEL_CACHE_DIR",
                           os.path.join(BASE_DIR, "models"))
    # rasterized page images
    PAGE_CACHE_DIR = _env("PDFTABLE_PAGE_CACHE_DIR",
                          os.path.join(BASE_DIR, "pages"))
    LOG_DIR = _env("PDFTABLE_LOG_DIR", os.path.join(BASE_DIR, "logs"))
    LOG_FILE = _env("PDFTABLE_LOG_FILE",
                    os.path.join(LOG_DIR, "pdf_table_tpu.log"))
    LOG_LEVEL = _env("PDFTABLE_LOG_LEVEL", "INFO")
    USE_MODELSCOPE_HUB = _env_bool("PDFTABLE_USE_MODELSCOPE_HUB", False)
    PDF_RENDER_DPI = int(_env("PDFTABLE_RENDER_DPI", "144"))
    DEBUG = _env_bool("PDFTABLE_DEBUG", False)

    @classmethod
    def ensure_dirs(cls) -> None:
        """Create the base, output, model-cache, page-cache and log
        directories."""
        for d in (cls.BASE_DIR, cls.OUTPUT_DIR, cls.MODEL_CACHE_DIR,
                  cls.PAGE_CACHE_DIR, cls.LOG_DIR):
            os.makedirs(d, exist_ok=True)
