"""The run logger (counterpart of pdf_table_tpu/utils/logging_utils.py):
the JAX package's format and level (``PDFTABLE_LOG_LEVEL``) on stderr,
for the CLI, the service and the system's debug output. It is
``pdf_table_tpu_torch.run``, a child of the package's logger and not its
parent: the modules' own loggers (``logging.getLogger(__name__)``) keep
propagating to the root.

A log file is written only where ``PDFTABLE_LOG_FILE`` names one: the JAX
logger always opens ``~/.pdf_table_tpu/logs/pdf_table_tpu.log``, the
port's writes nothing outside what its caller names.
"""

from __future__ import annotations

import logging
import os
import sys
from logging.handlers import TimedRotatingFileHandler

from .constants import Constants

_LOGGERS: dict = {}

_FMT = ("%(asctime)s - %(levelname)s - %(name)s - %(filename)s:%(lineno)d - "
        "%(message)s")


def get_logger(name: str = "pdf_table_tpu_torch.run") -> logging.Logger:
    if name in _LOGGERS:
        return _LOGGERS[name]
    lg = logging.getLogger(name)
    lg.setLevel(getattr(logging, Constants.LOG_LEVEL.upper(), logging.INFO))
    lg.propagate = False
    if not lg.handlers:
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(logging.Formatter(_FMT))
        lg.addHandler(sh)
        if os.environ.get("PDFTABLE_LOG_FILE"):
            try:
                os.makedirs(os.path.dirname(os.path.abspath(
                    Constants.LOG_FILE)), exist_ok=True)
                fh = TimedRotatingFileHandler(
                    Constants.LOG_FILE, when="midnight", backupCount=7,
                    encoding="utf-8")
                fh.setFormatter(logging.Formatter(_FMT))
                lg.addHandler(fh)
            except OSError:
                pass  # read-only filesystem: console-only logging
    _LOGGERS[name] = lg
    return lg


logger = get_logger()
