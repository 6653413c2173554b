"""Lazy package exports.

A package's names resolve at their first use: its ``__getattr__`` imports
the submodule that holds the name, so that importing the package pulls in
no model, builds no kernel and closes no import cycle. The JAX package
imports most of its exports eagerly; the names are the same.
"""

from __future__ import annotations

import importlib
import sys
from typing import Callable, Dict, Iterable, List, Tuple


def lazy_exports(package: str, exports: Dict[str, str],
                 submodules: Iterable[str] = ()
                 ) -> Tuple[Callable[[str], object], Callable[[], List[str]]]:
    """``(__getattr__, __dir__)`` for ``package``. ``exports`` maps each
    name to the submodule that defines it (relative, ``".config"``);
    ``submodules`` are names that resolve to the submodule itself."""
    subs = frozenset(submodules)

    def __getattr__(name: str):
        if name in subs:
            return importlib.import_module(f".{name}", package)
        if name not in exports:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        value = getattr(importlib.import_module(exports[name], package), name)
        setattr(sys.modules[package], name, value)
        return value

    def __dir__() -> List[str]:
        return sorted(set(vars(sys.modules[package])) | set(exports) | subs)

    return __getattr__, __dir__
