"""Build a hand-written CUDA kernel at first use and load it with ctypes.

``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface under ``ops/kernels/build/`` (listed in
``.gitignore``). The library name carries a hash of its source, so an
edited source rebuilds. nvcc's report (ptxas registers, shared memory,
spills) is kept beside the library as ``<library>.log``. ``build_all``
starts one ``nvcc`` per source, all at once, under a process-wide lock,
so that threads that reach a kernel first together build it once;
``load_all`` builds and loads every kernel's library (a server's
warm-up).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
_LOCK = threading.Lock()
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every ``csrc/<name>.cu`` whose library is missing, one
    ``nvcc`` each, all started together; raise if any fails. Returns each
    library's path."""
    with _LOCK:
        libs = {name: library_path(name) for name in names}
        procs = {}
        for name, lib in libs.items():
            if lib.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
                continue
            libs[name].with_suffix(".log").write_text(log)
            os.replace(tmp, libs[name])
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
        return libs


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built first if missing."""
    return ctypes.CDLL(str(build_all([name])[name]))


def load_all() -> Dict[str, ctypes.CDLL]:
    """Every kernel's library (``KERNELS``), built first where missing."""
    from . import KERNELS

    libs = build_all(sorted(set(KERNELS.values())))
    return {name: ctypes.CDLL(str(path)) for name, path in libs.items()}
