"""Host C++ built at first use: ``g++`` compiles a source of
``ops/native/`` into ``ops/native/build/`` (listed in ``.gitignore``), the
library's name carrying a hash of the source and the flags, so that an
edit rebuilds. ``ops/cv_host.py`` (OpenCV's host geometry) and
``utils/cv_readers.py`` (OpenCV's PNM and GIF loops) load theirs this
way. It lives under ``utils`` so that an image decode imports no
torch."""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent.parent / "ops" / "native"
BUILD_DIR = NATIVE_DIR / "build"
CXXFLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")


def library_path(source: Path) -> Path:
    """``native/build/lib<stem>-<hash>.so`` (the stem without its
    underscores), the hash over the source and the flags."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"lib{source.stem.replace('_', '')}-" \
                       f"{h.hexdigest()[:12]}.so"


def build_native(source: Path) -> Path:
    """Build the library of ``source`` if it is missing (a file of this
    process's own, renamed into place, so that concurrent builds do not
    collide)."""
    lib = library_path(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXXFLAGS, str(source), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {source.name} failed:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib
