"""File, JSON and text helpers (counterpart of
pdf_table_tpu/utils/file_utils.py)."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Iterable, List


class FileUtils:

    @staticmethod
    def ensure_dir(path: str) -> str:
        os.makedirs(path, exist_ok=True)
        return path

    @staticmethod
    def ensure_parent(path: str) -> str:
        parent = os.path.dirname(os.path.abspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
        return path

    @staticmethod
    def read_text(path: str, encoding: str = "utf-8") -> str:
        with open(path, "r", encoding=encoding) as f:
            return f.read()

    @staticmethod
    def write_text(path: str, text: str, encoding: str = "utf-8") -> None:
        FileUtils.ensure_parent(path)
        with open(path, "w", encoding=encoding) as f:
            f.write(text)

    @staticmethod
    def read_lines(path: str, encoding: str = "utf-8", strip: bool = True) -> List[str]:
        with open(path, "r", encoding=encoding) as f:
            lines = f.readlines()
        return [ln.rstrip("\n") if strip else ln for ln in lines]

    @staticmethod
    def write_lines(path: str, lines: Iterable[str], encoding: str = "utf-8") -> None:
        FileUtils.ensure_parent(path)
        with open(path, "w", encoding=encoding) as f:
            for ln in lines:
                f.write(str(ln) + "\n")

    @staticmethod
    def read_json(path: str) -> Any:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)

    @staticmethod
    def write_json(path: str, obj: Any, indent: int = 2) -> None:
        FileUtils.ensure_parent(path)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False, indent=indent, default=_json_default)

    @staticmethod
    def read_bytes(path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    @staticmethod
    def write_bytes(path: str, data: bytes) -> None:
        FileUtils.ensure_parent(path)
        with open(path, "wb") as f:
            f.write(data)

    @staticmethod
    def sha256(data: bytes) -> str:
        return hashlib.sha256(data).hexdigest()

    @staticmethod
    def file_sha256(path: str, chunk: int = 1 << 20) -> str:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            while True:
                b = f.read(chunk)
                if not b:
                    break
                h.update(b)
        return h.hexdigest()

    @staticmethod
    def base_name(path: str, with_ext: bool = False) -> str:
        name = os.path.basename(path)
        if not with_ext:
            name = os.path.splitext(name)[0]
        return name

    @staticmethod
    def copy(src: str, dst: str) -> None:
        FileUtils.ensure_parent(dst)
        shutil.copy2(src, dst)

    @staticmethod
    def list_files(directory: str, suffixes: tuple[str, ...] | None = None) -> List[str]:
        out = []
        for root, _dirs, files in os.walk(directory):
            for fn in sorted(files):
                if suffixes is None or fn.lower().endswith(suffixes):
                    out.append(os.path.join(root, fn))
        return out


def _json_default(obj):
    import numpy as np
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if hasattr(obj, "to_dict"):
        return obj.to_dict()
    return str(obj)
