"""The port's public surface is the JAX package's.

The walker reads JAX's surface from the sources with ``ast`` (it imports
no JAX): every module under ``pdf_table_tpu/``, each public module-level
``def`` and ``class`` and each public method of a public class, every name
that a package ``__init__.py`` imports or lists in ``__all__``, and every
name that the top-level ``__getattr__`` resolves. For each item one of
three holds:

(a) the same name exists in the port at the same path (a package export
    is checked with ``getattr`` on the imported package, so that lazy
    exports really resolve);
(b) the item is in ``RENAMED``, JAX's path to the port's, and the port's
    path exists;
(c) the item is in ``EXCLUDED``, with a reason from ``REASONS``.

Keys are ``"path.py"`` for a module, ``"path.py::Name"`` for a name and
``"path.py::Class.method"`` for a method, paths relative to the package
root. ``EXCLUDED`` keys are ``fnmatch`` patterns; a module's entry covers
its names, and a renamed module's names are looked up in its target.
"""

from __future__ import annotations

import ast
import fnmatch
import importlib
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / "pdf_table_tpu"
PORT = "pdf_table_tpu_torch"

REASONS = {
    "tunnel",         # a piece of the TPU tunnel (ROADMAP, Rules for the port)
    "jax_mechanism",  # flax setup, jit or compile caches, jaxpr walks
    "no_caller",      # no caller in the JAX package, its tests or tools/
    "test_oracle",    # a reference that only the JAX tests call
    "pallas",         # ops/pallas/*: PERF.md's kernel table covers them
}

RENAMED: Dict[str, str] = {
    # the port's DLA-34 CenterNet lives beside LORE's detector, under the
    # name JAX gives it in models/centernet_base.py
    "models/centernet_base.py": "models/lore/detector.py",
    "models/lore/detector.py::DLASegDetector":
        "models/lore/detector.py::DLACenterNet",
    # the tp rule and the state's shards sit with the tp layers
    "train/train_step.py::make_param_shardings":
        "parallel/tensor_parallel.py::make_param_shardings",
    "train/train_step.py::shard_state":
        "parallel/tensor_parallel.py::shard_state",
}

EXCLUDED: Dict[str, str] = {
    "engine/params.py::commit_params": "tunnel",
    "ops/page_codec.py": "tunnel",
    "utils/fault.py": "tunnel",
    "pipeline/batch_runner.py::BatchPipeline.warm": "tunnel",
    "tasks/layout.py::OcrLayoutTask.batch_enqueue_pages": "tunnel",
    # the host detour of the wiz refine (tasks/table_structure.py:279-299)
    "models/lore/corner_refine.py::refine_vertices_by_corners_np": "tunnel",
    "utils/profiling.py::trace_acc": "tunnel",
    "utils/profiling.py::drain_trace": "tunnel",
    "utils/profiling.py::trace_event": "tunnel",
    "utils/profiling.py::drain_events": "tunnel",
    "utils/profiling.py::TrackedProgram*": "tunnel",
    "utils/profiling.py::track_program": "tunnel",
    "engine/device.py::enable_compile_cache": "jax_mechanism",
    # flax module.init; the port has the seeded engine/params.py::init_*
    "engine/params.py::init_params": "jax_mechanism",
    # the port's tasks load when they are made
    "engine/infer_task.py::InferTask.ensure_built": "jax_mechanism",
    "utils/flops.py::jaxpr_flops": "jax_mechanism",
    "utils/flops.py::fn_flops": "jax_mechanism",
    "*::*.setup": "jax_mechanism",
    "models/nas_layers.py::nas_pad": "jax_mechanism",
    "models/layers.py::MLP": "no_caller",
    "models/layers.py::TransformerEncoderLayer": "no_caller",
    "models/layers.py::sinusoid_positions": "no_caller",
    "ops/deform_conv.py::deform_conv2d_reference_numpy": "test_oracle",
    "ops/native_ref.py": "test_oracle",
    "ops/pallas/*": "pallas",
}


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def _getattr_names(fn: ast.FunctionDef) -> List[str]:
    """The string constants a module ``__getattr__(name)`` compares
    ``name`` with (``name == "x"``, ``name in ("x", "y")``)."""
    arg = fn.args.args[0].arg
    out: List[str] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare) and isinstance(node.left, ast.Name) \
                and node.left.id == arg:
            for comp in node.comparators:
                elts = comp.elts if isinstance(comp, (ast.Tuple, ast.List,
                                                      ast.Set)) else [comp]
                out += [e.value for e in elts if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)]
    return out


def _init_exports(tree: ast.Module) -> List[str]:
    """The names a package ``__init__.py`` imports, lists in ``__all__``
    or resolves through its module ``__getattr__``."""
    names: List[str] = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module != "__future__":
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            names += [e.value for e in node.value.elts]
        elif isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            names += _getattr_names(node)
    return list(dict.fromkeys(names))


def surface(root: Path) -> List[str]:
    """Every item of the package at ``root``, as keys."""
    items: List[str] = []
    for f in sorted(root.rglob("*.py")):
        rel = f.relative_to(root).as_posix()
        items.append(rel)
        tree = ast.parse(f.read_text(encoding="utf-8"))
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) and _is_public(node.name):
                items.append(f"{rel}::{node.name}")
                if isinstance(node, ast.ClassDef):
                    items += [f"{rel}::{node.name}.{m.name}"
                              for m in node.body
                              if isinstance(m, (ast.FunctionDef,
                                                ast.AsyncFunctionDef))
                              and _is_public(m.name)]
        if f.name == "__init__.py":
            items += [f"{rel}::{n}" for n in _init_exports(tree)]
    return list(dict.fromkeys(items))


def package_exports(root: Path) -> Dict[str, List[str]]:
    """Each package ``__init__.py`` with exports -> its export names."""
    out = {}
    for f in sorted(root.rglob("__init__.py")):
        names = _init_exports(ast.parse(f.read_text(encoding="utf-8")))
        if names:
            out[f.relative_to(root).as_posix()] = names
    return out


def _module_name(port: str, rel: str) -> str:
    parts = rel[:-len(".py")].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([port] + parts)


def _excluded(key: str, excluded: Dict[str, str]) -> Optional[str]:
    module = key.split("::")[0]
    for pattern, reason in excluded.items():
        if fnmatch.fnmatchcase(key, pattern) \
                or fnmatch.fnmatchcase(module, pattern):
            return reason
    return None


def _resolve(port: str, port_dir: Path, key: str) -> Optional[str]:
    """None if ``key`` exists in the port, else why not."""
    rel, _, dotted = key.partition("::")
    if not (port_dir / rel).exists():
        return f"no module {rel}"
    if not dotted:
        return None
    try:
        obj = importlib.import_module(_module_name(port, rel))
    except Exception as e:  # an import error is a finding, not a crash
        return f"import of {rel} fails: {e!r}"
    for part in dotted.split("."):
        try:
            obj = getattr(obj, part)
        except AttributeError:
            return f"{rel} has no {dotted}"
    return None


def unresolved(root: Path, port: str, renamed: Dict[str, str],
               excluded: Dict[str, str]) -> List[Tuple[str, str]]:
    """The items of the package at ``root`` that the port named ``port``
    neither has, nor renames to a path it has, nor excludes with a
    reason from ``REASONS``."""
    port_dir = Path(importlib.import_module(port).__file__).parent
    out = []
    for key in surface(root):
        reason = _excluded(key, excluded)
        if reason is not None:
            if reason not in REASONS:
                out.append((key, f"reason {reason!r} is not one of REASONS"))
            continue
        rel, sep, dotted = key.partition("::")
        target = renamed.get(key)
        if target is None and rel in renamed:
            target = renamed[rel] + sep + dotted
        why = _resolve(port, port_dir, target or key)
        if why is not None:
            out.append((key, why + (f" (renamed to {target})"
                                    if target else "")))
    return out


def stale_entries(root: Path, renamed: Dict[str, str],
                  excluded: Dict[str, str]) -> List[str]:
    """Table keys that match no item of the surface."""
    items = surface(root)
    stale = [k for k in renamed if k not in items]
    stale += [p for p in excluded
              if not any(fnmatch.fnmatchcase(k, p) for k in items)]
    return stale


# --- the port against JAX --------------------------------------------------


def test_port_has_the_jax_public_surface():
    missing = unresolved(JAX_ROOT, PORT, RENAMED, EXCLUDED)
    assert not missing, "\n".join(f"{k}: {why}" for k, why in missing)


def test_tables_name_only_real_items():
    assert not stale_entries(JAX_ROOT, RENAMED, EXCLUDED)
    assert set(EXCLUDED.values()) <= REASONS


_PACKAGES = package_exports(JAX_ROOT)


@pytest.mark.parametrize("init", sorted(_PACKAGES))
def test_package_exports_resolve(init):
    """Each JAX package's export list resolves, name for name, through the
    port's package of the same path."""
    pkg = importlib.import_module(_module_name(PORT, init))
    missing = [n for n in _PACKAGES[init] if not hasattr(pkg, n)]
    assert not missing, f"{pkg.__name__} lacks {missing}"


def test_jax_exports_read_from_sources():
    """The walker reads what the JAX package exports: the top-level lazy
    names, the engine's list and the sizes of two more."""
    assert {"read_pdf", "ExtractionService", "entity", "parallel",
            "__version__"} <= set(_PACKAGES["__init__.py"])
    assert set(_PACKAGES["engine/__init__.py"]) == {
        "InferTask", "TaskConfig", "bucket_batch_size", "BUCKET_SIZES",
        "default_backend", "compute_dtype"}
    assert len(_PACKAGES["ops/__init__.py"]) == 20
    assert len(_PACKAGES["entity/__init__.py"]) == 15


def _named_as_submodules() -> List[str]:
    """Package exports (imported by name in JAX's ``__init__``) that share
    their name with a submodule of the port's package."""
    out = []
    for init in _PACKAGES:
        tree = ast.parse((JAX_ROOT / init).read_text(encoding="utf-8"))
        pkg = _module_name(PORT, init)
        pdir = REPO / pkg.replace(".", "/")
        out += [f"{pkg}.{a.asname or a.name}" for node in tree.body
                if isinstance(node, ast.ImportFrom) for a in node.names
                if (pdir / f"{a.asname or a.name}.py").exists()
                or (pdir / (a.asname or a.name)).is_dir()]
    return out


def test_package_imports_stay_light():
    """In a fresh interpreter: importing the data model pulls in neither
    torch nor a model, importing every package whose exports are lazy
    imports no model module (the names resolve at their first use), and an
    export named as its submodule is still the export once the submodule
    is imported (which binds the submodule's name on the package)."""
    lazy = ["ops", "tasks", "engine", "pipeline", "utils"] + [
        f"models.{m}" for m in ("center_net", "dbnet", "slanet",
                                "table_master", "docx_layout", "picodet",
                                "lgpma", "lore", "cls", "rec_ctc")]
    named = _named_as_submodules()
    assert f"{PORT}.ops.connected_components" in named
    script = textwrap.dedent(f"""
        import importlib, json, sys, types
        import {PORT}.entity
        first = sorted(m for m in sys.modules
                       if m == "torch" or m.startswith("{PORT}.models"))
        for p in {lazy!r}:
            importlib.import_module("{PORT}." + p)
        models = sorted(m for m in sys.modules
                        if m.startswith("{PORT}.models.")
                        and m.count(".") > 2)
        shadowed = []
        for full in {named!r}:
            pkg, name = full.rsplit(".", 1)
            importlib.import_module(full)
            if isinstance(getattr(sys.modules[pkg], name), types.ModuleType):
                shadowed.append(full)
        print(json.dumps({{"entity": first, "models": models,
                          "shadowed": shadowed}}))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "entity": [], "models": [], "shadowed": []}


# --- the walker on two tiny packages ----------------------------------------


def _write(root: Path, files: Dict[str, str]) -> None:
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def test_walker_reports_missing_and_accepts_tables(tmp_path, monkeypatch):
    ref, port = f"walkref_{tmp_path.name}", f"walkport_{tmp_path.name}"
    _write(tmp_path / ref, {
        "__init__.py": "from .a import f, g\n__all__ = ['f', 'g']\n",
        "a.py": """
            def f(): pass
            def g(): pass
            def h(): pass
            def gone(): pass
            def _private(): pass
            class K:
                def m(self): pass
                def setup(self): pass
        """,
        "b.py": "def b(): pass\n",
        "sub/__init__.py": "",
        "sub/c.py": "def c(): pass\n",
    })
    _write(tmp_path / port, {
        "__init__.py": "from .a import f\n",
        "a.py": """
            def f(): pass
            def g(): pass
            def new_h(): pass
            class K:
                def m(self): pass
        """,
        "sub/__init__.py": "",
        "moved.py": "def c(): pass\n",
    })
    monkeypatch.syspath_prepend(str(tmp_path))
    root = tmp_path / ref

    missing = dict(unresolved(root, port, {}, {}))
    assert set(missing) == {"__init__.py::g", "a.py::h", "a.py::gone",
                            "a.py::K.setup", "b.py", "b.py::b",
                            "sub/c.py", "sub/c.py::c"}

    renamed = {"a.py::h": "a.py::new_h", "sub/c.py": "moved.py"}
    excluded = {"a.py::gone": "no_caller", "*::*.setup": "jax_mechanism",
                "b.py": "test_oracle"}
    assert dict(unresolved(root, port, renamed, excluded)) == {
        "__init__.py::g": "__init__.py has no g"}
    assert stale_entries(root, renamed, excluded) == []

    # a rename to a name the port lacks, a reason outside the set and a
    # table key that names nothing are all reported
    bad = dict(unresolved(root, port, {"a.py::h": "a.py::nope"},
                          {"a.py::gone": "unused", "b.py": "test_oracle",
                           "*::*.setup": "jax_mechanism",
                           "sub/*": "tunnel"}))
    assert set(bad) == {"__init__.py::g", "a.py::h", "a.py::gone"}
    assert "renamed to a.py::nope" in bad["a.py::h"]
    assert stale_entries(root, {"a.py::zz": "a.py::f"},
                         {"c.py": "tunnel"}) == ["a.py::zz", "c.py"]

    (tmp_path / port / "__init__.py").write_text("from .a import f, g\n")
    sys.modules.pop(port, None)
    assert unresolved(root, port, renamed, excluded) == []
