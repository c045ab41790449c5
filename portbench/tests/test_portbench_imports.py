"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program.

Top-level names (the part before the first dot) are compared whole: the
port's name, ``fastbox_tpu_torch``, begins with the JAX package's.
"""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from .conftest import ROOT

BENCH = ROOT / "portbench"
JAX = {"jax", "jaxlib", "flax", "fastbox_tpu"}
PORT = "fastbox_tpu_torch"
LOCAL = {"portbench", PORT}


def _module_file(name: str) -> Path | None:
    """The repo file of a module under a local package, else None."""
    base = ROOT.joinpath(*name.split("."))
    for p in (base.with_suffix(".py"), base / "__init__.py"):
        if p.is_file():
            return p
    return None


def _imports(path: Path) -> set[str]:
    """Absolute names of the modules ``path`` imports (relative imports
    resolved against its package)."""
    pkg = list(path.relative_to(ROOT).with_suffix("").parts)[:-1]
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[:len(pkg) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            out.add(mod)
            out |= {f"{mod}.{a.name}" for a in node.names}
    return out


def closure(files) -> set[str]:
    """Every module name reachable from ``files`` by their imports,
    walking the repo's own packages and stopping at third-party ones."""
    seen_files, names, todo = set(), set(), list(files)
    while todo:
        f = todo.pop()
        if f in seen_files:
            continue
        seen_files.add(f)
        for n in _imports(f):
            names.add(n)
            if n.split(".")[0] in LOCAL:
                g = _module_file(n)
                if g is not None:
                    todo.append(g)
    return names


def _files(*globs):
    return [p for g in globs for p in sorted(BENCH.glob(g))]


def test_nothing_the_benchmark_runs_reaches_jax():
    roots = _files("run.py", "calibrate.py", "entries/*.py", "metrics/*.py",
                   "reference/**/*.py", "lib/*.py")
    tops = {n.split(".")[0] for n in closure(roots)}
    assert PORT in tops          # the walk does reach the program
    assert not tops & JAX


def test_the_reference_imports_nothing_of_the_program():
    tops = {n.split(".")[0] for n in closure(_files("reference/**/*.py"))}
    assert not tops & (JAX | {PORT})


@pytest.mark.parametrize("modules,forbidden", [
    (["portbench.reference.mock", "portbench.reference.cola",
      "portbench.reference.compare", "portbench.reference.control"],
     sorted(JAX | {PORT})),
    (["fastbox_tpu_torch", "fastbox_tpu_torch.parallel.sharded",
      "fastbox_tpu_torch.fields.cola", "portbench.lib.harness",
      "portbench.calibrate"], sorted(JAX)),
])
def test_loaded_modules(modules, forbidden):
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            + "; ".join(f"import {m}" for m in modules)
            + "; print(sorted({n.split('.')[0] for n in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=300, check=True)
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))  # noqa: S307
    assert not loaded & set(forbidden)
