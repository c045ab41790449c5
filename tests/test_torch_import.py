"""fastbox_tpu_torch never imports jax (nor fastbox_tpu, whose __init__ does)."""
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "fastbox_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import fastbox_tpu_torch as p
names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "fastbox_tpu"))
print(len(names), bad)
"""


def test_import_every_module_without_jax():
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    count, bad = res.stdout.strip().split(" ", 1)
    assert int(count) >= 20
    assert bad == "[]"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_import_statement(path):
    src = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|fastbox_tpu)\b",
                         src, re.M), path


def test_kernel_sources_ship_with_the_package():
    from fastbox_tpu_torch.ops.cuda import _build

    names = {p.name for p in _build._sources()}
    assert {"common.cuh", "noise.cu", "rsd_fused.cu", "rsd_interp.cu",
            "binned_pk_v2.cu"} <= names
    # the build key follows the sources and the toolkit
    assert _build.build_key("nvcc 12.8") != _build.build_key("nvcc 12.9")


def test_failed_kernel_build_raises(tmp_path, monkeypatch):
    """A compiler error surfaces as RuntimeError with nvcc's message; no
    library is left behind and nothing falls back."""
    from fastbox_tpu_torch.ops.cuda import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    "if [ \"$1\" = --version ]; then echo fake 0.0; exit 0; fi\n"
                    "echo 'error: no card here' >&2; exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no card here"):
        _build.load_library.__wrapped__()
    assert not list((tmp_path / "build").glob("*/*.so"))
