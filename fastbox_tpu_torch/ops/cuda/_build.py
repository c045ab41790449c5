"""Build, load and count the port's CUDA kernels.

The sources in ``fastbox_tpu_torch/csrc/`` are compiled at first use, one
``nvcc`` process per ``.cu`` file, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c

and linked (``nvcc -shared``) into one shared library with a plain C
interface, loaded with ``ctypes``.
The library lives in ``build/torch_kernels/<key>/`` at the checkout root,
keyed by a hash of the sources, the flags and ``nvcc --version``, so a
changed source or toolkit rebuilds and an unchanged one loads at once.
``build.log`` beside it keeps ptxas's register and shared-memory report.
Nothing here runs at import time: the CPU tests import every module on
machines without ``nvcc``.

Each wrapper counts its launches (``count_launch``); a run shows that the
main path went through the kernels by reading ``launch_counts()``.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["load_library", "kernel_fn", "launch_counts",
           "reset_launch_counts", "count_launch", "check", "require_cuda",
           "ptr", "stream_ptr", "build_key", "CSRC", "BUILD_ROOT"]

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = _ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LIB_NAME = "libfastbox_tpu_torch_kernels.so"

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_F64 = ctypes.c_double
_SIGNATURES = {
    "fbx_add_scaled_normal": (_P, _P, _P, _P, _P, _P, _I64, _I64, _INT, _P),
    "fbx_rsd_remap_wrap": (_P, _P, _P, _P, _P, _P, _I64, _I64, _INT, _INT,
                           _P),
    "fbx_rsd_bracket_interp": (_P, _P, _P, _P, _P, _I64, _I64, _INT, _INT,
                               _P),
    "fbx_banded_interp": (_P, _P, _P, _P, _P, _I64, _I64, _INT, _INT, _P),
    "fbx_interp_sorted": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _INT, _P),
    "fbx_binned_pk_v2": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                         _I64, _INT, _INT, _INT, _P),
    "fbx_binned_pk_v2t": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                          _I64, _INT, _INT, _INT, _P),
    "fbx_binned_pk_half_dual": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64,
                                _I64, _I64, _INT, _INT, _INT, _P),
    "fbx_binned_pk_full": (_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                           _INT, _INT, _INT, _P),
    "fbx_half_draw": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _INT,
                      _P),
    "fbx_cic_paint_lattice": (_P, _P, _P, _P, _P, _I64, _INT, _INT, _P),
    "fbx_cic_gather_lattice": (_P, _P, _P, _P, _P, _I64, _INT, _INT, _P),
    "fbx_cic_gather3_lattice": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64,
                                _INT, _INT, _P),
    "fbx_cic_paint_lattice_slab": (_P, _P, _P, _P, _I64, _P, _I64, _I64,
                                   _INT, _P, _P),
    "fbx_cic_gather3_lattice_slab": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I64, _I64, _INT, _P),
    "fbx_dft_c2c_axis": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                         _INT, _INT, _INT, _P),
    "fbx_row_normal": (_P, _I64, _I64, _I64, _I64, _I64, _I64, _INT, _INT,
                       _P, _P),
    "fbx_row_poisson": (_P, _I64, _I64, _I64, _I64, _I64, _P, _P, _P, _I64,
                        _P),
    "fbx_key_normal": (_P, _I64, _I64, _INT, _INT, _F64, _F64, _INT, _P, _P),
    "fbx_key_poisson": (_P, _I64, _I64, _P, _P, _P, _I64, _P),
    "fbx_cola_kick_drift": (_P, _P, _P, _P, _P, _I64) + (_F64,) * 8
    + (_INT, _P),
    "fbx_cic_paint_exact": (_P, _P, _P, _P, _P, _I64, _I64, _P),
    "fbx_cic_gather_exact": (_P,) * 9 + (_I64, _I64, _INT, _P),
}

_launches: collections.Counter = collections.Counter()


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return dict(_launches)


def reset_launch_counts() -> None:
    _launches.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                       "the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def build_key(nvcc_version: str) -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    h.update(nvcc_version.encode())
    return h.hexdigest()[:16]


def _compile_and_link(nvcc: str, out_dir: Path, lib_path: Path) -> None:
    """One nvcc per source in parallel, then one link; ``build.log`` keeps
    every step's output.  Raises with nvcc's message on failure."""
    tag = os.getpid()
    cus = [p for p in _sources() if p.suffix == ".cu"]
    objs = [out_dir / f"{p.stem}.{tag}.o" for p in cus]
    procs = [subprocess.Popen([nvcc, *_FLAGS, "-c", "-o", str(o), str(c)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c, o in zip(cus, objs)]
    logs, errors = [], []
    for c, proc in zip(cus, procs):
        out, err = proc.communicate()
        logs.append(f"== {c.name}\n{out}{err}")
        if proc.returncode != 0:
            errors.append(f"{c.name} ({proc.returncode}):\n{err}")
    if not errors:
        tmp = out_dir / f"{_LIB_NAME}.{tag}.tmp"
        res = subprocess.run([nvcc, *_ARCH, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True,
                             text=True)
        logs.append(f"== link\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            errors.append(f"link ({res.returncode}):\n{res.stderr}")
        else:
            os.replace(tmp, lib_path)
    for o in objs:
        o.unlink(missing_ok=True)
    (out_dir / "build.log").write_text("\n".join(logs))
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    nvcc = _nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    out_dir = BUILD_ROOT / build_key(version)
    lib_path = out_dir / _LIB_NAME
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        _compile_and_link(nvcc, out_dir, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for stem, args in _SIGNATURES.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, stem + suffix)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
    lib.fbx_error_string.argtypes = [ctypes.c_int]
    lib.fbx_error_string.restype = ctypes.c_char_p
    lib.fbx_cic_paint_lattice_slab_scratch.argtypes = [_I64, _I64, _INT,
                                                       _INT]
    lib.fbx_cic_paint_lattice_slab_scratch.restype = _I64
    lib.fbx_poisson_scratch.argtypes = [_I64, _I64, _INT]
    lib.fbx_poisson_scratch.restype = _I64
    return lib


def kernel_fn(stem: str, dtype: torch.dtype):
    """The C entry point ``stem`` for float32 or float64 tensors."""
    suffix = {torch.float32: "_f32", torch.float64: "_f64"}.get(dtype)
    if suffix is None:
        raise TypeError(f"{stem}: unsupported dtype {dtype} "
                        "(float32 or float64)")
    return getattr(load_library(), stem + suffix)


def check(err: int, what: str) -> None:
    if err != 0:
        msg = load_library().fbx_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor, dtype=None) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    (and, with ``dtype``, of that dtype)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device "
                             f"(got {t.device} and {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
