"""ctypes bindings for the native C++ cosmology kernels.

The reference's native surface is the CCL C library (SURVEY.md §2.3); this
module fills that role for the rebuild's host-side setup path.  The shared
library is built on demand from ``native/cosmokernels.cpp`` with g++ (cached
next to the source); every entry point has a pure-Python fallback in the
cosmology package, selected automatically when the library is unavailable.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

__all__ = ["get_lib", "available", "eh98_transfer", "growth_tables",
           "comoving_distance", "sigma2_gauss_moments", "sigma_tophat_eh98"]

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native", "cosmokernels.cpp")
_LIB = os.path.join(os.path.dirname(_SRC), "libcosmokernels.so")
_lib = None
_tried = False

_D = ctypes.c_double
_PD = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", _LIB, _SRC],
            check=True, capture_output=True, timeout=120,
        )
        return True
    except Exception:
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB) and os.path.exists(_SRC):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError:
        return None

    lib.eh98_transfer.argtypes = [_D, _D, _D, _D, _PD, _PD, ctypes.c_long]
    lib.growth_tables.argtypes = [_D, _D, _D, _D, _D, ctypes.c_long,
                                  _PD, _PD, _PD]
    lib.comoving_distance.argtypes = [_D, _D, _D, _D, _D, _D]
    lib.comoving_distance.restype = _D
    lib.sigma2_gauss_moments.argtypes = [_PD, _PD, ctypes.c_long, _D, _PD]
    lib.sigma_tophat_eh98.argtypes = [_D, _D, _D, _D, _D, _D]
    lib.sigma_tophat_eh98.restype = _D
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def eh98_transfer(params, k):
    lib = get_lib()
    k = np.ascontiguousarray(k, dtype=np.float64)
    out = np.empty_like(k)
    lib.eh98_transfer(params.Omega_c, params.Omega_b, params.h, params.T_CMB,
                      k, out, k.size)
    return out


def growth_tables(params, a_min=1e-3, n=512):
    lib = get_lib()
    a = np.empty(n)
    D = np.empty(n)
    f = np.empty(n)
    lib.growth_tables(params.Omega_m, params.Omega_r, params.Omega_l,
                      params.w0, a_min, n, a, D, f)
    return a, D, f


def comoving_distance(params, a):
    lib = get_lib()
    return lib.comoving_distance(params.Omega_m, params.Omega_r,
                                 params.Omega_l, params.w0, params.h,
                                 float(a))


def sigma2_gauss_moments(lnk, lnp, R):
    lib = get_lib()
    lnk = np.ascontiguousarray(lnk, dtype=np.float64)
    lnp = np.ascontiguousarray(lnp, dtype=np.float64)
    out = np.empty(3)
    lib.sigma2_gauss_moments(lnk, lnp, lnk.size, float(R), out)
    return out[0], out[1], out[2]


def sigma_tophat_eh98(params, R):
    lib = get_lib()
    return lib.sigma_tophat_eh98(params.Omega_c, params.Omega_b, params.h,
                                 params.T_CMB, params.n_s, float(R))
