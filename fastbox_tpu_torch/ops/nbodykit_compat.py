"""nbodykit-style wrappers over the estimators (counterpart of
``fastbox_tpu/ops/nbodykit_compat.py``).

Every reference example drives its estimation through nbodykit's
``ArrayMesh`` / ``ArrayCatalog.to_mesh`` / ``FFTPower`` / ``FFTCorr``.
These classes mirror that call surface over :mod:`.spectra` and
:mod:`.painting`.  A field or catalogue given as numpy goes to ``device``
(None: the CUDA card, raising without one); a tensor stays where it is.
Results are numpy, as nbodykit's are: ``FFTPower(...).power`` is a
dict-like with 'k', 'power', 'modes' (plus 'power_l' for poles), and
``FFTCorr(...).corr`` one with 'r', 'corr'.
"""
from __future__ import annotations

import numpy as np

from .. import device as devices
from ..grid import GridSpec
from . import painting, spectra

__all__ = ["ArrayMesh", "ArrayCatalog", "FFTPower", "FFTCorr"]


def _tensor(x, device):
    """A tensor stays on its device; anything else goes to ``device``."""
    return devices.on(x, devices.of(x, device=device))


def _box(BoxSize) -> tuple[float, float, float]:
    if np.isscalar(BoxSize):
        BoxSize = (BoxSize,) * 3
    return tuple(float(b) for b in BoxSize)


class ArrayMesh:
    """A field on a periodic box (nbodykit ArrayMesh analog)."""

    def __init__(self, field, BoxSize, device=None):
        self.field = _tensor(field, device)
        self.BoxSize = _box(BoxSize)
        self.grid = GridSpec(N=self.field.shape[0], Lx=self.BoxSize[0],
                             Ly=self.BoxSize[1], Lz=self.BoxSize[2])


class ArrayCatalog:
    """A particle catalogue (nbodykit ArrayCatalog analog).

    ``data`` is a dict with a 'Position' key of shape (Np, 3), positions in
    [0, L) comoving coordinates.
    """

    def __init__(self, data, device=None):
        self.data = {k: _tensor(v, device) for k, v in data.items()}

    def to_mesh(self, Nmesh, BoxSize, window="tsc", compensated=True,
                interlaced=False, position="Position"):
        """Paint onto a mesh with the given assignment window; returns an
        ArrayMesh of the (optionally compensated, optionally interlaced)
        overdensity."""
        box = _box(BoxSize)
        grid = GridSpec(N=int(Nmesh), Lx=box[0], Ly=box[1], Lz=box[2])
        delta = painting.overdensity_from_catalogue(
            self.data[position], grid, window=window, compensated=compensated,
            interlaced=bool(interlaced))
        return ArrayMesh(delta, box)


class _Result(dict):
    """Attribute+item access result container (nbodykit-ish)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc


def _numpy(res: dict) -> _Result:
    return _Result({k: v.cpu().numpy() for k, v in res.items()})


def _as_mesh(obj):
    if isinstance(obj, ArrayMesh):
        return obj
    raise TypeError("first argument must be an ArrayMesh (or use to_mesh)")


def _second(second, mesh: ArrayMesh):
    if isinstance(second, ArrayMesh):
        return second.field
    return None if second is None else _tensor(second, mesh.field.device)


class FFTPower:
    """FFT-based P(k) / P(k,mu) / multipole estimator (FFTPower analog).

    Parameters follow nbodykit: mode '1d' or '2d', optional ``poles``,
    linear bins of width ``dk`` from ``kmin``, and an arbitrary ``los``
    3-vector (default z axis, the only LOS the reference uses).
    """

    def __init__(self, first, mode="1d", Nmu=5, dk=None, kmin=0.0,
                 poles=(), second=None, los=(0, 0, 1)):
        mesh = _as_mesh(first)
        los = tuple(float(v) for v in los)
        second_f = _second(second, mesh)
        self.attrs = {"mode": mode, "dk": dk, "kmin": kmin,
                      "BoxSize": mesh.BoxSize, "los": los}
        self.poles = None
        if poles:
            self.poles = _numpy(spectra.power_multipoles(
                mesh.grid, mesh.field, second=second_f, poles=tuple(poles),
                dk=dk, kmin=kmin, los=los))
        nmu = Nmu if mode == "2d" else 1
        self.power = _numpy(spectra.power_spectrum(
            mesh.grid, mesh.field, second=second_f, dk=dk, kmin=kmin,
            nmu=nmu, los=los))


class FFTCorr:
    """FFT-based correlation-function estimator (FFTCorr analog)."""

    def __init__(self, first, mode="1d", dr=2.0, rmin=0.0, rmax=None,
                 poles=(), second=None, los=(0, 0, 1)):
        mesh = _as_mesh(first)
        los = tuple(float(v) for v in los)
        second_f = _second(second, mesh)
        self.attrs = {"mode": mode, "dr": dr, "BoxSize": mesh.BoxSize,
                      "los": los}
        self.poles = None
        if poles:
            self.poles = _numpy(spectra.correlation_multipoles(
                mesh.grid, mesh.field, second=second_f, poles=tuple(poles),
                dr=dr, rmin=rmin, rmax=rmax, los=los))
        self.corr = _numpy(spectra.correlation_function(
            mesh.grid, mesh.field, second=second_f, dr=dr, rmin=rmin,
            rmax=rmax))
