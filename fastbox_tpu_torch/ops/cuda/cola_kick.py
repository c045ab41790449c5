"""K12: the COLA kick-drift in one pass (csrc/cola_kick.cu) and its plain
passes.

K12 replaces no Pallas kernel: ``fastbox_tpu``'s step
(``fastbox_tpu/fields/cola.py``) is ``jnp`` arithmetic that XLA fuses.
``kick_drift_plain`` is the port's step as fourteen PyTorch passes over
the (3, N, N, N) state; the kernel does the same operations in the same
order, each rounded on its own, in one read of x, v, p1, p2 and F and one
write of x and v, so the two leave x and v bit for bit equal.  The scalars
are values of the state's dtype (``ColaEngine.step`` computes them on the
host): c1 = D1, c2 = D2 - D1^2, cf = fac_pm / a, K = K1 + K2, the drift
factors Dr, dD1, dD2 and the box length L.
"""
from __future__ import annotations

import torch

from ... import timing
from . import _build

__all__ = ["kick_drift", "kick_drift_cuda", "kick_drift_plain",
           "vector_path"]

NAME = "cola_kick_drift"


def vector_path(*tensors) -> bool:
    """Whether K12 reads and writes in 16-byte vectors: every array starts
    on a 16-byte boundary.  Else it takes the direct path, element by
    element; both give the same bits."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def kick_drift_plain(x, v, p1, p2, F, c1, c2, cf, K, Dr, dD1, dD2, L):
    """The kick and drift as fourteen PyTorch passes: ``v += (F - (p1 c1 +
    p2 c2) cf) K``, then ``x = (x + v Dr + p1 dD1 + p2 dD2) mod L``, x and
    v in place.  ``F`` is used as scratch."""
    comp = p1 * c1
    comp += p2 * c2
    comp *= cf
    F -= comp
    del comp
    F *= K
    v += F
    x += v * Dr
    x += p1 * dD1
    x += p2 * dD2
    torch.remainder(x, L, out=x)
    timing.count("kick.plain")


def _check(x, v, p1, p2, F):
    """Raise unless x, v, p1, p2 and F are contiguous (3, N, N, N) tensors
    of one float dtype on one device, no two sharing memory."""
    ts = (x, v, p1, p2, F)
    if x.dim() != 4 or x.shape[0] != 3:
        raise ValueError(f"{NAME}: the state must be (3, N, N, N), got "
                         f"{tuple(x.shape)}")
    for t in ts:
        if t.shape != x.shape:
            raise ValueError(f"{NAME}: x, v, p1, p2 and F must share one "
                             f"shape, got {tuple(x.shape)} and "
                             f"{tuple(t.shape)}")
        if t.dtype != x.dtype or t.dtype not in (torch.float32,
                                                 torch.float64):
            raise TypeError(f"{NAME}: expected one dtype, float32 or "
                            f"float64, got {x.dtype} and {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{NAME}: tensors on {x.device} and "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: tensors must be contiguous")
    if len({t.data_ptr() for t in ts}) != len(ts):
        raise ValueError(f"{NAME}: x, v, p1, p2 and F must not share memory")


def kick_drift_cuda(x, v, p1, p2, F, c1, c2, cf, K, Dr, dD1, dD2, L):
    """Launch K12: x and v updated in place; ``F`` is only read."""
    _check(x, v, p1, p2, F)
    _build.require_cuda(NAME, x, v, p1, p2, F, dtype=x.dtype)
    fn = _build.kernel_fn("fbx_cola_kick_drift", x.dtype)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), v.data_ptr(), p1.data_ptr(), p2.data_ptr(),
                 F.data_ptr(), x.numel(), *map(float, (c1, c2, cf, K, Dr,
                                                      dD1, dD2, L)),
                 int(vector_path(x, v, p1, p2, F)),
                 _build.stream_ptr(x.device))
    _build.check(err, NAME)
    _build.count_launch(NAME)
    timing.count("kick.fused")


def kick_drift(x, v, p1, p2, F, c1, c2, cf, K, Dr, dD1, dD2, L):
    """K12 on CUDA tensors, the plain passes on CPU tensors."""
    if x.device.type == "cuda":
        return kick_drift_cuda(x, v, p1, p2, F, c1, c2, cf, K, Dr, dD1, dD2,
                               L)
    if x.device.type == "cpu":
        _check(x, v, p1, p2, F)
        return kick_drift_plain(x, v, p1, p2, F, c1, c2, cf, K, Dr, dD1, dD2,
                                L)
    raise ValueError(f"{NAME}: unsupported device {x.device}")
