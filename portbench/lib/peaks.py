"""The card's published peaks and the roofline arithmetic.

NVIDIA H100 SXM (80 GB HBM3): 3.35 TB/s of memory bandwidth and 67
TFLOP/s in float32 outside the tensor cores, at its full 700 W.  A card
may be set below that limit; ``power_limit_w`` reads what it is set to, and
every result carries it beside the shares.
"""
from __future__ import annotations

import subprocess

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"float32": 67e12, "float64": 34e12}


def bound_ms(n_bytes: float, flops: float, dtype: str = "float32") -> tuple:
    """(the least time in ms the card could take for work that moves
    ``n_bytes`` and computes ``flops``, 'bytes' or 'operations': which of
    the two bounds it)."""
    t_b = n_bytes / PEAK_BYTES_S * 1e3
    t_o = flops / PEAK_FLOPS_S[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def share_pct(bound: float, measured_ms: float):
    """``bound`` as a percentage of the measured time (None without one)."""
    if not measured_ms or measured_ms <= 0:
        return None
    return 100.0 * bound / measured_ms


def power_limit_w():
    """The card's power limit in W from ``nvidia-smi`` (None where it
    cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
