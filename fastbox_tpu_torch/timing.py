"""Per-stage wall times of one pipeline call.

``StageClock`` marks the end of each stage: on a CUDA device with a
recorded ``torch.cuda.Event`` (no sync until ``ms()``), on the CPU with the
host clock.  The pipeline takes one through its ``clock`` argument; with
none it records nothing.
"""
from __future__ import annotations

import time

import torch

__all__ = ["StageClock"]


class StageClock:
    """Collects (stage, end time) marks; ``ms()`` gives each stage's time."""

    def __init__(self, device):
        """The first stage starts now."""
        self.device = torch.device(device)
        self._marks: list[tuple[str, object]] = [("", self._now())]

    def _now(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            return ev
        return time.perf_counter()

    def mark(self, stage: str) -> None:
        """The stage named ``stage`` ends now."""
        self._marks.append((stage, self._now()))

    def ms(self) -> dict[str, float]:
        """Milliseconds per stage, in pipeline order (waits for the device)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out: dict[str, float] = {}
        for (_, t0), (name, t1) in zip(self._marks, self._marks[1:]):
            dt = (t0.elapsed_time(t1) if self.device.type == "cuda"
                  else 1e3 * (t1 - t0))
            out[name] = out.get(name, 0.0) + dt
        return out
