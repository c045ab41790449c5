"""Stage timing: the reference examples' prints and per-stage wall times.

``stage`` is a context manager that prints "<name>..." and "\t<name>
complete (x sec)" around a block, as the reference examples' ad-hoc
``time.time()`` prints do, and names the block in ``torch.profiler``
traces; ``Timings`` collects the durations.  ``StageClock`` marks the end
of each stage of one pipeline call: on a CUDA device with a recorded
``torch.cuda.Event`` (no sync until ``ms()``), on the CPU with the host
clock.  The pipeline takes one through its ``clock`` argument; with none it
records nothing.
"""
from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["stage", "Timings", "StageClock"]


class Timings:
    """Collects named stage durations; printable report."""

    def __init__(self):
        self.records: list[tuple[str, float]] = []

    def add(self, name: str, dt: float):
        self.records.append((name, dt))

    def report(self) -> str:
        lines = ["Stage timings:"]
        for name, dt in self.records:
            lines.append(f"  {name:<40s} {dt:8.3f} sec")
        total = sum(dt for _, dt in self.records)
        lines.append(f"  {'TOTAL':<40s} {total:8.3f} sec")
        return "\n".join(lines)


def _cuda_devices(obj, found: set) -> set:
    """The CUDA devices of every tensor in ``obj`` (a tensor, or a list,
    tuple or dict of them, nested)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, found)
    return found


@contextlib.contextmanager
def stage(name: str, verbose: bool = True, timings: Timings | None = None,
          sync=None):
    """Time a pipeline stage, reproducing the reference examples' print style.

    Parameters:
        name: stage label, e.g. "(1) Generating box".
        verbose: print "<name>..." / "<name> complete (x sec)".
        timings: optional Timings collector.
        sync: optional tensor (or list, tuple or dict of tensors) whose CUDA
            devices are synchronised before the clock stops (device work is
            asynchronous); the block may set it as ``holder["sync"]``.
    """
    if verbose:
        print(f"{name}...")
    t0 = time.time()
    with torch.profiler.record_function(name):
        holder = {}
        yield holder
    for dev in _cuda_devices(holder.get("sync", sync), set()):
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    if verbose:
        print(f"\t{name} complete ({dt:3.3f} sec)")
    if timings is not None:
        timings.add(name, dt)


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
