"""Stage timing: the reference examples' prints and per-stage wall times.

``stage`` is a context manager that prints "<name>..." and "\t<name>
complete (x sec)" around a block, as the reference examples' ad-hoc
``time.time()`` prints do, and names the block in ``torch.profiler``
traces; ``Timings`` collects the durations.  ``StageClock`` is the trace of
one call of the program: it marks the end of each stage, on a CUDA device
with a recorded ``torch.cuda.Event`` (no sync until ``ms()``) and on the
host clock, and holds the call's counters.  The entry points take one
through their ``clock`` argument and make it the active clock for the
call (``active``), so that code with no clock argument counts into it
(``count``); with none they use ``NULL_CLOCK``, which times and counts
nothing.  While ``torch.profiler`` records, every mark, real or null,
also puts a ``stage:<name>`` range on the profiler's clock at the host's
end of the stage.  Clocks whose ``ms()`` was read add their host times and
counts to the process totals (``trace_totals``).

Counter names: ``sync.<site>`` where the program reads a value of the
device to the host (counted on every device, so that CPU runs show the
sites) or copies from pageable host memory to a CUDA device
(``count_copy``); ``rsd.band<b>``/``rsd.exact`` and
``cola.band<b>``/``cola.exact``, the tier or band each RSD remap and COLA
paint took; ``exact.paint``/``exact.gather``, the force paints and force
components that COLA's exact tier computed; ``colaplan.hit``/``.miss``,
whether a COLA engine found its host plan built; ``collective.calls`` and
``collective.bytes``, the ``torch.distributed`` collectives issued and the
bytes this rank sent.
"""
from __future__ import annotations

import contextlib
import contextvars
import time

import torch

__all__ = ["stage", "Timings", "StageClock", "NULL_CLOCK", "active", "count",
           "count_copy", "trace_totals", "reset_trace_totals"]


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


_profiling = torch.autograd._profiler_enabled
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "fastbox_tpu_torch_clock", default=None)
_TOTALS: dict = {"calls": 0, "host_ms": {}, "counts": {}}


def _profile_mark(stage: str) -> None:
    """A zero-length ``stage:<stage>`` range on the profiler's clock."""
    with torch.profiler.record_function("stage:" + stage):
        pass


class _NullClock:
    """The clock of a call made without one: no times, no counts; its
    marks reach a recording profiler only."""

    __slots__ = ()

    def mark(self, stage: str) -> None:
        if _profiling():
            _profile_mark(stage)


NULL_CLOCK = _NullClock()


class StageClock:
    """Collects (stage, end time) marks and counters of one call; ``ms()``
    gives each stage's device time, ``host_ms()`` its host time."""

    def __init__(self, device):
        """The first stage starts now."""
        self.device = torch.device(device)
        self._marks: list[tuple[str, object, float]] = [("", *self._now())]
        self._counts: dict[str, int] = {}
        self._folded = False

    def _now(self) -> tuple[object, float]:
        """(the device's time: a recorded event on CUDA, else the host's;
        the host's)."""
        t = time.perf_counter()
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            return ev, t
        return t, t

    def mark(self, stage: str) -> None:
        """The stage named ``stage`` ends now."""
        self._marks.append((stage, *self._now()))
        if _profiling():
            _profile_mark(stage)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the call's counter ``name``."""
        self._counts[name] = self._counts.get(name, 0) + n

    def counts(self) -> dict[str, int]:
        """The call's counters."""
        return dict(self._counts)

    def _per_stage(self, dt) -> dict[str, float]:
        out: dict[str, float] = {}
        for a, b in zip(self._marks, self._marks[1:]):
            out[b[0]] = out.get(b[0], 0.0) + dt(a, b)
        return out

    def host_ms(self) -> dict[str, float]:
        """Milliseconds per stage on the host clock (from the previous
        mark to the stage's own), in the order of ``ms()``."""
        return self._per_stage(lambda a, b: 1e3 * (b[2] - a[2]))

    def ms(self) -> dict[str, float]:
        """Milliseconds per stage, in pipeline order (waits for the
        device).  The first read adds the call's host times and counts to
        the process totals."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            out = self._per_stage(lambda a, b: a[1].elapsed_time(b[1]))
        else:
            out = self.host_ms()
        if not self._folded:
            self._folded = True
            _TOTALS["calls"] += 1
            for into, src in ((_TOTALS["host_ms"], self.host_ms()),
                              (_TOTALS["counts"], self._counts)):
                for k, v in src.items():
                    into[k] = into.get(k, 0) + v
        return out


@contextlib.contextmanager
def active(clock):
    """The call's clock, or ``NULL_CLOCK`` for None; a real clock is the
    active one (``count``'s) inside the block."""
    if clock is None:
        yield NULL_CLOCK
        return
    token = _ACTIVE.set(clock)
    try:
        yield clock
    finally:
        _ACTIVE.reset(token)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the active clock's counter ``name``; nothing without
    an active clock."""
    clock = _ACTIVE.get()
    if clock is not None:
        clock.count(name, n)


def count_copy(name: str, device, n: int = 1) -> None:
    """Count ``n`` copies from pageable host memory to ``device`` as host
    syncs, ``sync.<name>``, where ``device`` is a CUDA device: such a copy
    waits for the device's stream to drain."""
    clock = _ACTIVE.get()
    if clock is not None and torch.device(device).type == "cuda":
        clock.count("sync." + name, n)


def trace_totals() -> dict:
    """``{"calls", "host_ms", "counts"}`` summed over the clocks whose
    ``ms()`` was read since the last ``reset_trace_totals()``."""
    return {"calls": _TOTALS["calls"], "host_ms": dict(_TOTALS["host_ms"]),
            "counts": dict(_TOTALS["counts"])}


def reset_trace_totals() -> None:
    _TOTALS.update(calls=0, host_ms={}, counts={})
