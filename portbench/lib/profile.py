"""Reading a ``torch.profiler`` trace of a few calls.

The harness profiles a fixed count of calls (CPU and CUDA activities),
each inside a ``portbench.call`` range.  The trace is exported to a file
under ``TMPDIR``, read and deleted.  From it:

* ``window_s``: from the first profiled call's start to the last one's end;
* ``busy_s``: the union of the device's kernels, copies and sets inside
  that span;
* ``device_ops``: device seconds by kernel name, the largest first;
* ``idle_gaps``: the spans inside the window with nothing on the device,
  summed by what the host was doing at their middle (the innermost CPU op
  or runtime call that covers it, else ``host``), the largest first.
"""
from __future__ import annotations

import heapq
import json
import os
import tempfile

CALL_RANGE = "portbench.call"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver"}


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_trace(events: list, top: int = 10) -> dict | None:
    """The summary above from chrome-trace ``events`` (``ts``/``dur`` in
    microseconds); None when no profiled call or no device work is in
    them."""
    calls = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == CALL_RANGE and "dur" in e]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not calls or not dev:
        return None
    t0, t1 = min(a for a, _ in calls), max(b for _, b in calls)
    busy = _merge((max(t0, e["ts"]), min(t1, e["ts"] + e["dur"]))
                  for e in dev if e["ts"] < t1 and e["ts"] + e["dur"] > t0)
    busy_us = sum(b - a for a, b in busy)
    by_op: dict[str, float] = {}
    for e in dev:
        name = e["name"][:160]
        by_op[name] = by_op.get(name, 0.0) + e["dur"] * 1e-6
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"][:160])
                   for e in events if e.get("cat") in HOST_CATS
                   and "dur" in e), key=lambda h: h[0])
    gaps, prev = [], t0
    for a, b in busy + [[t1, t1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    # one sweep over the gaps in time order: a heap of the host events
    # begun so far, the latest-starting on top; an event that ended before
    # a gap's middle has ended for every later gap too, so it goes for good
    by_gap: dict[str, float] = {}
    begun, j = [], 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(begun, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while begun and begun[0][1] < mid:
            heapq.heappop(begun)
        name = begun[0][2] if begun else "host"
        by_gap[name] = by_gap.get(name, 0.0) + (b - a) * 1e-6
    return {
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(by_gap.items(), key=lambda kv: -kv[1])[:top],
    }


def profile_calls(call, indices) -> dict | None:
    """Run ``call(i)`` for each of ``indices`` under the profiler and read
    the trace (:func:`read_trace`)."""
    import sys
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in indices:
            with record_function(CALL_RANGE):
                call(i)
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        t2 = time.perf_counter()
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    out = read_trace(events)
    print(f"profile: {len(events)} events; calls {t1 - t0:.2f} s, export "
          f"{t2 - t1:.2f} s, reading {time.perf_counter() - t2:.2f} s",
          file=sys.stderr)
    return out
