"""The traced run's readings: ``torch.profiler`` over the measured
window, reduced to what the per-layer metrics read.

* ranges: ``record_function`` ranges, the program's own (``gradsync.*``)
  and the harness's (``pb.*``, put around calls into the program by
  ``mark``); a range's device time sums the kernels inside the windows
  of its device-side marks;
* busy: the union of every kernel's interval, against the window;
* breakdown: the kernels that took most time, and the longest idle gaps
  of the device labelled by the host op that was running then.
"""
from __future__ import annotations

import bisect
import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch

PREFIXES = ("gradsync.", "pb.")


def mark(module, fname: str, rng: str, on_call: Optional[Callable] = None):
    """Wrap ``module.fname`` in the profiler range ``rng``; ``on_call``
    sees each call's arguments (the roofline's shapes) first. Returns
    the undo. The wrapper shares the function's attributes: a kernel
    that counts its calls on itself (``flash_attention_bwd.launches``)
    looks itself up by its module's name, which is the wrapper now."""
    f = getattr(module, fname)

    def run(*a, **k):
        if on_call is not None:
            on_call(*a, **k)
        with torch.profiler.record_function(rng):
            return f(*a, **k)
    run.__dict__ = f.__dict__
    setattr(module, fname, run)
    return lambda: setattr(module, fname, f)


@contextlib.contextmanager
def marked(marks):
    undo = [mark(*m) for m in marks]
    try:
        yield
    finally:
        for u in reversed(undo):
            u()


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _union(iv: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(iv):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _events(prof):
    """(device events, range marks on the device, host events) as
    (start_us, end_us, name), read from the profiler's raw records (the
    parsed event tree, ``prof.events()``, costs minutes on a window of
    training steps)."""
    from torch.autograd import DeviceType
    kern, marks, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        name, dt = e.name(), e.device_type()
        a, b = e.start_ns() / 1e3, e.end_ns() / 1e3
        if dt == DeviceType.CUDA:
            (marks if name.startswith(PREFIXES) else kern).append(
                (a, b, name))
        elif dt == DeviceType.CPU:
            host.append((a, b, name))
    return kern, marks, host


def reduce(prof) -> Dict:
    """{"busy_s", "ranges":
    {name: {"device_ms", "host_ms", "count"}}, "breakdown"}."""
    kern, marks, host = _events(prof)
    kern.sort()
    starts = [k[0] for k in kern]
    ranges: Dict[str, Dict] = {}
    for a, b, name in host:
        if name.startswith(PREFIXES):
            r = ranges.setdefault(name, {"device_ms": 0.0, "host_ms": 0.0,
                                         "count": 0})
            r["host_ms"] += (b - a) / 1e3
            r["count"] += 1
    for a, b, name in marks:
        r = ranges.setdefault(name, {"device_ms": 0.0, "host_ms": 0.0,
                                     "count": 0})
        i = bisect.bisect_left(starts, a)
        while i < len(kern) and kern[i][0] <= b:
            if kern[i][1] <= b:
                r["device_ms"] += (kern[i][1] - kern[i][0]) / 1e3
            i += 1
    busy_us = _union([(a, b) for a, b, _ in kern])
    return {"busy_s": busy_us / 1e6, "ranges": ranges,
            "breakdown": breakdown(kern, host)}


def breakdown(kern, host, n: int = 10) -> Dict:
    by_name: Dict[str, float] = {}
    for a, b, name in kern:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    gaps, end = [], None
    for a, b, _ in kern:
        if end is not None and a > end:
            gaps.append((a - end, end, a))
        end = b if end is None else max(end, b)
    gaps.sort(reverse=True)
    # what the host was doing: the shortest host op spanning the gap's
    # middle (the innermost one), ranges and aten ops alike
    host_sorted = sorted(host)
    hs = [h[0] for h in host_sorted]
    out = []
    for g, a, b in gaps[:n]:
        mid = (a + b) / 2
        best = None
        i = bisect.bisect_right(hs, mid)
        for j in range(max(0, i - 4000), i):
            ha, hb, name = host_sorted[j]
            if ha <= mid <= hb and (best is None or hb - ha < best[0]):
                best = (hb - ha, name)
        out.append([best[1] if best else "no host op", g / 1e6])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": out}
