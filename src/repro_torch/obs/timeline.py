"""Step timeline profiler: Chrome-trace/Perfetto JSON + JSONL events.

Two event sources share one ``Timeline``:

* **host spans** — wall-clock ``span()``/``complete()`` events around
  real work: train steps, epoch re-lowers, coordinator RPCs, phase
  advances. These carry real microsecond timestamps.
* **logical events** — the *structure* of a compiled program, emitted
  at trace time (inside jit, so exactly once per lowering): pipeline
  waves per stage (``pipeline_wave_events``), gradient-sync rounds
  (``gradsync_round_events``), and the overlapped pipeline's per-tick
  group/round grid. Logical timestamps are tick indices scaled to a
  fixed tick width; they land on their own Chrome-trace pid rows so
  Perfetto shows the schedule grid under the wall-clock spans.

The module-level ``activate``/``current`` hook is how trace-time code
deep inside the executors reaches the live timeline without threading
it through every builder signature; when no timeline is active the
hooks cost one ``None`` check.

``span(name)`` is the program's one way to mark a stretch of its work:
the same span goes to the ``torch.profiler`` trace (on the profiler's
clock, beside the device's kernels) while a profiler records, and to
the active timeline, if any. A span is a host range by default; one
opened with ``device=True`` is also marked on the device's timeline
around the kernels launched directly inside it (see ``span``).
"""
from __future__ import annotations

import json
import sys
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

# Chrome-trace pid rows for logical (schedule-structure) events
PID_PIPELINE = 1000
PID_GRADSYNC = 1001
TICK_US = 1000.0  # one logical tick rendered as 1ms


class Timeline:
    def __init__(self, pid: int = 0):
        self.pid = pid
        self.events: List[Dict] = []
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------- clock
    def now(self) -> float:
        """Microseconds since this timeline's epoch."""
        return (time.perf_counter() - self._t0) * 1e6

    # ------------------------------------------------------------ events
    @contextmanager
    def span(self, name: str, *, cat: str = "host", tid: int = 0,
             args: Optional[Dict] = None):
        t = self.now()
        try:
            yield
        finally:
            self.complete(name, t, cat=cat, tid=tid, args=args)

    def complete(self, name: str, start_us: float, *, cat: str = "host",
                 tid: int = 0, args: Optional[Dict] = None) -> None:
        """Emit an X event from an earlier ``now()`` mark to now."""
        self.events.append({"name": name, "ph": "X", "cat": cat,
                            "ts": start_us,
                            "dur": max(0.0, self.now() - start_us),
                            "pid": self.pid, "tid": tid,
                            "args": args or {}})

    def instant(self, name: str, *, cat: str = "host", tid: int = 0,
                args: Optional[Dict] = None) -> None:
        self.events.append({"name": name, "ph": "i", "cat": cat,
                            "ts": self.now(), "s": "t", "pid": self.pid,
                            "tid": tid, "args": args or {}})

    def logical(self, name: str, *, ts: float, dur: float, pid: int,
                tid: int, cat: str = "logical",
                args: Optional[Dict] = None) -> None:
        """Schedule-structure event on a logical-time pid row."""
        self.events.append({"name": name, "ph": "X", "cat": cat,
                            "ts": ts, "dur": dur, "pid": pid, "tid": tid,
                            "args": args or {}})

    def extend(self, events: List[Dict]) -> None:
        self.events.extend(events)

    # ------------------------------------------------------------ export
    def chrome(self) -> Dict:
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome(), f)

    def save_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e) + "\n")


# ---------------------------------------------------------------------------
# active-timeline hook (trace-time emitters inside the executors)
# ---------------------------------------------------------------------------
_ACTIVE: Optional[Timeline] = None


def activate(tl: Timeline) -> None:
    global _ACTIVE
    _ACTIVE = tl


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def current() -> Optional[Timeline]:
    return _ACTIVE


# ---------------------------------------------------------------------------
# spans: the profiler's ranges and the active timeline's host spans
# ---------------------------------------------------------------------------
def profiling() -> bool:
    """Whether a ``torch.profiler`` is recording: torch's own flag, read
    without importing torch (False where torch is not loaded)."""
    p = sys.modules.get("torch.autograd.profiler")
    return p is not None and p._is_profiler_enabled


# the span of a process nobody is watching: enters nothing
_OFF = nullcontext()


class _Span:
    __slots__ = ("name", "args", "tl", "rf", "t")

    def __init__(self, name, device, args, prof, tl):
        self.name, self.args, self.tl = name, args, tl
        self.rf = None
        if prof:
            if device:
                self.rf = sys.modules["torch.autograd.profiler"] \
                    .record_function(name)
            else:
                self.rf = sys.modules["torch"]._C._profiler \
                    ._RecordFunctionFast(name)

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        if self.tl is not None:
            self.t = self.tl.now()
        return None

    def __exit__(self, *exc):
        if self.tl is not None:
            self.tl.complete(self.name, self.t, args=self.args)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, *, device: bool = False, **args):
    """A context manager around one stretch of the program's work.

    While a ``torch.profiler`` records, it opens a range named ``name``
    in the profile. By default that range is a host range alone (an op
    record, which the profiler does not mirror on the device). With
    ``device=True`` it is a ``record_function`` range, which the profiler
    also marks on the device's timeline around the kernels launched
    directly inside it: only for ranges whose device time a reading
    splits out (``gradsync.*``, ``pipeline.*``), since a reduction that
    does not know the name takes such a mark for a kernel. While a
    timeline is active, the span is also one of its host events (with
    ``args``). With neither, it costs the flag read and the ``None``
    check and enters nothing."""
    prof = profiling()
    tl = _ACTIVE
    if not prof and tl is None:
        return _OFF
    return _Span(name, device, args, prof, tl)


# ---------------------------------------------------------------------------
# logical-event derivations (consumed at program-build time)
# ---------------------------------------------------------------------------
def pipeline_wave_events(sched, *, label: str = "",
                         tick_us: float = TICK_US) -> List[Dict]:
    """Per-stage wave occupancy of a ``PipelineSchedule``: one event per
    (wave, stage) where the stage has an item — tid = stage row, name =
    F/B with (chunk group, microbatch). The gaps are the bubble."""
    out = []
    S = sched.n_stages
    for t, (kind, w) in enumerate(sched.waves):
        for s in range(S):
            it = (sched.fwd_item(w, s) if kind == "F"
                  else sched.bwd_item(w, s))
            if it is None:
                continue
            j, m = it
            out.append({"name": f"{kind} m{m}" + (f" c{j}"
                                                  if sched.interleave > 1
                                                  else ""),
                        "ph": "X", "cat": "pipeline" + label,
                        "ts": t * tick_us, "dur": tick_us,
                        "pid": PID_PIPELINE, "tid": s,
                        "args": {"wave": w, "kind": kind, "stage": s,
                                 "chunk_group": j, "microbatch": m}})
    return out


def gradsync_round_events(sched, *, group: int = 0,
                          offset: int = 0,
                          tick_us: float = TICK_US) -> List[Dict]:
    """One event per schedule round (tid = bucket group row; ``offset``
    skews overlapped groups to their pipeline tick)."""
    out = []
    for r, pairs in enumerate(sched.rounds):
        out.append({"name": f"r{r} {sched.op(r)}", "ph": "X",
                    "cat": "gradsync", "ts": (offset + r) * tick_us,
                    "dur": tick_us, "pid": PID_GRADSYNC, "tid": group,
                    "args": {"round": r, "op": sched.op(r),
                             "pairs": len(pairs), "group": group}})
    return out
