"""Live phase watermarks, wait attribution, and streaming telemetry.

The paper's claim is about *who waits on whom and for how long*; the
natural live observable (the Formalization-of-Phase-Ordering framing)
is the **phase watermark**: per participant, the last phase it signaled
and the last phase released to it, with the time between the two being
exactly the interval the participant would have blocked in WAIT. Three
pieces, all jax-free and always-on:

* ``WatermarkTracker`` — per-process. The protocol actors call into it
  through getattr-guarded facade hooks (``core/phaser.py``): a counter
  bump per signal / release advance, plus a bounded map of outstanding
  signal timestamps so the signal→release gap accumulates into the
  per-host wait-time decomposition (``wait_s`` blocked-on-WAIT vs
  ``signal_s`` local signaling work vs ``compute_s`` step time).

* ``ClusterWatermarks`` — coordinator-side merge, updated at every
  quiescent advance. Asserts per-host monotonicity across churn and
  generation bumps (a rebuild fast-forwards phases, it never rewinds
  them); a dead host's watermark is frozen at its last observed value,
  then retired out of the live view.

* ``LiveStreamer`` — appends compact JSONL heartbeat frames (watermark
  view, merged counter deltas, detector phi scores, RPC latency
  quantiles, membership events) to ``--live-out`` at a bounded cadence;
  ``python -m repro_torch.obs.watch`` tails the file and renders the
  dashboard mid-run.

Frame schema (DESIGN.md §14): one JSON object per line,
``{"v": 1, "ts", "step", "phase", "epoch", "gen", "live": [pids],
"wm": {pid: {"signal", "wait", "mode", "wait_s", "signal_s",
"compute_s"}}, "retired": {pid: wm}, "deltas": {counter: +n},
"phi": {pid: score}, "rpc": {op: {"p50", "p99"}}, "events":
[[step, kind, pid], ...]}``.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

from .metrics import MetricsRegistry

FRAME_VERSION = 1

# outstanding signal timestamps kept per rank (signals can run ahead of
# releases; the runtime's advance loop keeps this at ~1)
_MAX_OUTSTANDING = 256
# per-phase wait decomposition retained per rank (latest K phases)
_MAX_PHASE_WAITS = 32


class WatermarkTracker:
    """Per-process phase watermarks + wait-time decomposition for the
    locally-owned participants. Hot-path cost is a dict write; wall
    clocks are ``perf_counter`` reads only on signal/release edges
    (once per phase per rank), never per envelope."""

    def __init__(self, pid: int):
        self.pid = pid
        self.gen = 0
        self._hosts: Dict[int, Dict] = {}
        self.dropped_outstanding = 0

    def _host(self, rank: int) -> Dict:
        h = self._hosts.get(rank)
        if h is None:
            h = self._hosts[rank] = {
                "signal": -1, "wait": -1, "mode": "SIG_WAIT",
                "wait_s": 0.0, "signal_s": 0.0, "compute_s": 0.0,
                "sig_t": {},          # outstanding phase -> t_signal
                "phase_waits": {},    # phase -> wait_s (last K)
            }
        return h

    def set_mode(self, rank: int, mode: str) -> None:
        self._host(rank)["mode"] = mode

    # ------------------------------------------------------------- hooks
    def on_signal(self, rank: int, phase: int) -> None:
        h = self._host(rank)
        if phase > h["signal"]:
            h["signal"] = phase
        sig_t = h["sig_t"]
        if len(sig_t) >= _MAX_OUTSTANDING and phase not in sig_t:
            self.dropped_outstanding += 1
            sig_t.pop(next(iter(sig_t)))
        sig_t[phase] = time.perf_counter()

    def on_wait_advance(self, rank: int, phase: int) -> None:
        h = self._host(rank)
        if phase <= h["wait"]:
            return
        h["wait"] = phase
        sig_t = h["sig_t"]
        if sig_t:
            now = time.perf_counter()
            for p in [p for p in sig_t if p <= phase]:
                dt = now - sig_t.pop(p)
                h["wait_s"] += dt
                pw = h["phase_waits"]
                pw[p] = round(dt, 6)
                while len(pw) > _MAX_PHASE_WAITS:
                    pw.pop(next(iter(pw)))

    def add_signal_time(self, rank: int, dt: float) -> None:
        self._host(rank)["signal_s"] += dt

    def add_compute_time(self, rank: int, dt: float) -> None:
        self._host(rank)["compute_s"] += dt

    # ---------------------------------------------------------- snapshot
    def snapshot(self) -> Dict:
        """Plain-dict view (picklable / JSON-able) the agent ships in
        its ``obs`` reply; merged by ``ClusterWatermarks``."""
        return {"pid": self.pid, "gen": self.gen,
                "dropped_outstanding": self.dropped_outstanding,
                "hosts": {r: {"signal": h["signal"], "wait": h["wait"],
                              "mode": h["mode"],
                              "wait_s": round(h["wait_s"], 6),
                              "signal_s": round(h["signal_s"], 6),
                              "compute_s": round(h["compute_s"], 6),
                              "outstanding": len(h["sig_t"]),
                              "phase_waits": dict(h["phase_waits"])}
                         for r, h in self._hosts.items()}}


class WatermarkRegression(AssertionError):
    """A merged watermark moved backwards — phases are monotone by
    construction (rebuild fast-forwards, never rewinds), so regression
    means shard state corruption or a stale-generation leak."""


class ClusterWatermarks:
    """Coordinator-side merged watermark view over every shard's
    tracker snapshots; the single logical view (the PGAS global-view
    presentation) over per-process state."""

    def __init__(self):
        self.view: Dict[int, Dict] = {}      # rank -> merged watermark
        self.retired: Dict[int, Dict] = {}   # rank -> frozen final wm
        self.updates = 0
        self._gen: Dict[int, int] = {}       # rank -> last source gen
        self._strike_base: Dict[int, float] = {}   # rank -> wait_s mark

    def update(self, pid: int, snap: Optional[Dict],
               gen: Optional[int] = None) -> None:
        """Fold one shard's snapshot in; asserts monotonicity per rank
        across churn and generation bumps."""
        if not snap:
            return
        self.updates += 1
        for rank, h in snap.get("hosts", {}).items():
            rank = int(rank)
            if rank in self.retired:
                continue              # frozen: a corpse reports nothing
            cur = self.view.get(rank)
            if cur is not None:
                if h["signal"] < cur["signal"] or h["wait"] < cur["wait"]:
                    raise WatermarkRegression(
                        f"rank {rank}: watermark regressed "
                        f"(signal {cur['signal']}->{h['signal']}, "
                        f"wait {cur['wait']}->{h['wait']}, "
                        f"gen {self._gen.get(rank)}->{gen})")
            self.view[rank] = {k: h[k] for k in
                               ("signal", "wait", "mode", "wait_s",
                                "signal_s", "compute_s")}
            if gen is not None:
                self._gen[rank] = gen

    def retire(self, rank: int) -> Optional[Dict]:
        """A host left (cooperatively or not): freeze its last observed
        watermark and remove it from the live view. Survivor updates
        keep asserting monotone against their own history — retirement
        never resets anyone else's floor."""
        wm = self.view.pop(rank, None)
        if wm is not None:
            self.retired[rank] = wm
        self._gen.pop(rank, None)
        self._strike_base.pop(rank, None)
        return wm

    def wait_seconds(self) -> Dict[int, float]:
        return {r: h["wait_s"] for r, h in self.view.items()}

    def take_wait_deltas(self) -> Dict[int, float]:
        """Per-rank blocked-on-WAIT seconds accumulated since the last
        call — the straggler policy's attribution input (a host slow
        because it *waited* is a victim, not a culprit)."""
        out = {}
        for r, h in self.view.items():
            base = self._strike_base.get(r, 0.0)
            out[r] = max(0.0, h["wait_s"] - base)
            self._strike_base[r] = h["wait_s"]
        return out

    def summary(self) -> Dict:
        return {"live": {r: dict(h) for r, h in sorted(self.view.items())},
                "retired": {r: dict(h)
                            for r, h in sorted(self.retired.items())},
                "updates": self.updates}


class LiveStreamer:
    """Appends heartbeat frames to ``--live-out`` at a bounded cadence.

    Cost model (the <3% traced-step gate covers this): per advance one
    ``monotonic`` read; a frame is serialized only when ``min_interval``
    elapsed (or the caller forces one — failure events must not be
    rate-limited away). Counter deltas are computed against the
    previously framed snapshot so the stream stays compact."""

    def __init__(self, path: str, *, min_interval: float = 0.25):
        self.path = path
        self.min_interval = min_interval
        self.frames = 0
        self.suppressed = 0
        self._f = None
        self._last_t = 0.0
        self._last_counters: Dict[str, float] = {}
        self._last_events = 0

    # ------------------------------------------------------------ frames
    def frame(self, *, step: int, phase: int, epoch: int, gen: int,
              live: List[int], watermarks: Optional[Dict] = None,
              merged_metrics: Optional[Dict] = None,
              phi: Optional[Dict] = None,
              events: Optional[List] = None,
              rpc_quantiles: bool = True,
              force: bool = False) -> bool:
        """Emit one frame if the cadence allows (always on ``force``).
        Returns True iff a frame was written."""
        now = time.monotonic()
        if not force and now - self._last_t < self.min_interval:
            self.suppressed += 1
            return False
        self._last_t = now
        rec = {"v": FRAME_VERSION, "ts": round(time.time(), 3),
               "step": step, "phase": phase, "epoch": epoch,
               "gen": gen, "live": list(live)}
        if watermarks is not None:
            rec["wm"] = {str(r): h for r, h in
                         sorted(watermarks.view.items())}
            if watermarks.retired:
                rec["retired"] = {str(r): h for r, h in
                                  sorted(watermarks.retired.items())}
        if merged_metrics is not None:
            counters = merged_metrics.get("counters", {})
            deltas = {}
            for k, v in counters.items():
                d = v - self._last_counters.get(k, 0)
                if d:
                    deltas[k] = d
            self._last_counters = dict(counters)
            if deltas:
                rec["deltas"] = deltas
            if rpc_quantiles:
                rpc = {}
                for k, h in merged_metrics.get("hists", {}).items():
                    if not k.startswith("rpc.") or not h.get("count"):
                        continue
                    op = k.split(".")[1]
                    p50 = MetricsRegistry.hist_quantile(h, 0.5)
                    p99 = MetricsRegistry.hist_quantile(h, 0.99)
                    if p50 is not None:
                        rpc[op] = {"p50": round(p50, 6),
                                   "p99": round(p99, 6)}
                if rpc:
                    rec["rpc"] = rpc
        if phi:
            rec["phi"] = {str(p): round(v, 3) for p, v in phi.items()}
        if events is not None:
            new = events[self._last_events:]
            self._last_events = len(events)
            if new:
                rec["events"] = new
        self._write(rec)
        return True

    def _write(self, rec: Dict) -> None:
        if self._f is None:
            self._f = open(self.path, "a")
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._f.flush()               # tailers read mid-run
        self.frames += 1

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def read_frames(path: str, *, offset: int = 0) -> List[Dict]:
    """Parse frames from a live-out file, tolerating a torn final line
    (the writer may be mid-append)."""
    out = []
    with open(path) as f:
        if offset:
            f.seek(offset)
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                break                 # torn tail: next poll rereads it
    return out
