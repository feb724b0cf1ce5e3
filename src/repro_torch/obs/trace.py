"""Causal trace layer for the distributed control plane.

Every protocol envelope leaving a traced shard carries a **span
context** — ``(trace_id, span_id, depth)`` — alongside the Lamport
``depth`` the runtime already accounts (``core/runtime.py``). The
context is a plain tuple of primitives, so it survives pickling across
the AF_UNIX socket fabric unchanged.

Span model (DESIGN.md §12):

* a **root span** opens when a facade operation starts a causal chain
  (``signal``, ``join``, ``evict``, ``demote``, ``repromote``, the
  coordinator's ``epoch`` fingerprint round);
* every ``Actor.send`` opens a child span under the sender's *current*
  context — the span of the message being handled (set at delivery) or
  the facade root that initiated the local op;
* delivery closes the span with status ``delivered`` (recorded on the
  receiving shard — the two halves meet when the coordinator merges
  the drained records); a stale notification swallowed by the
  partitioned network's black hole closes it with ``blackholed``, so
  eviction fan-out never leaves dangling spans.

Two hop measures ride each span, deliberately distinct:

* ``hop``   — the envelope's Lamport depth at send: max over *all*
  incoming paths, monotone across phases (matches
  ``Network.max_depth`` / ``BENCH_dist.json``'s ``sig_hops``);
* ``depth`` — the span-tree depth under this trace's root: parent
  chain length, which **resets per trace** — this is what the
  per-signal O(log P) invariant asserts at every epoch boundary
  (``check_signal_hops``), independent of how many phases ran before.

Everything here is torch-free: control-plane-only worker processes (the
latency bench) import it without paying the torch import.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

from ..core.complexity import signal_bound

SpanId = Tuple[int, int]          # (shard pid, per-shard sequence)
SpanCtx = Tuple[str, SpanId, int]  # (trace id, span id, tree depth)

# facade ops that open root spans (name -> op recorded on the root)
ROOT_OPS = ("signal", "join", "evict", "demote", "repromote", "epoch",
            "failure")

_MAX_RECORDS = 200_000  # backstop for a shard nobody drains


class Tracer:
    """One shard's span recorder. Hooks are called by ``Actor.send`` /
    ``Network.deliver_from`` (via ``Network.tracer``) and by the
    ``ShardPhaser`` facade for root spans; ``drain()`` hands the
    accumulated records to the coordinator's ``TraceStore``."""

    def __init__(self, pid: int):
        self.pid = pid
        self.seq = 0
        self.records: List[Dict] = []
        self.dropped_records = 0
        # actor rank -> the context its next sends parent under
        self._cur: Dict[int, SpanCtx] = {}
        # optional FlightRecorder tee: every record also lands in the
        # process's bounded crash ring (set by ShardPhaser)
        self.flight = None

    # ------------------------------------------------------------ plumbing
    def _new_id(self) -> SpanId:
        self.seq += 1
        return (self.pid, self.seq)

    def _emit(self, rec: Dict) -> None:
        if self.flight is not None:
            # tee BEFORE the backstop: the flight ring keeps the most
            # recent records even when the drain buffer saturated
            self.flight.record(rec)
        if len(self.records) >= _MAX_RECORDS:
            self.dropped_records += 1
            return
        self.records.append(rec)

    # --------------------------------------------------------------- hooks
    def root(self, op: str, key: int) -> str:
        """Open a root span for a facade op on actor ``key``; the
        actor's subsequent sends become its children."""
        sid = self._new_id()
        trace = f"{op}:{key}:{self.pid}:{sid[1]}"
        self._emit({"ev": "span", "trace": trace, "span": sid,
                    "parent": None, "name": op, "src": key, "dst": key,
                    "pid": self.pid, "hop": 0, "depth": 0})
        self._cur[key] = (trace, sid, 0)
        return trace

    def on_send(self, rank: int, msg, hop: int) -> SpanCtx:
        """Child span for an outgoing envelope; returns the context the
        envelope carries."""
        sid = self._new_id()
        cur = self._cur.get(rank)
        if cur is not None:
            trace, parent, pdepth = cur
            depth = pdepth + 1
        else:
            # a send with no traced cause (e.g. state seeded outside any
            # facade op): its own root, flagged by the trace id prefix
            trace, parent, depth = (f"orphan:{msg.kind}:{self.pid}:{sid[1]}",
                                    None, 0)
        self._emit({"ev": "span", "trace": trace, "span": sid,
                    "parent": parent, "name": msg.kind, "src": msg.src,
                    "dst": msg.dst, "pid": self.pid, "hop": hop,
                    "depth": depth})
        return (trace, sid, depth)

    def on_deliver(self, ctx: SpanCtx, dst: int) -> None:
        """Close the envelope's span and make it the destination actor's
        current context (its handler's sends become children)."""
        self._emit({"ev": "close", "span": ctx[1], "status": "delivered",
                    "pid": self.pid})
        self._cur[dst] = ctx

    def on_blackhole(self, ctx: SpanCtx) -> None:
        """A stale notification to a departed key was swallowed: the
        span still closes — status records where the chain died."""
        self._emit({"ev": "close", "span": ctx[1], "status": "blackholed",
                    "pid": self.pid})

    def span_under(self, key: int, name: str, dst: int) -> SpanId:
        """Closed child span under ``key``'s current context — used for
        causal events that are not envelopes (the coordinator's
        per-host fingerprint RPCs under the ``epoch`` root)."""
        sid = self._new_id()
        cur = self._cur.get(key)
        if cur is not None:
            trace, parent, depth = cur[0], cur[1], cur[2] + 1
        else:
            trace, parent, depth = f"orphan:{name}:{self.pid}:{sid[1]}", \
                None, 0
        self._emit({"ev": "span", "trace": trace, "span": sid,
                    "parent": parent, "name": name, "src": key,
                    "dst": dst, "pid": self.pid, "hop": 0, "depth": depth})
        self._emit({"ev": "close", "span": sid, "status": "delivered",
                    "pid": self.pid})
        return sid

    def drain(self) -> List[Dict]:
        out, self.records = self.records, []
        return out


def trace_root_pid(trace: str) -> Optional[int]:
    """The pid that opened a trace's root span, parsed from the trace
    id (``op:key:pid:seq`` — ``orphan:kind:pid:seq`` for rootless
    sends). Lets ``problems`` tolerate a whole trace whose root lived
    on a lost shard, whatever order the ``lost`` marker arrived in."""
    parts = trace.split(":")
    if len(parts) != 4:
        return None
    try:
        return int(parts[2])
    except ValueError:
        return None


class TraceStore:
    """Merged span records from every shard; reconstructs causal span
    trees and answers the completeness / critical-path queries.

    Retention is bounded (``max_spans``): once the cap is crossed, the
    OLDEST whole traces are evicted — whole traces, never individual
    spans, so every retained tree stays complete and ``problems`` keeps
    its meaning over the retained window. ``dropped_spans`` counts the
    evicted spans; ``max_spans=None`` disables eviction (the per-window
    hop check builds throwaway exact stores that way)."""

    def __init__(self, max_spans: Optional[int] = 100_000):
        self.max_spans = max_spans
        self.spans: Dict[SpanId, Dict] = {}
        self.status: Dict[SpanId, str] = {}
        # shards declared dead before their records could be drained
        # (non-cooperative eviction): their spans are tolerated as
        # incomplete instead of failing the causal-tree check
        self.lost: set = set()
        self.dropped_spans = 0
        self.evicted_traces = 0
        # trace id -> span ids, in trace arrival order (eviction order)
        self._by_trace: "OrderedDict[str, List[SpanId]]" = OrderedDict()

    def mark_lost(self, pid: int) -> None:
        self.lost.add(pid)

    def add(self, records: Iterable[Dict]) -> None:
        for r in records:
            ev = r.get("ev")
            if ev == "span":
                sid = tuple(r["span"])
                self.spans[sid] = r
                self._by_trace.setdefault(r["trace"], []).append(sid)
            elif ev == "close":
                self.status[tuple(r["span"])] = r["status"]
            elif ev == "lost":
                self.lost.add(r["pid"])
            elif ev == "retention":
                # a bounded upstream store already evicted: account it
                self.dropped_spans += r.get("dropped_spans", 0)
                self.evicted_traces += r.get("evicted_traces", 0)
            # unknown ev kinds (flight events, future frames): ignored
        self._evict()

    def _evict(self) -> None:
        if self.max_spans is None:
            return
        while len(self.spans) > self.max_spans and len(self._by_trace) > 1:
            trace, sids = self._by_trace.popitem(last=False)
            for sid in sids:
                self.spans.pop(sid, None)
                self.status.pop(sid, None)
                self.dropped_spans += 1
            self.evicted_traces += 1

    # ------------------------------------------------------------ queries
    def traces(self) -> Dict[str, List[Dict]]:
        out: Dict[str, List[Dict]] = {}
        for r in self.spans.values():
            out.setdefault(r["trace"], []).append(r)
        return out

    def trace_ids(self, op: Optional[str] = None) -> List[str]:
        """Trace ids, optionally filtered by root-op prefix
        (``op="signal"`` -> every signal release chain)."""
        ids = set()
        for r in self.spans.values():
            t = r["trace"]
            if op is None or t.split(":", 1)[0] == op:
                ids.add(t)
        return sorted(ids)

    def root_of(self, trace: str) -> Optional[Dict]:
        for r in self.spans.values():
            if r["trace"] == trace and r["parent"] is None:
                return r
        return None

    def children(self, sid: SpanId) -> List[Dict]:
        sid = tuple(sid)
        return [r for r in self.spans.values()
                if r["parent"] is not None and tuple(r["parent"]) == sid]

    def tree(self, trace: str) -> Dict:
        """Nested {span, children} dict rooted at the trace's root."""
        root = self.root_of(trace)
        assert root is not None, f"trace {trace} has no root span"

        def build(rec):
            return {"span": rec,
                    "status": self.status.get(tuple(rec["span"])),
                    "children": [build(c)
                                 for c in self.children(rec["span"])]}
        return build(root)

    def problems(self, trace: str) -> List[str]:
        """Completeness check: every non-root span's parent must exist
        and every non-root span must be closed (delivered or
        blackholed). Empty list == the causal tree is complete. Spans
        whose parent or close record died with a ``lost`` shard (a
        crashed host whose records could never be drained) are
        tolerated — a crash must not fail the survivors' trees."""
        out = []
        recs = [r for r in self.spans.values() if r["trace"] == trace]
        if not any(r["parent"] is None for r in recs) \
                and trace_root_pid(trace) not in self.lost:
            out.append(f"{trace}: no root span")
        for r in recs:
            sid = tuple(r["span"])
            if r["parent"] is not None \
                    and tuple(r["parent"]) not in self.spans \
                    and r["parent"][0] not in self.lost:
                out.append(f"{trace}: span {sid} has unknown parent "
                           f"{tuple(r['parent'])}")
            if r["parent"] is not None and sid not in self.status \
                    and r["pid"] not in self.lost \
                    and r["dst"] not in self.lost:
                out.append(f"{trace}: span {sid} ({r['name']}) never "
                           "closed")
        return out

    def critical_path(self, trace: str) -> int:
        """Longest causal chain under the trace's root, in hops (the
        span-tree depth — per-trace, so per-phase for signal chains)."""
        return max((r["depth"] for r in self.spans.values()
                    if r["trace"] == trace), default=0)

    def max_hop(self, trace: str) -> int:
        """Largest Lamport envelope depth seen in this trace
        (monotone across phases; first-phase signal traces match
        ``Network.max_depth``)."""
        return max((r["hop"] for r in self.spans.values()
                    if r["trace"] == trace), default=0)

    def blackholed(self) -> List[SpanId]:
        return sorted(s for s, st in self.status.items()
                      if st == "blackholed")


def check_signal_hops(records: Iterable[Dict], n_live: int, *,
                      p: float = 0.5, c: float = 3.0) -> Dict:
    """The paper's T2a claim as a runtime invariant: every signal
    release chain in ``records`` must have critical-path depth within
    ``signal_bound(n_live)``. Raises AssertionError on violation;
    returns the measured summary. The coordinator runs this on the
    window of records drained since the previous check — i.e. at every
    phase advance, epoch boundaries included."""
    store = TraceStore(max_spans=None)   # one window: exact, uncapped
    store.add(records)
    bound = signal_bound(max(2, n_live), p=p, c=c)
    worst, worst_trace = 0, None
    traces = store.trace_ids("signal")
    for t in traces:
        d = store.critical_path(t)
        if d > worst:
            worst, worst_trace = d, t
        assert d <= bound, (
            f"signal trace {t}: critical path {d} hops exceeds the "
            f"O(log P) bound {bound} at n={n_live}")
    return {"traces": len(traces), "max_depth": worst,
            "worst_trace": worst_trace, "bound": bound, "n": n_live}
