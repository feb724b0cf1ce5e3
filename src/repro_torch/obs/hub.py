"""ObsHub: the coordinator-side collection point of the obs plane.

One hub per ``DistCoordinator`` (when built with ``obs=True``): it
accumulates every shard's drained span records into a ``TraceStore``,
keeps the latest per-process metrics snapshots for merging, owns the
coordinator's wall-clock ``Timeline``, and runs the per-signal
O(log P) hop assertion over each drained window — the window between
two collections is exactly one phase advance, so the invariant runs at
every phase and therefore at every epoch boundary, churn included.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from .live import ClusterWatermarks
from .metrics import MetricsRegistry
from .timeline import Timeline
from .trace import TraceStore, check_signal_hops


def spans_path(trace_path: str) -> str:
    """JSONL span-log path derived from the Chrome-trace path."""
    base = trace_path[:-5] if trace_path.endswith(".json") else trace_path
    return base + ".spans.jsonl"


class ObsHub:
    def __init__(self, *, p: float = 0.5, c: float = 3.0):
        self.p = p
        self.c = c
        self.store = TraceStore()
        self.metrics = MetricsRegistry()     # coordinator-local shard
        self.shards: Dict[int, Dict] = {}    # pid -> latest snapshot
        self.timeline = Timeline(pid=-1)
        self.hop_checks = 0
        self.hop_check_log: List[Dict] = []
        self._window: List[Dict] = []        # records since last check
        # merged live phase-watermark view (fed by the coordinator from
        # every shard's tracker snapshot at each quiescent advance)
        self.watermarks = ClusterWatermarks()

    # ---------------------------------------------------------- ingestion
    def ingest(self, pid: int, spans: List[Dict],
               metrics: Optional[Dict] = None) -> None:
        self.store.add(spans)
        self._window.extend(spans)
        if metrics is not None:
            self.shards[pid] = metrics

    def note_lost(self, pid: int) -> None:
        """A host died without draining its span shard: its records are
        gone. The store (and the exported span log, so offline checks
        agree) tolerates the resulting dangling parents / missing
        closes instead of reporting an incomplete causal tree."""
        rec = {"ev": "lost", "pid": pid}
        self.store.mark_lost(pid)
        self._window.append(rec)

    # --------------------------------------------------------- invariants
    def check_window(self, n_live: int, *, phase: Optional[int] = None
                     ) -> Dict:
        """Assert the O(log P) per-signal hop bound over the records
        collected since the previous check; called after every
        quiescent phase advance."""
        res = check_signal_hops(self._window, n_live, p=self.p, c=self.c)
        self._window = []
        self.hop_checks += 1
        self.hop_check_log.append({**res, "phase": phase})
        self.metrics.inc("obs.hop_checks")
        self.metrics.set("obs.signal_depth", res["max_depth"])
        return res

    # ------------------------------------------------------------ merging
    def merged_metrics(self) -> Dict:
        return MetricsRegistry.merge(
            [self.metrics.snapshot(), *self.shards.values()])

    # ------------------------------------------------------------- export
    def span_records(self) -> List[Dict]:
        """The retained window of span records, reconstructed from the
        capped store (retention is bounded — DESIGN.md §12): a
        ``retention`` marker accounting everything evicted, the ``lost``
        markers, then per trace (oldest first) each span followed by its
        close. Offline checks over the exported log therefore agree
        with the in-memory store."""
        out: List[Dict] = []
        st = self.store
        if st.dropped_spans or st.evicted_traces:
            out.append({"ev": "retention",
                        "dropped_spans": st.dropped_spans,
                        "evicted_traces": st.evicted_traces})
        out.extend({"ev": "lost", "pid": pid} for pid in sorted(st.lost))
        for trace, sids in st._by_trace.items():
            for sid in sids:
                rec = st.spans.get(sid)
                if rec is None:
                    continue
                out.append(rec)
                status = st.status.get(sid)
                if status is not None:
                    out.append({"ev": "close", "span": list(sid),
                                "status": status, "pid": rec["pid"]})
        return out

    def export(self, trace_path: Optional[str] = None,
               metrics_path: Optional[str] = None) -> None:
        """Write the Chrome trace (+ sibling span JSONL) and/or the
        merged metrics JSON."""
        if trace_path:
            self.timeline.save(trace_path)
            with open(spans_path(trace_path), "w") as f:
                for r in self.span_records():
                    f.write(json.dumps(r) + "\n")
        if metrics_path:
            with open(metrics_path, "w") as f:
                json.dump({"metrics": self.merged_metrics(),
                           "hop_checks": self.hop_check_log}, f, indent=2)

    def summary(self) -> Dict:
        return {"spans": len(self.store.spans),
                "dropped_spans": self.store.dropped_spans,
                "hop_checks": self.hop_checks,
                "max_signal_depth": max((h["max_depth"]
                                         for h in self.hop_check_log),
                                        default=0),
                "blackholed": len(self.store.blackholed()),
                "watermarks": self.watermarks.summary()}
