"""Typed metrics registry with per-process shards.

Every process (host agent, worker subprocess, the coordinator, the
serve engine) owns a ``MetricsRegistry``; the coordinator merges the
shards' ``snapshot()`` dicts into one cluster view at collection time
(``MetricsRegistry.merge``). Three metric types, all jax-free:

* ``Counter``    — monotone; merge = sum across shards;
* ``Gauge``      — last-set level; merge = max across shards (levels
  like decode occupancy compare, they don't add);
* ``Histogram``  — count/total/min/max plus a bounded reservoir of
  recent samples for a median AND a fixed log-spaced bucket ladder
  (shared across every shard, so merge is an elementwise sum of
  bucket counts); p50/p99 derive from the cumulative bucket counts
  (``quantile``) — the latency numbers the serve autoscaler and the
  live-telemetry frames read.

Names are dot-separated, subsystem first: ``serve.prefill.traces``,
``rpc.derive_epoch.seconds``, ``exchange.bytes_sent``,
``program_cache.hits``, ``strikes.straggle`` (DESIGN.md §12).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Iterable, List, Optional

_RESERVOIR = 64

# Shared bucket ladder: geometric, 1 µs .. 25 s in 1/2.5/5 decades
# (seconds-denominated metrics land mid-ladder; anything above the top
# bound falls into the implicit +inf bucket). Every shard uses the SAME
# ladder, which is what makes merge a plain elementwise sum.
BUCKET_BOUNDS = tuple(m * (10.0 ** e)
                      for e in range(-6, 2) for m in (1.0, 2.5, 5.0))
_NB = len(BUCKET_BOUNDS) + 1          # + the +inf overflow bucket


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


def _bucket_index(v: float) -> int:
    lo, hi = 0, len(BUCKET_BOUNDS)
    while lo < hi:                     # first bound >= v (upper bound)
        mid = (lo + hi) // 2
        if BUCKET_BOUNDS[mid] >= v:
            hi = mid
        else:
            lo = mid + 1
    return lo                          # == len(BOUNDS) -> +inf bucket


def quantile_from_buckets(buckets: List[int], q: float,
                          vmax: Optional[float] = None
                          ) -> Optional[float]:
    """Quantile estimate from cumulative bucket counts: the upper bound
    of the bucket where the cumulative count crosses ``q`` (the +inf
    bucket reports ``vmax`` when known). Works on a live ``Histogram``'s
    buckets and on merged snapshot dicts alike."""
    total = sum(buckets)
    if not total:
        return None
    target = q * total
    cum = 0
    for i, n in enumerate(buckets):
        cum += n
        if cum >= target:
            if i < len(BUCKET_BOUNDS):
                return BUCKET_BOUNDS[i]
            return vmax if vmax is not None else BUCKET_BOUNDS[-1]
    return vmax if vmax is not None else BUCKET_BOUNDS[-1]


class Histogram:
    __slots__ = ("count", "total", "vmin", "vmax", "recent", "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        self.recent: Deque[float] = deque(maxlen=_RESERVOIR)
        self.buckets: List[int] = [0] * _NB

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        self.recent.append(v)
        self.buckets[_bucket_index(v)] += 1

    def median(self) -> Optional[float]:
        if not self.recent:
            return None
        s = sorted(self.recent)
        return s[len(s) // 2]

    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-derived quantile (p50: ``quantile(0.5)``, p99:
        ``quantile(0.99)``); resolution is the ladder's decade thirds."""
        return quantile_from_buckets(self.buckets, q, self.vmax)


class MetricsRegistry:
    """One process's metric shard. ``snapshot()`` is plain dicts of
    primitives — picklable across the socket fabric and JSON-dumpable
    for ``--metrics-out``."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    # ------------------------------------------------------------- access
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram()
        return h

    # convenience one-liners for hot paths
    def inc(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    def set(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    # ---------------------------------------------------------- snapshots
    def snapshot(self) -> Dict:
        return {
            "counters": {k: c.value for k, c in self._counters.items()},
            "gauges": {k: g.value for k, g in self._gauges.items()},
            "hists": {k: {"count": h.count, "total": h.total,
                          "min": h.vmin, "max": h.vmax,
                          "recent": list(h.recent),
                          "buckets": list(h.buckets)}
                      for k, h in self._hists.items()},
        }

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()

    @staticmethod
    def merge(snapshots: Iterable[Dict]) -> Dict:
        """Fold per-process snapshots into one cluster-wide view."""
        out = {"counters": {}, "gauges": {}, "hists": {}}
        for snap in snapshots:
            if not snap:
                continue
            for k, v in snap.get("counters", {}).items():
                out["counters"][k] = out["counters"].get(k, 0) + v
            for k, v in snap.get("gauges", {}).items():
                cur = out["gauges"].get(k)
                out["gauges"][k] = v if cur is None else max(cur, v)
            for k, h in snap.get("hists", {}).items():
                cur = out["hists"].get(k)
                if cur is None:
                    out["hists"][k] = {**h, "recent": list(h["recent"]),
                                       "buckets": list(h.get("buckets")
                                                       or [0] * _NB)}
                    continue
                cur["count"] += h["count"]
                cur["total"] += h["total"]
                mins = [m for m in (cur["min"], h["min"]) if m is not None]
                maxs = [m for m in (cur["max"], h["max"]) if m is not None]
                cur["min"] = min(mins) if mins else None
                cur["max"] = max(maxs) if maxs else None
                cur["recent"] = (cur["recent"] + list(h["recent"]))[-_RESERVOIR:]
                # same fixed ladder on every shard: elementwise sum
                hb = h.get("buckets") or [0] * _NB
                cb = cur.get("buckets") or [0] * _NB
                cur["buckets"] = [a + b for a, b in zip(cb, hb)]
        return out

    @staticmethod
    def hist_quantile(merged_hist: Dict, q: float) -> Optional[float]:
        """Quantile from a snapshot/merged hist dict (p50/p99 for
        summary rows and live-telemetry frames)."""
        b = merged_hist.get("buckets")
        if not b:
            return None
        return quantile_from_buckets(b, q, merged_hist.get("max"))

    @staticmethod
    def summary_rows(merged: Dict) -> List[Dict]:
        """Flatten a merged snapshot into table rows (benchmarks/run.py
        prints these as the metrics summary)."""
        rows = []
        for k in sorted(merged.get("counters", {})):
            rows.append({"metric": k, "type": "counter",
                         "value": merged["counters"][k]})
        for k in sorted(merged.get("gauges", {})):
            rows.append({"metric": k, "type": "gauge",
                         "value": round(merged["gauges"][k], 4)})
        for k in sorted(merged.get("hists", {})):
            h = merged["hists"][k]
            if not h["count"]:
                rows.append({"metric": k, "type": "hist", "value": "n=0"})
                continue
            mean = h["total"] / h["count"]
            val = f"n={h['count']} mean={mean:.4g} max={h['max']:.4g}"
            p50 = MetricsRegistry.hist_quantile(h, 0.5)
            p99 = MetricsRegistry.hist_quantile(h, 0.99)
            if p50 is not None:
                val += f" p50={p50:.4g} p99={p99:.4g}"
            rows.append({"metric": k, "type": "hist", "value": val})
        return rows


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide default shard (each OS process gets its own by
    construction; in-process logical hosts that need isolation hold
    their own ``MetricsRegistry`` instance instead)."""
    return _DEFAULT
