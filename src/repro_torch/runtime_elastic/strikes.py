"""Escalating straggler policy, shared across membership granularities.

The split-phase slack argument (paper §5) says a slow participant only
hurts once its subtree gates someone else's combining path, so the
response escalates instead of evicting on first offense:

  strike 1                -> "straggle"  (recorded, no structural op)
  strike ``demote_after`` -> "demote"    (pin to a leaf of the SCSL
                                          reduce tree: fewest dependents)
  strike ``evict_after``  -> "evict"     (the deletion/fail path)
  recovery                -> "recover"   (re-promote to drawn height)

``ElasticPhaserRuntime.record_step_times`` applies it to single-host
workers; the multi-process coordinator (``runtime_dist``) applies the
same policy to whole hosts — eviction of a process is the paper's
deletion at host granularity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional


@dataclass(frozen=True)
class StrikeAction:
    worker: int
    action: str  # "straggle" | "demote" | "evict" | "recover"


class StrikeEscalation:
    """Strike bookkeeping + escalation decisions.

    ``observe`` walks the live set against the step times and invokes
    ``on_action`` *inline* as each decision is made — an eviction may
    shrink ``live`` before the next participant is considered, exactly
    like the historical in-loop behavior. Strike counts persist across
    calls on the instance (``strikes`` may be handed a shared dict)."""

    def __init__(self, *, slack: float = 3.0, demote_after: int = 2,
                 evict_after: int = 3,
                 strikes: Optional[Dict[int, int]] = None,
                 metrics=None):
        self.slack = slack
        self.demote_after = demote_after
        self.evict_after = evict_after
        self.strikes: Dict[int, int] = strikes if strikes is not None else {}
        if metrics is None:
            from ..obs.metrics import default_registry
            metrics = default_registry()
        self.metrics = metrics

    def forget(self, worker: int) -> None:
        self.strikes.pop(worker, None)

    def observe(self, live, times: Dict[int, float], *,
                demoted: Iterable[int] = (),
                on_action: Optional[Callable[[StrikeAction], None]] = None,
                compile_step: bool = False,
                waits: Optional[Dict[int, float]] = None
                ) -> List[StrikeAction]:
        """One step's observation. ``live`` and ``demoted`` are read
        live (the callback may mutate them); returns every action
        emitted, in order. A ``compile_step`` (the first step after a
        boundary re-lower) is recorded in the metrics but exempt from
        strike accounting: compile/warmup skew is not straggling.

        ``waits`` (optional) is the watermark layer's per-participant
        blocked-on-WAIT seconds for the step window: time spent waiting
        on *peers* is subtracted before the slack test, so a host that
        is slow because someone else gated it is a victim, not a
        culprit — attribution, not just magnitude."""
        wait_of = (lambda w: 0.0) if waits is None else \
            (lambda w: max(0.0, waits.get(w, 0.0)))

        def eff(w: int, t: float) -> float:
            return max(0.0, t - min(wait_of(w), t))

        live_times = [eff(w, times[w]) for w in live if w in times]
        if not live_times:
            return []
        med = sorted(live_times)[len(live_times) // 2]
        for t in live_times:
            self.metrics.observe("strikes.step_seconds", t)
        self.metrics.set("strikes.step_median_s", med)
        if compile_step:
            self.metrics.inc("strikes.compile_steps")
            return []
        out: List[StrikeAction] = []

        def emit(worker: int, action: str) -> None:
            act = StrikeAction(worker, action)
            out.append(act)
            self.metrics.inc(f"strikes.{action}")
            if on_action is not None:
                on_action(act)

        for w in sorted(live):
            t = times.get(w)
            if t is not None:
                t = eff(w, t)
            if t is not None and t > self.slack * med:
                self.strikes[w] = self.strikes.get(w, 0) + 1
                emit(w, "straggle")
                if self.strikes[w] >= self.evict_after and len(live) > 1:
                    emit(w, "evict")
                elif self.strikes[w] >= self.demote_after:
                    emit(w, "demote")
            else:
                if self.strikes.get(w, 0) and w in demoted:
                    emit(w, "recover")
                self.strikes[w] = 0
        return out
