"""ElasticPhaserRuntime: membership epochs driven through the real phaser.

This is the unified control plane the paper's two-phase structural
protocol implies (DESIGN.md §3): join/leave requests enter the live
protocol actors as *eager level-0 splices* (the paper's fast path), the
next phase advance marks the **epoch boundary**, and at each boundary the
deterministic skip-list oracle re-derives the topology and swaps the
compiled collective schedule for the following epoch (the paper's *lazy*
hand-over-hand promotion, lifted to the data plane: re-derivation is
deferred to a phase boundary so no in-flight step ever observes a
half-swapped schedule).

Lifecycle of one epoch:

  epoch e: [phase k ........ phase k']      schedule_e  (compiled, static)
      |                          |
      |   request_join/leave --> eager splice on SCSL/SNSL actors
      |   (protocol runs to quiescence; phases keep completing)
      |                          |
      +--- advance() at k': membership changed since e started?
                               -> derive oracle over live keys
                               -> build schedule_{e+1}, fire on_epoch
                               -> epoch e+1 begins at phase k'+1

Everything the data plane consumes (the collective schedule, the live
set, the loss re-weighting mask) is versioned by the epoch index, so a
trainer/server re-lowers exactly once per boundary and is otherwise
static — the paper's O(log n) synchronization cost is preserved across
churn because the *protocol* absorbs the structural work, not the step.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..core.collective import (ALLREDUCE_KINDS, PhaserCollective,
                               scsl_reduce_schedule, snsl_broadcast_schedule)
from ..core.phaser import SCSL, SNSL, SIG_WAIT, DistPhaser
from ..core.runtime import FifoScheduler, Scheduler
from ..core.skiplist import HEAD, SkipList
from .strikes import StrikeAction, StrikeEscalation


@dataclass
class WorkerEvent:
    step: int
    # "join" | "leave" | "fail" | "straggle" | "demote" | "repromote"
    kind: str
    worker: int


@dataclass(frozen=True)
class Epoch:
    """One membership epoch: a maximal run of phases with a fixed live
    set, executing one compiled collective schedule."""

    index: int
    phase_start: int                 # first phase this epoch's schedule gates
    live: Tuple[int, ...]            # sorted live keys
    kind: str                        # schedule actually compiled (post-fallback)
    collective: Optional[PhaserCollective]   # None iff live is empty

    @property
    def n(self) -> int:
        return len(self.live)

    def stats(self) -> Dict[str, int]:
        if self.collective is None:
            return {"rounds": 0, "messages": 0}
        return self.collective.stats()


class ElasticPhaserRuntime:
    """Drives membership epochs through the protocol actors.

    ``kind`` is the per-epoch gradient-sync schedule. Every kind is valid
    for any team size (non-power-of-two teams get the elimination
    derivations in ``core/collective.py``), so an epoch's kind equals the
    preference — the historical fallback to ``phaser_scsl`` is gone.
    """

    def __init__(self, n_workers: int, *, seed: int = 0,
                 kind: str = "phaser_scsl",
                 scheduler: Optional[Callable[[], Scheduler]] = None,
                 axis_name: str = "data"):
        assert kind in ALLREDUCE_KINDS, kind
        self.seed = seed
        self.kind = kind
        self.axis_name = axis_name
        self._make_scheduler = scheduler or FifoScheduler
        self.ph = DistPhaser(n_workers, seed=seed)
        self.live: Set[int] = set(range(n_workers))
        self.next_worker_id = n_workers
        self.events: List[WorkerEvent] = []
        self._dirty = False              # membership changed since last boundary
        self._step = 0                   # caller-side step counter (for events)
        self.epochs: List[Epoch] = [self._derive_epoch(0, 0)]
        self._on_epoch: List[Callable[[Epoch, Epoch], None]] = []
        self._strikes: Dict[int, int] = {}
        # first observed step after a program (re)compile pays
        # compile+warmup: record_step_times exempts it from strikes.
        # Armed by bind_program_cache and at boundaries with re-lower
        # hooks; a control-only runtime never compiles, so never tags.
        self._compile_pending = False

    # ------------------------------------------------------------- epochs
    @property
    def epoch(self) -> Epoch:
        return self.epochs[-1]

    @property
    def epoch_index(self) -> int:
        return self.epoch.index

    @property
    def pending_churn(self) -> bool:
        """Membership changed since the current epoch was derived; the
        next ``advance()`` will land it as a new epoch."""
        return self._dirty

    def on_epoch(self, fn: Callable[[Epoch, Epoch], None]) -> None:
        """Register a boundary hook ``fn(old_epoch, new_epoch)`` — the
        data plane's re-lower trigger."""
        self._on_epoch.append(fn)

    def bind_program_cache(self, cache) -> None:
        """Attach an epoch-aware program cache (anything with
        ``.get(collective)``, e.g. ``collective_exec.ProgramCache``): the
        current epoch's program is compiled now, and every boundary
        compiles (or re-uses) the next epoch's program right at the phase
        advance — the data plane swaps executables instead of
        re-simulating the schedule on host. The cache's own extra key
        (overlap mode, bucket groups, microbatches) rides its entries,
        so overlapped programs swap at boundaries exactly like eager
        ones: the runtime only hands over the epoch's collective."""
        def hook(old: Epoch, new: Epoch) -> None:
            if new.collective is not None:
                cache.get(new.collective)
        self.on_epoch(hook)
        if self.epoch.collective is not None:
            cache.get(self.epoch.collective)
        self._compile_pending = True

    def _kind_for(self, n: int, kind: Optional[str] = None) -> str:
        """The schedule kind an epoch of ``n`` members compiles. Since
        the elimination derivations every kind covers every team
        size, so this is the preference itself; the hook is kept for
        callers that pass explicit overrides."""
        return kind if kind is not None else self.kind

    def _derive_epoch(self, index: int, phase_start: int) -> Epoch:
        keys = tuple(sorted(self.live))
        if not keys:
            return Epoch(index, phase_start, keys, self.kind, None)
        k = self._kind_for(len(keys))
        pc = PhaserCollective(len(keys), self.axis_name, kind=k,
                              seed=self.seed, keys=keys,
                              leaf_keys=tuple(sorted(self.ph.demoted
                                                     & self.live)))
        return Epoch(index, phase_start, keys, k, pc)

    # ------------------------------------------------------------- churn
    def request_join(self, parent: Optional[int] = None,
                     *, step: Optional[int] = None,
                     mode: str = SIG_WAIT) -> int:
        """Eager admission (paper Fig. 2): level-0 splice now, schedule
        swap at the next boundary. Returns the new worker id; it is a
        live signaler from this moment on."""
        wid = self.next_worker_id
        self.next_worker_id += 1
        if parent is None:
            parent = min(self.live) if self.live else HEAD
        self.ph.async_add(parent, wid, mode)
        self.ph.run(self._make_scheduler())     # splice + lazy promotion
        self.live.add(wid)
        self.events.append(WorkerEvent(self._at(step), "join", wid))
        self._dirty = True
        return wid

    def request_leave(self, worker: int, *, fail: bool = False,
                      step: Optional[int] = None) -> None:
        """Deletion (graceful) or failure: the phaser DEREG lowers the
        expectation so the in-flight phase completes without the worker;
        level-by-level unlink runs to quiescence."""
        assert worker in self.live, (worker, sorted(self.live))
        self.ph.drop(worker)
        self.ph.run(self._make_scheduler())
        self.live.discard(worker)
        self._strikes.pop(worker, None)
        self.events.append(WorkerEvent(self._at(step),
                                       "fail" if fail else "leave", worker))
        self._dirty = True

    def request_demote(self, worker: int, *,
                       step: Optional[int] = None) -> None:
        """Straggler demotion: the worker keeps signaling but is pinned
        to a leaf of the SCSL reduce tree (fewest dependents). Eager on
        the protocol (partial top-down unlink, run to quiescence); the
        schedule re-derives at the next boundary like any churn."""
        assert worker in self.live, (worker, sorted(self.live))
        if worker in self.ph.demoted:
            return
        self.ph.demote(worker)
        self.ph.run(self._make_scheduler())
        self.events.append(WorkerEvent(self._at(step), "demote", worker))
        self._dirty = True

    def request_repromote(self, worker: int, *,
                          step: Optional[int] = None) -> None:
        """Reverse a demotion once the worker keeps pace again."""
        if worker not in self.live or worker not in self.ph.demoted:
            return
        self.ph.repromote(worker)
        self.ph.run(self._make_scheduler())
        self.events.append(WorkerEvent(self._at(step), "repromote", worker))
        self._dirty = True

    @property
    def demoted(self) -> Set[int]:
        return set(self.ph.demoted)

    def _at(self, step: Optional[int]) -> int:
        return self._step if step is None else step

    # ----------------------------------------------------------- stepping
    def advance(self, *, step: Optional[int] = None) -> int:
        """One phase: every live signaler signals, the protocol runs to
        quiescence, and — if membership changed during the closing epoch —
        the boundary derives the next epoch's schedule. Returns the head's
        released phase."""
        for w in sorted(self.live):
            a = self.ph.actors[w]
            if a.sc.member and not a.sc.dropping:
                self.ph.signal(w)
        self.ph.run(self._make_scheduler())
        released = self.ph.released()
        if self._dirty:
            old = self.epoch
            new = self._derive_epoch(old.index + 1, released + 1)
            self.epochs.append(new)
            self._dirty = False
            if self._on_epoch:
                self._compile_pending = True   # boundary hooks re-lower
            for fn in self._on_epoch:
                fn(old, new)
        if step is not None:
            self._step = step
        self._step += 1
        return released

    # ----------------------------------------------------------- topology
    def collective(self) -> PhaserCollective:
        assert self.epoch.collective is not None, "empty team"
        return self.epoch.collective

    def epoch_key(self) -> Optional[Dict]:
        """JSON-serializable identity of the current epoch's collective
        — the (member_set, kind, seed, p) part of the program-cache key
        that checkpoints persist (the consumer appends its own overlap
        config). None for an empty team."""
        pc = self.epoch.collective
        if pc is None:
            return None
        return {"member_set": list(pc.keys), "kind": pc.kind,
                "seed": pc.seed, "p": pc.p, "axis": pc.axis_name,
                "leaf_keys": list(pc.leaf_keys)}

    def oracle(self) -> SkipList:
        """Deterministic skip list over the live keys (demoted keys at
        height 1) — what the protocol actors must have converged to at
        quiescence."""
        return SkipList.build(sorted(self.live), p=self.ph.p,
                              max_height=self.ph.max_height, seed=self.seed,
                              leaf_keys=self.ph.demoted)

    def protocol_topology(self, lid: int = SCSL) -> List[List[int]]:
        """Lane-by-lane chains extracted from the live protocol actors
        (lane 0 first). The ground truth the oracle is checked against."""
        lanes: List[List[int]] = []
        l = 0
        while True:
            st = self.ph.actors[HEAD].st(lid)
            cur = st.nxt[l] if l < len(st.nxt) else None
            lane = []
            while cur is not None:
                lane.append(cur)
                nst = self.ph.actors[cur].st(lid)
                cur = nst.nxt[l] if l < nst.height else None
            if not lane and l > 0:
                break
            lanes.append(lane)
            l += 1
        return lanes

    def verify_epoch(self) -> None:
        """Prove the current epoch against the protocol state:

        1. the actors' converged lanes == the deterministic oracle's lanes
           (both SCSL and SNSL), and
        2. the compiled schedule == the schedule re-derived from a fresh
           oracle over the live keys.

        Called at quiescence (after ``advance``); raises AssertionError on
        any divergence."""
        assert self.ph.net.idle(), "verify_epoch requires quiescence"
        sl = self.oracle()
        want = [lane for lane in sl.lanes() if lane] or [[]]
        for lid in (SCSL, SNSL):
            got = self.protocol_topology(lid)
            got = [lane for lane in got if lane] or [[]]
            assert got == want, \
                f"lid={lid}: protocol lanes {got} != oracle lanes {want}"
        ep = self.epoch
        assert ep.live == tuple(sorted(self.live))
        if ep.collective is not None:
            assert ep.collective.matches_oracle(), \
                f"epoch {ep.index}: schedule does not match oracle"
            if ep.kind == "phaser_scsl":
                up = scsl_reduce_schedule(sl, list(ep.live))
                down = snsl_broadcast_schedule(sl, list(ep.live))
                assert ep.collective.up == up
                assert ep.collective.down == down

    # --------------------------------------------------------- stragglers
    def record_step_times(self, step: int, times: Dict[int, float], *,
                          slack: float = 3.0,
                          demote_after: int = 2,
                          evict_after: int = 3) -> List[int]:
        """Straggler policy on the split-phase slack (the shared
        ``StrikeEscalation``, which the multi-process runtime applies to
        whole hosts): a worker slower than ``slack``x the live median
        accumulates a strike. The response escalates — at
        ``demote_after`` consecutive strikes the worker is **demoted**
        to a leaf of the SCSL reduce tree (fewest dependents: its
        slowness stops gating anyone else's combining subtree) while it
        keeps contributing; only at ``evict_after`` strikes is it
        evicted (the fail path). A worker that recovers (strike reset)
        is re-promoted to its drawn height. Returns workers evicted
        this step."""
        esc = StrikeEscalation(slack=slack, demote_after=demote_after,
                               evict_after=evict_after,
                               strikes=self._strikes)
        evicted: List[int] = []

        def apply(act: StrikeAction) -> None:
            if act.action == "straggle":
                self.events.append(WorkerEvent(step, "straggle",
                                               act.worker))
            elif act.action == "evict":
                self.request_leave(act.worker, fail=True, step=step)
                evicted.append(act.worker)
            elif act.action == "demote":
                self.request_demote(act.worker, step=step)
            elif act.action == "recover":
                self.request_repromote(act.worker, step=step)

        compile_step = self._compile_pending
        self._compile_pending = False
        esc.observe(self.live, times, demoted=self.ph.demoted,
                    on_action=apply, compile_step=compile_step)
        return evicted

    # --------------------------------------------------------- inspection
    def loss_scale(self) -> float:
        """Re-weighting when the live set shrank mid-epoch: live fraction
        of the peak team size seen so far."""
        return len(self.live) / max(self.next_worker_id, 1)

    def stats(self) -> Dict:
        return {
            "live": sorted(self.live),
            "phase": self.ph.released(),
            "epoch": self.epoch.index,
            "epochs": len(self.epochs),
            "kind": self.epoch.kind,
            "schedule": self.epoch.stats(),
            "messages": dict(self.ph.net.sent),
            "critical_path": self.ph.net.max_depth,
        }
