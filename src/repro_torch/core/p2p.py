"""Point-to-point phaser modes: producer-consumer and pipeline graphs.

The paper's defining claim is that ONE primitive unifies collective and
point-to-point coordination through *registration modes*: a task
registered SIG is a pure producer (it signals phases, never blocks), a
task registered WAIT is a pure consumer (it observes phase advances,
never gates them), and SIG_WAIT is both. ``core/phaser.py`` already
carries the modes through the protocol — a SIG-only task joins the SCSL
but not the SNSL, a WAIT-only task the reverse — but nothing in the repo
exercised the point-to-point half. This module is that half:

* ``P2PPhaser`` — one phaser with explicit per-participant modes and the
  paper's **signal-accumulation** semantics: a producer may run
  arbitrarily far ahead (each ``signal`` contributes to the next unsignaled
  phase; the head releases phase k once every registered signaler has
  accumulated k+1 signals), and a consumer's ``wait(phase)`` is satisfied
  exactly when the SNSL has diffused the release of ``phase`` to it.
  This is the phaser generalization of semaphores/producer-consumer: the
  signal count is the semaphore value, phases are its history.

* ``PipelinePhaserGraph`` — a directed stage graph with one P2P phaser
  per edge: edge (u, v) registers u as SIG and v as WAIT, so interior
  pipeline stages are SIG toward their successor and WAIT on their
  predecessor (SIG_WAIT across their two edge phasers — exactly the
  dependency structure of pipeline parallelism). ``run_program`` drives
  an instruction stream (signal/wait ops) through the REAL protocol
  actors and records the global release order; ``simulate_program`` is
  the host counter oracle it must match (the p2p analogue of
  ``simulate_schedule`` for collective rounds).

The deterministic skip-list oracle extends to modes structurally: the
SCSL is the oracle over the *signaler* key set, the SNSL over the
*waiter* key set (``P2PPhaser.verify_topology``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from .phaser import SCSL, SNSL, SIG_MODE, SIG_WAIT, WAIT_MODE, DistPhaser
from .runtime import FifoScheduler, Scheduler
from .skiplist import HEAD, SkipList

MODES = (SIG_MODE, WAIT_MODE, SIG_WAIT)


class P2PPhaser:
    """One phaser with explicit per-participant registration modes.

    ``modes`` maps rank -> SIG | WAIT | SIG_WAIT for ranks 0..n-1.
    Signals accumulate: ``signal(rank, times)`` contributes ``times``
    consecutive phases without ever blocking (the protocol buffers the
    run-ahead; phase k is released only when every signaler reached it).
    ``wait(rank, phase)`` is the non-blocking completion test after the
    protocol ran to quiescence — the data plane's "may I consume item
    ``phase``" check.
    """

    def __init__(self, modes: Dict[int, str], *, seed: int = 0,
                 name: str = "p2p",
                 scheduler: Optional[Callable[[], Scheduler]] = None):
        assert modes, "empty phaser"
        assert all(m in MODES for m in modes.values()), modes
        assert sorted(modes) == list(range(len(modes))), \
            f"ranks must be 0..n-1, got {sorted(modes)}"
        self.name = name
        self.modes = dict(modes)
        self._make_scheduler = scheduler or FifoScheduler
        self.ph = DistPhaser(len(modes), modes=self.modes, seed=seed)
        self.signaled: Dict[int, int] = {r: 0 for r in modes}

    # ------------------------------------------------------------ mode sets
    def signalers(self) -> List[int]:
        return [r for r, m in self.modes.items()
                if m in (SIG_MODE, SIG_WAIT)]

    def waiters(self) -> List[int]:
        return [r for r, m in self.modes.items()
                if m in (WAIT_MODE, SIG_WAIT)]

    # ------------------------------------------------------------- task API
    def signal(self, rank: int, times: int = 1) -> None:
        """Producer side: accumulate ``times`` signals (run-ahead is
        unbounded — the paper's asynchronous signal)."""
        assert self.modes[rank] in (SIG_MODE, SIG_WAIT), \
            f"rank {rank} is {self.modes[rank]}: cannot signal"
        for _ in range(times):
            self.ph.signal(rank)
        self.signaled[rank] += times
        self.run()

    def wait(self, rank: int, phase: int) -> bool:
        """Consumer side: has ``phase`` been released to ``rank``?"""
        assert self.modes[rank] in (WAIT_MODE, SIG_WAIT), \
            f"rank {rank} is {self.modes[rank]}: cannot wait"
        self.run()
        return self.released(rank) >= phase

    def pending(self, rank: int) -> int:
        """Signals a producer has issued beyond the released phase — the
        accumulated run-ahead (the semaphore value)."""
        return self.signaled[rank] - (self.ph.released() + 1)

    # --------------------------------------------------------- watermarks
    def enable_watermarks(self, pid: int = 0):
        """Install a live phase-watermark tracker (obs plane): the
        underlying actors report per-rank (signal, wait) phases and the
        signal->release gap through the facade hooks; modes are seeded
        so the tracker's view matches the registration table."""
        from ..obs.live import WatermarkTracker
        wm = WatermarkTracker(pid)
        for r, m in self.modes.items():
            wm.set_mode(r, m)
        self.ph.watermarks = wm
        return wm

    @property
    def watermarks(self):
        return self.ph.watermarks

    def released(self, rank: Optional[int] = None) -> int:
        return self.ph.released(rank)

    def add_participant(self, parent: int, rank: int, mode: str) -> None:
        """Dynamic registration with an explicit mode (paper Fig. 2)."""
        self.ph.async_add(parent, rank, mode)
        self.modes[rank] = mode
        self.signaled[rank] = 0
        if self.ph.watermarks is not None:
            self.ph.watermarks.set_mode(rank, mode)
        self.run()

    def demote(self, rank: int) -> None:
        """Straggler demotion on a p2p phaser: pin ``rank`` to a leaf
        (height 1) in whichever lists its mode materializes it — it
        keeps signaling/waiting, but loses every skip-list dependent.
        The mode-filtered oracle (``verify_topology``) follows because
        it builds with ``leaf_keys = demoted``."""
        self.run()
        self.ph.demote(rank)
        self.run()

    def repromote(self, rank: int) -> None:
        """Undo a demotion: restore the deterministic drawn height."""
        self.run()
        self.ph.repromote(rank)
        self.run()

    def run(self) -> int:
        return self.ph.run(self._make_scheduler())

    # ---------------------------------------------------------- topology
    def _lanes(self, lid: int) -> List[List[int]]:
        lanes, l = [], 0
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
        return [lane for lane in lanes if lane] or [[]]

    def verify_topology(self) -> None:
        """Mode-filtered oracle check: the SCSL must be the deterministic
        skip list over the *signaler* keys, the SNSL over the *waiter*
        keys — the modes select which list a key materializes in, the
        heights stay a function of the key alone."""
        assert self.ph.net.idle(), "verify requires quiescence"
        for lid, keys in ((SCSL, self.signalers()), (SNSL, self.waiters())):
            sl = SkipList.build(keys, p=self.ph.p,
                                max_height=self.ph.max_height,
                                seed=self.ph.seed,
                                leaf_keys=self.ph.demoted)
            want = [sl.level_chain(l)
                    for l in range(max((sl.nodes[k].height
                                        for k in sl.keys()), default=1))]
            want = [lane for lane in want if lane] or [[]]
            got = self._lanes(lid)
            assert got == want, \
                f"{self.name} lid={lid}: lanes {got} != oracle {want}"


# ---------------------------------------------------------------------------
# Stage graphs: one P2P phaser per dependency edge
# ---------------------------------------------------------------------------
# an instruction: ("signal", (u, v)) or ("wait", (u, v), phase)
Op = Tuple
Edge = Tuple[int, int]


@dataclass(frozen=True)
class ReleaseEvent:
    edge: Edge
    phase: int


class PipelinePhaserGraph:
    """A directed stage graph as a family of point-to-point phasers.

    One phaser per edge (u, v): u registered SIG, v registered WAIT.
    A node with out-edges and in-edges is therefore SIG_WAIT *across the
    graph* — the paper's claim that phaser modes subsume producer-consumer
    and pipeline dependency structures, realized on the live actors.
    """

    def __init__(self, n_nodes: int, edges: Sequence[Edge], *,
                 seed: int = 0,
                 scheduler: Optional[Callable[[], Scheduler]] = None):
        self.n_nodes = n_nodes
        self.edges = tuple(edges)
        assert len(set(self.edges)) == len(self.edges), "duplicate edge"
        self.release_log: List[ReleaseEvent] = []
        self.phasers: Dict[Edge, P2PPhaser] = {}
        for (u, v) in self.edges:
            assert 0 <= u < n_nodes and 0 <= v < n_nodes and u != v
            p = P2PPhaser({0: SIG_MODE, 1: WAIT_MODE}, seed=seed,
                          name=f"edge{u}->{v}", scheduler=scheduler)
            # the release instant, observed from inside the head actor:
            # the global interleaving of per-edge phase releases
            p.ph.release_monitor = (
                lambda ph, k, e=(u, v):
                self.release_log.append(ReleaseEvent(e, k)))
            self.phasers[(u, v)] = p

    # ------------------------------------------------------------- node view
    def mode_of(self, node: int) -> str:
        """The node's aggregated registration across the graph."""
        sig = any(u == node for u, _ in self.edges)
        wai = any(v == node for _, v in self.edges)
        if sig and wai:
            return SIG_WAIT
        return SIG_MODE if sig else WAIT_MODE

    # ------------------------------------------------------------ execution
    def signal(self, edge: Edge) -> None:
        self.phasers[edge].signal(0)

    def wait(self, edge: Edge, phase: int) -> bool:
        return self.phasers[edge].wait(1, phase)

    def demote(self, edge: Edge, rank: int) -> None:
        """Mid-program straggler demotion of one edge phaser's
        participant (0 = the SIG producer, 1 = the WAIT consumer):
        release semantics are unchanged — only the skip-list topology
        degrades to the leaf-pinned oracle."""
        self.phasers[tuple(edge)].demote(rank)

    def repromote(self, edge: Edge, rank: int) -> None:
        self.phasers[tuple(edge)].repromote(rank)

    def run_program(self, program: Iterable[Op]) -> List[ReleaseEvent]:
        """Drive an instruction stream through the real protocol actors.
        Every ``wait`` must already be satisfied when reached (the
        program claims to be a valid linearization of the dependency
        graph); raises AssertionError otherwise. Returns the observed
        global release order."""
        self.release_log.clear()
        for op in program:
            if op[0] == "signal":
                self.signal(op[1])
            else:
                _, edge, phase = op
                assert self.wait(edge, phase), \
                    f"wait{edge} phase {phase} not satisfied " \
                    f"(released={self.phasers[edge].released(1)})"
        return list(self.release_log)

    def verify_topologies(self) -> None:
        for p in self.phasers.values():
            p.verify_topology()

    def stats(self) -> Dict[str, int]:
        return {"edges": len(self.edges),
                "messages": sum(p.ph.net.total_sent()
                                for p in self.phasers.values()),
                "releases": len(self.release_log)}


def simulate_program(edges: Sequence[Edge],
                     program: Iterable[Op]) -> List[ReleaseEvent]:
    """Host counter oracle for a p2p instruction stream — the exact
    mirror of ``PipelinePhaserGraph.run_program`` (the p2p analogue of
    ``simulate_schedule``): per edge, the accumulated signal count IS the
    released phase + 1; a ``wait(edge, k)`` is satisfied iff the count
    exceeds ``k``. Returns the release order; raises on an unsatisfied
    wait (an invalid linearization)."""
    count = {tuple(e): 0 for e in edges}
    log: List[ReleaseEvent] = []
    for op in program:
        if op[0] == "signal":
            e = tuple(op[1])
            log.append(ReleaseEvent(e, count[e]))
            count[e] += 1
        else:
            _, edge, phase = op
            assert count[tuple(edge)] > phase, \
                f"oracle: wait{tuple(edge)} phase {phase} unsatisfied " \
                f"(count={count[tuple(edge)]})"
    return log
