"""Explicit-state model checking of the distributed-phaser protocol.

Reproduces the paper's §4 methodology natively (SPIN is unavailable offline;
DESIGN.md §2): bounded explicit-state exploration over message-delivery
interleavings, with the paper's key idea — **message-based decomposition** of
the state space. A run designates a *focus* message class; deliveries of
non-focus messages are collapsed to one canonical order (they commute with
respect to the checked properties once their own class has been verified),
while deliveries of focus-class messages branch exhaustively. Running one
pass per message class (Table 1: TUS, TDS, MURS, MULS-1/2/3, AT, ENSP)
yields complete coverage of each handler's interleavings at a fraction of
the joint state space — the same engineering the paper used to get SPIN to
complete.

Checked properties (DESIGN.md §2):
  P1 structure   — level-0 chain is exactly the live membership, sorted;
                   every lane l links exactly the keys with height > l.
  P2 conservation— no signal lost or double-counted (head over-collection
                   asserts inline; final count checked at quiescence).
  P3 safety      — phase k is released only when every task registered for
                   k has signaled k (checked at the release instant).
  P4 liveness    — every maximal path quiesces (no deadlock) and reaches
                   the expected final phase.
  P5 promotion   — at quiescence every node reached its drawn height.
"""
from __future__ import annotations

import copy
import hashlib
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from . import messages as M
from .phaser import DistPhaser, PhaserActor, SIG_WAIT, SCSL, SNSL
from .runtime import Network
from .skiplist import HEAD

Scenario = Callable[[], Tuple[DistPhaser, dict]]


# ---------------------------------------------------------------------------
# State canonicalization
# ---------------------------------------------------------------------------
def _list_key(st) -> tuple:
    return (
        st.height, tuple(st.nxt), tuple(st.prv), st.member, st.joined,
        st.departed,
        tuple(sorted((c, tuple(tuple(iv) for iv in ivs))
                     for c, ivs in st.books.items())),
        tuple(tuple(iv) for iv in st.adv), st.closed,
        tuple(sorted(st.buf.items())),
        tuple(sorted((k, tuple(sorted(v))) for k, v in st.reported.items())),
        tuple(sorted(st.selfsig)), st.first_phase, st.dereg_phase,
        tuple(sorted(st.latch.items())),
        tuple(sorted((l, tuple(q)) for l, q in st.latch_q.items())),
        tuple(sorted((l, tuple(q)) for l, q in st.defer_q.items())),
        tuple(sorted((l, tuple(repr(u) for u in q))
                     for l, q in st.unl_park.items())),
        tuple(repr(x) for x in st.join_defer),
        st.released, st.dropping, st.unlink_level, st.unlink_waiting,
        st.unl_sent_succ, st.unl0_sent, tuple(st.splice_defer),
        st.final_childdel_sent,
        st.target_height, st.rp_pending, st.rp_queue,
    )


def _actor_key(a: PhaserActor) -> tuple:
    return (a.rank, a.mode, a.sig_next, a.wait_next, a.presig,
            a.pending_drop, _list_key(a.sc), _list_key(a.sn),
            a.expected_base, tuple(sorted(a.deltas.items())),
            a.head_released)


def state_digest(ph: DistPhaser) -> bytes:
    chans = tuple(sorted(
        (c, tuple(repr(e.msg) for e in q))
        for c, q in ph.net.channels.items() if q))
    actors = tuple(_actor_key(a) for _, a in sorted(ph.actors.items()))
    blob = repr((chans, actors, tuple(ph.release_log))).encode()
    return hashlib.blake2b(blob, digest_size=16).digest()


# ---------------------------------------------------------------------------
# Safety monitors
# ---------------------------------------------------------------------------
class PropertyViolation(AssertionError):
    pass


def release_monitor(ph: DistPhaser, k: int) -> None:
    """P3: at the instant the head releases phase k, every task registered
    for k (eager insert complete, first_phase <= k < dereg bound) must have
    signaled k."""
    for r, a in ph.actors.items():
        if r == HEAD or not a.sc.member or not a.sc.joined:
            continue
        st = a.sc
        active = (st.first_phase <= k
                  and (st.dereg_phase is None or k < st.dereg_phase))
        if active and k not in st.selfsig:
            raise PropertyViolation(
                f"P3: phase {k} released but task {r} "
                f"(first={st.first_phase}, dereg={st.dereg_phase}) "
                f"has not signaled it")


def check_transient(ph: DistPhaser) -> None:
    """Invariants that must hold in *every* reachable state."""
    head_rel = ph.actors[HEAD].head_released
    for r, a in ph.actors.items():
        if r == HEAD:
            continue
        if a.sn.member and a.sn.released > head_rel:
            raise PropertyViolation(
                f"P3(w): waiter {r} released {a.sn.released} > head "
                f"{head_rel}")


def check_quiescent(ph: DistPhaser, expect: dict) -> None:
    """Invariants at idle states: structure (P1), liveness targets (P4),
    promotion completion (P5)."""
    ph.check_quiescent_invariants()  # P1 across both lists
    if "final_phase" in expect:
        got = ph.actors[HEAD].head_released
        if got != expect["final_phase"]:
            raise PropertyViolation(
                f"P4: quiesced at released={got}, expected "
                f"{expect['final_phase']}")
    for r, a in ph.actors.items():
        if r == HEAD:
            continue
        for st in (a.sc, a.sn):
            if st.member and st.joined and not st.departed \
                    and not st.dropping:
                if st.height != st.target_height:
                    raise PropertyViolation(
                        f"P5: {r} lid={st.lid} height {st.height} != "
                        f"target {st.target_height}")
    # P2 at quiescence (conservation): no negative buffers anywhere; the
    # head must hold no residual counts for phases it already released (a
    # residual means a signal was double-counted or a registration delta
    # was lost); no node may hold a stuck count for a phase it closed.
    head = ph.actors[HEAD]
    for k, cnt in head.sc.buf.items():
        if cnt > 0 and k <= head.head_released:
            raise PropertyViolation(
                f"P2: head holds {cnt} residual count(s) for released "
                f"phase {k} (lost registration delta or double count)")
    for r, a in ph.actors.items():
        for st in (a.sc, a.sn):
            for ph_k, cnt in st.buf.items():
                if cnt < 0:
                    raise PropertyViolation(f"P2: negative buffer at {r}")
                if r != HEAD and st.lid == SCSL and cnt > 0 \
                        and ph_k <= st.closed:
                    raise PropertyViolation(
                        f"P2: {r} holds stuck count for closed phase {ph_k}")


# ---------------------------------------------------------------------------
# The checker
# ---------------------------------------------------------------------------
@dataclass
class CheckStats:
    focus: str
    states: int = 0
    transitions: int = 0
    quiescent: int = 0
    truncated: bool = False
    violations: List[str] = field(default_factory=list)


def _focus_channels(net: Network, focus: frozenset) -> List[tuple]:
    return [c for c in net.nonempty_channels()
            if net.channels[c][0].msg.kind in focus]


def _nonfocus_channels(net: Network, focus: frozenset) -> List[tuple]:
    return [c for c in net.nonempty_channels()
            if net.channels[c][0].msg.kind not in focus]


def _drain_nonfocus(ph: DistPhaser, focus: frozenset) -> None:
    """Deliver non-focus channel heads in canonical (sorted) order until
    every channel head is focus-class. Monitors run on the way."""
    while True:
        nf = _nonfocus_channels(ph.net, focus)
        if not nf:
            return
        ph.net.deliver_from(nf[0])
        check_transient(ph)


def check(scenario: Scenario, focus_kinds: Sequence[str], *,
          max_states: int = 200_000) -> CheckStats:
    """Exhaustively explore interleavings of ``focus_kinds`` deliveries (all
    other messages delivered in canonical order between branch points)."""
    focus = frozenset(focus_kinds)
    stats = CheckStats(focus="+".join(sorted(focus_kinds)))
    root, expect = scenario()
    root.release_monitor = release_monitor
    stack = [root]
    visited = set()
    while stack:
        ph = stack.pop()
        try:
            _drain_nonfocus(ph, focus)
        except PropertyViolation as e:
            stats.violations.append(str(e))
            continue
        d = state_digest(ph)
        if d in visited:
            continue
        visited.add(d)
        stats.states += 1
        if stats.states >= max_states:
            stats.truncated = True
            break
        chans = _focus_channels(ph.net, focus)
        if not chans:
            assert ph.net.idle()
            stats.quiescent += 1
            try:
                check_quiescent(ph, expect)
            except PropertyViolation as e:
                stats.violations.append(str(e))
            continue
        for c in chans:
            child = copy.deepcopy(ph)
            try:
                child.net.deliver_from(c)
                check_transient(child)
            except PropertyViolation as e:
                stats.violations.append(str(e))
                continue
            stats.transitions += 1
            stack.append(child)
    return stats


def check_decomposed(scenario: Scenario, *, classes: Optional[Sequence[
        Sequence[str]]] = None, max_states: int = 200_000) -> List[CheckStats]:
    """The paper's Table-1 run: one exploration per message class."""
    if classes is None:
        classes = [("TUS",), ("TDS",), ("MURS", "MURS_ACK"),
                   ("MULS1",), ("MULS2",), ("MULS3",),
                   ("AT",), ("ENSP",), ("SIG",), ("ADV",),
                   ("PRV", "CHILD_ADD", "CHILD_ADD_ACK", "CHILD_DEL"),
                   ("UNL", "UNL_ACK", "DEREG")]
    return [check(scenario, cls, max_states=max_states) for cls in classes]


def check_full(scenario: Scenario, *, max_states: int = 200_000) -> CheckStats:
    """Straightforward joint exploration (what made SPIN run out of memory
    in the paper) — used by benchmarks to demonstrate the blowup."""
    return check(scenario, list(M.ALL_KINDS), max_states=max_states)


# ---------------------------------------------------------------------------
# Scenarios (paper Fig. 2 and friends)
# ---------------------------------------------------------------------------
def scenario_eager_insert(n: int = 3, new_id: int = 10, parent: int = 0,
                          signals: int = 1, seed: int = 0) -> Scenario:
    """Paper Fig. 2: a team of n, task ``parent`` asyncs ``new_id`` in while
    every member signals ``signals`` phases concurrently."""

    def make():
        ph = DistPhaser(n, seed=seed)
        ph.async_add(parent, new_id)
        for k in range(signals):
            for r in range(n):
                ph.signal(r)
        # the new task signals as soon as it can (pre-join buffering)
        for k in range(signals):
            ph.signal(new_id)
        return ph, {"final_phase": signals - 1}

    return make


def scenario_delete(n: int = 4, victim: int = 2, signals: int = 1,
                    seed: int = 0) -> Scenario:
    """Concurrent deletion + signaling."""

    def make():
        ph = DistPhaser(n, seed=seed)
        for r in range(n):
            if r != victim:
                ph.signal(r)
        ph.drop(victim)
        return ph, {"final_phase": signals - 1 if signals else -1}

    return make


def scenario_insert_delete(n: int = 3, seed: int = 0) -> Scenario:
    """Simultaneous add + drop + signal traffic."""

    def make():
        ph = DistPhaser(n, seed=seed)
        ph.async_add(0, 10)
        ph.drop(n - 1)
        for r in range(n - 1):
            ph.signal(r)
        ph.signal(10)
        return ph, {"final_phase": 0}

    return make


def scenario_double_insert(n: int = 3, seed: int = 0) -> Scenario:
    """Two concurrent insertions (C=2 lazy-promotion group)."""

    def make():
        ph = DistPhaser(n, seed=seed)
        ph.async_add(0, 10)
        ph.async_add(1, 11)
        for r in range(n):
            ph.signal(r)
        ph.signal(10)
        ph.signal(11)
        return ph, {"final_phase": 0}

    return make
