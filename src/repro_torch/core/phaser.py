"""Distributed-phaser protocol actors.

Faithful control-plane reproduction of the paper's design (DESIGN.md §1-2):

* one actor per participant, plus a sentinel HEAD actor (-1) that plays the
  designated head-signaler (SCSL root) and head-waiter (SNSL root);
* signals flow child -> parent along *signal edges* (each node's predecessor
  at its own top lane), aggregated hierarchically; phase-advance ADVs diffuse
  down the SNSL along the reverse edges;
* dynamic addition = eager level-0 splice (TUS/TDS search + MURS fast
  single-link-modify) followed by lazy hand-over-hand MULS promotions;
* dynamic deletion = level-by-level top-down unlink (UNL);
* registration accounting (ENSP/DEREG deltas) rides the same FIFO channels
  as the signals, which makes head bookkeeping race-free.

Correctness architecture: the substrate is *eager pass-through routing* —
any count a node cannot account for is forwarded toward the head, and the
head's completion test is count-based (collected == expected). Hierarchical
combining (per-node books of children intervals) is an optimization layered
on top; its bookkeeping can lag behind structural churn without ever losing
or double-counting a signal. The model checker (core/modelcheck.py) verifies
the interaction of both layers under all interleavings for small configs.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import messages as M
from .runtime import Actor, Network, Scheduler, FifoScheduler
from .skiplist import HEAD, SkipList, det_height

SIG_MODE = "SIG"
WAIT_MODE = "WAIT"
SIG_WAIT = "SIG_WAIT"

SCSL, SNSL = 0, 1


@dataclass
class ListState:
    """Per-(node, list) protocol state: local links + combining books."""

    lid: int
    key: int
    height: int = 1
    target_height: int = 1
    nxt: List[Optional[int]] = field(default_factory=lambda: [None])
    prv: List[Optional[int]] = field(default_factory=lambda: [None])
    member: bool = False          # participates in this list at all
    joined: bool = False          # eager insert completed (links valid)
    departed: bool = False        # drop() finished
    # --- combining books (SCSL) / forwarding set (SNSL) ---
    # child -> list of [from_phase, to_phase|None) intervals
    books: Dict[int, List[List[Optional[int]]]] = field(default_factory=dict)
    # advertised intervals: [lo, hi|None, parent] — the exact mirror of the
    # interval this node has opened (CHILD_ADD / splice) and closed
    # (CHILD_DEL) in each parent's books. The single source of truth for
    # "who expects my closing report for phase k" — keeping it mirrored by
    # construction is what makes head accounting race-free.
    adv: List[List[Optional[int]]] = field(default_factory=list)
    closed: int = -1              # highest phase whose aggregate we sent
    buf: Dict[int, int] = field(default_factory=dict)
    reported: Dict[int, set] = field(default_factory=dict)
    selfsig: set = field(default_factory=set)
    first_phase: int = 0
    dereg_phase: Optional[int] = None   # signaler-active for first<=k<dereg
    # --- hand-over-hand latches for MULS splices (level -> new_id) ---
    latch: Dict[int, int] = field(default_factory=dict)
    latch_q: Dict[int, List[int]] = field(default_factory=dict)
    # walkers deferred at a dropping node until its level unlinks
    # (abort-retry against a leaving lane member would livelock)
    defer_q: Dict[int, List[int]] = field(default_factory=dict)
    # UNLs parked behind an open MULS latch at the same level
    unl_park: Dict[int, List] = field(default_factory=dict)
    # structural traffic deferred until our own eager insert completes
    # (serving a search/splice before MURS_ACK initializes our links
    # would be clobbered by the ack)
    join_defer: List = field(default_factory=list)
    # --- SCSL re-parent handshake (chain invariant, DESIGN.md §10) ---
    rp_pending: Optional[int] = None     # CHILD_ADD sent, awaiting ACK
    rp_queue: Optional[Tuple[int, int]] = None  # (next_parent, effective)
    # --- SNSL ---
    released: int = -1
    # --- deletion state machine ---
    dropping: bool = False
    # demotion: unlink stops when the level falls below this (1 = keep
    # level 0 — the node stays a member, pinned to a leaf position);
    # 0 = full departure (the plain drop path)
    demote_stop: int = 0
    unlink_level: Optional[int] = None
    unlink_waiting: bool = False      # paused on an open MULS latch
    unl_sent_succ: Optional[int] = None   # succ snapshot in the last UNL
    unl0_sent: bool = False           # level-0 UNL in flight
    splice_defer: List[int] = field(default_factory=list)
    final_childdel_sent: bool = False

    @property
    def top(self) -> int:
        return self.height - 1

    def covers(self, child: int, k: int) -> bool:
        for lo, hi in self.books.get(child, ()):  # type: ignore[misc]
            if lo <= k and (hi is None or k < hi):
                return True
        return False

    def active_children(self, k: int) -> List[int]:
        return [c for c in self.books if self.covers(c, k)]

    def any_coverage(self, k: int) -> bool:
        return any(self.covers(c, k) for c in self.books)

    def max_to(self) -> int:
        """Highest to_phase over closed child intervals (0 if none)."""
        m = 0
        for iv in self.books.values():
            for lo, hi in iv:
                if hi is not None:
                    m = max(m, hi)
        return m

    def all_children_closed(self) -> bool:
        return all(hi is not None for iv in self.books.values()
                   for lo, hi in iv)

    # -- advertised upstream intervals ------------------------------------
    def route_for(self, k: int) -> Optional[int]:
        """Parent whose books cover phase k; else the interval with the
        largest lo <= k; else the earliest parent (pass-through routing can
        always make progress toward the head)."""
        best = None
        for lo, hi, par in self.adv:
            if lo <= k and (hi is None or k < hi):
                return par
            if lo <= k and (best is None or lo >= best[0]):
                best = (lo, par)
        if best is not None:
            return best[1]
        if self.adv:
            return self.adv[0][2]
        return None

    def adv_covers(self, k: int) -> bool:
        return any(lo <= k and (hi is None or k < hi)
                   for lo, hi, _ in self.adv)

    def adv_open_iv(self) -> Optional[List[Optional[int]]]:
        for iv in self.adv:
            if iv[1] is None:
                return iv
        return None

    def adv_open(self, lo: int, parent: int) -> None:
        assert self.adv_open_iv() is None, "double-open advertised interval"
        self.adv.append([lo, None, parent])
        self.adv.sort(key=lambda iv: iv[0])

    def adv_close(self, hi: int) -> int:
        """Close the open interval at max(lo, hi); returns the actual end
        (the from_phase to use in the CHILD_DEL — mirrors book_del)."""
        iv = self.adv_open_iv()
        assert iv is not None, "no open advertised interval"
        end = max(iv[0], hi)
        iv[1] = end
        return end

    def book_add(self, child: int, from_phase: int) -> None:
        self.books.setdefault(child, []).append([from_phase, None])

    def book_del(self, child: int, from_phase: int) -> None:
        ivs = self.books.setdefault(child, [])
        for iv in reversed(ivs):
            if iv[1] is None:
                iv[1] = max(iv[0], from_phase)
                return
        # DEL for an interval we never opened (books lag): record empty
        ivs.append([from_phase, from_phase])

    def signaler_active(self, k: int) -> bool:
        if self.lid != SCSL or not self.member:
            return False
        if k < self.first_phase:
            return False
        return self.dereg_phase is None or k < self.dereg_phase


class PhaserActor(Actor):
    """One per participant task; also the base for the HEAD sentinel."""

    def __init__(self, rank: int, net: Network, mode: str, *,
                 phaser: "DistPhaser"):
        super().__init__(rank, net)
        self.mode = mode
        self.ph = phaser
        self.sc = ListState(SCSL, rank)
        self.sn = ListState(SNSL, rank)
        self.sc.member = mode in (SIG_MODE, SIG_WAIT) or rank == HEAD
        self.sn.member = mode in (WAIT_MODE, SIG_WAIT) or rank == HEAD
        self.sig_next = 0           # next phase this task will signal
        self.wait_next = 0          # next phase this task will wait on
        self.presig = 0             # signals sent before eager insert done
        self.pending_drop = False   # drop() called before eager insert done
        self.async_children_attached: set = set()
        # HEAD-only accounting
        self.expected_base = 0
        self.deltas: Dict[int, int] = {}
        self.head_released = -1

    # ------------------------------------------------------------------ util
    def st(self, lid: int) -> ListState:
        return self.sc if lid == SCSL else self.sn

    @property
    def is_head(self) -> bool:
        return self.rank == HEAD

    def _send(self, dst: int, msg: M.Msg) -> None:
        self.send(dst, msg)

    # ------------------------------------------------------------- public API
    def local_signal(self) -> None:
        """Task-level signal(): contribute +1 for phase ``sig_next``."""
        assert self.sc.member and not self.sc.departed
        if not self.sc.joined:
            # Eager insert still in flight: the first phase this task is
            # registered for is unknown until MURS_ACK. Buffer locally;
            # applied in order starting at first_phase on join.
            self.presig += 1
            return
        k = self.sig_next
        self.sig_next += 1
        self.sc.selfsig.add(k)
        self.sc.buf[k] = self.sc.buf.get(k, 0) + 1
        # phase-watermark hook (obs plane): facades that track live
        # watermarks implement it; plain facades don't pay for it
        cb = getattr(self.ph, "on_local_signal", None)
        if cb is not None:
            cb(self.rank, k)
        self._try_close_sc()

    def local_drop(self) -> None:
        """Deregister from the phaser; level-by-level unlink (paper §2)."""
        if (self.sc.member and not self.sc.joined) or \
                (self.sn.member and not self.sn.joined):
            self.pending_drop = True  # executed once eager insert completes
            return
        if self.sc.demote_stop or self.sn.demote_stop:
            # a demotion unlink is in flight: its unlink state (dropping,
            # unlink_level) is busy — run the drop when it completes
            self.pending_drop = True
            return
        if self.sc.member and not self.sc.dropping:
            self.sc.dropping = True
            self.sc.dereg_phase = self.sig_next
            par = self.sc.route_for(self.sig_next)
            if par is not None:
                self._send(par, M.DEREG(self.rank, par,
                                        phase=self.sig_next, delta=-1))
            self._unlink_next_level(self.sc)
        if self.sn.member and not self.sn.dropping:
            self.sn.dropping = True
            self._unlink_next_level(self.sn)

    def local_demote(self) -> None:
        """Straggler demotion: unlink every express lane but KEEP the
        level-0 membership — the node becomes a leaf of the SCSL reduce
        tree (fewest dependents) while still signaling every phase. The
        same top-down UNL walk as deletion, stopped at level 1; no
        DEREG (the head's expectation is unchanged)."""
        for st in (self.sc, self.sn):
            if not st.member or st.departed or st.dropping:
                continue
            st.target_height = 1
            if st.height <= 1:
                continue
            st.dropping = True          # lanes >= 1 behave as leaving
            st.demote_stop = 1
            st.unlink_level = None
            self._unlink_next_level(st)

    def local_promote_to(self, height: int) -> None:
        """Reverse a demotion: restore the drawn target height and walk
        the lazy MULS promotions back up."""
        for st in (self.sc, self.sn):
            if not st.member or st.departed or st.dropping:
                continue
            st.target_height = height
            self.start_promotion(st.lid)

    def start_insert(self, new_id: int, lid: int) -> None:
        """Initiate the eager insertion search from this (member) node."""
        st = self.st(lid)
        assert st.member and st.joined
        self.handle(M.TUS(self.rank, self.rank, key=new_id, new_id=new_id,
                          lid=lid))

    def start_promotion(self, lid: int) -> None:
        st = self.st(lid)
        if st.height < st.target_height and not st.dropping:
            self._muls_walk(st, st.height)

    # ------------------------------------------------------------ dispatcher
    def handle(self, msg: M.Msg) -> None:
        # A member whose own eager insert is still in flight cannot serve
        # protocol traffic (its links/routing are uninitialized and the
        # MURS_ACK would clobber anything it set): defer everything except
        # the join ack itself; replayed in _on_MURS_ACK.
        lid = getattr(msg, "lid", None)
        if lid is not None and msg.kind not in ("MURS_ACK", "AT"):
            st = self.st(lid)
            if st.member and not st.joined:
                st.join_defer.append(msg)
                return
        h = getattr(self, f"_on_{msg.kind}", None)
        assert h is not None, f"no handler for {msg.kind}"
        h(msg)

    # ------------------------------------------------------------- search
    def _on_TUS(self, m: M.TUS) -> None:
        st = self.st(m.lid)
        if st.departed:
            tgt = st.prv[0] if st.prv[0] is not None else HEAD
            self._send(tgt, m.replace(src=self.rank, dst=tgt))
            return
        if self.rank != HEAD and self.rank >= m.key:
            # ascend-left toward a node with key < target
            tgt = st.prv[st.top]
            assert tgt is not None
            self._send(tgt, m.replace(src=self.rank, dst=tgt))
        else:
            self._descend(st, m.key, st.top, m.new_id)

    def _on_TDS(self, m: M.TDS) -> None:
        st = self.st(m.lid)
        if st.departed:
            tgt = st.prv[0] if st.prv[0] is not None else HEAD
            self._send(tgt, M.TUS(self.rank, tgt, key=m.key, new_id=m.new_id,
                                  lid=m.lid))
            return
        # resume from OUR top lane, not the arrival lane: a rightward
        # walker at y < key may climb onto any of y's express lanes (all
        # its future hops stay < key) — capping at the arrival lane would
        # degenerate the search into a level-0 walk, O(n) not O(log n)
        self._descend(st, m.key, st.top, m.new_id)

    def _descend(self, st: ListState, key: int, level: int,
                 new_id: int) -> None:
        l = level
        while l >= 0:
            nk = st.nxt[l]
            if nk is not None and nk < key:
                self._send(nk, M.TDS(self.rank, nk, key=key, level=l,
                                     new_id=new_id, lid=st.lid))
                return
            l -= 1
        self._splice_level0(st, new_id)

    # ------------------------------------------------------------- splice
    def _splice_level0(self, st: ListState, new_id: int) -> None:
        """We are the level-0 predecessor: fast single-link-modify."""
        if st.unl0_sent:
            # our level-0 UNL (with its succ snapshot) is in flight: a
            # splice now would diverge the chain views (the bypassing
            # predecessor and we would each own a fork). Defer; flushed
            # as a fresh search from the bypassing pred at UNL_ACK.
            st.splice_defer.append(new_id)
            return
        succ = st.nxt[0]
        st.nxt[0] = new_id
        if st.lid == SCSL:
            first = st.closed + 1 if not self.is_head else self.head_released + 1
            st.book_add(new_id, first)
        else:
            first = self.st(SNSL).released + 1
            st.book_add(new_id, first)
        rel = self.st(SNSL).released if st.lid == SNSL else -1
        self._send(new_id, M.MURS_ACK(self.rank, new_id, new_id=new_id,
                                      succ=succ, first_phase=first,
                                      released=rel, lid=st.lid))
        if succ is not None:
            self._send(succ, M.PRV(self.rank, succ, level=0, prv=new_id,
                                   effective=first, lid=st.lid))

    def _on_MURS(self, m: M.MURS) -> None:
        # Direct splice request (initiator already adjacent); same path.
        self._splice_level0(self.st(m.lid), m.new_id)

    def _on_MURS_ACK(self, m: M.MURS_ACK) -> None:
        st = self.st(m.lid)
        st.height = 1
        st.nxt = [m.succ]
        st.prv = [m.src]
        st.joined = True
        st.first_phase = m.first_phase
        st.closed = m.first_phase - 1  # phases before our membership
        st.adv_open(m.first_phase, m.src)
        st.target_height = self.ph.height_of(self.rank)
        if st.lid == SCSL:
            self.sig_next = m.first_phase
            # ENSP: activate signal edge + push the +1 delta toward the head
            self._send(m.src, M.ENSP(self.rank, m.src, phase=m.first_phase,
                                     delta=+1, lid=SCSL))
            # replay signals sent while the insert was in flight
            cb = getattr(self.ph, "on_local_signal", None)
            while self.presig > 0:
                self.presig -= 1
                k = self.sig_next
                self.sig_next += 1
                st.selfsig.add(k)
                st.buf[k] = st.buf.get(k, 0) + 1
                if cb is not None:
                    cb(self.rank, k)
            self._try_close_sc()
        else:
            st.released = max(st.released, m.released)
            self.wait_next = max(self.wait_next, m.first_phase)
            if st.released >= 0:
                cb = getattr(self.ph, "on_wait_advance", None)
                if cb is not None:
                    cb(self.rank, st.released)
        parent = self.ph.async_parent.get(self.rank)
        if parent is not None and parent != self.rank \
                and self.ph.lists_done(self.rank):
            self._send(parent, M.AT(self.rank, parent, new_id=self.rank,
                                    first_phase=m.first_phase, lid=st.lid))
        # replay structural traffic that arrived before we joined
        deferred = st.join_defer
        st.join_defer = []
        for msg in deferred:
            self.handle(msg)
        if self.pending_drop and self.ph.lists_done(self.rank):
            self.pending_drop = False
            self.local_drop()
            return
        self.start_promotion(st.lid)

    def _on_AT(self, m: M.AT) -> None:
        self.async_children_attached.add(m.new_id)

    def _on_ENSP(self, m: M.ENSP) -> None:
        # Registration delta: head applies, others forward along the parent
        # edge covering the delta's phase — that chain is the one whose
        # closing reports gate the head's release of that phase, so the
        # delta provably arrives before the phase can be released.
        if self.is_head:
            self.deltas[m.phase] = self.deltas.get(m.phase, 0) + m.delta
            self._try_release_head()
            return
        st = self.st(m.lid)
        par = st.route_for(m.phase)
        assert par is not None
        self._send(par, m.replace(src=self.rank, dst=par))

    def _on_DEREG(self, m: M.DEREG) -> None:
        if self.is_head:
            self.deltas[m.phase] = self.deltas.get(m.phase, 0) + m.delta
            self._try_release_head()
            return
        st = self.st(m.lid)
        par = st.route_for(m.phase)
        assert par is not None
        self._send(par, m.replace(src=self.rank, dst=par))

    # ------------------------------------------------------- lazy promotion
    def _muls_walk(self, st: ListState, level: int) -> None:
        """Walk left along lane level-1 for our lane-``level`` predecessor."""
        tgt = st.prv[level - 1]
        assert tgt is not None
        self._send(tgt, M.MULS1(self.rank, tgt, level=level,
                                new_id=self.rank, lid=st.lid))

    def _on_MULS1(self, m: M.MULS1) -> None:
        st = self.st(m.lid)
        if st.departed or (not self.is_head and st.height <= m.level):
            # not on the lane: hand-over-hand, keep walking left
            tgt = st.prv[min(m.level - 1, st.top)] if not st.departed else st.prv[0]
            tgt = tgt if tgt is not None else HEAD
            self._send(tgt, m.replace(src=self.rank, dst=tgt))
            return
        if st.dropping:
            # leaving this lane: granting would race our unlink, and
            # bouncing the walker left would livelock (the grantor keeps
            # re-offering us as succ). Defer; flushed to the bypassing
            # predecessor when this level's unlink completes.
            st.defer_q.setdefault(m.level, []).append(m.new_id)
            return
        if m.level in st.latch:
            st.latch_q.setdefault(m.level, []).append(m.new_id)
            return
        st.latch[m.level] = m.new_id
        succ = st.nxt[m.level] if m.level < len(st.nxt) else None
        self._send(m.new_id, M.MULS2(self.rank, m.new_id, level=m.level,
                                     succ=succ, lid=m.lid))

    def _on_MULS2(self, m: M.MULS2) -> None:
        st = self.st(m.lid)
        if st.dropping or st.height != m.level \
                or st.target_height <= m.level:
            # leaving, or the walk went stale (a demotion shrank our
            # height / target while the MULS1 was in flight): decline —
            # the grantor releases its latch and serves the next walker
            self._send(m.src, M.MULS3(self.rank, m.src, level=m.level,
                                      new_id=self.rank, commit=False,
                                      lid=m.lid))
            return
        if m.succ is not None and m.succ < self.rank:
            # a closer predecessor was spliced concurrently: abort, re-aim
            self._send(m.src, M.MULS3(self.rank, m.src, level=m.level,
                                      new_id=self.rank, commit=False,
                                      lid=m.lid))
            self._send(m.succ, M.MULS1(self.rank, m.succ, level=m.level,
                                       new_id=self.rank, lid=m.lid))
            return
        st.nxt.append(m.succ)
        st.prv.append(m.src)
        st.height += 1
        self._send(m.src, M.MULS3(self.rank, m.src, level=m.level,
                                  new_id=self.rank, commit=True, lid=m.lid))
        if m.succ is not None:
            self._send(m.succ, M.PRV(self.rank, m.succ, level=m.level,
                                     prv=self.rank,
                                     effective=st.closed + 1, lid=m.lid))
        # our own signal edge moved: new parent is the lane-level predecessor
        if st.lid == SCSL:
            self._reparent(st, m.src, st.closed + 1)
        else:
            self._reparent(st, m.src, st.released + 1)
        self.start_promotion(st.lid)

    def _on_MULS3(self, m: M.MULS3) -> None:
        st = self.st(m.lid)
        if m.commit:
            st.nxt[m.level] = m.new_id
        del st.latch[m.level]
        if st.dropping:
            # we are leaving: queued walkers join the deferred set (flushed
            # at this level's unlink), parked UNLs proceed, and any paused
            # unlink resumes
            st.defer_q.setdefault(m.level, []).extend(
                st.latch_q.pop(m.level, []))
            for unl in st.unl_park.pop(m.level, []):
                self._on_UNL(unl)
            if st.unlink_waiting and st.unlink_level == m.level:
                st.unlink_waiting = False
                self._unlink_next_level(st)
            return
        for unl in st.unl_park.pop(m.level, []):
            self._on_UNL(unl)
        q = st.latch_q.get(m.level, [])
        if q:
            nxt = q.pop(0)
            self.handle(M.MULS1(nxt, self.rank, level=m.level, new_id=nxt,
                                lid=m.lid))

    # --------------------------------------------------------------- unlink
    def _unlink_next_level(self, st: ListState) -> None:
        if st.unlink_level is None:
            st.unlink_level = st.top
        l = st.unlink_level
        if st.demote_stop > 0 and l < st.demote_stop:
            # demotion complete: level 0 kept, node stays a live member
            st.dropping = False
            st.demote_stop = 0
            st.unlink_level = None
            st.unlink_waiting = False
            if self.pending_drop and not (self.sc.demote_stop
                                          or self.sn.demote_stop):
                self.pending_drop = False
                self.local_drop()
            return
        if l < 0:
            st.departed = True
            self._finalize_drop(st)
            return
        if l in st.latch:
            # an in-flight splice holds this level: pause; the MULS3 that
            # releases the latch resumes the unlink (latch/unlink mutual
            # exclusion — required for lane integrity under concurrent
            # insert+delete)
            st.unlink_waiting = True
            return
        pred = st.prv[l]
        assert pred is not None
        st.unl_sent_succ = st.nxt[l]
        if l == 0:
            st.unl0_sent = True
        self._send(pred, M.UNL(self.rank, pred, level=l, node=self.rank,
                               succ=st.nxt[l], lid=st.lid))

    def _on_UNL(self, m: M.UNL) -> None:
        st = self.st(m.lid)
        if not st.departed and (self.is_head or st.height > m.level) \
                and m.level in st.latch:
            # an open MULS latch at this level means a splice (whose
            # MULS2 carried our pre-bypass successor) may still commit
            # and re-link the departing node: park the UNL until the
            # latch releases (processed in _on_MULS3)
            st.unl_park.setdefault(m.level, []).append(m)
            return
        if st.departed or (not self.is_head and st.height <= m.level) \
                or st.nxt[m.level] != m.node:
            # stale pred (we moved/were bypassed): forward toward the node's
            # current predecessor via our own link at that level
            tgt = st.nxt[m.level] if (not st.departed and
                                      (self.is_head or st.height > m.level)) \
                else st.prv[0]
            tgt = tgt if tgt is not None else HEAD
            if tgt != m.node:
                self._send(tgt, m.replace(src=self.rank, dst=tgt))
                return
        st.nxt[m.level] = m.succ
        if m.succ is not None:
            eff = (st.closed + 1) if st.lid == SCSL else (st.released + 1)
            self._send(m.succ, M.PRV(self.rank, m.succ, level=m.level,
                                     prv=self.rank, effective=eff, lid=m.lid))
        self._send(m.node, M.UNL_ACK(self.rank, m.node, level=m.level,
                                     node=m.node, lid=m.lid))

    def _on_UNL_ACK(self, m: M.UNL_ACK) -> None:
        st = self.st(m.lid)
        if st.unlink_level != m.level:
            return   # late/duplicate ack (NXT-walk bypasses re-ack)
        cur = st.nxt[m.level]
        snap = st.unl_sent_succ
        if cur != snap:
            # our nxt changed after the UNL snapshot (we bypassed a
            # concurrently-deleting successor, or a chained NXT handed us
            # a node): the bypassing predecessor linked to the STALE succ.
            if cur is not None:
                # merge our live successor in (ordered NXT walk)
                self._send(m.src, M.NXT(self.rank, m.src, level=m.level,
                                        nxt=cur, lid=st.lid))
            elif snap is not None:
                # our successor left the lane entirely: the pred must
                # bypass the stale snapshot node to end-of-lane
                self._send(m.src, M.UNL(self.rank, m.src, level=m.level,
                                        node=snap, succ=None, lid=st.lid))
        if m.level == 0:
            # flush deferred splices as fresh searches from the live pred
            for nid in st.splice_defer:
                self._send(m.src, M.TUS(self.rank, m.src, key=nid,
                                        new_id=nid, lid=st.lid))
            st.splice_defer = []
        if st.lid == SCSL and m.level > 0 and m.level == st.top:
            # our top drops: re-parent to the predecessor at the new top
            self._reparent(st, st.prv[m.level - 1], st.closed + 1)
        # flush walkers deferred on this level to the bypassing pred
        for nid in st.defer_q.pop(m.level, []):
            self._send(m.src, M.MULS1(self.rank, m.src, level=m.level,
                                      new_id=nid, lid=st.lid))
        if m.level > 0:
            st.height = m.level
            st.nxt = st.nxt[:m.level]
            st.prv = st.prv[:m.level]
        st.unlink_level = m.level - 1
        self._unlink_next_level(st)

    def _on_NXT(self, m: M.NXT) -> None:
        """Ordered merge-walk: insert the handed-over node at its sorted
        position (my chain may have grown since the hand-over was sent;
        a blind overwrite would orphan the newer splice)."""
        st = self.st(m.lid)
        if st.departed or st.height <= m.level:
            # we are off this lane — the sender's link to us is stale:
            # have it bypass us directly to the handed-over node
            self._send(m.src, M.UNL(self.rank, m.src, level=m.level,
                                    node=self.rank, succ=m.nxt, lid=m.lid))
            return
        cur = st.nxt[m.level]
        if cur == m.nxt:
            if st.dropping and m.level >= st.demote_stop:
                # the handed node is already our successor, but WE are
                # leaving this lane (a demoting node keeps the lanes
                # below its demote_stop): the sender must bypass us
                self._send(m.src, M.UNL(self.rank, m.src, level=m.level,
                                        node=self.rank, succ=m.nxt,
                                        lid=m.lid))
            return                          # already linked
        if cur is not None and cur < m.nxt:
            # walk right: the handed node sorts after my successor
            self._send(cur, m.replace(src=self.rank, dst=cur))
            return
        st.nxt[m.level] = m.nxt
        eff = (st.closed + 1) if st.lid == SCSL else (st.released + 1)
        self._send(m.nxt, M.PRV(self.rank, m.nxt, level=m.level,
                                prv=self.rank, effective=eff, lid=m.lid))
        if cur is not None:
            # my old successor re-attaches after the handed node (its own
            # walk continues the merge down its chain)
            self._send(m.nxt, M.NXT(self.rank, m.nxt, level=m.level,
                                    nxt=cur, lid=m.lid))

    def _finalize_drop(self, st: ListState) -> None:
        if st.lid == SCSL:
            self._try_close_sc()
        # SNSL ghosts keep forwarding ADVs until children re-parent; nothing
        # further to do here.

    # ------------------------------------------------- neighbor/books events
    def _on_PRV(self, m: M.PRV) -> None:
        st = self.st(m.lid)
        if st.departed or st.height <= m.level:
            return  # stale
        st.prv[m.level] = m.prv
        if m.level == st.top:
            self._reparent(st, m.prv, m.effective)

    def _reparent(self, st: ListState, new_parent: int,
                  effective: int) -> None:
        """Move the open advertised interval to ``new_parent``.

        SNSL: immediate switch (ADV is idempotent-monotone; a catch-up ADV
        from the new parent repairs any gap).

        SCSL: two-way handshake. Fire-and-forget switching is UNSOUND: the
        new parent may have already closed (reported) the phases we would
        hand it, silently breaking the closing-report obligation chain to
        the head — and with it the safety of report-gated release against
        in-flight registration deltas. Instead we CHILD_ADD(from=f0) and
        keep the old interval open until the parent's CHILD_ADD_ACK grants
        coverage from ``granted = max(f0, parent.closed+1)``; phases below
        the grant stay with the old parent, whose book is still open."""
        iv = st.adv_open_iv()
        if iv is None:
            # fully deregistered (final CHILD_DEL already sent): no further
            # combining obligations to move
            return
        if st.lid == SNSL:
            old = iv[2]
            if old == new_parent:
                return
            switch = max(effective, st.released + 1, iv[0])
            end = st.adv_close(switch)
            self._send(old, M.CHILD_DEL(self.rank, old, from_phase=end,
                                        lid=st.lid))
            st.adv_open(end, new_parent)
            self._send(new_parent, M.CHILD_ADD(self.rank, new_parent,
                                               from_phase=end, lid=st.lid))
            return
        # ---- SCSL handshake ----
        if st.rp_pending is not None:
            if st.rp_pending != new_parent:
                st.rp_queue = (new_parent, effective)
            return
        if iv[2] == new_parent:
            return
        f0 = max(effective, st.closed + 1, iv[0])
        st.rp_pending = new_parent
        self._send(new_parent, M.CHILD_ADD(self.rank, new_parent,
                                           from_phase=f0, lid=st.lid))

    def _on_CHILD_ADD_ACK(self, m: M.CHILD_ADD_ACK) -> None:
        """Complete the SCSL re-parent: close the old interval at the
        granted phase and open [granted, None) at the granting parent
        (which may differ from the node we asked — departed relays forward
        the CHILD_ADD to their own parent)."""
        st = self.st(m.lid)
        st.rp_pending = None
        iv = st.adv_open_iv()
        if iv is None:
            # dropped while the handshake was in flight: release the
            # speculative book the granter opened for us
            self._send(m.src, M.CHILD_DEL(self.rank, m.src,
                                          from_phase=m.granted, lid=m.lid))
            return
        old = iv[2]
        if old == m.src:
            # the relayed request cycled back to our current parent: drop
            # the speculative grant (CHILD_DEL closes the granter's newest
            # open interval for us) and keep our existing interval
            self._send(m.src, M.CHILD_DEL(self.rank, m.src,
                                          from_phase=m.granted, lid=m.lid))
        else:
            end = st.adv_close(max(m.granted, iv[0]))
            self._send(old, M.CHILD_DEL(self.rank, old, from_phase=end,
                                        lid=st.lid))
            st.adv_open(end, m.src)
            # Catch-up: phases in [granted, closed] were discharged via the
            # old route while the handshake was in flight; the granter's
            # book covers them — zero-count closing reports clear its gate.
            for k in range(end, st.closed + 1):
                self._send(m.src, M.SIG(self.rank, m.src, phase=k, count=0,
                                        closing=True, lid=SCSL))
        if st.rp_queue is not None:
            nxt, eff = st.rp_queue
            st.rp_queue = None
            self._reparent(st, nxt, eff)
        self._try_close_sc()

    def _on_CHILD_ADD(self, m: M.CHILD_ADD) -> None:
        st = self.st(m.lid)
        child = m.child if m.child is not None else m.src
        if st.lid == SNSL:
            st.book_add(child, m.from_phase)
            # catch the new child up on releases it may have missed
            rel = self.head_released if self.is_head else st.released
            if rel >= 0:
                self._send(child, M.ADV(self.rank, child, phase=rel,
                                        lid=SNSL))
            return
        # ---- SCSL: grant (or relay) ----
        if not self.is_head and (st.departed or st.final_childdel_sent):
            # no chain of our own: relay toward our last known parent
            par = st.route_for(m.from_phase)
            tgt = par if par is not None else HEAD
            self._send(tgt, M.CHILD_ADD(self.rank, tgt,
                                        from_phase=m.from_phase,
                                        child=child, lid=SCSL))
            return
        base = self.head_released if self.is_head else st.closed
        granted = max(m.from_phase, base + 1)
        st.book_add(child, granted)
        self._send(child, M.CHILD_ADD_ACK(self.rank, child, granted=granted,
                                          lid=SCSL))

    def _on_CHILD_DEL(self, m: M.CHILD_DEL) -> None:
        st = self.st(m.lid)
        st.book_del(m.src, m.from_phase)
        if st.lid == SCSL:
            if self.is_head:
                self._try_release_head()
            else:
                self._try_close_sc()

    # ------------------------------------------------------------ signaling
    def _will_close(self, st: ListState, k: int) -> bool:
        """Will we ever emit our own aggregate for phase k? If not, any count
        for k must be passed through immediately (never parked in buf)."""
        return (st.signaler_active(k) or st.any_coverage(k)
                or st.adv_covers(k))

    def _on_SIG(self, m: M.SIG) -> None:
        st = self.sc
        if self.is_head:
            st.buf[m.phase] = st.buf.get(m.phase, 0) + m.count
            if m.closing and st.covers(m.src, m.phase):
                st.reported.setdefault(m.phase, set()).add(m.src)
            self._try_release_head()
            return
        if m.phase <= st.closed or not self._will_close(st, m.phase):
            # already reported (or never will): pass through toward the head
            par = st.route_for(m.phase)
            assert par is not None
            self._send(par, M.SIG(self.rank, par, phase=m.phase,
                                  count=m.count, closing=False, lid=SCSL))
            return
        st.buf[m.phase] = st.buf.get(m.phase, 0) + m.count
        if m.closing and st.covers(m.src, m.phase):
            st.reported.setdefault(m.phase, set()).add(m.src)
        self._try_close_sc()

    def _try_close_sc(self) -> None:
        st = self.sc
        if not st.joined and not st.member:
            return
        self._close_loop(st)
        self._maybe_final_childdel(st)

    def _close_loop(self, st: ListState) -> None:
        while True:
            k = st.closed + 1
            need_self = st.signaler_active(k)
            if need_self and k not in st.selfsig:
                return
            kids = st.active_children(k)
            if any(c not in st.reported.get(k, ()) for c in kids):
                return
            # Deregistered: phases >= K (our interval's eventual close
            # point) are owned by the final-CHILD_DEL epilogue — do not
            # proactively close them (unbounded otherwise). Phases below
            # an already-CLOSED advertised interval's end are firm
            # promises (e.g. a re-parent grant clamped the close point
            # upward) and must still be reported.
            if not need_self and st.dereg_phase is not None and not kids:
                K = max(st.dereg_phase, st.max_to())
                promised = max((iv[1] for iv in st.adv
                                if iv[1] is not None), default=0)
                if k >= max(K, promised):
                    return
            # Contract with the parent: a closing report for exactly the
            # phases covered by our advertised intervals — which mirror the
            # parent's books by construction, so neither side ever waits
            # for a report the other will not produce.
            expects_us = st.adv_covers(k)
            if not (need_self or kids or expects_us):
                # No combining obligations at k. If anything pends at or
                # beyond k, flush-and-advance (pass-through) so parked
                # counts can never wedge behind an idle phase.
                if any(p >= k for p in st.buf):
                    par = st.route_for(k)
                    if par is None:
                        return
                    total = st.buf.pop(k, 0)
                    if total:
                        self._send(par, M.SIG(self.rank, par, phase=k,
                                              count=total, closing=False,
                                              lid=SCSL))
                    st.reported.pop(k, None)
                    st.closed = k
                    continue
                return
            par = st.route_for(k)
            if par is None:
                return
            total = st.buf.pop(k, 0)
            if expects_us or total:
                self._send(par, M.SIG(self.rank, par, phase=k, count=total,
                                      closing=bool(expects_us), lid=SCSL))
            st.reported.pop(k, None)
            st.closed = k

    def _maybe_final_childdel(self, st: ListState) -> None:
        """Deregistration epilogue: once every child interval is closed and
        all covered phases are reported, close our own open advertised
        interval — the parent stops expecting us from K on."""
        if (st.dropping and st.departed and not st.final_childdel_sent
                and st.all_children_closed()
                and st.closed >= st.max_to() - 1
                and st.adv_open_iv() is not None):
            K = max(st.dereg_phase if st.dereg_phase is not None else 0,
                    st.max_to())
            end = st.adv_close(K)
            par = st.route_for(end)
            if par is not None:
                self._send(par, M.CHILD_DEL(self.rank, par,
                                            from_phase=end, lid=SCSL))
            st.final_childdel_sent = True
            # any phases still covered (closed+1 .. end-1) will be reported
            # by the regular close loop; counts beyond flow as pass-through
            self._close_loop(st)

    # HEAD: count-based completion --------------------------------------
    def _expected(self, k: int) -> int:
        return self.expected_base + sum(v for p, v in self.deltas.items()
                                        if p <= k)

    def _try_release_head(self) -> None:
        assert self.is_head
        while True:
            k = self.head_released + 1
            exp = self._expected(k)
            got = self.sc.buf.get(k, 0)
            assert got <= max(exp, self._expected_final_bound(k)), \
                "over-collection: conservation violated"
            if exp == 0 or got < exp:
                return
            # Completion is count-based AND report-based: every book-child
            # interval covering k must have delivered its closing report.
            # This is what makes release race-free against in-flight
            # registration deltas — a child that admitted a new signaler
            # for phase k withholds its own closing report for k until the
            # new task's report arrives, and the new task's ENSP (+1)
            # FIFO-precedes its first count on every channel toward the
            # head. Count-only release could fire between a DEREG and a
            # concurrent ENSP (premature phase advance).
            kids = self.sc.active_children(k)
            if any(c not in self.sc.reported.get(k, ()) for c in kids):
                return
            self.sc.buf.pop(k, None)
            self.sc.reported.pop(k, None)
            self.head_released = k
            self.ph.on_release(k)
            self._fanout_adv(k)

    def _expected_final_bound(self, k: int) -> int:
        # upper bound used only for the conservation assertion
        return self.expected_base + sum(abs(v) for v in self.deltas.values())

    def _fanout_adv(self, k: int) -> None:
        for c in list(self.sn.books):
            if any(True for _ in self.sn.books[c]):
                self._send(c, M.ADV(self.rank, c, phase=k, lid=SNSL))

    # ---------------------------------------------------------- notification
    def _on_ADV(self, m: M.ADV) -> None:
        st = self.sn
        if m.phase <= st.released:
            return
        st.released = m.phase
        # wait-watermark hook: phase m.phase is now released to this
        # participant — the signal->here gap is its blocked-on-WAIT time
        cb = getattr(self.ph, "on_wait_advance", None)
        if cb is not None:
            cb(self.rank, m.phase)
        for c in list(st.books):
            self._send(c, M.ADV(self.rank, c, phase=m.phase, lid=SNSL))


class DistPhaser:
    """Facade: builds the phaser, owns the network, exposes the task API.

    The initial team topology is derived from the deterministic skip-list
    oracle (every rank computes it identically — the data-plane adaptation of
    the paper's collective creation step; ``core/creation.py`` reproduces the
    recursive-doubling exchange itself and verifies it converges to the same
    structure)."""

    def __init__(self, n: int, *, modes: Optional[Dict[int, str]] = None,
                 p: float = 0.5, seed: int = 0, max_height: int = 32,
                 net: Optional[Network] = None):
        self.n = n
        self.p = p
        self.seed = seed
        self.max_height = max_height
        self.net = net or Network()
        self.modes = {r: SIG_WAIT for r in range(n)}
        if modes:
            self.modes.update(modes)
        self.async_parent: Dict[int, int] = {}
        self.release_log: List[int] = []
        self.actors: Dict[int, PhaserActor] = {}
        # demoted keys: height pinned to 1 (leaf of the reduce tree);
        # part of the topology identity the oracle re-derives
        self.demoted: set = set()
        # optional monitor(ph, k) invoked at the release instant (modelcheck)
        self.release_monitor = None
        # optional WatermarkTracker (obs plane): installed by consumers
        # that want live phase watermarks (P2PPhaser.enable_watermarks)
        self.watermarks = None

        head = PhaserActor(HEAD, self.net, SIG_WAIT, phaser=self)
        self.actors[HEAD] = head
        self.net.register(head)
        for r in range(n):
            a = PhaserActor(r, self.net, self.modes[r], phaser=self)
            self.actors[r] = a
            self.net.register(a)

        sig_keys = [r for r in range(n) if self.modes[r] in (SIG_MODE, SIG_WAIT)]
        wait_keys = [r for r in range(n) if self.modes[r] in (WAIT_MODE, SIG_WAIT)]
        self._init_list(SCSL, sig_keys)
        self._init_list(SNSL, wait_keys)
        head.expected_base = len(sig_keys)

    # ------------------------------------------------------------- topology
    def height_of(self, key: int) -> int:
        if key in self.demoted:
            return 1
        return det_height(key, p=self.p, max_height=self.max_height,
                          seed=self.seed)

    def oracle(self, keys) -> SkipList:
        return SkipList.build(keys, p=self.p, max_height=self.max_height,
                              seed=self.seed, leaf_keys=self.demoted)

    def _init_list(self, lid: int, keys: List[int]) -> None:
        sl = self.oracle(keys)
        for k in [HEAD] + keys:
            node = sl.nodes[k]
            st = self.actors[k].st(lid)
            st.member = True
            st.joined = True
            st.height = node.height if k != HEAD else node.height
            st.target_height = st.height
            st.nxt = list(node.nxt)
            st.prv = list(node.prv)
            st.books = {c: [[0, None]] for c in sl.children(k)}
            par = sl.parent(k)
            if par is not None:
                st.adv = [[0, None, par]]
            if lid == SNSL:
                st.released = -1

    def lists_done(self, rank: int) -> bool:
        a = self.actors[rank]
        ok = True
        if a.sc.member:
            ok &= a.sc.joined
        if a.sn.member:
            ok &= a.sn.joined
        return ok

    # ------------------------------------------------------------- task API
    def signal(self, rank: int) -> None:
        self.actors[rank].local_signal()

    def drop(self, rank: int) -> None:
        self.actors[rank].local_drop()
        self.demoted.discard(rank)

    def demote(self, rank: int) -> None:
        """Pin ``rank`` to a leaf position (height 1) in both lists: the
        straggler keeps signaling but loses every dependent in the
        hierarchical combining tree. Structural work is the deletion
        unlink stopped at level 1 — no DEREG, no departure."""
        assert self.lists_done(rank), rank
        self.demoted.add(rank)
        self.actors[rank].local_demote()

    def repromote(self, rank: int) -> None:
        """Undo a demotion: restore the deterministic drawn height and
        run the lazy MULS promotions back up the lanes."""
        self.demoted.discard(rank)
        self.actors[rank].local_promote_to(self.height_of(rank))

    def async_add(self, parent: int, new_rank: int,
                  mode: str = SIG_WAIT) -> None:
        """Paper Fig. 2: ``parent`` asyncs ``new_rank`` onto the phaser."""
        assert new_rank not in self.actors or not any(
            self.actors[new_rank].st(l).member for l in (SCSL, SNSL))
        a = PhaserActor(new_rank, self.net, mode, phaser=self)
        self.actors[new_rank] = a
        self.net.register(a)
        self.modes[new_rank] = mode
        self.async_parent[new_rank] = parent
        if mode in (SIG_MODE, SIG_WAIT):
            a.sc.member = True
            init = parent if self.modes.get(parent) in (SIG_MODE, SIG_WAIT) \
                else HEAD
            self.actors[init].start_insert(new_rank, SCSL)
        if mode in (WAIT_MODE, SIG_WAIT):
            a.sn.member = True
            init = parent if self.modes.get(parent) in (WAIT_MODE, SIG_WAIT) \
                else HEAD
            self.actors[init].start_insert(new_rank, SNSL)

    def released(self, rank: Optional[int] = None) -> int:
        if rank is None:
            return self.actors[HEAD].head_released
        a = self.actors[rank]
        return a.sn.released if a.sn.member else self.actors[HEAD].head_released

    def on_release(self, k: int) -> None:
        self.release_log.append(k)
        if self.release_monitor is not None:
            self.release_monitor(self, k)

    # -------------------------------------------------- watermark hooks
    def on_local_signal(self, rank: int, phase: int) -> None:
        if self.watermarks is not None:
            self.watermarks.on_signal(rank, phase)

    def on_wait_advance(self, rank: int, phase: int) -> None:
        if self.watermarks is not None:
            self.watermarks.on_wait_advance(rank, phase)

    # ------------------------------------------------------------- driving
    def run(self, scheduler: Optional[Scheduler] = None,
            max_steps: int = 1_000_000) -> int:
        return (scheduler or FifoScheduler()).run(self.net, max_steps)

    def next(self, ranks=None, scheduler: Optional[Scheduler] = None) -> int:
        """Convenience: everyone signals, run to quiescence, phase advances."""
        for r in (ranks if ranks is not None else
                  [r for r in self.modes
                   if self.modes[r] in (SIG_MODE, SIG_WAIT)
                   and self.actors[r].sc.member
                   and not self.actors[r].sc.dropping]):
            self.signal(r)
        self.run(scheduler)
        return self.actors[HEAD].head_released

    # ------------------------------------------------------------ inspection
    def check_quiescent_invariants(self) -> None:
        """Structural + bookkeeping invariants at quiescence (used by tests
        and the model checker)."""
        assert self.net.idle()
        for lid in (SCSL, SNSL):
            keys = sorted(r for r, a in self.actors.items()
                          if r != HEAD and a.st(lid).member
                          and a.st(lid).joined and not a.st(lid).departed)
            # walk level-0 from head: must be exactly `keys` in order
            seen = []
            cur = self.actors[HEAD].st(lid).nxt[0]
            while cur is not None:
                seen.append(cur)
                cur = self.actors[cur].st(lid).nxt[0]
            assert seen == keys, f"lid={lid}: level-0 chain {seen} != {keys}"
            for l in range(1, self.max_height):
                lane = []
                st = self.actors[HEAD].st(lid)
                cur = st.nxt[l] if l < len(st.nxt) else None
                while cur is not None:
                    lane.append(cur)
                    nst = self.actors[cur].st(lid)
                    cur = nst.nxt[l] if l < nst.height else None
                expect = [k for k in keys
                          if self.actors[k].st(lid).height > l]
                assert lane == expect, \
                    f"lid={lid} lane {l}: {lane} != {expect}"
