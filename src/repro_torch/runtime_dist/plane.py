"""Partitioned phaser control plane: one logical skip list, N processes.

``DistPhaser`` holds every protocol actor in one address space. Here the
same actors are *sharded by ownership* (the PGAS global-view recipe of
arXiv:2112.00068): process ``k`` owns the actor for participant key
``k``; the coordinator (pid ``COORD = -1``) owns the HEAD sentinel —
conveniently the same id as the HEAD key. ``PhaserActor`` is reused
unmodified: its only facade needs are ``height_of`` (deterministic hash,
computable anywhere), ``async_parent`` (populated on the joining key's
owner), ``lists_done`` (asked only about the local rank) and
``on_release`` (fires on the HEAD owner). Everything else the actors do
is messaging, and ``PartitionedNetwork`` routes any envelope whose
destination is remote through the transport endpoint; per-(src, dst)
FIFO — the protocol's only ordering assumption — is preserved because
each ordered pair maps onto one ordered stream.

Quiescence becomes a distributed property: locally ``idle()`` plus
globally "no frame in flight", which the coordinator establishes from
the shards' matching remote sent/received counters (two stable polls —
a Mattern-style termination wave; the in-process fabric needs no wave
because delivery is synchronous).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from ..core.phaser import SCSL, SNSL, SIG_MODE, SIG_WAIT, WAIT_MODE, \
    PhaserActor
from ..core.runtime import Envelope, Network
from ..core.skiplist import HEAD, SkipList, det_height
from ..obs.live import WatermarkTracker
from ..obs.recorder import FlightRecorder
from ..obs.trace import Tracer
from .transport import Endpoint

COORD = -1  # coordinator pid == the HEAD sentinel key


def default_owner(key: int) -> int:
    """Participant key k lives on process k; HEAD on the coordinator."""
    return COORD if key == HEAD else key


class PartitionedNetwork(Network):
    """The local slice of the cluster-wide network: envelopes for local
    actors use the in-memory FIFO channels; remote ones leave through
    the endpoint and are re-injected into the owner's channels by
    ``ingest`` on arrival (same (src, dst) channel key, so delivery
    order stays per-channel FIFO end to end)."""

    def __init__(self, pid: int, endpoint: Endpoint,
                 owner_of: Callable[[int], int] = default_owner):
        super().__init__()
        self.pid = pid
        self.endpoint = endpoint
        self.owner_of = owner_of
        self.remote_sent = 0
        self.remote_received = 0
        # keys that left the membership: envelopes to them are swallowed,
        # mirroring the monolithic network where a departed actor receives
        # stale notifications (ADV fan-out books) and ignores them
        self.dropped: Set[int] = set()
        self.black_holed = 0
        # membership generation: bumped by the coordinator's
        # non-cooperative recovery; stamped on every outgoing envelope
        # and checked at ingest so frames from the pre-crash incarnation
        # can never reach the rebuilt actors
        self.gen = 0
        self.stale_gen = 0
        self.send_failed = 0    # remote sends to a crashed peer

    def _blackhole(self, env: Envelope) -> None:
        if self.tracer is not None and env.trace is not None:
            # the span still closes: eviction fan-out must not
            # leave dangling spans in the causal tree
            self.tracer.on_blackhole(env.trace)

    def post(self, env: Envelope) -> None:
        env.gen = self.gen
        if env.msg.dst in self.dropped:
            self.black_holed += 1
            self._blackhole(env)
            return
        owner = self.owner_of(env.msg.dst)
        if owner == self.pid:
            super().post(env)
            return
        self.sent[env.msg.kind] += 1
        try:
            self.endpoint.send(owner, "env", env)
        except (OSError, ConnectionError):
            # crash-stop peer: the frame is gone; count it and close
            # the span — detection/recovery is the coordinator's job.
            # (Socket fabrics no longer take this path: their session
            # layer defers undeliverable envelopes into the resend
            # ring instead of raising, and frames reaped for good come
            # back through the endpoint reaper -> _blackhole edge.)
            self.send_failed += 1
            self._blackhole(env)
            return
        self.remote_sent += 1

    def ingest(self, env: Envelope) -> None:
        """Arrival of a remote envelope: enqueue without re-counting the
        send (the source shard already did). Frames from an older
        membership generation are fenced here (their senders were
        rebuilt or died); their spans close as blackholed."""
        if getattr(env, "gen", 0) != self.gen:
            self.stale_gen += 1
            self._blackhole(env)
            return
        if env.msg.dst in self.dropped:
            self.black_holed += 1
            self._blackhole(env)
            return
        self.remote_received += 1
        self.channels[(env.msg.src, env.msg.dst)].append(env)

    def deliver_all(self, max_steps: int = 1_000_000) -> int:
        """Round-robin local delivery to local idleness (remote sends
        triggered along the way just leave through the endpoint)."""
        n = 0
        rr = 0
        while not self.idle():
            chans = self.nonempty_channels()
            self.deliver_from(chans[rr % len(chans)])
            rr += 1
            n += 1
            assert n <= max_steps, "local delivery did not quiesce"
        return n


class ShardPhaser:
    """Per-process facade over the locally-owned protocol actors.

    Mirrors the slice of ``DistPhaser``'s surface the actors and the
    runtime need; global topology metadata (live keys, demotions, seed)
    is replicated on every shard so each process can derive the oracle —
    and therefore its own partition view — without communication."""

    def __init__(self, pid: int, endpoint: Endpoint, *,
                 live: Iterable[int], p: float = 0.5, seed: int = 0,
                 max_height: int = 32,
                 demoted: Iterable[int] = (),
                 owner_of: Callable[[int], int] = default_owner,
                 modes: Optional[Dict[int, str]] = None,
                 obs: bool = False):
        self.pid = pid
        self.p = p
        self.seed = seed
        self.max_height = max_height
        self.owner_of = owner_of
        self.live: Set[int] = set(live)
        self.demoted: Set[int] = set(demoted)
        self.net = PartitionedNetwork(pid, endpoint, owner_of)
        # session-layer reap edge: an unacked envelope torn out of a
        # resend ring for good (peer evicted, ring overflow) is
        # blackholed through the net so its span still closes
        _sr = getattr(endpoint, "set_reaper", None)
        if _sr is not None:
            _sr(lambda payload, tag:
                self.net._blackhole(payload) if tag == "env" else None)
        # always-on obs layer: phase watermarks (counter bumps via the
        # actor hooks) and the bounded flight ring — both cheap enough
        # to never gate behind ``obs``
        self.watermarks = WatermarkTracker(pid)
        self.flight = FlightRecorder(pid)
        if obs:
            self.net.tracer = Tracer(pid)
            self.net.tracer.flight = self.flight
        self.modes: Dict[int, str] = {k: SIG_WAIT for k in self.live}
        if modes:
            self.modes.update(modes)
        for k in self.live:
            if owner_of(k) == pid:
                self.watermarks.set_mode(k, self.modes[k])
        self.async_parent: Dict[int, int] = {}
        self.release_log: List[int] = []
        self.gen = 0                 # membership incarnation (recovery)
        self.stray: List = []        # non-env frames surfaced by pump()
        self.actors: Dict[int, PhaserActor] = {}
        local = [k for k in sorted(self.live) if owner_of(k) == pid]
        if owner_of(HEAD) == pid:
            local = [HEAD] + local
        for k in local:
            a = PhaserActor(k, self.net, self.modes.get(k, SIG_WAIT),
                            phaser=self)
            self.actors[k] = a
            self.net.register(a)
        sig = [k for k in sorted(self.live)
               if self.modes[k] in (SIG_MODE, SIG_WAIT)]
        wait = [k for k in sorted(self.live)
                if self.modes[k] in (WAIT_MODE, SIG_WAIT)]
        self._init_list(SCSL, sig)
        self._init_list(SNSL, wait)
        if HEAD in self.actors:
            self.actors[HEAD].expected_base = len(sig)

    # ---------------------------------------------------------- facade API
    def height_of(self, key: int) -> int:
        if key in self.demoted:
            return 1
        return det_height(key, p=self.p, max_height=self.max_height,
                          seed=self.seed)

    def lists_done(self, rank: int) -> bool:
        a = self.actors[rank]
        ok = True
        if a.sc.member:
            ok &= a.sc.joined
        if a.sn.member:
            ok &= a.sn.joined
        return ok

    def on_release(self, k: int) -> None:
        self.release_log.append(k)
        # fires on the HEAD owner (the coordinator): one event per phase
        self.flight.event("release", phase=k)

    # watermark hooks — PhaserActor looks these up via getattr on its
    # phaser facade; the shard's tracker is always on
    def on_local_signal(self, rank: int, phase: int) -> None:
        self.watermarks.on_signal(rank, phase)

    def on_wait_advance(self, rank: int, phase: int) -> None:
        self.watermarks.on_wait_advance(rank, phase)

    # ---------------------------------------------------------- topology
    def oracle(self, keys: Optional[Iterable[int]] = None) -> SkipList:
        return SkipList.build(sorted(keys if keys is not None
                                     else self.live),
                              p=self.p, max_height=self.max_height,
                              seed=self.seed, leaf_keys=self.demoted)

    def _init_list(self, lid: int, keys: List[int],
                   phase_start: int = 0) -> None:
        """Seed the local actors' list states from the global oracle —
        every shard computes the same structure, installs its slice.
        ``phase_start`` > 0 is the crash-recovery path: the rebuilt
        incarnation opens its books at the first un-released phase, so
        the fresh state is exactly boot state shifted by the phases the
        previous incarnation already closed."""
        sl = self.oracle(keys)
        for k, a in self.actors.items():
            if k != HEAD and k not in keys:
                continue
            node = sl.nodes[k]
            st = a.st(lid)
            st.member = True
            st.joined = True
            st.height = node.height
            st.target_height = st.height
            st.nxt = list(node.nxt)
            st.prv = list(node.prv)
            st.books = {c: [[phase_start, None]] for c in sl.children(k)}
            par = sl.parent(k)
            if par is not None:
                st.adv = [[phase_start, None, par]]
            st.first_phase = phase_start
            st.closed = phase_start - 1
            if lid == SNSL:
                st.released = phase_start - 1

    def local_states(self, lid: int) -> Dict[int, Tuple[int, Tuple, Tuple]]:
        """(height, nxt, prv) for every locally-owned live actor (HEAD
        included) — matched against ``SkipList.partition``'s view of
        this owner at epoch boundaries."""
        out = {}
        for k, a in self.actors.items():
            if k != HEAD and k not in self.live:
                continue
            st = a.st(lid)
            if not st.member or (k != HEAD and not st.joined) \
                    or st.departed:
                continue
            out[k] = (st.height, tuple(st.nxt), tuple(st.prv))
        return out

    # ---------------------------------------------------------- tracing
    @property
    def tracer(self) -> Optional[Tracer]:
        return self.net.tracer

    def _root(self, op: str, key: int) -> None:
        """Open a root span before a facade op: the actor's resulting
        sends (and their remote descendants) form one causal tree."""
        if self.net.tracer is not None:
            self.net.tracer.root(op, key)

    def drain_obs(self) -> List[Dict]:
        """Hand the shard's span records to the coordinator (empty when
        tracing is off)."""
        return self.net.tracer.drain() if self.net.tracer else []

    # ---------------------------------------------------------- operations
    def create_member(self, new: int, parent: int,
                      mode: str = SIG_WAIT) -> None:
        """Owner-side half of the paper's async add: materialize the new
        key's actor (it joins via MURS_ACK once the initiator's eager
        splice reaches it)."""
        assert self.owner_of(new) == self.pid, (new, self.pid)
        a = PhaserActor(new, self.net, mode, phaser=self)
        self.actors[new] = a
        self.net.register(a)
        self.modes[new] = mode
        self.async_parent[new] = parent
        self.live.add(new)

    def start_insert(self, new: int, parent: int) -> None:
        """Initiator-side half: the (locally-owned) parent starts the
        eager level-0 search for both lists. Runs on the parent's owner;
        ``create_member`` must already have run on ``new``'s owner."""
        self._root("join", parent)
        a = self.actors[parent]
        a.start_insert(new, SCSL)
        a.start_insert(new, SNSL)

    def signal(self, rank: int) -> None:
        self._root("signal", rank)
        t0 = time.perf_counter()
        self.actors[rank].local_signal()
        self.watermarks.add_signal_time(rank, time.perf_counter() - t0)

    def drop(self, rank: int) -> None:
        self._root("evict", rank)
        self.actors[rank].local_drop()
        self.demoted.discard(rank)

    def demote(self, rank: int) -> None:
        assert self.lists_done(rank), rank
        self._root("demote", rank)
        self.demoted.add(rank)
        self.actors[rank].local_demote()

    def repromote(self, rank: int) -> None:
        self._root("repromote", rank)
        self.demoted.discard(rank)
        self.actors[rank].local_promote_to(self.height_of(rank))

    def released(self) -> int:
        if HEAD in self.actors:
            return self.actors[HEAD].head_released
        for k in sorted(self.actors):
            a = self.actors[k]
            if a.sn.member and not a.sn.departed:
                return a.sn.released
        return -1

    # ---------------------------------------------------------- membership
    def note_membership(self, live: Iterable[int],
                        demoted: Iterable[int]) -> None:
        """Install the replicated membership view (broadcast by the
        coordinator after each structural op reaches quiescence)."""
        gone = self.live - set(live)
        self.net.dropped |= gone
        self.live = set(live)
        self.demoted = set(demoted)
        for k in self.live:
            self.modes.setdefault(k, SIG_WAIT)
        self.flight.event("membership", live=sorted(self.live),
                          gone=sorted(gone))

    # ---------------------------------------------------------- recovery
    def rebuild(self, live: Iterable[int], demoted: Iterable[int],
                phase: int, gen: int) -> None:
        """Non-cooperative eviction (DESIGN.md §13): a host died without
        running the demote→evict protocol, so its actors can never
        answer the unlink handshakes. Instead of forging the dead
        owner's messages, every survivor re-seeds its shard from the
        oracle of the surviving membership — the same ``_init_list``
        path boot uses, fast-forwarded to open at ``phase + 1`` (the
        first phase HEAD has not released). In-flight envelopes of the
        old incarnation are discarded here (their spans close as
        blackholed) and fenced at ingest by the ``gen`` stamp."""
        gone = self.live - set(live)
        self.net.dropped |= gone
        self.live = set(live)
        self.demoted = set(demoted)
        for k in self.live:
            self.modes.setdefault(k, SIG_WAIT)
        # the tracker survives rebuild: watermarks are monotone across
        # generations (the rebuilt incarnation opens at phase + 1, which
        # is >= every previously observed watermark)
        self.watermarks.gen = gen
        self.flight.event("rebuild", gen=gen, phase=phase,
                          live=sorted(self.live), gone=sorted(gone))
        # drop the old incarnation's in-flight frames, closing spans so
        # the causal trees stay complete
        for q in self.net.channels.values():
            for env in q:
                self.net._blackhole(env)
        self.net.channels.clear()
        self.net.gen = gen
        self.gen = gen
        # flight counters restart at zero on every survivor at the same
        # recovery point: the Mattern balance is re-founded for the new
        # incarnation (the dead host's counters are unknowable)
        self.net.remote_sent = 0
        self.net.remote_received = 0
        self.net.actors.clear()
        self.actors.clear()
        self.async_parent.clear()
        start = phase + 1
        local = [k for k in sorted(self.live) if self.owner_of(k) == self.pid]
        if self.owner_of(HEAD) == self.pid:
            local = [HEAD] + local
        for k in local:
            a = PhaserActor(k, self.net, self.modes.get(k, SIG_WAIT),
                            phaser=self)
            a.sig_next = start
            a.wait_next = start
            self.actors[k] = a
            self.net.register(a)
        sig = [k for k in sorted(self.live)
               if self.modes[k] in (SIG_MODE, SIG_WAIT)]
        wait = [k for k in sorted(self.live)
                if self.modes[k] in (WAIT_MODE, SIG_WAIT)]
        self._init_list(SCSL, sig, phase_start=start)
        self._init_list(SNSL, wait, phase_start=start)
        if HEAD in self.actors:
            head = self.actors[HEAD]
            head.expected_base = len(sig)
            head.head_released = phase

    # ---------------------------------------------------------- pumping
    def pump(self) -> int:
        """Ingest every queued transport envelope, then deliver local
        messages to local idleness. Returns deliveries made."""
        moved = 0
        while True:
            frame = self.net.endpoint.recv(timeout=0)
            if frame is None:
                break
            src, tag, payload = frame
            if tag == "red":
                self.stray.append(frame)   # a peer's step round: held
                continue
            if tag in ("ctl", "hb"):
                continue                   # stale control frames
            if tag == "cmd":
                # A retransmitted/duplicated command raced into the inbox
                # while we were servicing another op: park it for the
                # worker main loop (which dedupes by command id).
                self.stray.append(frame)
                continue
            assert tag == "env", f"unexpected {tag} frame in pump"
            self.net.ingest(payload)
        moved += self.net.deliver_all()
        return moved

    def drain_stray(self) -> List:
        out, self.stray = self.stray, []
        return out

    def flight_counters(self) -> Tuple[int, int]:
        return self.net.remote_sent, self.net.remote_received
