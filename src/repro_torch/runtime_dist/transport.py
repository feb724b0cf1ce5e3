"""Message transports for the multi-process control plane.

The phaser protocol only assumes point-to-point FIFO channels
(``core/runtime.py``); crossing a process boundary therefore needs just
one primitive: an ordered, typed frame stream between two process ids.
Two fabrics provide it:

* ``InprocFabric``  — N *logical* processes inside one OS process, with
  instant delivery into per-endpoint deques. Deterministic (no threads,
  no sockets), so tier-1 tests drive real partitioned control-plane
  code without subprocess machinery.
* ``SocketFabric``  — real OS processes over ``multiprocessing
  .connection`` AF_UNIX sockets. Every endpoint owns a listener at a
  path derived from its pid, so the address book is implicit: any
  process can reach any other from ``(directory, pid)`` alone —
  arrivals (elastic joins) need no address gossip. Connections are
  lazy and unidirectional (one per ordered (src, dst) pair, preserving
  the per-channel FIFO the protocol assumes); a reader thread per
  connection feeds one inbound queue.

Frames are ``(src, tag, payload)``; tags in use: ``"env"`` (a protocol
``Envelope``), ``"cmd"``/``"rep"`` (coordinator RPC), ``"red"``
(data-plane reduction buffers), ``"hb"`` (heartbeat, echoed by the
reader thread), ``"ctl"`` (out-of-band step control, e.g. abort),
``"hello"`` (stream header).

Session layer (DESIGN.md §15): the socket fabrics (AF_UNIX and TCP)
wrap every stream in a partition-tolerant session so the channel
abstraction above survives *connection* failure, not just process
failure. Per ordered (src, dst) channel: ``env`` frames carry monotone
sequence numbers and sit in a bounded resend ring until a cumulative
ack (piggybacked on every reverse frame, topped up by standalone
``ack`` frames) covers them; every frame is CRC-framed so a torn read
is dropped unparsed (and the stream cut, forcing a replay) instead of
deserialized; a (re)connect replays everything past the last acked
seq and the receiver dedupes by seq — exactly-once, in-order envelope
delivery re-established after any reset or healed partition. Counters:
``transport.session.{resets,replays,dupes_dropped,crc_drops,...}``.

Reading a frame (the port's one change to this layer): the stdlib's
``Connection.recv_bytes`` asks the kernel for every byte still missing
on each read, and on some hosts each such read costs time in proportion
to that count, so a frame's receive time grows with the square of its
size (a 539 MB gradient buffer: 110 s on the H100 machine, against 0.6
s in bounded reads). ``_recv_msg`` reads the same length-prefixed
message in bounded pieces. The bytes on the wire are unchanged: senders
still use ``Connection.send_bytes``.

``TcpEndpoint`` is the same machinery over AF_INET: each endpoint
binds an ephemeral TCP port and advertises ``host:port`` in a registry
file (``ep<pid>.addr``) in the fabric dir — the address book stays
derivable from ``(directory, pid)`` exactly like the AF_UNIX paths.

Chaos layer (DESIGN.md §13): ``ChaosConfig`` + ``FaultyInprocFabric`` /
``FaultyEndpoint`` decorate the two fabrics with a *seeded, per-(src,
dst)* fault policy. Faults are injected only where a recovery mechanism
exists for them:

* RPC frames (``cmd``/``rep``/``hb``) may be dropped or duplicated —
  retry with idempotent command ids recovers both;
* protocol envelopes (``env``) may be *delayed and reordered across
  channels* but never dropped or duplicated within a live channel: the
  protocol's SIG counting has no retransmission and is not
  duplication-safe, and per-(src, dst) FIFO is its only ordering
  assumption — so injection queues later frames of a delayed channel
  behind the delayed head (FIFO preserved end to end), and only frames
  addressed to a *dead* endpoint are dropped (counted, and their spans
  closed as blackholed through the ``reaper`` hook);
* link-level faults the RPC layer can't paper over: seeded connection
  resets (``p_reset``: the cached stream is torn down mid-traffic, the
  session layer must reconnect + replay) and ``LinkFault`` windows —
  symmetric partitions and one-way link kills between pid sets for a
  bounded wall-clock window, enforced at the *sender's* transmit edge
  (``chaos.link_blocked``), so a heal needs no connectivity to take
  effect;
* hard crash: ``SocketCluster.kill_pid`` (SIGKILL, no cleanup) and
  ``InprocCluster.kill_host`` (simulated crash-stop).

Every injected fault lands in the metrics registry / fault counters so
it stays attributable next to the span traces.
"""
from __future__ import annotations

import os
import pickle
import queue
import random
import struct
import tempfile
import threading
import time
import zlib
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from .failure import PeerUnreachable

Frame = Tuple[int, str, Any]  # (src pid, tag, payload)

# tags a retry + idempotency layer recovers: safe to drop/duplicate
RPC_TAGS = ("cmd", "rep", "hb")

# tags the session layer sequences, rings, replays and dedupes: the
# protocol envelopes, whose SIG counting is neither loss- nor
# duplication-safe, and step control — the ``ctl`` abort is what
# unwinds a worker blocked in an in-step exchange, so it must survive
# the very partition that caused the abort (a lost abort leaves the
# partitioned worker pinned on its in-step recv deadline, and the
# coordinator's resolve probe pinned behind it). RPC frames keep their
# own retry+cid-dedupe layer, ``red`` rounds their own step
# abort/retry, heartbeats are ephemeral.
SESSION_TAGS = ("env", "ctl")


@dataclass(frozen=True)
class ChaosConfig:
    """Seeded fault policy; every rate is per-frame, per ordered
    (src, dst) channel (each channel owns a derived rng, so one
    channel's draws never perturb another's — runs are reproducible
    under membership churn)."""

    seed: int = 0
    p_drop: float = 0.05      # RPC frames only
    p_dup: float = 0.02       # RPC frames only
    p_delay: float = 0.2      # env frames: probability of entering limbo
    delay_ticks: int = 3      # inproc: max extra delivery ticks
    max_delay: float = 0.05   # socket: max extra seconds in limbo
    p_reset: float = 0.0      # socket: per-frame connection reset (the
    #                           cached stream is hard-closed; the session
    #                           layer must reconnect and replay). Drawn
    #                           only when > 0, so existing seeds keep
    #                           their exact fault sequences.

    def rng(self, src: int, dst: int) -> random.Random:
        return random.Random((self.seed * 1_000_003
                              + (src + 7) * 8191 + (dst + 7)) & 0x7FFFFFFF)


@dataclass(frozen=True)
class LinkFault:
    """One link-level fault window: frames from ``a`` to ``b`` (and,
    unless ``oneway``, from ``b`` to ``a``) are blocked while
    ``t1 <= now < t2`` (``time.monotonic()``, evaluated locally at the
    enforcing endpoint — windows need no shared clock, each endpoint
    computes its own from the install moment)."""

    a: frozenset
    b: frozenset
    t1: float
    t2: float
    oneway: bool = False

    def blocks(self, src: int, dst: int, now: float) -> bool:
        if not (self.t1 <= now < self.t2):
            return False
        if src in self.a and dst in self.b:
            return True
        return (not self.oneway) and src in self.b and dst in self.a


def parse_link_spec(spec: str) -> List[Dict]:
    """``"1|0,2@3+1.5;0->2@5+0.5"`` -> fault dicts for the launcher.

    Each item is ``A|B@STEP+DUR`` (symmetric partition between pid sets
    A and B) or ``A->B@STEP+DUR`` (one-way link kill: A's frames to B
    are dropped, B's to A still flow). Pid sets are comma-separated
    ints (``-1``/``coord`` is the coordinator) or ``*`` = everyone
    else. The window activates at the STEP boundary and heals DUR
    seconds later — heal is a local timer at every endpoint, so it
    fires even while the partition blocks the control plane."""

    def pids(s: str):
        s = s.strip()
        if s == "*":
            return None                      # "everyone else"
        return sorted({-1 if x.strip() in ("coord", "-1") else int(x)
                       for x in s.split(",")})

    faults = []
    for item in spec.split(";"):
        item = item.strip()
        if not item:
            continue
        body, at = item.rsplit("@", 1)
        step_s, dur_s = at.split("+", 1)
        oneway = "->" in body
        a, b = body.split("->" if oneway else "|", 1)
        if pids(a) is None:
            raise ValueError(f"link fault {item!r}: '*' only on the "
                             "right side")
        faults.append({"a": pids(a), "b": pids(b), "step": int(step_s),
                       "dur": float(dur_s), "oneway": oneway})
    return faults


# ---------------------------------------------------------------------------
class Endpoint:
    """One process's port on a fabric."""

    def __init__(self, pid: int):
        self.pid = pid
        self.frames_sent = 0
        self.frames_received = 0

    def send(self, dst: int, tag: str, payload: Any) -> None:
        raise NotImplementedError

    def recv(self, timeout: Optional[float] = None) -> Optional[Frame]:
        """Next inbound frame, or None on timeout (timeout=0: poll)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# In-process fabric (deterministic, single-threaded)
# ---------------------------------------------------------------------------
class InprocEndpoint(Endpoint):
    def __init__(self, pid: int, fabric: "InprocFabric"):
        super().__init__(pid)
        self.fabric = fabric
        self.inbox: deque = deque()

    def send(self, dst: int, tag: str, payload: Any) -> None:
        self.frames_sent += 1
        self.fabric.transmit(self.pid, dst, tag, payload)

    def recv(self, timeout: Optional[float] = None) -> Optional[Frame]:
        if not self.inbox:
            return None  # same thread: nothing can arrive while we wait
        self.frames_received += 1
        return self.inbox.popleft()


class InprocFabric:
    """All endpoints share one OS process; delivery is an append."""

    def __init__(self):
        self.endpoints: Dict[int, InprocEndpoint] = {}
        self.removed: set = set()         # pids that once had an endpoint
        self.faults: Dict[str, int] = defaultdict(int)
        # span-close hook for frames swallowed at the fabric (dead
        # destination): the coordinator wires this to its tracer so the
        # causal tree never dangles
        self.reaper: Optional[Callable[[Any, str], Any]] = None

    def endpoint(self, pid: int) -> InprocEndpoint:
        assert pid not in self.endpoints, pid
        ep = InprocEndpoint(pid, self)
        self.endpoints[pid] = ep
        self.removed.discard(pid)
        return ep

    def drop_endpoint(self, pid: int) -> None:
        if self.endpoints.pop(pid, None) is not None:
            self.removed.add(pid)

    def _reap(self, tag: str, payload: Any) -> None:
        self.faults["dead_dropped"] += 1
        if self.reaper is not None:
            self.reaper(payload, tag)

    def transmit(self, src: int, dst: int, tag: str, payload: Any) -> None:
        ep = self.endpoints.get(dst)
        if ep is None:
            # crash-stop semantics: frames to a dead host vanish —
            # counted, never raised (the sender may not know yet)
            assert dst in self.removed, f"send to unknown pid {dst}"
            self._reap(tag, payload)
            return
        ep.inbox.append((src, tag, payload))

    def pending(self) -> int:
        return sum(len(ep.inbox) for ep in self.endpoints.values())

    def tick(self) -> int:
        return 0    # no time-based state in the fault-free fabric


class FaultyInprocFabric(InprocFabric):
    """Seeded delay/reorder-across-channels for the in-process fabric.

    Only ``env`` frames ride this fabric (in-proc RPC is a direct
    call), so the injected fault is exactly the one the protocol must
    tolerate: a channel's frames go into *limbo* for a bounded number
    of delivery ticks, later frames on the same channel queue behind
    the delayed head (per-channel FIFO preserved), while other
    channels' frames overtake freely. Deterministic in (seed, traffic).
    """

    def __init__(self, chaos: ChaosConfig):
        super().__init__()
        self.chaos = chaos
        self._rngs: Dict[Tuple[int, int], random.Random] = {}
        # (src, dst) -> deque of [release_tick, tag, payload]
        self.limbo: Dict[Tuple[int, int], deque] = defaultdict(deque)
        self._tick = 0

    def _rng(self, src: int, dst: int) -> random.Random:
        key = (src, dst)
        if key not in self._rngs:
            self._rngs[key] = self.chaos.rng(src, dst)
        return self._rngs[key]

    def transmit(self, src: int, dst: int, tag: str, payload: Any) -> None:
        self._tick += 1
        ch = (src, dst)
        q = self.limbo[ch]
        rng = self._rng(src, dst)
        delay = rng.random() < self.chaos.p_delay
        if q or delay:
            release = self._tick + (rng.randint(1, self.chaos.delay_ticks)
                                    if delay else 0)
            if q:
                release = max(release, q[-1][0])   # never overtake the head
            q.append([release, tag, payload])
            self.faults["delayed"] += 1
        else:
            super().transmit(src, dst, tag, payload)
        self._release_due()

    def _release_due(self) -> int:
        n = 0
        for ch in sorted(k for k, q in self.limbo.items() if q):
            q = self.limbo[ch]
            while q and q[0][0] <= self._tick:
                _, tag, payload = q.popleft()
                super().transmit(ch[0], ch[1], tag, payload)
                n += 1
                self.faults["released"] += 1
        return n

    def tick(self) -> int:
        """Advance fabric time without traffic (quiescence driver):
        limbo frames come due even when nobody is sending."""
        self._tick += 1
        return self._release_due()

    def drop_endpoint(self, pid: int) -> None:
        super().drop_endpoint(pid)
        for ch in list(self.limbo):
            if ch[1] == pid:
                for _, tag, payload in self.limbo.pop(ch):
                    self._reap(tag, payload)

    def pending(self) -> int:
        return super().pending() + sum(len(q) for q in self.limbo.values())


# ---------------------------------------------------------------------------
# Socket fabrics (real processes): AF_UNIX and TCP over one session layer
# ---------------------------------------------------------------------------
def fabric_dir() -> str:
    return tempfile.mkdtemp(prefix="phaser-fabric-")


def _sock_path(directory: str, pid: int) -> str:
    return os.path.join(directory, f"ep{pid}.sock")


def _addr_path(directory: str, pid: int) -> str:
    return os.path.join(directory, f"ep{pid}.addr")


def _pack_frame(seq: int, ack: int, tag: str, payload: Any) -> bytes:
    """Wire format: 4-byte big-endian CRC32 over the pickled
    ``(seq, ack, tag, payload)`` body. ``seq`` is 0 for unsequenced
    tags; ``ack`` is the sender's highest contiguously-delivered seq on
    the reverse channel (cumulative ack, piggybacked on every frame)."""
    blob = pickle.dumps((seq, ack, tag, payload),
                        protocol=pickle.HIGHEST_PROTOCOL)
    return struct.pack(">I", zlib.crc32(blob)) + blob


_READ_CHUNK = 1 << 22       # bytes asked of the kernel per read


def _read_exact(fd: int, view: memoryview, *, first: bool = False) -> None:
    """Fill ``view`` from ``fd`` in reads of at most ``_READ_CHUNK``.
    EOF before the first byte of a message (``first``) is ``EOFError``,
    later an ``OSError``, as ``Connection.recv_bytes`` raises them."""
    pos = 0
    while pos < len(view):
        n = os.readv(fd, [view[pos:pos + _READ_CHUNK]])
        if n == 0:
            if first and pos == 0:
                raise EOFError
            raise OSError("got end of file during message")
        pos += n


def _recv_msg(conn) -> bytearray:
    """``conn.recv_bytes()`` in bounded reads: a 4-byte big-endian length
    (-1, then an 8-byte one, past 2 GiB), then the body."""
    fd = conn.fileno()
    head = bytearray(4)
    _read_exact(fd, memoryview(head), first=True)
    (size,) = struct.unpack("!i", head)
    if size == -1:
        head = bytearray(8)
        _read_exact(fd, memoryview(head))
        (size,) = struct.unpack("!Q", head)
    body = bytearray(size)
    _read_exact(fd, memoryview(body))
    return body


def _unpack_frame(buf: bytes):
    """``(seq, ack, tag, payload)``, or None for a torn/corrupt frame —
    the body is never unpickled unless the CRC matches, so garbage on
    the wire cannot reach the deserializer."""
    if len(buf) < 5:
        return None
    (want,) = struct.unpack(">I", buf[:4])
    blob = buf[4:]
    if zlib.crc32(blob) != want:
        return None
    try:
        return pickle.loads(blob)
    except Exception:
        return None


class _SendSession:
    """Sender half of one ordered (self, dst) channel: monotone seq
    assignment and the bounded resend ring of unacked frames."""

    __slots__ = ("lock", "seq", "acked", "ring", "touched", "wired")

    def __init__(self):
        self.lock = threading.Lock()
        self.seq = 0            # last assigned
        self.acked = 0          # highest cumulative ack from the peer
        self.ring: deque = deque()   # (seq, tag, payload), unacked
        self.touched = time.monotonic()  # last send or ack progress
        self.wired = 0          # highest seq ever attempted on a wire
        #                         (distinguishes a true retransmission
        #                          from a first send riding a replay)

    def unacked(self) -> int:
        with self.lock:
            return sum(1 for f in self.ring if f[0] > self.acked)


class _RecvSession:
    """Receiver half: dedupe-by-seq watermark + standalone-ack pacing."""

    __slots__ = ("delivered", "since_ack")

    def __init__(self):
        self.delivered = 0      # highest contiguously delivered seq
        self.since_ack = 0      # sequenced receipts since the last ack


class SocketEndpoint(Endpoint):
    """AF_UNIX endpoint: own listener + lazy outbound connections, with
    the partition-tolerant session layer (DESIGN.md §15) underneath.

    ``hb_echo=True`` (worker side) makes the *reader thread* echo
    heartbeat frames back to their source — liveness is then a
    transport property, independent of how long the main loop spends
    inside a command (a multi-second model build must not look like a
    death), while a SIGKILL stops the reader and therefore the echoes.
    ``last_rx`` timestamps every arrival, so an orphaned worker can
    notice its coordinator went silent.

    Session layer: ``env`` frames get per-(src, dst) monotone seqs and
    sit in a bounded resend ring until the peer's cumulative ack covers
    them; any (re)connect replays the unacked suffix and the receiver
    dedupes by seq, so a connection reset or healed partition never
    loses or duplicates an envelope. A blocked/undeliverable ``env`` is
    *deferred* (kept in the ring, flushed by a background thread once
    the peer is reachable) rather than surfaced — the layers above keep
    their reliable-FIFO channel assumption. Frames reaped for good
    (eviction via ``forget_peer``, ring overflow) go through ``reaper``
    so their spans still close.
    """

    def __init__(self, pid: int, directory: str, *, metrics=None,
                 hb_echo: bool = False, ack_every: int = 64,
                 ring_cap: int = 4096):
        super().__init__(pid)
        self.directory = directory
        self.metrics = metrics
        self.hb_echo = hb_echo
        self.last_rx = time.monotonic()
        self._ack_every = ack_every
        self._ring_cap = ring_cap
        self._probe_after = 1.0   # unacked-and-silent before probing
        self.reaper: Optional[Callable[[Any, str], Any]] = None
        self._listener = self._make_listener()
        self._inbox: "queue.Queue[Frame]" = queue.Queue()
        self._out: Dict[int, Any] = {}
        self._ever: set = set()          # dsts we once connected to
        self._down: Dict[int, float] = {}  # dst -> last connect failure
        self._down_ttl = 1.0
        self._locks: Dict[int, threading.Lock] = {}
        self._locks_guard = threading.Lock()
        self._send_s: Dict[int, _SendSession] = {}
        self._recv_s: Dict[int, _RecvSession] = {}
        self._rs_guard = threading.Lock()
        self._links: List[LinkFault] = []
        self._dirty: set = set()         # dsts with deferred ring frames
        self._accepted: List[Any] = []   # inbound conns, severed on close
        self._closed = False
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        self._flush_thread = threading.Thread(target=self._flush_loop,
                                              daemon=True)
        self._flush_thread.start()

    # -- address family hooks (overridden by TcpEndpoint) -------------------
    def _make_listener(self):
        from multiprocessing.connection import Listener
        self.path = _sock_path(self.directory, self.pid)
        return Listener(self.path, "AF_UNIX")

    def _dial(self, dst: int):
        from multiprocessing.connection import Client
        return Client(_sock_path(self.directory, dst), "AF_UNIX")

    def _inc(self, name: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.inc(name, n)

    # -- link faults (chaos) -------------------------------------------------
    def add_link_fault(self, a, b, t1: float, t2: float, *,
                       oneway: bool = False) -> None:
        self._links.append(LinkFault(frozenset(a), frozenset(b),
                                     t1, t2, oneway))

    def clear_link_faults(self) -> None:
        self._links = []

    def _blocked(self, dst: int) -> bool:
        if not self._links:
            return False
        now = time.monotonic()
        live = [f for f in self._links if now < f.t2]
        if len(live) != len(self._links):
            self._links = live          # expired windows fall away
        return any(f.blocks(self.pid, dst, now) for f in live)

    # -- sessions ------------------------------------------------------------
    def set_reaper(self, fn: Callable[[Any, str], Any]) -> None:
        self.reaper = fn

    def _send_session(self, dst: int) -> _SendSession:
        with self._locks_guard:
            ss = self._send_s.get(dst)
            if ss is None:
                ss = self._send_s[dst] = _SendSession()
            return ss

    def _ack_for(self, src: int) -> int:
        with self._rs_guard:
            rs = self._recv_s.get(src)
            return rs.delivered if rs is not None else 0

    def _note_ack(self, src: int, ack: int) -> None:
        ss = self._send_s.get(src)
        if ss is None:
            return
        with ss.lock:
            if ack > ss.acked:
                ss.acked = ack
                ss.touched = time.monotonic()
                while ss.ring and ss.ring[0][0] <= ack:
                    ss.ring.popleft()
                if not ss.ring:
                    self._dirty.discard(src)

    def _reap(self, tag: str, payload: Any) -> None:
        if self.reaper is not None:
            try:
                self.reaper(payload, tag)
            except Exception:
                pass            # span salvage is best effort

    def session_stats(self) -> Dict[str, int]:
        """Introspection for tests/benches: unacked frames per ring."""
        return {dst: ss.unacked() for dst, ss in self._send_s.items()}

    # -- inbound ------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):
                return
            self._accepted.append(conn)
            threading.Thread(target=self._read_loop, args=(conn,),
                             daemon=True).start()

    def _read_loop(self, conn) -> None:
        try:
            msg = _unpack_frame(_recv_msg(conn))
            if msg is None or msg[2] != "hello" \
                    or not isinstance(msg[3], int):
                # malformed or half-open connect: reject the stream
                # gracefully instead of dying on an assertion — the
                # accept loop (and every other reader) keeps running
                self._inc("transport.bad_hello")
                return
            src = msg[3]
            while True:
                msg = _unpack_frame(_recv_msg(conn))
                if msg is None:
                    # torn/corrupt frame: dropped unparsed; cutting the
                    # stream makes the peer reconnect and replay from
                    # the last acked seq (dropped-and-resent, never
                    # deserialized)
                    self._inc("transport.session.crc_drops")
                    return
                seq, ack, tag, payload = msg
                self.last_rx = time.monotonic()
                if ack:
                    self._note_ack(src, ack)
                if seq:
                    want_ack = dup = False
                    with self._rs_guard:
                        rs = self._recv_s.get(src)
                        if rs is None:
                            rs = self._recv_s[src] = _RecvSession()
                        if seq <= rs.delivered:
                            dup = True
                        else:
                            if seq != rs.delivered + 1:
                                # only possible after a ring-overflow
                                # eviction upstream: counted, not hidden
                                self._inc("transport.session.gaps",
                                          seq - rs.delivered - 1)
                            rs.delivered = seq
                            rs.since_ack += 1
                            if rs.since_ack >= self._ack_every:
                                rs.since_ack = 0
                                want_ack = True
                            # claim + enqueue under one lock: overlapping
                            # old/new streams from the same src stay FIFO
                            self._inbox.put((src, tag, payload))
                    if dup:
                        # a replay the previous stream already delivered:
                        # dropped (exactly-once by seq dedupe), but
                        # re-acked so the sender's stale ring drains
                        self._inc("transport.session.dupes_dropped")
                        want_ack = True
                    else:
                        self._inc("transport.session.delivered")
                    if want_ack:
                        # reverse traffic may be sparse (one-way env
                        # fan-out): top up the piggybacked acks so the
                        # peer's ring drains
                        try:
                            self.send(src, "ack", None)
                        except (PeerUnreachable, OSError, ValueError):
                            pass
                    continue
                if tag == "ack":
                    continue    # carried its ack field; nothing to queue
                if tag == "hb" and self.hb_echo:
                    # echo from the reader thread: never blocks on the
                    # main loop, dies with the process on SIGKILL
                    try:
                        self.send(src, "hb", payload)
                    except PeerUnreachable:
                        # _connect already stamped the negative cache
                        # (or short-circuited off it): re-stamping here
                        # would make the cache self-renewing and a
                        # healed coordinator unreachable forever
                        pass
                    except (OSError, ValueError):
                        # socket-level send failure: stamp the negative
                        # cache so subsequent heartbeats short-circuit
                        # instead of paying a full connect backoff
                        # each (the orphan timer is the recovery path)
                        self._down[src] = time.monotonic()
                    continue
                self._inbox.put((src, tag, payload))
        except (EOFError, OSError):
            pass
        except (TypeError, ValueError):
            # Connection isn't thread-safe against concurrent close():
            # a blocked recv raced by close() (endpoint shutdown) dies
            # with a TypeError from the nulled handle, not an OSError
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def recv(self, timeout: Optional[float] = None) -> Optional[Frame]:
        try:
            if timeout == 0:
                frame = self._inbox.get_nowait()
            else:
                frame = self._inbox.get(timeout=timeout)
        except queue.Empty:
            return None
        self.frames_received += 1
        return frame

    # -- outbound -----------------------------------------------------------
    def _lock_for(self, dst: int) -> threading.Lock:
        with self._locks_guard:
            if dst not in self._locks:
                self._locks[dst] = threading.Lock()
            return self._locks[dst]

    def _connect(self, dst: int, timeout: float = 30.0):
        """Exponential backoff + jitter up to ``timeout``; raises a
        structured ``PeerUnreachable`` (not a bare TimeoutError) so
        callers can attribute the failure to a pid. A *re*connect (the
        peer was reachable before, so a refusal means it died, not
        that it is still booting) gets a short deadline, and a recent
        failure short-circuits entirely — a signal fan-out to a dead
        peer must not stall the survivor once per frame."""
        down_at = self._down.get(dst)
        if down_at is not None:
            if time.monotonic() - down_at < self._down_ttl:
                self._inc("transport.connect_shortcircuit")
                raise PeerUnreachable(dst, 0, 0.0)
            self._down.pop(dst, None)
        if dst in self._ever:
            timeout = min(timeout, 1.0)
        t0 = time.monotonic()
        deadline = t0 + timeout
        attempts = 0
        delay = 0.005
        rng = random.Random((self.pid + 7) * 131 + dst)
        while True:
            attempts += 1
            self._inc("transport.connect_attempts")
            try:
                conn = self._dial(dst)
                break
            except (FileNotFoundError, ConnectionRefusedError, OSError):
                now = time.monotonic()
                if now > deadline:
                    self._inc("transport.connect_failures")
                    self._down[dst] = now
                    raise PeerUnreachable(dst, attempts, now - t0)
                time.sleep(min(delay * (1 + rng.random()),
                               max(0.0, deadline - now)))
                delay = min(delay * 1.6, 0.25)
        conn.send_bytes(_pack_frame(0, 0, "hello", self.pid))
        self._ever.add(dst)
        return conn

    def _replay(self, dst: int, conn) -> None:
        """(Re)transmit every unacked sequenced frame to a fresh stream
        — reconnect-and-replay from the last acked seq. The receiver's
        seq dedupe drops whatever the dead stream already delivered.
        Only frames previously attempted on a wire count as replays;
        deferred frames getting their first transmission here don't."""
        ss = self._send_s.get(dst)
        if ss is None:
            return
        with ss.lock:
            frames = [f for f in ss.ring if f[0] > ss.acked]
            wired_before = ss.wired
            if frames:
                ss.wired = max(ss.wired, frames[-1][0])
        for seq, tag, payload in frames:
            conn.send_bytes(_pack_frame(seq, self._ack_for(dst), tag,
                                        payload))
        redone = sum(1 for f in frames if f[0] <= wired_before)
        if redone:
            self._inc("transport.session.replays", redone)

    def _drop_conn(self, dst: int, conn) -> None:
        self._out.pop(dst, None)
        try:
            conn.close()
        except OSError:
            pass

    def _transmit(self, dst: int, seq: int, tag: str,
                  payload: Any) -> None:
        """One framed message out, (re)establishing the stream (and
        replaying the unacked ring suffix) as needed. Caller holds the
        dst connection lock."""
        if self._blocked(dst):
            # link fault window: emulate the partition by tearing the
            # cached stream down once and refusing to transmit
            conn = self._out.pop(dst, None)
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
                self._inc("chaos.link_cut")
            self._inc("chaos.link_blocked")
            raise PeerUnreachable(dst, 0, 0.0)
        short = tag in ("hb", "ack")    # periodic/advisory: fail fast
        conn = self._out.get(dst)
        if conn is None:
            # fresh stream: everything unacked (the current sequenced
            # frame included — it is already in the ring) rides the
            # replay; only unsequenced frames need a direct send
            conn = self._connect(dst, timeout=(0.2 if short else 30.0))
            try:
                self._replay(dst, conn)
                if not seq:
                    conn.send_bytes(_pack_frame(0, self._ack_for(dst),
                                                tag, payload))
            except (OSError, ValueError):
                self._drop_conn(dst, conn)
                self._inc("transport.send_failures")
                raise
            self._out[dst] = conn
            return
        if seq:
            ss = self._send_s.get(dst)
            if ss is not None:
                with ss.lock:
                    ss.wired = max(ss.wired, seq)   # attempt recorded
        try:
            conn.send_bytes(_pack_frame(seq, self._ack_for(dst), tag,
                                        payload))
        except (OSError, ValueError):
            # connection reset mid-stream: drop the dead conn, dial
            # once more and replay from the last acked seq — the
            # current frame, if sequenced, is already in the ring and
            # rides the replay
            self._inc("transport.session.resets")
            self._drop_conn(dst, conn)
            conn = self._connect(dst, timeout=(0.2 if short else 1.0))
            try:
                self._replay(dst, conn)
                if not seq:
                    conn.send_bytes(_pack_frame(0, self._ack_for(dst),
                                                tag, payload))
            except (OSError, ValueError):
                self._drop_conn(dst, conn)
                self._inc("transport.send_failures")
                raise
            self._out[dst] = conn

    def send(self, dst: int, tag: str, payload: Any) -> None:
        # per-destination lock: the heartbeat thread and the main loop
        # share outbound connections, and Connection.send is not atomic
        with self._lock_for(dst):
            seq = 0
            if tag in SESSION_TAGS:
                ss = self._send_session(dst)
                with ss.lock:
                    ss.seq += 1
                    seq = ss.seq
                    ss.touched = time.monotonic()
                    ss.ring.append((seq, tag, payload))
                    while len(ss.ring) > self._ring_cap:
                        # replay-window bound: the oldest unacked frame
                        # can no longer be resent — reaped, its span
                        # closed, the receiver counts the gap
                        _, t, p = ss.ring.popleft()
                        self._inc("transport.session.ring_evict")
                        self._reap(t, p)
                self._inc("transport.session.seq_assigned")
            try:
                self._transmit(dst, seq, tag, payload)
            except (PeerUnreachable, OSError, ValueError):
                if seq:
                    # the frame stays in the resend ring: the flusher
                    # (or the next successful send) replays it once the
                    # peer is reachable again — an envelope is never
                    # lost to a reset or a transient partition
                    self._inc("transport.session.deferred")
                    self._dirty.add(dst)
                    return
                raise
        self.frames_sent += 1

    def _flush_loop(self) -> None:
        """Background session maintenance, three duties per tick:

        * flush pending receiver acks (ack_every paces bursts, but a
          trickle below the threshold must still ack within a tick so
          peer rings drain);
        * retry deferred (dirty) channels — a one-way envelope channel
          with no reverse traffic to ride on must still replay once a
          partition heals or the peer comes back;
        * probe channels whose unacked frames went stale: a send into a
          freshly-reset TCP stream can succeed into the kernel buffer
          and vanish, with the error surfacing only on the *next* write
          — the probe is that next write, provoking the reset detection
          (and thus reconnect-and-replay) even when the application has
          gone quiet.
        """
        while not self._stop.wait(0.2):
            with self._rs_guard:
                owed = [(src, rs.delivered)
                        for src, rs in self._recv_s.items()
                        if rs.since_ack > 0]
            for src, seen in owed:
                try:
                    self.send(src, "ack", None)
                except (PeerUnreachable, OSError, ValueError):
                    continue
                with self._rs_guard:
                    rs = self._recv_s.get(src)
                    if rs is not None and rs.delivered == seen:
                        rs.since_ack = 0
            now = time.monotonic()
            for dst, ss in list(self._send_s.items()):
                stale = (ss.unacked() > 0
                         and now - ss.touched > self._probe_after)
                if not (stale or dst in self._dirty):
                    continue
                lk = self._lock_for(dst)
                if not lk.acquire(blocking=False):
                    continue
                try:
                    self._transmit(dst, 0, "ack", None)
                    self._dirty.discard(dst)
                    self._inc("transport.session.flushes")
                except (PeerUnreachable, OSError, ValueError):
                    pass        # still unreachable: retry next tick
                finally:
                    lk.release()

    # -- chaos hooks ---------------------------------------------------------
    def inject_reset(self, dst: int) -> bool:
        """Hard-close the cached outbound stream *without* forgetting it:
        the peer sees EOF, and our next send hits the dead conn —
        exercising the reset-detect + reconnect-and-replay path."""
        with self._lock_for(dst):
            conn = self._out.get(dst)
            if conn is None:
                return False
            try:
                conn.close()
            except OSError:
                pass
        self._inc("chaos.reset_inject")
        return True

    def _send_corrupt(self, dst: int) -> None:
        """Chaos/test hook: emit a deliberately torn frame (CRC cannot
        match) on the cached stream — the receiver must drop it unparsed
        and cut the stream."""
        with self._lock_for(dst):
            conn = self._out.get(dst)
            if conn is None:
                conn = self._connect(dst)
                self._out[dst] = conn
            conn.send_bytes(b"\x00\x00\x00\x00not-a-frame")

    # -- lifecycle -----------------------------------------------------------
    def forget_peer(self, dst: int) -> None:
        """Drop the cached outbound connection AND the session state for
        an evicted process: unacked ring frames are reaped (spans close
        as blackholed), the recv watermark resets so a future
        incarnation of the pid space starts a fresh session."""
        with self._lock_for(dst):
            conn = self._out.pop(dst, None)
            ss = self._send_s.pop(dst, None)
        self._dirty.discard(dst)
        with self._rs_guard:
            self._recv_s.pop(dst, None)
        if ss is not None:
            with ss.lock:
                frames = [f for f in ss.ring if f[0] > ss.acked]
                ss.ring.clear()
            for _, tag, payload in frames:
                self._inc("transport.session.reaped")
                self._reap(tag, payload)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        self._down.pop(dst, None)
        self._ever.discard(dst)

    def close(self) -> None:
        self._closed = True
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        # sever inbound streams too: peers of a closed endpoint must see
        # the death (broken pipe) instead of feeding a zombie reader
        for conn in self._accepted:
            try:
                conn.close()
            except OSError:
                pass
        self._accepted = []
        for dst in list(self._out):
            with self._lock_for(dst):
                conn = self._out.pop(dst, None)
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
        try:
            os.unlink(self.path)
        except OSError:
            pass


class TcpEndpoint(SocketEndpoint):
    """The socket endpoint over TCP (AF_INET loopback/host networking):
    each endpoint binds an ephemeral port and advertises ``host:port``
    in a registry file in the fabric dir, so the address book is still
    derivable from ``(directory, pid)`` alone — arrivals need no
    address gossip, exactly like the AF_UNIX path scheme. Everything
    else (session layer, backoff, negative cache, hb echo, link
    faults) is shared."""

    host = "127.0.0.1"

    def _make_listener(self):
        from multiprocessing.connection import Listener
        lst = Listener((self.host, 0), "AF_INET")
        host, port = lst.address
        self.path = _addr_path(self.directory, self.pid)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(f"{host}:{port}\n")
        os.replace(tmp, self.path)      # atomic: readers never see torn
        return lst

    def _dial(self, dst: int):
        from multiprocessing.connection import Client
        # FileNotFoundError (peer still booting, registry entry not
        # written yet) rides the same backoff loop as a refused connect
        with open(_addr_path(self.directory, dst)) as f:
            host, port = f.read().strip().rsplit(":", 1)
        return Client((host, int(port)), "AF_INET")


ENDPOINT_KINDS = {"unix": SocketEndpoint, "tcp": TcpEndpoint}


def endpoint_cls(kind: str):
    try:
        return ENDPOINT_KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown socket fabric {kind!r} "
                         f"(want one of {sorted(ENDPOINT_KINDS)})")


class FaultyEndpoint(Endpoint):
    """Chaos decorator over any endpoint (installed on the coordinator's
    socket endpoint). Faults by tag class:

    * send side: ``cmd``/``hb`` frames dropped or duplicated per the
      seeded channel rng (retry + worker-side cid dedupe recover);
    * recv side: ``rep`` frames dropped (reply lost -> retry) or
      re-delivered (coordinator ignores cids it no longer awaits);
      ``env`` frames held in per-source limbo for a bounded wall-clock
      delay — later frames of the same source queue behind the held
      head, so per-channel FIFO survives while channels reorder.
    """

    def __init__(self, inner: Endpoint, chaos: ChaosConfig, metrics=None):
        super().__init__(inner.pid)
        self.inner = inner
        self.chaos = chaos
        self.metrics = metrics
        self._rngs: Dict[Tuple[int, int], random.Random] = {}
        self._held: Dict[int, deque] = defaultdict(deque)  # src -> frames
        self._redeliver: deque = deque()

    def _inc(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(name)

    def _rng(self, src: int, dst: int) -> random.Random:
        key = (src, dst)
        if key not in self._rngs:
            self._rngs[key] = self.chaos.rng(src, dst)
        return self._rngs[key]

    # -- passthrough surface -------------------------------------------------
    @property
    def last_rx(self):
        return getattr(self.inner, "last_rx", 0.0)

    def forget_peer(self, dst: int) -> None:
        fp = getattr(self.inner, "forget_peer", None)
        if fp is not None:
            fp(dst)

    def set_reaper(self, fn) -> None:
        sr = getattr(self.inner, "set_reaper", None)
        if sr is not None:
            sr(fn)

    def add_link_fault(self, a, b, t1: float, t2: float, *,
                       oneway: bool = False) -> None:
        alf = getattr(self.inner, "add_link_fault", None)
        if alf is not None:
            alf(a, b, t1, t2, oneway=oneway)

    def clear_link_faults(self) -> None:
        clf = getattr(self.inner, "clear_link_faults", None)
        if clf is not None:
            clf()

    def inject_reset(self, dst: int) -> bool:
        ir = getattr(self.inner, "inject_reset", None)
        return bool(ir(dst)) if ir is not None else False

    def session_stats(self):
        st = getattr(self.inner, "session_stats", None)
        return st() if st is not None else {}

    def close(self) -> None:
        self.inner.close()

    # -- faulted send/recv ---------------------------------------------------
    def send(self, dst: int, tag: str, payload: Any) -> None:
        if tag in ("cmd", "hb"):
            rng = self._rng(self.pid, dst)
            if rng.random() < self.chaos.p_drop:
                self._inc(f"chaos.drop_{tag}")
                return
            if rng.random() < self.chaos.p_dup:
                self._inc(f"chaos.dup_{tag}")
                self.inner.send(dst, tag, payload)
        if self.chaos.p_reset > 0 and tag in ("cmd", "env"):
            # guard keeps the rng stream byte-identical for configs
            # that never asked for resets (seed compatibility)
            rng = self._rng(self.pid, dst)
            if rng.random() < self.chaos.p_reset:
                self.inject_reset(dst)
        self.inner.send(dst, tag, payload)
        self.frames_sent += 1

    def _due(self) -> Optional[Frame]:
        if self._redeliver:
            return self._redeliver.popleft()
        now = time.monotonic()
        for src in sorted(s for s, q in self._held.items() if q):
            q = self._held[src]
            if q[0][0] <= now:
                self._inc("chaos.release_env")
                return q.popleft()[1]
        return None

    def _filter(self, frame: Frame) -> Optional[Frame]:
        src, tag, payload = frame
        rng = self._rng(src, self.pid)
        if tag == "rep":
            if rng.random() < self.chaos.p_drop:
                self._inc("chaos.drop_rep")
                return None
            if rng.random() < self.chaos.p_dup:
                self._inc("chaos.dup_rep")
                self._redeliver.append(frame)
            return frame
        if tag == "env":
            q = self._held[src]
            if q or rng.random() < self.chaos.p_delay:
                due = time.monotonic() + rng.uniform(
                    0.0, self.chaos.max_delay)
                if q:
                    due = max(due, q[-1][0])   # FIFO within the channel
                q.append((due, frame))
                self._inc("chaos.delay_env")
                return None
            return frame
        return frame

    def recv(self, timeout: Optional[float] = None) -> Optional[Frame]:
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            due = self._due()
            if due is not None:
                self.frames_received += 1
                return due
            if timeout == 0:
                inner_t: Optional[float] = 0
            else:
                inner_t = 0.02
                if deadline is not None:
                    inner_t = min(inner_t,
                                  max(0.0, deadline - time.monotonic()))
            frame = self.inner.recv(timeout=inner_t)
            if frame is not None:
                out = self._filter(frame)
                if out is not None:
                    self.frames_received += 1
                    return out
                continue
            if timeout == 0:
                return None
            if deadline is not None and time.monotonic() >= deadline:
                return None
