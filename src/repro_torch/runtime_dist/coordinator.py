"""DistCoordinator: membership epochs over a cluster of host processes.

The single-process ``ElasticPhaserRuntime`` drives churn through one
``DistPhaser`` holding every actor. Here the same epoch lifecycle runs
over a *partitioned* control plane: the coordinator owns the HEAD
sentinel (pid ``COORD``), each host process owns its own participant
actor, and every structural op is the paper's two-phase dance executed
with real inter-process messages — eager level-0 splice initiated on the
parent's owner, lazy multi-link handoff riding the same transport, then
a quiescence wave before the membership view is re-broadcast.

Epoch boundaries stay the swap point: at ``advance()`` after churn, each
surviving process re-derives the skip-list oracle over the *replicated*
membership view, checks its own partition of protocol state against it,
fingerprints the whole structure, and re-commits its process-level
program cache. The coordinator asserts all fingerprints (its own
included) agree — the distributed analogue of ``verify_epoch``.

Fault tolerance (DESIGN.md §13). The cooperative demote→evict path
needs the departing host to answer unlink handshakes; a crashed host
never will. So the coordinator layers:

* detection — a heartbeat thread + ``PhiDetector`` over the echo times
  (socket clusters); suspect → confirm → declare-dead, with a hard
  silence floor so one slow poll can't kill anyone;
* at-least-once RPC — ``collect`` retransmits commands with bounded
  exponential backoff; workers dedupe by command id and replay cached
  replies, making every op exactly-once end to end;
* non-cooperative eviction — ``recover_failure`` removes the dead host
  from membership, bumps the generation, re-seeds every survivor's
  shard from the surviving oracle (``ShardPhaser.rebuild``), and
  continues; ``advance``/``train_step`` retry around it. A mid-step
  crash resolves via ``step_status``: all-applied → done, none →
  retry, mixed → ``StepInconsistent`` (checkpoint resume is the only
  way back to replicated params).

Two cluster fabrics drive the same coordinator:

* ``InprocCluster``  — N logical processes in one address space over
  ``InprocFabric``; deterministic, used by tier-1 tests and the
  ``--processes N`` trainer (each host's ranks stacked on the one
  card, or the CPU). Pass
  ``chaos=ChaosConfig(...)`` for seeded delay/reorder injection;
  ``kill_host`` simulates crash-stop.
* ``SocketCluster``  — real OS processes (``worker.py``) over AF_UNIX
  sockets; quiescence needs the Mattern-style double poll; used by the
  control-plane latency benchmark and the slow churn test. Pass
  ``chaos=`` for RPC drop/dup + env delay; ``kill_pid`` SIGKILLs a
  worker with no cleanup.

State hand-off on join. A joining host builds its data plane from the
seeded initial parameters, so in the reference it trains from step 0's
parameters beside hosts that have moved on, and the replicas never
agree again. Here ``request_join`` copies the parameters and optimizer
state of the lowest live host into the joiner (``export_state`` /
``import_state``), so the replicas stay bitwise equal.
"""
from __future__ import annotations

import os
import random
import signal as _signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..core.phaser import SCSL, SNSL
from ..obs.hub import ObsHub
from ..obs.live import LiveStreamer
from ..obs.recorder import flight_path
from .agent import HostAgent
from .exchange import run_schedule_rounds
from .failure import (HostDead, PeerUnreachable, PhiDetector, RpcTimeout,
                      StepInconsistent, backoff, orphan_horizon)
from .plane import COORD, ShardPhaser
from .transport import (ChaosConfig, FaultyEndpoint, FaultyInprocFabric,
                        InprocFabric, SocketEndpoint, endpoint_cls,
                        fabric_dir)


@dataclass
class HostEvent:
    step: int
    kind: str    # "join" | "leave" | "fail" | "straggle" | "demote"
                 # | "repromote" | "dead" (non-cooperative eviction)
    pid: int


@dataclass(frozen=True)
class DistEpoch:
    """One membership epoch of the multi-host runtime. No compiled
    collective rides here (each process compiles its own slice); the
    epoch's identity is the fingerprint every process agreed on."""
    index: int
    phase_start: int
    live: Tuple[int, ...]
    demoted: Tuple[int, ...]
    fingerprint: str
    program_key: Optional[Dict] = None

    @property
    def n(self) -> int:
        return len(self.live)


class _StepAborted(Exception):
    """Internal: one or more hosts unwound a peer-exchange step."""

    def __init__(self, step: int, pids: Sequence[int]):
        self.step = step
        self.pids = list(pids)
        super().__init__(f"step {step} aborted on {self.pids}")


class InprocCluster:
    """All host agents in this address space, coordinator included."""

    peer_exchange = False   # steps run split (local halves + central rounds)

    def __init__(self, *, chaos: Optional[ChaosConfig] = None):
        self.fabric = (FaultyInprocFabric(chaos) if chaos is not None
                       else InprocFabric())
        self.ep = self.fabric.endpoint(COORD)
        self.agents: Dict[int, HostAgent] = {}
        self.env_sink: Optional[Callable] = None   # unused (pump is direct)
        self.dead: Set[int] = set()

    def add_host(self, pid: int, cfg: Dict) -> None:
        self.agents[pid] = HostAgent(pid, self.fabric.endpoint(pid), cfg)

    def call(self, pid: int, cmd: Dict, **kw) -> Dict:
        if pid in self.dead:
            raise HostDead(pid)
        r = self.agents[pid].handle(cmd)
        assert r.get("ok"), (pid, cmd.get("op"), r)
        return r

    def post(self, pid: int, cmd: Dict):
        return self.call(pid, cmd)

    def collect(self, handle, timeout: float = 0.0, watch=None) -> Dict:
        return handle

    def kill_host(self, pid: int) -> None:
        """Simulated crash-stop: the agent vanishes without running any
        protocol; frames already addressed to it are reaped by the
        fabric, future sends to it vanish (counted)."""
        self.dead.add(pid)
        self.agents.pop(pid, None)
        self.fabric.drop_endpoint(pid)

    def mark_dead(self, pid: int) -> None:
        self.kill_host(pid)

    def poll_failures(self) -> List[int]:
        """No detector in-process — deaths are explicit ``kill_host``
        calls; report them so the coordinator can recover proactively."""
        return sorted(self.dead)

    def fault_counters(self) -> Dict[str, int]:
        return dict(self.fabric.faults)

    def drop_host(self, pid: int) -> None:
        del self.agents[pid]
        self.fabric.drop_endpoint(pid)

    def quiesce(self, coord_shard: ShardPhaser, limit: int = 100_000) -> None:
        """Synchronous sweeps: pump every shard until a full round moves
        nothing and no frame sits in any inbox. Under a chaos fabric a
        stalled sweep advances fabric time instead, so limbo frames
        come due and the sweep resumes."""
        for _ in range(limit):
            moved = coord_shard.pump()
            for pid in sorted(self.agents):
                moved += self.agents[pid].shard.pump()
            if moved == 0:
                if self.fabric.pending() == 0:
                    return
                self.fabric.tick()
        raise AssertionError("in-process cluster did not quiesce")

    def close(self) -> None:
        self.agents.clear()


class SocketCluster:
    """Host agents as OS processes (``repro_torch.runtime_dist.worker``)
    over
    AF_UNIX sockets. The coordinator endpoint shares its inbox between
    protocol envelopes (routed to ``env_sink``), command replies, and
    heartbeat echoes (fed to the failure detector)."""

    peer_exchange = True    # steps run whole, with peer-to-peer rounds

    def __init__(self, *, control_only: bool = False,
                 python: Optional[str] = None,
                 hb_interval: float = 0.5,
                 failure_timeout: float = 10.0,
                 chaos: Optional[ChaosConfig] = None,
                 orphan_timeout: Optional[float] = None,
                 fabric: str = "unix"):
        from ..obs.metrics import MetricsRegistry
        self.dir = fabric_dir()
        self.metrics = MetricsRegistry()
        self.fabric_kind = fabric
        ep = endpoint_cls(fabric)(COORD, self.dir, metrics=self.metrics)
        self.ep = (FaultyEndpoint(ep, chaos, metrics=self.metrics)
                   if chaos is not None else ep)
        self.procs: Dict[int, subprocess.Popen] = {}
        self.env_sink: Optional[Callable] = None
        self.control_only = control_only
        self.python = python or sys.executable
        self.hb_interval = hb_interval
        self.failure_timeout = failure_timeout
        self.orphan_timeout = (orphan_timeout if orphan_timeout is not None
                               else orphan_horizon(failure_timeout))
        self._cid = 0
        self._reps: Dict[int, Dict] = {}
        self._pending: Dict[int, Dict] = {}   # cid -> retransmit state
        self._retry_rng = random.Random(0xC0FFEE)
        self.detector = PhiDetector(interval=hb_interval,
                                    timeout=failure_timeout,
                                    metrics=self.metrics)
        self.dead: Set[int] = set()
        # final counters of evicted hosts: their frames stay part of the
        # global sent/received balance after the process is gone
        self._ghost_sent = 0
        self._ghost_recv = 0
        self._hb_stop = threading.Event()
        self._hb_thread = threading.Thread(target=self._hb_loop,
                                           daemon=True)
        self._hb_thread.start()

    # ------------------------------------------------------------ liveness
    def _hb_loop(self) -> None:
        seq = 0
        while not self._hb_stop.wait(self.hb_interval):
            seq += 1
            for pid in list(self.procs):
                if pid in self.dead:
                    continue
                try:
                    self.ep.send(pid, "hb", (seq, time.monotonic()))
                except (PeerUnreachable, OSError, ValueError):
                    pass    # detector accounts the missing echo

    def _is_dead(self, pid: int) -> bool:
        return pid in self.dead or pid in self.detector.declared

    def poll_failures(self) -> List[int]:
        # drain queued heartbeat echoes first: between RPCs nothing else
        # empties the inbox, and acks the detector never saw would read
        # as silence from every host at once
        while self._drain(0.0):
            pass
        self.detector.poll()
        return sorted(set(self.detector.declared) - self.dead)

    def fault_counters(self) -> Dict[str, int]:
        snap = self.metrics.snapshot()["counters"]
        return {k.split("chaos.", 1)[1]: v for k, v in snap.items()
                if k.startswith("chaos.")}

    # ------------------------------------------------------------ lifecycle
    def _spawn(self, pid: int, cfg: Dict) -> None:
        env = dict(os.environ)
        # the package's own source root, not the working directory: the
        # coordinator may run from any copy of the tree
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        env["PHASER_ORPHAN_TIMEOUT"] = str(self.orphan_timeout)
        self.procs[pid] = subprocess.Popen(
            [self.python, "-m", "repro_torch.runtime_dist.worker",
             "--dir", self.dir, "--pid", str(pid),
             "--fabric", self.fabric_kind],
            env=env)
        self.detector.touch(pid)

    def add_host(self, pid: int, cfg: Dict) -> None:
        self._spawn(pid, cfg)
        r = self.call(pid, {"op": "init", "cfg": cfg}, timeout=600.0)
        assert r.get("ok"), (pid, r)

    def kill_pid(self, pid: int) -> None:
        """Hard crash for tests/chaos: SIGKILL, no cleanup whatsoever —
        detection must come from the heartbeat timeout."""
        os.kill(self.procs[pid].pid, _signal.SIGKILL)

    def mark_dead(self, pid: int) -> None:
        """Non-cooperative removal after a declare-dead: reap the OS
        process, drop cached connections and in-flight commands."""
        self.dead.add(pid)
        self.detector.remove(pid)
        p = self.procs.pop(pid, None)
        if p is not None:
            try:
                p.kill()
            except OSError:
                pass
            try:
                p.wait(timeout=30)
            except Exception:
                pass
        self.ep.forget_peer(pid)
        for cid in [c for c, e in self._pending.items()
                    if e["pid"] == pid]:
            self._pending.pop(cid, None)
        self.metrics.inc("cluster.marked_dead")

    # ------------------------------------------------------------ link chaos
    def inject_link_fault(self, a, b=None, *, duration: float,
                          oneway: bool = False) -> None:
        """Install a link-fault window on every live endpoint.

        ``b=None`` means "everyone else" (a isolates itself). Each
        endpoint converts ``duration`` into a *local* wall-clock window
        at receipt and auto-heals when it expires — no shared clock,
        and a heal never needs connectivity through the partition.
        Workers are told BEFORE the coordinator installs locally: once
        our own edge is cut we may not reach workers inside it."""
        a = sorted(a)
        if b is None:
            b = sorted(({COORD} | set(self.procs)) - set(a))
        else:
            b = sorted(b)
        cmd = {"op": "link_fault", "a": a, "b": b,
               "dur": duration, "oneway": oneway}
        for pid in sorted(self.procs):
            if pid in self.dead:
                continue
            try:
                self.call(pid, cmd, timeout=10.0)
            except (HostDead, RpcTimeout, PeerUnreachable, OSError):
                pass        # best effort: its local window just stays off
        alf = getattr(self.ep, "add_link_fault", None)
        if alf is not None and (COORD in a or COORD in b):
            now = time.monotonic()
            alf(a, b, now, now + duration, oneway=oneway)
        self.metrics.inc("chaos.link_fault_installed")

    def heal_link_faults(self) -> None:
        """Force-heal every window early: clear locally FIRST (so the
        broadcast can get through a partition that included us)."""
        clf = getattr(self.ep, "clear_link_faults", None)
        if clf is not None:
            clf()
        for pid in sorted(self.procs):
            if pid in self.dead:
                continue
            try:
                self.call(pid, {"op": "link_clear"}, timeout=10.0)
            except (HostDead, RpcTimeout, PeerUnreachable, OSError):
                pass

    def inject_reset_storm(self) -> int:
        """Chaos: hard-close every cached stream everywhere (coordinator
        outbound + each worker's outbound) — the session layer must
        reconnect and replay with zero envelope loss."""
        hit = 0
        ir = getattr(self.ep, "inject_reset", None)
        if ir is not None:
            for pid in sorted(self.procs):
                hit += bool(ir(pid))
        dsts = [COORD] + sorted(self.procs)
        for pid in sorted(self.procs):
            if pid in self.dead:
                continue
            try:
                r = self.call(pid, {"op": "inject_reset",
                                    "dsts": [d for d in dsts if d != pid]},
                              timeout=10.0)
                hit += int(r.get("reset", 0))
            except (HostDead, RpcTimeout, PeerUnreachable, OSError):
                pass
        self.metrics.inc("chaos.reset_storms")
        return hit

    # ------------------------------------------------------------------ rpc
    def _drain(self, timeout: float) -> bool:
        frame = self.ep.recv(timeout=timeout)
        if frame is None:
            return False
        src, tag, payload = frame
        if tag == "rep":
            cid, reply = payload
            if cid in self._pending:
                self._pending.pop(cid)
                self._reps[cid] = reply
            else:
                # duplicated or abandoned reply (chaos / late worker)
                self.metrics.inc("rpc.stale_reps")
        elif tag == "hb":
            seq, t_sent = payload
            self.detector.on_ack(src)
            self.metrics.observe("hb.rtt_seconds",
                                 time.monotonic() - t_sent)
        elif tag == "env":
            assert self.env_sink is not None
            self.env_sink(payload)
        else:
            self.metrics.inc(f"transport.unexpected_{tag}")
        return True

    def post(self, pid: int, cmd: Dict):
        self._cid += 1
        cid = self._cid
        now = time.monotonic()
        self._pending[cid] = {
            "pid": pid, "cmd": cmd, "attempts": 1, "t0": now,
            "retry_at": now + backoff(1, 0.25, 2.0, self._retry_rng)}
        try:
            self.ep.send(pid, "cmd", (cid, cmd))
        except (PeerUnreachable, OSError):
            self.metrics.inc("rpc.post_send_failures")
        return cid

    def collect(self, cid, timeout: float = 600.0, watch=None) -> Dict:
        """Await the reply for ``cid`` with at-least-once delivery:
        retransmit on a backoff schedule (the worker's cid dedupe makes
        that safe), raise ``HostDead`` the moment the detector declares
        the target — or any ``watch``-ed pid — dead, and ``RpcTimeout``
        only if the full deadline passes with the peer still alive."""
        t0 = time.monotonic()
        deadline = t0 + timeout
        while cid not in self._reps:
            self._drain(0.05)
            while self._drain(0):
                pass
            self.detector.poll()
            ent = self._pending.get(cid)
            pid = ent["pid"] if ent is not None else None
            if pid is not None and self._is_dead(pid):
                self._pending.pop(cid, None)
                raise HostDead(pid)
            for w in (watch or ()):
                if self._is_dead(w):
                    self._pending.pop(cid, None)
                    raise HostDead(w)
            now = time.monotonic()
            if ent is not None and now >= ent["retry_at"]:
                ent["attempts"] += 1
                self.metrics.inc("rpc.retries")
                try:
                    self.ep.send(pid, "cmd", (cid, ent["cmd"]))
                except (PeerUnreachable, OSError):
                    self.metrics.inc("rpc.retry_send_failures")
                ent["retry_at"] = now + backoff(ent["attempts"], 0.25,
                                                2.0, self._retry_rng)
            if now >= deadline:
                self._pending.pop(cid, None)
                raise RpcTimeout(pid if pid is not None else -1, cid,
                                 now - t0,
                                 ent["attempts"] if ent else 0)
        r = self._reps.pop(cid)
        assert r.get("ok"), (cid, r)
        return r

    def collect_any(self, cids, timeout: float = 600.0,
                    watch=None) -> Tuple[int, Dict]:
        """Await the first available reply among ``cids`` in ARRIVAL
        order (not posting order), with the same retransmit / death /
        deadline rules as ``collect``. Returns ``(cid, reply)``.

        Arrival order is load-bearing for the step path: when a
        partition makes one worker abort its exchange while another
        blocks on its in-step recv deadline, posting-order collection
        would pin the coordinator behind the blocked worker and never
        see the abort it needs to act on."""
        t0 = time.monotonic()
        deadline = t0 + timeout
        cids = list(cids)
        while True:
            for cid in cids:
                if cid in self._reps:
                    r = self._reps.pop(cid)
                    assert r.get("ok"), (cid, r)
                    return cid, r
            self._drain(0.05)
            while self._drain(0):
                pass
            self.detector.poll()
            now = time.monotonic()
            for cid in cids:
                ent = self._pending.get(cid)
                if ent is None:
                    continue
                pid = ent["pid"]
                if self._is_dead(pid):
                    self._pending.pop(cid, None)
                    raise HostDead(pid)
                if now >= ent["retry_at"]:
                    ent["attempts"] += 1
                    self.metrics.inc("rpc.retries")
                    try:
                        self.ep.send(pid, "cmd", (cid, ent["cmd"]))
                    except (PeerUnreachable, OSError):
                        self.metrics.inc("rpc.retry_send_failures")
                    ent["retry_at"] = now + backoff(ent["attempts"],
                                                    0.25, 2.0,
                                                    self._retry_rng)
            for w in (watch or ()):
                if self._is_dead(w):
                    for cid in cids:
                        self._pending.pop(cid, None)
                    raise HostDead(w)
            if now >= deadline:
                for cid in cids:
                    self._pending.pop(cid, None)
                raise RpcTimeout(-1, cids[0] if cids else -1,
                                 now - t0, 0)

    def call(self, pid: int, cmd: Dict, timeout: float = 600.0) -> Dict:
        return self.collect(self.post(pid, cmd), timeout=timeout)

    def abandon(self, cids) -> None:
        """Stop retransmitting (and drop any cached reply for) commands
        the caller no longer awaits — a step unwound by recovery."""
        for cid in cids:
            self._pending.pop(cid, None)
            self._reps.pop(cid, None)

    def drop_host(self, pid: int) -> None:
        try:
            r = self.call(pid, {"op": "status"}, timeout=30.0)
            self._ghost_sent += r["sent"]
            self._ghost_recv += r["received"]
            self.call(pid, {"op": "shutdown"}, timeout=30.0)
        finally:
            self.detector.remove(pid)
            p = self.procs.pop(pid)
            p.wait(timeout=60)
            self.ep.forget_peer(pid)

    def quiesce(self, coord_shard: ShardPhaser, limit: int = 10_000) -> None:
        """Mattern-style termination wave: poll every host's (idle, sent,
        received) plus the coordinator's own; done after two consecutive
        polls that are stable, all-idle, and globally balanced."""
        stable = 0
        prev = None
        for _ in range(limit):
            while self._drain(timeout=0.01):
                pass
            vec = []
            for pid in sorted(self.procs):
                r = self.call(pid, {"op": "status"})
                vec.append((pid, r["idle"], r["sent"], r["received"]))
            while self._drain(timeout=0.01):
                pass
            ms, mr = coord_shard.flight_counters()
            vec.append((COORD, coord_shard.net.idle(), ms, mr))
            idle = all(v[1] for v in vec)
            balanced = (sum(v[2] for v in vec) + self._ghost_sent
                        == sum(v[3] for v in vec) + self._ghost_recv)
            if idle and balanced and vec == prev:
                stable += 1
                if stable >= 2:
                    return
            else:
                stable = 0
            prev = vec
        raise AssertionError("socket cluster did not quiesce")

    def close(self) -> None:
        self._hb_stop.set()
        if self._hb_thread.is_alive():
            self._hb_thread.join(timeout=5)
        for pid in list(self.procs):
            try:
                self.drop_host(pid)
            except Exception:
                p = self.procs.pop(pid, None)
                if p is not None:
                    try:
                        p.kill()
                        p.wait(timeout=10)
                    except Exception:
                        pass
        self.ep.close()


class DistCoordinator:
    """Epoch lifecycle of ``ElasticPhaserRuntime``, generalized to
    whole-host churn over a cluster fabric."""

    def __init__(self, cluster, n_hosts: int, *, seed: int = 0,
                 p: float = 0.5, proc_kind: str = "phaser_scsl",
                 axis_name: str = "data", data: Optional[Dict] = None,
                 data_for: Optional[Callable[[int], Dict]] = None,
                 obs: bool = False, live_out: Optional[str] = None,
                 flight_dir: Optional[str] = None):
        self.cluster = cluster
        self.seed = seed
        self.p = p
        self.proc_kind = proc_kind
        self.axis_name = axis_name
        self.data = data
        self._data_for = data_for or (lambda pid: dict(data)
                                      if data is not None else None)
        self.live: Set[int] = set(range(n_hosts))
        self.demoted: Set[int] = set()
        self.next_pid = n_hosts
        self.events: List[HostEvent] = []
        self.epochs: List[DistEpoch] = []
        self._dirty = False
        self._step = 0
        self._gen = 0            # membership incarnation (bumped per death)
        self._strikes: Dict[int, int] = {}
        self._on_epoch: List[Callable[[DistEpoch, DistEpoch], None]] = []
        # obs plane: per-frame span traces collected at every quiescent
        # advance, the O(log P) hop invariant checked per phase, shard
        # metrics merged here (DESIGN.md §12)
        self.obs = ObsHub(p=p) if (obs or live_out) else None
        # streaming telemetry: heartbeat frames appended to --live-out
        # at a bounded cadence; failure edges force a frame through
        self.live_stream = LiveStreamer(live_out) if live_out else None
        # flight-ring flush directory: when set, the coordinator asks
        # shards to flush their rings at the failure edges and flushes
        # its own alongside
        self.flight_dir = flight_dir
        if flight_dir:
            os.makedirs(flight_dir, exist_ok=True)
        # the first step after any (re)compile boundary is warmup: tag
        # it so step-time strike accounting never counts compile time.
        # Only hosts with a data plane ever compile; control-only
        # clusters keep the untagged strike accounting.
        self._has_data = data is not None or data_for is not None
        self._compile_pending = self._has_data
        self.shard = ShardPhaser(COORD, cluster.ep, live=self.live,
                                 p=p, seed=seed, obs=obs)
        # frames swallowed at the fabric (dead destination) still close
        # their spans: wire the fabric's reaper to the coordinator's
        # blackhole edge so the causal trees stay complete
        fab = getattr(cluster, "fabric", None)
        if fab is not None:
            fab.reaper = self._reap_frame
        if cluster.env_sink is None:
            cluster.env_sink = self._ingest_env
        for pid in sorted(self.live):
            cluster.add_host(pid, self._cfg_for(pid))
        self.epochs.append(self._derive_boundary(0, 0))

    # ------------------------------------------------------------ plumbing
    def _ingest_env(self, env) -> None:
        self.shard.net.ingest(env)
        self.shard.net.deliver_all()

    def _reap_frame(self, payload, tag: str) -> None:
        if tag == "env":
            self.shard.net._blackhole(payload)

    def _cfg_for(self, pid: int) -> Dict:
        return {"seed": self.seed, "p": self.p, "axis": self.axis_name,
                "proc_kind": self.proc_kind,
                "live": sorted(self.live), "demoted": sorted(self.demoted),
                "obs": self.obs is not None,
                "flight_dir": self.flight_dir,
                # a host joining after a non-cooperative eviction must be
                # born into the CURRENT incarnation, or the survivors'
                # gen-stamped frames (its own MURS_ACK included) get
                # fenced at its ingest and the splice never completes
                "gen": self._gen,
                "data": self._data_for(pid)}

    def _call(self, pid: int, cmd: Dict, **kw) -> Dict:
        """RPC to a host agent; with obs on, the round-trip latency lands
        in the coordinator's metrics shard keyed by the op name."""
        if self.obs is None:
            return self.cluster.call(pid, cmd, **kw)
        t0 = time.perf_counter()
        r = self.cluster.call(pid, cmd, **kw)
        self.obs.metrics.observe(f"rpc.{cmd['op']}.seconds",
                                 time.perf_counter() - t0)
        return r

    def _collect_obs(self) -> None:
        """Pull every shard's span records + metrics snapshot into the
        hub (the coordinator's own shard and the cluster's transport
        shard included)."""
        assert self.obs is not None
        self.obs.ingest(COORD, self.shard.drain_obs())
        self.obs.watermarks.update(COORD, self.shard.watermarks.snapshot(),
                                   gen=self._gen)
        for pid in sorted(self.live):
            r = self._call(pid, {"op": "obs"})
            self.obs.ingest(pid, r["spans"], r["metrics"])
            # merge the shard's phase watermarks: per-host monotonicity
            # asserted here, across churn and generation bumps
            self.obs.watermarks.update(pid, r.get("watermarks"),
                                       gen=self._gen)
        cm = getattr(self.cluster, "metrics", None)
        if cm is not None:
            self.obs.ingest(-2, [], cm.snapshot())
        fc = getattr(self.cluster, "fault_counters", None)
        if fc is not None:
            for k, v in fc().items():
                self.obs.metrics.set(f"fault.{k}", v)

    def export_obs(self, trace_path: Optional[str] = None,
                   metrics_path: Optional[str] = None) -> None:
        assert self.obs is not None, "coordinator built without obs=True"
        self.obs.export(trace_path, metrics_path)

    def _emit_live_frame(self, *, phase: int, force: bool = False) -> None:
        """One heartbeat frame to --live-out (rate-limited unless the
        caller forces; failure edges always force)."""
        if self.live_stream is None or self.obs is None:
            return
        det = getattr(self.cluster, "detector", None)
        phi = None
        if det is not None:
            phi = {}
            for p in sorted(self.live):
                try:
                    phi[p] = det.phi(p)
                except Exception:
                    pass
        self.live_stream.frame(
            step=self._step, phase=phase, epoch=self.epoch.index,
            gen=self._gen, live=sorted(self.live),
            watermarks=self.obs.watermarks,
            merged_metrics=self.obs.merged_metrics(), phi=phi,
            events=[[e.step, e.kind, e.pid] for e in self.events],
            force=force)

    def _flush_flight(self, reason: str,
                      pids: Optional[Sequence[int]] = None) -> None:
        """Best-effort flight-ring flush: the coordinator's own ring
        plus the given shards' (default: every live host). Never raises
        — these are failure edges."""
        if not self.flight_dir:
            return
        self.shard.flight.flush(flight_path(self.flight_dir, COORD),
                                reason)
        for pid in (sorted(self.live) if pids is None else pids):
            try:
                self._call(pid, {"op": "flight_flush",
                                 "dir": self.flight_dir,
                                 "reason": reason}, timeout=30.0)
            except Exception:
                pass    # a flush must never extend a failure cascade

    def _quiesce(self) -> None:
        self.cluster.quiesce(self.shard)

    def _broadcast_membership(self) -> None:
        live, dem = sorted(self.live), sorted(self.demoted)
        self.shard.note_membership(live, dem)
        for pid in live:
            self._call(pid, {"op": "note_membership",
                                    "live": live, "demoted": dem})

    # ------------------------------------------------------------- epochs
    @property
    def epoch(self) -> DistEpoch:
        return self.epochs[-1]

    @property
    def gen(self) -> int:
        return self._gen

    @property
    def pending_churn(self) -> bool:
        return self._dirty

    def on_epoch(self, fn: Callable[[DistEpoch, DistEpoch], None]) -> None:
        self._on_epoch.append(fn)

    def _derive_boundary(self, index: int, phase_start: int) -> DistEpoch:
        """Every process (coordinator included) re-derives the oracle,
        checks its partition, fingerprints, re-commits its cache."""
        live, dem = sorted(self.live), sorted(self.demoted)
        self.shard.note_membership(live, dem)
        t0 = self.obs.timeline.now() if self.obs is not None else 0.0
        tr = self.shard.tracer
        if tr is not None:
            # the fingerprint round is a causal tree too: one epoch root,
            # one child span per host the coordinator polls
            tr.root("epoch", index)
        sl = self.shard.oracle()
        view = sl.partition(self.shard.owner_of).get(COORD)
        if view is not None:
            for lid in (SCSL, SNSL):
                d = view.diff(self.shard.local_states(lid))
                assert not d, f"coordinator lid {lid}: {d}"
        fps = {COORD: sl.fingerprint()}
        pk = None
        for pid in live:
            if tr is not None:
                tr.span_under(index, "derive_epoch", pid)
            r = self._call(pid, {"op": "derive_epoch", "index": index,
                                        "live": live, "demoted": dem})
            fps[pid] = r["fingerprint"]
            pk = r.get("program_key", pk)
        assert len(set(fps.values())) == 1, f"fingerprint split: {fps}"
        # boundary re-commits every process's program cache: the next
        # observed step pays compile/warmup and must not strike anyone
        if self._has_data:
            self._compile_pending = True
        if self.obs is not None:
            self.obs.timeline.complete("epoch.derive", t0, cat="control",
                                       args={"index": index,
                                             "n": len(live)})
        return DistEpoch(index, phase_start, tuple(live), tuple(dem),
                         fps[COORD], pk)

    # ------------------------------------------------------------- churn
    def request_join(self, parent: Optional[int] = None, *,
                     step: Optional[int] = None) -> int:
        """Host arrival: spawn/attach the process, materialize its actor
        on its own shard (fast single-link path starts at the parent's
        owner), run the splice + lazy promotion to quiescence.

        Any host already declared dead is evicted FIRST: the cooperative
        splice assumes every participant answers, so running it against
        a membership that still contains a corpse would leave the
        structure partially linked (frames to the dead host are reaped
        at the fabric, never acked)."""
        self._check_cluster_failures(step=step)
        pid = self.next_pid
        self.next_pid += 1
        if parent is None:
            parent = min(self.live)
        self.cluster.add_host(pid, self._cfg_for(pid))
        self._call(pid, {"op": "create_member", "new": pid,
                                "parent": parent})
        self.live.add(pid)
        self._call(parent, {"op": "start_insert", "new": pid,
                                   "parent": parent})
        self._quiesce()
        self._broadcast_membership()
        if self._has_data:
            # the joiner adopts a live host's trained state (see the
            # module docstring): replicas stay bitwise equal
            st = self._call(min(self.live - {pid}),
                            {"op": "export_state"})
            self._call(pid, {"op": "import_state",
                             "params": st["params"], "opt": st["opt"]})
        self.events.append(HostEvent(self._at(step), "join", pid))
        self._dirty = True
        return pid

    def request_leave(self, pid: int, *, fail: bool = False,
                      step: Optional[int] = None) -> None:
        """Host eviction: the existing demote→evict path — DEREG lowers
        the expectation, level-by-level unlink runs to quiescence, then
        the process leaves the cluster."""
        self._check_cluster_failures(step=step)
        if pid not in self.live:
            return                    # already evicted non-cooperatively
        self._call(pid, {"op": "drop", "key": pid})
        self._quiesce()
        self.live.discard(pid)
        self.demoted.discard(pid)
        self._strikes.pop(pid, None)
        self._broadcast_membership()
        if self.obs is not None:
            # the departing host's half of the eviction tree (its root
            # span + deliveries) must be salvaged before the process goes
            r = self._call(pid, {"op": "obs"})
            self.obs.ingest(pid, r["spans"], r["metrics"])
            self.obs.watermarks.update(pid, r.get("watermarks"),
                                       gen=self._gen)
            self.obs.watermarks.retire(pid)
        if self.flight_dir:
            self._flush_flight("leave", pids=[pid])
        self.cluster.drop_host(pid)
        self.events.append(HostEvent(self._at(step),
                                     "fail" if fail else "leave", pid))
        self._dirty = True

    def request_demote(self, pid: int, *, step: Optional[int] = None) -> None:
        self._check_cluster_failures(step=step)
        if pid not in self.live or pid in self.demoted:
            return
        self._call(pid, {"op": "demote", "key": pid})
        self._quiesce()
        self.demoted.add(pid)
        self._broadcast_membership()
        self.events.append(HostEvent(self._at(step), "demote", pid))
        self._dirty = True

    def request_repromote(self, pid: int, *,
                          step: Optional[int] = None) -> None:
        self._check_cluster_failures(step=step)
        if pid not in self.live or pid not in self.demoted:
            return
        self._call(pid, {"op": "repromote", "key": pid})
        self._quiesce()
        self.demoted.discard(pid)
        self._broadcast_membership()
        self.events.append(HostEvent(self._at(step), "repromote", pid))
        self._dirty = True

    def _at(self, step: Optional[int]) -> int:
        return self._step if step is None else step

    # ----------------------------------------------------------- recovery
    def _check_cluster_failures(self, *, step: Optional[int] = None
                                ) -> List[int]:
        """Proactively recover any host the cluster's detector has
        declared dead; returns the pids recovered this call."""
        poll = getattr(self.cluster, "poll_failures", None)
        if poll is None:
            return []
        recovered = []
        for pid in poll():
            if pid in self.live:
                self.recover_failure(pid, step=step)
                recovered.append(pid)
        return recovered

    def recover_failure(self, pid: int, *,
                        step: Optional[int] = None) -> None:
        """Non-cooperative eviction of a crashed host (DESIGN.md §13).

        The dead host cannot answer unlink handshakes, so instead of the
        cooperative two-phase dance every survivor re-seeds its shard
        from the surviving membership's oracle at the coordinator's
        released phase (``ShardPhaser.rebuild``), under a bumped
        generation that fences the dead incarnation's in-flight frames.
        A survivor dying *during* recovery just extends the cascade."""
        pending = [pid]
        while pending:
            d = pending.pop(0)
            if d not in self.live:
                continue
            t0 = time.perf_counter()
            det = getattr(self.cluster, "detector", None)
            decl = (dict(det.declared[d])
                    if det is not None and d in det.declared else None)
            tr = self.shard.tracer
            if tr is not None:
                tr.root("failure", d)
            self.live.discard(d)
            self.demoted.discard(d)
            self._strikes.pop(d, None)
            self.cluster.mark_dead(d)
            self._gen += 1
            phase = self.shard.released()
            live, dem = sorted(self.live), sorted(self.demoted)
            self.shard.rebuild(live, dem, phase, self._gen)
            # the Mattern balance restarts for the new incarnation: the
            # dead host's final counters are unknowable, and rebuild
            # zeroed every survivor's flight counters
            if hasattr(self.cluster, "_ghost_sent"):
                self.cluster._ghost_sent = 0
                self.cluster._ghost_recv = 0
            for s in live:
                if tr is not None:
                    tr.span_under(d, "force_evict", s)
                try:
                    self._call(s, {"op": "force_evict", "live": live,
                                   "demoted": dem, "phase": phase,
                                   "gen": self._gen})
                except HostDead as e:
                    if e.pid not in pending:
                        pending.append(e.pid)
            self.events.append(HostEvent(self._at(step), "dead", d))
            self._dirty = True
            if self.obs is not None:
                self.obs.note_lost(d)
                # the corpse's watermark freezes at its last observed
                # value, then leaves the live view — survivors keep
                # asserting monotone against their own floors
                self.obs.watermarks.retire(d)
                self.obs.metrics.inc("failure.declared_dead")
                self.obs.metrics.observe("failure.recover_seconds",
                                         time.perf_counter() - t0)
                if decl is not None:
                    self.obs.metrics.observe("failure.detection_seconds",
                                             decl["silence"])
        # SIGKILL-survivor recovery: the corpse wrote nothing, so the
        # record of the death is every survivor's ring (+ the
        # coordinator's own), flushed now
        self._flush_flight("peer-dead")
        self._emit_live_frame(phase=self.shard.released(), force=True)

    # ----------------------------------------------------------- stepping
    def advance(self, *, step: Optional[int] = None) -> int:
        """One phase, fault-tolerant: any ``HostDead`` surfaced while
        signalling/quiescing triggers non-cooperative recovery, after
        which the whole phase is retried against the survivors (the
        rebuild reset every survivor's signal cursor, and generation
        fencing discards the aborted attempt's frames)."""
        last: Optional[HostDead] = None
        for _ in range(2 + len(self.live)):
            self._check_cluster_failures(step=step)
            if not self.live:
                raise RuntimeError("advance: no live hosts left")
            try:
                return self._advance_once(step=step)
            except HostDead as e:
                last = e
                self.recover_failure(e.pid, step=step)
        raise RuntimeError(f"advance: unrecoverable failure cascade "
                           f"({last})")

    def _advance_once(self, *, step: Optional[int] = None) -> int:
        """One phase: every live host signals its own actor, the
        protocol quiesces across processes, and a dirty boundary derives
        (and verifies) the next epoch on every survivor."""
        for pid in sorted(self.live):
            self._call(pid, {"op": "signal"})
        self._quiesce()
        released = self.shard.released()
        if self.obs is not None:
            # drain one phase's spans from every shard, then assert the
            # per-signal critical path stays within the O(log P) bound —
            # this runs at EVERY quiescent advance, churn included
            self._collect_obs()
            self.obs.check_window(len(self.live), phase=released)
            self._emit_live_frame(phase=released)
        if self._dirty:
            old = self.epoch
            new = self._derive_boundary(old.index + 1, released + 1)
            self.epochs.append(new)
            self._dirty = False
            for fn in self._on_epoch:
                fn(old, new)
        if step is not None:
            self._step = step
        self._step += 1
        return released

    def _abort_step(self, step: int) -> None:
        """Best-effort out-of-band unwind: survivors blocked inside a
        peer-exchange step can't serve commands, so the abort rides the
        raw ``ctl`` stream their in-step recv loop does watch."""
        if not getattr(self.cluster, "peer_exchange", False):
            return
        for pid in sorted(self.live):
            try:
                self.cluster.ep.send(pid, "ctl", ("abort_step", step))
            except Exception:
                pass

    def train_step(self, step: int) -> Dict[int, Dict]:
        """One data-parallel step across the cluster, fault-tolerant:
        a crash mid-step aborts the survivors' exchanges (``ctl``),
        recovers the membership, then resolves via ``step_status`` —
        every survivor already applied → the step is done; none →
        retry it against the shrunk cluster; a strict subset →
        ``StepInconsistent`` (params diverged; the caller falls back to
        a checkpoint-consistent ``resume``)."""
        for attempt in range(4):
            self._check_cluster_failures(step=step)
            if not self.live:
                raise RuntimeError("train_step: no live hosts left")
            try:
                return self._train_step_once(step)
            except HostDead as e:
                self._abort_step(step)
                self.recover_failure(e.pid, step=step)
            except _StepAborted:
                self._abort_step(step)
                self._check_cluster_failures(step=step)
            res = self._resolve_step(step)
            if res is not None:
                return res
        raise RuntimeError(f"train_step {step}: retries exhausted")

    def _train_step_once(self, step: int) -> Dict[int, Dict]:
        """One data-parallel step across the cluster: local grads + local
        reduce on every host, the process-level schedule between hosts,
        jitted apply everywhere. Socket mode exchanges the rounds
        peer-to-peer; in-process mode mirrors them centrally (bitwise
        identical — see ``exchange``)."""
        pids = sorted(self.live)
        if self.cluster.peer_exchange:
            handles = [(pid, self.cluster.post(pid, {"op": "step",
                                                     "step": step,
                                                     "gen": self._gen}))
                       for pid in pids]
            out = {}
            try:
                # collect in ARRIVAL order: the first "aborted" reply
                # triggers the out-of-band unwind immediately, so a
                # peer blocked on its in-step recv (e.g. behind a link
                # partition) is released by the sequenced ctl abort
                # instead of pinning this loop on its 300 s deadline
                waiting = {h: pid for pid, h in handles}
                abort_sent = False
                while waiting:
                    h, r = self.cluster.collect_any(list(waiting),
                                                    watch=pids)
                    out[waiting.pop(h)] = r
                    if r.get("aborted") and not abort_sent:
                        abort_sent = True
                        self._abort_step(step)
            except BaseException:
                ab = getattr(self.cluster, "abandon", None)
                if ab is not None:
                    ab([h for _, h in handles])
                raise
            aborted = [p for p, r in out.items() if r.get("aborted")]
            if aborted:
                raise _StepAborted(step, aborted)
            return out
        bufs = {pid: self._call(pid, {"op": "step_local",
                                             "step": step})["buf"]
                for pid in pids}
        red = run_schedule_rounds(self._proc_schedule(), bufs)
        return {pid: self._call(pid, {"op": "step_apply",
                                             "buf": red[pid],
                                             "step": step})
                for pid in pids}

    def _resolve_step(self, step: int) -> Optional[Dict[int, Dict]]:
        """Post-crash consistency probe: ask every survivor which step
        it last applied. All applied ``step`` → return their recorded
        results; none → None (the caller retries the step); a strict
        subset → ``StepInconsistent``."""
        while True:
            stat: Dict[int, Dict] = {}
            try:
                for pid in sorted(self.live):
                    stat[pid] = self._call(pid, {"op": "step_status"})
            except HostDead as e:
                self.recover_failure(e.pid, step=step)
                continue
            if not stat:
                return None
            applied = {p for p, s in stat.items()
                       if s.get("step") == step}
            if not applied:
                return None
            if applied == set(stat):
                if self.obs is not None:
                    self.obs.metrics.inc("failure.step_resolved_applied")
                return {p: {k: v for k, v in stat[p].items()
                            if k != "ok"} for p in stat}
            raise StepInconsistent(step, {p: s.get("step", -1)
                                          for p, s in stat.items()})

    def _proc_schedule(self):
        from ..core.collective import PhaserCollective
        keys = tuple(sorted(self.live))
        pc = PhaserCollective(len(keys), self.axis_name,
                              kind=self.proc_kind, seed=self.seed,
                              p=self.p, keys=keys,
                              leaf_keys=tuple(sorted(self.demoted)))
        sched = pc.unified_schedule()
        assert sched is not None, self.proc_kind
        return sched

    # --------------------------------------------------------- stragglers
    def record_step_times(self, step: int, times: Dict[int, float], *,
                          slack: float = 3.0, demote_after: int = 2,
                          evict_after: int = 3) -> List[int]:
        """Whole-host straggler policy — the same ``StrikeEscalation``
        the single-process runtime applies to workers, applied to
        processes: straggle, demote to a leaf, then evict."""
        from ..runtime_elastic.strikes import StrikeAction, StrikeEscalation
        esc = StrikeEscalation(slack=slack, demote_after=demote_after,
                               evict_after=evict_after,
                               strikes=self._strikes,
                               metrics=self.obs.metrics if self.obs
                               else None)
        evicted: List[int] = []

        def apply(act: StrikeAction) -> None:
            if act.action == "straggle":
                self.events.append(HostEvent(step, "straggle", act.worker))
            elif act.action == "evict":
                self.request_leave(act.worker, fail=True, step=step)
                evicted.append(act.worker)
            elif act.action == "demote":
                self.request_demote(act.worker, step=step)
            elif act.action == "recover":
                self.request_repromote(act.worker, step=step)

        compile_step = self._compile_pending
        self._compile_pending = False
        # wait attribution: a host slow because it *waited* on peers is
        # a victim, not a culprit — its blocked-on-WAIT seconds since
        # the last policy call are subtracted before the median test
        waits = (self.obs.watermarks.take_wait_deltas()
                 if self.obs is not None else None)
        esc.observe(self.live, times, demoted=self.demoted,
                    on_action=apply, compile_step=compile_step,
                    waits=waits)
        return evicted

    # ------------------------------------------------------- checkpointing
    def save_checkpoint(self, step: int) -> Dict:
        """Boundary checkpoint, written by the lowest live host (its
        manifest records the process set via the agent's program key)."""
        return self._call(min(self.live), {"op": "save",
                                                  "step": step})

    def precompile_all(self, program_key: Dict) -> Dict[int, bool]:
        """Compile (or cache-hit) the program identified by a manifest
        key on every live host; returns pid -> freshly-compiled flag."""
        return {pid: self._call(
                    pid, {"op": "precompile",
                          "program_key": program_key})["compiled"]
                for pid in sorted(self.live)}

    def restore_all(self, step: Optional[int] = None) -> int:
        steps = {pid: self._call(pid, {"op": "restore",
                                              **({"step": step}
                                                 if step is not None
                                                 else {})})["step"]
                 for pid in sorted(self.live)}
        assert len(set(steps.values())) == 1, steps
        return next(iter(steps.values()))

    def resume(self, step: Optional[int] = None) -> Dict:
        """Resume from the checkpoint manifest: read the recorded
        program key (the process set live AT SAVE TIME — after an
        eviction that is the surviving-host set, not the boot set),
        pre-compile that program on every live host, then restore the
        arrays. The pre-compile runs BEFORE the restore so the first
        post-resume step hits an already-built executable."""
        rep = self._call(min(self.live),
                                {"op": "manifest_key",
                                 **({"step": step} if step is not None
                                    else {})})
        pk = rep["program_key"]
        assert pk is not None, "checkpoint manifest has no program key"
        compiled = self.precompile_all(pk)
        restored = self.restore_all(step)
        return {"step": restored, "program_key": pk,
                "compiled": compiled}

    # --------------------------------------------------------- inspection
    def control_stats(self) -> Dict:
        """Cluster-wide control-plane counters (quiescent state)."""
        per = {pid: self._call(pid, {"op": "status"})
               for pid in sorted(self.live)}
        ms, mr = self.shard.flight_counters()
        frames = sum(v["sent"] for v in per.values()) + ms
        depth = max([v["max_depth"] for v in per.values()]
                    + [self.shard.net.max_depth])
        out = {"live": sorted(self.live), "epoch": self.epoch.index,
               "phase": self.shard.released(),
               "remote_frames": frames, "critical_path": depth,
               "per_host": per}
        if self.obs is not None:
            out["obs"] = self.obs.summary()
        return out

    def close(self) -> None:
        if self.obs is not None and self.live:
            try:
                self._collect_obs()   # epoch spans since the last advance
                self._emit_live_frame(phase=self.shard.released(),
                                      force=True)
            except Exception:
                pass                  # never let teardown fail on obs
        if self.live_stream is not None:
            self.live_stream.close()
        self.cluster.close()
