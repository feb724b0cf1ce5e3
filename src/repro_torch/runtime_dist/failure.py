"""Failure model of the multi-host control plane (DESIGN.md §13).

Crash-stop only: a process that fails stops sending forever — there is
no Byzantine tolerance anywhere in the runtime. Detection is layered:

* ``PhiDetector`` — a phi-accrual-style timeout detector over the
  coordinator's heartbeat acks. ``phi`` is the elapsed silence measured
  in units of the observed mean inter-ack interval, so a uniformly slow
  machine (CI under load) raises everyone's mean instead of raising
  false suspicion. A host is *suspected* when phi crosses
  ``phi_suspect``; it is *declared dead* only when BOTH the adaptive
  test (phi >= ``phi_dead``) and the hard floor (silence >= ``timeout``)
  hold — suspect -> confirm -> declare, never declare on one signal.
* Structured exceptions — every way a peer can fail surfaces as a typed
  error carrying the pid, so the coordinator's recovery path
  (``DistCoordinator.recover_failure``) can react mechanically.

Everything here is torch-free and import-light: worker processes and the
transport layer both import it.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional


class PeerUnreachable(ConnectionError):
    """Could not establish a transport connection to ``pid`` after
    ``attempts`` backoff retries over ``elapsed`` seconds."""

    def __init__(self, pid: int, attempts: int, elapsed: float):
        self.pid = pid
        self.attempts = attempts
        self.elapsed = elapsed
        super().__init__(f"peer {pid} unreachable after {attempts} "
                         f"connect attempts over {elapsed:.2f}s")


class HostDead(RuntimeError):
    """A host was declared dead (heartbeat timeout or simulated crash);
    the pending operation cannot complete against it."""

    def __init__(self, pid: int, reason: str = "declared dead"):
        self.pid = pid
        super().__init__(f"host {pid} {reason}")


class RpcTimeout(RuntimeError):
    """No reply for a command after retries, and the detector never
    declared the peer dead — the caller's deadline expired first."""

    def __init__(self, pid: int, cid: int, elapsed: float, attempts: int):
        self.pid = pid
        self.cid = cid
        self.elapsed = elapsed
        self.attempts = attempts
        super().__init__(f"no reply from host {pid} for cmd {cid} after "
                         f"{elapsed:.1f}s ({attempts} attempts)")


class StepInconsistent(RuntimeError):
    """After a mid-step crash, some survivors applied the step and some
    did not — params have diverged and only a checkpoint-consistent
    ``resume()`` can restore the replicated invariant."""

    def __init__(self, step: int, applied: Dict[int, int]):
        self.step = step
        self.applied = dict(applied)
        super().__init__(f"step {step} applied on a strict subset of "
                         f"survivors: {self.applied}")


def orphan_horizon(failure_timeout: float) -> float:
    """How long a worker tolerates coordinator silence before it
    self-terminates as an orphan.

    Partition-tolerance invariant: this must strictly exceed the
    coordinator's eviction horizon (``failure_timeout``), or a
    transient network partition shorter than the failure timeout —
    which the session layer heals with zero envelope loss and the
    PhiDetector resolves as suspect→recover — would still kill the
    worker from the *other* side. 3× the failure timeout (floored at
    10s so aggressive test timeouts don't make orphanhood hair-
    triggered) means any partition short enough to be survivable is
    also short enough that neither side acts on it.
    """
    return max(10.0, 3.0 * failure_timeout)


def backoff(attempt: int, base: float, cap: float, rng=None) -> float:
    """Bounded exponential backoff with optional jitter: attempt 1 waits
    ~``base``, doubling up to ``cap``; jitter spreads retries by up to
    +50% so replayed commands from many callers don't synchronize."""
    d = min(cap, base * (2 ** max(0, attempt - 1)))
    if rng is not None:
        d *= 1.0 + 0.5 * rng.random()
    return d


class PhiDetector:
    """Suspect -> confirm -> declare-dead over heartbeat acks.

    ``on_ack(pid, t)`` feeds ack arrival times; ``poll(now)`` returns
    the pids newly declared dead. All clocks are ``time.monotonic``.
    """

    ALIVE, SUSPECT, DEAD = "alive", "suspect", "dead"

    def __init__(self, *, interval: float = 0.5, timeout: float = 10.0,
                 phi_suspect: float = 4.0, phi_dead: float = 10.0,
                 window: int = 16, metrics=None):
        self.interval = max(1e-3, interval)
        self.timeout = timeout
        self.phi_suspect = phi_suspect
        self.phi_dead = phi_dead
        self.window = window
        self.metrics = metrics
        self.last: Dict[int, float] = {}        # pid -> last ack time
        self.ivals: Dict[int, List[float]] = {}  # pid -> recent intervals
        self.state: Dict[int, str] = {}
        self.declared: Dict[int, Dict] = {}      # pid -> {at, silence}

    # ------------------------------------------------------------ feeding
    def touch(self, pid: int, t: Optional[float] = None) -> None:
        """Start tracking ``pid`` (spawn time counts as the first ack,
        so a worker that never comes up still gets declared)."""
        t = time.monotonic() if t is None else t
        self.last.setdefault(pid, t)
        self.ivals.setdefault(pid, [])
        self.state.setdefault(pid, self.ALIVE)

    def on_ack(self, pid: int, t: Optional[float] = None) -> None:
        t = time.monotonic() if t is None else t
        if self.state.get(pid) == self.DEAD:
            return                    # late ack from a declared host
        prev = self.last.get(pid)
        if prev is not None:
            iv = self.ivals.setdefault(pid, [])
            iv.append(max(1e-4, t - prev))
            del iv[:-self.window]
        self.last[pid] = t
        if self.state.get(pid) == self.SUSPECT:
            self.state[pid] = self.ALIVE    # confirm failed: recovered
            if self.metrics is not None:
                self.metrics.inc("detector.recovered")
        else:
            self.state.setdefault(pid, self.ALIVE)

    def remove(self, pid: int) -> None:
        """Cooperative departure: stop tracking without declaring."""
        for d in (self.last, self.ivals, self.state, self.declared):
            d.pop(pid, None)

    # ------------------------------------------------------------ queries
    def phi(self, pid: int, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        last = self.last.get(pid)
        if last is None:
            return 0.0
        iv = self.ivals.get(pid) or []
        mean = (sum(iv) / len(iv)) if iv else self.interval
        return (now - last) / max(mean, 1e-4)

    def poll(self, now: Optional[float] = None) -> List[int]:
        """Advance every tracked host's state machine; returns pids
        newly declared dead (exactly once each)."""
        now = time.monotonic() if now is None else now
        newly: List[int] = []
        for pid in list(self.last):
            if self.state.get(pid) == self.DEAD:
                continue
            silence = now - self.last[pid]
            ph = self.phi(pid, now)
            if self.state[pid] == self.ALIVE:
                if ph >= self.phi_suspect or silence >= self.timeout / 2:
                    self.state[pid] = self.SUSPECT
                    if self.metrics is not None:
                        self.metrics.inc("detector.suspected")
            if self.state[pid] == self.SUSPECT:
                # declare only when the adaptive and hard tests agree
                if ph >= self.phi_dead and silence >= self.timeout:
                    self.state[pid] = self.DEAD
                    self.declared[pid] = {"at": now, "silence": silence}
                    newly.append(pid)
                    if self.metrics is not None:
                        self.metrics.inc("detector.declared_dead")
                        self.metrics.observe("detector.silence_seconds",
                                             silence)
        return newly
