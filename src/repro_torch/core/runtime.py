"""Event-driven message-passing runtime for the distributed-phaser protocol.

Models an APGAS-style cluster: one actor per participant, FIFO channels per
(src, dst) pair, and a pluggable delivery scheduler. Three schedulers cover
the three uses of the runtime:

* ``RandomScheduler``  — seeded adversarial interleavings (property tests);
* ``FifoScheduler``    — deterministic round-robin (benchmarks, examples);
* external control     — the model checker drives ``deliver_from`` directly.

Complexity accounting: every message carries a Lamport-style ``depth`` so the
*critical path length* (the paper's time-complexity measure) is observable
independently of the interleaving; total message counts per kind give the
message complexity.
"""
from __future__ import annotations

import random
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

from .messages import Msg


@dataclass
class Envelope:
    msg: Msg
    depth: int  # critical-path hops accumulated when this message departs
    # span context (trace id, span id, tree depth) when the network has a
    # tracer attached — a plain tuple so it pickles across transports
    trace: Optional[tuple] = None
    # membership generation (incarnation) stamped by the partitioned
    # network at post time: after a non-cooperative eviction rebuilds the
    # survivors, in-flight frames of the old incarnation are fenced at
    # ingest instead of corrupting the fresh phase state
    gen: int = 0


class Actor:
    """Base actor. Subclasses implement ``handle(msg)`` and use ``send``."""

    def __init__(self, rank: int, net: "Network"):
        self.rank = rank
        self.net = net
        self.clock = 0  # Lamport critical-path clock (hops)

    def send(self, dst: int, msg: Msg) -> None:
        assert msg.src == self.rank and msg.dst == dst, (msg, self.rank, dst)
        env = Envelope(msg, self.clock + 1)
        tr = self.net.tracer
        if tr is not None:
            env.trace = tr.on_send(self.rank, msg, env.depth)
        self.net.post(env)

    def handle(self, msg: Msg) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


class Network:
    """FIFO channels + stats. Delivery order across channels is the
    scheduler's choice; within a channel it is FIFO (matching the paper's
    point-to-point ordering assumption)."""

    def __init__(self):
        self.channels: Dict[Tuple[int, int], Deque[Envelope]] = defaultdict(deque)
        self.actors: Dict[int, Actor] = {}
        self.sent: Dict[str, int] = defaultdict(int)
        self.delivered: Dict[str, int] = defaultdict(int)
        self.max_depth = 0
        self.trace: Optional[List[Msg]] = None  # set to [] to record
        self.tracer = None  # obs.trace.Tracer: per-envelope span contexts

    # -- wiring -------------------------------------------------------------
    def register(self, actor: Actor) -> None:
        self.actors[actor.rank] = actor

    def post(self, env: Envelope) -> None:
        self.sent[env.msg.kind] += 1
        self.channels[(env.msg.src, env.msg.dst)].append(env)

    # -- delivery -----------------------------------------------------------
    def nonempty_channels(self) -> List[Tuple[int, int]]:
        return sorted(k for k, q in self.channels.items() if q)

    def deliver_from(self, channel: Tuple[int, int]) -> Msg:
        env = self.channels[channel].popleft()
        actor = self.actors[env.msg.dst]
        actor.clock = max(actor.clock, env.depth)
        self.max_depth = max(self.max_depth, env.depth)
        self.delivered[env.msg.kind] += 1
        if self.trace is not None:
            self.trace.append(env.msg)
        if self.tracer is not None and env.trace is not None:
            # closes the span AND makes it the handler's current context
            # (sends inside handle() become its children)
            self.tracer.on_deliver(env.trace, env.msg.dst)
        actor.handle(env.msg)
        return env.msg

    def idle(self) -> bool:
        return not any(self.channels.values())

    # -- stats ----------------------------------------------------------------
    def total_sent(self) -> int:
        return sum(self.sent.values())

    def reset_stats(self) -> None:
        self.sent.clear()
        self.delivered.clear()
        self.max_depth = 0
        for a in self.actors.values():
            a.clock = 0


class Scheduler:
    def step(self, net: Network) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError

    def run(self, net: Network, max_steps: int = 10_000_000) -> int:
        """Drive to quiescence; returns number of deliveries."""
        n = 0
        while not net.idle():
            if not self.step(net):
                break
            n += 1
            if n > max_steps:
                raise RuntimeError("scheduler did not quiesce "
                                   f"(>{max_steps} deliveries)")
        return n


class FifoScheduler(Scheduler):
    """Deterministic round-robin over channels."""

    def __init__(self):
        self._rr = 0

    def step(self, net: Network) -> bool:
        chans = net.nonempty_channels()
        if not chans:
            return False
        net.deliver_from(chans[self._rr % len(chans)])
        self._rr += 1
        return True


class RandomScheduler(Scheduler):
    """Seeded adversarial interleaving: uniformly random channel each step."""

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)

    def step(self, net: Network) -> bool:
        chans = net.nonempty_channels()
        if not chans:
            return False
        net.deliver_from(self.rng.choice(chans))
        return True


class PriorityScheduler(Scheduler):
    """Deliver non-focus messages eagerly/deterministically; used by the
    model checker's message-based decomposition (DESIGN.md §2): only the
    focus class branches, everything else collapses to one canonical order."""

    def __init__(self, focus_kinds: Tuple[str, ...]):
        self.focus = set(focus_kinds)

    def nonfocus_channels(self, net: Network) -> List[Tuple[int, int]]:
        return [c for c in net.nonempty_channels()
                if net.channels[c][0].msg.kind not in self.focus]

    def step(self, net: Network) -> bool:
        nf = self.nonfocus_channels(net)
        if nf:
            net.deliver_from(nf[0])
            return True
        chans = net.nonempty_channels()
        if not chans:
            return False
        net.deliver_from(chans[0])
        return True
