"""Process-level schedule execution: ppermute rounds over the transport.

The hierarchical program's level-1 sync runs the epoch's round schedule
(``Schedule``: partial permutations with per-round add/copy ops) between
*processes*. Two executors produce bitwise-identical f32 results:

* ``run_schedule_rounds``  — central, round-major, over a dict of host
  buffers. The in-process cluster uses it (one thread can't block on
  peer receives), and it doubles as the reference mirror.
* ``exchange_schedule``    — the per-process half: each participant
  sends its pre-round buffer and applies at most one incoming buffer
  per round (schedules are partial permutations, so a destination
  receives exactly one message per round — same single-port model as
  the protocol's FIFO channels).

Equality across the two holds because each destination applies exactly
one combine per round, in round order, in f32.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Dict, Sequence

import numpy as np

if TYPE_CHECKING:  # core.collective imports torch; control-plane-only
    from ..core.collective import Schedule  # processes must stay torch-free


def run_schedule_rounds(sched: "Schedule",
                        bufs: Dict[int, np.ndarray], *,
                        metrics=None) -> Dict[int, np.ndarray]:
    """Execute ``sched`` centrally over per-rank f32 buffers (rank i of
    the schedule = sorted key i of ``bufs``). Returns the final buffers
    keyed like the input. ``metrics`` (an ``obs.MetricsRegistry``)
    accounts rounds and mirrored bytes."""
    keys = sorted(bufs)
    assert len(keys) == sched.n, (keys, sched.n)
    vals = [np.asarray(bufs[k], dtype=np.float32) for k in keys]
    for r, pairs in enumerate(sched.rounds):
        incoming = {d: vals[s].copy() for s, d in pairs}
        op = sched.op(r)
        for d, v in incoming.items():
            vals[d] = vals[d] + v if op == "add" else v
        if metrics is not None:
            metrics.inc("exchange.rounds")
            metrics.inc("exchange.bytes_moved",
                        sum(v.nbytes for v in incoming.values()))
    return {k: vals[i] for i, k in enumerate(keys)}


def exchange_schedule(sched: "Schedule", rank: int, pids: Sequence[int],
                      buf: np.ndarray, *,
                      send: Callable[[int, int, np.ndarray], None],
                      recv: Callable[[int, int], np.ndarray],
                      metrics=None) -> np.ndarray:
    """One participant's walk through ``sched``. ``pids[i]`` is the
    process id executing schedule rank ``i``; ``send(dst_pid, round,
    arr)`` / ``recv(src_pid, round)`` are the transport hooks (recv
    blocks until the peer's frame for that round arrives). ``metrics``
    accounts this participant's rounds and bytes sent."""
    buf = np.asarray(buf, dtype=np.float32)
    for r, pairs in enumerate(sched.rounds):
        out = [d for s, d in pairs if s == rank]
        inc = [s for s, d in pairs if d == rank]
        for d in out:
            send(pids[d], r, buf.copy())
        if metrics is not None:
            metrics.inc("exchange.rounds")
            if out:
                metrics.inc("exchange.bytes_sent",
                            buf.nbytes * len(out))
        if inc:
            (s,) = inc  # partial permutation: at most one per round
            v = recv(pids[s], r)
            buf = buf + v if sched.op(r) == "add" else v
    return buf
