"""Execution of a gradient sync over the stacked bucket buffer. Port of
``repro/collective_exec/executor.py``.

``execute_flat`` is the data plane of one gradient sync: it runs the
epoch's schedule over the team's ``RankStack`` (``(n, n_buckets,
bucket_elems)``, rank r in row r), each round a ``ppermute`` and one
``bucket_combine`` launch covering every rank (the hand-written kernel
on the card, its plain version on the CPU). ``halving_doubling`` runs
its own segment-level executor and ``xla_psum`` is the stacked sum.

``execute_flat_pipelined`` keeps the reference's skewed double-buffered
round order over the readiness groups: at tick ``t`` group ``g`` runs
round ``t - g``, and every active group's ``ppermute`` is issued before
any group's combine. The per-element combine sequence equals
``execute_flat``'s, so the result is bitwise equal. In eager PyTorch
the groups do not yet overlap the backward pass (that needs backward
hooks and a side stream; ROADMAP).

The reference emits the schedule's round grid to the active timeline
once per lowering of a program; ``emit_round_grid`` is that hook,
called once per program build.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..core.collective import (PhaserCollective, RankStack,
                               halving_doubling_allreduce,
                               schedule_allreduce)
from ..kernels.bucket_combine import bucket_combine
from ..obs import timeline as obs_timeline


def emit_round_grid(pc: PhaserCollective, n_groups: int,
                    pipelined: bool) -> None:
    """Put the schedule's round grid on the active timeline (if any):
    one row per bucket group, overlapped groups skewed by their tick."""
    tl = obs_timeline.current()
    sched = pc.unified_schedule()
    if tl is None or sched is None:
        return
    if not pipelined:
        tl.extend(obs_timeline.gradsync_round_events(sched))
        return
    for g in range(n_groups):
        tl.extend(obs_timeline.gradsync_round_events(sched, group=g,
                                                     offset=g))


def execute_flat(flat: torch.Tensor, pc: PhaserCollective,
                 stack: RankStack) -> torch.Tensor:
    """All-reduce the stacked ``(n, n_buckets, bucket_elems)`` buffer
    through the collective's schedule; returns a new tensor in which
    every rank's row holds the sum."""
    if pc.kind == "xla_psum":
        return stack.psum(flat)
    if pc.kind == "halving_doubling":
        return halving_doubling_allreduce(flat, stack, pc.n)
    return schedule_allreduce(flat, stack, pc.unified_schedule())


def execute_flat_pipelined(bufs: Sequence[torch.Tensor],
                           pc: PhaserCollective,
                           stack: RankStack) -> List[torch.Tensor]:
    """All-reduce each readiness group's stacked ``(n, g_buckets,
    bucket_elems)`` buffer, pipelining the schedule across groups.
    ``bufs`` are in readiness order; so is the result. The combine is
    launched per (group, round) on the group's own rows."""
    bufs = list(bufs)
    if pc.kind == "xla_psum":
        return [stack.psum(b) for b in bufs]
    if pc.kind == "halving_doubling":
        return [halving_doubling_allreduce(b, stack, pc.n) for b in bufs]
    sched = pc.unified_schedule()
    gates = [stack.gate(pairs) for pairs in sched.rounds]
    R, G = sched.depth, len(bufs)
    for t in range(R + G - 1):
        active = [g for g in range(G) if 0 <= t - g < R]
        # double buffering: issue every active group's ppermute first ...
        inflight = [(g, t - g, stack.ppermute(bufs[g], sched.rounds[t - g]))
                    for g in active]
        # ... then combine
        for g, r, y in inflight:
            bufs[g] = bucket_combine(bufs[g], y, gates[r], op=sched.op(r))
    return bufs
