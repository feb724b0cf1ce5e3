"""Gradient-sync train-step programs: phaser schedules over the stacked
team. Port of ``repro/collective_exec/program.py``.

``build_gradsync_program`` turns one membership epoch's gradient sync
into an executable train step:

  1. each rank computes loss and grads on its own shard of the batch,
     with the one copy of the parameters (the ranks run one after
     another on one device),
  2. rank r's grads, scaled by its alive flag, are flattened with the
     flag into row r of a stacked ``(n, n_buckets, bucket_elems)`` f32
     buffer allocated once per program (``buckets.py``),
  3. the epoch's schedule runs over the stack, each round one
     ``bucket_combine`` launch for every rank (``executor.py``),
  4. rank 0's row is unflattened (the reference's replicated output
     reads device 0), the masked mean is taken from the reduced alive
     count, and AdamW runs once on the single parameter copy.

``overlap="pipelined"`` syncs per readiness group through the
double-buffered executor; ``microbatches > 1`` splits each rank's shard
and runs one bucket stream per microbatch with the flag at a/M. Both
execute the reference's per-element combine sequence, so pipelined is
bitwise equal to eager at fixed ``microbatches``.

``build_hier_gradsync_program`` is the multi-host runtime's two-level
sync (DESIGN.md §11): level 0 reduces one host process's M ranks,
stacked on its device, through the local schedule's ``bucket_combine``
rounds; level 1, the process-level schedule, runs between processes
over the transport on the host copy of the flat buffer
(``runtime_dist``).

``build_allreduce_program`` is the bare data-plane program (no model):
it all-reduces a stacked per-rank value through the same bucket path.

A step's three parts are ``torch.profiler`` ranges marked on the device
too (``obs.timeline.span(..., device=True)``; ``gradsync.grads``:
every rank's forward, backward and flatten; ``gradsync.sync``;
``gradsync.update``), so a profile splits device time among them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from ..core.collective import PhaserCollective, RankStack
from ..obs.timeline import span
from ..utils import tree_map
from .buckets import BucketLayout, make_layout
from .executor import emit_round_grid, execute_flat, execute_flat_pipelined

OVERLAP_MODES = ("eager", "pipelined")


def reduce_worker_metrics(pm: Dict[str, torch.Tensor],
                          meta: Dict[str, int]) -> Dict[str, Any]:
    """Per-worker (n,) metric rows -> scalars: masked mean for the
    pre-sync losses, the sum for the alive count, rank 0's copy for
    post-sync values, plus the program's static meta."""
    n_alive = torch.clamp(pm["alive"].sum(), min=1.0)
    out = {}
    for k, v in pm.items():
        if k in ("loss", "aux"):
            out[k] = v.sum() / n_alive
        elif k == "alive":
            out[k] = v.sum()
        else:
            out[k] = v[0]
    out.update({k: torch.tensor(float(v), dtype=torch.float32)
                for k, v in meta.items()})
    return out


def _shard(batch: Dict, r: int, n: int, stacked: bool) -> Dict:
    """Rank r's part of the batch: row r of a stacked batch, or the r-th
    contiguous block of a global one (the reference's ``P(axis)``)."""
    if stacked:
        return {k: v[r] for k, v in batch.items()}
    return {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[r]
            for k, v in batch.items()}


@dataclass
class GradSyncProgram:
    """One epoch's train step. ``key`` is the program-cache identity:
    (member_set, kind, seed, p, overlap, microbatches)."""

    key: tuple
    pc: PhaserCollective
    stack: RankStack
    layout: BucketLayout
    run: Callable             # (params, opt, batch, alive) -> (p, o, pm)
    stacked: bool
    meta: Dict[str, int] = field(default_factory=dict)
    # the last step's stacked buffer and its reduced groups (references,
    # no copies; the buffer is refilled by the next step)
    last: Dict[str, Any] = field(default_factory=dict)

    @property
    def n(self) -> int:
        return self.pc.n

    def step(self, params, opt_state, batch, alive=None):
        """Run one synced step; ``alive`` defaults to the full team."""
        if alive is None:
            alive = torch.ones((self.pc.n,), dtype=torch.float32,
                               device=self.stack.device)
        return self.run(params, opt_state, batch, alive)

    # single-axis programs carry canonical state: the converters exist
    # so loops drive this and the pipeline program alike
    def bind_state(self, params, opt_state):
        return params, opt_state

    def readout_state(self, params, opt_state):
        return params, opt_state

    def reduce_metrics(self, pm: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        return reduce_worker_metrics(pm, self.meta)

    def last_sync(self):
        """``(stacked, reduced)`` of the last step: the ``(n, n_buckets,
        bucket_elems)`` buffer its last microbatch synced, and rank 0's
        reduced ``(n_buckets, bucket_elems)`` row (summed over the
        microbatches)."""
        red = self.last["reduced"]
        row0 = red[0][0] if len(red) == 1 else torch.cat([b[0] for b in red])
        return self.last["stacked"], row0


def build_gradsync_program(api, opt, pc: PhaserCollective, *,
                           device="cuda", stacked: bool = False,
                           remat: bool = False,
                           overlap: str = "eager",
                           microbatches: int = 1,
                           block_groups: Optional[int] = None
                           ) -> GradSyncProgram:
    """The epoch's schedule as a train step over a ``RankStack`` on
    ``device``.

    ``stacked=True`` takes per-worker batches stacked on a leading team
    axis (leaves ``(n, B, S)``); ``stacked=False`` splits a global batch
    (leaves ``(B, S)``, ``B % n == 0``) into n contiguous shards.
    ``overlap``, ``microbatches`` and ``block_groups`` as in the
    reference: grouping only partitions the buffer, never the
    per-element combine sequence.
    """
    assert overlap in OVERLAP_MODES, overlap
    assert microbatches >= 1, microbatches
    n = pc.n
    stack = RankStack(n, device)
    layout = make_layout(api.param_spec(), block_groups=block_groups or 1)
    pipelined = overlap == "pipelined"
    emit_round_grid(pc, layout.n_groups, pipelined)
    bufs: List[torch.Tensor] = []      # the stacked buffer, made once
    last: Dict[str, Any] = {}

    def sync(buf: torch.Tensor) -> List[torch.Tensor]:
        """One bucket-stream all-reduce; returns per-group buffers."""
        if pipelined:
            return execute_flat_pipelined(layout.split_groups(buf), pc,
                                          stack)
        return [execute_flat(buf, pc, stack)]

    def unflatten_rank0(red: List[torch.Tensor]):
        if pipelined:
            return layout.unflatten_groups([b[0] for b in red])
        return layout.unflatten(red[0][0])

    def rank_grads(params, shards, alive, k, losses, auxes):
        """Every rank's loss and grads on microbatch k of its shard,
        flattened with its flag into its row of the stacked buffer."""
        for r in range(n):
            b = shards[r]
            if microbatches > 1:
                b = {key: v.reshape(microbatches,
                                    v.shape[0] // microbatches,
                                    *v.shape[1:])[k]
                     for key, v in b.items()}
            a = alive[r]
            (_, m), grads = api.value_and_grad(params, b, remat=remat)
            grads = tree_map(lambda g: g * a.to(g.dtype), grads)
            layout.flatten_into(bufs[0][r], grads, a / microbatches
                                if microbatches > 1 else a)
            losses[r] = losses[r] + m["loss"]
            auxes[r] = auxes[r] + m["aux"]

    def run(params, opt_state, batch, alive):
        if not bufs:
            bufs.append(torch.zeros((n, layout.n_buckets,
                                     layout.bucket_elems),
                                    dtype=torch.float32, device=stack.device))
        alive = alive.to(device=stack.device, dtype=torch.float32)
        shards = [_shard(batch, r, n, stacked) for r in range(n)]
        losses = [torch.zeros((), device=stack.device) for _ in range(n)]
        auxes = [torch.zeros((), device=stack.device) for _ in range(n)]
        synced = None
        for k in range(microbatches):
            with span("gradsync.grads", device=True):
                rank_grads(params, shards, alive, k, losses, auxes)
            with span("gradsync.sync", device=True):
                red = sync(bufs[0])
            if synced is None:
                # the next microbatch refills the buffer, which a
                # one-rank sync returns as it is
                synced = ([t.clone() for t in red] if microbatches > 1
                          else red)
            else:
                synced = [s + t for s, t in zip(synced, red)]
        last.update(stacked=bufs[0], reduced=synced)
        with span("gradsync.update", device=True):
            grads, count = unflatten_rank0(synced)
            inv = 1.0 / torch.clamp(count, min=1.0)
            if microbatches > 1:
                inv = inv / microbatches
            grads = tree_map(lambda g: g * inv.to(g.dtype), grads)
            new_p, new_o, om = opt.update(grads, opt_state, params)
        loss = torch.stack(losses) / microbatches
        aux = torch.stack(auxes) / microbatches
        pm = {"loss": loss * alive, "aux": aux * alive, "alive": alive,
              **{k: v.float().reshape(1).expand(n) for k, v in om.items()}}
        return new_p, new_o, pm

    st = pc.stats()
    meta = {"team": n, "sync_rounds": st["rounds"],
            "sync_messages": st["messages"],
            "overlap": int(pipelined),
            "bucket_groups": layout.n_groups,
            "microbatches": microbatches}
    return GradSyncProgram(key=(pc.keys, pc.kind, pc.seed, pc.p,
                                overlap, microbatches),
                           pc=pc, stack=stack, layout=layout, run=run,
                           stacked=stacked, meta=meta, last=last)


@dataclass
class HierSyncProgram:
    """Two-level gradient sync for one host process of the multi-host
    runtime (DESIGN.md §11). Level 0 reduces the process's M ranks,
    stacked on its device (the local collective); level 1 runs the
    *process-level* schedule, derived from the same skip-list oracle
    over the live process keys, as transport messages between
    processes. Only the flat bucket buffer crosses the process boundary:

      ``local_grads``: (params, opt, batch, alive) -> (flat, pm): each
          rank's grads, flattened with its alive flag into its row of
          the stacked ``(M, n_buckets, bucket_elems)`` buffer (made once
          per program), reduced by the local schedule so every row holds
          the process-partial sum; ``flat`` is row 0, ``pm`` the
          per-rank ``(M,)`` loss and alive rows;
      ``apply``: (params, opt, flat) -> (params, opt, om): unflatten the
          *globally* reduced buffer, take the masked mean by the reduced
          alive count (live processes x M), one AdamW update.

    Identical reduced buffers on every process keep the parameters
    replicated across hosts with no parameter traffic. ``key`` is keyed
    by the process-level collective: the cache entry a surviving host
    re-commits at each churn epoch boundary."""

    key: tuple
    pc_proc: PhaserCollective     # process-level collective (epoch id)
    pc_local: PhaserCollective    # the local M-rank collective
    stack: RankStack
    layout: BucketLayout
    local_grads: Callable
    apply: Callable
    meta: Dict[str, int] = field(default_factory=dict)
    # the last local sync's stacked buffer and its reduced result
    # (references, no copies; refilled by the next step)
    last: Dict[str, Any] = field(default_factory=dict)

    @property
    def proc_schedule(self):
        """The round schedule the owning process executes over the
        transport (add rounds reduce, copy rounds hydrate)."""
        return self.pc_proc.unified_schedule()


def build_hier_gradsync_program(api, opt, pc_proc: PhaserCollective, *,
                                local_ranks: int, device="cuda",
                                local_kind: str = "phaser_scsl"
                                ) -> HierSyncProgram:
    """One churn epoch's hierarchical sync for one process.

    ``pc_proc`` spans the live *process* keys (the epoch identity); the
    local level is a fresh collective over ``range(local_ranks)``,
    stacked on ``device``: identical on every host, so the programs
    differ only by their slice of the batch. ``pc_proc.kind`` must be a
    whole-buffer round schedule (``phaser_scsl`` or
    ``recursive_doubling``): the cross-process rounds are executed by
    the transport. Batches are stacked per rank (leaves ``(M, B, S)``).
    """
    assert pc_proc.unified_schedule() is not None, \
        f"process-level kind {pc_proc.kind!r} is not a round schedule"
    m = local_ranks
    pc_local = PhaserCollective(m, pc_proc.axis_name, kind=local_kind,
                                seed=pc_proc.seed)
    stack = RankStack(m, device)
    layout = make_layout(api.param_spec())
    emit_round_grid(pc_local, layout.n_groups, False)
    bufs: List[torch.Tensor] = []      # the stacked buffer, made once
    last: Dict[str, Any] = {}

    def local_grads(params, opt_state, batch, alive):
        if not bufs:
            bufs.append(torch.zeros((m, layout.n_buckets,
                                     layout.bucket_elems),
                                    dtype=torch.float32,
                                    device=stack.device))
        alive = alive.to(device=stack.device, dtype=torch.float32)
        losses = []
        with span("gradsync.grads", device=True):
            for r in range(m):
                a = alive[r]
                (_, met), grads = api.value_and_grad(
                    params, {k: v[r] for k, v in batch.items()})
                grads = tree_map(lambda g: g * a.to(g.dtype), grads)
                layout.flatten_into(bufs[0][r], grads, a)
                losses.append(met["loss"] * a)
        with span("gradsync.sync", device=True):
            red = execute_flat(bufs[0], pc_local, stack)
        last.update(stacked=bufs[0], reduced=red)
        # every local rank holds the same locally reduced buffer
        return red[0], {"loss": torch.stack(losses), "alive": alive}

    def apply(params, opt_state, flat: torch.Tensor):
        with span("gradsync.update", device=True):
            grads, count = layout.unflatten(flat)
            inv = 1.0 / torch.clamp(count, min=1.0)
            grads = tree_map(lambda g: g * inv.to(g.dtype), grads)
            new_p, new_o, om = opt.update(grads, opt_state, params)
        return new_p, new_o, {k: v.float() for k, v in om.items()}

    st = pc_proc.stats()
    lst = pc_local.stats()
    meta = {"team": pc_proc.n * m, "processes": pc_proc.n,
            "local_devices": m,
            "sync_rounds": st["rounds"] + lst["rounds"],
            "sync_messages": st["messages"] * m + lst["messages"]}
    return HierSyncProgram(
        key=(pc_proc.keys, pc_proc.kind, pc_proc.seed, pc_proc.p,
             "hier", m, local_kind),
        pc_proc=pc_proc, pc_local=pc_local, stack=stack, layout=layout,
        local_grads=local_grads, apply=apply, meta=meta, last=last)


def build_allreduce_program(pc: PhaserCollective, spec, *,
                            device="cuda") -> Callable:
    """A bare bucketed all-reduce: ``(n, *spec.shape)`` stacked per-rank
    values -> the same, every rank holding the reduced sum."""
    stack = RankStack(pc.n, device)
    layout = make_layout({"x": spec})

    def run(x: torch.Tensor) -> torch.Tensor:
        buf = torch.stack([layout.flatten({"x": x[r].float()}, 1.0)
                           for r in range(pc.n)])
        red = execute_flat(buf, pc, stack)
        return torch.stack([layout.unflatten(red[r])[0]["x"]
                            for r in range(pc.n)]).to(x.dtype)

    return run
