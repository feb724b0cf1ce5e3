"""Pipeline-parallel train programs on a (stage, data) grid stacked on
one device. Port of ``repro/pipeline_exec/stage_program.py``.

``build_pipeline_program`` runs the point-to-point dependency graph of
``core/p2p.py`` (chunks SIG toward their successor, WAIT on their
predecessor) as one train step over a grid of S stage rows by n data
ranks, every cell of which runs on one device, as ``RankStack`` stacks
the data axis of the single-axis program:

* the **stage axis** partitions the stacked blocks. With
  ``interleave = v`` stage s owns the v chunks s, s+S, ... (the looping
  placement), so consecutive chunks sit on neighbouring stages. Waves
  run in the interleaved 1F1B order ``derive_interleaved`` derives from
  the phase ordering (``schedule.py``), each stage's (chunk group,
  microbatch) item from the reference's ``wave - stage`` arithmetic. The
  reference's stage-axis ``ppermute`` is a hand-off of the previous
  wave's registers: every stage reads them as they stood before the
  wave (double-buffered), never a neighbour's fresh output. Items the
  reference masks as inactive are skipped; their gated contribution is
  zero. A backward wave recomputes its chunk from the parked incoming
  activation with autograd (the reference's ``jax.vjp``) and pulls the
  reference's cotangents through it; parked activations live in
  per-chunk rings of ``sched.ring_slots`` slots.
* the **data axis** runs the elastic epoch's collective schedule
  unchanged: each stage row's grads flatten into the bucket layout of
  the LOCAL param slice (v·per block rows plus the io params) and sync
  through ``execute_flat`` / ``execute_flat_pipelined``, i.e. through
  the ``bucket_combine`` kernel on the card. All stage rows share one
  layout, so their buffers fold into the kernel's rows dim: one launch
  a round covers every (rank, stage row), as ``(n, S * n_buckets,
  bucket_elems)`` (per readiness group with ``overlap="pipelined"``).
  The io grads (embedding, final norm, shared block) are summed over
  the stages first, which covers a tied embedding used by stage 0 and
  stage S-1, and the AdamW clip norm is global over stages, so the
  update is the single-axis step's to f32 rounding.

Carried state stays in the canonical layer order: on one device a
stage's chunks are row slices of the stacked blocks, so there is no
shard to keep contiguous and ``bind_state`` / ``readout_state`` are the
identity (their round trip is trivially bitwise).

A step's parts are ``torch.profiler`` ranges marked on the device too
(``obs.timeline.span(..., device=True)``): ``pipeline.fwd`` (a
forward wave), ``pipeline.bwd`` (a backward wave, recompute included),
``gradsync.sync`` and ``gradsync.update``. Building a program puts the
schedule's wave grid and the sync's round grid on the active timeline.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..collective_exec.buckets import make_layout
from ..collective_exec.executor import (emit_round_grid, execute_flat,
                                        execute_flat_pipelined)
from ..collective_exec.program import (OVERLAP_MODES, _shard,
                                       reduce_worker_metrics)
from ..core.collective import PhaserCollective, RankStack
from ..obs import timeline as obs_timeline
from ..obs.timeline import span
from ..utils import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .schedule import PipelineSchedule, derive_interleaved

STAGE_AXIS = "stage"


def stage_partition(api, n_stages: int,
                    interleave: int = 1) -> Tuple[Tuple[int, int], ...]:
    """The chunk map: contiguous [lo, hi) slices of the stacked-blocks
    scan axis, one per CHUNK (``n_stages * interleave`` virtual stages;
    chunk c belongs to stage ``c % n_stages``). The scan length
    (layers, or groups for the grouped families) must divide evenly."""
    assert n_stages >= 1 and interleave >= 1, (n_stages, interleave)
    assert api.pipeline_supported(), \
        f"pipeline: family {api.cfg.family!r} keeps the single-axis path"
    n_chunks = n_stages * interleave
    spec = api.param_spec()
    lens = {l.shape[0] for l in tree_leaves(spec["blocks"])}
    assert len(lens) == 1, f"ragged scan axis: {lens}"
    scan_len = lens.pop()
    assert scan_len % n_chunks == 0, \
        f"scan length {scan_len} not divisible by {n_chunks} chunks " \
        f"({n_stages} stages x {interleave} interleave)"
    per = scan_len // n_chunks
    return tuple((c * per, (c + 1) * per) for c in range(n_chunks))


@dataclass
class PipelineProgram:
    """One epoch's 2-D train step. Mirrors ``GradSyncProgram``'s surface
    (``step``/``reduce_metrics``) so the train loop drives both alike;
    ``key`` also carries the chunk map and the pipeline config."""

    key: tuple
    pc: PhaserCollective
    stack: RankStack
    sched: PipelineSchedule
    stage_map: Tuple[Tuple[int, int], ...]
    interleave: int
    layout: Any
    run: Callable             # (params, opt, batch, alive) -> (p, o, pm)
    stacked: bool
    meta: Dict[str, int] = field(default_factory=dict)

    @property
    def n(self) -> int:
        return self.pc.n

    @property
    def n_stages(self) -> int:
        return len(self.stage_map) // self.interleave

    def step(self, params, opt_state, batch, alive=None):
        """One step; ``alive`` defaults to the full team."""
        if alive is None:
            alive = torch.ones((self.pc.n,), dtype=torch.float32,
                               device=self.stack.device)
        return self.run(params, opt_state, batch, alive)

    def bind_state(self, params, opt_state):
        """Canonical state -> the carried layout: the identity here (see
        the module doc)."""
        return params, opt_state

    def readout_state(self, params, opt_state):
        """Carried state -> canonical layer order: the identity here."""
        return params, opt_state

    def reduce_metrics(self, pm: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        return reduce_worker_metrics(pm, self.meta)


def build_pipeline_program(api, opt, pc: PhaserCollective, *,
                           n_stages: int,
                           interleave: int = 1,
                           device="cuda",
                           microbatches: int = 1,
                           stacked: bool = False,
                           remat: bool = False,
                           overlap: str = "eager",
                           block_groups: Optional[int] = None
                           ) -> PipelineProgram:
    """The epoch's 2-D program: the (interleaved) 1F1B stage pipeline
    over the stage rows and the epoch's gradient-sync schedule over the
    data ranks, on ``device``. ``microbatches`` is the pipeline depth M
    (each rank's shard splits along its leading dim); ``interleave`` is
    the virtual-stage count v per stage (M % S == 0 for v > 1);
    ``stacked``, ``overlap`` and ``block_groups`` as in
    ``build_gradsync_program``."""
    assert overlap in OVERLAP_MODES, overlap
    assert microbatches >= 1, microbatches
    S, M, v = n_stages, microbatches, interleave
    n = pc.n
    stack = RankStack(n, device)
    stage_map = stage_partition(api, S, v)
    sched = derive_interleaved(S, M, v)
    tl = obs_timeline.current()
    if tl is not None:
        # the schedule's wave/stage occupancy grid (one event per filled
        # slot, gaps = bubble) for the Chrome trace
        tl.extend(obs_timeline.pipeline_wave_events(
            sched, label=f":S{S}M{M}v{v}"))
    per = stage_map[0][1] - stage_map[0][0]
    Vc = S * v
    spec = api.param_spec()
    local_spec = dict(spec)
    local_spec["blocks"] = tree_map(
        lambda l: torch.empty((v * per, *l.shape[1:]), dtype=l.dtype,
                              device="meta"), spec["blocks"])
    layout = make_layout(local_spec, block_groups=block_groups or 1)
    pipelined = overlap == "pipelined"
    emit_round_grid(pc, layout.n_groups, pipelined)
    nb, be = layout.n_buckets, layout.bucket_elems
    inv_M = 1.0 / M
    R = sched.ring_slots
    # stage s's local block rows: its chunks s, s+S, ... in group order
    stage_rows = [[stage_map[j * S + s] for j in range(v)]
                  for s in range(S)]
    bufs: List[torch.Tensor] = []      # (n, S, nb, be), made once

    def local_blocks(tree, s):
        """Stage s's (v·per, ...) slice of a canonical blocks tree."""
        return tree_map(lambda t: torch.cat([t[lo:hi] for lo, hi
                                             in stage_rows[s]]), tree)

    def rank_pipeline(params, tok_s, tgt_s):
        """One data rank's pass over the wave schedule: (loss, aux, f32
        block grads in canonical rows, f32 io grads), summed over the
        stages."""
        blocks = params["blocks"]
        io = {k: p for k, p in params.items() if k != "blocks"}
        io_paths, io_leaves = tree_flatten(io)
        blk_paths = tree_flatten(blocks)[0]
        dev = tok_s.device
        g_blocks = tree_map(lambda p: torch.zeros(p.shape,
                                                  dtype=torch.float32,
                                                  device=p.device), blocks)
        g_io = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in io_leaves]
        g_blk_leaves = tree_flatten(g_blocks)[1]
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        aux_acc = torch.zeros((), dtype=torch.float32, device=dev)
        # registers: the value each stage sent in the last wave (None =
        # the zeros of an idle stage); parked-activation rings per
        # (stage, chunk group)
        fwd_reg: List[Optional[torch.Tensor]] = [None] * S
        bwd_reg: List[Optional[torch.Tensor]] = [None] * S
        acts = [[[None] * R for _ in range(v)] for _ in range(S)]

        def chunk(c):
            lo, hi = stage_map[c]
            return tree_map(lambda t: t[lo:hi], blocks)

        for kind, w in sched.waves:
            if kind == "F":
                with span("pipeline.fwd", device=True):
                    # static, as in the reference: only stage 0 consumes
                    # the embedding, and only when its item is group 0
                    we = (0 <= w < v * M) and (w // S) % v == 0
                    new: List[Optional[torch.Tensor]] = [None] * S
                    for s in range(S):
                        src = (s - 1) % S if v > 1 else s - 1
                        y = fwd_reg[src] if src >= 0 else None
                        r = w - s
                        if not 0 <= r < v * M:
                            continue
                        j = (r // S) % v
                        m = (r // Vc) * S + r % S
                        use_embed = we and s == 0 and j == 0
                        with torch.no_grad():
                            h = (api.embed_fn(io, tok_s[m]) if use_embed
                                 else y)
                            assert h is not None, ("F", w, s, j, m)
                            new[s] = api.stage_fn(io, chunk(j * S + s),
                                                  h)[0]
                        # park the incoming activation for the backward
                        # recompute (this chunk's 1F1B in-flight set)
                        acts[s][j][m % R] = y
                    fwd_reg = new
            else:
                with span("pipeline.bwd", device=True):
                    r0 = w - (S - 1)
                    we = (0 <= r0 < v * M) and \
                        (v - 1) - (r0 // S) % v == 0
                    wh = (0 <= w < v * M) and (w // S) % v == 0
                    new = [None] * S
                    for s in range(S):
                        src = (s + 1) % S if v > 1 else s + 1
                        cot = bwd_reg[src] if src < S else None
                        r = w - (S - 1 - s)
                        if not 0 <= r < v * M:
                            continue
                        j = (v - 1) - (r // S) % v
                        m = (r // Vc) * S + r % S
                        c = j * S + s
                        last_chunk = s == S - 1 and j == v - 1
                        use_embed = we and s == 0 and j == 0
                        use_head = wh and last_chunk
                        recv = acts[s][j][m % R]
                        acts[s][j][m % R] = None
                        blk = [t.detach().requires_grad_(True)
                               for t in tree_flatten(chunk(c))[1]]
                        io_req = [t.detach().requires_grad_(True)
                                  for t in io_leaves]
                        with torch.enable_grad():
                            iot = tree_unflatten(io_paths, io_req)
                            if use_embed:
                                x_in = api.embed_fn(iot, tok_s[m])
                                inputs = blk + io_req
                            else:
                                assert recv is not None, ("B", w, s, j, m)
                                x_in = recv.detach().requires_grad_(True)
                                inputs = blk + io_req + [x_in]
                            h_out, aux = api.stage_fn(
                                iot, tree_unflatten(blk_paths, blk), x_in,
                                remat=remat)
                            outs, cots = [], []
                            if not last_chunk:
                                assert cot is not None, ("B", w, s, j, m)
                                outs.append(h_out)
                                cots.append(cot.to(h_out.dtype))
                            if use_head:
                                xent = api.loss_from_logits(
                                    api.head_fn(iot, h_out), tgt_s[m])
                                outs.append(xent)
                                cots.append(torch.full_like(xent, inv_M))
                            if aux.requires_grad:
                                outs.append(aux)
                                cots.append(torch.full_like(aux,
                                                            0.01 * inv_M))
                            grads = torch.autograd.grad(
                                outs, inputs, cots, allow_unused=True)
                        lo, hi = stage_map[c]
                        for acc, g in zip(g_blk_leaves, grads[:len(blk)]):
                            if g is not None:
                                acc[lo:hi] += g.float()
                        for acc, g in zip(g_io, grads[len(blk):
                                                      len(blk) + len(io_req)]):
                            if g is not None:
                                acc += g.float()
                        if use_head:
                            loss_acc = loss_acc + xent.detach().float()
                        aux_acc = aux_acc + aux.detach().float()
                        if not use_embed:
                            new[s] = grads[-1]
                    bwd_reg = new
        return (loss_acc, aux_acc, g_blocks,
                tree_unflatten(io_paths, g_io))

    def sync(buf: torch.Tensor) -> List[torch.Tensor]:
        """The stacked ``(n, S, nb, be)`` stage rows, folded into the
        kernel's rows dim, through the epoch's schedule; returns rank
        0's reduced ``(S, nb, be)`` rows."""
        if pipelined:
            # each group's rows of every stage row, one contiguous block
            # a rank (the kernel's operand layout)
            groups = [buf[:, :, lo:hi].reshape(n, S * (hi - lo),
                                               be).contiguous()
                      for lo, hi in layout.groups]
            red = execute_flat_pipelined(groups, pc, stack)
            return torch.cat([g[0].reshape(S, -1, be) for g in red], dim=1)
        return execute_flat(buf.view(n, S * nb, be), pc,
                            stack)[0].reshape(S, nb, be)

    def run(params, opt_state, batch, alive):
        if not bufs:
            bufs.append(torch.zeros((n, S, nb, be), dtype=torch.float32,
                                    device=stack.device))
        buf = bufs[0]
        alive = alive.to(device=stack.device, dtype=torch.float32)
        losses, auxes = [], []
        for r in range(n):
            b = _shard(batch, r, n, stacked)
            assert b["tokens"].shape[0] % M == 0, \
                f"per-rank batch {b['tokens'].shape[0]} not divisible " \
                f"by {M} microbatches"
            tok_s, tgt_s = (b[k].reshape(M, b[k].shape[0] // M,
                                         *b[k].shape[1:])
                            for k in ("tokens", "targets"))
            a = alive[r]
            loss, aux, g_blocks, g_io = rank_pipeline(params, tok_s, tgt_s)
            losses.append(loss * inv_M)
            auxes.append(aux * inv_M)
            g_io = tree_map(lambda g: g * a, g_io)
            g_blocks = tree_map(lambda g: g * a, g_blocks)
            for s in range(S):
                layout.flatten_into(buf[r, s], {
                    **g_io, "blocks": local_blocks(g_blocks, s)}, a)
        with span("gradsync.sync", device=True):
            red = sync(buf)
        with span("gradsync.update", device=True):
            rows = [layout.unflatten(red[s]) for s in range(S)]
            inv = 1.0 / torch.clamp(rows[0][1], min=1.0)
            rows = [tree_map(lambda g: g * inv.to(g.dtype), t)
                    for t, _ in rows]
            # clip on the TRUE global norm: the stages' block rows are
            # disjoint (their square sums add), the io grads count once
            sq = lambda t: sum(torch.sum(torch.square(l.float()))
                               for l in tree_leaves(t))
            gnorm = torch.sqrt(sum(sq(t["blocks"]) for t in rows)
                               + sq({k: g for k, g in rows[0].items()
                                     if k != "blocks"}))
            grads = {k: g for k, g in rows[0].items() if k != "blocks"}
            grads["blocks"] = _canonical_blocks(
                [t["blocks"] for t in rows], stage_rows, per)
            new_p, new_o, om = opt.update(grads, opt_state, params,
                                          gnorm=gnorm)
        loss = torch.stack(losses)
        aux = torch.stack(auxes)
        pm = {"loss": loss * alive, "aux": aux * alive, "alive": alive,
              **{k: val.float().reshape(1).expand(n)
                 for k, val in om.items()}}
        return new_p, new_o, pm

    st = pc.stats()
    meta = {"team": n, "stages": S, "microbatches": M,
            "interleave": v,
            "pipeline_waves": sched.n_waves,
            "ring_slots": R,
            "sync_rounds": st["rounds"],
            "sync_messages": st["messages"],
            "overlap": int(pipelined),
            "bucket_groups": layout.n_groups}
    key = (pc.keys, pc.kind, pc.seed, pc.p, "pipeline", stage_map,
           overlap, M, v)
    return PipelineProgram(key=key, pc=pc, stack=stack, sched=sched,
                           stage_map=stage_map, interleave=v,
                           layout=layout, run=run, stacked=stacked,
                           meta=meta)


def _canonical_blocks(local: List[Dict], stage_rows, per: int) -> Dict:
    """The stages' local block grads (each v·per rows, its chunks in
    group order) back in the canonical layer order."""
    n_rows = sum(hi - lo for rows in stage_rows for lo, hi in rows)

    def place(*leaves):
        out = leaves[0].new_empty((n_rows, *leaves[0].shape[1:]))
        for leaf, rows in zip(leaves, stage_rows):
            for j, (lo, hi) in enumerate(rows):
                out[lo:hi] = leaf[j * per:(j + 1) * per]
        return out
    return tree_map(place, *local)
