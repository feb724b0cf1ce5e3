"""Train-step builder: loss + grad + AdamW update, with optional
gradient accumulation (microbatching) and remat. Port of
``repro/train/step.py``.

Two paths, as in the reference:

* plain: one forward and backward on the global batch (or a loop over
  microbatches accumulating f32 grads), then AdamW; a ``collective``
  only adds its static sync metadata to the metrics;
* program: with ``collective`` and ``program=True``, the step is the
  execution engine's ``GradSyncProgram`` over the team's ``RankStack``:
  per-rank grads synced by the epoch's schedule through the
  ``bucket_combine`` kernel (``overlap="pipelined"`` keeps the
  reference's double-buffered round order);
* pipeline: with ``collective``, ``program=True`` and
  ``pipeline_stages > 1`` or ``interleave > 1``, the step is the 2-D
  ``PipelineProgram`` (``pipeline_exec``): the (interleaved) 1F1B
  schedule over the stage rows, each stage row's grads synced over the
  data ranks by the epoch's schedule. Without a collective program the
  pipeline options raise, as the reference's loop does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..models.registry import ModelAPI
from ..optim import AdamW, OptState
from ..utils import tree_map


@dataclass
class TrainStep:
    """A train step. ``fn(params, opt, batch)`` -> (params, opt,
    metrics); on the program paths ``fn`` also takes a trailing
    per-worker alive mask and ``program`` is the engine's
    ``GradSyncProgram`` or the 2-D ``PipelineProgram``."""

    fn: Callable
    program: Any = None


def _program_train_step(prog) -> TrainStep:
    """A ``GradSyncProgram`` or ``PipelineProgram`` as a train step whose
    metrics are reduced over the team."""
    def fn(params, opt_state, batch, alive=None):
        new_p, new_o, pm = prog.step(params, opt_state, batch, alive)
        return new_p, new_o, prog.reduce_metrics(pm)

    return TrainStep(fn=fn, program=prog)


def build_train_step(api: ModelAPI, opt: AdamW, *, remat: bool = True,
                     microbatches: int = 1, collective=None,
                     program: bool = False, overlap: str = "eager",
                     pipeline_stages: int = 1,
                     interleave: int = 1, device="cuda") -> TrainStep:
    """``collective``: the elastic epoch's PhaserCollective. Without
    ``program`` it enters the metrics as static sync metadata (team
    size, rounds, messages); with it, the step is the engine's program
    over ``device`` and the schedule's rounds are the gradient
    reduction; ``pipeline_stages > 1`` or ``interleave > 1`` make it
    the 2-D pipeline program (``microbatches`` is the 1F1B depth)."""
    if pipeline_stages > 1 or interleave > 1:
        if collective is None or not program:
            raise ValueError("pipeline_stages/interleave > 1 require the "
                             "collective program path")
        from ..pipeline_exec import build_pipeline_program
        return _program_train_step(build_pipeline_program(
            api, opt, collective, n_stages=pipeline_stages,
            interleave=interleave, device=device,
            microbatches=microbatches, remat=remat, overlap=overlap))
    if collective is not None and program:
        from ..collective_exec import build_gradsync_program
        return _program_train_step(build_gradsync_program(
            api, opt, collective, device=device, remat=remat,
            overlap=overlap, microbatches=microbatches))
    sync_meta = None
    if collective is not None:
        st = collective.stats()
        sync_meta = {"team": collective.n,
                     "sync_rounds": st["rounds"],
                     "sync_messages": st["messages"]}

    def step(params, opt_state: OptState, batch):
        if microbatches > 1:
            mbs = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                *v.shape[1:]) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(mbs.values())).device)
            for k in range(microbatches):
                b = {key: v[k] for key, v in mbs.items()}
                (l, _), g = api.value_and_grad(params, b, remat=remat)
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / microbatches, grads)
            metrics = {"loss": loss / microbatches}
        else:
            (_, metrics), grads = api.value_and_grad(params, batch,
                                                     remat=remat)
        new_params, new_opt, om = opt.update(grads, opt_state, params)
        out = {**metrics, **om}
        if sync_meta is not None:
            out.update({k: torch.tensor(float(v), dtype=torch.float32)
                        for k, v in sync_meta.items()})
        return new_params, new_opt, out

    return TrainStep(fn=step)
