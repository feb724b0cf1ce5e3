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

``rules`` (a ``ShardingRules``, the dry-run's) runs the loss and its
gradient under ``use_rules`` on the plain path, so the models'
``constrain`` hints redistribute the DTensors the caller placed by the
placements the step reports (``param_sh``, ``opt_sh``, ``batch_sh``);
``build_prefill_step`` and ``build_decode_step`` are the serve steps'
builders, in the same pattern. With ``rules=None`` every path is as
without them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from ..configs.base import ShapeConfig
from ..models.registry import ModelAPI
from ..optim import AdamW, OptState
from ..sharding import ShardingRules, param_shardings, use_rules
from ..sharding.policies import batch_specs
from ..sharding.rules import spec_to_placements
from ..utils import tree_map


@dataclass
class TrainStep:
    """A train step. ``fn(params, opt, batch)`` -> (params, opt,
    metrics); on the program paths ``fn`` also takes a trailing
    per-worker alive mask and ``program`` is the engine's
    ``GradSyncProgram`` or the 2-D ``PipelineProgram``. Under rules,
    ``param_sh``, ``opt_sh`` and ``batch_sh`` are the DTensor placements
    of the step's inputs (trees like them)."""

    fn: Callable
    program: Any = None
    param_sh: Any = None
    opt_sh: Any = None
    batch_sh: Any = None


def _program_train_step(prog) -> TrainStep:
    """A ``GradSyncProgram`` or ``PipelineProgram`` as a train step whose
    metrics are reduced over the team."""
    def fn(params, opt_state, batch, alive=None):
        new_p, new_o, pm = prog.step(params, opt_state, batch, alive)
        return new_p, new_o, prog.reduce_metrics(pm)

    return TrainStep(fn=fn, program=prog)


def _placements(rules: ShardingRules, spec_tree):
    return tree_map(lambda s: spec_to_placements(s, rules.mesh), spec_tree)


def _sharded(rules: Optional[ShardingRules]) -> bool:
    return rules is not None and rules.mesh is not None


def build_train_step(api: ModelAPI, opt: AdamW, *,
                     rules: Optional[ShardingRules] = None,
                     remat: bool = True,
                     microbatches: int = 1, collective=None,
                     program: bool = False, overlap: str = "eager",
                     pipeline_stages: int = 1,
                     interleave: int = 1, device="cuda") -> TrainStep:
    """``collective``: the elastic epoch's PhaserCollective. Without
    ``program`` it enters the metrics as static sync metadata (team
    size, rounds, messages); with it, the step is the engine's program
    over ``device`` and the schedule's rounds are the gradient
    reduction; ``pipeline_stages > 1`` or ``interleave > 1`` make it
    the 2-D pipeline program (``microbatches`` is the 1F1B depth).
    ``rules`` applies to the plain path only."""
    if _sharded(rules) and (collective is not None and program
                            or pipeline_stages > 1 or interleave > 1):
        raise ValueError("rules apply to the plain step only")
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

    def value_and_grad(params, batch):
        with use_rules(rules):
            return api.value_and_grad(params, batch, remat=remat)

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
                (l, _), g = value_and_grad(params, b)
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / microbatches, grads)
            metrics = {"loss": loss / microbatches}
        else:
            (_, metrics), grads = value_and_grad(params, batch)
        new_params, new_opt, om = opt.update(grads, opt_state, params)
        out = {**metrics, **om}
        if sync_meta is not None:
            out.update({k: torch.tensor(float(v), dtype=torch.float32)
                        for k, v in sync_meta.items()})
        return new_params, new_opt, out

    if not _sharded(rules):
        return TrainStep(fn=step)
    param_sh = param_shardings(api.param_spec(), rules)
    replicated = spec_to_placements((), rules.mesh)
    dummy = api.input_specs(ShapeConfig("x", 8 + api.cfg.vision_tokens, 8,
                                        "train"))
    return TrainStep(fn=step, param_sh=param_sh,
                     opt_sh=OptState(step=replicated, mu=param_sh,
                                     nu=param_sh),
                     batch_sh=_placements(rules, batch_specs(rules, dummy)))


# ---------------------------------------------------------------------------
# Serve steps (prefill / decode) — same builder pattern
# ---------------------------------------------------------------------------
def build_prefill_step(api: ModelAPI, *,
                       rules: Optional[ShardingRules] = None):
    """(step(params, batch) -> (last logits, caches), parameter
    placements or None)."""
    def step(params, batch):
        with use_rules(rules):
            return api.prefill_fn(params, batch)
    if _sharded(rules):
        return step, param_shardings(api.param_spec(), rules)
    return step, None


def build_decode_step(api: ModelAPI, *,
                      rules: Optional[ShardingRules] = None,
                      batch: int = 1, window: int = 2048,
                      split_k: bool = False):
    """(step(params, state, batch) -> (logits, state), (parameter,
    state, batch placements) or None). A request batch that does not
    divide the dp axes is replicated, and the cache's window dim takes
    the data axis instead (``decode_state_specs``)."""
    def step(params, state, b):
        with use_rules(rules):
            return api.decode_fn(params, state, b)
    if not _sharded(rules):
        return step, None
    from ..sharding.policies import axis_size, decode_state_specs
    mesh = rules.mesh
    st_spec = decode_state_specs(rules, api.cfg,
                                 api.decode_state_spec(batch, window), mesh,
                                 batch=batch, split_k=split_k)
    dp = rules.logical["batch"]
    bspec = (dp if batch % axis_size(mesh, dp) == 0 else None,)
    b_pl = spec_to_placements(bspec, mesh)
    return step, (param_shardings(api.param_spec(), rules),
                  _placements(rules, st_spec),
                  {"token": b_pl, "t": b_pl})
