"""Training loop: phaser-coordinated, elastic, checkpointable. Port of
``repro/train/loop.py``.

The control plane is the phaser over the (simulated) worker group: every
step is one phaser phase, and churn requested during a phase lands as a
new epoch at its boundary (``runtime_elastic.elastic_phaser``). At each
boundary the loop checkpoints, then swaps its step for the new epoch's,
then proves the epoch against the protocol actors (``verify_epoch``).

With a runtime attached, the step is the execution engine's program
whenever the batch divides the team (``device_collective=None``; True
requires it, False never takes it): the epoch's ranks are stacked on one
device, each computes its shard's grads, and the epoch's schedule syncs
them through the ``bucket_combine`` kernel. Programs come from an
epoch-aware cache keyed by the member set and kind plus the overlap
config, so a boundary that revisits a team reuses its program (and its
buffer). Every checkpoint carries the live program key, so a resume
builds the checkpointed epoch's program before step 1.

``pipeline_stages > 1`` (or ``interleave > 1``) makes each epoch's step
the 2-D pipeline program (``pipeline_exec``; ``microbatches`` is the
1F1B depth), and every epoch boundary also proves the (interleaved)
1F1B wave order against real SIG/WAIT phaser actors
(``verify_phase_order``). Checkpoints and the loop's return hold the
canonical layer order (``readout_state``).

The per-worker alive mask is evaluated after the step's events: a
worker that fails at step s contributes zeros in step s itself, while
its epoch boundary lands after it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from ..checkpoint import CheckpointManager
from ..data import SyntheticLM
from ..models.registry import ModelAPI
from ..obs import timeline as obs_timeline
from ..obs.metrics import MetricsRegistry
from ..obs.timeline import span
from ..optim import AdamW, OptState
from ..runtime_elastic.elastic_phaser import ElasticPhaserRuntime
from ..utils import to_device_copy
from .step import build_train_step


class _StepClock:
    """``train.step_seconds`` as the device runs the steps: on a CUDA
    device an event is recorded after each step (and one before the
    first), and a step's seconds are those between its event and the
    one before, observed once the later event has completed, so the
    loop never waits for it; ``drain`` observes the rest at the end of
    the run. On the CPU a step's host time."""

    def __init__(self, metrics: MetricsRegistry, device, event=None):
        self.metrics = metrics
        self.event = event
        if self.event is None and torch.device(device).type == "cuda":
            self.event = lambda: torch.cuda.Event(enable_timing=True)
        self.pending: List[Any] = []
        if self.event is not None:
            self._record()

    def _record(self) -> None:
        ev = self.event()
        ev.record()
        self.pending.append(ev)

    def step_end(self, t0: float) -> None:
        if self.event is None:
            self.metrics.observe("train.step_seconds", time.time() - t0)
            return
        self._record()
        self._observe_done()

    def _observe_done(self) -> None:
        while len(self.pending) > 1 and self.pending[1].query():
            a = self.pending.pop(0)
            self.metrics.observe("train.step_seconds",
                                 a.elapsed_time(self.pending[0]) / 1e3)

    def drain(self) -> None:
        if len(self.pending) > 1:
            self.pending[-1].synchronize()
            self._observe_done()


@dataclass
class TrainLoop:
    api: ModelAPI
    opt: AdamW
    data: SyntheticLM
    ckpt: Optional[CheckpointManager] = None
    ckpt_every: int = 50
    remat: bool = False
    microbatches: int = 1
    log_every: int = 10
    metrics_log: List[Dict] = field(default_factory=list)
    # --- elastic control plane (optional) --------------------------------
    runtime: Optional[ElasticPhaserRuntime] = None
    # step -> list of ("join", None) | ("leave", wid|None) | ("fail", wid|None)
    elastic_events: Dict[int, List] = field(default_factory=dict)
    epoch_log: List[Dict] = field(default_factory=list)
    # engine data plane: None = whenever a runtime is attached and the
    # batch divides the team, True = required, False = plain step
    device_collective: Optional[bool] = None
    # pipelined round order over the readiness groups (engine path)
    overlap_sync: bool = False
    # pipeline parallelism (engine path): the stacked blocks split over
    # a stage axis, the 1F1B wave schedule on a (stage, data) grid;
    # ``microbatches`` is the pipeline depth M (DESIGN.md §6)
    pipeline_stages: int = 1
    # interleaved virtual stages: each stage owns ``interleave``
    # non-contiguous chunks (bubble (S-1)/(vM+S-1)); needs
    # microbatches % pipeline_stages == 0
    interleave: int = 1
    timeline: Optional[obs_timeline.Timeline] = None
    metrics: Optional[MetricsRegistry] = None
    device: Any = "cuda"
    _progs: Any = field(default=None, init=False, repr=False)

    @property
    def _overlap_mode(self) -> str:
        return "pipelined" if self.overlap_sync else "eager"

    def _apply_elastic_events(self, step: int) -> None:
        for kind, arg in self.elastic_events.get(step, []):
            if kind == "join":
                self.runtime.request_join(arg, step=step)
                continue
            live = self.runtime.live
            if arg is None:
                if not live:
                    raise ValueError(f"elastic event {kind}@{step}: no "
                                     "live workers left to remove")
                wid = max(live)
            elif arg not in live:
                raise ValueError(f"elastic event {kind}:{arg}@{step}: "
                                 f"worker {arg} is not live "
                                 f"(live={sorted(live)})")
            else:
                wid = arg
            self.runtime.request_leave(wid, fail=(kind == "fail"),
                                       step=step)

    def _replay_elastic_events(self, upto: int) -> None:
        """Resume path: rebuild the runtime's live set and epoch index by
        replaying the churn schedule through the real protocol up to the
        restored step. Only a fresh runtime is replayed."""
        if self.runtime.events:
            return
        for s in sorted(k for k in self.elastic_events if k < upto):
            self._apply_elastic_events(s)
            self.runtime.advance(step=s)

    @property
    def _pipelined_2d(self) -> bool:
        return self.pipeline_stages > 1 or self.interleave > 1

    def _use_program(self, pc) -> bool:
        """Whether the epoch's step is the engine's program: the team
        (and per-rank microbatching) must divide the batch. The 2-D
        pipeline path requires it."""
        if self.device_collective is False or pc is None:
            if self._pipelined_2d:
                raise ValueError("pipeline_stages/interleave > 1 "
                                 "require the device-collective path")
            return False
        ok = (pc.n >= 1 and self.data.batch % pc.n == 0
              and (self.data.batch // pc.n) % self.microbatches == 0)
        if self.device_collective is True or self._pipelined_2d:
            assert ok, (f"device_collective requested but team={pc.n}, "
                        f"stages={self.pipeline_stages}, "
                        f"batch={self.data.batch}, "
                        f"microbatches={self.microbatches}")
        return ok

    def _ensure_progs(self):
        """The epoch-aware program cache; the overlap/microbatch and
        pipeline config rides the cache key."""
        if self._progs is None:
            from ..collective_exec import ProgramCache
            self._progs = ProgramCache(
                lambda c: build_train_step(
                    self.api, self.opt, remat=self.remat,
                    microbatches=self.microbatches, collective=c,
                    program=True, overlap=self._overlap_mode,
                    pipeline_stages=self.pipeline_stages,
                    interleave=self.interleave, device=self.device),
                extra_key=(self._overlap_mode, self.microbatches,
                           self.pipeline_stages, self.interleave),
                metrics=self.metrics)
        return self._progs

    def _build_step(self):
        pc = (self.runtime.epoch.collective
              if self.runtime is not None else None)
        if self._use_program(pc):
            return self._ensure_progs().get(pc)
        return build_train_step(self.api, self.opt, remat=self.remat,
                                microbatches=self.microbatches,
                                collective=pc, device=self.device)

    # ------------------------------------------------- program-key ckpt
    def _program_key(self) -> Optional[Dict]:
        """Checkpointable identity of the current epoch's program (member
        set, kind, seed/p, overlap config)."""
        if self.runtime is None or self._progs is None:
            return None
        key = self.runtime.epoch_key()
        if key is None:
            return None
        return {"process_set": [0], **key, "overlap": self._overlap_mode,
                "microbatches": self.microbatches,
                "pipeline_stages": self.pipeline_stages,
                "interleave": self.interleave}

    def _prebuild_from_key(self, pk: Optional[Dict]) -> None:
        """Resume path: rebuild the checkpointed epoch's collective and
        build (or cache-hit) its program before the first step."""
        if not pk or self.device_collective is False:
            return
        if (pk.get("overlap") != self._overlap_mode
                or pk.get("microbatches") != self.microbatches
                or pk.get("pipeline_stages", 1) != self.pipeline_stages
                or pk.get("interleave", 1) != self.interleave
                or (self.runtime is not None
                    and (pk.get("kind") != self.runtime.kind
                         or pk.get("seed") != self.runtime.seed))):
            return
        from ..core.collective import PhaserCollective
        keys = tuple(pk["member_set"])
        pc = PhaserCollective(len(keys), pk.get("axis", "data"),
                              kind=pk["kind"], seed=pk["seed"],
                              p=pk["p"], keys=keys,
                              leaf_keys=tuple(pk.get("leaf_keys", ())))
        if self._use_program(pc):
            self._ensure_progs().get(pc)

    def _to_canonical(self, ts, params, opt_state):
        """Carried state -> canonical layer order (the program's
        ``readout_state``; identity without a program)."""
        prog = getattr(ts, "program", None)
        if prog is not None:
            return prog.readout_state(params, opt_state)
        return params, opt_state

    def _to_carried(self, ts, params, opt_state):
        """Canonical state -> the program's carried layout, paid once at
        bind / restore."""
        prog = getattr(ts, "program", None)
        if prog is not None:
            return prog.bind_state(params, opt_state)
        return params, opt_state

    def run(self, steps: int, *, params=None, opt_state=None,
            resume: bool = False, on_step: Optional[Callable] = None):
        if self.timeline is not None:
            obs_timeline.activate(self.timeline)
        ts = self._build_step()
        start = 0
        if params is None:
            params = self.api.init_params(
                torch.Generator(self.device).manual_seed(0), self.device)
        if opt_state is None:
            opt_state = self.opt.init(params)
        if resume and self.ckpt is not None and self.ckpt.latest_step():
            # build the checkpointed epoch's program before the restore
            # and the event replay: the re-build below is a cache hit
            self._prebuild_from_key(self.ckpt.program_key())
            tpl = {"params": params, "opt": opt_state._asdict()}
            start, tree, extra = self.ckpt.restore(tpl)
            params = tree["params"]
            opt_state = OptState(**tree["opt"])
            if "data" in extra:
                self.data.load_state_dict(extra["data"])
            if self.runtime is not None:
                self._replay_elastic_events(start)
                ts = self._build_step()
        params, opt_state = self._to_carried(ts, params, opt_state)

        clock = (_StepClock(self.metrics, self.device)
                 if self.metrics is not None else None)
        for step in range(start, steps):
            if self.runtime is not None and self.elastic_events.get(step):
                with span("train.churn"):
                    self._apply_elastic_events(step)
            with span("train.batch"):
                batch = {k: to_device_copy(v, self.device)
                         for k, v in next(self.data).items()}
            t0 = time.time()
            with span("train.step", step=step):
                if ts.program is not None:
                    # per-worker alive mask, after this step's events: a
                    # worker that left mid-epoch contributes zeros
                    ep = self.runtime.epoch
                    alive = torch.tensor(
                        [1.0 if w in self.runtime.live else 0.0
                         for w in ep.live],
                        dtype=torch.float32, device=self.device)
                    params, opt_state, metrics = ts.fn(params, opt_state,
                                                       batch, alive)
                else:
                    params, opt_state, metrics = ts.fn(params, opt_state,
                                                       batch)
            if clock is not None:
                clock.step_end(t0)
            if self.runtime is not None:
                # the step is one phaser phase; churn requested above
                # lands as a new epoch exactly at this boundary
                before = self.runtime.epoch.index
                with span("train.advance"):
                    released = self.runtime.advance(step=step)
                ep = self.runtime.epoch
                if ep.index != before:
                    # checkpoint-consistent swap: persist, then re-build
                    if self.ckpt is not None:
                        with span("train.checkpoint"):
                            cp, co = self._to_canonical(ts, params,
                                                        opt_state)
                            self.ckpt.save(
                                step + 1, cp, co,
                                extra={"data": self.data.state_dict()},
                                program_key=self._program_key())
                    with span("epoch.relower", epoch=ep.index):
                        ts = self._build_step()
                    if self.metrics is not None:
                        self.metrics.inc("train.relower")
                    with span("train.verify"):
                        self.runtime.verify_epoch()
                        if self._pipelined_2d:
                            # the stage axis's own proof: the
                            # (interleaved) 1F1B wave order against the
                            # real p2p actors
                            from ..pipeline_exec import (
                                derive_interleaved, verify_phase_order)
                            verify_phase_order(derive_interleaved(
                                self.pipeline_stages, self.microbatches,
                                self.interleave))
                    self.epoch_log.append({
                        "step": step, "phase": released,
                        "epoch": ep.index, "live": list(ep.live),
                        "kind": ep.kind, **ep.stats()})
            if step % self.log_every == 0 or step == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["dt"] = time.time() - t0
                if self.runtime is not None:
                    m["epoch"] = self.runtime.epoch.index
                    m["live"] = len(self.runtime.live)
                self.metrics_log.append(m)
            if self.ckpt is not None and (step + 1) % self.ckpt_every == 0:
                with span("train.checkpoint"):
                    cp, co = self._to_canonical(ts, params, opt_state)
                    self.ckpt.save(step + 1, cp, co,
                                   extra={"data": self.data.state_dict()},
                                   program_key=self._program_key())
            if on_step is not None:
                on_step(step, params, metrics)
        if clock is not None:
            clock.drain()
        params, opt_state = self._to_canonical(ts, params, opt_state)
        if self.ckpt is not None:
            self.ckpt.save(steps, params, opt_state,
                           extra={"data": self.data.state_dict()},
                           program_key=self._program_key())
            self.ckpt.wait()
        if self.timeline is not None:
            obs_timeline.deactivate()
        return params, opt_state
