"""Elastic membership: the paper's dynamic phaser protocol driving the
data-plane worker group.

The mapping (DESIGN.md §2-3):

* each data-parallel worker is a phaser participant in SIG_WAIT mode;
* one training step == one phaser phase: a worker signals when its
  gradient contribution is ready; the optimizer step is released when the
  phase advances (all live signalers signaled);
* JOIN  == paper's eager insertion: the joining worker is admitted
  immediately (its first_phase is assigned by the protocol) — O(1) on the
  data plane. The topology-optimal collective schedule is re-derived
  LAZILY at the next phase boundary (the paper's hand-over-hand
  promotion, lifted to epoch granularity — see elastic_phaser.py);
* LEAVE/FAIL == deletion: DEREG lowers the phase expectation so the phase
  can still complete without the failed worker;
* STRAGGLER quorum == split-phase: with signal(), fast workers proceed
  into the next step's compute before wait()ing — the phaser's fuzzy
  barrier gives the slack window.

``ElasticController`` is the stable worker-group facade kept for existing
callers; the epoch machinery itself lives in ``ElasticPhaserRuntime``
(this class *is* one, plus a membership mask and the legacy naming).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .elastic_phaser import ElasticPhaserRuntime, Epoch, WorkerEvent
from ..core.collective import PhaserCollective

__all__ = ["ElasticController", "ElasticPhaserRuntime", "Epoch",
           "WorkerEvent"]


class ElasticController(ElasticPhaserRuntime):
    """Host-side controller coordinating the worker group with a real
    distributed-phaser instance (legacy facade over the epoch runtime)."""

    def __init__(self, n_workers: int, *, seed: int = 0,
                 kind: str = "phaser_scsl"):
        super().__init__(n_workers, seed=seed, kind=kind)
        self.n = n_workers
        self.mask = np.ones((n_workers,), bool)

    # ------------------------------------------------------------ topology
    def collective(self, kind: Optional[str] = None) -> PhaserCollective:
        """Current-epoch collective schedule for the data axis. Passing a
        ``kind`` overrides the epoch's preferred schedule (derived over
        the same live keys; every kind covers any team size via the
        elimination derivations)."""
        ep = self.epoch
        kind = self._kind_for(len(ep.live), kind)
        if kind == ep.kind:
            return super().collective()
        return PhaserCollective(len(ep.live), self.axis_name, kind=kind,
                                seed=self.seed, keys=ep.live)

    def loss_scale(self) -> float:
        """Re-weighting when the live set shrank mid-epoch (masked mean)."""
        return self.mask.sum() / max(len(self.mask), 1)

    # -------------------------------------------------------------- events
    def request_join(self, parent: Optional[int] = None, *,
                     step: Optional[int] = None, **kw) -> int:
        wid = super().request_join(parent, step=step, **kw)
        self._grow_mask(wid)
        self.mask[wid] = True
        return wid

    def request_leave(self, worker: int, *, fail: bool = False,
                      step: Optional[int] = None) -> None:
        super().request_leave(worker, fail=fail, step=step)
        if worker < len(self.mask):
            self.mask[worker] = False

    def join(self, step: int, parent: Optional[int] = None) -> int:
        """Eager admission of a new worker (paper Fig. 2)."""
        return self.request_join(parent, step=step)

    def leave(self, step: int, worker: int, *, fail: bool = False) -> None:
        """Deletion (graceful) or failure (detected by missed heartbeat)."""
        self.request_leave(worker, fail=fail, step=step)

    def _grow_mask(self, wid: int) -> None:
        if wid >= len(self.mask):
            m = np.zeros((wid + 1,), bool)
            m[:len(self.mask)] = self.mask
            self.mask = m

    # ------------------------------------------------------------ stepping
    def step_barrier(self, step: int,
                     signals: Optional[Dict[int, bool]] = None) -> int:
        """One training-step phase: live workers signal, phase advances,
        pending membership changes land as a new epoch at the boundary."""
        return self.advance(step=step)

    # ---------------------------------------------------------- inspection
    @property
    def schedule_epoch(self) -> int:
        """Number of lazy schedule re-derivations that have landed."""
        return self.epoch.index

    def stats(self) -> Dict:
        st = super().stats()
        st["schedule_epoch"] = self.schedule_epoch
        return st
