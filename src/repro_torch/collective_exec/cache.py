"""Epoch-aware program cache: ``(member_set, kind)`` -> program.

The elastic runtime swaps data-plane programs at phase-advance
boundaries (DESIGN.md §3): when a boundary lands a new epoch, the next
epoch's program is looked up here — compiled once per distinct
``(member_set, kind)`` and re-used when churn revisits a team (a worker
set that grew back, an A/B membership flip). The phaser's keys are never
recycled, so within one runtime the member set *is* the topology
identity: skip-list heights are a deterministic function of
``(seed, key)``, so equal key sets under the same seed derive equal
skip lists and therefore equal schedules. The cache key carries
``(seed, p)`` alongside ``(member_set, kind)`` to stay correct when one
cache serves collectives from differently-seeded runtimes, and an
``extra_key`` for builder-level configuration that changes the compiled
program without changing the collective — the overlap mode, bucket-group
config, and microbatch count (DESIGN.md §5): an eager and a pipelined
program over the same member set are distinct cache entries. So are the
2-D pipeline programs of different stage counts and interleave factors:
the train loop puts both in ``extra_key``, and a ``PipelineProgram``'s
own ``key`` (what checkpoints persist) carries its chunk map and
interleave after the collective key.

LRU-bounded: compiled shard_map executables hold device buffers; the
default capacity keeps the last 8 teams warm.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Optional, Tuple

from ..core.collective import PhaserCollective


class ProgramCache:
    def __init__(self, builder: Callable[[PhaserCollective], Any], *,
                 capacity: Optional[int] = 8,
                 extra_key: Tuple = (),
                 metrics: Any = None):
        self._builder = builder
        self._programs: "OrderedDict[Tuple, Any]" = OrderedDict()
        self.capacity = capacity
        self.extra_key = tuple(extra_key)
        self.metrics = metrics   # obs.MetricsRegistry shard, optional
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key_of(pc: PhaserCollective) -> Tuple:
        # leaf_keys: a demoted straggler changes the schedule without
        # changing the member set — it must be a distinct cache entry
        return (pc.keys, pc.kind, pc.seed, pc.p,
                tuple(getattr(pc, "leaf_keys", ()) or ()))

    def full_key(self, pc: PhaserCollective) -> Tuple:
        """Cache identity of this collective's program: the collective
        key plus the cache's static builder config (overlap mode,
        bucket groups, microbatches)."""
        return self.key_of(pc) + self.extra_key

    def get(self, pc: PhaserCollective) -> Any:
        """The program for this collective's (member_set, kind),
        building it on first use."""
        key = self.full_key(pc)
        prog = self._programs.get(key)
        if prog is not None:
            self.hits += 1
            if self.metrics is not None:
                self.metrics.inc("program_cache.hits")
            self._programs.move_to_end(key)
            return prog
        self.misses += 1
        if self.metrics is not None:
            self.metrics.inc("program_cache.misses")
        prog = self._builder(pc)
        self._programs[key] = prog
        if self.capacity and len(self._programs) > self.capacity:
            self._programs.popitem(last=False)
        return prog

    def __contains__(self, pc: PhaserCollective) -> bool:
        return self.full_key(pc) in self._programs

    def __len__(self) -> int:
        return len(self._programs)

    def programs(self) -> list:
        """The cached programs, least recently used first."""
        return list(self._programs.values())

    def stats(self) -> dict:
        return {"entries": len(self._programs), "hits": self.hits,
                "misses": self.misses}
