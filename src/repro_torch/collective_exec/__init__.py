"""Collective execution engine over the stacked team (port of
``repro/collective_exec``): bucketed grad flattening in reverse-
topological order with readiness groups (``buckets``), schedule rounds
with the ``bucket_combine`` kernel as the local reduce, eager or
double-buffered per group (``executor``), per-epoch train-step programs,
flat and hierarchical (``program``) and the epoch-aware program cache
(``cache``)."""
from .buckets import BucketLayout, make_layout
from .cache import ProgramCache
from .executor import execute_flat, execute_flat_pipelined
from .program import (OVERLAP_MODES, GradSyncProgram, HierSyncProgram,
                      build_allreduce_program, build_gradsync_program,
                      build_hier_gradsync_program, reduce_worker_metrics)

__all__ = ["BucketLayout", "make_layout", "ProgramCache", "execute_flat",
           "execute_flat_pipelined", "OVERLAP_MODES", "GradSyncProgram",
           "HierSyncProgram", "build_allreduce_program",
           "build_gradsync_program", "build_hier_gradsync_program",
           "reduce_worker_metrics"]
