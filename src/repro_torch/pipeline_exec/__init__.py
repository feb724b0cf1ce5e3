"""Pipeline-parallel execution on point-to-point phaser graphs (port of
``repro/pipeline_exec``, DESIGN.md §6).

The point-to-point half of the paper's claim, run on the data plane:
pipeline chunks register SIG toward their successor and WAIT on their
predecessor (``core/p2p.py``), the wave-synchronous 1F1B schedule and
its interleaved virtual-stage generalization (``interleave = v`` chunks
per stage, bubble fraction (S-1)/(vM+S-1)) are derived from and verified
against that phaser graph's phase ordering (``schedule``), and
``stage_program`` runs them as one train step over a (stage, data) grid
stacked on one device, the stage rows' activation and cotangent
hand-offs interleaved with the elastic epoch's gradient-sync rounds on
the data axis.
"""
from .schedule import (PipelineSchedule, derive_1f1b, derive_interleaved,
                       pipeline_edges, verify_phase_order)
from .stage_program import (STAGE_AXIS, PipelineProgram,
                            build_pipeline_program, stage_partition)

__all__ = ["PipelineSchedule", "derive_1f1b", "derive_interleaved",
           "pipeline_edges", "verify_phase_order", "STAGE_AXIS",
           "PipelineProgram", "build_pipeline_program",
           "stage_partition"]
