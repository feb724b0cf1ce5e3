"""Observability plane: causal traces, metrics shards, step timelines.

Three layers (DESIGN.md §12), all importable without torch so the
control-plane-only worker processes stay light:

* ``trace``    — per-envelope span contexts carried through the
  partitioned control plane; ``TraceStore`` reconstructs causal span
  trees; ``check_signal_hops`` is the runtime O(log P) invariant.
* ``metrics``  — typed counters/gauges/histograms in per-process
  ``MetricsRegistry`` shards, merged at the coordinator.
* ``timeline`` — wall-clock spans + logical schedule grids exported as
  Chrome-trace/Perfetto JSON and JSONL; ``timeline.span`` marks the
  program's own work in a ``torch.profiler`` trace and on the active
  timeline at once.

The always-on layer (DESIGN.md §14) rides on top:

* ``live``     — per-host phase watermarks + wait-time attribution
  (``WatermarkTracker`` per process, ``ClusterWatermarks`` merged at
  the coordinator) and the ``LiveStreamer`` heartbeat frames behind
  ``--live-out`` (tail with ``python -m repro_torch.obs.watch``).
* ``recorder`` — bounded per-process flight rings flushed to
  ``*.flight.jsonl`` at failure edges; ``python -m
  repro_torch.obs.recorder`` checks coherence.
* ``regress``  — the perf-regression sentry over ``BENCH_*.json``
  (``python -m repro_torch.obs.regress``).

``hub.ObsHub`` glues them together on the coordinator;
``python -m repro_torch.obs.check`` asserts the invariants over an
exported span log (CI).
"""
from .hub import ObsHub, spans_path
from .live import (ClusterWatermarks, LiveStreamer, WatermarkRegression,
                   WatermarkTracker, read_frames)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, \
    default_registry
from .recorder import FlightRecorder, check_flight_file, flight_path
from .timeline import Timeline, activate, current, deactivate, \
    gradsync_round_events, pipeline_wave_events
from .trace import SpanCtx, SpanId, Tracer, TraceStore, check_signal_hops

__all__ = [
    "ClusterWatermarks", "Counter", "FlightRecorder", "Gauge",
    "Histogram", "LiveStreamer", "MetricsRegistry", "ObsHub",
    "SpanCtx", "SpanId", "Timeline", "Tracer", "TraceStore",
    "WatermarkRegression", "WatermarkTracker", "activate",
    "check_flight_file", "check_signal_hops", "current", "deactivate",
    "default_registry", "flight_path", "gradsync_round_events",
    "pipeline_wave_events", "read_frames", "spans_path",
]
