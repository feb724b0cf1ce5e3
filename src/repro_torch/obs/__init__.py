from .metrics import Counter, Gauge, Histogram, MetricsRegistry, \
    default_registry
from .timeline import Timeline, activate, current, deactivate, \
    gradsync_round_events, pipeline_wave_events

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "Timeline",
           "activate", "current", "deactivate", "default_registry",
           "gradsync_round_events", "pipeline_wave_events"]
