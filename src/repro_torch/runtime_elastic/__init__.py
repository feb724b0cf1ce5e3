from .elastic_phaser import ElasticPhaserRuntime, Epoch, WorkerEvent
from .strikes import StrikeAction, StrikeEscalation

__all__ = ["ElasticPhaserRuntime", "Epoch", "StrikeAction",
           "StrikeEscalation", "WorkerEvent"]
