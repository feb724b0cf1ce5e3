from .elastic_phaser import ElasticPhaserRuntime, Epoch, WorkerEvent
from .membership import ElasticController
from .strikes import StrikeAction, StrikeEscalation

__all__ = ["ElasticController", "ElasticPhaserRuntime", "Epoch",
           "StrikeAction", "StrikeEscalation", "WorkerEvent"]
