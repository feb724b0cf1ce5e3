"""Multi-host elastic phaser runtime (DESIGN.md §11).

The skip-list control plane partitioned across N processes: each host
owns its own protocol actor, the coordinator owns the HEAD sentinel, and
envelopes whose destination lives elsewhere ride a message transport
(in-process fabric or AF_UNIX sockets) that preserves the per-(src, dst)
FIFO the protocol assumes. Membership churn happens at whole-host
granularity through the same two-phase structural ops; every epoch
boundary re-derives the oracle on every survivor, checks each local
partition against it, and re-commits the per-process program cache.

Import note: nothing here imports torch at import time, so
control-plane-only worker processes never pay the torch import: the
agent's data plane imports it when it is first built. The coordinator
(which can drive data-plane steps and the strike policy) loads lazily
on attribute access, as in the reference.
"""
from .agent import HostAgent
from .exchange import exchange_schedule, run_schedule_rounds
from .failure import (HostDead, PeerUnreachable, PhiDetector, RpcTimeout,
                      StepInconsistent, backoff, orphan_horizon)
from .plane import COORD, PartitionedNetwork, ShardPhaser, default_owner
from .transport import (ChaosConfig, Endpoint, FaultyEndpoint,
                        FaultyInprocFabric, InprocEndpoint, InprocFabric,
                        LinkFault, SocketEndpoint, TcpEndpoint,
                        endpoint_cls, fabric_dir, parse_link_spec)

_LAZY = ("DistCoordinator", "DistEpoch", "HostEvent", "InprocCluster",
         "SocketCluster")

__all__ = ["HostAgent", "exchange_schedule", "run_schedule_rounds",
           "HostDead", "PeerUnreachable", "PhiDetector", "RpcTimeout",
           "StepInconsistent", "backoff", "orphan_horizon",
           "COORD", "PartitionedNetwork", "ShardPhaser", "default_owner",
           "ChaosConfig", "Endpoint", "FaultyEndpoint",
           "FaultyInprocFabric", "InprocEndpoint", "InprocFabric",
           "LinkFault", "SocketEndpoint", "TcpEndpoint", "endpoint_cls",
           "fabric_dir", "parse_link_spec"] + list(_LAZY)


def __getattr__(name):   # PEP 562: keep worker imports torch-free
    if name in _LAZY:
        from . import coordinator
        return getattr(coordinator, name)
    raise AttributeError(name)
