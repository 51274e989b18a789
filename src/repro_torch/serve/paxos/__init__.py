"""Batched-machine serve subsystem of the port: the end-to-end SIMD serve
path on the GPU.

``Cluster(machine_cls=BatchedMachine)`` runs every workload of the scalar
cluster completion-for-completion identically, with ALL replicas' planes
stacked on a leading machine axis in one device-resident
:class:`~.cluster_engine.ClusterEngine` — ``(18, M, K)`` receiver KV ints
and ``(65, M, S)`` issuer proposer ints — and the cluster tick run in fused
*waves*::

      every machine's inbox ─▶ IngestScheduler ─▶ conflict-free batches
                               ┌──────────────────────────────────────┐
      wave w, all machines ──▶ │ ONE fused receiver call              │─▶ replies
        staged msg lanes       │ paxos_apply kernel over (M·K,) lanes │
        + is_registered bit    └──────────────────────────────────────┘
                               ┌──────────────────────────────────────┐
      wave w, all machines ──▶ │ ONE fused issuer call                │─▶ ActionBatch
        steered reply lanes    │ paxos_propose, staged lanes only,    │  decisions
                               │ in place: one upload, one launch,    │
                               │ one download                         │
                               └──────────────────────────────────────┘
      host dispatch between waves (scalar code, bridge row views): grab /
      steal / help, accept values, local commits, retries, inspection
      timers and FIFO probing, which start new rounds and reload lanes.

The host-bridge contract, the registry coupling and the argument for
completion identity are those of the reference package
``repro.serve.paxos``; :mod:`.cluster_engine` says what the port changes
(no donation, lane-granular host<->device transfers) and why that changes
no result.
"""

from repro_torch.core.lanes import ShardMap
from .bridge import KVBridge, ShardedKVView, SteeringTable
from .cluster_engine import ClusterEngine, require_launches, \
    select_launches, stacks_from_numpy
from .machine import BatchedMachine
from .scheduler import DEFAULT_BATCH_TARGET, IngestScheduler, \
    bucket_conflict_free

__all__ = ["BatchedMachine", "ClusterEngine", "DEFAULT_BATCH_TARGET",
           "IngestScheduler", "KVBridge", "ShardMap", "ShardedKVView",
           "SteeringTable", "bucket_conflict_free", "require_launches",
           "select_launches", "stacks_from_numpy"]
