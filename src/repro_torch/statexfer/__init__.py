"""Live state-transfer subsystem: in-memory replicated snapshots + real
ReshardPlan execution on rejoin (PHOENIX/FFTrainer-style hot-spare state).

The port's counterpart of ``repro.statexfer``, with the same public names."""
from repro_torch.statexfer.registry import StateTransferRegistry
from repro_torch.statexfer.replication import (
    ReplicaStore,
    dp_domains,
    pod_domains,
    ring_peers,
)
from repro_torch.statexfer.reshard_exec import (
    ReshardOutcome,
    TransferReceipt,
    execute_reshard,
    materialize,
)
from repro_torch.statexfer.snapshot import (
    Snapshot,
    SnapshotManager,
    host_copy,
    take_snapshot,
    tree_nbytes,
)

__all__ = [
    "ReplicaStore",
    "ReshardOutcome",
    "Snapshot",
    "SnapshotManager",
    "StateTransferRegistry",
    "TransferReceipt",
    "dp_domains",
    "execute_reshard",
    "host_copy",
    "materialize",
    "pod_domains",
    "ring_peers",
    "take_snapshot",
    "tree_nbytes",
]
