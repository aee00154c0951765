"""Cluster serving runtime, torch counterpart of ``repro.cluster``
(DESIGN.md §7, §10): sharded router, replica hedging, WAL-durable mutations,
with every replica in this process (``transport='inproc'``) or one worker
subprocess a replica over the RPC transport (``'process'``: unix sockets and
shared-memory slabs; ``'tcp'``)."""
from .replica import ReplicaDiverged, ReplicaKilled, ShardReplica  # noqa: F401
from .remote import RemoteReplica, WorkerHandle  # noqa: F401
from .router import ClusterConfig, ClusterRouter, ClusterUnavailable  # noqa: F401
from .transport import Connection, RemoteError  # noqa: F401
from .wal import OP_DELETE, OP_INSERT, WalRecord, WriteAheadLog  # noqa: F401
