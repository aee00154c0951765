"""Cluster serving runtime, torch counterpart of ``repro.cluster``
(DESIGN.md §7): sharded router, replica hedging, WAL-durable mutations, with
every replica in this process (``transport='inproc'``).  The process
transport (``transport.py``, ``shm.py``, ``worker.py``, ``remote.py``) is not
ported yet."""
from .replica import ReplicaDiverged, ReplicaKilled, ShardReplica  # noqa: F401
from .router import ClusterConfig, ClusterRouter, ClusterUnavailable  # noqa: F401
from .wal import OP_DELETE, OP_INSERT, WalRecord, WriteAheadLog  # noqa: F401
