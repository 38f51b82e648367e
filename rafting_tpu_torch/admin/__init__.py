"""Admin control plane: the Multi-Raft group lifecycle as a replicated
state machine on the reserved meta lane (reference command/admin/:
Administrator + STM/MVCC KV engine)."""

from .administrator import (
    DESTROYED, NORMAL, NOT_FOUND, SLEEPING,
    AdminProvider, Administrator, LifecycleBus,
    build_close_tx, build_open_tx,
)
from .kv import KVEngine, STM
from .rebalance import Rebalancer, RebalanceError

__all__ = [
    "Administrator", "AdminProvider", "LifecycleBus",
    "KVEngine", "STM", "build_open_tx", "build_close_tx",
    "NOT_FOUND", "NORMAL", "SLEEPING", "DESTROYED",
    "Rebalancer", "RebalanceError",
]
