"""PyTorch/CUDA port of the vectorized Multi-Raft engine (``rafting_tpu``).

A package of its own beside the JAX reference: it imports torch and numpy,
never jax and nothing of ``rafting_tpu``.  Its entry points run on the CUDA
device unless the caller passes ``device=`` (the tests pass ``"cpu"``);
with no card and no device given they raise.  Phase 10's quorum commit
runs in a hand-written CUDA kernel on the card (``ops/csrc``).
"""

from .core.cluster import DeviceCluster, auto_host_inbox, cluster_step, route
from .core.sim import (
    committed_entries, run_cluster_ticks, run_cluster_ticks_reads,
)
from .core.step import node_step
from .core.types import (
    CANDIDATE, FOLLOWER, LEADER, NIL, PRE_CANDIDATE, EngineConfig,
    HostInbox, Messages, RaftState, StepInfo, init_state,
)

__all__ = [
    "CANDIDATE", "FOLLOWER", "LEADER", "NIL", "PRE_CANDIDATE",
    "DeviceCluster", "EngineConfig", "HostInbox", "Messages", "RaftState",
    "StepInfo", "auto_host_inbox", "cluster_step", "committed_entries",
    "init_state", "node_step", "route", "run_cluster_ticks",
    "run_cluster_ticks_reads",
]
