"""PyTorch/CUDA port of the vectorized Multi-Raft engine (``rafting_tpu``).

A package of its own beside the JAX reference: it imports torch and numpy,
never jax and nothing of ``rafting_tpu``.  Its entry points run on the CUDA
device unless the caller passes ``device=`` (the tests pass ``"cpu"``);
with no card and no device given they raise.  Phase 10's quorum commit
runs in a hand-written CUDA kernel on the card (``ops/csrc``).  The
device nemesis (``run_cluster_ticks_nemesis``, ``testkit.nemesis``) and
the optional subtrees (flight recorder, heat lanes, CheckQuorum, debug
checks) run on the same step.
"""

from .core.cluster import (
    DeviceCluster, auto_host_inbox, cluster_step, cluster_step_nemesis, route,
)
from .core.sim import (
    committed_entries, run_cluster_ticks, run_cluster_ticks_nemesis,
    run_cluster_ticks_reads,
)
from .core.step import DEBUG_CODES, node_step, raise_debug_violations
from .core.types import (
    CANDIDATE, FOLLOWER, LEADER, NIL, PRE_CANDIDATE, EngineConfig,
    FaultSchedule, HeatState, HostInbox, Messages, QuorumContact, RaftState,
    StepInfo, TraceState, crash_restart, init_state,
)

__all__ = [
    "CANDIDATE", "DEBUG_CODES", "FOLLOWER", "LEADER", "NIL", "PRE_CANDIDATE",
    "DeviceCluster", "EngineConfig", "FaultSchedule", "HeatState",
    "HostInbox", "Messages", "QuorumContact", "RaftState", "StepInfo",
    "TraceState", "auto_host_inbox", "cluster_step", "cluster_step_nemesis",
    "committed_entries", "crash_restart", "init_state", "node_step",
    "raise_debug_violations", "route", "run_cluster_ticks",
    "run_cluster_ticks_nemesis", "run_cluster_ticks_reads",
]
