"""Multi-tick cluster simulation: the throughput path.

The counterpart of ``rafting_tpu/core/sim.py``.  Where the JAX engine runs
a ``lax.scan`` over whole-cluster steps, the port runs a plain Python tick
loop: each tick builds the self-driving host inbox and steps the cluster.
Neither makes a host synchronisation, so the loop only enqueues work on
the card (and can later be captured as a CUDA graph).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .cluster import auto_host_inbox, cluster_step, cluster_step_nemesis
from .types import (
    EngineConfig, FaultSchedule, Messages, RaftState, StepInfo,
    resolve_device, tree_map,
)


def _on_device(states: RaftState, device) -> None:
    dev = resolve_device(device)
    if states.term.device.type != dev.type:
        raise ValueError(f"cluster state lives on {states.term.device}, "
                         f"the run asked for {dev}")


def run_cluster_ticks(cfg: EngineConfig, n_ticks: int, states: RaftState,
                      inflight: Messages, prev_info: StepInfo,
                      conn: torch.Tensor, submit_n: torch.Tensor,
                      read_n=None, durable_lag: bool = False, device=None
                      ) -> Tuple[RaftState, Messages, StepInfo]:
    """Advance the cluster ``n_ticks`` ticks under a constant offered load
    (``submit_n`` [N, G]; optional ``read_n`` [N, G]).  Runs on the card
    unless ``device`` says otherwise; the state must already live there.
    Returns the final ``(states, inflight, info)``."""
    _on_device(states, device)
    info = prev_info
    for _ in range(n_ticks):
        host = auto_host_inbox(cfg, states, submit_n, True, info, read_n,
                               durable_lag)
        states, inflight, info = cluster_step(cfg, states, inflight, host,
                                              conn)
    return states, inflight, info


def run_cluster_ticks_reads(cfg: EngineConfig, n_ticks: int,
                            states: RaftState, inflight: Messages,
                            prev_info: StepInfo, conn: torch.Tensor,
                            submit_n: torch.Tensor, read_n: torch.Tensor,
                            device=None):
    """``run_cluster_ticks`` with read-plane accounting: returns
    ``(states, inflight, info, reads_served, lease_hits, appended)``.
    The three counters are int64 scalar tensors on the run's device (the
    JAX engine keeps int32 scalars)."""
    _on_device(states, device)
    dev = states.term.device
    served = torch.zeros((), dtype=torch.int64, device=dev)
    lease = torch.zeros((), dtype=torch.int64, device=dev)
    appended = torch.zeros((), dtype=torch.int64, device=dev)
    info = prev_info
    for _ in range(n_ticks):
        host = auto_host_inbox(cfg, states, submit_n, True, info, read_n)
        states, inflight, info = cluster_step(cfg, states, inflight, host,
                                              conn)
        served = served + info.read_served.sum()
        lease = lease + info.read_lease.sum()
        appended = appended + torch.where(
            info.appended_to > 0,
            info.appended_to - info.appended_from + 1, 0).sum()
    return states, inflight, info, served, lease, appended


def run_cluster_ticks_nemesis(cfg: EngineConfig, states: RaftState,
                              inflight: Messages, prev_info: StepInfo,
                              sched: FaultSchedule, submit_n: torch.Tensor,
                              read_n=None, device=None
                              ) -> Tuple[RaftState, Messages, StepInfo]:
    """Advance the cluster ``sched.n_ticks`` ticks under a fault schedule
    (per-tick link masks, crash-restarts, stalls, duplicate delivery),
    with constant offered load ``submit_n`` [N, G] (and optional
    ``read_n``).  The counterpart of the JAX scan: a tick loop over the
    schedule's leading axis that makes no host synchronisation.  Runs on
    the card unless ``device`` says otherwise; state and schedule must
    already live there.  Returns the final ``(states, inflight, info)``;
    a stalled node's StepInfo stays frozen, so its host half stalls
    too."""
    _on_device(states, device)
    if sched.link_up.device.type != states.term.device.type:
        raise ValueError(f"fault schedule lives on {sched.link_up.device}, "
                         f"the cluster state on {states.term.device}")
    info = prev_info
    for t in range(sched.n_ticks):
        fault = tree_map(lambda a: a[t], sched)
        host = auto_host_inbox(cfg, states, submit_n, True, info, read_n)
        states, inflight, info = cluster_step_nemesis(
            cfg, states, inflight, host, info, fault)
    return states, inflight, info


def committed_entries(states: RaftState) -> torch.Tensor:
    """Total entries committed across all groups, each group counted once
    at its furthest node.  An int64 scalar tensor: the JAX engine's total
    is int32 with x64 off and wraps past 2**31 (100k groups reach that
    after ~21k commits per group)."""
    return states.commit.amax(dim=0).to(torch.int64).sum()
