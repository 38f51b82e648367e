"""Multi-tick cluster simulation: the throughput path.

The counterpart of ``rafting_tpu/core/sim.py``.  Where the JAX engine runs
a ``lax.scan`` over whole-cluster steps, the port runs a plain Python tick
loop: each tick builds the self-driving host inbox and steps the cluster.
Neither makes a host synchronisation, so the loop only enqueues work on
the card (and can later be captured as a CUDA graph).

``run_cluster_ticks_blocked`` tiles the group axis: groups never interact,
so blocks of ``group_block`` groups each run the whole tick loop, one
block after another (as ``lax.map`` runs them in the JAX engine), lane
for lane the JAX function's result.

``run_cluster_ticks``, ``run_cluster_ticks_nemesis`` and
``committed_entries`` also take a ``mesh`` (``core/shard.py``): each rank
then runs its slice of the cluster from ``shard_cluster``, with the full
config, and the ranks meet only in the collectives of ``route``, the
nemesis step's crash/stall exchange and the commit total.  The gathered
result is the unsharded run's, lane for lane.

Each entry point takes ``conn``, ``submit_n``, ``read_n`` and a fault
schedule's masks as numpy arrays too (the JAX functions do): they are
converted once, before the loop, onto the cluster state's device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.distributed as dist

from . import prng
from .cluster import (
    as_fault_schedule, auto_host_inbox, cluster_step, cluster_step_nemesis,
)
from .shard import (
    SUBMIT_PSPEC, Mesh, info_pspecs, messages_pspecs, state_pspecs,
)
from .types import (
    BOOL, I32, EngineConfig, FaultSchedule, Messages, RaftState, StepInfo,
    as_lanes, resolve_device, tree_map,
)


def _on_device(states: RaftState, device, mesh: Mesh | None = None
               ) -> None:
    dev = mesh.device if mesh is not None else resolve_device(device)
    if states.term.device.type != dev.type:
        raise ValueError(f"cluster state lives on {states.term.device}, "
                         f"the run asked for {dev}")


def _operands(states: RaftState, conn, submit_n, read_n=None) -> tuple:
    """``conn``, ``submit_n`` and ``read_n`` as tensors on the cluster
    state's device: numpy operands copied there once, before the tick
    loop; tensors already there pass through."""
    dev = states.term.device
    return (as_lanes(conn, BOOL, dev), as_lanes(submit_n, I32, dev),
            as_lanes(read_n, I32, dev))


def _scan_ticks(cfg: EngineConfig, n_ticks: int, states: RaftState,
                inflight: Messages, prev_info: StepInfo, conn: torch.Tensor,
                submit_n: torch.Tensor, read_n=None, durable_lag: bool = False,
                mesh: Mesh | None = None
                ) -> Tuple[RaftState, Messages, StepInfo]:
    info = prev_info
    for _ in range(n_ticks):
        host = auto_host_inbox(cfg, states, submit_n, True, info, read_n,
                               durable_lag)
        states, inflight, info = cluster_step(cfg, states, inflight, host,
                                              conn, mesh)
    return states, inflight, info


def run_cluster_ticks(cfg: EngineConfig, n_ticks: int, states: RaftState,
                      inflight: Messages, prev_info: StepInfo,
                      conn: torch.Tensor, submit_n: torch.Tensor,
                      read_n=None, durable_lag: bool = False, device=None,
                      mesh: Mesh | None = None
                      ) -> Tuple[RaftState, Messages, StepInfo]:
    """Advance the cluster ``n_ticks`` ticks under a constant offered load
    (``submit_n`` [N, G]; optional ``read_n`` [N, G]).  Runs on the card
    unless ``device`` says otherwise; the state must already live there.
    On a ``mesh``, every input is this rank's slice (``shard_cluster``),
    ``cfg`` stays the full config and the run is on ``mesh.device``.
    Returns the final ``(states, inflight, info)``."""
    _on_device(states, device, mesh)
    conn, submit_n, read_n = _operands(states, conn, submit_n, read_n)
    if mesh is not None:
        cfg = mesh.local_config(cfg)
    return _scan_ticks(cfg, n_ticks, states, inflight, prev_info, conn,
                       submit_n, read_n, durable_lag, mesh)


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
    conn, submit_n, read_n = _operands(states, conn, submit_n, read_n)
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
                              read_n=None, device=None,
                              mesh: Mesh | None = None
                              ) -> Tuple[RaftState, Messages, StepInfo]:
    """Advance the cluster ``sched.n_ticks`` ticks under a fault schedule
    (per-tick link masks, crash-restarts, stalls, duplicate delivery),
    with constant offered load ``submit_n`` [N, G] (and optional
    ``read_n``).  The counterpart of the JAX scan: a tick loop over the
    schedule's leading axis that makes no host synchronisation.  Runs on
    the card unless ``device`` says otherwise; state and schedule must
    already live there.  Returns the final ``(states, inflight, info)``;
    a stalled node's StepInfo stays frozen, so its host half stalls
    too.  On a ``mesh``, as :func:`run_cluster_ticks`, with the
    schedule's slice from ``shard_fault_schedule``."""
    _on_device(states, device, mesh)
    if isinstance(sched.link_up, torch.Tensor) and \
            sched.link_up.device.type != states.term.device.type:
        raise ValueError(f"fault schedule lives on {sched.link_up.device}, "
                         f"the cluster state on {states.term.device}")
    sched = as_fault_schedule(sched, states.term.device)
    _, submit_n, read_n = _operands(states, None, submit_n, read_n)
    if mesh is not None:
        cfg = mesh.local_config(cfg)
    info = prev_info
    for t in range(sched.n_ticks):
        fault = tree_map(lambda a: a[t], sched)
        host = auto_host_inbox(cfg, states, submit_n, True, info, read_n)
        states, inflight, info = cluster_step_nemesis(
            cfg, states, inflight, host, info, fault, mesh)
    return states, inflight, info


def _group_axis(spec) -> int | None:
    return spec.index("group") if "group" in spec else None


def _to_blocks(tree, specs, nb: int, gb: int):
    """Split every group axis into [nb, gb] and move the block axis front.
    Leaves without a group axis are broadcast (shared by every block)."""
    def f(a, spec):
        ax = _group_axis(spec)
        if ax is None:
            return a.expand((nb,) + a.shape)
        pad = nb * gb - a.shape[ax]
        if pad:
            # Zero pad == inactive lanes (active=False).
            shape = list(a.shape)
            shape[ax] = pad
            a = torch.cat([a, a.new_zeros(shape)], dim=ax)
        a = a.reshape(a.shape[:ax] + (nb, gb) + a.shape[ax + 1:])
        return a.movedim(ax, 0)
    return tree_map(f, tree, specs)


def _from_blocks(tree, specs, G: int):
    """Invert ``_to_blocks``: merge [nb, gb] back into the group axis and
    strip padding.  Block-invariant leaves take block 0's value."""
    def f(a, spec):
        ax = _group_axis(spec)
        if ax is None:
            return a[0]
        a = a.movedim(0, ax)
        a = a.reshape(a.shape[:ax] + (-1,) + a.shape[ax + 2:])
        return a.narrow(ax, 0, G).contiguous()
    return tree_map(f, tree, specs)


def run_cluster_ticks_blocked(cfg: EngineConfig, n_ticks: int,
                              states: RaftState, inflight: Messages,
                              prev_info: StepInfo, conn: torch.Tensor,
                              submit_n: torch.Tensor, group_block: int,
                              device=None
                              ) -> Tuple[RaftState, Messages, StepInfo]:
    """``run_cluster_ticks``, tiled over the group axis.

    With ``group_block >= G`` this is the plain loop.  Otherwise the
    groups are padded with inert lanes (zero means ``active=False``: a
    padded lane never elects, accepts or sends) up to ``nb`` blocks of
    ``group_block``, and each block runs the whole ``n_ticks`` loop as a
    cluster of ``group_block`` groups, one block after another, with no
    host synchronisation.  Block b's per-node PRNG keys are the node keys
    folded with b, so election jitter stays decorrelated across blocks:
    the result is not the unblocked run's, but it is the JAX engine's
    blocked run lane for lane.  Leaves with no group axis (``rng``,
    ``now``, ``node_id``) come back as block 0's.  Runs on the card
    unless ``device`` says otherwise; the state must already live there.
    """
    _on_device(states, device)
    conn, submit_n, _ = _operands(states, conn, submit_n)
    G = cfg.n_groups
    if group_block >= G:
        return _scan_ticks(cfg, n_ticks, states, inflight, prev_info, conn,
                           submit_n)
    nb = -(-G // group_block)
    gb = group_block
    cfg_blk = dataclasses.replace(cfg, n_groups=gb)

    st_specs, msg_specs, inf_specs = (
        state_pspecs(trace=states.trace is not None,
                     heat=states.heat is not None,
                     qc=states.qc is not None), messages_pspecs(),
        info_pspecs(qc=prev_info.cq_stepdown is not None))
    states_b = _to_blocks(states, st_specs, nb, gb)
    inflight_b = _to_blocks(inflight, msg_specs, nb, gb)
    info_b = _to_blocks(prev_info, inf_specs, nb, gb)
    submit_b = _to_blocks(submit_n, SUBMIT_PSPEC, nb, gb)
    # Decorrelate the per-node keys across blocks: fold_in(node key, b).
    states_b = states_b.replace(rng=torch.stack(
        [prng.fold_in(states.rng, b) for b in range(nb)]))

    outs = []
    for b in range(nb):
        pick = lambda a: a[b]
        outs.append(_scan_ticks(
            cfg_blk, n_ticks, tree_map(pick, states_b),
            tree_map(pick, inflight_b), tree_map(pick, info_b), conn,
            submit_b[b]))
    stack = lambda *xs: torch.stack(xs)
    states_o, inflight_o, info_o = (tree_map(stack, *parts)
                                    for parts in zip(*outs))
    return (_from_blocks(states_o, st_specs, G),
            _from_blocks(inflight_o, msg_specs, G),
            _from_blocks(info_o, inf_specs, G))


def committed_entries(states: RaftState, mesh: Mesh | None = None
                      ) -> torch.Tensor:
    """Total entries committed across all groups, each group counted once
    at its furthest node.  An int64 scalar tensor: the JAX engine's total
    is int32 with x64 off and wraps past 2**31 (100k groups reach that
    after ~21k commits per group).  On a ``mesh``, the whole cluster's
    total on every rank: a MAX over the node shards, then a SUM over the
    group shards."""
    commit = torch.as_tensor(states.commit)
    if mesh is None:
        return commit.amax(dim=0).to(torch.int64).sum()
    furthest = mesh.all_reduce(commit.amax(dim=0),
                               dist.ReduceOp.MAX, "node")
    return mesh.all_reduce(furthest.to(torch.int64).sum(),
                           dist.ReduceOp.SUM, "group")
