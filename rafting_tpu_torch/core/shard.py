"""Per-field axis tables for the stacked cluster containers.

The counterpart of the tables in ``rafting_tpu/core/shard.py``.  A whole
N-node cluster stacks every per-node container along a leading ``node``
axis, and each node's state is group-major.  The tables below name, field
by field, which axis of each tensor is the node axis and which is the
group axis.  They are declared by meaning, not inferred from sizes, so a
group count that happens to equal another dimension (P, L, B, S) can
never move an axis.

Each leaf is a plain tuple of axis names, one entry per leading axis
(``None`` for an axis that is neither), where the JAX package holds a
``jax.sharding.PartitionSpec`` of the same entries; trailing axes are
left out, as a PartitionSpec leaves them.  The containers are the port's
``RaftState``, ``Messages``, ``StepInfo``, ``HostInbox`` and
``FaultSchedule``, with ``None`` subtrees where a flag is off.  The
group-blocked runner (``core/sim.py``) reads the group axis from them.
"""

from __future__ import annotations

import dataclasses

from .types import (
    FaultSchedule, HeatState, HostInbox, LogState, Messages, QuorumContact,
    RaftState, StepInfo, TraceState,
)

# RaftState fields with no group axis: per-node scalars and the PRNG key.
_STATE_NODE_ONLY = ("node_id", "now", "rng")

_NODE = ("node",)
_NODE_GROUP = ("node", "group")             # [N, G, ...]
_NODE_PEER_GROUP = ("node", None, "group")  # [N, P, G, ...] message planes


def state_pspecs(trace: bool = False, heat: bool = False,
                 qc: bool = False) -> RaftState:
    """A RaftState-shaped tree of axis tuples for stacked [N, ...] state.

    ``trace``, ``heat`` and ``qc`` must match whether the state carries
    the flight-recorder, heat and quorum-contact subtrees: a None subtree
    in the state pairs with a None in the table.  Every lane of those
    subtrees is group-major like the rest."""
    kw = {f.name: _NODE_GROUP for f in dataclasses.fields(RaftState)}
    for name in _STATE_NODE_ONLY:
        kw[name] = _NODE
    kw["log"] = LogState(term=_NODE_GROUP, conf=_NODE_GROUP,
                         base=_NODE_GROUP, base_term=_NODE_GROUP,
                         base_conf=_NODE_GROUP, last=_NODE_GROUP)
    kw["trace"] = TraceState(
        tick=_NODE_GROUP, kind=_NODE_GROUP, term=_NODE_GROUP,
        aux=_NODE_GROUP, n=_NODE_GROUP) if trace else None
    kw["heat"] = HeatState(
        appended=_NODE_GROUP, sent=_NODE_GROUP, commits=_NODE_GROUP,
        reads=_NODE_GROUP) if heat else None
    kw["qc"] = QuorumContact(
        heard=_NODE_GROUP, since=_NODE_GROUP) if qc else None
    return RaftState(**kw)


def messages_pspecs() -> Messages:
    """Axes of stacked [N, P, G, ...] message planes (axis 2 = group)."""
    return Messages(**{f.name: _NODE_PEER_GROUP
                       for f in dataclasses.fields(Messages)})


def info_pspecs(qc: bool = False) -> StepInfo:
    """``qc`` must match whether the info carries the CheckQuorum lanes
    (cfg.check_quorum), as in :func:`state_pspecs`."""
    kw = {f.name: _NODE_GROUP for f in dataclasses.fields(StepInfo)}
    if not qc:
        kw["cq_stepdown"] = None
        kw["cq_veto"] = None
    return StepInfo(**kw)


def host_pspecs(durable: bool = False) -> HostInbox:
    """Axes of a stacked [N, ...] HostInbox.  ``read_veto`` is a per-node
    scalar; ``durable`` must match whether the inbox carries the
    durable-tail lane."""
    kw = {f.name: _NODE_GROUP for f in dataclasses.fields(HostInbox)}
    kw["read_veto"] = _NODE
    kw["durable_tail"] = _NODE_GROUP if durable else None
    return HostInbox(**kw)


# Inputs that are plain tensors.
CONN_PSPEC = ("node",)              # [N, N] connectivity, rows by node
SUBMIT_PSPEC = ("node", "group")    # [N, G] offered load


def fault_schedule_pspecs() -> FaultSchedule:
    """Axes of a [T, ...] FaultSchedule: the tick axis is walked, never
    split; the first node axis is the sender's, as in CONN_PSPEC."""
    return FaultSchedule(
        link_up=(None, "node"),     # [T, N, N]
        crash=(None, "node"),       # [T, N]
        stall=(None, "node"),       # [T, N]
        dup=(None, "node"),         # [T, N, N]
    )
