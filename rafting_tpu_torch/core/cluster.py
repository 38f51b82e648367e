"""Whole-cluster execution: N nodes in one batched step.

The counterpart of ``rafting_tpu/core/cluster.py``.  A whole N-node cluster
steps in one ``node_step`` call over the explicit leading node axis, and
message routing is a pure permutation: ``inbox[dst, src] = outbox[src,
dst]``, a transpose of the first two axes.  Fault injection is a boolean
connectivity matrix ANDed into every ``*_valid`` mask; the nemesis step
(:func:`cluster_step_nemesis`) adds crash-restarts, stalls and duplicate
delivery from one tick of a ``FaultSchedule``, all as masks on the
device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .shard import Mesh, exchange_messages
from .step import node_step, raise_debug_violations
from .types import (
    I32, LEADER, NIL, EngineConfig, FaultSchedule, HostInbox, Messages,
    RaftState, StepInfo, conf_learners_of, conf_new_of, conf_voters_of,
    crash_restart, init_state, resolve_device, stack_states, tree_map,
)

_VALID_FIELDS = tuple(f.name for f in dataclasses.fields(Messages)
                      if f.name.endswith("_valid"))
# Message kind (the field-name prefix: ae/aer/rv/rvr/is/isr/tn) -> every
# field of that RPC.  Duplicate re-delivery replaces whole RPCs.
_KIND_FIELDS = {}
for _f in dataclasses.fields(Messages):
    _KIND_FIELDS.setdefault(_f.name.split("_", 1)[0], []).append(_f.name)


def route(outboxes: Messages, conn: Optional[torch.Tensor] = None,
          mesh: Optional[Mesh] = None) -> Messages:
    """Deliver every node's outbox as next tick's inboxes: ``[N(sender),
    P(dest), G, ...]`` -> ``[N(dest), P(sender), G, ...]``.  ``conn[s, d]``
    masks link s->d (False = partitioned).

    On a ``mesh`` this rank holds sender rows ``[Nl, N, Gl]`` and
    ``conn``'s rows ``[Nl, N]``: the links are masked on the sender's
    side, then the node shards swap their blocks
    (:func:`~rafting_tpu_torch.core.shard.exchange_messages`).  Masking
    commutes with the swap, so the inboxes are the unsharded ones."""
    if mesh is not None:
        if conn is not None:
            mask = conn.unsqueeze(-1)
            outboxes = outboxes.replace(**{
                name: getattr(outboxes, name) & mask
                for name in _VALID_FIELDS})
        return exchange_messages(mesh, outboxes)
    swapped = tree_map(lambda a: a.transpose(0, 1), outboxes)
    if conn is None:
        return swapped
    # After the swap an element at [d, s] traveled s->d: mask with conn.T.
    mask = conn.transpose(0, 1).unsqueeze(-1)
    return swapped.replace(**{name: getattr(swapped, name) & mask
                              for name in _VALID_FIELDS})


def cluster_step(cfg: EngineConfig, states: RaftState, inflight: Messages,
                 host: HostInbox, conn: torch.Tensor,
                 mesh: Optional[Mesh] = None
                 ) -> Tuple[RaftState, Messages, StepInfo]:
    """One lockstep tick of the whole cluster (leading node axis [N] on
    ``states``, ``host`` and the returned ``StepInfo``; ``inflight`` is the
    traffic delivered this tick).  On a ``mesh``, one rank's slice:
    ``cfg`` is the slice's (``Mesh.local_config``) and ``conn`` its
    rows."""
    base = 0 if mesh is None else mesh.group_base(cfg)
    return node_step(cfg, states, route(inflight, conn, mesh), host, base)


def _node_bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a [N] node mask against a leading-node-axis tensor."""
    return mask.reshape(mask.shape + (1,) * (like.ndim - 1))


def _select_nodes(mask: torch.Tensor, on_true, on_false):
    """Per-node select over a container: leaf[n] <- on_true[n] where
    mask[n]; None subtrees stay None."""
    return tree_map(lambda a, b: torch.where(_node_bcast(mask, a), a, b),
                    on_true, on_false)


def cluster_step_nemesis(cfg: EngineConfig, states: RaftState,
                         inflight: Messages, host: HostInbox,
                         prev_info: StepInfo, fault: FaultSchedule,
                         mesh: Optional[Mesh] = None
                         ) -> Tuple[RaftState, Messages, StepInfo]:
    """One lockstep tick under one tick of a fault schedule (``fault``
    holds ``link_up`` [N, N], ``crash`` [N], ``stall`` [N], ``dup`` [N,
    N]).  Mirrors ``rafting_tpu.core.cluster.cluster_step_nemesis``:

    1. crashed nodes reset volatile state (:func:`crash_restart`) before
       delivery; the select keeps other nodes' PRNG streams bit-exact;
    2. in-flight messages deliver through ``link_up``; anything addressed
       to a crashed or stalled node is lost;
    3. live nodes step; stalled nodes are frozen wholesale (state, clock,
       timers, StepInfo) and send nothing;
    4. messages delivered over a ``dup`` link are queued again for next
       tick, whole RPC, wherever the fresh outbox left that kind empty.

    Every fault is a mask on the device: no host synchronisation.

    On a ``mesh`` the state, messages and ``fault`` are one rank's slice
    (``fault``'s sender rows): a sender needs every destination's
    crash and stall, so the node shards all-gather them once a tick."""
    down = fault.crash | fault.stall                               # [N]
    base, down_all = 0, down
    if mesh is not None:
        base = mesh.group_base(cfg)
        down_all = torch.cat(mesh.all_gather(down, "node"))         # [N]

    states = _select_nodes(fault.crash, crash_restart(cfg, states, base),
                           states)

    delivered = fault.link_up & ~down_all.unsqueeze(0)              # [N, N]
    stepped, outboxes, infos = node_step(
        cfg, states, route(inflight, delivered, mesh), host, base)
    new_states = _select_nodes(fault.stall, states, stepped)
    infos = _select_nodes(fault.stall, prev_info, infos)
    sender_up = ~fault.stall
    outboxes = outboxes.replace(**{
        name: getattr(outboxes, name) & _node_bcast(
            sender_up, getattr(outboxes, name))
        for name in _VALID_FIELDS})

    dup_lane = (fault.dup & delivered).unsqueeze(-1)               # [N, N, 1]
    reps = {}
    for kind, names in _KIND_FIELDS.items():
        vname = f"{kind}_valid"
        keep = dup_lane & getattr(inflight, vname) \
            & ~getattr(outboxes, vname)                            # [N, P, G]
        for name in names:
            old = getattr(inflight, name)
            k = keep if old.ndim == keep.ndim else keep.unsqueeze(-1)
            reps[name] = torch.where(k, old, getattr(outboxes, name))
        reps[vname] = getattr(outboxes, vname) | keep
    return new_states, outboxes.replace(**reps), infos


def auto_host_inbox(cfg: EngineConfig, states: RaftState,
                    submit_n: torch.Tensor, compact, prev_info: StepInfo,
                    read_n: Optional[torch.Tensor] = None,
                    durable_lag: bool = False) -> HostInbox:
    """A HostInbox batch [N, ...] for the self-driving harness: offer
    ``submit_n`` (and ``read_n``) per group, compact with slack up to
    ``commit - L/4`` (``compact``: True every tick, int K every K ticks,
    False never), and service last tick's snapshot requests instantly.
    ``durable_lag`` feeds the previous tick's log tail as the durable
    tail.  Mirrors ``rafting_tpu.core.cluster.auto_host_inbox``."""
    N, G = states.term.shape
    dev = states.term.device
    slack = cfg.log_slots // 4
    zero = torch.zeros((N, G), dtype=I32, device=dev)
    if read_n is None:
        read_n = zero
    if compact is True:
        ct = torch.clamp(states.commit - slack, min=0)
    elif compact:
        due = (states.now % int(compact) == 0).unsqueeze(-1)
        ct = torch.where(due, torch.clamp(states.commit - slack, min=0),
                         zero)
    else:
        ct = zero
    return HostInbox.empty(cfg, dev, lead=(N,)).replace(
        submit_n=submit_n,
        read_n=read_n,
        compact_to=ct,
        snap_done=prev_info.snap_req,
        snap_idx=prev_info.snap_req_idx,
        snap_term=prev_info.snap_req_term,
        snap_conf=prev_info.snap_req_conf,
        durable_tail=prev_info.log_tail if durable_lag else None,
    )


def cluster_snapshot(states: RaftState) -> dict:
    """Host snapshot dict (numpy) from a stacked [N, ...] RaftState — the
    audit currency of ``rafting_tpu/testkit/invariants.py``."""
    np_ = lambda t: t.detach().cpu().numpy()
    return {
        "term": np_(states.term),
        "role": np_(states.role),
        "voted_for": np_(states.voted_for),
        "leader_id": np_(states.leader_id),
        "commit": np_(states.commit),
        "last": np_(states.log.last),
        "base": np_(states.log.base),
        "log_term": np_(states.log.term),
        "now": np_(states.now),
    }


class DeviceCluster:
    """Host-side driver for an all-on-device N-node Multi-Raft cluster
    (``n_peers`` nodes, each holding ``n_groups`` groups).  Runs on the
    card unless ``device`` says otherwise."""

    def __init__(self, cfg: EngineConfig, seed: int = 0,
                 n_active: int | None = None, n_voters: int | None = None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # Compaction policy for the self-driving inbox (auto_host_inbox).
        self.compact = True
        N = cfg.n_peers
        self.states: RaftState = stack_states([
            init_state(cfg, i, seed=seed, n_active=n_active,
                       n_voters=n_voters, device=self.device)
            for i in range(N)])
        self.inflight: Messages = Messages.empty(cfg, self.device, lead=(N,))
        self.conn = torch.ones((N, N), dtype=torch.bool, device=self.device)
        self.last_info: StepInfo = StepInfo.empty(cfg, self.device,
                                                  lead=(N,))

    # -- fault injection ----------------------------------------------------
    def set_partition(self, groups_of_nodes) -> None:
        """Partition the cluster: nodes can only reach their own side."""
        N = self.cfg.n_peers
        conn = np.zeros((N, N), bool)
        for side in groups_of_nodes:
            for a in side:
                for b in side:
                    conn[a, b] = True
        self.conn = torch.as_tensor(conn, device=self.device)

    def heal(self) -> None:
        N = self.cfg.n_peers
        self.conn = torch.ones((N, N), dtype=torch.bool, device=self.device)

    def isolate(self, node: int) -> None:
        N = self.cfg.n_peers
        self.set_partition([[n for n in range(N) if n != node], [node]])

    # -- stepping -----------------------------------------------------------
    def _dense(self, v) -> torch.Tensor:
        N, G = self.cfg.n_peers, self.cfg.n_groups
        if v is None:
            return torch.zeros((N, G), dtype=I32, device=self.device)
        v = torch.as_tensor(v, dtype=I32, device=self.device)
        return v.expand(N, G) if v.ndim == 0 else v

    def tick(self, submit_n=None, host: Optional[HostInbox] = None,
             read_n=None) -> StepInfo:
        if host is None:
            host = auto_host_inbox(self.cfg, self.states,
                                   self._dense(submit_n), self.compact,
                                   self.last_info, self._dense(read_n))
        self.states, self.inflight, info = cluster_step(
            self.cfg, self.states, self.inflight, host, self.conn)
        self.last_info = info
        if self.cfg.debug_checks:
            self._debug_check(info)
        return info

    def _debug_check(self, info: StepInfo) -> None:
        """cfg.debug_checks: raise on any in-step violation code, and on
        the one cross-node invariant a node cannot see — two leaders of
        one group at one term.  Reads the tick back to the host."""
        raise_debug_violations(info, "cluster tick")
        role = self.states.role.cpu().numpy()
        term = self.states.term.cpu().numpy()
        N = role.shape[0]
        for i in range(N):
            for j in range(i + 1, N):
                both = ((role[i] == LEADER) & (role[j] == LEADER)
                        & (term[i] == term[j]))
                if both.any():
                    g = int(np.nonzero(both)[0][0])
                    raise AssertionError(
                        f"election safety violated: nodes {i} and {j} both "
                        f"lead group {g} at term {int(term[i, g])}")

    def run(self, n_ticks: int, submit_n=None) -> None:
        for _ in range(n_ticks):
            self.tick(submit_n)

    # -- membership ---------------------------------------------------------
    def _select(self, groups) -> np.ndarray:
        sel = np.zeros(self.cfg.n_groups, bool)
        sel[np.asarray(list(range(self.cfg.n_groups)) if groups is None
                       else groups)] = True
        return sel

    def request_membership(self, voters: int, learners: int = 0,
                           groups=None, submit_n=None) -> StepInfo:
        """One tick with a membership-change request offered to every node
        for the selected groups (only the leader's intake takes it)."""
        sel = self._select(groups)
        hv = np.where(sel, voters, 0).astype(np.int32)
        hl = np.where(sel, learners, 0).astype(np.int32)
        return self._tick_with(conf_voters=hv, conf_learners=hl,
                               submit_n=submit_n)

    def request_transfer(self, target, groups=None) -> StepInfo:
        """One tick with a leadership-transfer request offered to every
        node for the selected groups (``target``: a peer id or [G])."""
        sel = self._select(groups)
        tgt = np.broadcast_to(np.asarray(target, np.int32),
                              (self.cfg.n_groups,))
        return self._tick_with(
            xfer_target=np.where(sel, tgt, NIL).astype(np.int32))

    def _tick_with(self, submit_n=None, **host_lanes) -> StepInfo:
        """Tick once with extra per-group HostInbox lanes broadcast to
        every node on top of the self-driving policy."""
        N = self.cfg.n_peers
        host = auto_host_inbox(self.cfg, self.states, self._dense(submit_n),
                               self.compact, self.last_info)
        host = host.replace(**{
            k: torch.as_tensor(v, device=self.device).expand(
                (N,) + v.shape).contiguous()
            for k, v in host_lanes.items()})
        return self.tick(host=host)

    def membership(self, group: int, node: int = 0) -> dict:
        """Decoded active config of one group as one node sees it."""
        w = int(self.states.conf_word[node, group])
        return {"voters": int(conf_voters_of(w)),
                "voters_new": int(conf_new_of(w)),
                "learners": int(conf_learners_of(w)),
                "joint": bool(conf_new_of(w))}

    # -- inspection ---------------------------------------------------------
    def snapshot(self) -> dict:
        """Pull the whole cluster state to host numpy for assertions."""
        return cluster_snapshot(self.states)

    def leaders(self, group: int = 0) -> list[int]:
        role = self.states.role[:, group].cpu().numpy()
        return [int(n) for n in np.nonzero(role == LEADER)[0]]

    def log_terms(self, node: int, group: int, lo: int, hi: int) -> list:
        """Entry terms for indices [lo, hi] on one node (host-side read)."""
        L = self.cfg.log_slots
        ring = self.states.log.term[node, group].cpu().numpy()
        base = int(self.states.log.base[node, group])
        last = int(self.states.log.last[node, group])
        return [None if (i <= base or i > last) else int(ring[i % L])
                for i in range(lo, hi + 1)]
