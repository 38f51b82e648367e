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

The rest of the module runs a whole cluster sharded over a (node shards x
group shards) grid of ``torch.distributed`` ranks, the counterpart of the
JAX package's ``Mesh('node', 'group')``.  :class:`Mesh` holds the grid,
this rank's coordinates, its device and the process subgroups of each
axis; :func:`shard_cluster` and :func:`shard_fault_schedule` give a rank
its slice of every input, read from the tables above and materialised
dense on its device; :func:`exchange_messages` is the node axis of
``route`` (one ``all_to_all_single`` a tick over the node subgroup);
:func:`gather_tree` puts full tensors back together for checks.  The
slicing and the reassembly are pure functions of (tree, table, grid,
coordinates), so their shapes can be tested in one process.

With the gloo backend and tensors on the card, every collective copies
its operands to host tensors and the results back (``Mesh.staged``):
gloo moves host memory only.  That staging is the chosen route for
several ranks on one card, not a fallback.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .types import (
    EngineConfig, FaultSchedule, HeatState, HostInbox, LogState, Messages,
    QuorumContact, RaftState, StepInfo, TraceState, tree_map,
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


# ---------------------------------------------------------------------------
# The grid of ranks
# ---------------------------------------------------------------------------

_AXIS = {"node": 0, "group": 1}


@dataclasses.dataclass
class Mesh:
    """A (node shards x group shards) grid of ranks: rank ``i * b + j``
    holds node block ``i`` and group block ``j`` (``shape = (a, b)``), as
    ``Mesh(devices.reshape(a, b), ('node', 'group'))`` places devices.
    ``node_pg`` is the process subgroup of the ranks that hold this
    rank's group block (the node axis, where messages travel), and
    ``group_pg`` that of the ranks that hold its node block.  A mesh
    built by hand with no subgroups serves the pure slicing functions."""

    shape: Tuple[int, int]
    coords: Tuple[int, int]
    device: torch.device
    node_pg: object = None
    group_pg: object = None
    staged: bool = False

    def local_config(self, cfg: EngineConfig) -> EngineConfig:
        """The config of this rank's slice: ``n_groups`` is the block's."""
        return dataclasses.replace(cfg,
                                   n_groups=cfg.n_groups // self.shape[1])

    def group_base(self, local_cfg: EngineConfig) -> int:
        """Global index of this rank's first group."""
        return self.coords[1] * local_cfg.n_groups

    # -- collectives (bool travels as uint8; staged through the host) ----
    def _out(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(torch.uint8) if t.dtype == torch.bool else t
        return t.cpu() if self.staged else t.contiguous()

    def _back(self, t: torch.Tensor, dtype) -> torch.Tensor:
        t = t.to(self.device) if self.staged else t
        return t.to(torch.bool) if dtype == torch.bool else t

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Block k of ``x``'s first axis goes to node shard k; block k of
        the result came from node shard k."""
        src = self._out(x)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.node_pg)
        return self._back(out, x.dtype)

    def all_gather(self, x: torch.Tensor, axis: str) -> list:
        """``x`` from every rank of this rank's node subgroup (``axis``
        "node") or of the world ("world"), in rank order."""
        pg = self.node_pg if axis == "node" else None
        src = self._out(x)
        parts = [torch.empty_like(src)
                 for _ in range(dist.get_world_size(pg))]
        dist.all_gather(parts, src, group=pg)
        return [self._back(p, x.dtype) for p in parts]

    def all_reduce(self, x: torch.Tensor, op, axis: str) -> torch.Tensor:
        pg = self.node_pg if axis == "node" else self.group_pg
        t = self._out(x)
        t = t.clone() if t is x else t
        dist.all_reduce(t, op=op, group=pg)
        return self._back(t, x.dtype)


def init_mesh(shape: Tuple[int, int], device) -> Mesh:
    """The grid over the default process group (initialised by the
    caller, ``world_size == a * b``), with one subgroup for every node
    column and every group row; every rank builds every subgroup, in
    the same order, as ``new_group`` requires."""
    a, b = shape
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != a * b:
        raise ValueError(f"a ({a} x {b}) mesh needs {a * b} ranks, the "
                         f"process group has {world}")
    i, j = divmod(rank, b)
    node_pgs = [dist.new_group([k * b + jj for k in range(a)])
                for jj in range(b)]
    group_pgs = [dist.new_group([i2 * b + k for k in range(b)])
                 for i2 in range(a)]
    device = torch.device(device)
    return Mesh(shape=(a, b), coords=(i, j), device=device,
                node_pg=node_pgs[j], group_pg=group_pgs[i],
                staged=(dist.get_backend() == "gloo"
                        and device.type == "cuda"))


# ---------------------------------------------------------------------------
# Slicing and reassembly: pure functions of (tree, table, grid, coords)
# ---------------------------------------------------------------------------

def _check(ok: bool, what) -> None:
    # Raised, not asserted: the guard must hold under ``python -O`` too.
    if not ok:
        raise AssertionError(what)


def local_slice(a: torch.Tensor, spec, shape, coords) -> torch.Tensor:
    """The block of ``a`` that grid position ``coords`` holds: every axis
    named in ``spec`` split evenly over its mesh dimension (a view)."""
    for ax, name in enumerate(spec):
        if name is None:
            continue
        k = _AXIS[name]
        n = a.shape[ax]
        _check(n % shape[k] == 0,
               f"axis {ax} ({name}) of extent {n} does not split "
               f"{shape[k]} ways")
        w = n // shape[k]
        a = a.narrow(ax, coords[k] * w, w)
    return a


def slice_tree(tree, specs, shape, coords):
    """:func:`local_slice` on every leaf of a container (views)."""
    return tree_map(lambda a, s: local_slice(a, s, shape, coords),
                    tree, specs)


def assemble(parts: list, spec, shape) -> torch.Tensor:
    """Invert :func:`local_slice`: ``parts[i * b + j]`` is grid position
    ``(i, j)``'s block.  An axis the spec does not name is replicated
    along that mesh dimension, so its first block is taken."""
    a, b = shape
    rows = []
    for i in range(a if "node" in spec else 1):
        row = [parts[i * b + j] for j in range(b if "group" in spec else 1)]
        rows.append(torch.cat(row, dim=spec.index("group"))
                    if len(row) > 1 else row[0])
    return (torch.cat(rows, dim=spec.index("node"))
            if len(rows) > 1 else rows[0])


def _materialise(a: torch.Tensor, device) -> torch.Tensor:
    """A dense copy in fresh storage on ``device`` (a sliced group axis
    is a strided view; the quorum kernel is handed dense operands)."""
    return torch.empty(a.shape, dtype=a.dtype, device=device).copy_(a)


def _put(mesh: Mesh, tree, specs):
    return tree_map(lambda a: _materialise(a, mesh.device),
                    slice_tree(tree, specs, mesh.shape, mesh.coords))


def validate_cluster_shapes(cfg: EngineConfig, states: RaftState,
                            inflight: Messages, info: StepInfo,
                            conn: Optional[torch.Tensor] = None,
                            submit: Optional[torch.Tensor] = None,
                            shape: Tuple[int, int] = (1, 1)) -> None:
    """Check that the declared group axes hold G — the guard that makes
    the per-field tables safe whatever the sizes.  The asserts of
    ``rafting_tpu/core/shard.py:123-149``, on the full cluster (``shape``
    (1, 1)) or on one rank's slice of an ``(a, b)`` grid: then the group
    axes hold ``G / b`` and ``conn`` is the slice's rows of the full
    ``[N, N]``.  Raises AssertionError."""
    a, b = shape
    _check(cfg.n_groups % b == 0,
           f"{cfg.n_groups} groups do not split {b} ways")
    G, P = cfg.n_groups // b, cfg.n_peers
    N = states.term.shape[0]
    _check(states.term.ndim == 2 and states.term.shape[1] == G,
           states.term.shape)
    _check(states.next_idx.shape[1:] == (G, P), states.next_idx.shape)
    _check(states.log.term.shape[1] == G, states.log.term.shape)
    if states.trace is not None:
        _check(states.trace.tick.shape[1] == G, states.trace.tick.shape)
        _check(states.trace.n.shape[1:] == (G,), states.trace.n.shape)
    if states.heat is not None:
        _check(states.heat.appended.shape[1:] == (G,),
               states.heat.appended.shape)
    if states.qc is not None:
        _check(states.qc.heard.shape[1:] == (G, P), states.qc.heard.shape)
        _check(states.qc.since.shape[1:] == (G,), states.qc.since.shape)
    _check(inflight.ae_valid.ndim == 3 and inflight.ae_valid.shape[2] == G,
           inflight.ae_valid.shape)
    _check(info.commit.shape[1] == G, info.commit.shape)
    if conn is not None:
        _check(tuple(conn.shape) == (N, N * a), conn.shape)
    if submit is not None:
        _check(tuple(submit.shape) == (N, G), submit.shape)


def _tables(states: RaftState, info: StepInfo):
    return (state_pspecs(trace=states.trace is not None,
                         heat=states.heat is not None,
                         qc=states.qc is not None),
            messages_pspecs(),
            info_pspecs(qc=info.cq_stepdown is not None))


def shard_cluster(mesh: Mesh, cfg: EngineConfig, states: RaftState,
                  inflight: Messages, info: StepInfo, conn: torch.Tensor,
                  submit: torch.Tensor):
    """This rank's slice of every cluster input, by its table entry,
    dense on ``mesh.device``: ``(states, inflight, info, conn, submit)``
    with group axes ``G / b`` wide and node axes ``N / a`` long
    (``conn`` keeps its sender rows).  The full inputs are validated
    first and the slices after."""
    validate_cluster_shapes(cfg, states, inflight, info, conn, submit)
    st, msg, inf = _tables(states, info)
    out = (_put(mesh, states, st), _put(mesh, inflight, msg),
           _put(mesh, info, inf), _put(mesh, conn, CONN_PSPEC),
           _put(mesh, submit, SUBMIT_PSPEC))
    validate_cluster_shapes(cfg, *out, shape=mesh.shape)
    return out


def shard_fault_schedule(mesh: Mesh, sched: FaultSchedule) -> FaultSchedule:
    """This rank's slice of a ``[T, N, ...]`` fault schedule: the first
    node axis (the sender's) split as ``conn``'s rows, dense on
    ``mesh.device``."""
    T, N = sched.crash.shape
    _check(tuple(sched.link_up.shape) == (T, N, N), sched.link_up.shape)
    _check(tuple(sched.stall.shape) == (T, N), sched.stall.shape)
    _check(tuple(sched.dup.shape) == (T, N, N), sched.dup.shape)
    return _put(mesh, sched, fault_schedule_pspecs())


def gather_tree(mesh: Mesh, tree, specs):
    """Full tensors from every rank's slices (an all-gather over the
    world per leaf), on every rank — for checks, not for the tick."""
    return tree_map(
        lambda a, s: assemble(mesh.all_gather(a, "world"), s, mesh.shape),
        tree, specs)


def gather_cluster(mesh: Mesh, states: RaftState, inflight: Messages,
                   info: StepInfo):
    """:func:`gather_tree` of a sharded ``(states, inflight, info)``."""
    st, msg, inf = _tables(states, info)
    return (gather_tree(mesh, states, st), gather_tree(mesh, inflight, msg),
            gather_tree(mesh, info, inf))


# ---------------------------------------------------------------------------
# The node axis of ``route``
# ---------------------------------------------------------------------------

def exchange_messages(mesh: Mesh, outboxes: Messages) -> Messages:
    """Deliver this rank's outboxes ``[Nl(sender), N(dest), Gl, ...]`` as
    inboxes ``[Nl(dest), N(sender), Gl, ...]``: the unsharded ``route``'s
    transpose of the first two axes, across the node shards.

    Every field is packed, as int32 with its trailing axes flattened,
    into one ``[a, Nl, Nl, Gl, W]`` buffer whose block k holds the
    messages for node shard k's destinations; one ``all_to_all_single``
    over the node subgroup swaps the blocks, and the fields are read
    back as views of the received buffer in their own dtypes."""
    a = mesh.shape[0]
    names = [f.name for f in dataclasses.fields(Messages)]
    leaves = [getattr(outboxes, n) for n in names]
    Nl, N, Gl = leaves[0].shape[:3]
    cols = [t.reshape(Nl, N, Gl, -1).to(torch.int32) for t in leaves]
    widths = [c.shape[-1] for c in cols]
    W = sum(widths)
    buf = torch.cat(cols, dim=-1).view(Nl, a, N // a, Gl, W)
    got = mesh.all_to_all(buf.transpose(0, 1).contiguous())
    # got[k, s, d]: sender s of node shard k to local destination d.
    inbox = got.view(N, N // a, Gl, W).transpose(0, 1)
    out, o = {}, 0
    for n, t, w in zip(names, leaves, widths):
        v = inbox[..., o:o + w].reshape(
            (N // a, N, Gl) + tuple(t.shape[3:]))
        out[n] = v.to(torch.bool) if t.dtype == torch.bool else v
        o += w
    return Messages(**out)
