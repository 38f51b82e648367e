"""Core value types of the PyTorch port of the vectorized Multi-Raft engine.

The counterpart of ``rafting_tpu/core/types.py``: the consensus state of all
groups on a node lives in group-major tensors, and one step advances every
group at once.  Field names, shapes and dtypes match the JAX package lane
for lane (bool stays ``torch.bool``, int32 stays ``torch.int32``) so the
two engines can be compared tick for tick.  The one representational
difference is the PRNG key: jax's uint32 ``[2]`` key is carried as an
int64 ``[2]`` tensor holding the same two words (see ``core/prng.py``).

State containers are plain dataclasses of tensors; ``replace(**kw)`` stands
in for flax ``struct``'s method of the same name.

Index conventions
-----------------
* Log indices start at 1; index 0 is the empty sentinel.  ``base`` is the
  compaction floor: entries in ``(base, last]`` are live, ``base`` itself
  carries ``base_term`` (the snapshot milestone term).
* Peer slot p in any ``[G, P]`` / ``[P, G]`` tensor refers to cluster node
  id p.  A node's own slot is inert (never sent to, masked everywhere).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from . import prng

# Role lattice.
FOLLOWER = 0
PRE_CANDIDATE = 1
CANDIDATE = 2
LEADER = 3

NIL = -1  # "no vote" / "no leader" sentinel

I32 = torch.int32
BOOL = torch.bool

# Every index/term/clock lane is int32; the engine bounds per-group log
# indices, terms and the tick clock at I32_SAFE_MAX.
I32_SAFE_MAX = (1 << 31) - (1 << 20)

# Membership plane: one int32 config word packs three peer-slot bitmasks
# and a marker flag (bits 0..9 voters, 10..19 voters_new — nonzero iff
# joint, 20..29 learners, bit 30 set on every real config word).  The
# port keeps its own copy of the layout constants.
CONF_MASK_BITS = 10
CONF_MASK = (1 << CONF_MASK_BITS) - 1
CONF_NEW_SHIFT = CONF_MASK_BITS
CONF_LRN_SHIFT = 2 * CONF_MASK_BITS
CONF_FLAG = 1 << 30


def conf_pack(voters, voters_new=0, learners=0):
    """Pack a config word (python ints or int32 tensors; CONF_FLAG set)."""
    return (CONF_FLAG | (voters & CONF_MASK)
            | ((voters_new & CONF_MASK) << CONF_NEW_SHIFT)
            | ((learners & CONF_MASK) << CONF_LRN_SHIFT))


def conf_voters_of(word):
    return (word >> 0) & CONF_MASK


def conf_new_of(word):
    return (word >> CONF_NEW_SHIFT) & CONF_MASK


def conf_learners_of(word):
    return (word >> CONF_LRN_SHIFT) & CONF_MASK


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the one asked for, else the
    card.  With no card and no device given this raises — the port never
    drifts to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "rafting_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain version")
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration — the shape contract.

    Field for field the same as ``rafting_tpu.core.types.EngineConfig``
    (names, defaults and asserts), so one config describes both engines.
    ``use_pallas`` is kept for parity: in the port the CUDA quorum kernel
    runs on every CUDA tick whatever its value, and the plain version on
    every CPU tick.  ``trace_depth``, ``heat``, ``check_quorum`` and
    ``debug_checks`` are accepted here but not yet ported: the entry
    points raise ``NotImplementedError`` for them (:func:`check_supported`).
    """

    n_groups: int                 # G — groups resident on this node
    n_peers: int                  # P — cluster size (incl. self); peer id == node id
    log_slots: int = 64           # L — per-group log ring capacity (power of two)
    batch: int = 8                # B — max entries per AppendEntries
    max_submit: int = 8           # S — max client commands accepted per group per tick
    election_ticks: int = 10      # T — election timeout base, randomized [T, 2T)
    heartbeat_ticks: int = 3      # heartbeat interval
    rpc_timeout_ticks: int = 8    # re-send an un-acked AppendEntries after this long
    pre_vote: bool = True         # PreVote phase enabled
    use_pallas: bool = False      # parity field (see the class docstring)
    inflight_limit: int = 4       # W — max un-acked AppendEntries batches per (group, peer)
    avail_crit: int = 3           # peer unhealthy after this many consecutive RPC timeouts
    recovery_ticks: int = 6       # peer stays unhealthy this long after its last failure
    debug_checks: bool = False    # in-kernel invariant checks (not yet ported)
    read_slots: int = 4           # K — pending ReadIndex batches per group
    read_lease: bool = True       # lease fast path (receipt-anchored evidence)
    read_fresh_ticks: int = 3     # lease evidence freshness bound
    trace_depth: int = 0          # D — flight-recorder depth (not yet ported)
    quorum_fixed: bool = False    # BENCH-ONLY fixed-majority commit baseline
    heat: bool = False            # per-group heat lanes (not yet ported)
    check_quorum: bool = False    # CheckQuorum step-down (not yet ported)

    def __post_init__(self):
        assert self.n_peers >= 1
        assert self.n_peers <= CONF_MASK_BITS, \
            "membership plane packs voter/learner masks into one i32 conf " \
            f"word ({CONF_MASK_BITS} bits per mask) — n_peers is bounded"
        assert self.log_slots & (self.log_slots - 1) == 0, "log_slots must be a power of 2"
        assert self.batch <= self.log_slots
        assert self.heartbeat_ticks < self.election_ticks
        assert self.rpc_timeout_ticks >= 1
        assert self.inflight_limit >= 1, "pipelining window needs >= 1 slot"
        assert self.avail_crit >= 0 and self.recovery_ticks >= 0
        assert self.read_slots >= 1, "read plane needs >= 1 pending slot"
        assert self.read_fresh_ticks >= 2, \
            "lease evidence needs the 2-tick delivery round trip"
        assert self.trace_depth == 0 or self.trace_depth >= 12, \
            "flight-recorder rings need >= 12 slots (one tick can emit " \
            "up to 11 events, batched into one scatter per lane)"

    @property
    def majority(self) -> int:
        return self.n_peers // 2 + 1


def check_supported(cfg: EngineConfig) -> None:
    """Raise for the optional device subtrees the port does not have yet,
    rather than silently building a state without their lanes."""
    off = [name for name, on in (("trace_depth", cfg.trace_depth),
                                 ("heat", cfg.heat),
                                 ("check_quorum", cfg.check_quorum),
                                 ("debug_checks", cfg.debug_checks)) if on]
    if off:
        raise NotImplementedError(
            f"{', '.join(off)} not ported yet (ROADMAP queue 1, item 8: "
            "optional device subtrees)")


class _Tree:
    """Dataclass-of-tensors helpers shared by every state container."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _z(shape, device, dtype=I32):
    return torch.zeros(shape, dtype=dtype, device=device)


@dataclasses.dataclass
class LogState(_Tree):
    """Device-resident log metadata for all groups: entry terms in a ring."""

    term: torch.Tensor       # [G, L] int32 — term of entry at slot (index % L)
    conf: torch.Tensor       # [G, L] int32 — packed config word at that slot (0 = none)
    base: torch.Tensor       # [G] int32 — compaction floor
    base_term: torch.Tensor  # [G] int32 — term of the entry at `base`
    base_conf: torch.Tensor  # [G] int32 — packed config as of index `base`
    last: torch.Tensor       # [G] int32 — last appended index (0 = empty)


@dataclasses.dataclass
class RaftState(_Tree):
    """Group-major consensus state for one node (or, stacked along a
    leading node axis, for a whole cluster).  See the JAX class of the
    same name for the meaning of each lane."""

    node_id: torch.Tensor        # scalar int32
    now: torch.Tensor            # scalar int32 — logical tick clock
    rng: torch.Tensor            # [2] int64 holding the uint32 PRNG key words

    active: torch.Tensor         # [G] bool
    term: torch.Tensor           # [G] int32
    role: torch.Tensor           # [G] int32
    voted_for: torch.Tensor      # [G] int32
    leader_id: torch.Tensor      # [G] int32
    commit: torch.Tensor         # [G] int32
    applied: torch.Tensor        # [G] int32

    log: LogState

    own_from: torch.Tensor       # [G] int32
    next_idx: torch.Tensor       # [G, P] int32
    match_idx: torch.Tensor      # [G, P] int32
    send_next: torch.Tensor      # [G, P] int32
    inflight: torch.Tensor       # [G, P] int32
    hb_inflight: torch.Tensor    # [G, P] int32
    sent_at: torch.Tensor        # [G, P] int32
    need_snap: torch.Tensor      # [G, P] bool

    ok_at: torch.Tensor          # [G, P] int32
    fail_at: torch.Tensor        # [G, P] int32
    fail_streak: torch.Tensor    # [G, P] int32

    votes: torch.Tensor          # [G, P] bool
    prevotes: torch.Tensor       # [G, P] bool

    elect_deadline: torch.Tensor  # [G] int32
    hb_due: torch.Tensor          # [G] int32

    conf_idx: torch.Tensor       # [G] int32
    conf_word: torch.Tensor      # [G] int32

    xfer_to: torch.Tensor        # [G] int32
    xfer_dl: torch.Tensor        # [G] int32

    read_evid: torch.Tensor      # [G, P] int32
    rq_idx: torch.Tensor         # [G, K] int32
    rq_stamp: torch.Tensor       # [G, K] int32
    rq_n: torch.Tensor           # [G, K] int32
    rq_head: torch.Tensor        # [G] int32
    rq_len: torch.Tensor         # [G] int32

    # Optional subtrees of the JAX state; always None in the port until
    # ROADMAP item 8 lands (check_supported raises for their flags).
    trace: Any = None
    heat: Any = None
    qc: Any = None


def crash_restart(cfg: EngineConfig, s: RaftState) -> RaftState:
    """Volatile-state reset for a crash-restart of ONE node: durable state
    (term, ballot, log, config cache) survives, everything else returns to
    boot values, and the election timer re-arms from a fresh split of the
    node's key.  Mirrors ``rafting_tpu.core.types.crash_restart``."""
    check_supported(cfg)
    G, P, K = cfg.n_groups, cfg.n_peers, cfg.read_slots
    dev = s.term.device
    keys = prng.split(s.rng)
    rng, k = keys[..., 0, :], keys[..., 1, :]
    deadline = s.now + prng.randint(k, G, cfg.election_ticks,
                                    2 * cfg.election_ticks)
    z = lambda *sh: _z(sh, dev)
    f = lambda *sh: _z(sh, dev, BOOL)
    boot_next = (s.log.last[:, None] + 1).expand(G, P).clone()
    return s.replace(
        rng=rng,
        role=z(G),
        leader_id=torch.full((G,), NIL, dtype=I32, device=dev),
        commit=s.log.base.clone(),
        applied=z(G),
        own_from=z(G),
        next_idx=boot_next,
        match_idx=z(G, P),
        send_next=boot_next.clone(),
        inflight=z(G, P),
        hb_inflight=z(G, P),
        sent_at=z(G, P),
        need_snap=f(G, P),
        ok_at=z(G, P),
        fail_at=z(G, P),
        fail_streak=z(G, P),
        votes=f(G, P),
        prevotes=f(G, P),
        elect_deadline=deadline,
        hb_due=z(G),
        read_evid=z(G, P),
        rq_idx=z(G, K), rq_stamp=z(G, K), rq_n=z(G, K),
        rq_head=z(G), rq_len=z(G),
        xfer_to=torch.full((G,), NIL, dtype=I32, device=dev),
        xfer_dl=z(G),
    )


@dataclasses.dataclass
class Messages(_Tree):
    """One tick's worth of RPC traffic, dense over (peer, group).

    Axis 0 is the *sender* for an inbox and the *destination* for an
    outbox (after the node axis, when batched).  Same fields as the JAX
    class."""

    ae_valid: torch.Tensor      # [P, G] bool
    ae_term: torch.Tensor       # [P, G] int32
    ae_prev_idx: torch.Tensor   # [P, G] int32
    ae_prev_term: torch.Tensor  # [P, G] int32
    ae_commit: torch.Tensor     # [P, G] int32
    ae_n: torch.Tensor          # [P, G] int32
    ae_ents: torch.Tensor       # [P, G, B] int32
    ae_occ: torch.Tensor        # [P, G] bool
    ae_cents: torch.Tensor      # [P, G, B] int32
    ae_tick: torch.Tensor       # [P, G] int32

    aer_valid: torch.Tensor     # [P, G] bool
    aer_term: torch.Tensor      # [P, G] int32
    aer_success: torch.Tensor   # [P, G] bool
    aer_match: torch.Tensor     # [P, G] int32
    aer_empty: torch.Tensor     # [P, G] bool
    aer_occ: torch.Tensor       # [P, G] bool
    aer_tick: torch.Tensor      # [P, G] int32

    rv_valid: torch.Tensor      # [P, G] bool
    rv_term: torch.Tensor       # [P, G] int32
    rv_last_idx: torch.Tensor   # [P, G] int32
    rv_last_term: torch.Tensor  # [P, G] int32
    rv_prevote: torch.Tensor    # [P, G] bool

    rvr_valid: torch.Tensor     # [P, G] bool
    rvr_term: torch.Tensor      # [P, G] int32
    rvr_granted: torch.Tensor   # [P, G] bool
    rvr_prevote: torch.Tensor   # [P, G] bool
    rvr_echo: torch.Tensor      # [P, G] int32

    is_valid: torch.Tensor      # [P, G] bool
    is_term: torch.Tensor       # [P, G] int32
    is_idx: torch.Tensor        # [P, G] int32
    is_last_term: torch.Tensor  # [P, G] int32
    is_probe: torch.Tensor      # [P, G] bool
    is_conf: torch.Tensor       # [P, G] int32
    isr_valid: torch.Tensor     # [P, G] bool
    isr_term: torch.Tensor      # [P, G] int32
    isr_success: torch.Tensor   # [P, G] bool
    isr_probe: torch.Tensor     # [P, G] bool

    tn_valid: torch.Tensor      # [P, G] bool
    tn_term: torch.Tensor       # [P, G] int32

    @classmethod
    def empty(cls, cfg: EngineConfig, device=None,
              lead: tuple = ()) -> "Messages":
        """All-quiet traffic; ``lead`` prepends batch axes (a cluster's
        in-flight messages are ``lead=(N,)``)."""
        dev = resolve_device(device)
        P, G, B = cfg.n_peers, cfg.n_groups, cfg.batch
        out = {}
        for f in dataclasses.fields(cls):
            shape = lead + ((P, G, B) if f.name in ("ae_ents", "ae_cents")
                            else (P, G))
            is_bool = f.name.endswith(("_valid", "_occ", "_success",
                                       "_prevote", "_granted", "_empty",
                                       "_probe"))
            out[f.name] = _z(shape, dev, BOOL if is_bool else I32)
        return cls(**out)


@dataclasses.dataclass
class HostInbox(_Tree):
    """Host -> device inputs for one tick (beyond peer RPC traffic)."""

    submit_n: torch.Tensor       # [G] int32
    snap_done: torch.Tensor      # [G] bool
    snap_idx: torch.Tensor       # [G] int32
    snap_term: torch.Tensor      # [G] int32
    compact_to: torch.Tensor     # [G] int32
    conf_voters: torch.Tensor    # [G] int32 (0 = no request)
    conf_learners: torch.Tensor  # [G] int32
    xfer_target: torch.Tensor    # [G] int32 (NIL = none)
    snap_conf: torch.Tensor      # [G] int32
    read_n: torch.Tensor         # [G] int32
    read_veto: torch.Tensor      # scalar bool
    durable_tail: Optional[torch.Tensor] = None   # [G] int32, or None

    @classmethod
    def empty(cls, cfg: EngineConfig, device=None,
              lead: tuple = ()) -> "HostInbox":
        dev = resolve_device(device)
        G = cfg.n_groups
        z = lambda: _z(lead + (G,), dev)
        return cls(
            submit_n=z(), snap_done=_z(lead + (G,), dev, BOOL),
            snap_idx=z(), snap_term=z(), compact_to=z(),
            conf_voters=z(), conf_learners=z(),
            xfer_target=torch.full(lead + (G,), NIL, dtype=I32, device=dev),
            snap_conf=z(), read_n=z(),
            read_veto=_z(lead, dev, BOOL),
            durable_tail=None,
        )


_INFO_BOOL = ("dirty", "ready", "snap_req", "read_lease", "read_abort",
              "conf_pending", "xfer_fired", "xfer_abort")


@dataclasses.dataclass
class StepInfo(_Tree):
    """Device -> host outputs for one tick (beyond peer RPC traffic)."""

    submit_start: torch.Tensor   # [G] int32
    submit_acc: torch.Tensor     # [G] int32
    dirty: torch.Tensor          # [G] bool
    appended_from: torch.Tensor  # [G] int32
    appended_to: torch.Tensor    # [G] int32
    log_tail: torch.Tensor       # [G] int32
    commit: torch.Tensor         # [G] int32
    leader: torch.Tensor         # [G] int32
    ready: torch.Tensor          # [G] bool
    snap_req: torch.Tensor       # [G] bool
    snap_req_from: torch.Tensor  # [G] int32
    snap_req_idx: torch.Tensor   # [G] int32
    snap_req_term: torch.Tensor  # [G] int32
    snap_req_conf: torch.Tensor  # [G] int32
    noop_idx: torch.Tensor       # [G] int32
    noop_term: torch.Tensor      # [G] int32
    read_acc: torch.Tensor       # [G] int32
    read_index: torch.Tensor     # [G] int32
    read_rel: torch.Tensor       # [G] int32
    read_served: torch.Tensor    # [G] int32
    read_lease: torch.Tensor     # [G] bool
    read_abort: torch.Tensor     # [G] bool
    conf_app_idx: torch.Tensor   # [G] int32
    conf_app_term: torch.Tensor  # [G] int32
    conf_app_word: torch.Tensor  # [G] int32
    conf_word: torch.Tensor      # [G] int32
    conf_idx: torch.Tensor       # [G] int32
    conf_pending: torch.Tensor   # [G] bool
    xfer_fired: torch.Tensor     # [G] bool
    xfer_abort: torch.Tensor     # [G] bool
    debug_viol: torch.Tensor     # [G] int32 (zeros: debug checks not ported)
    cq_stepdown: Any = None      # CheckQuorum outputs: None until item 8
    cq_veto: Any = None

    @classmethod
    def empty(cls, cfg: EngineConfig, device=None,
              lead: tuple = ()) -> "StepInfo":
        dev = resolve_device(device)
        shape = lead + (cfg.n_groups,)
        out = {}
        for f in dataclasses.fields(cls):
            if f.name in ("cq_stepdown", "cq_veto"):
                continue
            out[f.name] = _z(shape, dev, BOOL if f.name in _INFO_BOOL
                             else I32)
        out["leader"] = torch.full(shape, NIL, dtype=I32, device=dev)
        return cls(**out)


def boot_conf_word(cfg: EngineConfig, n_voters: int | None = None) -> int:
    """The boot configuration word: the first ``n_voters`` slots (default
    all P) are voters, no joint set, no learners."""
    nv = cfg.n_peers if n_voters is None else n_voters
    assert 1 <= nv <= cfg.n_peers
    return int(conf_pack((1 << nv) - 1))


def init_state(cfg: EngineConfig, node_id: int, seed: int = 0,
               n_active: int | None = None, n_voters: int | None = None,
               device=None) -> RaftState:
    """Fresh boot state of one node: every group a follower at term 0 with
    an empty log, election deadlines staggered by the node's seeded key
    (the same draw as the JAX engine, bit for bit)."""
    check_supported(cfg)
    dev = resolve_device(device)
    G, P, K, L = cfg.n_groups, cfg.n_peers, cfg.read_slots, cfg.log_slots
    key = prng.prng_key(seed * 7919 + node_id, device=dev)
    keys = prng.split(key)
    key, sub = keys[0], keys[1]
    first_deadline = prng.randint(sub, G, cfg.election_ticks,
                                  2 * cfg.election_ticks)
    n_act = G if n_active is None else n_active
    active = torch.arange(G, device=dev) < n_act
    z = lambda *s: _z(s, dev)
    word = boot_conf_word(cfg, n_voters)
    full = lambda v: torch.full((G,), v, dtype=I32, device=dev)
    return RaftState(
        node_id=torch.tensor(node_id, dtype=I32, device=dev),
        now=torch.tensor(0, dtype=I32, device=dev),
        rng=key,
        active=active,
        term=z(G), role=z(G), voted_for=full(NIL), leader_id=full(NIL),
        commit=z(G), applied=z(G),
        log=LogState(term=z(G, L), conf=z(G, L), base=z(G),
                     base_term=z(G), base_conf=full(word), last=z(G)),
        own_from=z(G),
        next_idx=torch.ones((G, P), dtype=I32, device=dev),
        match_idx=z(G, P),
        send_next=torch.ones((G, P), dtype=I32, device=dev),
        inflight=z(G, P), hb_inflight=z(G, P), sent_at=z(G, P),
        need_snap=_z((G, P), dev, BOOL),
        ok_at=z(G, P), fail_at=z(G, P), fail_streak=z(G, P),
        votes=_z((G, P), dev, BOOL), prevotes=_z((G, P), dev, BOOL),
        elect_deadline=first_deadline, hb_due=z(G),
        conf_idx=z(G), conf_word=full(word),
        xfer_to=full(NIL), xfer_dl=z(G),
        read_evid=z(G, P),
        rq_idx=z(G, K), rq_stamp=z(G, K), rq_n=z(G, K),
        rq_head=z(G), rq_len=z(G),
    )


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise across containers of the same structure
    (``fn(leaf, *other_leaves)``); ``None`` leaves stay ``None``."""
    if isinstance(tree, _Tree):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if tree is None:
        return None
    return fn(tree, *rest)


def stack_states(states) -> RaftState:
    """Stack per-node states along a new leading node axis."""
    return tree_map(lambda *xs: torch.stack(xs), *states)
