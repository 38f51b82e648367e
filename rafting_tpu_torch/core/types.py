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
from typing import Optional

import torch

from . import prng
from ..utils.tracelog import TR_CRASH_RESTART

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
    every CPU tick.  ``trace_depth``, ``heat`` and ``check_quorum`` each
    add an optional subtree to the state (``None`` when off, so a build
    with them off runs exactly the default step); ``debug_checks`` fills
    ``StepInfo.debug_viol``.
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
    debug_checks: bool = False    # in-step invariant checks (StepInfo.debug_viol)
    read_slots: int = 4           # K — pending ReadIndex batches per group
    read_lease: bool = True       # lease fast path (receipt-anchored evidence)
    read_fresh_ticks: int = 3     # lease evidence freshness bound
    trace_depth: int = 0          # D — flight-recorder depth (0 = off)
    quorum_fixed: bool = False    # BENCH-ONLY fixed-majority commit baseline
    heat: bool = False            # per-group heat lanes
    check_quorum: bool = False    # CheckQuorum step-down (phase 6c)

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
class TraceState(_Tree):
    """Per-group flight-recorder rings (``cfg.trace_depth`` slots per
    group): slot ``i % D`` holds event ``i``, ``n`` counts events ever
    written.  Observability state: no step phase reads it back."""

    tick: torch.Tensor   # [G, D] int32 — event tick stamp (node's own clock)
    kind: torch.Tensor   # [G, D] int32 — TR_* event kind
    term: torch.Tensor   # [G, D] int32 — group term at emission
    aux: torch.Tensor    # [G, D] int32 — per-kind payload
    n: torch.Tensor      # [G] int32 — events ever written (ring head = n % D)

    @classmethod
    def empty(cls, n_groups: int, depth: int, device=None) -> "TraceState":
        dev = resolve_device(device)
        z = lambda *sh: _z(sh, dev)
        return cls(tick=z(n_groups, depth), kind=z(n_groups, depth),
                   term=z(n_groups, depth), aux=z(n_groups, depth),
                   n=z(n_groups))


@dataclasses.dataclass
class HeatState(_Tree):
    """Per-group cumulative activity counters (``cfg.heat``).  They
    survive ``crash_restart``: activity history is not protocol state."""

    appended: torch.Tensor   # [G] int32 — entries appended to the log, ever
    sent: torch.Tensor       # [G] int32 — RPCs emitted (all 7 kinds), ever
    commits: torch.Tensor    # [G] int32 — commit-index advance, ever
    reads: torch.Tensor      # [G] int32 — linearizable reads served, ever

    @classmethod
    def empty(cls, n_groups: int, device=None) -> "HeatState":
        # One buffer per lane: an in-place update of one lane must never
        # show through another.
        dev = resolve_device(device)
        z = lambda: _z((n_groups,), dev)
        return cls(appended=z(), sent=z(), commits=z(), reads=z())


@dataclasses.dataclass
class QuorumContact(_Tree):
    """Per-group quorum-contact lanes (``cfg.check_quorum``), read back
    only by phase 6c and reset by ``crash_restart``."""

    heard: torch.Tensor   # [G, P] int32 — own-clock tick of last contact (0 never)
    since: torch.Tensor   # [G] int32 — contact-window anchor (0 = not leading yet)

    @classmethod
    def empty(cls, n_groups: int, n_peers: int, device=None
              ) -> "QuorumContact":
        dev = resolve_device(device)
        return cls(heard=_z((n_groups, n_peers), dev),
                   since=_z((n_groups,), dev))


def trace_append(tr: TraceState, mask: torch.Tensor, kind: int,
                 tick, term, aux) -> TraceState:
    """Masked append of one event kind across all groups (any leading
    axes: ``mask`` is [..., G]; ``tick``/``term``/``aux`` broadcast to
    it).  Lanes where ``mask`` is False write nowhere and keep their
    count.  Compare-and-select, not scatter, as in the JAX engine."""
    D = tr.tick.shape[-1]
    dev = tr.tick.device
    slot = torch.where(mask, torch.remainder(tr.n, D),
                       torch.full_like(tr.n, D))
    hit = slot.unsqueeze(-1) == torch.arange(D, dtype=I32, device=dev)

    def put(ring, v):
        # A Python int goes into the select as a scalar: no host copy.
        if isinstance(v, torch.Tensor):
            v = v.to(ring.dtype).expand(mask.shape).unsqueeze(-1)
        return torch.where(hit, v, ring)

    return tr.replace(tick=put(tr.tick, tick), kind=put(tr.kind, kind),
                      term=put(tr.term, term), aux=put(tr.aux, aux),
                      n=tr.n + mask.to(I32))


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

    # Optional subtrees, None when their flag is off (the step then runs
    # none of their code).
    trace: Optional[TraceState] = None   # cfg.trace_depth
    heat: Optional[HeatState] = None     # cfg.heat
    qc: Optional[QuorumContact] = None   # cfg.check_quorum


@dataclasses.dataclass
class FaultSchedule(_Tree):
    """A precomputed fault plan for a chaos run, indexed by tick along the
    leading axis (the semantics of ``rafting_tpu.core.types.FaultSchedule``):
    ``link_up[t, s, d]`` False drops messages in flight s->d; ``crash[t,
    n]`` crash-restarts node n before delivery; ``stall[t, n]`` freezes
    node n for the tick; ``dup[t, s, d]`` re-delivers this tick's s->d
    traffic next tick."""

    link_up: torch.Tensor  # [T, N, N] bool — conn[s, d] per tick (False = cut)
    crash: torch.Tensor    # [T, N] bool — crash-restart node n at tick t
    stall: torch.Tensor    # [T, N] bool — freeze node n for tick t
    dup: torch.Tensor      # [T, N, N] bool — duplicate deliveries on link s->d

    @property
    def n_ticks(self) -> int:
        return self.link_up.shape[0]

    @classmethod
    def healthy(cls, n_peers: int, n_ticks: int, device=None
                ) -> "FaultSchedule":
        """The no-fault schedule: all links up, nothing crashes."""
        dev = resolve_device(device)
        return cls(
            link_up=torch.ones((n_ticks, n_peers, n_peers), dtype=BOOL,
                               device=dev),
            crash=_z((n_ticks, n_peers), dev, BOOL),
            stall=_z((n_ticks, n_peers), dev, BOOL),
            dup=_z((n_ticks, n_peers, n_peers), dev, BOOL),
        )


def crash_restart(cfg: EngineConfig, s: RaftState, group_base: int = 0
                  ) -> RaftState:
    """Volatile-state reset for a crash-restart: durable state (term,
    ballot, log, config cache) survives, everything else returns to boot
    values, and the election timer re-arms from a fresh split of the
    node's key.  Mirrors ``rafting_tpu.core.types.crash_restart`` for one
    node, and batches over a leading node axis (``s.now`` [N]) as the
    JAX ``vmap`` does: each node's result is the one-node result.

    The flight recorder survives and records the restart, stamped with
    the pre-step clock; heat survives; quorum-contact lanes reset.
    ``group_base`` offsets the timer draw's counters for a shard of the
    group axis, as in ``node_step``."""
    G, P, K = cfg.n_groups, cfg.n_peers, cfg.read_slots
    lead = s.term.shape[:-1]
    dev = s.term.device
    keys = prng.split(s.rng)
    rng, k = keys[..., 0, :], keys[..., 1, :]
    now = s.now.unsqueeze(-1)                         # [..., 1]
    deadline = now + prng.randint(k, G, cfg.election_ticks,
                                  2 * cfg.election_ticks, group_base)
    z = lambda *sh: _z(lead + sh, dev)
    f = lambda *sh: _z(lead + sh, dev, BOOL)
    nil = lambda: torch.full(lead + (G,), NIL, dtype=I32, device=dev)
    boot_next = (s.log.last.unsqueeze(-1) + 1).expand(lead + (G, P)).clone()
    trace = s.trace
    if trace is not None:
        trace = trace_append(trace, s.active, TR_CRASH_RESTART, now,
                             s.term, s.log.last)
    qc = s.qc
    if qc is not None:
        qc = qc.replace(heard=torch.zeros_like(qc.heard),
                        since=torch.zeros_like(qc.since))
    return s.replace(
        trace=trace,
        qc=qc,
        rng=rng,
        role=z(G),
        leader_id=nil(),
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
        xfer_to=nil(),
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
    debug_viol: torch.Tensor     # [G] int32 — invariant violation code
                                 #   (0 = ok; step.DEBUG_CODES), zeros
                                 #   unless cfg.debug_checks
    # CheckQuorum outputs, None unless cfg.check_quorum: [G] bool
    # step-down this tick, and [G] int32 pending reads it vetoed.
    cq_stepdown: Optional[torch.Tensor] = None
    cq_veto: Optional[torch.Tensor] = None

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
        if cfg.check_quorum:
            out["cq_stepdown"] = _z(shape, dev, BOOL)
            out["cq_veto"] = _z(shape, dev)
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
    (the same draw as the JAX engine, bit for bit).  The optional
    subtrees are built per flag, None when off."""
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
        trace=(TraceState.empty(G, cfg.trace_depth, dev)
               if cfg.trace_depth else None),
        heat=HeatState.empty(G, dev) if cfg.heat else None,
        qc=QuorumContact.empty(G, P, dev) if cfg.check_quorum else None,
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
