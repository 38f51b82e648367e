"""The batched Multi-Raft step: every group of every node, one tick.

The counterpart of ``rafting_tpu/core/step.py`` ``node_step`` (phases
0-10), with its optional blocks: CheckQuorum (phase 6c,
``cfg.check_quorum``), the flight recorder (``cfg.trace_depth``), heat
lanes (``cfg.heat``) and the invariant checks (``cfg.debug_checks``).
Each is a Python branch on the config: with its flag off its subtree is
``None`` and none of its code runs.

Where the JAX engine ``vmap``s ``node_step`` over the node axis, this step
is written with the node axis explicit: every ``[G]`` lane is ``[N, G]``,
every ``[G, P]`` lane ``[N, G, P]``, every ``[P, G]`` message plane
``[N, P, G]``, ``me`` and ``now`` are ``[N]``.  One call steps the whole
cluster; a single node is ``N = 1``.

The step makes no host synchronisation — no ``.item()``, no ``nonzero``,
no boolean-mask indexing, no Python branch on tensor values — so a tick
loop can later be captured as a CUDA graph.  Phase 10's quorum commit runs
in the CUDA kernel on CUDA tensors (``ops/quorum.py``).

Translation notes (each is a place where a literal port would drift):

* ``argmax`` over bool (``_pick_peer``): torch refuses bool input, so the
  first set peer is ``where(flag, arange(P), P).amin()``, mapped to 0 when
  no flag is set — exactly ``jnp.argmax``'s answer on both devices.
* ``.at[].set(mode="drop")``: slot ``L`` (or ``K``) means "dropped".
  Torch scatters raise on an out-of-range index, so the write goes into a
  copy padded by one column, which is then sliced off.  Within a row the
  reference only writes distinct slots, so scatter order cannot matter.
* Gathers use ``torch.gather`` with int64 indices; every index stays in
  range through the reference's own ``remainder``/``clip`` expressions.
* Sums over bool and int32 promote to int64 in torch; every lane the
  reference keeps int32 is cast back.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from . import prng
from .types import (
    CANDIDATE, FOLLOWER, I32, LEADER, NIL, PRE_CANDIDATE,
    EngineConfig, HostInbox, LogState, Messages, RaftState, StepInfo,
    conf_learners_of, conf_new_of, conf_pack, conf_voters_of,
)
from ..ops.quorum import contact_quorum, quorum_commit, read_barrier_release
from ..utils.tracelog import (
    TR_BECAME_CANDIDATE, TR_BECAME_LEADER, TR_BECAME_PRE_CANDIDATE,
    TR_COMMIT_ADVANCE, TR_CONF_CHANGE_COMMIT, TR_CONF_CHANGE_ENTER,
    TR_CRASH_RESTART, TR_LEADER_TRANSFER, TR_READ_RELEASE,
    TR_SNAPSHOT_INSTALL, TR_STEPPED_DOWN, TR_TERM_BUMP,
)

Tensor = torch.Tensor

# StepInfo.debug_viol codes (cfg.debug_checks; the check block at the end
# of node_step).
DEBUG_CODES = {
    1: "live log window exceeds ring capacity",
    2: "commit passed the log end",
    3: "term regressed",
    4: "continuing leader's matchIndex moved backwards",
    5: "candidate ballot is not itself",
    6: "commit regressed",
    7: "pipeline head behind ack base",
    8: "read FIFO length out of range",
    9: "active config has no voters",
}

# Flight-recorder kinds in canonical intra-tick emission order.
_TRACE_KINDS = (
    TR_TERM_BUMP, TR_STEPPED_DOWN, TR_BECAME_PRE_CANDIDATE,
    TR_BECAME_CANDIDATE, TR_BECAME_LEADER, TR_SNAPSHOT_INSTALL,
    TR_COMMIT_ADVANCE, TR_READ_RELEASE, TR_CONF_CHANGE_ENTER,
    TR_CONF_CHANGE_COMMIT, TR_LEADER_TRANSFER,
)
# Every kind but TR_CRASH_RESTART (written by crash_restart), in order.
assert _TRACE_KINDS == tuple(k for k in range(1, len(_TRACE_KINDS) + 2)
                             if k != TR_CRASH_RESTART)


def raise_debug_violations(info: StepInfo, where: str = "") -> None:
    """Host-side consumer of ``StepInfo.debug_viol`` (a tensor, or a host
    array once fetched): raise naming the first violating lane and its
    invariant (one host read)."""
    viol = info.debug_viol
    viol = viol.detach().cpu().numpy() if isinstance(viol, Tensor) \
        else np.asarray(viol)
    bad = np.nonzero(viol)
    if len(bad[0]):
        first = tuple(int(b[0]) for b in bad)
        code = int(viol[first])
        raise AssertionError(
            f"kernel invariant violated{' in ' + where if where else ''}: "
            f"lane {first} code {code} "
            f"({DEBUG_CODES.get(code, 'unknown')}); "
            f"{len(bad[0])} lane(s) total")


# ---------------------------------------------------------------------------
# Log-ring primitives (any leading axes; the group axis is second to last
# of the [..., G, L] ring).
# ---------------------------------------------------------------------------

def ring_term_at(log: LogState, idx: Tensor) -> Tensor:
    """Term of entry ``idx`` per group ([..., G] -> [..., G]): base_term at
    or below the floor, -1 beyond ``last``."""
    L = log.term.shape[-1]
    slot = torch.remainder(idx, L).long().unsqueeze(-1)
    t = torch.gather(log.term, -1, slot).squeeze(-1)
    return torch.where(idx <= log.base, log.base_term,
                       torch.where(idx <= log.last, t,
                                   torch.full_like(t, -1)))


def ring_terms_batch(log: LogState, idx: Tensor) -> Tensor:
    """Terms for a [..., G, K] index matrix (absent -> -1)."""
    L = log.term.shape[-1]
    t = torch.gather(log.term, -1, torch.remainder(idx, L).long())
    return torch.where(idx <= log.base.unsqueeze(-1),
                       log.base_term.unsqueeze(-1),
                       torch.where(idx <= log.last.unsqueeze(-1), t,
                                   torch.full_like(t, -1)))


def ring_write_batch(log_term: Tensor, idx: Tensor, vals: Tensor,
                     mask: Tensor) -> Tensor:
    """Masked scatter of values at [..., G, K] indices into the [..., G, L]
    ring.  Masked-off writes land in a pad column that is dropped."""
    L = log_term.shape[-1]
    slot = torch.where(mask, torch.remainder(idx, L),
                       torch.full_like(idx, L)).long()
    pad = torch.zeros(log_term.shape[:-1] + (1,), dtype=log_term.dtype,
                      device=log_term.device)
    out = torch.cat([log_term, pad], dim=-1)
    out.scatter_(-1, slot, vals.expand(idx.shape).to(log_term.dtype))
    return out[..., :L]


def ring_conf_batch(log: LogState, idx: Tensor) -> Tensor:
    """Packed config words for a [..., G, K] index matrix (0 outside the
    live window)."""
    L = log.conf.shape[-1]
    w = torch.gather(log.conf, -1, torch.remainder(idx, L).long())
    live = (idx > log.base.unsqueeze(-1)) & (idx <= log.last.unsqueeze(-1))
    return torch.where(live, w, torch.zeros_like(w))


def _conf_sweep(log: LogState, upto=None):
    """Index of the latest config entry in (base, min(upto, last)] per
    group (0 = none), over one [..., G, L] sweep of the conf ring."""
    L = log.conf.shape[-1]
    j = torch.arange(L, dtype=I32, device=log.conf.device)
    last = log.last.unsqueeze(-1)
    idx = last - torch.remainder(last - j, L)
    isc = (idx > log.base.unsqueeze(-1)) & (log.conf != 0)
    if upto is not None:
        isc = isc & (idx <= upto.unsqueeze(-1))
    return torch.where(isc, idx, torch.zeros_like(idx)).amax(dim=-1), idx, isc


def _conf_at(log: LogState, cidx: Tensor) -> Tensor:
    L = log.conf.shape[-1]
    return torch.gather(log.conf, -1,
                        torch.remainder(cidx, L).long().unsqueeze(-1)
                        ).squeeze(-1)


def latest_conf(log: LogState, upto: Tensor) -> Tuple[Tensor, Tensor]:
    """The active configuration per group: ``(conf_idx, conf_word)`` of the
    latest config entry in ``(base, min(upto, last)]``, falling back to
    ``(0, base_conf)`` when none is live."""
    cidx, _, _ = _conf_sweep(log, upto)
    w = _conf_at(log, cidx)
    has = cidx > 0
    return (torch.where(has, cidx, torch.zeros_like(cidx)),
            torch.where(has, w, log.base_conf))


def mask_bits(mask: Tensor, P: int) -> Tensor:
    """Expand [...] peer bitmasks into a [..., P] boolean matrix."""
    p = torch.arange(P, dtype=I32, device=mask.device)
    return ((mask.unsqueeze(-1) >> p) & 1) > 0


def dual_quorum(flags: Tensor, voters: Tensor, voters_new: Tensor) -> Tensor:
    """Do ``flags`` [..., P] cover a majority of ``voters`` — and, when
    joint, of ``voters_new`` too?"""
    P = flags.shape[-1]
    vb = mask_bits(voters, P)
    nb = mask_bits(voters_new, P)
    ok_v = (flags & vb).sum(dim=-1) >= vb.sum(dim=-1) // 2 + 1
    ok_n = (flags & nb).sum(dim=-1) >= nb.sum(dim=-1) // 2 + 1
    return ok_v & ((voters_new == 0) | ok_n)


def _pick_peer(flag_pg: Tensor) -> Tuple[Tensor, Tensor]:
    """The lowest-indexed peer whose flag is set, per group, over the peer
    axis (second to last of [..., P, G]).  Returns ``(peer, any_flag)``;
    ``peer`` is 0 where no flag is set, as ``jnp.argmax`` gives."""
    P = flag_pg.shape[-2]
    ids = torch.arange(P, dtype=I32, device=flag_pg.device).unsqueeze(-1)
    first = torch.where(flag_pg, ids, torch.full_like(ids, P)).amin(dim=-2)
    return torch.where(first == P, torch.zeros_like(first), first), \
        flag_pg.any(dim=-2)


def _gather_peer(field_pg: Tensor, peer: Tensor) -> Tensor:
    """field [..., P, G] or [..., P, G, B], peer [..., G] -> the selected
    peer's [..., G] / [..., G, B] values."""
    if field_pg.ndim == peer.ndim + 1:
        return torch.gather(field_pg, -2,
                            peer.long().unsqueeze(-2)).squeeze(-2)
    idx = peer.long().unsqueeze(-2).unsqueeze(-1).expand(
        peer.shape[:-1] + (1,) + peer.shape[-1:] + field_pg.shape[-1:])
    return torch.gather(field_pg, -3, idx).squeeze(-3)


def _t(a: Tensor) -> Tensor:
    """[N, P, G] <-> [N, G, P] (the reference's per-node ``.T``)."""
    return a.transpose(-1, -2)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def node_step(cfg: EngineConfig, state: RaftState, inbox: Messages,
              host: HostInbox, group_base: int = 0
              ) -> Tuple[RaftState, Messages, StepInfo]:
    """Advance every group of every node by one tick (batched over the
    leading node axis of ``state``/``inbox``/``host``).

    ``group_base`` is the global index of the first group held here (a
    shard of the group axis, ``cfg.n_groups`` wide): the election-timeout
    draw takes counters ``group_base ..``, so each group draws the bits
    it draws in the whole cluster's step."""
    G, P, B, L, S, K = (cfg.n_groups, cfg.n_peers, cfg.batch,
                        cfg.log_slots, cfg.max_submit, cfg.read_slots)
    s = state
    N = s.term.shape[0]
    dev = s.term.device
    now = s.now + 1                                   # [N]
    nowG = now.unsqueeze(-1)                          # [N, 1]
    now3 = nowG.unsqueeze(-1)                         # [N, 1, 1]
    keys = prng.split(s.rng)
    rng, k_to = keys[:, 0], keys[:, 1]
    rand_to = prng.randint(k_to, G, cfg.election_ticks,
                           2 * cfg.election_ticks, group_base)  # [N, G]

    me = s.node_id                                    # [N]
    meG = me.unsqueeze(-1)
    peer_ids = torch.arange(P, dtype=I32, device=dev)
    pid_col = peer_ids.view(1, P, 1)                  # over [N, P, G]
    self_hot = (peer_ids == meG).unsqueeze(1)         # [N, 1, P]
    not_me_col = (peer_ids != meG).unsqueeze(-1)      # [N, P, 1]
    zG = torch.zeros((N, G), dtype=I32, device=dev)

    def bc(v):                                        # [N, G] -> [N, P, G]
        return v.unsqueeze(1).expand(N, P, G)

    def g(v):                                         # [N, G] -> [N, 1, G]
        return v.unsqueeze(1)

    active = s.active
    term, role, voted = s.term, s.role, s.voted_for
    leader_id, commit = s.leader_id, s.commit
    log = s.log
    next_idx, match_idx = s.next_idx, s.match_idx
    own_from = s.own_from
    send_next, inflight = s.send_next, s.inflight
    hb_inflight = s.hb_inflight
    sent_at, need_snap = s.sent_at, s.need_snap
    ok_at, fail_at, fail_streak = s.ok_at, s.fail_at, s.fail_streak
    votes, prevotes = s.votes, s.prevotes
    elect_dl, hb_due = s.elect_deadline, s.hb_due

    old_term, old_voted, old_last = term, voted, log.last

    # ---- 0. membership view C0 (tick-start, the state's cache) ------------
    cidx0, w0 = s.conf_idx, s.conf_word
    voters0 = conf_voters_of(w0)
    vnew0 = conf_new_of(w0)

    # ---- 1. term sync: adopt the highest real term seen this tick ---------
    def masked(valid, t):
        return torch.where(valid, t, torch.full_like(t, -1))
    mt = functools.reduce(torch.maximum, [
        masked(inbox.ae_valid, inbox.ae_term),
        masked(inbox.aer_valid, inbox.aer_term),
        masked(inbox.rv_valid & ~inbox.rv_prevote, inbox.rv_term),
        masked(inbox.rvr_valid, inbox.rvr_term),
        masked(inbox.is_valid, inbox.is_term),
        masked(inbox.isr_valid, inbox.isr_term),
        masked(inbox.tn_valid, inbox.tn_term),
    ]).amax(dim=1)                                            # [N, G]
    stepdown = active & (mt > term)
    term = torch.where(stepdown, mt, term)
    role = torch.where(stepdown, FOLLOWER, role)
    voted = torch.where(stepdown, NIL, voted)
    leader_id = torch.where(stepdown, NIL, leader_id)
    elect_dl = torch.where(stepdown, nowG + rand_to, elect_dl)

    last_term_v = ring_term_at(log, log.last)

    # ---- 2. vote requests --------------------------------------------------
    rv_v = inbox.rv_valid & g(active) & not_me_col            # [N, P, G]
    pv = inbox.rv_prevote
    utd = ((inbox.rv_last_term > g(last_term_v)) |
           ((inbox.rv_last_term == g(last_term_v)) &
            (inbox.rv_last_idx >= g(log.last))))
    elig_rv = (rv_v & ~pv & (inbox.rv_term == g(term)) & utd &
               ((g(voted) == NIL) | (g(voted) == pid_col)))
    first_elig, _ = _pick_peer(elig_rv)
    grant_rv = elig_rv & ((g(voted) == pid_col) |
                          (pid_col == g(first_elig)))
    granted_any = (grant_rv & (g(voted) == NIL)).any(dim=1)
    voted = torch.where(granted_any & (voted == NIL), first_elig, voted)
    elect_dl = torch.where(grant_rv.any(dim=1), nowG + rand_to, elect_dl)
    lease_open = (nowG >= elect_dl) | (leader_id == NIL)
    grant_pv = (rv_v & pv & (inbox.rv_term > g(term)) & utd &
                g(lease_open))
    out_rvr_valid = rv_v
    out_rvr_term = bc(term)
    out_rvr_granted = torch.where(pv, grant_pv, grant_rv)
    out_rvr_prevote = pv
    out_rvr_echo = inbox.rv_term

    # ---- 3. vote responses + tallies --------------------------------------
    rr = inbox.rvr_valid & g(active)
    g_pv = (rr & inbox.rvr_prevote & inbox.rvr_granted &
            g(role == PRE_CANDIDATE) & (inbox.rvr_echo == g(term + 1)))
    prevotes = prevotes | _t(g_pv)
    g_rv = (rr & ~inbox.rvr_prevote & inbox.rvr_granted &
            g(role == CANDIDATE) & (inbox.rvr_term == g(term)))
    votes = votes | _t(g_rv)

    vb0 = mask_bits(voters0, P)
    nb0 = mask_bits(vnew0, P)
    maj_v0 = vb0.sum(dim=-1) // 2 + 1
    maj_n0 = nb0.sum(dim=-1) // 2 + 1
    not_joint0 = vnew0 == 0

    def tally0(flags):
        return ((flags & vb0).sum(dim=-1) >= maj_v0) \
            & (not_joint0 | ((flags & nb0).sum(dim=-1) >= maj_n0))

    pv_win = (role == PRE_CANDIDATE) & tally0(prevotes)
    term = torch.where(pv_win, term + 1, term)
    role = torch.where(pv_win, CANDIDATE, role)
    voted = torch.where(pv_win, meG, voted)
    leader_id = torch.where(pv_win, NIL, leader_id)
    votes = torch.where(pv_win.unsqueeze(-1), self_hot, votes)
    elect_dl = torch.where(pv_win, nowG + rand_to, elect_dl)

    vote_win = (role == CANDIDATE) & tally0(votes)
    vw = vote_win.unsqueeze(-1)
    role = torch.where(vote_win, LEADER, role)
    leader_id = torch.where(vote_win, meG, leader_id)
    next_idx = torch.where(vw, (log.last + 1).unsqueeze(-1), next_idx)
    match_idx = torch.where(vw, 0, match_idx)
    send_next = torch.where(vw, (log.last + 1).unsqueeze(-1), send_next)
    inflight = torch.where(vw, 0, inflight)
    hb_inflight = torch.where(vw, 0, hb_inflight)
    need_snap = torch.where(vw, False, need_snap)
    ok_at = torch.where(vw, 0, ok_at)
    fail_at = torch.where(vw, 0, fail_at)
    fail_streak = torch.where(vw, 0, fail_streak)
    hb_due = torch.where(vote_win, nowG, hb_due)
    own_from = torch.where(vote_win, log.last + 1, own_from)
    # Raft §8: a fresh leader appends an own-term no-op (ring permitting).
    noop_ok = vote_win & (log.last - log.base < L)
    noop_idx = torch.where(noop_ok, log.last + 1, zG)
    noop_term = torch.where(noop_ok, term, zG)
    nidx1 = (log.last + 1).unsqueeze(-1)
    log = log.replace(
        term=ring_write_batch(log.term, nidx1, term.unsqueeze(-1),
                              noop_ok.unsqueeze(-1)),
        conf=ring_write_batch(log.conf, nidx1, torch.zeros_like(nidx1),
                              noop_ok.unsqueeze(-1)),
        last=log.last + noop_ok.to(I32))

    # ---- 4. AppendEntries requests ----------------------------------------
    ae_v = inbox.ae_valid & g(active) & not_me_col
    ae_t_ok = ae_v & (inbox.ae_term == g(term))
    ae_peer, ae_any = _pick_peer(ae_t_ok)
    ae_any = ae_any & (role != LEADER)
    role = torch.where(ae_any, FOLLOWER, role)
    leader_id = torch.where(ae_any, ae_peer, leader_id)
    elect_dl = torch.where(ae_any, nowG + rand_to, elect_dl)

    prev_i = _gather_peer(inbox.ae_prev_idx, ae_peer)
    prev_t = _gather_peer(inbox.ae_prev_term, ae_peer)
    n_e = _gather_peer(inbox.ae_n, ae_peer)
    lc = _gather_peer(inbox.ae_commit, ae_peer)
    ents = _gather_peer(inbox.ae_ents, ae_peer)                   # [N, G, B]
    cents = _gather_peer(inbox.ae_cents, ae_peer)
    # Bounded-window partial accept (jnp.clip(n_e, 0, hi)).
    n_e = torch.minimum(torch.clamp(n_e, min=0),
                        torch.clamp(log.base + L - prev_i, min=0))
    prev_match = ((prev_i <= log.base) |
                  ((prev_i <= log.last) &
                   (ring_term_at(log, prev_i) == prev_t)))
    acc = ae_any & prev_match

    col = torch.arange(B, dtype=I32, device=dev)
    idxs = prev_i.unsqueeze(-1) + 1 + col                         # [N, G, B]
    in_n = col < n_e.unsqueeze(-1)
    exists = (idxs <= log.last.unsqueeze(-1)) & \
        (idxs > log.base.unsqueeze(-1))
    cur = ring_terms_batch(log, idxs)
    conflict = (acc.unsqueeze(-1) & in_n & exists & (cur != ents)).any(-1)
    wmask = acc.unsqueeze(-1) & in_n & (idxs > log.base.unsqueeze(-1))
    new_ring = ring_write_batch(log.term, idxs, ents, wmask)
    new_cring = ring_write_batch(log.conf, idxs, cents, wmask)
    tail = prev_i + n_e
    new_last = torch.where(acc,
                           torch.where(conflict, tail,
                                       torch.maximum(log.last, tail)),
                           log.last)
    wrote = acc & (n_e > 0) & ((new_last != log.last) | conflict)
    app_from = torch.where(wrote, prev_i + 1, zG)
    app_to = torch.where(wrote, new_last, zG)
    log = log.replace(term=new_ring, conf=new_cring, last=new_last)
    commit = torch.where(acc,
                         torch.maximum(commit, torch.minimum(lc, tail)),
                         commit)
    is_sel = (pid_col == g(ae_peer)) & ae_t_ok
    out_aer_valid = ae_v
    out_aer_term = bc(term)
    out_aer_success = is_sel & g(acc)
    out_aer_match = torch.where(
        is_sel & g(acc), g(tail),
        torch.minimum(g(log.last), inbox.ae_prev_idx - 1))
    out_aer_empty = ae_v & (inbox.ae_n == 0)
    out_aer_occ = ae_v & inbox.ae_occ
    out_aer_tick = torch.where(ae_v, inbox.ae_tick,
                               torch.zeros_like(inbox.ae_tick))

    # ---- 5. InstallSnapshot ------------------------------------------------
    is_v = inbox.is_valid & g(active) & not_me_col
    is_t_ok = is_v & (inbox.is_term == g(term))
    is_peer, is_any = _pick_peer(is_t_ok)
    is_any = is_any & (role != LEADER)
    role = torch.where(is_any, FOLLOWER, role)
    leader_id = torch.where(is_any, is_peer, leader_id)
    elect_dl = torch.where(is_any, nowG + rand_to, elect_dl)
    off_idx = _gather_peer(inbox.is_idx, is_peer)
    off_term = _gather_peer(inbox.is_last_term, is_peer)
    off_conf = _gather_peer(inbox.is_conf, is_peer)
    covered = ((off_idx <= log.base) |
               ((off_idx <= log.last) &
                (ring_term_at(log, off_idx) == off_term)))
    useful = is_any & ~covered
    snap_req = useful
    snap_from = torch.where(useful, is_peer, zG)
    snap_idx_o = torch.where(useful, off_idx, zG)
    snap_term_o = torch.where(useful, off_term, zG)
    snap_conf_o = torch.where(useful, off_conf, zG)
    is_sel_snap = (pid_col == g(is_peer)) & is_t_ok
    out_isr_valid = is_v
    out_isr_term = bc(term)
    out_isr_success = is_sel_snap & g(covered)
    out_isr_probe = is_v & inbox.is_probe

    # Host finished installing a snapshot: adopt the milestone as the floor.
    sd = host.snap_done & active & (host.snap_idx > log.base)
    tail_matches = ((host.snap_idx <= log.last) &
                    (ring_term_at(log, host.snap_idx) == host.snap_term))
    log = log.replace(
        base=torch.where(sd, host.snap_idx, log.base),
        base_term=torch.where(sd, host.snap_term, log.base_term),
        base_conf=torch.where(sd & (host.snap_conf != 0), host.snap_conf,
                              log.base_conf),
        last=torch.where(sd, torch.where(tail_matches, log.last,
                                         host.snap_idx), log.last),
    )
    commit = torch.where(sd, torch.maximum(commit, host.snap_idx), commit)

    # Compaction grant from the host, never past commit; the milestone's
    # term and config are read before the floor moves.  One conf sweep
    # serves the milestone config and the post-compaction view C1.
    ct = torch.minimum(host.compact_to, commit)
    do_c = active & (ct > log.base)
    ct_term = ring_term_at(log, ct)
    cidx_all, sw_idx, sw_isc = _conf_sweep(log)
    w_all = _conf_at(log, cidx_all)
    cidx_ct = torch.where(sw_isc & (sw_idx <= ct.unsqueeze(-1)), sw_idx,
                          torch.zeros_like(sw_idx)).amax(dim=-1)
    w_ct = _conf_at(log, cidx_ct)
    ct_conf = torch.where(cidx_ct > 0, w_ct, log.base_conf)
    log = log.replace(base=torch.where(do_c, ct, log.base),
                      base_term=torch.where(do_c, ct_term, log.base_term),
                      base_conf=torch.where(do_c, ct_conf, log.base_conf))
    live1 = cidx_all > log.base
    cidx1 = torch.where(live1, cidx_all, zG)
    w1 = torch.where(live1, w_all, log.base_conf)
    voters1 = conf_voters_of(w1)
    vnew1 = conf_new_of(w1)
    lrn1 = conf_learners_of(w1)

    # ---- 6. AppendEntries responses (leader bookkeeping) -------------------
    lead_g = g(role == LEADER)
    base3 = log.base.unsqueeze(-1)
    aer_r = _t(inbox.aer_valid & g(active) & lead_g &
               (inbox.aer_term == g(term)))                      # [N, G, P]
    aer_suc = aer_r & _t(inbox.aer_success)
    aer_fail = aer_r & ~_t(inbox.aer_success)
    aer_m = _t(inbox.aer_match)
    m_new = torch.maximum(match_idx, aer_m)
    match_idx = torch.where(aer_suc, m_new, match_idx)
    nx = torch.where(aer_suc, torch.maximum(next_idx, m_new + 1),
                     torch.where(aer_fail,
                                 torch.minimum(torch.clamp(aer_m + 1, min=1),
                                               next_idx),
                                 next_idx))
    need_snap = torch.where(aer_r, aer_fail & (nx <= base3), need_snap)
    next_idx = torch.maximum(nx, base3 + 1)
    aer_ack = aer_r & ~_t(inbox.aer_empty)
    aer_hb_ack = aer_r & _t(inbox.aer_empty) & _t(inbox.aer_occ)
    inflight = torch.where(aer_ack, torch.clamp(inflight - 1, min=0),
                           inflight)
    hb_inflight = torch.where(aer_hb_ack,
                              torch.clamp(hb_inflight - 1, min=0),
                              hb_inflight)
    inflight = torch.where(aer_fail, 0, inflight)
    hb_inflight = torch.where(aer_fail, 0, hb_inflight)
    send_next = torch.where(aer_fail, next_idx, send_next)
    ok_at = torch.where(aer_r, now3, ok_at)
    fail_streak = torch.where(aer_r, 0, fail_streak)

    # ---- 6b. read-barrier evidence ----------------------------------------
    read_evid = s.read_evid
    if cfg.read_lease:
        evid_hit = aer_r & ~self_hot & \
            (now3 - _t(inbox.aer_tick) <= cfg.read_fresh_ticks)
        evid_val = now3.expand(N, G, P)
    else:
        evid_hit = aer_r & ~self_hot
        evid_val = torch.maximum(read_evid, _t(inbox.aer_tick))
    read_evid = torch.where(evid_hit, evid_val, read_evid)
    read_evid = torch.where(host.read_veto.view(N, 1, 1), 0, read_evid)

    isr_r = _t(inbox.isr_valid & g(active) & lead_g &
               (inbox.isr_term == g(term)))
    isr_ok = isr_r & _t(inbox.isr_success)
    need_snap = torch.where(isr_ok, False, need_snap)
    next_idx = torch.where(isr_ok, torch.maximum(next_idx, base3 + 1),
                           next_idx)
    match_idx = torch.where(isr_ok, torch.maximum(match_idx, base3),
                            match_idx)
    isr_ack = isr_r & ~_t(inbox.isr_probe)
    inflight = torch.where(isr_ack, torch.clamp(inflight - 1, min=0),
                           inflight)
    ok_at = torch.where(isr_r, now3, ok_at)
    fail_streak = torch.where(isr_r, 0, fail_streak)
    send_next = torch.maximum(send_next, next_idx)

    # ---- 6c. CheckQuorum step-down (cfg.check_quorum) ---------------------
    # Any valid inbound RPC is contact (term-independent).  The window
    # anchors at election win and advances each time a due check passes;
    # a leader without voter-quorum contact for one election timeout steps
    # down.  Placed before 7b/8/8b, so its pending transfer aborts, its
    # submissions are refused and 8b drops its pending lease reads.
    qc = s.qc
    cq_down = cq_veto = None
    if cfg.check_quorum:
        heard_any = _t(inbox.ae_valid | inbox.aer_valid | inbox.rv_valid
                       | inbox.rvr_valid | inbox.is_valid | inbox.isr_valid
                       | inbox.tn_valid) & active.unsqueeze(-1) & ~self_hot
        heard = torch.where(heard_any, now3, qc.heard)
        since = torch.where(vote_win, nowG, qc.since)
        cq_due = active & (role == LEADER) & \
            (nowG - since >= cfg.election_ticks)
        cq_ok = contact_quorum(voters1, vnew1, me, heard, since)
        cq_down = cq_due & ~cq_ok
        since = torch.where(cq_due & cq_ok, nowG, since)
        role = torch.where(cq_down, FOLLOWER, role)
        leader_id = torch.where(cq_down, NIL, leader_id)
        elect_dl = torch.where(cq_down, nowG + rand_to, elect_dl)
        qc = qc.replace(heard=heard, since=since)
        # The reads pending at the step-down (8b aborts them).
        jcol = torch.arange(K, dtype=I32, device=dev)
        pend_slot = torch.remainder(s.rq_head.unsqueeze(-1) + jcol, K)
        pend_n = torch.where(jcol < s.rq_len.unsqueeze(-1),
                             torch.gather(s.rq_n, -1, pend_slot.long()),
                             0).sum(dim=-1).to(I32)
        cq_veto = torch.where(cq_down, pend_n, 0)

    # ---- 7. timers ---------------------------------------------------------
    voter_self = (((voters1 | vnew1) >> meG) & 1) > 0
    expired = active & (nowG >= elect_dl) & (role != LEADER) & voter_self
    if cfg.pre_vote:
        start_pre = expired & ((role == FOLLOWER) | (role == PRE_CANDIDATE))
        timer_cand = expired & (role == CANDIDATE)
    else:
        start_pre = torch.zeros_like(expired)
        timer_cand = expired
    tn_cand = ((inbox.tn_valid & g(active) & not_me_col
                & (inbox.tn_term == g(term))).any(dim=1)
               & voter_self & (role != LEADER))
    start_pre = start_pre & ~tn_cand
    timer_cand = timer_cand | tn_cand
    term = torch.where(timer_cand, term + 1, term)
    voted = torch.where(timer_cand, meG, voted)
    role = torch.where(timer_cand, CANDIDATE,
                       torch.where(start_pre, PRE_CANDIDATE, role))
    leader_id = torch.where(timer_cand | start_pre, NIL, leader_id)
    votes = torch.where(timer_cand.unsqueeze(-1), self_hot, votes)
    prevotes = torch.where(start_pre.unsqueeze(-1), self_hot, prevotes)
    elect_dl = torch.where(timer_cand | start_pre, nowG + rand_to, elect_dl)

    became_cand = pv_win | timer_cand
    last_term_v = ring_term_at(log, log.last)

    # ---- 7b. leadership-transfer intake/abort ------------------------------
    pend0 = s.xfer_to != NIL
    keep_x = (pend0 & active & (role == LEADER) & (term == s.term)
              & (nowG < s.xfer_dl))
    xfer_abort = pend0 & ~keep_x
    xfer_to = torch.where(keep_x, s.xfer_to, NIL)
    xfer_dl = torch.where(keep_x, s.xfer_dl, 0)
    tgt = host.xfer_target
    tgt_voter = (((voters1 | vnew1) >> torch.clamp(tgt, 0, P - 1)) & 1) > 0
    take_x = (active & (role == LEADER) & (xfer_to == NIL)
              & (tgt >= 0) & (tgt < P) & (tgt != meG) & tgt_voter)
    xfer_to = torch.where(take_x, tgt, xfer_to)
    xfer_dl = torch.where(take_x, nowG + cfg.election_ticks, xfer_dl)
    fenced = xfer_to != NIL

    # ---- 8. client submissions --------------------------------------------
    free = L - (log.last - log.base)
    n_acc = torch.where(active & (role == LEADER) & ~fenced,
                        torch.minimum(torch.clamp(host.submit_n, min=0),
                                      torch.clamp(free, max=S)), zG)
    sub_start = log.last + 1
    scol = torch.arange(S, dtype=I32, device=dev)
    sidx = log.last.unsqueeze(-1) + 1 + scol
    smask = scol < n_acc.unsqueeze(-1)
    new_ring = ring_write_batch(log.term, sidx, term.unsqueeze(-1), smask)
    new_cring = ring_write_batch(log.conf, sidx,
                                 torch.zeros_like(sidx), smask)
    log = log.replace(term=new_ring, conf=new_cring, last=log.last + n_acc)
    app_from = torch.where((n_acc > 0) & (app_from == 0), sub_start,
                           app_from)
    app_to = torch.where(n_acc > 0, log.last, app_to)

    # ---- 8b. linearizable read plane: intake + barrier release ------------
    keep_reads = active & (role == LEADER) & (term == s.term)
    read_abort = (s.rq_len > 0) & ~keep_reads
    rq_head = torch.where(keep_reads, s.rq_head, 0)
    rq_len = torch.where(keep_reads, s.rq_len, 0)
    read_evid = torch.where(keep_reads.unsqueeze(-1), read_evid, 0)
    n_read = torch.where(keep_reads & (commit >= own_from) & (rq_len < K),
                         torch.clamp(host.read_n, min=0), zG)
    read_acc = n_read > 0
    # The reference scatters at slot K (dropped) for lanes not taking a
    # batch; ring_write_batch's mask does the same.
    slot_in = (rq_head + rq_len).unsqueeze(-1)
    acc_col = read_acc.unsqueeze(-1)
    rq_idx = ring_write_batch(s.rq_idx, slot_in, commit.unsqueeze(-1),
                              acc_col)
    rq_stamp = ring_write_batch(s.rq_stamp, slot_in, nowG.unsqueeze(-1),
                                acc_col)
    rq_n = ring_write_batch(s.rq_n, slot_in, n_read.unsqueeze(-1), acc_col)
    rq_len = rq_len + read_acc.to(I32)
    read_index_out = torch.where(read_acc, commit, zG)
    n_rel, n_served = read_barrier_release(
        voters1, vnew1, me, read_evid, rq_stamp, rq_head, rq_len, rq_n)
    rq_head = torch.remainder(rq_head + n_rel, K)
    rq_len = rq_len - n_rel
    read_lease_hit = read_acc & (n_rel > 0) & (rq_len == 0)
    read_kick = read_acc & (rq_len > 0)

    # ---- 8c. membership-change intake + automatic joint leave (§6) --------
    full_bits = (1 << P) - 1
    hv = host.conf_voters & full_bits
    hl = host.conf_learners & full_bits & ~hv
    joint1 = vnew1 != 0
    pending1 = cidx1 > commit
    space = log.last - log.base < L
    may_append = active & (role == LEADER) & ~pending1 & space
    enter_word = conf_pack(voters1, torch.where(hv == voters1, 0, hv), hl)
    want_enter = (may_append & ~joint1 & ~fenced & (hv != 0)
                  & (enter_word != w1))
    want_leave = may_append & joint1
    leave_word = conf_pack(vnew1, 0, lrn1)
    conf_app = want_enter | want_leave
    app_word = torch.where(want_leave, leave_word, enter_word)
    nidx = log.last + 1
    log = log.replace(
        term=ring_write_batch(log.term, nidx.unsqueeze(-1),
                              term.unsqueeze(-1), conf_app.unsqueeze(-1)),
        conf=ring_write_batch(log.conf, nidx.unsqueeze(-1),
                              app_word.unsqueeze(-1),
                              conf_app.unsqueeze(-1)),
        last=log.last + conf_app.to(I32))
    conf_app_idx = torch.where(conf_app, nidx, zG)
    conf_app_term = torch.where(conf_app, term, zG)
    conf_app_word = torch.where(conf_app, app_word, zG)
    app_from = torch.where(conf_app & (app_from == 0), nidx, app_from)
    app_to = torch.where(conf_app, log.last, app_to)

    # Membership view C2: the end-of-tick active config.
    cidx2 = torch.where(conf_app, nidx, cidx1)
    w2 = torch.where(conf_app, app_word, w1)
    voters2 = conf_voters_of(w2)
    vnew2 = conf_new_of(w2)
    lrn2 = conf_learners_of(w2)
    member2 = mask_bits(voters2 | vnew2 | lrn2, P)               # [N, G, P]

    # ---- 9. replication fan-out -------------------------------------------
    lead_peer = (active & (role == LEADER)).unsqueeze(-1) & ~self_hot \
        & member2
    timed_out = lead_peer & (inflight + hb_inflight > 0) & \
        (now3 - sent_at >= cfg.rpc_timeout_ticks)
    fail_streak = torch.where(timed_out, fail_streak + 1, fail_streak)
    fail_at = torch.where(timed_out, now3, fail_at)
    send_next = torch.where(timed_out, next_idx, send_next)
    inflight = torch.where(timed_out, 0, inflight)
    hb_inflight = torch.where(timed_out, 0, hb_inflight)

    heartbeat = (role == LEADER) & ((nowG >= hb_due) | read_kick)
    last3 = log.last.unsqueeze(-1)
    has_data = (last3 >= send_next) & ~need_snap
    n_avail = torch.clamp(last3 - send_next + 1, 0, B)
    can_send = (inflight + hb_inflight) < cfg.inflight_limit
    send_data = lead_peer & ~need_snap & has_data & can_send
    send_hb = lead_peer & ~need_snap & heartbeat.unsqueeze(-1) & ~send_data
    hb_occupy = send_hb & can_send
    send_ae = send_data | send_hb
    n_send = torch.where(send_data, n_avail, 0)
    prev = send_next - 1
    # One fused gather for all peers' batches: [N, G, P*B] -> [N, P, G, B].
    flat_idx = (send_next.unsqueeze(-1) + col).reshape(N, G, P * B)
    ents_all = ring_terms_batch(log, flat_idx).reshape(N, G, P, B)
    cents_all = ring_conf_batch(log, flat_idx).reshape(N, G, P, B)
    prev_terms = _t(ring_terms_batch(log, prev))                 # [N, P, G]
    out_ae_valid = _t(send_ae)
    out_ae_term = bc(term)
    out_ae_prev_idx = _t(prev)
    out_ae_prev_term = prev_terms
    out_ae_commit = bc(commit)
    out_ae_n = _t(n_send)
    out_ae_ents = ents_all.transpose(1, 2)                       # [N, P, G, B]
    out_ae_cents = cents_all.transpose(1, 2)
    out_ae_occ = _t(hb_occupy)
    out_ae_tick = now3.expand(N, P, G)
    send_is_win = lead_peer & need_snap & (inflight + hb_inflight == 0)
    send_is = send_is_win | (lead_peer & need_snap &
                             heartbeat.unsqueeze(-1))
    out_is_valid = _t(send_is)
    out_is_term = bc(term)
    out_is_idx = bc(log.base)
    out_is_last_term = bc(log.base_term)
    out_is_probe = _t(send_is & ~send_is_win)
    out_is_conf = bc(log.base_conf)
    occupy = send_data | send_is_win
    send_next = torch.where(send_data, send_next + n_send, send_next)
    inflight = torch.where(occupy, inflight + 1, inflight)
    hb_inflight = torch.where(hb_occupy, hb_inflight + 1, hb_inflight)
    sent_at = torch.where(occupy | hb_occupy, now3, sent_at)
    hb_due = torch.where(heartbeat, nowG + cfg.heartbeat_ticks, hb_due)

    # Leader readiness: a masked quorum of healthy followers.
    healthy = (ok_at > 0) & ~need_snap & ~self_hot
    if cfg.avail_crit > 0:
        healthy = healthy & (fail_streak <= cfg.avail_crit)
    if cfg.recovery_ticks > 0:
        healthy = healthy & ((fail_at == 0) |
                             (now3 - fail_at >= cfg.recovery_ticks))
    ready = (active & (role == LEADER) & ~fenced &
             dual_quorum((healthy & lead_peer) | self_hot, voters2, vnew2))

    # TimeoutNow dispatch once the transfer target has caught up.
    tgt_match = torch.gather(
        match_idx, -1, torch.clamp(xfer_to, 0, P - 1).long().unsqueeze(-1)
    ).squeeze(-1)
    xfer_fire = (active & (role == LEADER) & (xfer_to != NIL)
                 & (tgt_match >= log.last))
    out_tn_valid = (pid_col == g(xfer_to)) & g(xfer_fire)
    out_tn_term = bc(term)

    # Election broadcasts to voter slots.
    bcast = (became_cand | start_pre) & active
    out_rv_valid = g(bcast) & not_me_col & \
        _t(mask_bits(voters2 | vnew2, P))
    out_rv_term = bc(torch.where(start_pre, term + 1, term))
    out_rv_last_idx = bc(log.last)
    out_rv_last_term = bc(last_term_v)
    out_rv_prevote = bc(start_pre)

    # ---- 10. commit advance ------------------------------------------------
    # Self column = the log tail, or its durable prefix when the host says
    # so; the masked quorum order statistic runs in the CUDA kernel on
    # CUDA tensors (one launch for the whole cluster).  The where writes
    # match_full dense in [N, G, P] order even when match_idx arrives with
    # the inbox's transposed strides, so the kernel reads whole rows.
    self_match = log.last if host.durable_tail is None \
        else torch.minimum(log.last, host.durable_tail)
    match_full = torch.where(self_hot, self_match.unsqueeze(-1), match_idx,
                             out=torch.empty_like(
                                 match_idx,
                                 memory_format=torch.contiguous_format))
    commit = quorum_commit(cfg, match_full, log, commit, own_from,
                           active & (role == LEADER), voters2, vnew2)
    match_idx = match_full

    # §6 epilogue: a leader whose committed simple config excludes it
    # steps down.
    resigned = (active & (role == LEADER) & (vnew2 == 0)
                & (cidx2 <= commit)
                & (((voters2 >> meG) & 1) == 0))
    role = torch.where(resigned, FOLLOWER, role)
    leader_id = torch.where(resigned, NIL, leader_id)
    elect_dl = torch.where(resigned, nowG + rand_to, elect_dl)

    # ---- flight recorder (cfg.trace_depth) --------------------------------
    # A tick's events land in canonical order: event e's ring slot is n
    # plus the count of this tick's events that fired before it.  Written
    # without a scatter: the fired events compact into a dense NE-wide
    # window ([N, G, NE, NE] one-hot), and ring position d takes window
    # offset (d - n) mod D when that offset is below the tick's count, so
    # masked lanes write nowhere.  trace_depth >= NE + 1 keeps a tick's
    # slots distinct.
    trace = s.trace
    if cfg.trace_depth:
        D = cfg.trace_depth
        NE = len(_TRACE_KINDS)
        ev_masks = torch.stack([
            term != s.term,
            (s.role == LEADER) & (role != LEADER),
            start_pre,
            became_cand,
            vote_win,
            sd,
            commit > s.commit,
            n_rel > 0,
            (w2 != w0) | (cidx2 != cidx0),
            (cidx2 > 0) & (s.commit < cidx2) & (commit >= cidx2),
            xfer_fire,
        ], dim=-1) & active.unsqueeze(-1)                      # [N, G, NE]
        # _TRACE_KINDS built on the device (a host tensor would be a
        # synchronising copy every tick).
        e = torch.arange(NE, dtype=I32, device=dev)
        ev_kinds = e + 1 + (e >= TR_CRASH_RESTART - 1).to(I32)
        ev_aux = torch.stack([
            s.term, leader_id, zG,
            # Candidacy cause: 0 PreVote majority / 1 timer / 2 TimeoutNow.
            timer_cand.to(I32) + tn_cand.to(I32),
            noop_idx, host.snap_idx,
            commit, n_served,
            w2, cidx2, xfer_to,
        ], dim=-1)
        ev_i32 = ev_masks.to(I32)
        prior = torch.cumsum(ev_i32, dim=-1).to(I32) - ev_i32
        n_new = ev_i32.sum(dim=-1).to(I32)                     # [N, G]
        off_hit = (prior.unsqueeze(-1) ==
                   torch.arange(NE, dtype=I32, device=dev)) \
            & ev_masks.unsqueeze(-1)                           # [N, G, NE, NE]

        def win(vals):                                         # -> [N, G, NE]
            return torch.where(off_hit, vals.unsqueeze(-1), 0) \
                .sum(dim=-2).to(I32)

        rel = torch.remainder(
            torch.arange(D, dtype=I32, device=dev)
            - torch.remainder(trace.n, D).unsqueeze(-1), D)    # [N, G, D]
        write = rel < n_new.unsqueeze(-1)
        rel_idx = torch.clamp(rel, max=NE - 1).long()

        def put(ring, vals):
            return torch.where(write, torch.gather(win(vals), -1, rel_idx),
                               ring)

        trace = trace.replace(
            tick=torch.where(write, now3, trace.tick),
            kind=put(trace.kind, ev_kinds.expand(N, G, NE)),
            term=torch.where(write, term.unsqueeze(-1), trace.term),
            aux=put(trace.aux, ev_aux),
            n=trace.n + n_new,
        )

    # ---- heat lanes (cfg.heat) --------------------------------------------
    # Cumulative per-group counters: entries appended, RPCs emitted (all
    # seven kinds, summed over the destination axis), commit advance,
    # reads served.
    heat = s.heat
    if cfg.heat:
        sent_n = (out_ae_valid.to(I32) + out_aer_valid.to(I32)
                  + out_rv_valid.to(I32) + out_rvr_valid.to(I32)
                  + out_is_valid.to(I32) + out_isr_valid.to(I32)
                  + out_tn_valid.to(I32)).sum(dim=1).to(I32)
        appended_n = torch.where(app_to > 0, app_to - app_from + 1, 0)
        heat = heat.replace(
            appended=heat.appended + appended_n,
            sent=heat.sent + sent_n,
            commits=heat.commits + (commit - s.commit),
            reads=heat.reads + n_served,
        )

    dirty = (term != old_term) | (voted != old_voted) | \
        (log.last != old_last) | (app_to > 0)

    # ---- invariant checks (cfg.debug_checks) ------------------------------
    # The first violated invariant per lane, as a DEBUG_CODES code.
    debug_viol = zG
    if cfg.debug_checks:
        def flag(viol, cond, code):
            return torch.where(active & cond & (viol == 0), code, viol)
        debug_viol = flag(debug_viol, log.last - log.base > L, 1)
        debug_viol = flag(debug_viol,
                          commit > torch.maximum(log.last, log.base), 2)
        debug_viol = flag(debug_viol, term < s.term, 3)
        debug_viol = flag(
            debug_viol,
            (s.role == LEADER) & (role == LEADER)
            & (match_idx < s.match_idx).any(dim=-1), 4)
        debug_viol = flag(debug_viol, (role == CANDIDATE) & (voted != meG), 5)
        debug_viol = flag(debug_viol, commit < s.commit, 6)
        debug_viol = flag(debug_viol, (send_next < next_idx).any(dim=-1), 7)
        debug_viol = flag(debug_viol, (rq_len < 0) | (rq_len > K), 8)
        debug_viol = flag(debug_viol, voters2 == 0, 9)

    new_state = RaftState(
        node_id=s.node_id, now=now, rng=rng, active=active,
        term=term, role=role, voted_for=voted, leader_id=leader_id,
        commit=commit, applied=s.applied, log=log,
        own_from=own_from,
        next_idx=next_idx, match_idx=match_idx, send_next=send_next,
        inflight=inflight, hb_inflight=hb_inflight, sent_at=sent_at,
        need_snap=need_snap,
        ok_at=ok_at, fail_at=fail_at, fail_streak=fail_streak,
        votes=votes, prevotes=prevotes,
        elect_deadline=elect_dl, hb_due=hb_due,
        conf_idx=cidx2, conf_word=w2,
        xfer_to=xfer_to, xfer_dl=xfer_dl,
        read_evid=read_evid,
        rq_idx=rq_idx, rq_stamp=rq_stamp, rq_n=rq_n,
        rq_head=rq_head, rq_len=rq_len,
        trace=trace, heat=heat, qc=qc,
    )
    outbox = Messages(
        ae_valid=out_ae_valid, ae_term=out_ae_term,
        ae_prev_idx=out_ae_prev_idx, ae_prev_term=out_ae_prev_term,
        ae_commit=out_ae_commit, ae_n=out_ae_n, ae_ents=out_ae_ents,
        ae_occ=out_ae_occ, ae_cents=out_ae_cents, ae_tick=out_ae_tick,
        aer_valid=out_aer_valid, aer_term=out_aer_term,
        aer_success=out_aer_success, aer_match=out_aer_match,
        aer_empty=out_aer_empty, aer_occ=out_aer_occ,
        aer_tick=out_aer_tick,
        rv_valid=out_rv_valid, rv_term=out_rv_term,
        rv_last_idx=out_rv_last_idx, rv_last_term=out_rv_last_term,
        rv_prevote=out_rv_prevote,
        rvr_valid=out_rvr_valid, rvr_term=out_rvr_term,
        rvr_granted=out_rvr_granted, rvr_prevote=out_rvr_prevote,
        rvr_echo=out_rvr_echo,
        is_valid=out_is_valid, is_term=out_is_term, is_idx=out_is_idx,
        is_last_term=out_is_last_term, is_probe=out_is_probe,
        is_conf=out_is_conf,
        isr_valid=out_isr_valid, isr_term=out_isr_term,
        isr_success=out_isr_success, isr_probe=out_isr_probe,
        tn_valid=out_tn_valid, tn_term=out_tn_term,
    )
    info = StepInfo(
        submit_start=sub_start, submit_acc=n_acc, dirty=dirty,
        appended_from=app_from, appended_to=app_to, log_tail=log.last,
        commit=commit, leader=leader_id, ready=ready, snap_req=snap_req,
        snap_req_from=snap_from, snap_req_idx=snap_idx_o,
        snap_req_term=snap_term_o, snap_req_conf=snap_conf_o,
        noop_idx=noop_idx, noop_term=noop_term,
        read_acc=n_read, read_index=read_index_out,
        read_rel=n_rel, read_served=n_served,
        read_lease=read_lease_hit, read_abort=read_abort,
        conf_app_idx=conf_app_idx, conf_app_term=conf_app_term,
        conf_app_word=conf_app_word,
        conf_word=w2, conf_idx=cidx2, conf_pending=cidx2 > commit,
        xfer_fired=xfer_fire, xfer_abort=xfer_abort,
        debug_viol=debug_viol,
        cq_stepdown=cq_down, cq_veto=cq_veto,
    )
    return new_state, outbox, info
