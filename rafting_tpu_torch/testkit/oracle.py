"""Scalar oracle: a loop-based re-derivation of one Multi-Raft node tick.

The port's copy of the JAX package's ``testkit/oracle.py``.  It
implements the SAME protocol semantics as
:func:`rafting_tpu_torch.core.step.node_step`, but as explicit per-group /
per-peer Python loops following the reference implementation's scalar
logic (curioloop/rafting: context/member/Follower.java, Candidate.java,
Leader.java, Leadership.java, context/RaftRoutine.java) and the Raft paper
rules.  It is deliberately written WITHOUT vector tricks so that it can
serve as an independent check of the step's vectorization: the parity
runs drive both with identical inputs and compare every state lane and
every outbound message bit-for-bit.  Every protocol line is the
reference oracle's; only the seam differs:

* the inputs are the port's containers (one node, no node axis), with
  tensors on any device; :func:`_np` brings them to host numpy under the
  reference's dotted names and dtypes (the PRNG key as uint32 words);
* the election-timeout draw comes from :mod:`rafting_tpu_torch.core.prng`,
  bit-exact to ``jax.random``, on a host copy of the key.

The oracle is host code: it returns numpy, whatever device the state is
on.

The only shared computation is the PRNG draw for randomized election
timeouts: the oracle consumes the same threefry stream as the step so that
timer outcomes are comparable (the reference re-randomizes the election
window on every read, support/RaftConfig.java:187-190; which lanes
*consume* the draw is part of the checked semantics).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from ..core import prng
from ..core.types import (
    CANDIDATE, FOLLOWER, LEADER, NIL, PRE_CANDIDATE,
    EngineConfig, HostInbox, Messages, RaftState,
    conf_learners_of, conf_new_of, conf_pack, conf_voters_of,
)
from ..utils.tracelog import (
    TR_BECAME_CANDIDATE, TR_BECAME_LEADER, TR_BECAME_PRE_CANDIDATE,
    TR_COMMIT_ADVANCE, TR_CONF_CHANGE_COMMIT, TR_CONF_CHANGE_ENTER,
    TR_LEADER_TRANSFER, TR_READ_RELEASE, TR_SNAPSHOT_INSTALL,
    TR_STEPPED_DOWN, TR_TERM_BUMP,
)


def _popcount(x: int) -> int:
    return bin(x & 0xFFFFFFFF).count("1")


def _dual_quorum(flags, voters: int, voters_new: int) -> bool:
    """Scalar mirror of core.step.dual_quorum: ``flags`` is a per-peer
    boolean sequence; a joint config needs a majority in BOTH sets."""
    cv = sum(1 for p, f in enumerate(flags) if f and (voters >> p) & 1)
    ok = cv >= _popcount(voters) // 2 + 1
    if voters_new:
        cn = sum(1 for p, f in enumerate(flags)
                 if f and (voters_new >> p) & 1)
        ok = ok and cn >= _popcount(voters_new) // 2 + 1
    return ok


def _np(tree) -> Dict[str, np.ndarray]:
    """Flatten one of the port's containers into {field: host numpy
    array}, nested fields dotted (``log.term``, ``trace.tick``, ...).

    Leaves may be tensors on any device or numpy arrays.  None subfields
    (e.g. ``trace`` with the flight recorder disabled) are empty subtrees
    — skipped, exactly as jax's flatten drops them.  The PRNG key comes
    back as the reference's uint32 words (``bridge.state_to_numpy``'s
    rule), so the oracle's outputs compare with the JAX oracle's as they
    are."""
    out = {}
    for name in tree.__dataclass_fields__:
        v = getattr(tree, name)
        if v is None:
            continue
        if hasattr(v, "__dataclass_fields__"):
            for sub, arr in _np(v).items():
                out[f"{name}.{sub}"] = arr
        else:
            a = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v))
            out[name] = a.astype(np.uint32) if name == "rng" else a
    return out


@dataclass
class _Log:
    """Scalar view of one group's log ring."""
    ring: np.ndarray  # [L] terms
    cring: np.ndarray  # [L] packed config words (0 = not a config entry)
    base: int
    base_term: int
    base_conf: int
    last: int

    def term_at(self, idx: int) -> int:
        # Mirrors ring_term_at: <= base -> milestone term; > last -> -1.
        if idx <= self.base:
            return int(self.base_term)
        if idx <= self.last:
            return int(self.ring[idx % len(self.ring)])
        return -1

    def conf_at(self, idx: int) -> int:
        # Mirrors ring_conf_batch: the entry's packed config word inside
        # the live window, else 0.
        if self.base < idx <= self.last:
            return int(self.cring[idx % len(self.ring)])
        return 0

    def latest_conf(self, upto: int):
        """(conf_idx, conf_word) of the latest config entry in
        (base, min(upto, last)], else (0, base_conf) — the scalar mirror
        of core.step.latest_conf."""
        L = len(self.ring)
        lo = max(self.base + 1, self.last - L + 1, 1)
        for idx in range(min(upto, self.last), lo - 1, -1):
            w = int(self.cring[idx % L])
            if w != 0:
                return idx, w
        return 0, int(self.base_conf)


def oracle_step(cfg: EngineConfig, state: RaftState, inbox: Messages,
                host: HostInbox):
    """Advance one node by one tick, scalar semantics.

    Returns (state_dict, outbox_dict, info_dict) of numpy arrays with the
    same keys/shapes as the kernel's pytrees (nested fields dotted,
    e.g. ``log.term``).
    """
    G, P, B, L, S = (cfg.n_groups, cfg.n_peers, cfg.batch, cfg.log_slots,
                     cfg.max_submit)
    maj = cfg.majority
    s = _np(state)
    ib = _np(inbox)
    h = _np(host)

    me = int(s["node_id"])
    now = int(s["now"]) + 1

    # Same PRNG stream as the kernel (shared on purpose; see module doc),
    # drawn on a host copy of the key.
    rng, k_to = prng.split(torch.from_numpy(s["rng"].astype(np.int64)))
    rand_to = prng.randint(k_to, G, cfg.election_ticks,
                           2 * cfg.election_ticks).numpy()

    active = s["active"].copy()
    term = s["term"].astype(np.int64).copy()
    role = s["role"].copy()
    voted = s["voted_for"].copy()
    leader_id = s["leader_id"].copy()
    commit = s["commit"].copy()
    ring = s["log.term"].copy()
    cring = s["log.conf"].copy()
    base = s["log.base"].copy()
    base_term = s["log.base_term"].copy()
    base_conf = s["log.base_conf"].copy()
    last = s["log.last"].copy()
    conf_idx_st = s["conf_idx"].copy()
    conf_word_st = s["conf_word"].copy()
    xfer_to = s["xfer_to"].copy()
    xfer_dl = s["xfer_dl"].copy()
    next_idx = s["next_idx"].copy()
    own_from_a = s["own_from"].astype(np.int64).copy()
    match_idx = s["match_idx"].copy()
    send_next = s["send_next"].copy()
    inflight = s["inflight"].copy()
    hb_inflight = s["hb_inflight"].copy()
    sent_at = s["sent_at"].copy()
    need_snap = s["need_snap"].copy()
    ok_at = s["ok_at"].copy()
    fail_at = s["fail_at"].copy()
    fail_streak = s["fail_streak"].copy()
    votes = s["votes"].copy()
    prevotes = s["prevotes"].copy()
    elect_dl = s["elect_deadline"].copy()
    hb_due = s["hb_due"].copy()
    read_evid = s["read_evid"].copy()
    rq_idx = s["rq_idx"].copy()
    rq_stamp = s["rq_stamp"].copy()
    rq_n = s["rq_n"].copy()
    rq_head = s["rq_head"].copy()
    rq_len = s["rq_len"].copy()
    K = cfg.read_slots

    # Flight recorder (cfg.trace_depth): the scalar mirror of the kernel's
    # ring writes — same canonical event order, same ring semantics.
    has_trace = state.trace is not None
    if has_trace:
        tr_tick = s["trace.tick"].copy()
        tr_kind = s["trace.kind"].copy()
        tr_term = s["trace.term"].copy()
        tr_aux = s["trace.aux"].copy()
        tr_n = s["trace.n"].copy()
        D = tr_tick.shape[1]

    # Heat lanes (cfg.heat): the scalar mirror of the kernel's cumulative
    # per-group activity counters (appended / sent / commits / reads).
    has_heat = state.heat is not None
    if has_heat:
        ht_app = s["heat.appended"].copy()
        ht_sent = s["heat.sent"].copy()
        ht_com = s["heat.commits"].copy()
        ht_rd = s["heat.reads"].copy()

    # Quorum-contact lanes (cfg.check_quorum): the scalar mirror of the
    # kernel's CheckQuorum phase 6c.
    has_qc = state.qc is not None
    if has_qc:
        qc_heard = s["qc.heard"].copy()
        qc_since = s["qc.since"].copy()

    old_term = term.copy()
    old_voted = voted.copy()
    old_last = last.copy()
    old_commit = commit.copy()
    old_role = role.copy()

    # Outbox accumulators, [P, G] dense like the kernel's.
    def zi(*shape):
        return np.zeros(shape, np.int32)

    def zb(*shape):
        return np.zeros(shape, bool)

    out = {
        "ae_valid": zb(P, G), "ae_term": zi(P, G), "ae_prev_idx": zi(P, G),
        "ae_prev_term": zi(P, G), "ae_commit": zi(P, G), "ae_n": zi(P, G),
        "ae_ents": zi(P, G, B), "ae_cents": zi(P, G, B),
        "ae_occ": zb(P, G), "ae_tick": zi(P, G),
        "aer_valid": zb(P, G), "aer_term": zi(P, G),
        "aer_success": zb(P, G), "aer_match": zi(P, G),
        "aer_empty": zb(P, G), "aer_occ": zb(P, G), "aer_tick": zi(P, G),
        "rv_valid": zb(P, G), "rv_term": zi(P, G), "rv_last_idx": zi(P, G),
        "rv_last_term": zi(P, G), "rv_prevote": zb(P, G),
        "rvr_valid": zb(P, G), "rvr_term": zi(P, G), "rvr_granted": zb(P, G),
        "rvr_prevote": zb(P, G), "rvr_echo": zi(P, G),
        "is_valid": zb(P, G), "is_term": zi(P, G), "is_idx": zi(P, G),
        "is_last_term": zi(P, G), "is_probe": zb(P, G), "is_conf": zi(P, G),
        "isr_valid": zb(P, G), "isr_term": zi(P, G), "isr_success": zb(P, G),
        "isr_probe": zb(P, G),
        "tn_valid": zb(P, G), "tn_term": zi(P, G),
    }
    info = {
        "submit_start": zi(G), "submit_acc": zi(G), "dirty": zb(G),
        "appended_from": zi(G), "appended_to": zi(G), "log_tail": zi(G),
        "commit": zi(G), "leader": np.full(G, NIL, np.int32),
        "ready": zb(G),
        "snap_req": zb(G), "snap_req_from": zi(G), "snap_req_idx": zi(G),
        "snap_req_term": zi(G), "snap_req_conf": zi(G),
        "noop_idx": zi(G), "noop_term": zi(G),
        "read_acc": zi(G), "read_index": zi(G),
        "read_rel": zi(G), "read_served": zi(G),
        "read_lease": zb(G), "read_abort": zb(G),
        "conf_app_idx": zi(G), "conf_app_term": zi(G),
        "conf_app_word": zi(G),
        "conf_word": zi(G), "conf_idx": zi(G), "conf_pending": zb(G),
        "xfer_fired": zb(G), "xfer_abort": zb(G),
    }
    if has_qc:
        info["cq_stepdown"] = zb(G)
        info["cq_veto"] = zi(G)

    for g in range(G):
        log = _Log(ring[g], cring[g], int(base[g]), int(base_term[g]),
                   int(base_conf[g]), int(last[g]))
        app_from, app_to = 0, 0

        # ---- 0. membership view C0 (tick-start) ---------------------------
        # (kernel phase 0: the state's conf_idx/conf_word cache — always
        # equal to the latest config entry in the log, §6 apply-on-append;
        # tallies count against it.)
        cidx0, w0 = int(conf_idx_st[g]), int(conf_word_st[g])
        voters0, vnew0 = conf_voters_of(w0), conf_new_of(w0)

        # ---- 1. term sync: adopt the highest real inbound term ------------
        # (Raft "if RPC term > currentTerm, become follower"; reference
        # Follower.java:45-47, Leader.java:224-227.  PreVote request terms
        # are speculative and excluded.)
        mt = -1
        for p in range(P):
            if ib["ae_valid"][p, g]:
                mt = max(mt, int(ib["ae_term"][p, g]))
            if ib["aer_valid"][p, g]:
                mt = max(mt, int(ib["aer_term"][p, g]))
            if ib["rv_valid"][p, g] and not ib["rv_prevote"][p, g]:
                mt = max(mt, int(ib["rv_term"][p, g]))
            if ib["rvr_valid"][p, g]:
                mt = max(mt, int(ib["rvr_term"][p, g]))
            if ib["is_valid"][p, g]:
                mt = max(mt, int(ib["is_term"][p, g]))
            if ib["isr_valid"][p, g]:
                mt = max(mt, int(ib["isr_term"][p, g]))
            if ib["tn_valid"][p, g]:
                mt = max(mt, int(ib["tn_term"][p, g]))
        if active[g] and mt > term[g]:
            term[g] = mt
            role[g] = FOLLOWER
            voted[g] = NIL
            leader_id[g] = NIL
            elect_dl[g] = now + rand_to[g]

        last_term_v = log.term_at(log.last)

        # ---- 2. vote requests ---------------------------------------------
        # (reference Follower.requestVote:108-127 / preVote:91-105.)
        def up_to_date(p):
            lt, li = int(ib["rv_last_term"][p, g]), int(ib["rv_last_idx"][p, g])
            return lt > last_term_v or (lt == last_term_v and li >= log.last)

        rv_v = [bool(ib["rv_valid"][p, g]) and active[g] and p != me
                for p in range(P)]
        elig = [rv_v[p] and not ib["rv_prevote"][p, g]
                and int(ib["rv_term"][p, g]) == term[g] and up_to_date(p)
                and (voted[g] == NIL or voted[g] == p)
                for p in range(P)]
        first_elig = next((p for p in range(P) if elig[p]), 0)
        grant_rv = [elig[p] and (voted[g] == p or p == first_elig)
                    for p in range(P)]
        if any(grant_rv) and voted[g] == NIL:
            voted[g] = first_elig
        if any(grant_rv):
            elect_dl[g] = now + rand_to[g]
        lease_open = now >= elect_dl[g] or leader_id[g] == NIL
        for p in range(P):
            if rv_v[p]:
                pv = bool(ib["rv_prevote"][p, g])
                if pv:
                    granted = (int(ib["rv_term"][p, g]) > term[g]
                               and up_to_date(p) and lease_open)
                else:
                    granted = grant_rv[p]
                out["rvr_valid"][p, g] = True
                out["rvr_granted"][p, g] = granted
                out["rvr_prevote"][p, g] = pv
                out["rvr_echo"][p, g] = ib["rv_term"][p, g]
                out["rvr_term"][p, g] = term[g]

        # ---- 3. vote responses + tallies ----------------------------------
        # (reference Candidate.startElection:112-134, prepareElection
        # tally Follower.java:241-275.)
        for p in range(P):
            if not (ib["rvr_valid"][p, g] and active[g]):
                continue
            if (ib["rvr_prevote"][p, g] and ib["rvr_granted"][p, g]
                    and role[g] == PRE_CANDIDATE
                    and int(ib["rvr_echo"][p, g]) == term[g] + 1):
                prevotes[g, p] = True
            if (not ib["rvr_prevote"][p, g] and ib["rvr_granted"][p, g]
                    and role[g] == CANDIDATE
                    and int(ib["rvr_term"][p, g]) == term[g]):
                votes[g, p] = True
        become_cand_pv = (role[g] == PRE_CANDIDATE
                          and _dual_quorum(prevotes[g], voters0, vnew0))
        if become_cand_pv:
            term[g] += 1
            role[g] = CANDIDATE
            voted[g] = me
            leader_id[g] = NIL
            votes[g] = False
            votes[g, me] = True
            elect_dl[g] = now + rand_to[g]
        vote_win = (role[g] == CANDIDATE
                    and _dual_quorum(votes[g], voters0, vnew0))
        if vote_win:
            role[g] = LEADER
            leader_id[g] = me
            next_idx[g] = log.last + 1
            match_idx[g] = 0
            send_next[g] = log.last + 1
            inflight[g] = 0
            hb_inflight[g] = 0
            need_snap[g] = False
            ok_at[g] = 0
            fail_at[g] = 0
            fail_streak[g] = 0
            hb_due[g] = now
            own_from_a[g] = log.last + 1
            # Raft §8 no-op on election win (mirrors kernel phase 3):
            # appended AFTER the replication matrix reset, so
            # next/send point exactly at the no-op.
            if log.last - log.base < L:
                info["noop_idx"][g] = log.last + 1
                info["noop_term"][g] = term[g]
                log.ring[(log.last + 1) % L] = term[g]
                log.cring[(log.last + 1) % L] = 0
                log.last += 1

        # ---- 4. AppendEntries requests ------------------------------------
        # (reference Follower.appendEntries:35-88.)
        ae_ok = [bool(ib["ae_valid"][p, g]) and active[g] and p != me
                 and int(ib["ae_term"][p, g]) == term[g] for p in range(P)]
        ae_peer = next((p for p in range(P) if ae_ok[p]), 0)
        ae_any = any(ae_ok) and role[g] != LEADER
        acc = False
        tail = 0
        if ae_any:
            role[g] = FOLLOWER
            leader_id[g] = ae_peer
            elect_dl[g] = now + rand_to[g]
            prev_i = int(ib["ae_prev_idx"][ae_peer, g])
            prev_t = int(ib["ae_prev_term"][ae_peer, g])
            n_e = int(ib["ae_n"][ae_peer, g])
            # Bounded-window partial accept (see kernel phase 4): never let
            # the live window (base, last] exceed the ring capacity.
            n_e = max(0, min(n_e, log.base + L - prev_i))
            lc = int(ib["ae_commit"][ae_peer, g])
            ents = ib["ae_ents"][ae_peer, g]
            centsv = ib["ae_cents"][ae_peer, g]
            acc = (prev_i <= log.base
                   or (prev_i <= log.last and log.term_at(prev_i) == prev_t))
            if acc:
                tail = prev_i + n_e
                conflict = False
                for k in range(n_e):
                    idx = prev_i + 1 + k
                    if log.base < idx <= log.last \
                            and log.term_at(idx) != int(ents[k]):
                        conflict = True
                        break
                for k in range(n_e):
                    idx = prev_i + 1 + k
                    if idx > log.base:
                        log.ring[idx % L] = ents[k]
                        # Config adoption rides the entry write (§6
                        # apply-on-append via latest_conf).
                        log.cring[idx % L] = centsv[k]
                new_last = tail if conflict else max(log.last, tail)
                wrote = n_e > 0 and (new_last != log.last or conflict)
                if wrote:
                    app_from, app_to = prev_i + 1, new_last
                log.last = new_last
                commit[g] = max(commit[g], min(lc, tail))
        for p in range(P):
            if bool(ib["ae_valid"][p, g]) and active[g] and p != me:
                out["aer_valid"][p, g] = True
                out["aer_term"][p, g] = term[g]
                sel = ae_ok[p] and p == ae_peer
                out["aer_success"][p, g] = sel and acc
                out["aer_match"][p, g] = (
                    tail if (sel and acc)
                    else min(log.last, int(ib["ae_prev_idx"][p, g]) - 1))
                # Heartbeat echo: the sender never charged an empty AE
                # against its window, so the reply must not decrement it.
                out["aer_empty"][p, g] = int(ib["ae_n"][p, g]) == 0
                out["aer_occ"][p, g] = bool(ib["ae_occ"][p, g])
                # Send-tick echo (read-barrier evidence; kernel phase 4
                # echoes it on success AND failure — any same-term reply
                # proves the AE was processed).
                out["aer_tick"][p, g] = ib["ae_tick"][p, g]

        # ---- 5. InstallSnapshot -------------------------------------------
        # (reference Follower.installSnapshot:130-153 + host completion,
        # RaftRoutine.restoreCheckpoint:482-541.)
        is_ok = [bool(ib["is_valid"][p, g]) and active[g] and p != me
                 and int(ib["is_term"][p, g]) == term[g] for p in range(P)]
        is_peer = next((p for p in range(P) if is_ok[p]), 0)
        is_any = any(is_ok) and role[g] != LEADER
        # Coverage is evaluated against the selected offer whenever one
        # passed the term check (the reply is sent even if we are — by an
        # impossible schedule — a same-term leader; matches the kernel).
        off_idx = int(ib["is_idx"][is_peer, g])
        off_term = int(ib["is_last_term"][is_peer, g])
        off_conf = int(ib["is_conf"][is_peer, g])
        covered = (any(is_ok)
                   and (off_idx <= log.base
                        or (off_idx <= log.last
                            and log.term_at(off_idx) == off_term)))
        if is_any:
            role[g] = FOLLOWER
            leader_id[g] = is_peer
            elect_dl[g] = now + rand_to[g]
            if not covered:
                info["snap_req"][g] = True
                info["snap_req_from"][g] = is_peer
                info["snap_req_idx"][g] = off_idx
                info["snap_req_term"][g] = off_term
                info["snap_req_conf"][g] = off_conf
        for p in range(P):
            if bool(ib["is_valid"][p, g]) and active[g] and p != me:
                out["isr_valid"][p, g] = True
                out["isr_term"][p, g] = term[g]
                out["isr_success"][p, g] = (is_ok[p] and p == is_peer
                                            and covered)
                out["isr_probe"][p, g] = bool(ib["is_probe"][p, g])

        snap_inst = (h["snap_done"][g] and active[g]
                     and int(h["snap_idx"][g]) > log.base)
        if snap_inst:
            si, st = int(h["snap_idx"][g]), int(h["snap_term"][g])
            tail_matches = si <= log.last and log.term_at(si) == st
            log.base, log.base_term = si, st
            if int(h["snap_conf"][g]) != 0:
                log.base_conf = int(h["snap_conf"][g])
            if not tail_matches:
                log.last = si
            commit[g] = max(commit[g], si)

        ct = min(int(h["compact_to"][g]), int(commit[g]))
        if active[g] and ct > log.base:
            log.base_term = log.term_at(ct)
            # The milestone config folds into base_conf BEFORE the floor
            # moves (kernel: latest_conf(log, ct) pre-floor).
            _, log.base_conf = log.latest_conf(ct)
            log.base = ct

        # Membership view C1 (kernel: post-AE/snapshot/compaction).
        cidx1, w1 = log.latest_conf(log.last)
        voters1, vnew1 = conf_voters_of(w1), conf_new_of(w1)
        lrn1 = conf_learners_of(w1)
        voter_self = ((voters1 | vnew1) >> me) & 1

        # ---- 6. AppendEntries / snapshot responses (leader side) ----------
        # (reference Leader.java:224-243, Leadership.updateIndex:75-114;
        # pipeline accounting per Leadership.java:10-11; health evidence per
        # statSuccess, Leadership.java:53-63.)
        for p in range(P):
            r = (bool(ib["aer_valid"][p, g]) and active[g]
                 and role[g] == LEADER and int(ib["aer_term"][p, g]) == term[g])
            if r:
                m = int(ib["aer_match"][p, g])
                if ib["aer_success"][p, g]:
                    match_idx[g, p] = max(match_idx[g, p], m)
                    next_idx[g, p] = max(next_idx[g, p], match_idx[g, p] + 1)
                    need_snap[g, p] = False
                else:
                    next_idx[g, p] = min(max(m + 1, 1), next_idx[g, p])
                    need_snap[g, p] = next_idx[g, p] <= log.base
            # Unconditional floor (kernel applies it to every lane).
            next_idx[g, p] = max(next_idx[g, p], log.base + 1)
            if r:
                # Heartbeat replies (aer_empty) release a heartbeat slot;
                # data replies release a data slot (lanes never cross).
                if ib["aer_empty"][p, g]:
                    if ib["aer_occ"][p, g]:
                        hb_inflight[g, p] = max(hb_inflight[g, p] - 1, 0)
                else:
                    inflight[g, p] = max(inflight[g, p] - 1, 0)
                if not ib["aer_success"][p, g]:
                    inflight[g, p] = 0
                    hb_inflight[g, p] = 0
                    send_next[g, p] = next_idx[g, p]
                ok_at[g, p] = now
                fail_streak[g, p] = 0
            ir = (bool(ib["isr_valid"][p, g]) and active[g]
                  and role[g] == LEADER and int(ib["isr_term"][p, g]) == term[g])
            if ir:
                if ib["isr_success"][p, g]:
                    need_snap[g, p] = False
                    next_idx[g, p] = max(next_idx[g, p], log.base + 1)
                    match_idx[g, p] = max(match_idx[g, p], log.base)
                # Probe re-offers never occupied a slot (isr_probe echo).
                if not ib["isr_probe"][p, g]:
                    inflight[g, p] = max(inflight[g, p] - 1, 0)
                ok_at[g, p] = now
                fail_streak[g, p] = 0
            # The pipeline head never trails the ack base.
            send_next[g, p] = max(send_next[g, p], next_idx[g, p])

        # ---- 6b. read-barrier evidence ------------------------------------
        # (kernel phase 6b: a same-term AE reply proves the sender followed
        # us when it processed the AE.  Lease mode stores the RECEIPT tick
        # gated by the echo freshness bound; strict mode stores the ECHOED
        # send tick.)
        for p in range(P):
            if p == me:
                continue
            r = (bool(ib["aer_valid"][p, g]) and active[g]
                 and role[g] == LEADER and int(ib["aer_term"][p, g]) == term[g])
            if not r:
                continue
            echoed = int(ib["aer_tick"][p, g])
            if cfg.read_lease:
                if now - echoed <= cfg.read_fresh_ticks:
                    read_evid[g, p] = now
            else:
                read_evid[g, p] = max(int(read_evid[g, p]), echoed)
        if h["read_veto"]:
            # Host detected a wall-clock tick gap: stored AND same-tick
            # lease evidence is untrustworthy (kernel applies the same
            # zeroing after the evidence store).
            read_evid[g, :] = 0

        # ---- 6c. CheckQuorum step-down (kernel phase 6c) ------------------
        # Any valid inbound RPC from p (term-independent) refreshes the
        # contact lane; the window anchors at election win and advances
        # when a due check passes.  A due leader without a voter-quorum
        # of fresh contact steps down — phase 8b then drops its pending
        # lease reads and zeroes read_evid via keep_reads.
        if has_qc:
            for p in range(P):
                if p == me or not active[g]:
                    continue
                if any(bool(ib[k][p, g]) for k in
                       ("ae_valid", "aer_valid", "rv_valid", "rvr_valid",
                        "is_valid", "isr_valid", "tn_valid")):
                    qc_heard[g, p] = now
            if vote_win:
                qc_since[g] = now
            cq_due = (active[g] and role[g] == LEADER
                      and now - int(qc_since[g]) >= cfg.election_ticks)
            if cq_due:
                flags = [p == me or int(qc_heard[g, p]) >= int(qc_since[g])
                         for p in range(P)]
                if _dual_quorum(flags, voters1, vnew1):
                    qc_since[g] = now
                else:
                    # Count the pending lease reads this step-down vetoes
                    # BEFORE 8b clears the FIFO.
                    info["cq_stepdown"][g] = True
                    info["cq_veto"][g] = sum(
                        int(rq_n[g, (int(rq_head[g]) + j) % K])
                        for j in range(int(rq_len[g])))
                    role[g] = FOLLOWER
                    leader_id[g] = NIL
                    elect_dl[g] = now + rand_to[g]

        # ---- 7. timers -----------------------------------------------------
        # (reference Follower.onTimeout:156-168, Candidate.onTimeout:82-88.)
        start_pre = False
        timer_cand = False
        # Only voters campaign (§6; kernel phase 7 gate on C1).
        if (active[g] and now >= elect_dl[g] and role[g] != LEADER
                and voter_self):
            if cfg.pre_vote:
                if role[g] in (FOLLOWER, PRE_CANDIDATE):
                    start_pre = True
                elif role[g] == CANDIDATE:
                    timer_cand = True
            else:
                timer_cand = True
        # TimeoutNow (§3.10): immediate candidacy, skipping PreVote.
        tn_cand = (active[g] and role[g] != LEADER and voter_self
                   and any(ib["tn_valid"][p, g]
                           and int(ib["tn_term"][p, g]) == term[g]
                           for p in range(P) if p != me))
        if tn_cand:
            start_pre = False
            timer_cand = True
        if timer_cand:
            term[g] += 1
            voted[g] = me
            role[g] = CANDIDATE
            leader_id[g] = NIL
            votes[g] = False
            votes[g, me] = True
            elect_dl[g] = now + rand_to[g]
        elif start_pre:
            role[g] = PRE_CANDIDATE
            leader_id[g] = NIL
            prevotes[g] = False
            prevotes[g, me] = True
            elect_dl[g] = now + rand_to[g]
        became_cand = become_cand_pv or timer_cand
        last_term_v = log.term_at(log.last)

        # ---- 7b. leadership-transfer intake/abort (kernel phase 7b) -------
        pend0 = int(xfer_to[g]) != NIL
        keep_x = (pend0 and active[g] and role[g] == LEADER
                  and term[g] == old_term[g] and now < int(xfer_dl[g]))
        info["xfer_abort"][g] = pend0 and not keep_x
        if not keep_x:
            xfer_to[g], xfer_dl[g] = NIL, 0
        tgt = int(h["xfer_target"][g])
        tgt_voter = 0 <= tgt < P and ((voters1 | vnew1) >> tgt) & 1
        if (active[g] and role[g] == LEADER and int(xfer_to[g]) == NIL
                and tgt_voter and tgt != me):
            xfer_to[g] = tgt
            xfer_dl[g] = now + cfg.election_ticks
        fenced = int(xfer_to[g]) != NIL

        # ---- 8. client submissions ----------------------------------------
        # (reference RaftStub.submit -> Leader.acceptCommand:128-140; a
        # pending leadership transfer fences intake.)
        info["submit_start"][g] = log.last + 1
        n_acc = 0
        if active[g] and role[g] == LEADER and not fenced:
            free = L - (log.last - log.base)
            n_acc = max(0, min(int(h["submit_n"][g]), min(free, S)))
        if n_acc > 0:
            if app_from == 0:
                app_from = log.last + 1
            for k in range(n_acc):
                log.ring[(log.last + 1 + k) % L] = term[g]
                log.cring[(log.last + 1 + k) % L] = 0
            log.last += n_acc
            app_to = log.last
        info["submit_acc"][g] = n_acc

        # ---- 8b. linearizable read plane: intake + barrier release --------
        # (kernel phase 8b: stamp an offered batch with the current commit,
        # release pending batches FIFO once a majority's barrier evidence
        # postdates their stamp — mirrors ops/quorum.read_barrier_release.)
        keep_reads = (active[g] and role[g] == LEADER
                      and term[g] == old_term[g])
        info["read_abort"][g] = int(rq_len[g]) > 0 and not keep_reads
        if not keep_reads:
            rq_head[g] = 0
            rq_len[g] = 0
            read_evid[g, :] = 0
        n_read = 0
        if (keep_reads and commit[g] >= own_from_a[g]
                and int(rq_len[g]) < K):
            n_read = max(0, int(h["read_n"][g]))
        if n_read > 0:
            slot = (int(rq_head[g]) + int(rq_len[g])) % K
            rq_idx[g, slot] = commit[g]
            rq_stamp[g, slot] = now
            rq_n[g, slot] = n_read
            rq_len[g] += 1
            info["read_index"][g] = commit[g]
        info["read_acc"][g] = n_read
        n_rel, n_served = 0, 0
        for j in range(int(rq_len[g])):
            slot = (int(rq_head[g]) + j) % K
            flags = [p == me or int(read_evid[g, p]) >= int(rq_stamp[g, slot])
                     for p in range(P)]
            if not _dual_quorum(flags, voters1, vnew1):
                break   # FIFO: an unreleasable batch blocks younger ones
            n_rel += 1
            n_served += int(rq_n[g, slot])
        rq_head[g] = (int(rq_head[g]) + n_rel) % K
        rq_len[g] -= n_rel
        info["read_rel"][g] = n_rel
        info["read_served"][g] = n_served
        info["read_lease"][g] = (n_read > 0 and n_rel > 0
                                 and int(rq_len[g]) == 0)
        read_kick = n_read > 0 and int(rq_len[g]) > 0

        # ---- 8c. membership-change intake + automatic joint leave ---------
        # (kernel phase 8c: one config entry per request — joint when the
        # voter set moves — one change in flight, C_new leave appended
        # automatically once the joint entry commits.)
        full_bits = (1 << P) - 1
        hv = int(h["conf_voters"][g]) & full_bits
        hl = int(h["conf_learners"][g]) & full_bits & ~hv
        joint1 = vnew1 != 0
        pending1 = cidx1 > commit[g]
        may_append = (active[g] and role[g] == LEADER and not pending1
                      and log.last - log.base < L)
        enter_word = int(conf_pack(voters1, 0, hl) if hv == voters1
                         else conf_pack(voters1, hv, hl))
        want_enter = (may_append and not joint1 and not fenced
                      and hv != 0 and enter_word != w1)
        want_leave = may_append and joint1
        conf_app = want_enter or want_leave
        app_word = int(conf_pack(vnew1, 0, lrn1)) if want_leave \
            else enter_word
        if conf_app:
            nidx = log.last + 1
            log.ring[nidx % L] = term[g]
            log.cring[nidx % L] = app_word
            log.last = nidx
            info["conf_app_idx"][g] = nidx
            info["conf_app_term"][g] = term[g]
            info["conf_app_word"][g] = app_word
            if app_from == 0:
                app_from = nidx
            app_to = log.last
            cidx2, w2 = nidx, app_word
        else:
            cidx2, w2 = cidx1, w1
        voters2, vnew2 = conf_voters_of(w2), conf_new_of(w2)
        lrn2 = conf_learners_of(w2)
        member2 = voters2 | vnew2 | lrn2

        # ---- 9. replication fan-out ---------------------------------------
        # (reference Leader.replicateLog:142-245 + prepareElection fan-out;
        # pipelined up to inflight_limit batches, Leadership.java:10-11;
        # fan-out gated to MEMBER slots of the active config.)
        heartbeat = role[g] == LEADER and (now >= hb_due[g] or read_kick)
        if active[g] and role[g] == LEADER:
            for p in range(P):
                if p == me or not (member2 >> p) & 1:
                    continue
                # RPC timeout — the only failure evidence, anchored to our
                # own last occupying send (see kernel phase 9; reference
                # statFailure, Leadership.java:65-73).
                timed_out = (inflight[g, p] + hb_inflight[g, p] > 0
                             and now - sent_at[g, p] >= cfg.rpc_timeout_ticks)
                if timed_out:
                    fail_streak[g, p] += 1
                    fail_at[g, p] = now
                    send_next[g, p] = next_idx[g, p]
                    inflight[g, p] = 0
                    hb_inflight[g, p] = 0
                has_data = (log.last >= send_next[g, p]
                            and not need_snap[g, p])
                can_send = (inflight[g, p] + hb_inflight[g, p]
                            < cfg.inflight_limit)
                send_data = not need_snap[g, p] and has_data and can_send
                # Heartbeats flow on the cadence regardless of window state
                # (slot-exempt when full; reference heartbeat budget
                # division, Leader.java:162).
                send_hb = (not need_snap[g, p] and heartbeat
                           and not send_data)
                hb_occupy = send_hb and can_send
                send_is_win = (need_snap[g, p]
                               and inflight[g, p] + hb_inflight[g, p] == 0)
                send_is = send_is_win or (need_snap[g, p] and heartbeat)
                if send_data or send_hb:
                    n_send = (min(B, log.last - send_next[g, p] + 1)
                              if send_data else 0)
                    prev = int(send_next[g, p]) - 1
                    out["ae_valid"][p, g] = True
                    out["ae_term"][p, g] = term[g]
                    out["ae_prev_idx"][p, g] = prev
                    # prev term via batch semantics (<= base -> base_term).
                    out["ae_prev_term"][p, g] = (
                        log.base_term if prev <= log.base
                        else (log.ring[prev % L] if prev <= log.last else -1))
                    out["ae_commit"][p, g] = commit[g]
                    out["ae_n"][p, g] = n_send
                    out["ae_tick"][p, g] = now
                    for k in range(B):
                        idx = int(send_next[g, p]) + k
                        out["ae_ents"][p, g, k] = (
                            log.base_term if idx <= log.base
                            else (log.ring[idx % L] if idx <= log.last
                                  else -1))
                        out["ae_cents"][p, g, k] = log.conf_at(idx)
                    send_next[g, p] += n_send
                elif send_is:
                    out["is_valid"][p, g] = True
                    out["is_term"][p, g] = term[g]
                    out["is_idx"][p, g] = log.base
                    out["is_last_term"][p, g] = log.base_term
                    out["is_probe"][p, g] = not send_is_win
                    out["is_conf"][p, g] = log.base_conf
                # Data batches and first snapshot offers occupy data
                # slots, in-window heartbeats occupy heartbeat slots; any
                # occupying send refreshes the send clock.
                if send_data or send_is_win:
                    inflight[g, p] += 1
                if hb_occupy:
                    hb_inflight[g, p] += 1
                if send_data or send_is_win or hb_occupy:
                    sent_at[g, p] = now
        if heartbeat:
            hb_due[g] = now + cfg.heartbeat_ticks

        # Leader readiness (reference Leader.isReady, Leader.java:52-64),
        # as a masked quorum over the active config; self counts iff self
        # is a voter; a pending transfer reports not-ready.
        flags = []
        for p in range(P):
            if p == me:
                flags.append(True)
                continue
            hp = (active[g] and role[g] == LEADER
                  and bool((member2 >> p) & 1)
                  and ok_at[g, p] > 0 and not need_snap[g, p])
            if cfg.avail_crit > 0:
                hp = hp and fail_streak[g, p] <= cfg.avail_crit
            if cfg.recovery_ticks > 0:
                hp = hp and (fail_at[g, p] == 0
                             or now - fail_at[g, p] >= cfg.recovery_ticks)
            flags.append(bool(hp))
        info["ready"][g] = (active[g] and role[g] == LEADER and not fenced
                            and _dual_quorum(flags, voters2, vnew2))

        # TimeoutNow dispatch (kernel: after readiness, pre-commit match).
        xt = int(xfer_to[g])
        fire = (active[g] and role[g] == LEADER and xt != NIL
                and int(match_idx[g, xt]) >= log.last)
        info["xfer_fired"][g] = fire
        if fire:
            out["tn_valid"][xt, g] = True
            out["tn_term"][xt, g] = term[g]

        if active[g] and (became_cand or start_pre):
            for p in range(P):
                if p == me or not ((voters2 | vnew2) >> p) & 1:
                    continue
                out["rv_valid"][p, g] = True
                out["rv_term"][p, g] = term[g] + 1 if start_pre else term[g]
                out["rv_last_idx"][p, g] = log.last
                out["rv_last_term"][p, g] = last_term_v
                out["rv_prevote"][p, g] = start_pre

        # ---- 10. commit advance -------------------------------------------
        # (reference Leadership.majorIndices:116-130 + the own-term rule,
        # Leader.tryCommit:256-261.)
        full = match_idx[g].copy()
        full[me] = log.last

        def _stat(mask: int) -> int:
            # ops/quorum.masked_order_stat, scalar: non-members sort as
            # -1 below every real match; the statistic sits at
            # P - (popcount//2 + 1) of the ascending order.
            vals = sorted(int(full[p]) if (mask >> p) & 1 else -1
                          for p in range(P))
            pos = min(max(P - (_popcount(mask) // 2 + 1), 0), P - 1)
            return vals[pos]

        quorum_idx = _stat(voters2)
        if vnew2:
            # Joint config: a commit needs a quorum in BOTH sets (§6).
            quorum_idx = min(quorum_idx, _stat(vnew2))
        voter_rows = [int(full[p]) for p in range(P)
                      if ((voters2 | vnew2) >> p) & 1]
        full_idx = min(voter_rows) if voter_rows else (1 << 31) - 1
        # Own-term rule via own_from (terms monotone along the log; set at
        # election win) — mirrors ops/quorum.py exactly.
        if (active[g] and role[g] == LEADER and quorum_idx > commit[g]
                and quorum_idx >= own_from_a[g]
                and quorum_idx <= log.last):
            commit[g] = quorum_idx
        # Full-replication lane (reference Leader.java:260, mirrors
        # ops/quorum.py): min over VOTER slots commits without the
        # own-term fence — identical on every voter, hence on every
        # possible future leader; learner lag never stalls it.
        if (active[g] and role[g] == LEADER and full_idx > commit[g]
                and full_idx <= log.last):
            commit[g] = full_idx
        match_idx[g] = full

        # §6 epilogue (kernel post-phase-10): a leader removed by its
        # committed simple config resigns.
        if (active[g] and role[g] == LEADER and vnew2 == 0
                and cidx2 <= commit[g] and not (voters2 >> me) & 1):
            role[g] = FOLLOWER
            leader_id[g] = NIL
            elect_dl[g] = now + rand_to[g]

        info["conf_word"][g] = w2
        info["conf_idx"][g] = cidx2
        info["conf_pending"][g] = cidx2 > commit[g]
        conf_idx_st[g], conf_word_st[g] = cidx2, w2

        # ---- 11. flight recorder ------------------------------------------
        # (kernel trailing block: same masks, same canonical order, same
        # ring-overwrite semantics.  All records carry the end-of-tick
        # term; TR_CRASH_RESTART is emitted by types.crash_restart.)
        if has_trace and active[g]:
            def tr_emit(mask, kind, aux):
                if not mask:
                    return
                slot = int(tr_n[g]) % D
                tr_tick[g, slot] = now
                tr_kind[g, slot] = kind
                tr_term[g, slot] = term[g]
                tr_aux[g, slot] = aux
                tr_n[g] += 1

            tr_emit(term[g] != old_term[g], TR_TERM_BUMP, old_term[g])
            tr_emit(old_role[g] == LEADER and role[g] != LEADER,
                    TR_STEPPED_DOWN, leader_id[g])
            tr_emit(start_pre, TR_BECAME_PRE_CANDIDATE, 0)
            # Candidacy cause: 0 prevote / 1 timer / 2 TimeoutNow.
            tr_emit(became_cand, TR_BECAME_CANDIDATE,
                    (2 if tn_cand else 1) if timer_cand else 0)
            tr_emit(vote_win, TR_BECAME_LEADER, info["noop_idx"][g])
            tr_emit(snap_inst, TR_SNAPSHOT_INSTALL, h["snap_idx"][g])
            tr_emit(commit[g] > old_commit[g], TR_COMMIT_ADVANCE, commit[g])
            tr_emit(n_rel > 0, TR_READ_RELEASE, n_served)
            tr_emit(w2 != w0 or cidx2 != cidx0, TR_CONF_CHANGE_ENTER, w2)
            tr_emit(cidx2 > 0 and old_commit[g] < cidx2 <= commit[g],
                    TR_CONF_CHANGE_COMMIT, cidx2)
            tr_emit(fire, TR_LEADER_TRANSFER, xfer_to[g])

        ring[g] = log.ring
        cring[g] = log.cring
        base[g], base_term[g], last[g] = log.base, log.base_term, log.last
        base_conf[g] = log.base_conf
        info["dirty"][g] = (term[g] != old_term[g] or voted[g] != old_voted[g]
                            or last[g] != old_last[g] or app_to > 0)
        info["appended_from"][g] = app_from
        info["appended_to"][g] = app_to
        info["log_tail"][g] = log.last
        info["commit"][g] = commit[g]
        info["leader"][g] = leader_id[g]

        # ---- 12. heat lanes -----------------------------------------------
        # (kernel trailing block: per-group cumulative activity.  By the
        # end of this iteration every out[...][:, g] column is final, so
        # the sent count matches the kernel's sum over the outbox valid
        # planes exactly.)
        if has_heat:
            sent_n = 0
            for k in ("ae_valid", "aer_valid", "rv_valid", "rvr_valid",
                      "is_valid", "isr_valid", "tn_valid"):
                for p in range(P):
                    sent_n += int(out[k][p, g])
            ht_app[g] += (app_to - app_from + 1) if app_to > 0 else 0
            ht_sent[g] += sent_n
            ht_com[g] += int(commit[g]) - int(old_commit[g])
            ht_rd[g] += n_served

    new_state = {
        "node_id": np.asarray(me, np.int32),
        "now": np.asarray(now, np.int32),
        "rng": rng.numpy().astype(np.uint32),
        "active": active,
        "term": term.astype(np.int32),
        "role": role,
        "voted_for": voted,
        "leader_id": leader_id,
        "commit": commit,
        "applied": s["applied"],
        "log.term": ring, "log.conf": cring, "log.base": base,
        "log.base_term": base_term, "log.base_conf": base_conf,
        "log.last": last,
        "own_from": own_from_a.astype(np.int32),
        "next_idx": next_idx, "match_idx": match_idx,
        "send_next": send_next, "inflight": inflight,
        "hb_inflight": hb_inflight,
        "sent_at": sent_at, "need_snap": need_snap,
        "ok_at": ok_at, "fail_at": fail_at, "fail_streak": fail_streak,
        "votes": votes, "prevotes": prevotes,
        "elect_deadline": elect_dl, "hb_due": hb_due,
        "read_evid": read_evid,
        "rq_idx": rq_idx, "rq_stamp": rq_stamp, "rq_n": rq_n,
        "rq_head": rq_head, "rq_len": rq_len,
        "conf_idx": conf_idx_st, "conf_word": conf_word_st,
        "xfer_to": xfer_to, "xfer_dl": xfer_dl,
    }
    if has_trace:
        new_state.update({
            "trace.tick": tr_tick, "trace.kind": tr_kind,
            "trace.term": tr_term, "trace.aux": tr_aux, "trace.n": tr_n,
        })
    if has_heat:
        new_state.update({
            "heat.appended": ht_app, "heat.sent": ht_sent,
            "heat.commits": ht_com, "heat.reads": ht_rd,
        })
    if has_qc:
        new_state.update({"qc.heard": qc_heard, "qc.since": qc_since})
    return new_state, out, info
