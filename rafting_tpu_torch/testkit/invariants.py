"""Cluster-level Raft safety invariants, audited over cluster snapshots.

The port's own copy of the JAX package's ``ClusterChecker``
(``testkit/invariants.py``): the same invariants, the same decisions and
messages on the same snapshots, written with numpy array operations
instead of per-entry Python loops, so that one audit of a 100k-group ×
5-node cluster takes well under a second instead of minutes.

Checked (Raft §5.2-§5.4):

* **Election safety** — at most one leader per (group, term), across the
  whole history.
* **Log matching** — two nodes that hold an entry with the same (index,
  term) hold identical logs up to it (on the intersection of their live
  windows; :meth:`ClusterChecker.check_log_matching`).
* **Commit stability** — an entry committed at (index, term) is never
  seen committed with another term, and no node's commit frontier
  regresses (a crash-restarted node's volatile frontier may).
* **Term monotonicity** — per (node, group), the term never decreases.

Plus the transaction invariant, :func:`check_transfer_atomicity`, copied
from the reference word for word: the bank-transfer judgment over the
converged machines of the cross-group 2PC plane (balance conserved, no
lost, phantom or half-applied transfer, no stranded intent).

Snapshots are dicts of numpy arrays, as ``core.cluster.cluster_snapshot``
makes them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..core.cluster import cluster_snapshot  # noqa: F401 — audit currency
from ..core.types import LEADER


class InvariantViolation(AssertionError):
    pass


def check_transfer_atomicity(coordinator, participants: Dict[int, Any],
                             initial_total: Optional[int] = None,
                             key_prefix: str = "acct") -> dict:
    """The bank-transfer atomicity judgment over CONVERGED state.

    ``coordinator``: the coordinator group's machine (pass the current
    leader's — its ``txns`` dict is the replicated decision ledger).
    ``participants``: lane -> that participant group's (leader) machine.
    ``initial_total``: when given, the sum of numeric values under keys
    starting with ``key_prefix`` across all participants must equal it
    (balance conservation — a lost debit or phantom credit moves it).

    Raises :class:`InvariantViolation` on:

    * a LIVE intent on any participant — an in-doubt txn nobody
      resolved (call only after the deadline sweep had time to run);
    * a LOST transfer — the coordinator decided commit but a recorded
      participant has no commit in its done-ledger;
    * a HALF-APPLIED transfer — the coordinator decided abort (or never
      decided) yet some participant committed;
    * a PHANTOM — a participant applied a commit it never prepared
      (``commit-noop`` ledger entries, machine/kv_machine.py), or holds
      a commit for a txn the coordinator has no commit decision for;
    * a balance-sum mismatch when ``initial_total`` is given.

    Returns a report dict (committed/aborted/undecided counts, the
    balance sum) for artifacts."""
    for lane, m in participants.items():
        if m.intents:
            raise InvariantViolation(
                f"participant {lane}: {len(m.intents)} live intent(s) "
                f"{sorted(m.intents)} — in-doubt txns unresolved")
        for tid, done in m.txn_done.items():
            if done == "commit-noop":
                raise InvariantViolation(
                    f"participant {lane}: txn {tid} applied a commit it "
                    f"never prepared (phantom)")

    committed = aborted = undecided = 0
    decisions = coordinator.txns
    for tid, rec in decisions.items():
        d = rec["decision"]
        if d == "commit":
            committed += 1
            for lane in rec["parts"]:
                m = participants.get(lane)
                if m is not None and m.txn_done.get(tid) != "commit":
                    raise InvariantViolation(
                        f"LOST transfer {tid}: coordinator decided "
                        f"commit but participant {lane} recorded "
                        f"{m.txn_done.get(tid)!r}")
        elif d == "abort":
            aborted += 1
            for lane in rec["parts"]:
                m = participants.get(lane)
                if m is not None and m.txn_done.get(tid) == "commit":
                    raise InvariantViolation(
                        f"HALF-APPLIED transfer {tid}: decided abort "
                        f"but participant {lane} committed")
        else:
            undecided += 1

    for lane, m in participants.items():
        for tid, done in m.txn_done.items():
            if done == "commit":
                rec = decisions.get(tid)
                if rec is None or rec["decision"] != "commit":
                    raise InvariantViolation(
                        f"PHANTOM transfer {tid}: participant {lane} "
                        f"committed but the coordinator decided "
                        f"{rec['decision'] if rec else None!r}")

    total = 0
    for m in participants.values():
        for k, v in m.data.items():
            if k.startswith(key_prefix) and isinstance(v, (int, float)):
                total += v
    if initial_total is not None and total != initial_total:
        raise InvariantViolation(
            f"balance NOT conserved: sum over {key_prefix}* keys is "
            f"{total}, expected {initial_total}")
    return {"committed": committed, "aborted": aborted,
            "undecided": undecided, "balance_total": total,
            "participants": len(participants)}


def _grow(a: np.ndarray, cols: int, fill) -> np.ndarray:
    out = np.full((a.shape[0], cols), fill, a.dtype)
    out[:, :a.shape[1]] = a
    return out


class ClusterChecker:
    """Audits a sequence of cluster snapshots.

    The history lives in arrays: ``_lead[g, term]`` is the node seen
    leading group g at that term (-1 none), and the committed-entry
    ledger is a per-group ring keyed by ``index % W`` (``_led_idx`` holds
    the index, 0 for an empty slot, ``_led_term`` its term).  The ledger
    forgets entries at or below every node's compaction floor: the floor
    is durable and never moves back, so no later audit can look them up
    (an audit that does raises, since the floor then regressed).  ``W``
    grows to cover every group's span of auditable indices, so the ring
    never holds two indices in one slot.
    """

    def __init__(self, cfg):
        self.cfg = cfg
        self.max_commit = None   # [N, G] per-node committed frontier
        self.max_term = None     # [N, G]
        self._lead = None        # [G, T] int8
        self._led_idx = None     # [G, W] int32
        self._led_term = None    # [G, W] int32
        self._floor = None       # [G] entries at or below are forgotten

    # -- the history, as the JAX checker's dicts ---------------------------
    @property
    def leaders(self) -> Dict[Tuple[int, int], int]:
        """(group, term) -> node seen leading it."""
        if self._lead is None:
            return {}
        gs, ts = np.nonzero(self._lead >= 0)
        return {(int(g), int(t)): int(self._lead[g, t])
                for g, t in zip(gs, ts)}

    @property
    def committed_terms(self) -> Dict[Tuple[int, int], int]:
        """(group, index) -> committed term, for the indices still
        auditable (above every node's compaction floor)."""
        if self._led_idx is None:
            return {}
        gs, ws = np.nonzero(self._led_idx > 0)
        return {(int(g), int(self._led_idx[g, w])): int(self._led_term[g, w])
                for g, w in zip(gs, ws)}

    # -- audits -------------------------------------------------------------
    def check(self, snap: dict, crashed=None) -> None:
        """snap: dict of numpy arrays from ``cluster_snapshot``.

        ``crashed``: optional [N] bool — nodes that crash-restarted since
        the previous check.  commitIndex is volatile (the engine restarts
        it at the compaction floor), so a crashed node's frontier may
        regress; everything durable stays strict."""
        role, term = snap["role"], snap["term"]
        commit, last = snap["commit"], snap["last"]
        base, log_term = snap["base"], snap["log_term"]
        L = log_term.shape[-1]

        window = last - base
        if (window > L).any():
            n, g = np.argwhere(window > L)[0]
            raise InvariantViolation(
                f"log window exceeds ring: node {n} group {g}: "
                f"({base[n, g]}, {last[n, g]}] > {L} slots")

        if self.max_term is not None and (term < self.max_term).any():
            n, g = np.argwhere(term < self.max_term)[0]
            raise InvariantViolation(
                f"term regressed on node {n} group {g}: "
                f"{self.max_term[n, g]} -> {term[n, g]}")
        self.max_term = term.copy() if self.max_term is None \
            else np.maximum(self.max_term, term)

        self._check_leaders(role, term)

        if self.max_commit is not None and crashed is not None:
            self.max_commit[np.asarray(crashed, bool)] = 0
        if self.max_commit is not None and (commit < self.max_commit).any():
            n, g = np.argwhere(commit < self.max_commit)[0]
            raise InvariantViolation(
                f"commit regressed on node {n} group {g}: "
                f"{self.max_commit[n, g]} -> {commit[n, g]}")
        self.max_commit = commit.copy() if self.max_commit is None \
            else np.maximum(self.max_commit, commit)

        self._check_committed(commit, last, base, log_term)

    def _check_leaders(self, role, term) -> None:
        lead = role == LEADER
        if not lead.any():
            return
        G = role.shape[1]
        need = int(term[lead].max()) + 1
        if self._lead is None:
            self._lead = np.full((G, max(need, 64)), -1, np.int8)
        elif need > self._lead.shape[1]:
            self._lead = _grow(self._lead, max(need, 2 * self._lead.shape[1]),
                               -1)
        # Node by node, in the order the reference visits leader lanes.
        for n in range(role.shape[0]):
            gs = np.nonzero(lead[n])[0]
            ts = term[n, gs]
            prev = self._lead[gs, ts]
            bad = (prev >= 0) & (prev != n)
            if bad.any():
                k = int(np.argmax(bad))
                raise InvariantViolation(
                    f"two leaders for group {gs[k]} term {ts[k]}: "
                    f"nodes {prev[k]} and {n}")
            self._lead[gs, ts] = n

    def _check_committed(self, commit, last, base, log_term) -> None:
        N, G = commit.shape
        L = log_term.shape[-1]
        lo = np.maximum(base + 1, 1)                               # [N, G]
        hi = np.minimum(commit, last)
        K = max(int((hi - lo + 1).max()), 0)                       # <= L
        idx = lo[..., None] + np.arange(K)                         # [N, G, K]
        live = idx <= hi[..., None]
        terms = np.take_along_axis(log_term, idx % L, axis=-1)
        floor = base.min(axis=0)                                   # [G]
        if self._floor is not None:
            back = live & (idx <= self._floor[None, :, None])
            if back.any():
                n, g, k = np.argwhere(back)[0]
                raise InvariantViolation(
                    f"compaction floor regressed: node {n} group {g} "
                    f"audits index {idx[n, g, k]} at or below the floor "
                    f"{self._floor[g]} every node had passed")
            floor = np.maximum(floor, self._floor)
        self._floor = floor

        top = np.where(live, idx, 0).max(axis=(0, 2)) if K else \
            np.zeros(G, np.int64)
        if self._led_idx is None:
            W = 2 * L
            self._led_idx = np.zeros((G, W), np.int32)
            self._led_term = np.zeros((G, W), np.int32)
        self._led_idx[self._led_idx <= floor[:, None]] = 0
        span = int((np.maximum(top, self._led_idx.max(axis=1))
                    - floor).max())
        W = self._led_idx.shape[1]
        if span > W:
            W = 1 << (span - 1).bit_length()
            gs, ws = np.nonzero(self._led_idx > 0)
            ids = self._led_idx[gs, ws]
            new_idx = np.zeros((G, W), np.int32)
            new_term = np.zeros((G, W), np.int32)
            new_idx[gs, ids % W] = ids
            new_term[gs, ids % W] = self._led_term[gs, ws]
            self._led_idx, self._led_term = new_idx, new_term

        # Node by node, so that within one audit the lowest node's term
        # is the one later nodes are held to, as in the reference.
        # A row's K indices are consecutive and K <= L <= W, so they fall
        # in distinct ring slots.
        slot = idx % W                                             # [N, G, K]
        found = []
        for n in range(N):
            have = np.take_along_axis(self._led_idx, slot[n], axis=1) \
                == idx[n]
            prev = np.take_along_axis(self._led_term, slot[n], axis=1)
            bad = live[n] & have & (prev != terms[n])
            if bad.any():
                g, k = np.argwhere(bad)[0]
                found.append((int(g), n, int(idx[n, g, k]), int(prev[g, k]),
                              int(terms[n, g, k])))
            new = live[n] & ~have
            np.put_along_axis(
                self._led_idx, slot[n],
                np.where(new, idx[n], np.take_along_axis(
                    self._led_idx, slot[n], axis=1)), axis=1)
            np.put_along_axis(self._led_term, slot[n],
                              np.where(new, terms[n], prev), axis=1)
        if found:
            g, n, i, prev, t = min(found)
            raise InvariantViolation(
                f"committed entry changed: group {g} index {i}: "
                f"term {prev} vs {t} (node {n})")

    def check_log_matching(self, snap: dict) -> None:
        """Pairwise log-matching audit: for every pair of nodes, below the
        highest index where their live windows hold the same term, every
        shared index must hold the same term."""
        last, base, log_term = snap["last"], snap["base"], snap["log_term"]
        N, G = last.shape
        L = log_term.shape[-1]
        found = []
        for a in range(N):
            for b in range(a + 1, N):
                lo = np.maximum(base[a], base[b]) + 1              # [G]
                hi = np.minimum(last[a], last[b])
                K = max(int((hi - lo + 1).max()), 0)
                if K == 0:
                    continue
                idx = lo[:, None] + np.arange(K)                   # [G, K]
                live = idx <= hi[:, None]
                ta = np.take_along_axis(log_term[a], idx % L, axis=1)
                tb = np.take_along_axis(log_term[b], idx % L, axis=1)
                same = live & (ta == tb)
                match_at = np.where(same, idx, -1).max(axis=1)     # [G]
                bad = live & (idx < match_at[:, None]) & (ta != tb)
                if bad.any():
                    g = int(np.nonzero(bad.any(axis=1))[0][0])
                    k = int(np.argmax(bad[g]))
                    found.append((g, a, b, int(match_at[g]), int(idx[g, k]),
                                  int(ta[g, k]), int(tb[g, k])))
        if found:
            g, a, b, m, i, ta, tb = min(found)
            raise InvariantViolation(
                f"log matching violated: group {g} nodes {a}/{b} share "
                f"({m}) but differ at {i}: {ta} vs {tb}")
