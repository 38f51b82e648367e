"""Cross-group transactions: a replicated 2PC coordinator over Raft
groups (ROADMAP item 5; the hierarchical composition Fast Raft,
arXiv:2506.17793, argues for — consensus groups as building blocks
under a coordinator that is itself replicated).

Every workload before this plane stopped at a single Raft group.  This
module composes groups: an atomic multi-group write is driven as
classic two-phase commit where EVERY piece of protocol state lives in
some group's replicated log, so no component of the protocol is less
durable or less available than the groups it coordinates:

* **Participant state** — ``txn_prepare`` / ``txn_commit`` /
  ``txn_abort`` are ordinary log payloads in each participant group
  (machine/kv_machine.py buffers the prepared ops as a write-intent
  under key locks with a wall-clock deadline).  A participant's
  PREPARE ack therefore means *replicated*, not just received.
* **Coordinator state** — txn id allocation (``txn_begin``) and the
  COMMIT/ABORT decision (``txn_decide``, FIRST-WRITER-WINS) are
  replicated entries in whichever group the caller designates as the
  coordinator, so coordinator failover is just Raft leader failover:
  any replica of the coordinator group can answer "what was decided?"
  once elected.
* **The driver is disposable** — the client thread running
  :class:`TxnBuilder` holds NO authoritative state.  If it dies at the
  worst moment (all PREPAREs acked, decision not yet replicated), the
  intent deadlines expire and each participant group's LEADER resolves
  in-doubt txns off its tick loop (:meth:`TxnPlane.tick`): submit a
  presumed-abort ``txn_decide`` to the coordinator group (first writer
  wins — if the driver's commit got there first, the resolver learns
  COMMIT instead) and finalize locally with the winning decision.
  Every message is idempotent, so resolver races — with the driver,
  with other replicas' resolvers, with leadership changes mid-resolve
  — all converge on the single replicated decision.

Overload contract (the txn half of ISSUE 15): admission sheds at the
TRANSACTION level via :meth:`AdmissionController.admit_txn` — one
decision before ``txn_begin`` covering every entry the txn will write.
A refused txn has touched nothing (no id, no intent), so the refusal
is a MARKED pre-log ``OverloadError`` (api/anomaly.py) and trivially
retry-safe; a txn that passes the gate is never half-shed, because
shedding one participant's PREPARE mid-flight is exactly how intents
get stranded.  A bounded in-flight cap (``max_inflight``) backstops
the driver threads themselves.

Latency: each sampled txn (seeded stride, utils/latency.py) stamps
begin → prepared → decided → applied → acked into a
:class:`~rafting_tpu.utils.latency.TxnSpan`; phase histograms, e2e
p50/p99/p999 and the abort ratio land on /metrics and /latency.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..api.anomaly import OverloadError, as_refusal, is_refusal
from ..utils.latency import (
    T_ACKED, T_APPLIED, T_BEGIN, T_DECIDED, T_PREPARED,
)

__all__ = ["TxnPlane", "TxnBuilder", "TxnResult", "txn_plane_from_env"]


class TxnResult(dict):
    """The dict a committed/aborted txn resolves with (``txn``,
    ``decision``, plus diagnostics); attribute sugar for the two
    load-bearing keys."""

    @property
    def txn(self) -> str:
        return self["txn"]

    @property
    def decision(self) -> str:
        return self["decision"]

    @property
    def committed(self) -> bool:
        return self["decision"] == "commit"


class TxnPlane:
    """Per-node transaction-plane state: the in-flight gate the drivers
    check, the counters the tick thread folds into /metrics, and the
    deadline-expiry recovery sweep.

    Thread contract: :meth:`admit`/:meth:`release` and the counter
    bumps run on driver (client) threads — plain int bumps under the
    GIL, same style as AdmissionController.  :meth:`tick` runs on the
    node's tick thread only (it reads machines — the tick thread IS
    the machine single-writer — and folds counters).  Resolver threads
    touch nothing but node.submit / transport and the single-flight
    set (guarded by ``_rlock``)."""

    def __init__(self, max_inflight: int = 64, sweep_every: int = 32,
                 resolver_cap: int = 8, deadline_s: float = 5.0,
                 resolve_timeout_s: float = 10.0):
        self.max_inflight = int(max_inflight)
        self.sweep_every = max(1, int(sweep_every))
        self.resolver_cap = int(resolver_cap)
        self.deadline_s = float(deadline_s)
        self.resolve_timeout_s = float(resolve_timeout_s)
        # Driver-side counters (client threads, GIL-atomic bumps).
        self.committed = 0
        self.aborted = 0
        self.refused = 0         # txn-level shed / inflight cap
        self.unknown = 0         # decision outcome unknown to the driver
        self.inflight = 0
        self._gate = threading.Lock()
        # Recovery-side counters (resolver threads).
        self.resolved_commit = 0
        self.resolved_abort = 0
        self.resolve_retry = 0   # coordinator unreachable; next sweep
        self._rlock = threading.Lock()
        self._resolving: set = set()
        # Tick-thread state.
        self._tick_n = 0
        self._fold: Dict[str, int] = {}
        # Test hook: called between PREPARE-all-acked and the decision
        # submit (the coordinator crash window the recovery proof kills
        # leaders in).  Production: None, never consulted off tests.
        self.pause_after_prepare = None

    # ----------------------------------------------------- driver gate --

    def admit(self, node, n_ops: int, tenant: Optional[str]) -> None:
        """Txn-level admission: refuse BEFORE txn_begin (marked, retry-
        safe) or reserve one in-flight slot.  Raises OverloadError."""
        with self._gate:
            if self.inflight >= self.max_inflight:
                self.refused += 1
                raise as_refusal(OverloadError(
                    f"txn plane: {self.inflight} transactions in flight "
                    f"(cap {self.max_inflight})",
                    retry_after_s=node.admission.busy_retry_after()))
            ra = node.admission.admit_txn(n_ops, tenant)
            if ra is not None:
                self.refused += 1
                raise as_refusal(OverloadError(
                    "txn plane: admission shed (overload) — refused "
                    "before PREPARE, nothing was written",
                    retry_after_s=ra))
            self.inflight += 1

    def release(self) -> None:
        with self._gate:
            self.inflight -= 1

    # ------------------------------------------------------ tick thread --

    def tick(self, node) -> None:
        """Per-tick hook (runtime/node.py): fold counters into the
        metrics registry (delta-fold, same pattern as the admission
        fold) and run the deadline-expiry sweep every ``sweep_every``
        ticks."""
        self._tick_n += 1
        m = node.metrics
        last = self._fold
        for name, cur in (("txn_committed", self.committed),
                          ("txn_aborted", self.aborted),
                          ("txn_refused", self.refused),
                          ("txn_unknown", self.unknown),
                          ("txn_resolved_commit", self.resolved_commit),
                          ("txn_resolved_abort", self.resolved_abort),
                          ("txn_resolve_retry", self.resolve_retry)):
            d = cur - last.get(name, 0)
            if d:
                m[name] += d
                last[name] = cur
        m.gauge("txn_inflight", float(self.inflight))
        if self._tick_n % self.sweep_every == 0:
            self._sweep(node)

    def _sweep(self, node) -> None:
        """Find expired intents on groups THIS node leads and launch
        single-flight resolvers.  O(instantiated machines) per sweep —
        each probe is one attribute lookup plus an O(1) empty-dict test
        (machine/spi.py expired_intents contract), amortized over
        ``sweep_every`` ticks."""
        now = time.time()
        for g, machine in list(node.dispatcher._machines.items()):
            fn = getattr(machine, "expired_intents", None)
            if fn is None:
                continue
            expired = fn(now)
            if not expired or not node.is_leader(g):
                continue
            for rec in expired:
                key = (g, rec["txn"])
                with self._rlock:
                    if key in self._resolving \
                            or len(self._resolving) >= self.resolver_cap:
                        continue
                    self._resolving.add(key)
                threading.Thread(
                    target=self._resolve, daemon=True,
                    name=f"txn-resolve-{g}",
                    args=(node, g, rec["txn"], int(rec["coord"]))).start()

    # -------------------------------------------------- resolver threads --

    def _resolve(self, node, group: int, tid: str, coord: int) -> None:
        """In-doubt resolution for one expired intent: replicate a
        presumed-abort decision in the coordinator group (first writer
        wins — a decision already there is returned instead), then
        finalize this participant with the winner.  Failures leave the
        intent for the next sweep; every step is idempotent."""
        key = (group, tid)
        try:
            decision = self._coordinator_decision(node, coord, tid)
            if decision is None:
                self.resolve_retry += 1
                return
            op = "txn_commit" if decision == "commit" else "txn_abort"
            payload = node.serializer.encode_command(
                json.dumps({"op": op, "txn": tid}))
            node.submit(group, payload).result(
                timeout=self.resolve_timeout_s)
            if decision == "commit":
                self.resolved_commit += 1
            else:
                self.resolved_abort += 1
        except Exception:
            self.resolve_retry += 1
        finally:
            with self._rlock:
                self._resolving.discard(key)

    def _coordinator_decision(self, node, coord: int,
                              tid: str) -> Optional[str]:
        """Arbitrate via the coordinator group's replicated log: submit
        decide-abort; the machine's first-writer-wins rule returns the
        standing decision if one exists (presumed abort otherwise).
        None = coordinator group unreachable right now (retry later)."""
        if coord < 0:
            return "abort"   # no coordinator recorded: presumed abort
        payload = node.serializer.encode_command(json.dumps(
            {"op": "txn_decide", "txn": tid, "decision": "abort"}))
        try:
            if node.is_leader(coord):
                r = node.submit(coord, payload).result(
                    timeout=self.resolve_timeout_s)
            else:
                hint = node.leader_hint(coord)
                if hint is None or hint == node.node_id:
                    return None
                ok, raw = node.transport.forward_submit(
                    hint, coord, payload, timeout=self.resolve_timeout_s)
                if not ok:
                    return None
                r = node.serializer.decode_result(raw)
        except Exception:
            return None
        if isinstance(r, dict) and r.get("decision") in ("commit",
                                                         "abort"):
            return r["decision"]
        return None

    # ------------------------------------------------------------- views --

    def snapshot(self) -> dict:
        done = self.committed + self.aborted
        return {
            "inflight": self.inflight,
            "max_inflight": self.max_inflight,
            "committed": self.committed,
            "aborted": self.aborted,
            "refused": self.refused,
            "unknown": self.unknown,
            "abort_ratio": self.aborted / done if done else 0.0,
            "resolved_commit": self.resolved_commit,
            "resolved_abort": self.resolved_abort,
            "resolve_retry": self.resolve_retry,
            "deadline_s": self.deadline_s,
        }


def txn_plane_from_env() -> TxnPlane:
    """Build a node's plane from env knobs: ``RAFT_TXN_INFLIGHT``
    (driver cap, 64), ``RAFT_TXN_SWEEP_TICKS`` (sweep cadence, 32),
    ``RAFT_TXN_DEADLINE_S`` (default intent deadline, 5)."""
    import os

    def num(name: str, default: float) -> float:
        raw = os.environ.get(name, "").strip()
        try:
            return float(raw) if raw else default
        except ValueError:
            return default

    return TxnPlane(max_inflight=int(num("RAFT_TXN_INFLIGHT", 64)),
                    sweep_every=int(num("RAFT_TXN_SWEEP_TICKS", 32)),
                    deadline_s=num("RAFT_TXN_DEADLINE_S", 5.0))


class TxnBuilder:
    """The ``RaftStub.txn()`` handle: buffer ops against participant
    groups, then :meth:`execute` the 2PC flow on the calling thread.

    The stub it was built from designates the COORDINATOR group (its
    lane hosts the replicated txn ids and decisions); participants are
    named by other stubs on the same container (or group names, which
    are resolved through it).  All submits ride the ordinary stub
    machinery, so leader forwarding, retry budgets, circuit breakers
    and redirect caps (api/retry.py) apply to every 2PC message.

    At-most-once contract: a raised MARKED refusal (admission shed,
    inflight cap, a begin that never entered a log) means the txn
    provably did not happen — retry freely.  Any other raise means the
    outcome is UNKNOWN to this driver; the replicated decision (or its
    absence past the intent deadline) is the truth, and the recovery
    sweep finishes the job.  Never resubmit after an unmarked failure
    — poll the coordinator group's ``txn_status`` instead."""

    def __init__(self, coord, deadline_s: Optional[float] = None,
                 timeout: Optional[float] = None):
        self._coord = coord
        self._deadline_s = deadline_s
        self._timeout = timeout
        # name -> (stub, [op dicts]); insertion order = prepare order.
        self._parts: Dict[str, Tuple[Any, List[dict]]] = {}

    # ------------------------------------------------------ op builders --

    def _bucket(self, part) -> List[dict]:
        if isinstance(part, str):
            stub = self._part_stub(part)
        else:
            stub = part
        ent = self._parts.get(stub.name)
        if ent is None:
            ent = self._parts[stub.name] = (stub, [])
        return ent[1]

    def _part_stub(self, name: str):
        if name == self._coord.name:
            return self._coord
        container = self._coord._container
        lane = container._lookup(name)
        if lane is None:
            raise ValueError(f"unknown participant group {name!r}")
        return type(self._coord)(container, name, lane,
                                 tenant=self._coord.tenant)

    def set(self, part, k: str, v: Any) -> "TxnBuilder":
        self._bucket(part).append({"op": "set", "k": k, "v": v})
        return self

    def add(self, part, k: str, v: Any) -> "TxnBuilder":
        self._bucket(part).append({"op": "add", "k": k, "v": v})
        return self

    def incr(self, part, k: str, dv) -> "TxnBuilder":
        self._bucket(part).append({"op": "incr", "k": k, "v": dv})
        return self

    def delete(self, part, k: str) -> "TxnBuilder":
        self._bucket(part).append({"op": "del", "k": k})
        return self

    def transfer(self, src, src_key: str, dst, dst_key: str,
                 amount) -> "TxnBuilder":
        """The bank-transfer idiom: debit ``src_key`` on ``src``,
        credit ``dst_key`` on ``dst`` — atomic across both groups."""
        return self.incr(src, src_key, -amount).incr(dst, dst_key,
                                                     amount)

    # ---------------------------------------------------------- execute --

    def execute(self, timeout: Optional[float] = None) -> TxnResult:
        """Run the full 2PC flow, blocking: begin → prepare each
        participant → decide (commit iff every PREPARE acked) →
        finalize fan-out.  Returns a :class:`TxnResult` for BOTH clean
        outcomes — a decided abort (lock conflict, a failed prepare)
        is a result, not an exception."""
        if not self._parts:
            raise ValueError("empty transaction: add ops first")
        coord = self._coord
        node = coord._container._node   # may raise marked Unavailable
        plane = getattr(node, "txn", None)
        tr = getattr(node, "_lat", None)
        n_ops = sum(len(ops) for _s, ops in self._parts.values())
        total = timeout if timeout is not None else (
            self._timeout if self._timeout is not None
            else coord.forward_budget)
        overall = time.monotonic() + total

        def left() -> float:
            return max(0.1, overall - time.monotonic())

        def expired() -> bool:
            return time.monotonic() >= overall

        sp = None
        if tr is not None:
            seq = tr.next_seq_t()
            if tr.sampled(seq):
                sp = tr.make_txn_span(seq)
                if sp is not None:
                    sp.parts = len(self._parts)
        if plane is not None:
            try:
                plane.admit(node, n_ops, coord.tenant)
            except BaseException:
                if sp is not None:
                    tr.retire(sp, "refused")
                raise
        try:
            return self._run(node, plane, sp, tr, left, expired)
        finally:
            if plane is not None:
                plane.release()

    @staticmethod
    def _retry_exec(stub, cmd: dict, left, expired):
        """Submit an IDEMPOTENT per-tid 2PC message (decide / finalize
        retries are replay-safe by construction: first-writer-wins
        decisions, dup-acked prepares, ledgered finalizes), retrying
        past the failures the generic stub machinery must surface —
        a forward channel dying with the old leader, an election-window
        timeout.  The plain stub cannot retry those for arbitrary
        commands (unknown outcome = possible double-apply); the txn
        vocabulary can, so coordinator failover is survivable from the
        driver's seat.  Bounded by the driver's overall time budget."""
        while True:
            try:
                return stub.execute(json.dumps(cmd), timeout=left())
            except BaseException:
                if expired():
                    raise
                time.sleep(min(0.1, left()))

    def _run(self, node, plane, sp, tr, left, expired) -> TxnResult:
        coord = self._coord
        coord_lane = coord.lane
        deadline_s = self._deadline_s if self._deadline_s is not None \
            else (plane.deadline_s if plane is not None else 5.0)
        deadline = time.time() + deadline_s

        # 1. BEGIN: allocate the replicated txn id + participant set.
        begin = {"op": "txn_begin",
                 "parts": [s.lane for s, _o in self._parts.values()],
                 "deadline": deadline}
        try:
            b = coord.execute(json.dumps(begin), timeout=left())
            tid = b["txn"]
            if sp is not None:
                sp.tid = tid
        except BaseException as e:
            # Nothing prepared anywhere.  Marked refusal = provably no
            # id was allocated either; unknown = at worst an orphan
            # txn record with no decision and no intents (harmless —
            # presumed abort).
            self._retire(tr, sp, "refused" if is_refusal(e)
                         else "unknown")
            if plane is not None and not is_refusal(e):
                plane.unknown += 1
            raise

        # 2. PREPARE each participant (replicated write-intents).
        prepared_all = True
        reason = None
        attempted: List[Any] = []
        for name, (stub, ops) in self._parts.items():
            p = {"op": "txn_prepare", "txn": tid, "coord": coord_lane,
                 "deadline": deadline, "ops": ops}
            attempted.append(stub)
            try:
                r = stub.execute(json.dumps(p), timeout=left())
            except BaseException as e:
                # Marked refusal: this participant provably holds no
                # intent.  Unmarked/timeout: it MIGHT — either way the
                # decision below is abort, and the abort fan-out (or
                # the deadline sweep) clears whatever exists.
                prepared_all = False
                reason = f"prepare {name}: {type(e).__name__}"
                break
            if not r.get("prepared"):
                prepared_all = False
                reason = (f"prepare {name}: conflict on "
                          f"{r.get('conflict')!r}"
                          if "conflict" in r else
                          f"prepare {name}: {r}")
                break
        if sp is not None:
            sp.mark(T_PREPARED)

        if plane is not None and plane.pause_after_prepare is not None:
            # Coordinator crash-window hook (tests only): the proof
            # kills the coordinator group's leader right here —
            # PREPAREs replicated, decision not.
            plane.pause_after_prepare(tid, prepared_all)

        # 3. DECIDE in the coordinator group's log.  First-writer-wins:
        # the reply's decision is the truth even if a deadline resolver
        # beat us to an abort.
        want = "commit" if prepared_all else "abort"
        try:
            d = self._retry_exec(
                coord, {"op": "txn_decide", "txn": tid, "decision": want},
                left, expired)
            decision = d["decision"]
        except BaseException:
            # Outcome unknown: the decision may or may not have
            # replicated.  Do NOT finalize anything — participants
            # converge via the deadline sweep's coordinator query.
            self._retire(tr, sp, "unknown")
            if plane is not None:
                plane.unknown += 1
            raise
        if sp is not None:
            sp.mark(T_DECIDED)

        # 4. FINALIZE: fan the decision out to every participant we
        # touched.  Failures are non-fatal — the decision is already
        # replicated, so the sweep finishes delivery.
        fin = {"op": "txn_commit" if decision == "commit"
               else "txn_abort", "txn": tid}
        resolved_later = 0
        for stub in attempted if decision == "abort" \
                else [s for s, _o in self._parts.values()]:
            try:
                stub.execute(json.dumps(fin), timeout=left())
            except BaseException:
                resolved_later += 1
        if sp is not None:
            sp.mark(T_APPLIED)

        if plane is not None:
            if decision == "commit":
                plane.committed += 1
            else:
                plane.aborted += 1
        self._retire(tr, sp, decision)
        res = TxnResult(txn=tid, decision=decision,
                        parts=len(self._parts),
                        resolved_later=resolved_later)
        if reason is not None:
            res["reason"] = reason
        return res

    @staticmethod
    def _retire(tr, sp, outcome: str) -> None:
        if sp is not None:
            sp.mark(T_ACKED)
            tr.retire(sp, outcome)
