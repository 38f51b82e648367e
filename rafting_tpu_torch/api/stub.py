"""RaftStub: the user-facing client handle for one group.

Submit a command, get a future (or block with ``execute``); rejected with a
redirect hint when this node isn't the leader.  Handles are refcounted by
the container so closing the last one releases the cache slot (reference
command/RaftStub.java:47-110, RaftContainer.getStub:92-111)."""

from __future__ import annotations

import random
import threading
import time as _time
from concurrent.futures import Future, TimeoutError as _FutTimeout
from typing import Any, Optional, Union

from .anomaly import (
    LeadershipEvacuatedError, NotLeaderError, ObsoleteContextError,
    OverloadError, RaftError, WaitTimeoutError, as_refusal, evac_target_of,
    is_refusal, retry_after_of, wire_refusal,
)
from .retry import BreakerBoard, CircuitBreaker, RetryBudget


class RaftStub:
    def __init__(self, container, name: str, lane: int, forward: bool = True,
                 forward_budget: float = 20.0, max_redirects: int = 16,
                 tenant: Optional[str] = None,
                 retry_budget: Optional[RetryBudget] = None,
                 breakers: Optional[BreakerBoard] = None):
        """``forward=True`` relays submissions to the current leader over
        the transport when this node is a follower, instead of bouncing
        NotLeader back to the caller (the reference only returns the hint,
        support/anomaly/NotLeaderException.java:11-27).  Commands and
        forwarded results travel through the node's CmdSerializer
        (api/serial.py; JSON by default — plug RawSerializer or your own
        for arbitrary result types, the reference CmdSerializer contract,
        support/serial/CmdSerializer.java:11-24).

        ``forward_budget``: overall retry deadline (seconds) for chasing
        leader hints when no explicit per-call timeout is given;
        ``execute(timeout=...)`` overrides it per call, and every
        per-attempt wait is capped by the remaining budget — worst-case
        caller latency is the budget, not budget + a trailing attempt.

        ``max_redirects``: hard cap on refusal-driven retries inside one
        forwarded call.  During an election a command (or read) can
        ping-pong between ex-leaders whose hints point at each other —
        each hop a fresh NotLeader — and a purely time-bounded loop burns
        the whole budget doing it.  After this many redirects the last
        refusal surfaces to the caller even with budget left.  Retries
        back off exponentially with +/-50% jitter (decorrelating the
        thundering herd of callers all chasing the same election), or by
        the server's explicit retry-after hint when the refusal carries
        one (OverloadError / BusyLoopError, api/anomaly.py).

        Self-protection (the client half of the overload-control plane,
        ISSUE 15): ``tenant`` labels this stub's traffic for the server's
        per-tenant fair shedding; ``retry_budget`` is the token bucket
        capping refusal-driven retries at ~10% of fresh traffic (shared
        container-wide by default — retry pressure is a process-level
        property); ``breakers`` is the per-peer circuit-breaker board
        (also container-shared: a dead peer is dead for every stub).
        When the budget is spent or a peer's breaker is open, refusals
        surface to the caller immediately instead of amplifying the
        overload they report (api/retry.py)."""
        self._container = container
        self.name = name
        self._lane = lane
        self.forward = forward
        self.forward_budget = forward_budget
        self.max_redirects = max_redirects
        self.tenant = tenant
        self._budget = retry_budget if retry_budget is not None \
            else self._shared(container, "_retry_budget", RetryBudget)
        self._breakers = breakers if breakers is not None \
            else self._shared(container, "_breaker_board", BreakerBoard)
        self._closed = False
        # Client-history recording (testkit/history.py): None = off, and
        # the blocking paths pay exactly ONE is-None test — same contract
        # as the node's latency tracer (tests/test_hotpath_lint.py).
        self._history = None

    @staticmethod
    def _shared(container, attr: str, factory):
        """Container-wide singleton (budget / breaker board).  A create
        race between two stubs is benign — one instance wins, the loser
        was never observed."""
        obj = getattr(container, attr, None)
        if obj is None:
            try:
                obj = factory()
                setattr(container, attr, obj)
            except AttributeError:   # container with __slots__ / frozen
                return factory()
        return obj

    @property
    def lane(self) -> int:
        """Resolved per use: after a destroy/re-open cycle the NAME may map
        to a different lane, and a cached stub must never route commands
        into another group's log."""
        cur = self._container._lookup(self.name)
        if cur is None:
            raise ObsoleteContextError(f"group {self.name!r} not open")
        self._lane = cur
        return cur

    def submit(self, command: Union[bytes, str],
               timeout: Optional[float] = None) -> Future:
        """Async submit (reference RaftStub.submit -> Promise,
        command/RaftStub.java:65-74).  The future resolves with the state
        machine's apply result, or NotLeaderError with a redirect hint.
        ``timeout`` (when given) bounds the forward-retry budget for this
        call; it does NOT bound how long the returned future may pend.

        At-most-once per call: if a LOCAL submit is accepted and later
        aborted by a leadership change, it is NOT auto-forwarded — the
        command may still commit under the new leader, and resubmitting
        would double-apply it.  Only submissions that never entered the
        local log are forwarded."""
        if self._closed:
            raise ObsoleteContextError(f"stub for {self.name!r} closed")
        node = self._container._node
        payload = node.serializer.encode_command(command)
        self._budget.deposit()   # fresh traffic funds future retries
        if node.is_leader(self.lane) or not self.forward:
            fut = node.submit(self.lane, payload, tenant=self.tenant)
            # A MARKED refusal provably never entered the log, so retrying
            # through the forward path is safe for every TRANSIENT kind —
            # NotLeader (leadership moved between our check and the
            # node's), NotReady (the fresh leader's majority-health gate
            # hasn't opened yet; it lapses transiently right after an
            # election), BusyLoop (queue pressure).  The marker is
            # required — an accept-then-abort race can complete the future
            # with an UNMARKED NotLeaderError for a command that may still
            # commit (api/anomaly.py as_refusal).
            exc = fut.exception() if fut.done() else None
            if (self.forward and exc is not None and is_refusal(exc)
                    and type(exc).__name__ in self._TRANSIENT_REFUSALS):
                return self._forwarded(payload, timeout)
            return fut
        return self._forwarded(payload, timeout)

    def read(self, query: Union[bytes, str],
             timeout: Optional[float] = None) -> Future:
        """Async linearizable read (the read plane, core/step.py phase 8b):
        resolves with the state machine's ``read(query)`` result WITHOUT
        appending to the log — the leader stamps a ReadIndex and serves
        once a quorum confirms its leadership and the apply frontier
        covers the stamp.  Queries travel through the same CmdSerializer
        as commands.  Reads never enter any log, so every failure is a
        marked retry-safe refusal; with ``forward=True`` a non-leader stub
        relays the read to the leader (bounded by ``forward_budget`` /
        ``max_redirects``, like submit)."""
        if self._closed:
            raise ObsoleteContextError(f"stub for {self.name!r} closed")
        node = self._container._node
        payload = node.serializer.encode_command(query)
        self._budget.deposit()
        if node.is_leader(self.lane) or not self.forward:
            fut = node.read(self.lane, payload, tenant=self.tenant)
            exc = fut.exception() if fut.done() else None
            if (self.forward and exc is not None and is_refusal(exc)
                    and type(exc).__name__ in self._TRANSIENT_REFUSALS):
                return self._forwarded(payload, timeout, read=True)
            return fut
        return self._forwarded(payload, timeout, read=True)

    def read_batch(self, queries) -> Future:
        """Many linearizable queries under ONE ReadIndex barrier (one
        future resolving to the list of results in order) — the batch
        amortization the read plane exists for.  Leader-local only: a
        non-leader stub's batch fails NotLeader (forward the individual
        reads or redirect the batch by hint).  No timeout parameter on
        purpose: the batch is never forwarded, so there is no retry chase
        to bound — bound the wait on the FUTURE (``.result(timeout=…)``),
        as with submit."""
        if self._closed:
            raise ObsoleteContextError(f"stub for {self.name!r} closed")
        node = self._container._node
        enc = node.serializer.encode_command
        self._budget.deposit(len(queries))
        return node.read_batch(self.lane, [enc(q) for q in queries],
                               tenant=self.tenant)

    def txn(self, deadline_s: Optional[float] = None,
            timeout: Optional[float] = None):
        """Begin a CROSS-GROUP transaction with THIS stub's group as the
        replicated 2PC coordinator (runtime/txn.py).  Returns a
        :class:`~rafting_tpu.runtime.txn.TxnBuilder`: buffer ops against
        participant stubs (``.set/.add/.incr/.delete/.transfer``), then
        ``.execute()`` runs begin → prepare → decide → commit/abort on
        the calling thread.  Every 2PC message rides this stub machinery
        — leader forwarding, retry budgets, circuit breakers and
        redirect caps included — and admission sheds at the TXN level
        (a marked OverloadError before anything is written).

        ``deadline_s`` bounds each participant's write-intent: past it,
        participant leaders resolve the txn themselves by querying this
        coordinator group's decided log (presumed abort).  ``timeout``
        bounds the driver's whole flow (default: forward_budget)."""
        from ..runtime.txn import TxnBuilder

        if self._closed:
            raise ObsoleteContextError(f"stub for {self.name!r} closed")
        return TxnBuilder(self, deadline_s=deadline_s, timeout=timeout)

    def attach_history(self, history, proc: str) -> "RaftStub":
        """Record this stub's blocking calls into ``history`` as client
        process ``proc`` (testkit/history.py invoke/ok/fail/info; the
        chaos plane's workload driver turns this on, production code
        never pays more than the is-None check)."""
        from ..testkit.history import StubRecorder
        self._history = StubRecorder(history, proc)
        return self

    def execute_read(self, query: Union[bytes, str],
                     timeout: Optional[float] = None) -> Any:
        """Blocking linearizable read (the read-plane sibling of
        :meth:`execute`); ``timeout`` bounds the whole call including any
        forward-retry chase."""
        if self._history is not None:
            return self._history.execute_read(self, query, timeout)
        return self._execute_read(query, timeout)

    def _execute_read(self, query: Union[bytes, str],
                      timeout: Optional[float] = None) -> Any:
        tr = getattr(self._container._node, "_lat", None)
        t0 = _time.perf_counter() if tr is not None else 0.0
        fut = self.read(query, timeout=timeout)
        try:
            result = fut.result(timeout=timeout)
        except _FutTimeout:
            raise WaitTimeoutError(
                f"read on {self.name!r} not served in {timeout}s")
        if tr is not None:
            # Client-perceived wall time — queueing, ReadIndex barrier
            # and any forward chase included (utils/latency.py parks the
            # sample in this thread's ring; the tick thread merges it).
            tr.observe_client(_time.perf_counter() - t0, read=True)
        return result

    # Pre-log refusals are identified by the as_refusal marker set at
    # their creation sites (api/anomaly.py) — never by exception type or
    # future-completion timing: a step-down abort of an ACCEPTED command
    # also raises NotLeaderError and must NOT be retried (it may still
    # commit cluster-wide; the standard Raft at-most-once contract).
    # Remote refusals carry the marker as the serve side's REFUSED: wire
    # prefix.  Among refusals, only these TYPES are transient enough to
    # retry — an ObsoleteContextError (group destroyed) is a refusal too,
    # but retrying it for the whole budget is futile.  OverloadError
    # (admission shed) and UnavailableError (quarantined stripe) are
    # transient FROM THE CLUSTER'S view — the shed clears / a healthy
    # replica takes over — but both count against the peer's circuit
    # breaker so a persistently refusing node gets routed around.
    # LeadershipEvacuatedError is listed EXPLICITLY even though it
    # subclasses NotLeaderError — membership here is by type NAME, not
    # isinstance, so the subclass would silently fall through to the
    # permanent-refusal path otherwise.  It is routing chatter (a
    # deliberate healthy hand-off), NOT _PEER_SICK.
    _TRANSIENT_REFUSALS = ("NotLeaderError", "NotReadyError",
                           "BusyLoopError", "OverloadError",
                           "UnavailableError", "LeadershipEvacuatedError")
    # Refusal kinds that mean the PEER is sick (breaker ``failure()``),
    # as opposed to healthy routing chatter (NotLeader/NotReady).
    _PEER_SICK = ("BusyLoopError", "OverloadError", "UnavailableError",
                  "StorageFaultError")

    def _forwarded(self, payload: bytes,
                   budget: Optional[float] = None,
                   read: bool = False) -> Future:
        """Relay to the leader from a worker thread (the forward channel is
        a blocking ephemeral connection).  Elections and readiness are
        transient: while the operation keeps being REFUSED (locally or by
        the remote serve side) without ever entering a log, re-resolve the
        hint and retry — but BOUNDED twice over: ``budget`` (default the
        stub's forward_budget) is the overall wall deadline, and
        ``max_redirects`` caps the refusal-driven retry COUNT, so an
        election whose ex-leaders hint at each other cannot ping-pong the
        call for the whole budget (reference clients chase
        NotLeaderException hints, support/anomaly/NotLeaderException.java:
        11-27 — with no cap at all).  Each retry backs off exponentially
        with +/-50% jitter to decorrelate competing callers.  ``read``
        routes through node.read / transport.forward_read (the read
        plane) instead of submit."""
        node = self._container._node
        lane = self.lane
        out: Future = Future()
        total = self.forward_budget if budget is None else budget
        what = "read" if read else "command"

        def run():
            import time as _time
            overall = _time.monotonic() + total
            retries = 0
            # One-shot redirect from a LeadershipEvacuated refusal: the
            # refusing node NAMED the peer it handed the group to, which
            # beats the leader-hint mirror while the fleet re-points.
            hint_override: Optional[int] = None

            def left() -> float:
                # Per-attempt cap: never let one blocking wait overrun the
                # overall deadline (a fixed 30s attempt made worst-case
                # latency ~budget + 30s).  Floor keeps a just-expiring
                # budget from turning into a zero-timeout busy loop.
                return max(0.05, overall - _time.monotonic())

            def backoff(last_refusal: Exception) -> None:
                # Count + sleep for ONE refusal-driven retry.  Raises the
                # refusal once any bound trips: redirect cap, wall
                # deadline, or the shared RETRY BUDGET — a drained bucket
                # means the fleet is already refusing at scale, and the
                # anti-amplification move is to surface the refusal NOW
                # rather than add retry load (api/retry.py).  Sleep
                # honors the server's retry-after hint when the refusal
                # carries one (jittered UP only — retrying before the
                # server's window cannot see a different decision), else
                # jittered exponential (0.05s doubling, capped at 0.5s).
                nonlocal retries, hint_override
                tgt = evac_target_of(last_refusal)
                if tgt is not None and tgt != node.node_id:
                    hint_override = tgt
                retries += 1
                if retries > self.max_redirects:
                    raise last_refusal
                if _time.monotonic() >= overall:
                    raise last_refusal
                if not self._budget.try_spend():
                    raise last_refusal
                ra = retry_after_of(last_refusal)
                if ra is not None and ra > 0:
                    delay = ra * random.uniform(1.0, 1.5)
                else:
                    delay = (min(0.5, 0.05 * (2 ** min(retries, 4)))
                             * random.uniform(0.5, 1.5))
                _time.sleep(min(delay, left()))

            try:
                tenant = self.tenant
                if read:
                    def local_op(g, p):
                        return node.read(g, p, tenant=tenant)
                else:
                    def local_op(g, p):
                        return node.submit(g, p, tenant=tenant)
                remote_op = (node.transport.forward_read if read
                             else node.transport.forward_submit)
                while True:
                    # Resolve a target: ourselves if leadership landed
                    # here, else the current hint.
                    while True:
                        if node.is_leader(lane):
                            fut = local_op(lane, payload)
                            exc = fut.exception() if fut.done() else None
                            if (exc is not None and is_refusal(exc)
                                    and type(exc).__name__
                                    in self._TRANSIENT_REFUSALS):
                                # Marked pre-log refusal: never entered
                                # the log — keep resolving (same
                                # treatment as a remote REFUSED reply).
                                backoff(exc)
                                continue
                            # Accepted (or pending): wait for the result.
                            # A MARKED transient refusal raised later
                            # (the queued-but-never-accepted rejection
                            # sweep on leadership loss) is still
                            # retry-safe — keep resolving.  Any UNMARKED
                            # failure surfaces: an abort after acceptance
                            # may still commit cluster-wide.
                            try:
                                out.set_result(fut.result(timeout=left()))
                                return
                            except _FutTimeout:
                                # Accepted but not resolved inside the
                                # budget: the command may still commit —
                                # report the timeout, never resubmit.
                                raise WaitTimeoutError(
                                    f"forwarded {what} on {self.name!r} "
                                    f"not resolved in {total}s")
                            except Exception as e:
                                if (is_refusal(e) and type(e).__name__
                                        in self._TRANSIENT_REFUSALS):
                                    backoff(e)
                                    continue
                                raise
                        hint, hint_override = (
                            hint_override if hint_override is not None
                            else node.leader_hint(lane), None)
                        if hint is not None and hint != node.node_id:
                            break
                        backoff(NotLeaderError(lane, None))
                    br = self._breakers.get(hint)
                    if not br.allow():
                        # Circuit open: don't even connect.  Back off by
                        # the breaker's own cooldown hint, then re-resolve
                        # the target — leadership may have moved off the
                        # sick peer in the meantime.
                        backoff(as_refusal(OverloadError(
                            f"peer {hint}: circuit open",
                            retry_after_s=br.retry_after_s())))
                        continue
                    try:
                        ok, raw = remote_op(hint, self.lane, payload,
                                            timeout=left())
                    except Exception:
                        br.failure()   # transport error: peer unreachable
                        raise
                    if ok:
                        br.success()
                        out.set_result(node.serializer.decode_result(raw))
                        return
                    msg = raw.decode(errors="replace")
                    parts = msg.split(":", 2)
                    kind = parts[1] if len(parts) > 1 else ""
                    detail = parts[2] if len(parts) > 2 else msg
                    if msg.startswith("REFUSED:"):
                        # The peer answered: overload / storage refusals
                        # count against its breaker, routing chatter
                        # (NotLeader/NotReady) proves it healthy.
                        if kind in self._PEER_SICK:
                            br.failure()
                        else:
                            br.success()
                        if kind == "NotLeaderError":
                            exc: Exception = NotLeaderError(lane, hint)
                        elif kind == "LeadershipEvacuatedError":
                            # Rebuild with the lane in hand (wire_refusal
                            # has no group context) — backoff() chases
                            # the embedded [target=N] marker directly.
                            exc = LeadershipEvacuatedError(
                                lane, hint, target=evac_target_of(detail))
                        else:
                            exc = wire_refusal(kind, detail)
                        if kind in self._TRANSIENT_REFUSALS:
                            backoff(exc)
                            continue
                        # Permanent refusal (ObsoleteContext, plain
                        # StorageFault): surface the rebuilt TYPE
                        # immediately, matching the local-submit branch.
                        raise exc
                    br.failure()
                    raise RaftError(f"forward failed: {msg}")
            except Exception as e:
                if not out.done():
                    out.set_exception(e)
        threading.Thread(target=run, daemon=True,
                         name=f"raft-fwd-{self.name}").start()
        return out


    def change_membership(self, voters: int, learners: int = 0,
                          timeout: Optional[float] = None) -> Future:
        """Reconfigure this group to the TARGET config (§6 joint
        consensus; voters/learners are peer-slot bitmasks).  Leader-local
        when possible; with ``forward=True`` a non-leader stub relays the
        op to the leader over the FWD_CONF channel, chasing NotLeader
        hints like submit (bounded by forward_budget / max_redirects).
        Resolves once the final config is active and committed."""
        from ..transport.codec import CONF_OP_CHANGE

        return self._membership_op(CONF_OP_CHANGE, int(voters),
                                   int(learners), timeout,
                                   lambda node, lane: node.change_membership(
                                       lane, voters, learners))

    def transfer_leadership(self, target: int,
                            timeout: Optional[float] = None) -> Future:
        """Hand this group's leadership to voter ``target`` (§3.10
        TimeoutNow).  Forwarded to the current leader when this node is a
        follower; resolves once the old leader relinquished after
        TimeoutNow."""
        from ..transport.codec import CONF_OP_TRANSFER

        return self._membership_op(CONF_OP_TRANSFER, int(target), 0,
                                   timeout,
                                   lambda node, lane:
                                   node.transfer_leadership(lane, target))

    def _membership_op(self, op: int, a: int, b: int,
                       budget: Optional[float], local_call) -> Future:
        """Shared leader-resolution loop for membership ops: run locally
        when leading, else relay over FWD_CONF — same refusal-chasing
        contract as _forwarded, on the membership channel."""
        import json as _json
        import time as _time

        if self._closed:
            raise ObsoleteContextError(f"stub for {self.name!r} closed")
        node = self._container._node
        lane = self.lane
        if node.is_leader(lane) or not self.forward:
            return local_call(node, lane)
        out: Future = Future()
        total = self.forward_budget if budget is None else budget

        def run():
            overall = _time.monotonic() + total
            retries = 0
            try:
                while True:
                    left = max(0.05, overall - _time.monotonic())
                    if node.is_leader(lane):
                        fut = local_call(node, lane)
                        out.set_result(fut.result(timeout=left))
                        return
                    hint = node.leader_hint(lane)
                    if hint is not None and hint != node.node_id:
                        ok, raw = node.transport.forward_conf(
                            hint, lane, op, a, b, timeout=left)
                        if ok:
                            out.set_result(_json.loads(raw))
                            return
                        msg = raw.decode(errors="replace")
                        kind = msg.split(":", 2)[1] if ":" in msg else ""
                        if not (msg.startswith("REFUSED:")
                                and kind in self._TRANSIENT_REFUSALS):
                            raise RaftError(f"membership forward failed: "
                                            f"{msg}")
                    retries += 1
                    if retries > self.max_redirects \
                            or _time.monotonic() >= overall:
                        raise NotLeaderError(lane, node.leader_hint(lane))
                    _time.sleep(min(0.5, 0.05 * (2 ** min(retries, 4)))
                                * random.uniform(0.5, 1.5))
            except Exception as e:
                if not out.done():
                    out.set_exception(e)
        threading.Thread(target=run, daemon=True,
                         name=f"raft-conf-{self.name}").start()
        return out

    def execute(self, command: Union[bytes, str],
                timeout: Optional[float] = None) -> Any:
        """Blocking submit (reference RaftStub.execute,
        command/RaftStub.java:47-58).  ``timeout`` bounds the whole call,
        INCLUDING any forward-retry chase (the per-call budget the
        advisor's r4 finding asked for).

        Retry duplicate-safety (the at-most-once contract, see submit):
        when execute raises an UNMARKED error or a WaitTimeoutError the
        outcome is UNKNOWN — the command may still commit.  A caller
        that resubmits after such an error can double-apply; only a
        MARKED refusal (api/anomaly.py is_refusal) proves the first
        attempt never entered a log and makes a retry safe.  With
        history recording attached, unknown outcomes are recorded as
        ``info`` (never ok/fail) so the linearizability checker accepts
        either world — committed or not — while a true duplicate apply
        still surfaces as a non-linearizable read."""
        if self._history is not None:
            return self._history.execute(self, command, timeout)
        return self._execute(command, timeout)

    def _execute(self, command: Union[bytes, str],
                 timeout: Optional[float] = None) -> Any:
        tr = getattr(self._container._node, "_lat", None)
        t0 = _time.perf_counter() if tr is not None else 0.0
        fut = self.submit(command, timeout=timeout)
        try:
            result = fut.result(timeout=timeout)
        except _FutTimeout:
            raise WaitTimeoutError(
                f"command on {self.name!r} not committed in {timeout}s")
        if tr is not None:
            # Client-perceived wall time — queueing, commit/apply wait
            # and any forward chase included (sample parks in this
            # thread's ring; the tick thread merges it at harvest).
            tr.observe_client(_time.perf_counter() - t0)
        return result

    @property
    def leader_hint(self) -> Optional[int]:
        return self._container._node.leader_hint(self.lane)

    def is_leader(self) -> bool:
        return self._container._node.is_leader(self.lane)

    def close(self) -> None:
        """Release one reference; the shared handle only goes dead when the
        LAST holder closes (refcount semantics, reference getStub:92-111)."""
        if not self._closed:
            remaining = self._container._release_stub(self.name)
            if remaining == 0:
                self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
