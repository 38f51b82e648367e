"""ApplyDispatcher: drives state machines from the device commit frontier.

The vectorized analog of the reference's apply loop
(RaftRoutine.commitState/applyEntry/applyCommand,
context/RaftRoutine.java:224-306): after each device tick the runtime
hands the dispatcher the committed-index frontier for all groups; the
dispatcher applies any newly committed entries in order, completes client
promises, and reports apply progress (fed back to the device `applied`
lanes and into the snapshot maintain policy).

Halt/resume mirrors the restore dance (RaftRoutine.restoreCheckpoint
commitVersion CAS MACHINE_HALT, context/RaftRoutine.java:482-541): while a
group's snapshot is being installed its applies are frozen, then resumed
at the recovered frontier.
"""

from __future__ import annotations

import bisect
import logging
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

import numpy as np

from .spi import MachineProvider, RaftMachine
from ..utils.latency import APPLIED as _APPLIED

log = logging.getLogger(__name__)


class _SingleSink:
    """Adapts a plain Future to the promise-sink protocol (the
    ``register_promise`` compatibility path and internal single-command
    promises): ``_complete(k, result)`` / ``_fail(err)``."""

    __slots__ = ("fut",)

    def __init__(self, fut: Future):
        self.fut = fut

    def _complete(self, k: int, result) -> None:
        if not self.fut.done():
            self.fut.set_result(result)

    def _fail(self, err: Exception) -> None:
        if not self.fut.done():
            self.fut.set_exception(err)


class _Range:
    """One registered promise range: entries [start, start+n) of a group
    map to sink slots [k0, k0+n).  Mutated in place as applies consume the
    prefix (ranges only ever shrink from the front — applies are
    contiguous — or get failed wholesale)."""

    __slots__ = ("start", "n", "sink", "k0")

    def __init__(self, start: int, n: int, sink, k0: int):
        self.start = start
        self.n = n
        self.sink = sink
        self.k0 = k0


class ApplyDispatcher:
    def __init__(self, provider: MachineProvider, payload_fn,
                 on_applied: Optional[Callable[[int, int], None]] = None,
                 payload_window_fn=None, payload_runs_fn=None):
        """payload_fn(group, index) -> bytes | None (usually LogStore.payload).
        payload_window_fn(group, start, n) -> [bytes|None]: batched variant
        (LogStore.payloads_window) — the apply loop fetches each group's
        newly committed window in one call when provided.
        payload_runs_fn(group, start, n) -> (pieces, lens) | None: the
        arena variant (LogStore.payload_runs) feeding machines that
        implement ``apply_run`` with buffer slices — zero per-entry
        materialization on the apply hot path.

        on_applied(group, new_last_applied): progress hook (maintain policy).
        """
        self._provider = provider
        self._payload = payload_fn
        self._payload_window = payload_window_fn
        self._payload_runs = payload_runs_fn
        self._machines: Dict[int, RaftMachine] = {}
        self._halted: Dict[int, bool] = {}
        # Promises keyed group -> sorted list of _Range records: a whole
        # accepted client BATCH registers as ONE range (start, n, sink)
        # instead of n dict entries — promise bookkeeping cost per tick is
        # O(ranges touched), not O(entries) (the per-entry Future dict was
        # ~15% of the durable tick at 32k groups).  The apply loop skips
        # bookkeeping entirely for groups with none registered (every
        # group on a follower node), and abort scans one group's list.
        self._promises: Dict[int, List[_Range]] = {}
        self._on_applied = on_applied
        self._retry_counts: Dict[tuple, int] = {}
        # Empty-payload (election no-op) guard: machines that do not set
        # ``applies_empty = True`` (machine/spi.py) never see empty
        # payloads — the dispatcher skips them and records the highest
        # skipped index per group here, so the apply frontier keeps
        # advancing past no-ops the machine's own last_applied cannot
        # cover.  Invariant: _skip_hi[g], when present, is an index the
        # dispatcher fully processed (applied or skipped) up to.
        self._skip_hi: Dict[int, int] = {}
        self._warned_empty: set = set()
        # Per-group short-circuit tally behind the warning above — the
        # runtime surfaces the sum as the ``empty_apply_skips`` gauge so
        # a lagging last_applied stays diagnosable after the once-per-
        # class log line scrolled away.  Keyed by group so the striped
        # workers' disjoint masks never race an increment.
        self._empty_skip_n: Dict[int, int] = {}
        # Numpy mirror of every machine's last_applied: advance() visits
        # only lanes whose commit frontier moved past it, so per-tick cost
        # scales with progress, not with total group count (VERDICT r1 #8).
        # Lazily sized from the first commit array; always <= the machine's
        # true last_applied is the invariant that makes skipping safe.
        self._applied_arr: Optional[np.ndarray] = None

    @property
    def empty_skips(self) -> int:
        """Total election no-ops short-circuited for machines without the
        ``applies_empty`` opt-in (machine/spi.py) — surfaced by the
        runtime as the ``empty_apply_skips`` gauge."""
        return sum(self._empty_skip_n.values())

    def _applied_mirror(self, n: int) -> np.ndarray:
        a = self._applied_arr
        if a is None or len(a) < n:
            a = np.zeros(n, np.int64)
            for g, m in self._machines.items():
                if g < n:
                    a[g] = m.last_applied()
            self._applied_arr = a
        return a

    def machine(self, g: int) -> RaftMachine:
        m = self._machines.get(g)
        if m is None:
            m = self._machines[g] = self._provider.bootstrap(g)
            if self._applied_arr is not None and g < len(self._applied_arr):
                self._applied_arr[g] = m.last_applied()
        return m

    def applied(self, g: int) -> int:
        return self.machine(g).last_applied()

    # -- client promises ----------------------------------------------------

    def register_promise(self, g: int, index: int, fut: Future) -> None:
        """A client command was accepted at (g, index); complete its future
        with the apply result (reference: RaftContext promise map keyed by
        EntryKey, context/RaftContext.java:223-237)."""
        self.register_promise_range(g, index, 1, _SingleSink(fut), 0)

    def register_promise_range(self, g: int, start: int, n: int,
                               sink, k0: int) -> None:
        """Register a whole accepted span in one record: entries
        [start, start+n) complete sink slots [k0, k0+n).  ``sink`` speaks
        ``_complete(k, result)`` / ``_fail(err)`` (BatchSubmit / _SingleSink).
        Ranges are kept sorted by start; within one leadership accepts are
        monotonic so the common case is an append."""
        lst = self._promises.setdefault(g, [])
        r = _Range(start, n, sink, k0)
        if lst and lst[-1].start >= start:
            bisect.insort(lst, r, key=lambda x: x.start)
        else:
            lst.append(r)

    def _complete_run(self, g: int, lo: int, results: list) -> None:
        """Entries [lo, lo+len(results)) applied with these results:
        complete every overlapping promise slot.  Ranges are contiguous
        and the apply frontier moves contiguously, so overlaps consume
        range PREFIXES; a consumed range is dropped, a partial one shrinks
        in place."""
        lst = self._promises.get(g)
        if not lst:
            return
        hi = lo + len(results) - 1
        keep: List[_Range] = []
        for r in lst:
            end = r.start + r.n - 1
            if end < lo or r.start > hi:
                keep.append(r)
                continue
            a, b = max(r.start, lo), min(end, hi)
            comp = r.sink._complete
            base_k = r.k0 + (a - r.start)
            base_r = a - lo
            sp = getattr(r.sink, "span", None)   # sampled lifecycle span
            if sp is not None and base_k <= sp.k <= base_k + (b - a):
                # Stamped BEFORE the completion loop: the batch's ack
                # stamp fires inside _complete when its last slot lands,
                # and applied must precede acked (utils/latency.py).
                sp.mark(_APPLIED)
            for j in range(b - a + 1):
                comp(base_k + j, results[base_r + j])
            if b < end:
                # suffix survives (apply stopped mid-range)
                taken = b - r.start + 1
                r.start += taken
                r.n -= taken
                r.k0 += taken
                keep.append(r)
            # a > r.start cannot leave a live prefix: applies are
            # contiguous from the frontier, so any slot below `a` was
            # already consumed (its range shrank past it).
        if keep:
            self._promises[g] = keep
        else:
            del self._promises[g]

    def _fail_span(self, g: int, lo: int, hi: int, err: Exception) -> None:
        """Entries in [lo, hi] can never deliver a result (snapshot jump /
        mid-batch apply divergence): fail their sinks.  A sink failed here
        reports which slots already completed (BatchAbortedError contract);
        slots above `hi` stay registered so later applies still record
        their results into the (already failed) batch — harmless, and it
        mirrors the old per-entry map, which also kept them."""
        lst = self._promises.get(g)
        if not lst:
            return
        keep: List[_Range] = []
        for r in lst:
            end = r.start + r.n - 1
            if end < lo or r.start > hi:
                keep.append(r)
                continue
            r.sink._fail(err)
            if end > hi:
                taken = hi - r.start + 1
                r.start += taken
                r.n -= taken
                r.k0 += taken
                keep.append(r)
        if keep:
            self._promises[g] = keep
        else:
            del self._promises[g]

    def abort_promises(self, g: int, err: Exception) -> None:
        """Leadership lost: fail outstanding promises (reference
        Leader ctor abortPromise, context/RaftContext.java:165-187)."""
        lst = self._promises.pop(g, None)
        if lst:
            for r in lst:
                r.sink._fail(err)

    # -- snapshot halt/resume ------------------------------------------------

    def halt(self, g: int) -> None:
        self._halted[g] = True

    def unhalt(self, g: int) -> None:
        """Abort a halt without a recover (failed install)."""
        self._halted[g] = False

    def drop_machine(self, g: int, destroy: bool = False) -> None:
        """Forget a group's machine (group closed/destroyed; reference
        destroyContext, context/ContextManager.java:139-167)."""
        m = self._machines.pop(g, None)
        if m is not None:
            (m.destroy if destroy else m.close)()
        self._halted.pop(g, None)
        self._skip_hi.pop(g, None)
        if self._applied_arr is not None and g < len(self._applied_arr):
            self._applied_arr[g] = 0
        for key in [k for k in self._retry_counts if k[0] == g]:
            del self._retry_counts[key]

    def resume_from(self, g: int, checkpoint) -> None:
        """Install a snapshot into the machine and resume applies.

        Promises at or below the checkpoint index can never be completed by
        an apply (the machine jumps over them), so they are aborted — their
        commands committed cluster-wide but the result is unobservable here.
        """
        self.machine(g).recover(checkpoint)
        if self._applied_arr is not None and g < len(self._applied_arr):
            self._applied_arr[g] = self.machine(g).last_applied()
        if self._skip_hi.get(g, 0) <= checkpoint.index:
            self._skip_hi.pop(g, None)
        self._fail_span(g, 0, checkpoint.index, RuntimeError(
            "entry applied via snapshot; result unavailable"))
        self._halted[g] = False

    # -- the apply loop -----------------------------------------------------

    def warm_mirror(self, n: int) -> None:
        """Materialize the applied-frontier mirror for ``n`` groups on the
        CALLING thread.  The striped host tier calls this once from the
        orchestrator before fanning ``advance`` out to stripe workers —
        lazy creation inside concurrent advance() calls would race the
        full-array build."""
        self._applied_mirror(n)

    def advance(self, commit: np.ndarray,
                groups: Optional[np.ndarray] = None,
                max_per_group: int = 0) -> None:
        """Apply newly committed entries.  `commit` is the [G] frontier;
        `groups` optionally restricts which lanes are live (active mask or
        index list).  `max_per_group` bounds work per call (0 = no bound).

        Stripe-sliced calls (striped host tier) pass a pre-sliced index
        view: disjoint group sets make concurrent advance() calls safe —
        every structure here (machines, promises, skip ledger, the mirror's
        per-element writes) is keyed or indexed by group.  An index list is
        intersected with the behind mask exactly like a bool mask, so a
        stripe view costs no applies for already-caught-up groups."""
        mirror = self._applied_mirror(len(commit))
        behind = commit > mirror[:len(commit)]
        if groups is None:
            gs = np.nonzero(behind)[0]
        elif groups.dtype == bool:
            gs = np.nonzero(groups & behind)[0]
        else:
            groups = np.asarray(groups, np.int64)
            gs = groups[behind[groups]]
        retries = self._retry_counts
        for g in gs:
            g = int(g)
            if self._halted.get(g):
                continue
            m = self.machine(g)
            apply_fn = m.apply
            applies_empty = bool(getattr(m, "applies_empty", False))
            has_promises = g in self._promises
            target = int(commit[g])
            before = m.last_applied()
            if not applies_empty:
                # Resume past no-ops this machine never saw (spi.py
                # empty-payload opt-out): the dispatcher's skip ledger
                # extends the machine's own frontier.
                sk = self._skip_hi.get(g, 0)
                if sk > before:
                    before = sk
            idx = before + 1
            hi = target if max_per_group <= 0 \
                else min(target, idx + max_per_group - 1)
            # Probe the first index before prefetching the window: a group
            # whose frontier is far ahead of its local store (snapshot
            # pending) must cost one lookup per tick, not one per missing
            # entry.  The probe's hit is cached, so no duplicate work.
            window = None
            results = None
            probe_ok = (hi >= idx and self._payload(g, idx) is not None)
            # Fastest path: an arena-capable machine (apply_run, SPI)
            # takes the whole window as buffer pieces — no per-entry
            # bytes anywhere (payload materialization for applies was
            # ~25% of the durable tick once staging went arena).
            run_fn = getattr(m, "apply_run", None)
            if probe_ok and run_fn is not None \
                    and self._payload_runs is not None:
                pr = self._payload_runs(g, idx, hi - idx + 1)
                if pr is not None and not applies_empty \
                        and (np.asarray(pr[1]) == 0).any():
                    # Window holds an election no-op the machine must not
                    # see: route through the windowed/per-entry paths,
                    # which skip it (spi.py applies_empty contract).
                    pr = None
                if pr is not None:
                    try:
                        results = run_fn(idx, pr[0], pr[1])
                    except Exception as e:
                        log.warning("apply_run failed g=%d idx=%d: %s "
                                    "(falling back)", g, idx, e)
                        # An empty result list (NOT None) routes through
                        # the shared resync block below: the machine may
                        # have applied a prefix before raising, and
                        # falling straight into apply_batch at the stale
                        # idx would re-apply it (double apply).
                        results = []
            # Fast path: machines exposing apply_batch (SPI, spi.py) take
            # the locally-available contiguous prefix in ONE call; a short
            # return (failed entry) falls through to the per-entry loop,
            # which retries it with full diagnostics.
            if results is None:
                if probe_ok and self._payload_window is not None:
                    window = self._payload_window(g, idx, hi - idx + 1)
                batch_fn = getattr(m, "apply_batch", None)
                if window is not None and batch_fn is not None:
                    n_have = 0
                    for p in window:
                        # Stop the batch at an election no-op the machine
                        # opted out of seeing; the per-entry loop below
                        # skips it and carries on.
                        if p is None or (not p and not applies_empty):
                            break
                        n_have += 1
                    if n_have:
                        try:
                            results = batch_fn(idx, window[:n_have])
                        except Exception as e:
                            # A raising batch apply must not kill the whole
                            # tick (the per-entry path catches and retries).
                            # The machine may have applied a prefix before
                            # raising: resync from its own frontier, then
                            # let the per-entry loop below retry the failing
                            # entry with full diagnostics.
                            log.warning("apply_batch failed g=%d idx=%d: %s "
                                        "(falling back to per-entry)",
                                        g, idx, e)
                            results = []
            if results is not None:
                if has_promises and results:
                    self._complete_run(g, idx, results)
                if retries:
                    for k in range(len(results)):
                        retries.pop((g, idx + k), None)
                idx += len(results)
                la = m.last_applied()
                if la >= idx:
                    # The machine advanced past the reported results
                    # (mid-batch failure after a partial apply, or a
                    # contract violation): those entries DID apply but
                    # their results are unobservable.  Their promises
                    # must not hang forever — fail them explicitly,
                    # like the snapshot-jump path (resume_from).
                    self._fail_span(g, idx, la, RuntimeError(
                        "entry applied; result unavailable"
                        " (batch apply failed mid-batch)"))
                    if retries:
                        for key in [k for k in retries
                                    if k[0] == g and idx <= k[1] <= la]:
                            del retries[key]
                    idx = la + 1
            while idx <= hi:
                payload = (window[idx - before - 1] if window is not None
                           else self._payload(g, idx))
                if payload is None:
                    # Frontier ahead of locally stored entries (e.g. device
                    # committed via snapshot milestone); the machine must
                    # catch up via recover, not apply.
                    break
                if not payload and not applies_empty:
                    # Election no-op (Raft §8) short-circuited for a
                    # machine without the spi.py opt-in: the machine never
                    # sees the empty command, the dispatcher's skip ledger
                    # carries the frontier over it, and any (unusual)
                    # client promise on an empty command completes None.
                    key = type(m).__name__
                    if key not in self._warned_empty:
                        self._warned_empty.add(key)
                        log.warning(
                            "machine %s (group %d) does not opt into "
                            "empty-payload applies (applies_empty=False); "
                            "short-circuiting election no-op at index %d "
                            "— set applies_empty=True on the machine to "
                            "receive empty commands (machine/spi.py)",
                            key, g, idx)
                    if has_promises:
                        self._complete_run(g, idx, [None])
                    self._skip_hi[g] = idx
                    self._empty_skip_n[g] = self._empty_skip_n.get(g, 0) + 1
                    idx += 1
                    continue
                try:
                    result = apply_fn(idx, payload)
                except Exception as e:
                    # Retry next round (reference RetryCommandException,
                    # RaftRoutine.java:288-300).  A deterministic failure
                    # freezes the group's apply frontier on purpose —
                    # skipping a committed entry would diverge replicas —
                    # but escalate so the operator sees a stuck group.
                    n = retries[(g, idx)] = retries.get((g, idx), 0) + 1
                    lvl = log.error if n in (10, 100) or n % 1000 == 0 \
                        else log.warning
                    lvl("apply failed g=%d idx=%d (attempt %d): %s",
                        g, idx, n, e)
                    break
                if retries:
                    retries.pop((g, idx), None)
                if has_promises:
                    self._complete_run(g, idx, [result])
                idx += 1
            # Mirror tracks true machine progress; on a payload gap or a
            # failed apply it simply stays behind and the lane is revisited
            # next tick.
            mirror[g] = idx - 1 if idx - 1 > before else before
            if self._on_applied is not None and idx - 1 > before:
                self._on_applied(g, idx - 1)

    def applied_frontier(self, n_groups: int) -> np.ndarray:
        out = np.zeros(n_groups, np.int32)
        a = self._applied_arr
        if a is not None and len(a) >= n_groups:
            return a[:n_groups].astype(np.int32)
        for g, m in self._machines.items():
            if g < n_groups:
                out[g] = m.last_applied()
        return out

    def close(self) -> None:
        for m in self._machines.values():
            m.close()
        self._machines.clear()
