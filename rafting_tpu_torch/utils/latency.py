"""Per-entry commit-path latency tracing (the sampled span plane).

Every signal the runtime exported before this module was per-tick: the
stage histograms and the flight recorder measure what a *tick* costs,
never what one *command* experienced from submit to ack.  CD-Raft
(arXiv:2603.10555) and "Paxos vs Raft" (arXiv:2004.05074) both frame
consensus quality as end-to-end commit latency — and the ROADMAP's
"millions of users" claim is a p999 claim, so the runtime needs to know
where the microseconds go per entry, not per tick.

Design:

* **Sampling** is a seeded stride: submission seq ``s`` is sampled iff
  ``(s + seed % rate) % rate == 0`` (~1/rate of submits).  The sampled
  SET is a pure function of (seed, rate) — same seed, same set — and
  membership of a contiguous seq range [s0, s0+n) is O(1) arithmetic
  (``first_in``), so the 100k-group fan-out path never loops to decide.
  ``rate=0`` disables the plane entirely: the node holds no tracer and
  every hot-path hook is one attribute-is-None check.
* **Spans** stamp wall-clock marks through the commit path:
  ``submitted → offered → staged → fsynced → sent → committed →
  applied → acked`` (writes) and ``submitted → served`` (reads).  A
  span that dies before its ack — leadership loss, storage fault, lane
  close — retires with ``outcome-unknown`` (or ``refused`` for marked
  pre-log refusals) and contributes NO latency sample: a crashed span
  must never fabricate a latency.
* **Rings**: spans retire into per-thread ring buffers (client threads,
  stripe workers, the tick thread each own one deque; registration of
  a new ring takes the only lock in the retire path).  The tick thread
  merges rings at :meth:`harvest` and is the sole writer of the shared
  histograms — the registry keeps its single-writer contract (see
  utils/metrics.py) with W striped workers in play.
* **Admission** is bounded (``max_live``): the sampler's *selection* is
  deterministic, but at most ``max_live`` spans are in flight at once —
  overflow candidates are counted (``span_overflow``), not traced, so
  a 100k-group burst cannot turn the trace plane into the workload.

Histograms land in the node's Metrics registry as ``lat_<pair>_s``
per phase pair plus ``lat_e2e_s`` / ``lat_read_e2e_s`` end-to-end, so
/metrics exposition and /latency percentiles come from one source.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

# Phase indices (Span.t slots).
SUBMITTED, OFFERED, STAGED, FSYNCED, SENT, COMMITTED, APPLIED, ACKED, \
    SERVED = range(9)

PHASE_NAMES = ("submitted", "offered", "staged", "fsynced", "sent",
               "committed", "applied", "acked", "served")

# Adjacent phase pairs reported as histograms (writes).  Summing these
# medians ≈ the e2e median on an idle cluster (the reconciliation the
# acceptance criteria check).
PHASE_PAIRS = (
    ("submit_offer", SUBMITTED, OFFERED),
    ("offer_stage", OFFERED, STAGED),
    ("stage_fsync", STAGED, FSYNCED),
    ("fsync_send", FSYNCED, SENT),
    ("send_commit", SENT, COMMITTED),
    ("commit_apply", COMMITTED, APPLIED),
    ("apply_ack", APPLIED, ACKED),
)

# Transaction phase indices (TxnSpan.t slots) — the 2PC lifecycle the
# txn plane (runtime/txn.py) stamps per sampled transaction.
T_BEGIN, T_PREPARED, T_DECIDED, T_APPLIED, T_ACKED = range(5)

TXN_PHASE_NAMES = ("begin", "prepared", "decided", "applied", "acked")

TXN_PHASE_PAIRS = (
    ("begin_prepare", T_BEGIN, T_PREPARED),    # begin replicated + all
    #                                            participant PREPAREs acked
    ("prepare_decide", T_PREPARED, T_DECIDED),  # decision replicated in
    #                                            the coordinator group
    ("decide_apply", T_DECIDED, T_APPLIED),    # commit/abort fan-out
    ("apply_ack", T_APPLIED, T_ACKED),         # result handed to caller
)


class Span:
    """One sampled entry's lifecycle record.  Mutated by whichever
    thread reaches the stamp site; each slot has exactly one writer per
    lifecycle (the stamp sites are ordered by the commit protocol), so
    no locking — a torn read can only be observed by the harvester for
    an outcome-unknown span, which reports no latency anyway."""

    __slots__ = ("seq", "kind", "k", "group", "idx", "tick", "t",
                 "outcome", "tr")

    def __init__(self, seq: int, kind: str, k: int):
        self.seq = seq
        self.kind = kind          # "w" (write) | "r" (read)
        self.k = k                # entry offset within its batch
        self.group = -1
        self.idx = -1             # log index (writes; stamped at offer)
        self.tick = -1            # node tick at device accept — the
        #                           shared axis flight-recorder events
        #                           and worker-util intervals plot on
        self.t = [0.0] * 9
        self.outcome: Optional[str] = None   # None=in flight, "ok",
        #                                      "unknown", "refused"
        self.tr: Optional["LatencyTracer"] = None   # set by make_span —
        # completion sites (BatchSubmit sinks) retire via the span alone

    def mark(self, phase: int) -> None:
        if self.t[phase] == 0.0:
            self.t[phase] = time.perf_counter()

    def to_dict(self) -> dict:
        """Per-phase breakdown for /latency and save_dump meta: deltas
        from ``submitted`` (seconds), only for stamped phases."""
        t0 = self.t[SUBMITTED]
        phases = {PHASE_NAMES[i]: round(self.t[i] - t0, 9)
                  for i in range(1, 9) if self.t[i] > 0.0}
        return {"seq": self.seq, "kind": self.kind, "group": self.group,
                "idx": self.idx, "k": self.k, "tick": self.tick,
                "outcome": self.outcome or "in-flight", "phases": phases}


class TxnSpan:
    """One sampled cross-group transaction's 2PC lifecycle record
    (begin → prepared → decided → applied → acked).  Stamped by the
    driving client thread only (runtime/txn.py runs the whole 2PC flow
    on the caller's thread), retired into that thread's ring like any
    Span — the tick thread folds it at harvest.  Outcomes: ``commit`` /
    ``abort`` (clean decisions — both contribute latency samples),
    ``refused`` (txn-level admission shed, pre-PREPARE), ``unknown``
    (coordinator unreachable mid-flight; resolved later by recovery)."""

    __slots__ = ("seq", "tid", "parts", "t", "outcome", "tr")

    def __init__(self, seq: int):
        self.seq = seq
        self.tid = ""
        self.parts = 0            # participant count
        self.t = [0.0] * 5
        self.outcome: Optional[str] = None
        self.tr: Optional["LatencyTracer"] = None

    def mark(self, phase: int) -> None:
        if self.t[phase] == 0.0:
            self.t[phase] = time.perf_counter()

    def to_dict(self) -> dict:
        t0 = self.t[T_BEGIN]
        phases = {TXN_PHASE_NAMES[i]: round(self.t[i] - t0, 9)
                  for i in range(1, 5) if self.t[i] > 0.0}
        return {"seq": self.seq, "kind": "t", "txn": self.tid,
                "parts": self.parts,
                "outcome": self.outcome or "in-flight", "phases": phases}


class LatencyTracer:
    """Sampler + span bookkeeping + harvest for one node.

    Thread contract: ``next_seq_w`` is called under the node's submit
    lock and ``next_seq_r`` under its read lock (the counters need no
    lock of their own); ``retire`` may run on any thread (per-thread
    rings); ``harvest``/``mark_committed``/``tick_spans`` run on the
    tick thread only.
    """

    def __init__(self, rate: int, seed: int = 0, slo_s: float = 0.5,
                 max_live: int = 512, recent: int = 64):
        assert rate >= 1
        self.rate = int(rate)
        self.seed = int(seed)
        self.phase = self.seed % self.rate
        self.slo_s = float(slo_s)
        self.max_live = int(max_live)
        self._seq_w = 0           # guarded by the node's submit lock
        self._seq_r = 0           # guarded by the node's read lock
        self._seq_t = 0           # txn drivers run on arbitrary client
        self._seq_t_lock = threading.Lock()   # threads: own tiny lock
        self._txn_seen = False    # tick thread: any TxnSpan harvested yet
        self._live = 0
        self._live_lock = threading.Lock()
        self._rings_lock = threading.Lock()
        self._rings: List[deque] = []
        self._tls = threading.local()
        # Tick-thread-only state.
        self.pending_commit: List[Span] = []   # offered, awaiting commit
        self.recent: deque = deque(maxlen=recent)
        self.counts: Dict[str, int] = {
            "sampled": 0, "ok": 0, "unknown": 0, "refused": 0,
            "overflow": 0, "slo_violations": 0}

    # -- sampling (pure arithmetic) -------------------------------------
    def sampled(self, seq: int) -> bool:
        return (seq + self.phase) % self.rate == 0

    def first_in(self, seq0: int, n: int) -> int:
        """Offset of the first sampled seq in [seq0, seq0+n), or -1.
        O(1): the stride has exactly one hit per ``rate`` seqs."""
        off = (-(seq0 + self.phase)) % self.rate
        return off if off < n else -1

    def next_seq_w(self, n: int) -> int:
        s = self._seq_w
        self._seq_w = s + n
        return s

    def next_seq_r(self, n: int) -> int:
        s = self._seq_r
        self._seq_r = s + n
        return s

    def next_seq_t(self) -> int:
        with self._seq_t_lock:
            s = self._seq_t
            self._seq_t = s + 1
        return s

    # -- span lifecycle -------------------------------------------------
    def make_span(self, seq: int, kind: str, k: int) -> Optional[Span]:
        """Admit a sampled candidate (bounded by ``max_live``)."""
        with self._live_lock:
            if self._live >= self.max_live:
                self.counts["overflow"] += 1   # GIL-atomic enough: the
                return None                    # lock serializes writers
            self._live += 1
            self.counts["sampled"] += 1
        sp = Span(seq, kind, k)
        sp.tr = self
        sp.mark(SUBMITTED)
        return sp

    def make_txn_span(self, seq: int) -> Optional[TxnSpan]:
        """Admit a sampled txn candidate (same ``max_live`` bound and
        overflow accounting as entry spans)."""
        with self._live_lock:
            if self._live >= self.max_live:
                self.counts["overflow"] += 1
                return None
            self._live += 1
            self.counts["sampled"] += 1
        sp = TxnSpan(seq)
        sp.tr = self
        sp.mark(T_BEGIN)
        return sp

    def _ring(self) -> deque:
        ring = getattr(self._tls, "ring", None)
        if ring is None:
            ring = self._tls.ring = deque()
            with self._rings_lock:
                self._rings.append(ring)
        return ring

    def retire(self, sp: Span, outcome: str) -> None:
        """Finish a span on the CURRENT thread: record its outcome and
        park it in this thread's ring for the tick thread to harvest.
        Idempotent — the first outcome wins (an abort racing a late
        completion must not retire the span twice)."""
        if sp.outcome is not None:
            return
        sp.outcome = outcome
        self._ring().append(sp)
        with self._live_lock:
            self._live -= 1

    def observe_client(self, seconds: float, read: bool = False) -> None:
        """Any thread (api/stub.py execute / execute_read): park one
        client-perceived wall time — queueing + forward chase included —
        in this thread's ring; harvest folds it into
        ``lat_client_execute_s`` / ``lat_client_read_s``.  Client
        threads never touch the shared registry (single-writer rule)."""
        self._ring().append((seconds, read))

    def mark_committed(self, h_commit) -> None:
        """Tick thread: stamp ``committed`` on in-flight spans whose
        group's commit frontier reached their log index."""
        pend = self.pending_commit
        if not pend:
            return
        keep: List[Span] = []
        for sp in pend:
            if sp.outcome is not None:
                continue          # already retired (abort path)
            if sp.idx >= 0 and int(h_commit[sp.group]) >= sp.idx:
                sp.mark(COMMITTED)
            else:
                keep.append(sp)
        self.pending_commit = keep

    # -- harvest (tick thread: the registry's single writer) ------------
    def harvest(self, metrics) -> None:
        with self._rings_lock:
            rings = list(self._rings)
        c = self.counts
        observe = metrics.observe
        for ring in rings:
            while ring:
                sp = ring.popleft()
                if sp.__class__ is tuple:     # client wall-time sample
                    observe("lat_client_read_s" if sp[1]
                            else "lat_client_execute_s", sp[0])
                    continue
                if sp.__class__ is TxnSpan:   # 2PC lifecycle sample
                    self._txn_seen = True
                    self.recent.append(sp)
                    key = "txn_" + (sp.outcome or "unknown")
                    c[key] = c.get(key, 0) + 1
                    if sp.outcome in ("commit", "abort"):
                        t = sp.t
                        for name, a, b in TXN_PHASE_PAIRS:
                            if t[a] > 0.0 and t[b] > 0.0:
                                observe(f"lat_txn_{name}_s",
                                        max(0.0, t[b] - t[a]))
                        if t[T_ACKED] > 0.0:
                            observe("lat_txn_e2e_s",
                                    t[T_ACKED] - t[T_BEGIN])
                    continue
                self.recent.append(sp)
                if sp.outcome != "ok":
                    c[sp.outcome] = c.get(sp.outcome, 0) + 1
                    continue      # never fabricate a latency
                c["ok"] += 1
                t = sp.t
                if sp.kind == "r":
                    if t[SERVED] > 0.0:
                        observe("lat_read_e2e_s", t[SERVED] - t[SUBMITTED])
                    continue
                for name, a, b in PHASE_PAIRS:
                    if t[a] > 0.0 and t[b] > 0.0:
                        observe(f"lat_{name}_s", max(0.0, t[b] - t[a]))
                end = t[ACKED] if t[ACKED] > 0.0 else 0.0
                if end > 0.0:
                    e2e = end - t[SUBMITTED]
                    observe("lat_e2e_s", e2e)
                    if e2e > self.slo_s:
                        c["slo_violations"] += 1
        # Percentile + SLO-burn gauges from the registry's own histogram
        # (one source for /metrics, /healthz and /latency).
        h = metrics.histogram("lat_e2e_s")
        metrics.gauge("lat_e2e_p50_s", h.quantile(0.5))
        metrics.gauge("lat_e2e_p99_s", h.quantile(0.99))
        metrics.gauge("lat_e2e_p999_s", h.quantile(0.999))
        metrics.gauge("lat_slo_target_s", self.slo_s)
        ok = c["ok"]
        metrics.gauge("lat_slo_burn_ratio",
                      c["slo_violations"] / ok if ok else 0.0)
        metrics["lat_sampled"] = c["sampled"]
        metrics["lat_spans_ok"] = ok
        metrics["lat_spans_unknown"] = c["unknown"]
        metrics["lat_spans_refused"] = c["refused"]
        metrics["lat_span_overflow"] = c["overflow"]
        if self._txn_seen:
            th = metrics.histogram("lat_txn_e2e_s")
            metrics.gauge("lat_txn_e2e_p50_s", th.quantile(0.5))
            metrics.gauge("lat_txn_e2e_p99_s", th.quantile(0.99))
            metrics.gauge("lat_txn_e2e_p999_s", th.quantile(0.999))
            nc = c.get("txn_commit", 0)
            na = c.get("txn_abort", 0)
            metrics.gauge("lat_txn_abort_ratio",
                          na / (nc + na) if (nc + na) else 0.0)

    # -- views -----------------------------------------------------------
    def snapshot(self, metrics) -> dict:
        """The /latency document: sampler config, SLO state, per-phase
        and end-to-end percentile table, recent sampled spans."""
        phases = {}
        for name, _a, _b in PHASE_PAIRS:
            h = metrics._histograms.get(f"lat_{name}_s")
            if h is not None and h.n:
                phases[name] = h.summary() | {"p999": h.quantile(0.999)}
        doc = {
            "sampling": {"rate": self.rate, "seed": self.seed,
                         "counts": dict(self.counts),
                         "in_flight": self._live},
            "slo": {
                "target_s": self.slo_s,
                "e2e_p999_s": metrics._gauges.get("lat_e2e_p999_s", 0.0),
                "burn_ratio": metrics._gauges.get("lat_slo_burn_ratio",
                                                  0.0),
            },
            "phases": phases,
            "recent": [sp.to_dict() for sp in list(self.recent)],
        }
        for key in ("lat_e2e_s", "lat_read_e2e_s"):
            h = metrics._histograms.get(key)
            if h is not None and h.n:
                doc[key[:-2]] = h.summary() | {"p999": h.quantile(0.999)}
        if self._txn_seen:
            txn_phases = {}
            for name, _a, _b in TXN_PHASE_PAIRS:
                h = metrics._histograms.get(f"lat_txn_{name}_s")
                if h is not None and h.n:
                    txn_phases[name] = h.summary() | \
                        {"p999": h.quantile(0.999)}
            c = self.counts
            txn = {"phases": txn_phases,
                   "counts": {k: v for k, v in c.items()
                              if k.startswith("txn_")},
                   "abort_ratio": metrics._gauges.get(
                       "lat_txn_abort_ratio", 0.0)}
            h = metrics._histograms.get("lat_txn_e2e_s")
            if h is not None and h.n:
                txn["e2e"] = h.summary() | {"p999": h.quantile(0.999)}
            doc["txn"] = txn
        return doc


# ---------------------------------------------------------------------------
# Cross-node hop tracing (the fleet attribution plane).
#
# A sampled write span tells us WHEN the replication phase (send_commit)
# burned its time but not WHERE.  For every sampled span the leader
# attaches a compact hop context to the AppendEntries traffic that ships
# the entry (transport/codec.py HOPS frames, piggybacked on the same
# per-peer slice); the follower stamps receive → staged → fsynced on its
# OWN clock and echoes the context with single-clock durations; the
# leader pairs the echo like an RPC and decomposes the phase into
#
#   leader_pack     AE computed -> frame handed to the transport
#                   (leader clock; includes the persist-before-send
#                   barrier in serial mode)
#   wire            one-way estimate: (rtt - follower_residence) / 2
#                   (both terms single-clock: rtt on the leader,
#                   residence on the follower — clock skew cancels)
#   follower_fsync  receive -> entry durable (follower clock)
#   ack_return      remainder of the rtt after wire + fsync (the
#                   follower's post-fsync residence + the return trip)
#   quorum_wait     echo received -> commit stamped (leader clock;
#                   waiting on the rest of the quorum + tick cadence)
#
# The five segments telescope: leader_pack + wire + follower_fsync +
# ack_return = (t_send - t_pack) + rtt, and quorum_wait covers echo ->
# commit, so for any peer whose echo beat the commit the sum equals
# commit - t_pack exactly — which is send_commit plus the sub-tick
# pack-to-SENT sliver (the ≤5% reconciliation in tests/test_hops.py).
# Spans that die before committing are DROPPED (never fabricate a hop
# latency); un-echoed contexts expire by TTL on both ends.
# ---------------------------------------------------------------------------

HOP_SEGMENTS = ("leader_pack", "wire", "follower_fsync", "ack_return",
                "quorum_wait")

# HOPS frame directions (transport/codec.py pack_hops).
HOP_REQUEST, HOP_ECHO = 0, 1


class _HopRec:
    """Leader-side pending context for one sampled span's replication."""

    __slots__ = ("hop_id", "span", "t_pack", "born", "sent", "echo")

    def __init__(self, hop_id: int, span: Span, born_ns: int):
        self.hop_id = hop_id
        self.span = span
        self.t_pack = 0       # ns — first AE coverage detected
        self.born = born_ns
        self.sent = {}        # peer -> t_send_ns (0 = queued, unsent)
        self.echo = {}        # peer -> (t_echo_recv_ns, rtt_ns,
        #                       d_staged_ns, d_fsync_ns, d_echo_ns)


class _ForeignHop:
    """Follower-side context received from an origin leader."""

    __slots__ = ("origin", "hop_id", "group", "idx", "t_send", "t_recv",
                 "d_staged", "d_fsync")

    def __init__(self, origin: int, hop_id: int, group: int, idx: int,
                 t_send: int, t_recv: int):
        self.origin = origin
        self.hop_id = hop_id
        self.group = group
        self.idx = idx
        self.t_send = t_send      # origin clock, echoed back verbatim
        self.t_recv = t_recv      # OUR clock (reader-thread arrival)
        self.d_staged = 0         # ns from t_recv (our clock)
        self.d_fsync = 0


class HopTracer:
    """Per-node hop bookkeeping — both roles at once (every node leads
    some groups and follows others).

    Thread contract: ``recv_requests``/``recv_echoes`` run on transport
    reader threads (lock-free deque appends); everything else —
    ``track``, ``scan_outbox``, ``fold_foreign``, ``take_out``,
    ``fold`` — runs on the tick/host-phase thread only."""

    def __init__(self, node_id: int, n_peers: int, ttl_s: float = 30.0,
                 recent: int = 64):
        self.node_id = int(node_id)
        self.n_peers = int(n_peers)
        self._ttl_ns = int(ttl_s * 1e9)
        # Leader side.
        self._next_id = 1
        self._live: Dict[int, _HopRec] = {}
        self._by_group: Dict[int, List[_HopRec]] = {}
        self._out_req: Dict[int, List[_HopRec]] = {}    # peer -> queued
        self._in_echo: deque = deque()   # (origin, records, t_recv_ns)
        # Follower side.
        self._in_req: deque = deque()    # (origin, records, t_recv_ns)
        self._foreign: List[_ForeignHop] = []
        self._out_echo: Dict[int, List[_ForeignHop]] = {}
        self.recent: deque = deque(maxlen=recent)
        self.counts: Dict[str, int] = {
            "tracked": 0, "requests_sent": 0, "echoes": 0,
            "echo_orphan": 0, "finalized": 0, "dropped_unknown": 0,
            "expired": 0, "foreign_seen": 0, "foreign_expired": 0}

    # -- leader: context creation + AE coverage -------------------------
    def track(self, span: Span) -> None:
        """Register a device-accepted sampled span (group/idx pinned)
        for hop attribution.  Tick thread."""
        r = _HopRec(self._next_id, span, time.perf_counter_ns())
        self._next_id += 1
        self._live[r.hop_id] = r
        self._by_group.setdefault(span.group, []).append(r)
        self.counts["tracked"] += 1

    def scan_outbox(self, ae_valid, ae_prev_idx, ae_n) -> None:
        """Detect which peers' AE frames this tick cover a tracked
        span's (group, idx) and queue a hop request for each — one per
        (span, peer), first coverage wins.  Arrays are the host-fetched
        [P, G] outbox planes; the walk is over tracked groups only (at
        most a handful of sampled spans are live)."""
        if not self._by_group:
            return
        now = time.perf_counter_ns()
        for g, recs in self._by_group.items():
            for r in recs:
                idx = r.span.idx
                for p in range(self.n_peers):
                    if p == self.node_id or p in r.sent:
                        continue
                    if ae_valid[p, g]:
                        prev = int(ae_prev_idx[p, g])
                        if prev < idx <= prev + int(ae_n[p, g]):
                            if r.t_pack == 0:
                                r.t_pack = now
                            r.sent[p] = 0
                            self._out_req.setdefault(p, []).append(r)

    # -- follower: intake + durability stamping -------------------------
    def recv_requests(self, origin: int, records, t_recv_ns: int) -> None:
        """Reader thread: park an inbound HOPS request batch."""
        self._in_req.append((origin, records, t_recv_ns))

    def recv_echoes(self, origin: int, records, t_recv_ns: int) -> None:
        """Reader thread: park an inbound HOPS echo batch."""
        self._in_echo.append((origin, records, t_recv_ns))

    def fold_foreign(self, tail, fsynced: bool) -> None:
        """Tick/host-phase thread: drain inbound requests and stamp the
        ones whose (group, idx) the given per-group tail now covers —
        ``fsynced=False`` after staging (marks ``staged``),
        ``fsynced=True`` after the durability barrier (marks ``fsynced``
        and readies the echo for the next flush to the origin)."""
        while self._in_req:
            origin, records, t_recv = self._in_req.popleft()
            for hop_id, group, idx, t_send in records:
                self._foreign.append(_ForeignHop(
                    origin, hop_id, int(group), int(idx), t_send, t_recv))
                self.counts["foreign_seen"] += 1
        if not self._foreign:
            return
        now = time.perf_counter_ns()
        keep: List[_ForeignHop] = []
        for f in self._foreign:
            if 0 <= f.group < len(tail) and int(tail[f.group]) >= f.idx:
                if f.d_staged == 0:
                    f.d_staged = max(now - f.t_recv, 1)
                if fsynced:
                    f.d_fsync = max(now - f.t_recv, 1)
                    self._out_echo.setdefault(f.origin, []).append(f)
                    continue
            elif now - f.t_recv > self._ttl_ns:
                # The entry never became durable here (conflict
                # truncation, leadership churn, lane close): expire —
                # an unstamped context must never fabricate a latency.
                self.counts["foreign_expired"] += 1
                continue
            keep.append(f)
        self._foreign = keep

    # -- both roles: outbound records for one peer ----------------------
    def take_out(self, peer: int):
        """Outbound hop records riding this flush to ``peer``:
        ``(requests, echoes)`` or None.  Stamps send times (requests)
        and residence (echoes) NOW — call immediately before handing
        the peer's bytes to the transport.  Tick/host-phase thread."""
        reqs = self._out_req.pop(peer, None)
        echoes = self._out_echo.pop(peer, None)
        if not reqs and not echoes:
            return None
        t = time.perf_counter_ns()
        req_records = []
        for r in reqs or ():
            r.sent[peer] = t
            req_records.append((r.hop_id, r.span.group, r.span.idx, t))
            self.counts["requests_sent"] += 1
        echo_records = []
        for f in echoes or ():
            echo_records.append((f.hop_id, f.t_send, f.d_staged,
                                 f.d_fsync, max(t - f.t_recv, 1)))
        return req_records, echo_records

    def has_out(self, peer: int) -> bool:
        return peer in self._out_req or peer in self._out_echo

    def out_peers(self):
        return set(self._out_req) | set(self._out_echo)

    # -- leader: echo folding + finalization ----------------------------
    def fold(self, metrics) -> None:
        """Tick thread: pair echoes with pending contexts, finalize
        contexts whose span settled (observing per-peer segment
        histograms for committed spans only), expire the rest by TTL,
        and fold the counters into the registry."""
        while self._in_echo:
            origin, records, t_recv = self._in_echo.popleft()
            for hop_id, _t_send, d_staged, d_fsync, d_echo in records:
                r = self._live.get(hop_id)
                if r is None:
                    self.counts["echo_orphan"] += 1
                    continue
                t_sent = r.sent.get(origin, 0)
                if not t_sent or origin in r.echo:
                    continue
                r.echo[origin] = (t_recv, max(t_recv - t_sent, 0),
                                  d_staged, d_fsync, d_echo)
                self.counts["echoes"] += 1
        if self._live:
            now = time.perf_counter_ns()
            done: List[int] = []
            for hop_id, r in self._live.items():
                sp = r.span
                if sp.outcome is None:
                    if now - r.born > self._ttl_ns:
                        done.append(hop_id)
                        self.counts["expired"] += 1
                    continue
                done.append(hop_id)
                if sp.outcome != "ok" or sp.t[COMMITTED] <= 0.0:
                    # Crashed / refused / outcome-unknown span: its hop
                    # context dies with it — no segment is observed.
                    self.counts["dropped_unknown"] += 1
                    continue
                self._observe(r, metrics)
            for hop_id in done:
                r = self._live.pop(hop_id)
                recs = self._by_group.get(r.span.group)
                if recs is not None:
                    try:
                        recs.remove(r)
                    except ValueError:
                        pass
                    if not recs:
                        del self._by_group[r.span.group]
        c = self.counts
        metrics["hop_tracked"] = c["tracked"]
        metrics["hop_requests_sent"] = c["requests_sent"]
        metrics["hop_echoes"] = c["echoes"]
        metrics["hop_finalized"] = c["finalized"]
        metrics["hop_dropped_unknown"] = c["dropped_unknown"]
        metrics["hop_expired"] = c["expired"]
        metrics["hop_foreign_seen"] = c["foreign_seen"]
        metrics["hop_foreign_expired"] = c["foreign_expired"]

    def _observe(self, r: _HopRec, metrics) -> None:
        t_commit = r.span.t[COMMITTED]
        peers = {}
        for p, (t_er, rtt, _d_staged, d_fsync, d_echo) in r.echo.items():
            t_send = r.sent.get(p, 0)
            if not t_send or r.t_pack == 0:
                continue
            rtt_s = rtt * 1e-9
            resid_s = min(max(d_echo, 0) * 1e-9, rtt_s)
            wire = (rtt_s - resid_s) / 2.0
            fsync_s = min(max(d_fsync, 0) * 1e-9, resid_s)
            segs = {
                "leader_pack": max(t_send - r.t_pack, 0) * 1e-9,
                "wire": wire,
                "follower_fsync": fsync_s,
                "ack_return": max(rtt_s - wire - fsync_s, 0.0),
                "quorum_wait": max(t_commit - t_er * 1e-9, 0.0),
            }
            peers[p] = segs
            for name, v in segs.items():
                metrics.observe(f"hop_{name}_s", v)
                metrics.observe(f"hop_{name}_p{p}_s", v)
        if peers:
            self.counts["finalized"] += 1
            sp = r.span
            sc = (t_commit - sp.t[SENT]) if sp.t[SENT] > 0.0 else 0.0
            self.recent.append({
                "seq": sp.seq, "group": sp.group, "idx": sp.idx,
                "tick": sp.tick, "send_commit_s": round(sc, 9),
                "peers": {p: {k: round(v, 9) for k, v in segs.items()}
                          for p, segs in peers.items()},
            })

    # -- views -----------------------------------------------------------
    def snapshot(self, metrics) -> dict:
        """The /hops document: per-peer and aggregate segment summaries
        + bookkeeping counters + recent finalized decompositions."""
        def summarize(name):
            h = metrics._histograms.get(name)
            if h is None or not h.n:
                return None
            return h.summary() | {"p999": h.quantile(0.999)}

        segments = {}
        for seg in HOP_SEGMENTS:
            agg = summarize(f"hop_{seg}_s")
            if agg is None:
                continue
            per_peer = {}
            for p in range(self.n_peers):
                s = summarize(f"hop_{seg}_p{p}_s")
                if s is not None:
                    per_peer[p] = s
            segments[seg] = {"all": agg, "peers": per_peer}
        return {
            "counts": dict(self.counts),
            "pending": len(self._live),
            "foreign_pending": len(self._foreign),
            "segments": segments,
            "recent": list(self.recent),
        }


def hops_from_env(node_id: int, n_peers: int) -> Optional[HopTracer]:
    """Build the node's hop tracer from RAFT_HOP_TRACE (default on;
    0/false disables).  Cheap when idle: a node with latency sampling
    off never tracks a span, so the per-tick fold is a no-op — but the
    tracer must exist on FOLLOWERS regardless of their own sampling
    config, or a sampled leader's contexts would never echo."""
    import os
    raw = os.environ.get("RAFT_HOP_TRACE", "").strip().lower()
    if raw in ("0", "false", "no", "off"):
        return None
    ttl = float(os.environ.get("RAFT_HOP_TTL_S", "30"))
    return HopTracer(node_id, n_peers, ttl_s=max(ttl, 1.0))


def tracer_from_env(seed: int = 0, slo_s: float = 0.5,
                    default_rate: int = 64) -> Optional[LatencyTracer]:
    """Build the node's tracer from RAFT_LAT_SAMPLE (1/N sampling;
    0/negative disables — the node then holds None and every hot-path
    hook is one is-None check)."""
    import os
    raw = os.environ.get("RAFT_LAT_SAMPLE", "").strip()
    try:
        rate = int(raw) if raw else default_rate
    except ValueError:
        rate = default_rate
    if rate <= 0:
        return None
    return LatencyTracer(rate, seed=seed, slo_s=slo_s)
