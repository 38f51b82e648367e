"""Metrics: counters, gauges and latency histograms for the node runtime.

The reference has no metrics beyond logback debug lines and a config block
feeding the health detector (SURVEY §5; support/RaftConfig.java:137-141) —
the survey explicitly calls for commits/sec, election counts and per-step
latency histograms in this build.  This module is dependency-free and
cheap on the hot path (a counter bump is a dict add; histogram observe is
a bisect into fixed log-spaced buckets).
"""

from __future__ import annotations

import bisect
import json
import math
import re
import time
from typing import Dict, List, Optional

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str, prefix: str) -> str:
    """Sanitize a registry name into a Prometheus metric name."""
    return prefix + _NAME_RE.sub("_", name)


def _prom_value(v) -> str:
    """Render a sample value in exposition-format syntax.

    Python would print ``nan``/``inf``/``-inf``, which the format does not
    accept — the canonical spellings are ``NaN``/``+Inf``/``-Inf``.  A
    non-finite gauge (e.g. a rate over a zero interval) must not corrupt
    the whole scrape page."""
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return str(v)


def escape_label_value(v: str) -> str:
    """Escape a label VALUE for ``name{label="<here>"}`` (backslash, quote
    and newline, per the exposition format's label escaping rules) — for
    handlers that render labeled series on top of this registry."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class Histogram:
    """Fixed log-spaced buckets (microseconds to minutes by default).

    Thread contract — SINGLE WRITER, many readers.  ``observe`` (and
    ``reset``/``merge``) must only be called from one thread at a time;
    in the node runtime that is the tick thread: the striped host tier's
    W workers return their stage timings through the phase barrier and
    the tick thread observes the per-tick max (runtime/node.py striped
    phase), and the latency tracer's client-thread samples park in
    per-thread rings that the tick thread drains in ``harvest``
    (utils/latency.py).  Concurrent ``observe`` from two threads would
    lose increments (``counts[i] += 1`` is a read-modify-write) — grow a
    per-worker shard and fold it with ``merge`` instead.  Readers
    (HTTP scrape threads calling ``summary``/``quantile``/
    ``render_prometheus``) may race the writer freely: they take an
    atomic ``list(counts)`` snapshot and derive the sample count from
    its sum, so bucket series stay monotone even mid-observe.  The test
    suite enforces both halves (tests/test_latency.py)."""

    def __init__(self, bounds: Optional[List[float]] = None):
        if bounds is None:
            # 2x-spaced: 1us .. ~2.2min.  (4x spacing made tick-latency
            # quantiles useless — a p50 of 1.2s reported as "4.19s".)
            bounds = [1e-6 * (2 ** i) for i in range(28)]
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.total = 0.0
        self.n = 0
        self.max = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_right(self.bounds, v)] += 1
        self.total += v
        self.n += 1
        if v > self.max:
            self.max = v

    def reset(self) -> None:
        """Zero the histogram in place (e.g. a benchmark separating its
        measure phase from warmup/compile ticks)."""
        self.counts = [0] * len(self.counts)
        self.total = 0.0
        self.n = 0
        self.max = 0.0

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram's samples into this one (writer-side
        only — same single-writer contract as ``observe``).  Bounds must
        match; this is the shard-fold primitive for any future
        per-worker histogram sharding."""
        if other.bounds != self.bounds:
            raise ValueError("histogram bounds mismatch")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.total += other.total
        self.n += other.n
        if other.max > self.max:
            self.max = other.max

    def quantile(self, q: float, _counts: Optional[List[int]] = None
                 ) -> float:
        """Upper bucket bound at quantile q (conservative estimate).
        Safe to call from reader threads: operates on an atomic snapshot
        of the counts (``_counts`` lets ``summary`` reuse one snapshot
        for all three quantiles)."""
        counts = list(self.counts) if _counts is None else _counts
        n = sum(counts)
        if n == 0:
            return 0.0
        target = q * n
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= target:
                return self.bounds[i] if i < len(self.bounds) else self.max
        return self.max

    def summary(self) -> dict:
        # One atomic counts snapshot serves count and every quantile, so
        # a scrape racing the writer reports an internally consistent
        # row; mean pairs it with a total read just after (the skew is
        # at most the samples observed in between — harmless for a
        # monitoring mean, and never a crash or negative value).
        counts = list(self.counts)
        n = sum(counts)
        return {
            "count": n,
            "mean": self.total / n if n else 0.0,
            "p50": self.quantile(0.5, counts),
            "p99": self.quantile(0.99, counts),
            "max": self.max,
        }


class Metrics:
    """Counter/gauge/histogram registry with dict-style counter access
    (``m["commits"] += 1`` and ``m.inc("commits")`` both work)."""

    def __init__(self):
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._t0 = time.monotonic()
        self._ckpt_counters: Dict[str, float] = {}
        self._ckpt_t = self._t0

    # counters ---------------------------------------------------------------
    def inc(self, name: str, delta: float = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + delta

    def __getitem__(self, name: str) -> float:
        return self._counters.get(name, 0)

    def __setitem__(self, name: str, value: float) -> None:
        self._counters[name] = value

    # gauges -----------------------------------------------------------------
    def gauge(self, name: str, value: float) -> None:
        self._gauges[name] = value

    # histograms -------------------------------------------------------------
    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram()
        return h

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    # reporting --------------------------------------------------------------
    def checkpoint(self) -> None:
        """Snapshot the counters as the baseline for windowed rates: a
        long-lived node's ``rates(since_last=True)`` then reports CURRENT
        throughput over the window since this call, not a lifetime
        average diluted by hours of history (the benchmark checkpoints at
        the start of its measure phase).  Race note: ``dict(d)`` is one
        atomic C call under the GIL, so a checkpoint racing the tick
        thread's counter bumps captures a point-in-time copy; the window
        between the copy and ``monotonic()`` only skews the first
        windowed rate by nanoseconds."""
        self._ckpt_counters = dict(self._counters)
        self._ckpt_t = time.monotonic()

    def rates(self, since_last: bool = False) -> Dict[str, float]:
        """Counters per second — over the registry lifetime, or (with
        ``since_last``) over the window since the last :meth:`checkpoint`
        (boot, if never checkpointed).  Iterates a dict snapshot: readers
        (HTTP scrape threads) race the tick thread's first-seen counter
        inserts, and dict(d) is one atomic C call under the GIL."""
        counters = dict(self._counters)
        if since_last:
            dt = max(time.monotonic() - self._ckpt_t, 1e-9)
            base = self._ckpt_counters
            return {f"{k}_per_sec": (v - base.get(k, 0)) / dt
                    for k, v in counters.items()}
        dt = max(time.monotonic() - self._t0, 1e-9)
        return {f"{k}_per_sec": v / dt for k, v in counters.items()}

    def breakdown(self, prefix: str = "tick_stage_") -> Dict[str, dict]:
        """Summaries of every histogram under ``prefix`` keyed by the bare
        stage name — the per-stage tick breakdown (scan-wait, wal, fsync,
        send, apply, maintain) the runtime observes each tick and the
        durable bench reports per run."""
        return {name[len(prefix):]: h.summary()
                for name, h in dict(self._histograms).items()
                if name.startswith(prefix)}

    def to_dict(self) -> dict:
        return {
            "uptime_s": time.monotonic() - self._t0,
            "counters": dict(self._counters),
            "gauges": dict(self._gauges),
            "rates": self.rates(),
            "histograms": {k: h.summary()
                           for k, h in dict(self._histograms).items()},
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def render_prometheus(self, prefix: str = "raft_") -> str:
        """Prometheus text exposition format 0.0.4 of the whole registry.

        Counters render as ``<prefix><name>_total`` (counter), gauges as
        ``<prefix><name>`` (gauge), histograms as the standard cumulative
        ``_bucket{le=...}`` / ``_sum`` / ``_count`` triplet over the fixed
        log-spaced bounds.  Names are sanitized to the Prometheus charset;
        dependency-free (no client library) by design, like the rest of
        this module — serve it from any HTTP handler with content type
        ``text/plain; version=0.0.4``."""
        lines: List[str] = []
        # Dict snapshots: the renderer runs on HTTP scrape threads while
        # the tick thread inserts first-seen keys (atomic C-level copies
        # under the GIL — see rates()).
        counters = dict(self._counters)
        gauges = dict(self._gauges)
        histograms = dict(self._histograms)
        for name in sorted(counters):
            m = _prom_name(name, prefix) + "_total"
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {_prom_value(counters[name])}")
        for name in sorted(gauges):
            m = _prom_name(name, prefix)
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {_prom_value(gauges[name])}")
        for name in sorted(histograms):
            h = histograms[name]
            m = _prom_name(name, prefix)
            lines.append(f"# TYPE {m} histogram")
            # Atomic counts snapshot with _count derived from its sum:
            # reading the live list while the tick thread observes could
            # render cum > h.n (read at a different instant), a
            # non-monotone bucket series scrapers reject.
            counts = list(h.counts)
            n = sum(counts)
            cum = 0
            for bound, c in zip(h.bounds, counts):
                cum += c
                lines.append(f'{m}_bucket{{le="{bound:.6g}"}} {cum}')
            lines.append(f'{m}_bucket{{le="+Inf"}} {n}')
            lines.append(f"{m}_sum {_prom_value(h.total)}")
            lines.append(f"{m}_count {n}")
        return "\n".join(lines) + "\n"


# ------------------------------------------------------------- validation --

_METRIC_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_VALUE = r"(?:[+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|\+Inf|-Inf|NaN)"
_TYPE_LINE = re.compile(rf"^# TYPE ({_METRIC_NAME}) "
                        r"(counter|gauge|histogram|summary|untyped)$")
_SAMPLE_LINE = re.compile(
    rf"^({_METRIC_NAME})"
    rf"(?:\{{le=\"({_VALUE})\"\}})? ({_VALUE})$")


def validate_exposition(text: str) -> None:
    """Strict structural check of a text exposition-format page.

    Raises ``ValueError`` on: a line matching neither the TYPE nor the
    sample grammar (bad charset, malformed value — Python's ``nan``/
    ``inf`` spellings included), a duplicate TYPE line for one metric,
    ``le`` buckets out of ascending order, or a bucket series missing its
    ``+Inf`` terminator.  Deliberately stricter than a scraper needs —
    this is the round-trip oracle for :meth:`Metrics.render_prometheus`.
    """
    if not text.endswith("\n"):
        raise ValueError("exposition page must end with a newline")
    typed: set = set()
    le_seen: Dict[str, float] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        t = _TYPE_LINE.match(line)
        if t:
            if t.group(1) in typed:
                raise ValueError(f"line {ln}: duplicate TYPE for "
                                 f"{t.group(1)}")
            typed.add(t.group(1))
            continue
        if line.startswith("#"):
            continue   # HELP / comment lines are free-form
        s = _SAMPLE_LINE.match(line)
        if s is None:
            raise ValueError(f"line {ln}: malformed sample: {line!r}")
        name, le, _val = s.group(1), s.group(2), s.group(3)
        if le is not None:
            prev = le_seen.get(name)
            cur = float(le)   # float() parses '+Inf'/'-Inf'/'NaN' natively
            if math.isnan(cur):
                raise ValueError(f"line {ln}: NaN le bucket")
            if prev is not None and not cur > prev:
                raise ValueError(f"line {ln}: le buckets not ascending "
                                 f"for {name}")
            le_seen[name] = cur
    for name, top in le_seen.items():
        if top != math.inf:
            raise ValueError(f"bucket series {name} missing +Inf")
