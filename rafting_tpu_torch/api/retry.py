"""Client-side self-protection primitives: retry budgets and circuit
breakers (beyond-reference — the reference client retries NotLeader hints
unboundedly, support/anomaly/NotLeaderException.java:11-27).

The overload-control plane's client half (ISSUE 15 / ROADMAP item 5):
under sustained overload, naive clients AMPLIFY the load they are
refused under — every shed request comes back as a retry, the retry is
shed again, and the system enters the metastable failure the CD-Raft
paper (arXiv:2603.10555) describes.  Two standard brakes, both local,
both allocation-free on the happy path:

* :class:`RetryBudget` — a token bucket that caps RETRY traffic at a
  fraction (~10%) of first-attempt traffic.  Every fresh call deposits
  ``ratio`` tokens; every refusal-driven retry spends one.  While the
  fleet is healthy the bucket stays full and retries are free; under
  overload it drains, and further refusals surface to the caller
  immediately instead of hammering the server (the AWS-SDK / Finagle
  retry-budget design).
* :class:`CircuitBreaker` — per-peer trip-out on CONSECUTIVE refusals /
  timeouts.  Open means "stop sending entirely" for a cooldown (which
  doubles on every re-trip, capped); after the cooldown the breaker
  half-opens PROBABILISTICALLY — each candidate call wins the single
  probe slot with probability ``probe_p`` — so a thousand stubs behind
  one dead peer don't all probe in the same tick.  One probe in flight
  at a time; its outcome closes or re-opens the breaker.

Both take injectable ``clock``/``rng`` so tests can walk the state
machines deterministically.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, Optional

__all__ = ["RetryBudget", "CircuitBreaker", "BreakerBoard"]


class RetryBudget:
    """Token bucket bounding retry traffic to ``ratio`` of first-attempt
    traffic.  Starts FULL (``cap`` tokens) so short refusal bursts — an
    election's NotLeader ping-pong — retry freely; only sustained
    refusal pressure drains it.  Thread-safe: one stub is commonly
    shared across caller threads."""

    def __init__(self, ratio: float = 0.1, cap: float = 50.0):
        self.ratio = float(ratio)
        self.cap = float(cap)
        self._tokens = float(cap)
        self._lock = threading.Lock()

    @property
    def tokens(self) -> float:
        return self._tokens

    def deposit(self, n: int = 1) -> None:
        """Credit ``ratio`` tokens per fresh (non-retry) request."""
        with self._lock:
            self._tokens = min(self.cap, self._tokens + self.ratio * n)

    def try_spend(self, n: float = 1.0) -> bool:
        """Take one retry's worth of budget; False = budget exhausted —
        the caller should surface the refusal instead of retrying."""
        with self._lock:
            if self._tokens < n:
                return False
            self._tokens -= n
            return True


# Circuit states.
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"


class CircuitBreaker:
    """Per-peer circuit breaker: trips OPEN after ``trip_after``
    consecutive failures (refusals carrying overload/unavailable
    semantics, transport errors, timeouts), stays open for a cooldown
    that doubles per re-trip (capped), then half-opens probabilistically
    — ``allow()`` grants the single probe slot with probability
    ``probe_p`` per call once the cooldown elapsed.  ``success()``
    closes it and resets the cooldown; ``failure()`` in half-open
    re-opens with the next-longer cooldown.

    NotLeader/NotReady refusals are NOT failures (a healthy peer saying
    "not me" is routing, not sickness) — the caller decides what counts.
    LeadershipEvacuated is the same: a degraded node handing leadership
    to a named healthy peer is the self-healing plane WORKING, and
    tripping its breaker would punish exactly the right behavior (the
    stub counts it as routing, api/stub.py _PEER_SICK exclusion).
    """

    def __init__(self, trip_after: int = 5, cooldown_s: float = 1.0,
                 max_cooldown_s: float = 30.0, probe_p: float = 0.3,
                 clock: Callable[[], float] = time.monotonic,
                 rng: Optional[random.Random] = None):
        self.trip_after = int(trip_after)
        self.base_cooldown_s = float(cooldown_s)
        self.max_cooldown_s = float(max_cooldown_s)
        self.probe_p = float(probe_p)
        self._clock = clock
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self.state = CLOSED
        self._consecutive = 0
        self._cooldown_s = self.base_cooldown_s
        self._opened_at = 0.0
        self._probing = False

    def allow(self) -> bool:
        """May a call go to this peer right now?  Closed: yes.  Open
        inside the cooldown: no.  Open past the cooldown: probabilistic
        probe — at most one winner transitions to half-open; everyone
        else keeps waiting.  Half-open: only the in-flight probe."""
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                if self._clock() - self._opened_at < self._cooldown_s:
                    return False
                if self._rng.random() < self.probe_p:
                    self.state = HALF_OPEN
                    self._probing = True
                    return True
                return False
            # HALF_OPEN: the probe slot is taken until it resolves.
            return False

    def success(self) -> None:
        with self._lock:
            self.state = CLOSED
            self._consecutive = 0
            self._cooldown_s = self.base_cooldown_s
            self._probing = False

    def failure(self) -> None:
        with self._lock:
            if self.state == HALF_OPEN:
                # Failed probe: back to open, longer cooldown.
                self._cooldown_s = min(self.max_cooldown_s,
                                       self._cooldown_s * 2)
                self.state = OPEN
                self._opened_at = self._clock()
                self._probing = False
                return
            self._consecutive += 1
            if self.state == CLOSED and self._consecutive >= self.trip_after:
                self.state = OPEN
                self._opened_at = self._clock()

    def retry_after_s(self) -> float:
        """How long until a probe could be allowed — the breaker's own
        retry-after hint for backoff sleeps."""
        with self._lock:
            if self.state == CLOSED:
                return 0.0
            rem = self._cooldown_s - (self._clock() - self._opened_at)
            return max(0.05, rem)


class BreakerBoard:
    """One CircuitBreaker per peer id, shared by every stub of a
    container (the peer's health is a node-level fact, not a per-group
    one).  Creation is locked; lookups after that are plain dict reads."""

    def __init__(self, **breaker_kwargs):
        self._kwargs = breaker_kwargs
        self._breakers: Dict[int, CircuitBreaker] = {}
        self._lock = threading.Lock()

    def get(self, peer: int) -> CircuitBreaker:
        br = self._breakers.get(peer)
        if br is None:
            with self._lock:
                br = self._breakers.get(peer)
                if br is None:
                    br = self._breakers[peer] = CircuitBreaker(
                        **self._kwargs)
        return br
