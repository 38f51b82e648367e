"""Transport-level fault injection: the chaos plane's network nemesis.

One :class:`LinkFaults` instance is the shared fault table for a whole
cluster — every transport (TCP sender threads, loopback send paths)
consults it per frame, per DIRECTED link, so asymmetric partitions
(A->B dead, B->A alive) fall out of the representation instead of being
a special case.  Faults are runtime-togglable: a partition installed
mid-run heals mid-run, with senders rejoining through the normal
reconnect-backoff ladder (tcp.py) — the same code path a real switch
flap exercises.

Fault taxonomy (the Jepsen network nemeses, per directed link):

* ``cut``      — the link is down: TCP senders fail like an unreachable
  peer and run the reconnect ladder; loopback frames vanish.
* ``drop_p``   — each frame is independently lost with this probability.
* ``delay_p/delay_s`` — a frame is held back (TCP: the sender thread
  sleeps ``delay_s``; loopback: the frame is delivered just before the
  NEXT frame on that link, a one-frame time shift that preserves order).
* ``dup_p``    — a frame is delivered twice (stale/duplicate RPC
  idempotency through the real codec round-trip).
* ``reorder_p`` — a frame is held and delivered AFTER the next frame on
  the link (adjacent swap: the minimal observable reordering).

Determinism: every directed link owns a private ``random.Random`` stream
derived from ``(seed, src, dst)``, and each :meth:`plan` call consumes a
fixed number of draws — so a link's fault decisions depend only on the
seed and how many frames crossed it, never on thread interleaving with
other links.  That is what makes a seeded chaos run replayable.
"""

from __future__ import annotations

import threading
from collections import namedtuple
from random import Random
from typing import Dict, Iterable, Optional, Set, Tuple

__all__ = ["LinkAction", "LinkFaults", "PASS"]

# The per-frame verdict a transport acts on.  ``cut`` means the link is
# administratively down (TCP severs the connection); ``deliver=False``
# without cut is a probabilistic single-frame drop.
LinkAction = namedtuple("LinkAction",
                        ("deliver", "cut", "delay_s", "dup", "reorder"))
PASS = LinkAction(True, False, 0.0, False, False)
_CUT = LinkAction(False, True, 0.0, False, False)
_DROP = LinkAction(False, False, 0.0, False, False)

# Counter names as they render on /metrics (pre-registered at 0 by the
# node so a clean cluster exposes the whole family).
COUNTERS = ("net_faults_cut_total", "net_faults_dropped_total",
            "net_faults_delayed_total", "net_faults_duplicated_total",
            "net_faults_reordered_total")


class LinkFaults:
    """Seeded per-directed-link fault table shared by a cluster's
    transports.  All methods are thread-safe (sender threads consult it
    concurrently with the conductor mutating it)."""

    def __init__(self, n_nodes: int, seed: int = 0):
        self.n = n_nodes
        self.seed = seed
        self._lock = threading.Lock()
        self._down: Set[Tuple[int, int]] = set()
        # (src, dst) -> (drop_p, dup_p, reorder_p, delay_p, delay_s)
        self._spec: Dict[Tuple[int, int], Tuple[float, float, float,
                                                float, float]] = {}
        self._rng: Dict[Tuple[int, int], Random] = {}
        self.counters: Dict[str, int] = {
            "cut": 0, "dropped": 0, "delayed": 0, "duplicated": 0,
            "reordered": 0}

    # -- topology (partitions) ----------------------------------------------

    def set_link(self, src: int, dst: int, up: bool) -> None:
        """Directed cut/restore: ``up=False`` kills src->dst only — the
        asymmetric half-partition (dst still reaches src)."""
        with self._lock:
            if up:
                self._down.discard((src, dst))
            else:
                self._down.add((src, dst))

    def cut(self, a: int, b: int, sym: bool = True) -> None:
        self.set_link(a, b, False)
        if sym:
            self.set_link(b, a, False)

    def restore(self, a: int, b: int, sym: bool = True) -> None:
        self.set_link(a, b, True)
        if sym:
            self.set_link(b, a, True)

    def isolate(self, node: int) -> None:
        """Cut every link touching ``node`` in both directions."""
        with self._lock:
            for o in range(self.n):
                if o != node:
                    self._down.add((node, o))
                    self._down.add((o, node))

    def partition(self, sides: Iterable[Iterable[int]]) -> None:
        """Install a full partition: links WITHIN a side stay up, links
        ACROSS sides go down (same contract as LoopbackNetwork.partition)."""
        sides = [set(s) for s in sides]
        with self._lock:
            self._down.clear()
            for s in range(self.n):
                for d in range(self.n):
                    if s == d:
                        continue
                    if not any(s in side and d in side for side in sides):
                        self._down.add((s, d))

    def heal(self) -> None:
        """Restore all connectivity AND clear per-link fault specs.  RNG
        streams survive — determinism counts plan() calls, not heals."""
        with self._lock:
            self._down.clear()
            self._spec.clear()

    def link_up(self, src: int, dst: int) -> bool:
        with self._lock:
            return (src, dst) not in self._down

    # -- per-link probabilistic faults --------------------------------------

    def set_flaky(self, src: int, dst: int, *, drop_p: float = 0.0,
                  dup_p: float = 0.0, reorder_p: float = 0.0,
                  delay_p: float = 0.0, delay_s: float = 0.0) -> None:
        """Install (or, with all zeros, clear) probabilistic faults on the
        directed link src->dst."""
        with self._lock:
            if drop_p or dup_p or reorder_p or delay_p:
                self._spec[(src, dst)] = (drop_p, dup_p, reorder_p,
                                          delay_p, delay_s)
            else:
                self._spec.pop((src, dst), None)

    def set_all_flaky(self, **kw) -> None:
        for s in range(self.n):
            for d in range(self.n):
                if s != d:
                    self.set_flaky(s, d, **kw)

    # -- the per-frame verdict ----------------------------------------------

    def plan(self, src: int, dst: int) -> LinkAction:
        """One frame is about to cross src->dst: decide its fate.  Exactly
        four RNG draws per call on a flaky link (none on a clean or cut
        one), so outcome streams are a pure function of (seed, link,
        frame count)."""
        with self._lock:
            if (src, dst) in self._down:
                self.counters["cut"] += 1
                return _CUT
            spec = self._spec.get((src, dst))
            if spec is None:
                return PASS
            drop_p, dup_p, reorder_p, delay_p, delay_s = spec
            key = (src, dst)
            rng = self._rng.get(key)
            if rng is None:
                rng = self._rng[key] = Random(
                    (self.seed * 1000003) ^ (src * 8191 + dst))
            r_drop, r_dup, r_reord, r_delay = (
                rng.random(), rng.random(), rng.random(), rng.random())
            if r_drop < drop_p:
                self.counters["dropped"] += 1
                return _DROP
            dup = r_dup < dup_p
            reorder = r_reord < reorder_p
            delay = delay_s if r_delay < delay_p else 0.0
            if dup:
                self.counters["duplicated"] += 1
            if reorder:
                self.counters["reordered"] += 1
            if delay:
                self.counters["delayed"] += 1
            return LinkAction(True, False, delay, dup, reorder)

    # -- audit ---------------------------------------------------------------

    def snapshot(self) -> dict:
        """Current table + counters, JSON-shaped (chaos artifacts embed
        this so a soak's final network state is part of the record)."""
        with self._lock:
            return {
                "down": sorted(list(p) for p in self._down),
                "flaky": {f"{s}->{d}": list(v)
                          for (s, d), v in sorted(self._spec.items())},
                "counters": dict(self.counters),
            }
