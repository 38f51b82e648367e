"""Host-side gray-failure scorecards: decayed per-peer and self health.

A *gray* failure is the one the binary health checks miss: the node is
up, the sockets connect, but one direction of a link is dead, a disk
fsyncs at 100x its usual latency, or the process is so overloaded its
acks crawl.  The device tier's CheckQuorum (core/step.py phase 6c)
handles the acute case — a leader that cannot HEAR a voter quorum steps
down.  This registry is the chronic case's bookkeeping: it folds the
signals the runtime already collects into per-peer and self scores, so
the node can *proactively evacuate* leadership off itself while it is
merely degraded, before it becomes the fleet's slowest quorum member —
and never INTO a peer that looks worse.

Inputs (all already collected elsewhere; this module only folds):

* per-peer hop-segment histograms (utils/latency.py HopTracer): the
  ``hop_{wire,follower_fsync,ack_return}_p{p}_s`` windowed deltas — a
  peer whose delta-window p50 sits far above the fleet median is slow
  in a way aggregate percentiles hide;
* the storage-fault plane (runtime/node.py): quarantined WAL stripes,
  ENOSPC backpressure, the slow-I/O watchdog — *self* signals;
* the transport's ``reconnects_total`` counter — a flapping link is a
  self signal too (every peer shares this node's NIC);
* the admission controller's shed level (runtime/admission.py);
* CheckQuorum contact lanes (core/types.py QuorumContact), drained at
  an admin cadence: the per-peer last-heard tick feeds the scorecard's
  ``last_contact`` column and a stale-contact penalty.

Scores DECAY (half-life in ticks, the utils/heat.py discipline): a
healed peer's score melts back to 0 instead of branding it forever.
0 = healthy; ``degraded_after`` and up = degraded.  numpy + stdlib
only, single-writer ``ingest`` on the tick thread, HTTP-safe
``snapshot`` — the same relaxed-read contract as /metrics.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

# Hop segments that indict a PEER (leader_pack is our own packing time;
# quorum_wait blames the quorum, not one peer).
PEER_SEGMENTS = ("wire", "follower_fsync", "ack_return")


def _delta_quantile(bounds: List[float], delta: List[int],
                    q: float) -> float:
    """Upper-bound quantile over a windowed bucket-count delta (the
    delta analog of utils/metrics.Histogram.quantile — conservative,
    returns the bucket's upper bound)."""
    n = sum(delta)
    if n <= 0:
        return 0.0
    target = q * n
    seen = 0
    for i, c in enumerate(delta):
        seen += c
        if seen >= target:
            return bounds[i] if i < len(bounds) else bounds[-1] * 2
    return bounds[-1] * 2


class HealthRegistry:
    """Decayed per-peer + self health scores from runtime signals.

    ``ingest`` runs once per tick on the tick thread; everything it
    reads from the metrics registry is reader-safe (atomic list
    snapshots of histogram counts).  Scores are penalties: 0 is
    healthy, ``degraded_after`` is the evacuation/avoidance threshold.
    """

    def __init__(self, n_peers: int, node_id: int,
                 half_life_ticks: float = 256.0,
                 degraded_after: float = 4.0,
                 min_window_samples: int = 8,
                 slow_ratio: float = 4.0,
                 contact_stale_ticks: int = 64):
        self.n_peers = int(n_peers)
        self.node_id = int(node_id)
        self.half_life = float(half_life_ticks)
        self.degraded_after = float(degraded_after)
        self.min_window_samples = int(min_window_samples)
        self.slow_ratio = float(slow_ratio)
        self.contact_stale_ticks = int(contact_stale_ticks)
        self.score = np.zeros(self.n_peers, np.float64)
        self.self_score = 0.0
        # Own-clock tick each peer was last heard from (-1 = never /
        # unknown; fed from the CheckQuorum contact lanes when the
        # engine carries them).
        self.last_contact = np.full(self.n_peers, -1, np.int64)
        self.last_contact[self.node_id] = 0
        self.tick = 0
        self._score_tick = 0
        # Previous cumulative bucket counts per (segment, peer) — the
        # window baseline for delta quantiles.
        self._prev_counts: Dict[tuple, List[int]] = {}
        self._prev_poisoned = 0
        self._prev_reconnects = 0.0
        # Evacuation audit (appended by the node when it evacuates).
        self.evacuations = 0
        self.recent_evacuations: List[dict] = []
        # Score timeline ring: one decayed sample every
        # ``sample_every`` ingests, capped — the post-mortem CLI
        # (tools/health_report.py) plots these next to the evacuation
        # audit to show WHEN a node went gray, not just that it did.
        self.sample_every = 16
        self.history: List[dict] = []
        self._hist_next = 0

    # ------------------------------------------------------------ ingest

    def _decay(self, tick: int) -> None:
        dt = tick - self._score_tick
        if dt > 0:
            f = 0.5 ** (dt / self.half_life)
            self.score *= f
            self.self_score *= f
            self._score_tick = tick

    def _peer_window_p50(self, metrics, seg: str, p: int) -> tuple:
        """(windowed delta p50 seconds, delta sample count) for one
        peer's hop segment since the last ingest."""
        h = metrics._histograms.get(f"hop_{seg}_p{p}_s")
        if h is None:
            return 0.0, 0
        cur = list(h.counts)
        prev = self._prev_counts.get((seg, p))
        self._prev_counts[(seg, p)] = cur
        if prev is None or len(prev) != len(cur):
            return 0.0, 0
        delta = [c - q for c, q in zip(cur, prev)]
        n = sum(delta)
        if n < self.min_window_samples:
            return 0.0, n
        return _delta_quantile(h.bounds, delta, 0.5), n

    def ingest(self, tick: int, metrics, *,
               io_slow: bool = False, poisoned_stripes: int = 0,
               backpressure: bool = False, admission_level: float = 0.0
               ) -> None:
        """Fold one tick's signals.  Tick thread only."""
        self.tick = int(tick)
        self._decay(self.tick)
        # -- peers: relative hop-segment slowness -----------------------
        for seg in PEER_SEGMENTS:
            p50s = {}
            for p in range(self.n_peers):
                if p == self.node_id:
                    continue
                v, n = self._peer_window_p50(metrics, seg, p)
                if n >= self.min_window_samples:
                    p50s[p] = v
            if len(p50s) < 2:
                continue   # no fleet to compare against
            med = float(np.median(list(p50s.values())))
            if med <= 0.0:
                continue
            for p, v in p50s.items():
                ratio = v / med
                if ratio >= self.slow_ratio:
                    # Penalty grows with how far past the threshold the
                    # peer sits, capped so one wild window cannot brand
                    # a peer past any realistic decay horizon.
                    self.score[p] += min(ratio / self.slow_ratio, 4.0)
        # -- peers: stale contact (CheckQuorum lanes, when fed) ---------
        heard = self.last_contact
        for p in range(self.n_peers):
            if p == self.node_id or heard[p] < 0:
                continue
            if self.tick - heard[p] > self.contact_stale_ticks:
                self.score[p] += 1.0
        # -- self -------------------------------------------------------
        if io_slow:
            self.self_score += 1.0
        if backpressure:
            self.self_score += 1.0
        new_poison = max(0, int(poisoned_stripes) - self._prev_poisoned)
        self._prev_poisoned = max(self._prev_poisoned,
                                  int(poisoned_stripes))
        if new_poison:
            self.self_score += 2.0 * new_poison
        rec = float(metrics._counters.get("reconnects_total", 0.0))
        d_rec = rec - self._prev_reconnects
        self._prev_reconnects = rec
        if d_rec > 0:
            self.self_score += 0.5 * d_rec
        if admission_level > 0.0:
            self.self_score += float(admission_level)
        # -- timeline sample --------------------------------------------
        if self.tick >= self._hist_next:
            self._hist_next = self.tick + self.sample_every
            self.history.append({
                "tick": self.tick,
                "self": round(self.self_score, 3),
                "peers": [round(float(s), 3) for s in self.score],
            })
            del self.history[:-256]

    def note_contact(self, heard_ticks: np.ndarray) -> None:
        """Fold the device contact lanes' per-peer max-over-groups
        last-heard ticks ([P] int32, own engine clock; 0 = never).
        Tick thread only, admin cadence."""
        h = np.asarray(heard_ticks, np.int64)
        upd = h > 0
        self.last_contact[upd] = np.maximum(self.last_contact[upd], h[upd])

    def note_evacuation(self, group: int, target: int) -> None:
        self.evacuations += 1
        self.recent_evacuations.append(
            {"tick": self.tick, "group": int(group), "target": int(target)})
        del self.recent_evacuations[:-32]

    # ----------------------------------------------------------- queries

    def _decayed(self, v: float) -> float:
        return v * 0.5 ** (max(self.tick - self._score_tick, 0)
                           / self.half_life)

    def degraded_peers(self) -> set:
        thr = self.degraded_after
        return {int(p) for p in range(self.n_peers)
                if p != self.node_id
                and self._decayed(float(self.score[p])) >= thr}

    def self_degraded(self) -> bool:
        return self._decayed(self.self_score) >= self.degraded_after

    def snapshot(self) -> dict:
        """The /healthz ``peers`` block: scores, last contact ages,
        degraded flags, evacuation audit."""
        peers = []
        for p in range(self.n_peers):
            lc = int(self.last_contact[p])
            peers.append({
                "peer": p,
                "self": p == self.node_id,
                "score": round(self._decayed(float(self.score[p])), 3),
                "degraded": (p != self.node_id
                             and p in self.degraded_peers()),
                "last_contact_tick": lc if lc >= 0 else None,
                "contact_age_ticks": (int(self.tick - lc)
                                      if 0 <= lc else None),
            })
        return {
            "tick": self.tick,
            "half_life_ticks": self.half_life,
            "degraded_after": self.degraded_after,
            "self_score": round(self._decayed(self.self_score), 3),
            "self_degraded": self.self_degraded(),
            "peers": peers,
            "evacuations": self.evacuations,
            "recent_evacuations": list(self.recent_evacuations),
            "timeline": list(self.history),
        }


def health_from_env(n_peers: int, node_id: int
                    ) -> Optional[HealthRegistry]:
    """Build the node's health registry from the environment (default
    on; RAFT_HEALTH=0 disables).  Tunables: RAFT_HEALTH_HALF_LIFE
    (ticks, 256), RAFT_HEALTH_DEGRADED (score threshold, 4.0),
    RAFT_HEALTH_SLOW_RATIO (peer p50 / fleet median, 4.0),
    RAFT_HEALTH_STALE_TICKS (contact age penalty threshold, 64)."""
    import os

    raw = os.environ.get("RAFT_HEALTH", "").strip().lower()
    if raw in ("0", "false", "no", "off"):
        return None
    half = float(os.environ.get("RAFT_HEALTH_HALF_LIFE", "256"))
    thr = float(os.environ.get("RAFT_HEALTH_DEGRADED", "4"))
    ratio = float(os.environ.get("RAFT_HEALTH_SLOW_RATIO", "4"))
    stale = int(os.environ.get("RAFT_HEALTH_STALE_TICKS", "64"))
    return HealthRegistry(n_peers, node_id,
                          half_life_ticks=max(half, 1.0),
                          degraded_after=max(thr, 0.5),
                          slow_ratio=max(ratio, 1.5),
                          contact_stale_ticks=max(stale, 1))
