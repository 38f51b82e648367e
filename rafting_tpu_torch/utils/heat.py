"""Host-side decaying heat registry over the device heat lanes.

The device engine accumulates cumulative per-group activity counters
(core/types.py HeatState: entries appended, RPCs sent, commit advance,
reads served) when ``cfg.heat`` is on; the runtime drains them once per
tick and feeds the deltas here.  The registry keeps:

* a per-group exponentially-decaying **work score** (half-life in ticks)
  over client-driven work — appended + commits + reads.  ``sent`` is
  tracked but EXCLUDED from the score on purpose: heartbeats and vote
  traffic touch every group at cadence, so a score that counted RPCs
  would declare the whole idle fleet hot;
* the **last-active tick** per group, giving the idleness-age
  distribution;
* the **active-set size**: groups with client work inside the trailing
  window — the direct proof metric for the sparse-tick refactor
  (ROADMAP item 2: commit latency should track this gauge, not G).

numpy + stdlib only (like utils/tracelog.py) so post-mortem tooling can
load dumps without the engine.  Single-writer: ``ingest`` runs on the
tick thread only; ``snapshot`` is read-only over arrays that are
replaced, not resized, so serving it from an HTTP thread is safe under
the same relaxed contract as /metrics.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

LANES = ("appended", "sent", "commits", "reads")

# Idleness-age histogram bucket upper bounds, in ticks (powers of two);
# the last bucket is open-ended and a "never" lane counts groups with no
# client work since boot.
IDLE_BUCKETS = tuple(1 << i for i in range(13))   # 1 .. 4096 ticks


class HeatRegistry:
    """Decaying per-group heat from the drained device heat lanes."""

    def __init__(self, n_groups: int, half_life_ticks: float = 64.0,
                 active_window_ticks: int = 64):
        self.n_groups = int(n_groups)
        self.half_life = float(half_life_ticks)
        self.window = int(active_window_ticks)
        # Last drained cumulative device counters, one row per lane.
        self._cum = np.zeros((len(LANES), self.n_groups), np.int64)
        self.totals = np.zeros(len(LANES), np.int64)
        self.score = np.zeros(self.n_groups, np.float64)
        self.last_active = np.full(self.n_groups, -1, np.int64)
        self._score_tick = 0
        self.tick = 0

    # ------------------------------------------------------------ ingest

    def ingest(self, tick: int, appended: np.ndarray, sent: np.ndarray,
               commits: np.ndarray, reads: np.ndarray) -> tuple:
        """Fold one tick's cumulative lanes; returns the per-lane delta
        sums ``(appended, sent, commits, reads)`` for the metrics fold.
        Tick thread only."""
        cur = np.stack([
            np.asarray(appended, np.int64), np.asarray(sent, np.int64),
            np.asarray(commits, np.int64), np.asarray(reads, np.int64)])
        delta = cur - self._cum
        self._cum = cur
        lane_sums = delta.sum(axis=1)
        self.totals += lane_sums
        self.tick = int(tick)
        work = delta[0] + delta[2] + delta[3]
        if work.any():
            dt = self.tick - self._score_tick
            if dt > 0:
                self.score *= 0.5 ** (dt / self.half_life)
                self._score_tick = self.tick
            self.score += work
            self.last_active[work > 0] = self.tick
        return tuple(int(v) for v in lane_sums)

    def reset_group(self, g: int) -> None:
        """Purged lane: the device counters restart at 0 — the mirror
        must too, or the next drain folds a negative delta."""
        self._cum[:, g] = 0
        self.score[g] = 0.0
        self.last_active[g] = -1

    # ---------------------------------------------------------- queries

    def active_set_size(self) -> int:
        """Groups with client work inside the trailing window."""
        ever = self.last_active >= 0
        return int((ever & (self.tick - self.last_active
                            <= self.window)).sum())

    def top_k(self, k: int) -> list:
        """The k hottest groups by decayed work score (score > 0 only),
        hottest first, with their cumulative lane counters."""
        k = max(0, min(int(k), self.n_groups))
        order = np.argsort(-self.score, kind="stable")[:k]
        decay = 0.5 ** (max(self.tick - self._score_tick, 0)
                        / self.half_life)
        out = []
        for g in order.tolist():
            if self.score[g] <= 0.0:
                break
            out.append({
                "group": int(g),
                "score": round(float(self.score[g] * decay), 3),
                "appended": int(self._cum[0, g]),
                "sent": int(self._cum[1, g]),
                "commits": int(self._cum[2, g]),
                "reads": int(self._cum[3, g]),
                "idle_ticks": int(self.tick - self.last_active[g]),
            })
        return out

    def idleness_histogram(self) -> dict:
        """Idleness-age distribution over groups that ever saw client
        work, plus the never-active count."""
        ever = self.last_active >= 0
        ages = (self.tick - self.last_active[ever]).astype(np.int64)
        bounds = np.asarray(IDLE_BUCKETS, np.int64)
        counts = np.zeros(len(IDLE_BUCKETS) + 1, np.int64)
        if len(ages):
            counts[:-1] = (ages[None, :] <= bounds[:, None]).sum(axis=1)
            counts[-1] = len(ages)
            # Cumulative -> per-bucket.
            counts[1:] = np.diff(counts)
        return {
            "le_ticks": [int(b) for b in IDLE_BUCKETS] + ["inf"],
            "counts": counts.tolist(),
            "never_active": int((~ever).sum()),
        }

    def snapshot(self, k: int = 16) -> dict:
        """The /heatmap document."""
        return {
            "tick": self.tick,
            "half_life_ticks": self.half_life,
            "window_ticks": self.window,
            "active_set": self.active_set_size(),
            "groups": self.n_groups,
            "totals": {name: int(v)
                       for name, v in zip(LANES, self.totals)},
            "top": self.top_k(k),
            "idleness": self.idleness_histogram(),
        }


def heat_registry_from_env(n_groups: int) -> HeatRegistry:
    """Build a registry with env-tunable decay/window:
    RAFT_HEAT_HALF_LIFE (ticks, default 64) and RAFT_HEAT_WINDOW
    (ticks, default 64)."""
    import os

    half = float(os.environ.get("RAFT_HEAT_HALF_LIFE", "64"))
    window = int(os.environ.get("RAFT_HEAT_WINDOW", "64"))
    return HeatRegistry(n_groups, half_life_ticks=max(half, 1.0),
                        active_window_ticks=max(window, 1))
