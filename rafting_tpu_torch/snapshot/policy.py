"""MaintainAgreement: when to checkpoint machines and compact logs.

Port of the reference's policy semantics (command/MaintainAgreement.java):
a checkpoint is triggered when enough state changes accumulated
(``state_change_threshold``), the dirty log is long enough
(``dirty_log_tolerance``) and minimum intervals elapsed
(MaintainAgreement.java:85-103); log compaction runs on its own cadence
gated on an existing snapshot (118-130).  Times here are node ticks, not
wall-clock — the policy is driven once per runtime tick.

One instance tracks ALL groups in numpy lanes (the policy itself is
vectorized; only the actual checkpoint work is per-group host code).
"""

from __future__ import annotations

import numpy as np


class MaintainAgreement:
    def __init__(self, n_groups: int, *,
                 state_change_threshold: int = 64,
                 dirty_log_tolerance: int = 16,
                 snap_min_interval: int = 20,
                 compact_min_interval: int = 10,
                 compact_slack: int = 8):
        G = n_groups
        self.state_change_threshold = state_change_threshold
        self.dirty_log_tolerance = dirty_log_tolerance
        self.snap_min_interval = snap_min_interval
        self.compact_min_interval = compact_min_interval
        self.compact_slack = compact_slack
        # Phase-stagger the cadences across groups: groups booted together
        # would otherwise cross their thresholds TOGETHER, turning
        # maintenance into a synchronized storm (thousands of checkpoint
        # file copies in one tick — a multi-second stall at 8k+ groups)
        # instead of a steady trickle.
        self.last_snap_tick = -(np.arange(G, dtype=np.int64)
                                % max(snap_min_interval, 1))
        self.last_compact_tick = -(np.arange(G, dtype=np.int64)
                                   % max(compact_min_interval, 1))
        self.snap_index = np.zeros(G, np.int64)     # newest archived snapshot
        self.applied_at_snap = np.zeros(G, np.int64)

    def need_checkpoint(self, now: int, applied: np.ndarray,
                        log_base: np.ndarray) -> np.ndarray:
        """[G] bool: machines whose state moved enough to checkpoint
        (MaintainAgreement.needMaintain, 85-103)."""
        changed = applied - self.applied_at_snap
        dirty = applied - log_base
        due = now - self.last_snap_tick >= self.snap_min_interval
        return ((changed >= self.state_change_threshold)
                & (dirty >= self.dirty_log_tolerance) & due)

    def note_checkpoint(self, g: int, now: int, index: int) -> None:
        self.last_snap_tick[g] = now
        self.snap_index[g] = index
        self.applied_at_snap[g] = index

    def compact_targets(self, now: int, commit: np.ndarray,
                        log_base: np.ndarray) -> np.ndarray:
        """[G] int: compact-to index per group (0 = keep).  Compaction never
        passes the newest snapshot (the reference gates flush on the
        snapshot milestone, RaftRoutine.compactLog:365-400) and keeps
        ``compact_slack`` committed entries for briefly-lagging followers."""
        due = now - self.last_compact_tick >= self.compact_min_interval
        target = np.minimum(self.snap_index,
                            np.maximum(commit - self.compact_slack, 0))
        target = np.where(due & (target > log_base), target, 0)
        if target.any():
            self.last_compact_tick = np.where(
                target > 0, now, self.last_compact_tick)
        return target.astype(np.int64)
