"""Snapshot subsystem: durable archive + maintain policy.

* :class:`SnapshotArchive` — per-group on-disk snapshot store with atomic
  installs, bounded retention and pending-download tracking (reference
  command/SnapshotArchive.java:15-244).
* :class:`MaintainAgreement` — the *when* policy: thresholds and cadences
  deciding when to checkpoint the machine and when to compact the log
  (reference command/MaintainAgreement.java:12-145).
"""

from .archive import PendingSnapshot, Snapshot, SnapshotArchive  # noqa: F401
from .policy import MaintainAgreement  # noqa: F401
