"""Process-wide I/O fault hook for the host storage tier.

The WAL engines carry their own per-engine fault tables (native: the
fault fields in ``struct Wal``; Python: ``PyWal._faults``) because the
hot path must not pay a Python call per record.  The *cold* storage
paths — ConfMeta flush, snapshot-archive copy/fsync — instead consult
this module-level hook, which a test (typically via
``testkit.faultfs``) installs for the duration of a scenario.

The hook is a callable ``hook(op: str, path: str) -> None`` that may:

* return normally            — no fault;
* raise ``OSError``          — injected failure (errno chosen by the
                               scheduler, e.g. EIO / ENOSPC);
* raise ``TornWrite(keep=n)``— the caller should persist only the
                               first ``n`` bytes, then fail;
* ``time.sleep``             — injected slow-I/O (gray failure).

Op names in use: ``"conf.flush"``, ``"archive.write"``,
``"archive.fsync"``.  Production runs never install a hook, so
``check`` is a single global load + ``is None`` test.
"""

from __future__ import annotations

import errno
from typing import Callable, Optional

Hook = Callable[[str, str], None]

_hook: Optional[Hook] = None


class TornWrite(OSError):
    """Injected short write: persist only the first ``keep`` bytes of the
    staged buffer, then fail the operation (simulates a crash/medium
    error mid-write).  Callers that cannot honor partial persistence
    treat it as a plain I/O error."""

    def __init__(self, keep: int = 0):
        super().__init__(errno.EIO, f"injected torn write (keep={keep})")
        self.keep = keep


def install(hook: Hook) -> Optional[Hook]:
    """Install ``hook`` process-wide; returns the previous hook so tests
    can nest/restore."""
    global _hook
    prev = _hook
    _hook = hook
    return prev


def uninstall() -> None:
    global _hook
    _hook = None


def installed() -> bool:
    return _hook is not None


def check(op: str, path: str) -> None:
    """Consult the hook (no-op when none installed)."""
    h = _hook
    if h is not None:
        h(op, path)
