"""Storage-fault nemesis: seeded host-I/O fault plans + injection glue.

The device nemesis (testkit/nemesis.py) compiles network/crash scenarios
into dense per-tick schedules; this module is its *storage* twin for the
host durability tier.  The injection *plane* already lives inside the
engines — the per-engine fault tables in ``log/wal.py`` (Python tier)
and ``log/native/wal.cpp`` (native tier, exported as ``wal_fault_set``/
``wal_fault_clear``) plus the process-wide cold-path hook in
``utils/iofault.py`` — so this module is pure *policy*:

* :func:`plan_storage_faults` — a deterministic, seeded per-tick plan of
  engine-level faults (failed fsync, ENOSPC, torn/short write, slow
  I/O), a pure function of ``(shape, seed)`` exactly like the nemesis
  generators: the same seed replays the same storage scenario on either
  WAL tier.
* :class:`FaultInjector` — walks a plan alongside the node's tick loop,
  arming each event on the LogStore's fault table the tick before it is
  scheduled to fire.
* :class:`ColdFaults` — an installable ``utils.iofault`` hook for the
  cold paths (ConfMeta flush, snapshot-archive write/fsync) with
  one-shot arming and restore-on-exit.
* :func:`flip_bits` — deterministic at-rest corruption (the "cosmic
  ray"/firmware-lie stand-in) for checksum/scrub tests.

Faults are armed through public surfaces only (``LogStore.set_fault``,
``iofault.install``); nothing here monkeypatches os/file internals, so
the same plans drive the native engine byte-for-byte.
"""

from __future__ import annotations

import errno
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import iofault

__all__ = [
    "FaultEvent", "plan_storage_faults", "FaultInjector", "ColdFaults",
    "flip_bits",
]

# Engine-level ops (log/wal.py _FAULT_OPS): value semantics per op are
#   fsync/write -> errno (0 = EIO), short -> bytes kept, delay -> usec.
ENGINE_OPS = ("fsync", "write", "short", "delay")


@dataclass(frozen=True)
class FaultEvent:
    """One armed fault: at ``tick``, arm ``op`` on WAL stripe ``shard``
    so that the ``(after + 1)``-th matching engine call fires with
    ``value`` (errno / bytes-kept / microseconds, per op)."""
    tick: int
    op: str
    shard: int = 0
    after: int = 0
    value: int = 0


def plan_storage_faults(n_ticks: int, n_shards: int = 1, *, seed: int = 0,
                        fsync_p: float = 0.0, enospc_p: float = 0.0,
                        short_p: float = 0.0, delay_p: float = 0.0,
                        delay_us: int = 2000,
                        max_events: Optional[int] = None
                        ) -> Tuple[FaultEvent, ...]:
    """Compile a seeded storage-fault scenario into a flat event plan.

    Each ``(tick, shard)`` cell independently draws at most ONE fault,
    tested in severity order (fail-stop fsync, then ENOSPC, then torn
    write, then slow I/O) — mirroring how the nemesis generators draw
    per-cell faults.  Pure function of the arguments: the same seed
    yields the identical plan, and the engines' fault tables are
    deterministic, so a failing storage scenario replays exactly.

    ``max_events`` caps the plan (earliest events win) so acceptance
    runs can bound how much of the cluster they poison.
    """
    rng = np.random.default_rng(seed)
    events: List[FaultEvent] = []
    for t in range(n_ticks):
        for s in range(n_shards):
            r = rng.random(4)
            keep = int(rng.integers(0, 48))  # drawn always: keeps the
            # stream position independent of which branch fires below.
            if r[0] < fsync_p:
                events.append(FaultEvent(t, "fsync", s, 0, errno.EIO))
            elif r[1] < enospc_p:
                events.append(FaultEvent(t, "write", s, 0, errno.ENOSPC))
            elif r[2] < short_p:
                events.append(FaultEvent(t, "short", s, 0, keep))
            elif r[3] < delay_p:
                events.append(FaultEvent(t, "delay", s, 0, int(delay_us)))
    if max_events is not None:
        events = events[:max_events]
    return tuple(events)


class FaultInjector:
    """Arm a plan's events on a LogStore in step with the tick loop.

    Call :meth:`advance` with the node's tick number BEFORE driving that
    tick; every event scheduled for it is armed on the store's fault
    table (``LogStore.set_fault``) and will fire from inside the engine
    when the host phase touches the faulted stripe.  Events for poisoned
    stripes still arm harmlessly — a fail-stop engine refuses all
    further I/O regardless.
    """

    def __init__(self, store, plan: Sequence[FaultEvent]):
        self.store = store
        self._by_tick: Dict[int, List[FaultEvent]] = defaultdict(list)
        for ev in plan:
            self._by_tick[ev.tick].append(ev)
        self.armed_total = 0

    def advance(self, tick: int) -> List[FaultEvent]:
        """Arm all events scheduled for ``tick``; returns them."""
        evs = self._by_tick.pop(tick, [])
        for ev in evs:
            self.store.set_fault(ev.op, after=ev.after, value=ev.value,
                                 shard=ev.shard)
            self.armed_total += 1
        return evs

    @property
    def pending(self) -> int:
        return sum(len(v) for v in self._by_tick.values())


class ColdFaults:
    """One-shot fault hook for the cold storage paths (``utils.iofault``
    ops: ``"conf.flush"``, ``"archive.write"``, ``"archive.fsync"``).

    Use as a context manager; arms are one-shot (consumed when they
    fire) and the previously installed hook — normally none — is
    restored on exit::

        with ColdFaults() as cf:
            cf.arm("archive.fsync", err=errno.EIO)
            ...  # next archive seal fails once
    """

    def __init__(self):
        # op -> [remaining-skips, thrower-or-delay]
        self._armed: Dict[str, list] = {}
        self._prev = None
        self.fired: List[Tuple[str, str]] = []

    def arm(self, op: str, *, err: Optional[int] = None,
            torn_keep: Optional[int] = None, delay_s: float = 0.0,
            after: int = 0) -> "ColdFaults":
        self._armed[op] = [after, (err, torn_keep, delay_s)]
        return self

    def __call__(self, op: str, path: str) -> None:
        ent = self._armed.get(op)
        if ent is None:
            return
        if ent[0] > 0:
            ent[0] -= 1
            return
        err, torn_keep, delay_s = ent[1]
        del self._armed[op]  # one-shot
        self.fired.append((op, path))
        if delay_s > 0:
            time.sleep(delay_s)
            return
        if torn_keep is not None:
            raise iofault.TornWrite(keep=torn_keep)
        e = errno.EIO if err is None else err
        raise OSError(e, f"injected {op} fault")

    def __enter__(self) -> "ColdFaults":
        self._prev = iofault.install(self)
        return self

    def __exit__(self, *exc) -> None:
        if self._prev is not None:
            iofault.install(self._prev)
        else:
            iofault.uninstall()


def flip_bits(path: str, seed: int = 0, n_flips: int = 1,
              skip: int = 0) -> List[Tuple[int, int]]:
    """Deterministically flip ``n_flips`` bits of the file at ``path``
    (offsets drawn past byte ``skip``), modeling silent at-rest
    corruption the CRC-32C sidecars must catch.  Returns the flipped
    ``(offset, bit)`` pairs so a test can assert the corruption landed.
    """
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        if len(data) <= skip:
            raise ValueError(f"{path}: nothing to corrupt past {skip}")
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(n_flips):
            off = int(rng.integers(skip, len(data)))
            bit = int(rng.integers(0, 8))
            data[off] ^= (1 << bit)
            out.append((off, bit))
        f.seek(0)
        f.write(bytes(data))
        f.truncate()
    return out
