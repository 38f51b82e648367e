"""Shared trivial state machines for benchmarks and tests.

``NullMachine`` counts applies with no per-entry I/O (so a harness
measures the framework, not fixture work); ``NullProvider`` hands one per
group.  The checkpoint is a one-line temp file so the snapshot/compaction
lifecycle still runs end to end (the reference's test machines are
likewise minimal file fixtures, cluster/cmd/FileMachine.java).
"""

from __future__ import annotations

import os
import tempfile

from ..machine.spi import Checkpoint, MachineProvider, RaftMachine


class NullMachine(RaftMachine):
    applies_empty = True   # counts no-ops like any apply

    def __init__(self):
        self._applied = 0

    def last_applied(self) -> int:
        return self._applied

    def apply(self, index: int, payload: bytes):
        self._applied = index
        return index

    def apply_batch(self, start_index: int, payloads) -> list:
        self._applied = start_index + len(payloads) - 1
        return list(range(start_index, start_index + len(payloads)))

    def checkpoint(self, must_include: int) -> Checkpoint:
        fd, path = tempfile.mkstemp()
        os.write(fd, str(self._applied).encode())
        os.close(fd)
        return Checkpoint(path=path, index=self._applied)

    def recover(self, ckpt) -> None:
        with open(ckpt.path) as f:
            self._applied = int(f.read() or 0)

    def close(self) -> None:
        pass

    def destroy(self) -> None:
        pass


class ArenaNullMachine(NullMachine):
    """NullMachine plus the arena apply fast path.  Deliberately a LEAF
    class, not part of NullMachine itself: a test subclass overriding
    ``apply`` on NullMachine must not have an inherited ``apply_run``
    silently bypass its override (the hazard machine/spi.py documents for
    apply_batch applies doubly here)."""

    def apply_run(self, start_index: int, pieces, lens) -> list:
        """Arena fast path (machine/spi.py): the null machine never reads
        payload bytes, so a whole committed run applies in O(1)."""
        n = len(lens)
        self._applied = start_index + n - 1
        return list(range(start_index, start_index + n))


class NullProvider(MachineProvider):
    def __init__(self, _root=None):
        pass

    def bootstrap(self, group: int) -> RaftMachine:
        return ArenaNullMachine()
