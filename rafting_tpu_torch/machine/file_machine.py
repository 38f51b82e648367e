"""FileMachine: the cross-implementation correctness oracle.

Re-creation of the reference's test fixture machine (curioloop/rafting
test cluster/cmd/FileMachine.java:14-142): every committed command appends
an ``index:line`` row to a text file, so two replicas are correct iff
their files are byte-identical — the reference's whole-system oracle
(README.md:28-33).  Checkpoint = file copy under the archive dir
(FileMachine.java:87-104); recover validates that the checkpoint is a
prefix-extension of current state before replacing it
(FileMachine.java:121-131).
"""

from __future__ import annotations

import glob
import os
import shutil
from typing import Any, Optional

from .spi import Checkpoint


class FileMachine:
    # Opt into election no-ops (machine/spi.py): an empty command appends
    # an 'index:' line, keeping replica files byte-identical incl. no-ops.
    applies_empty = True

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a+")
        self._last_applied = self._count_lines()
        # One startup sweep for crash leftovers; afterwards checkpoints are
        # tracked in memory (a glob per checkpoint scans the whole shared
        # machines dir — O(groups) per call, O(groups^2) per tick at scale).
        self._prune_ckpts()
        self._last_ckpt: Optional[str] = None

    def _count_lines(self) -> int:
        """last_applied = index of the final line (reference counts lines,
        FileMachine.java:27-31; here lines carry their index explicitly)."""
        self._f.seek(0)
        last = 0
        for line in self._f:
            head, _, _ = line.partition(":")
            if head.isdigit():
                last = int(head)
        self._f.seek(0, os.SEEK_END)
        return last

    def last_applied(self) -> int:
        return self._last_applied

    def apply(self, index: int, payload: bytes) -> Any:
        assert index == self._last_applied + 1, \
            f"apply out of order: {index} after {self._last_applied}"
        # Escape newlines/backslashes so one committed entry is always one
        # physical line — the invariant _count_lines and recover depend on.
        line = (payload.decode("utf-8", "replace")
                .replace("\\", "\\\\").replace("\n", "\\n"))
        self._f.write(f"{index}:{line}\n")
        self._f.flush()
        self._last_applied = index
        return index

    def apply_batch(self, start_index: int, payloads) -> list:
        """Batched apply (SPI fast path, spi.py): all lines in one write +
        one flush instead of one syscall pair per entry."""
        assert start_index == self._last_applied + 1, \
            f"apply out of order: {start_index} after {self._last_applied}"
        lines = []
        for k, payload in enumerate(payloads):
            line = (payload.decode("utf-8", "replace")
                    .replace("\\", "\\\\").replace("\n", "\\n"))
            lines.append(f"{start_index + k}:{line}\n")
        self._f.write("".join(lines))
        self._f.flush()
        self._last_applied = start_index + len(payloads) - 1
        return list(range(start_index, start_index + len(payloads)))

    def checkpoint(self, must_include: int) -> Checkpoint:
        assert self._last_applied >= must_include
        os.fsync(self._f.fileno())
        if self._last_ckpt:
            try:
                os.unlink(self._last_ckpt)
            except OSError:
                pass
        tmp = f"{self.path}.ckpt.{self._last_applied}"
        shutil.copyfile(self.path, tmp)
        self._last_ckpt = tmp
        return Checkpoint(path=tmp, index=self._last_applied)

    def _prune_ckpts(self) -> None:
        for p in glob.glob(f"{self.path}.ckpt.*"):
            try:
                os.unlink(p)
            except OSError:
                pass

    def recover(self, checkpoint: Checkpoint) -> None:
        # Prefix validation (reference FileMachine.java:121-131): current
        # state must be a prefix of the checkpoint or vice versa; a
        # divergent file means the oracle caught an inconsistency.
        with open(checkpoint.path, "r") as src:
            new_lines = src.readlines()
        self._f.seek(0)
        cur_lines = self._f.readlines()
        common = min(len(new_lines), len(cur_lines))
        if new_lines[:common] != cur_lines[:common]:
            raise AssertionError(
                f"snapshot diverges from local state at {self.path}")
        self._f.close()
        shutil.copyfile(checkpoint.path, self.path)
        self._f = open(self.path, "a+")
        self._last_applied = checkpoint.index

    def close(self) -> None:
        self._f.close()

    def destroy(self) -> None:
        self._f.close()
        self._prune_ckpts()
        if os.path.exists(self.path):
            os.unlink(self.path)

    def lines(self):
        self._f.seek(0)
        out = self._f.readlines()
        self._f.seek(0, os.SEEK_END)
        return out


class FileMachineProvider:
    """One file per group under a root dir (reference
    cluster/cmd/FileMachineProvider.java:13-40)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def bootstrap(self, group: int) -> FileMachine:
        return FileMachine(os.path.join(self.root, f"group_{group}.txt"))
