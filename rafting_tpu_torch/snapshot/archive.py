"""SnapshotArchive: durable per-group snapshot store.

Disk layout mirrors the reference (command/SnapshotArchive.java:110-242):
one directory per group holding files named ``snapshot_<index:016x>_<term:016x>``,
installed by atomic rename, retaining the last N (reference keeps 5,
context/ContextManager.java:72).  Temp files from interrupted transfers
are swept at open (SnapshotArchive.java:127-132).  A PendingSnapshot
tracks at most one in-flight remote download per group
(SnapshotArchive.java:197-211).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import shutil
import threading
from typing import Dict, List, Optional

from ..utils import iofault
from ..utils.crc32c import crc32c_file

log = logging.getLogger(__name__)

_NAME = re.compile(r"^snapshot_([0-9a-f]{16})_([0-9a-f]{16})$")

# Integrity sidecar: every archived snapshot file gets a small JSON
# companion at `<path>.crc` recording its CRC-32C and byte length, written
# atomically AFTER the payload is fsynced.  The payload file itself stays
# pristine bytes — state machines read checkpoint paths raw, and the
# remote-install path streams them verbatim — so integrity metadata must
# live beside the data, not inside it.  The receiving node recomputes the
# CRC over the bytes it actually landed on disk, making the check
# end-to-end across the transfer at the storage layer.  Snapshots from
# before this scheme have no sidecar and verify as "legacy".
_CRC_SUFFIX = ".crc"
_CORRUPT_SUFFIX = ".corrupt"  # quarantined files keep their bytes for
                              # post-mortem; no scan pattern matches them


@dataclasses.dataclass(frozen=True)
class Snapshot:
    path: str
    index: int
    term: int


@dataclasses.dataclass
class PendingSnapshot:
    """One in-flight snapshot download/install for a group."""
    index: int
    term: int
    from_peer: int
    failed: bool = False

    def expired_by(self, index: int, term: int) -> bool:
        """A newer offer supersedes this one (reference PendingSnapshot
        ordering, SnapshotArchive.java:30-76)."""
        return (term, index) > (self.term, self.index)


class SnapshotArchive:
    def __init__(self, root: str, retain: int = 5):
        self.root = root
        self.retain = retain
        os.makedirs(root, exist_ok=True)
        self._pending: Dict[int, PendingSnapshot] = {}
        # Hot-path caches: group dirs already created, and the FULL sorted
        # snapshot manifest per group.  The manifest makes checkpoint
        # rotation O(1): save_checkpoint appends to it and prunes from its
        # head instead of re-listing and re-stat'ing the directory on
        # every call (the listdir+stat retention storm was 16k+ posix.stat
        # calls per durable bench run).  A group's manifest is warmed once
        # (first touch after open) and maintained by every mutation; the
        # directory is re-read only on that first touch.
        self._dirs: set = set()
        self._manifest: Dict[int, List[Snapshot]] = {}
        # Per-group incarnation counter bumped by destroy(), plus the lock
        # that makes check-gen-then-cache atomic against it: a cache-miss
        # read that overlapped a destroy must not write its (now dead)
        # listing back into the manifest — see last_snapshot.  The same
        # lock orders manifest mutations from the checkpoint worker pool
        # (runtime/node.py off-thread saves) against the tick thread's
        # installs/serves; manifest critical sections are a few list ops —
        # file I/O (copy, unlink) always happens outside it.
        self._gen: Dict[int, int] = {}
        self._gen_lock = threading.Lock()
        # Sweep temp droppings from interrupted installs.
        for name in os.listdir(root):
            if name.endswith(".tmp"):
                try:
                    os.unlink(os.path.join(root, name))
                except OSError:
                    pass
            elif os.path.isdir(os.path.join(root, name)):
                gdir = os.path.join(root, name)
                for f in os.listdir(gdir):
                    if f.endswith(".tmp"):
                        try:
                            os.unlink(os.path.join(gdir, f))
                        except OSError:
                            pass

    def _gdir(self, g: int) -> str:
        d = os.path.join(self.root, f"g{g}")
        if g not in self._dirs:
            os.makedirs(d, exist_ok=True)
            self._dirs.add(g)
        return d

    def groups_with_snapshots(self, n_groups: Optional[int] = None
                              ) -> List[int]:
        """Group ids that have an on-disk snapshot directory — ONE listdir
        of the archive root, no per-group mkdir/stat.  Boot recovery
        iterates this instead of range(n_groups): a 100k-group cold start
        with a handful of snapshotted groups costs one directory read,
        not 100k makedirs (each _gdir call CREATES the directory).  The
        listing may include groups whose directories exist but hold no
        snapshot files; callers filter via last_snapshot."""
        out: List[int] = []
        for name in os.listdir(self.root):
            if not name.startswith("g"):
                continue
            try:
                g = int(name[1:])
            except ValueError:
                continue
            if n_groups is not None and g >= n_groups:
                continue
            out.append(g)
        out.sort()
        return out

    # -- local snapshots -----------------------------------------------------

    def save_checkpoint(self, g: int, src_path: str, index: int,
                        term: int) -> Snapshot:
        """Archive a machine checkpoint as the group's newest snapshot
        (atomic move; ordering asserted like SnapshotArchive.java:138-182).

        Safe off the tick thread: the node runtime runs local checkpoint
        saves on its worker pool (group-sharded, so one group's saves
        stay ordered); the manifest keeps rotation O(1) — no listdir or
        per-file stat on this path, ever."""
        last = self.last_snapshot(g)
        if last is not None:
            assert (term, index) >= (last.term, last.index), \
                f"snapshot ordering violated: ({index},{term}) after " \
                f"({last.index},{last.term})"
            if (index, term) == (last.index, last.term):
                return last
        dst = os.path.join(self._gdir(g), f"snapshot_{index:016x}_{term:016x}")
        # Writer-unique temp name (still *.tmp so the open() sweep catches
        # droppings): a tick-thread install and a pool worker's save must
        # never collide on one temp path.
        tmp = f"{dst}.{threading.get_ident()}.tmp"
        iofault.check("archive.write", dst)
        shutil.copyfile(src_path, tmp)
        # Durability + integrity before the atomic publish: fsync the
        # payload, then record its CRC-32C — computed from the bytes ON
        # DISK, so a copy/transfer corruption is caught here or by the
        # scrubber, never served onward as good.
        crc, size = self._fsync_and_crc(tmp)
        os.replace(tmp, dst)
        self._write_sidecar(dst, crc, size)
        snap = Snapshot(dst, index, term)
        with self._gen_lock:
            m = self._manifest.setdefault(g, [])
            if not m or (snap.term, snap.index) > (m[-1].term, m[-1].index):
                m.append(snap)
            drop, self._manifest[g] = m[:-self.retain], m[-self.retain:]
        for s in drop:
            for p in (s.path, s.path + _CRC_SUFFIX):
                try:
                    os.unlink(p)
                except OSError:
                    pass
        return snap

    @staticmethod
    def _fsync_and_crc(path: str):
        with open(path, "rb") as f:
            iofault.check("archive.fsync", path)
            os.fsync(f.fileno())
        return crc32c_file(path), os.path.getsize(path)

    @staticmethod
    def _write_sidecar(path: str, crc: int, size: int) -> None:
        tmp = path + _CRC_SUFFIX + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"algo": "crc32c", "crc": int(crc), "len": int(size)},
                      f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path + _CRC_SUFFIX)

    # -- integrity: verify / quarantine / scrub ------------------------------

    @staticmethod
    def verify_snapshot(path: str) -> str:
        """Check one archived snapshot against its sidecar.  Returns
        ``"ok"`` (checksum matches), ``"legacy"`` (no sidecar — predates
        the scheme, accepted), ``"corrupt"`` (length or CRC mismatch, or
        unreadable payload with a sidecar present), or ``"missing"`` (the
        payload file is gone)."""
        if not os.path.exists(path):
            return "missing"
        try:
            with open(path + _CRC_SUFFIX) as f:
                meta = json.load(f)
            want_crc = int(meta["crc"])
            want_len = int(meta["len"])
        except (OSError, ValueError, KeyError):
            return "legacy"
        try:
            if os.path.getsize(path) != want_len:
                return "corrupt"
            return "ok" if crc32c_file(path) == want_crc else "corrupt"
        except OSError:
            return "corrupt"

    def quarantine(self, g: int, snap: Snapshot) -> None:
        """Fail-stop a corrupt archived snapshot: move the bytes aside
        (kept for post-mortem under ``*.corrupt``) and drop it from the
        manifest so no reader — recovery, serve, retention — ever hands
        it out again."""
        log.error("snapshot archive: quarantining corrupt %s", snap.path)
        try:
            os.replace(snap.path, snap.path + _CORRUPT_SUFFIX)
        except OSError:
            pass
        try:
            os.unlink(snap.path + _CRC_SUFFIX)
        except OSError:
            pass
        with self._gen_lock:
            m = self._manifest.get(g)
            if m is not None:
                self._manifest[g] = [s for s in m if s.path != snap.path]

    def verified_last_snapshot(self, g: int) -> Optional[Snapshot]:
        """Newest snapshot that passes verification, quarantining any
        corrupt newer ones on the way down — the verify-on-recovery walk:
        a corrupt newest milestone falls back to the previous one (WAL
        replay above it restores the rest)."""
        while True:
            snap = self.last_snapshot(g)
            if snap is None:
                return None
            v = self.verify_snapshot(snap.path)
            if v in ("ok", "legacy"):
                return snap
            self.quarantine(g, snap)

    def scrub(self, g: int, limit: int = 0):
        """Verify up to ``limit`` (0 = all) of a group's archived
        snapshots, newest first; corrupt ones are quarantined.  Returns
        ``(ok, corrupt)`` counts — the background scrubber's unit of
        work."""
        ok = corrupt = 0
        for snap in reversed(self.list_snapshots(g)):
            if limit and ok + corrupt >= limit:
                break
            v = self.verify_snapshot(snap.path)
            if v == "corrupt":
                self.quarantine(g, snap)
                corrupt += 1
            elif v in ("ok", "legacy"):
                ok += 1
        return ok, corrupt

    def last_snapshot(self, g: int) -> Optional[Snapshot]:
        with self._gen_lock:
            m = self._manifest.get(g)
            if m is not None:
                return m[-1] if m else None
            gen = self._gen.get(g, 0)
        snaps = self._scan_dir(g)
        # The gen check and the write-back must be ONE atomic step (under
        # _gen_lock, paired with destroy's pop+bump): a bare
        # check-then-setdefault leaves a preemption window in which
        # destroy() completes between the two and the dead listing gets
        # cached anyway — handing out a deleted path and pinning a stale
        # manifest that a recreated group's save_checkpoint would trip
        # its ordering assert on.
        with self._gen_lock:
            if self._gen.get(g, 0) != gen:
                # destroy() completed while this miss was listing: the
                # listing belongs to the dead incarnation.
                return None
            # setdefault, not assignment: if another thread archived a
            # NEWER snapshot while this (possibly transport-thread) miss
            # was listing the directory, its manifest must win — a stale
            # write-back here would pin an old/empty view until the
            # group's next checkpoint.
            m = self._manifest.setdefault(g, snaps)
            return m[-1] if m else None

    def list_snapshots(self, g: int) -> List[Snapshot]:
        with self._gen_lock:
            m = self._manifest.get(g)
            if m is not None:
                return list(m)
            gen = self._gen.get(g, 0)
        snaps = self._scan_dir(g)
        with self._gen_lock:
            if self._gen.get(g, 0) != gen:
                return []
            return list(self._manifest.setdefault(g, snaps))

    def _scan_dir(self, g: int) -> List[Snapshot]:
        """Cold read of a group directory (manifest warm-up only)."""
        d = self._gdir(g)
        out = []
        try:
            names = os.listdir(d)
        except OSError:
            # destroy()'s rmtree raced this listing (the _dirs cache said
            # the dir existed): the group is gone — an empty listing, not
            # a crash in the snapshot-serving thread.
            return []
        for name in names:
            m = _NAME.match(name)
            if m:
                out.append(Snapshot(os.path.join(d, name),
                                    int(m.group(1), 16), int(m.group(2), 16)))
        out.sort(key=lambda s: (s.term, s.index))
        return out

    # -- remote installs -----------------------------------------------------

    def pend_snapshot(self, g: int, index: int, term: int,
                      from_peer: int) -> Optional[PendingSnapshot]:
        """Register an in-flight download unless one is already pending for
        an equal-or-newer milestone.  Returns the new pending record, or
        None if the existing one stands (SnapshotArchive.java:197-211)."""
        cur = self._pending.get(g)
        if cur is not None and not cur.failed and \
                not cur.expired_by(index, term):
            return None
        p = PendingSnapshot(index=index, term=term, from_peer=from_peer)
        self._pending[g] = p
        return p

    def pending(self, g: int) -> Optional[PendingSnapshot]:
        return self._pending.get(g)

    def install_pending(self, g: int, data_path: str,
                        index: Optional[int] = None,
                        term: Optional[int] = None) -> Snapshot:
        """Download finished: atomically archive the received snapshot.

        ``index``/``term`` are the milestone the serving peer ACTUALLY
        returned (it may serve a newer snapshot than requested); they default
        to the pending request's milestone.  If a newer snapshot was archived
        locally while the download was in flight (local checkpoint racing the
        transfer), the download is discarded and the newer local snapshot is
        returned instead — the caller recovers from whichever is returned."""
        p = self._pending.get(g)
        assert p is not None, "no pending snapshot"
        index = p.index if index is None else index
        term = p.term if term is None else term
        try:
            last = self.last_snapshot(g)
            if last is not None and (last.term, last.index) > (term, index):
                return last
            return self.save_checkpoint(g, data_path, index, term)
        finally:
            del self._pending[g]

    def fail_pending(self, g: int) -> None:
        p = self._pending.get(g)
        if p is not None:
            p.failed = True

    def clear_pending(self, g: int) -> None:
        self._pending.pop(g, None)

    def destroy(self, g: int) -> None:
        shutil.rmtree(self._gdir(g), ignore_errors=True)
        self._pending.pop(g, None)
        self._dirs.discard(g)
        # Pop and bump under the lock, AFTER the rmtree: a concurrent
        # last_snapshot miss either wins the lock first (its possibly
        # pre-rmtree cache entry is popped right here) or enters after
        # and sees the bumped gen, discarding its dead listing.  A miss
        # that starts after the bump lists the (empty) new-incarnation
        # directory — caching that is correct.
        with self._gen_lock:
            self._manifest.pop(g, None)
            self._gen[g] = self._gen.get(g, 0) + 1
