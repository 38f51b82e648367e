"""WAL storage engine binding: native C++ backend with a Python fallback.

The native engine lives in ``native/wal.cpp`` (see its header comment for
the record format and recovery semantics).  It is compiled on first use
with the system toolchain and loaded through ctypes — the binding style
this environment supports (no pybind11).  ``PyWal`` reimplements the same
contract in pure Python for platforms without a compiler; both backends
read/write the identical on-disk format (cross-checked in
tests/test_wal.py).

Durability contract (the ack-after-fsync rule every engine here obeys):
``append_*``/``truncate``/``milestone``/``append_stable`` only STAGE
records — nothing is durable, and the caller must not acknowledge
anything that depends on a staged record, until :meth:`sync` returns.
One ``sync`` is the fsync barrier covering every record staged before it;
the node runtime releases RPC replies and completes client futures only
behind that barrier (persist-before-reply, amortized over all groups),
and the pipelined runtime additionally feeds the post-barrier durable
tail back into the device scan so an un-fsynced range can never be
self-acked into a commit quorum (core/types.py HostInbox.durable_tail).

``ShardedWal`` stripes groups over S independent engines (group ->
shard ``g % S``), each with its own segment files and fsync: a tick's
appends land as one arena call per moved stripe and ``sync`` issues the
S fsyncs in parallel from a small worker pool with a single barrier
join — the barrier completes only when EVERY shard's fsync has, so the
ack-after-fsync contract is unchanged.  The stripe count is pinned in a
``wal_shards.json`` meta file at creation; reopening honors the pinned
value, so recovery can never silently read a half-striped directory.
"""

from __future__ import annotations

import ctypes
import errno as _errno
import os
import struct
import subprocess
import threading
import time
import zlib
from typing import Dict, Optional

from ..utils import iofault


class WalSyncError(IOError):
    """The durability barrier failed in a NON-RETRIABLE way: fsync error,
    torn/short write, or any write failure other than disk-full.

    ``shards`` carries the poisoned engine ids — those engines are
    fail-stop: a failed fsync is never retried on the same fd (the page
    cache may have dropped the dirty pages that failed to reach the
    device, so a later "successful" fsync would be a lie — the
    PostgreSQL fsyncgate lesson).  An EMPTY ``shards`` means a global
    transient (e.g. the ConfMeta sidecar flush) with no engine poisoned:
    the caller may skip the tick and retry at the next barrier.
    ``nospace`` lists any shards that simultaneously hit ENOSPC in the
    same barrier (mixed-failure merge)."""

    def __init__(self, msg: str, shards=(), nospace=()):
        super().__init__(msg)
        self.shards = tuple(shards)
        self.nospace = tuple(nospace)


class WalNoSpace(IOError):
    """The barrier failed with ENOSPC on ``shards`` — RETRIABLE: each
    engine rewound its segment to the last good offset and KEPT its
    staged buffer, so a later barrier retries the flush once space
    frees.  Callers respond with admission backpressure, not
    quarantine."""

    def __init__(self, msg: str, shards=()):
        super().__init__(msg)
        self.shards = tuple(shards)


# Uniform injectable-fault vocabulary across both engines (native op codes).
# "fsync"/"write" fail the guarded call with `value` as errno (0 -> EIO);
# "short" persists only `value` bytes of the staged buffer then poisons;
# "delay" sleeps `value` microseconds at each sync barrier (a level, not a
# countdown — clear by setting 0).
_FAULT_OPS = {"fsync": 1, "write": 2, "short": 3, "delay": 4}


def _merge_wal_errors(excs):
    """Collapse per-shard barrier failures into ONE taxonomy exception:
    non-taxonomy errors win verbatim; otherwise poisoned shards and
    ENOSPC shards are unioned, with WalSyncError taking precedence (a
    barrier that poisoned anything is non-retriable as a whole)."""
    excs = [e for e in excs if e is not None]
    if not excs:
        return None
    for e in excs:
        if not isinstance(e, (WalSyncError, WalNoSpace)):
            return e
    poisoned, nospace = [], []
    for e in excs:
        if isinstance(e, WalSyncError):
            poisoned.extend(e.shards)
            nospace.extend(e.nospace)
        else:
            nospace.extend(e.shards)
    msg = "; ".join(str(e) for e in excs[:4])
    if poisoned:
        return WalSyncError(msg, sorted(set(poisoned)), sorted(set(nospace)))
    return WalNoSpace(msg, sorted(set(nospace)))


_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_SRC = os.path.join(_NATIVE_DIR, "wal.cpp")
_SO = os.path.join(_NATIVE_DIR, "libwal.so")
_build_lock = threading.Lock()
_lib = None
_build_err: Optional[str] = None


def _build_native() -> Optional[str]:
    """Compile the native engine if missing/stale; return error or None."""
    try:
        if (os.path.exists(_SO)
                and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
            return None
        r = subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
             _SRC, "-o", _SO],
            capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            return r.stderr[-2000:]
        return None
    except Exception as e:  # toolchain absent
        return str(e)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_err
    with _build_lock:
        if _lib is not None:
            return _lib
        _build_err = _build_native()
        if _build_err is not None:
            return None
        lib = ctypes.CDLL(_SO)
        lib.wal_open.restype = ctypes.c_void_p
        lib.wal_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.wal_close.argtypes = [ctypes.c_void_p]
        lib.wal_append_entry.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_uint32]
        lib.wal_append_stable.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int64, ctypes.c_int64]
        lib.wal_truncate.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64]
        lib.wal_milestone.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_int64]
        lib.wal_reset.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.wal_sync.argtypes = [ctypes.c_void_p]
        lib.wal_sync.restype = ctypes.c_int
        for f, res in [("wal_tail", ctypes.c_int64),
                       ("wal_floor", ctypes.c_int64),
                       ("wal_floor_term", ctypes.c_int64),
                       ("wal_entry_term", ctypes.c_int64),
                       ("wal_entry_len", ctypes.c_int64)]:
            fn = getattr(lib, f)
            fn.restype = res
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_uint32]
                           + ([ctypes.c_uint64] if "entry" in f else []))
        lib.wal_stable.restype = ctypes.c_int
        lib.wal_stable.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.wal_entry_payload.restype = ctypes.c_int64
        lib.wal_entry_payload.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_uint64]
        lib.wal_checkpoint.argtypes = [ctypes.c_void_p]
        lib.wal_checkpoint.restype = ctypes.c_int
        lib.wal_segment_count.argtypes = [ctypes.c_void_p]
        lib.wal_segment_count.restype = ctypes.c_uint64
        lib.wal_total_bytes.argtypes = [ctypes.c_void_p]
        lib.wal_total_bytes.restype = ctypes.c_uint64
        lib.wal_live_bytes.argtypes = [ctypes.c_void_p]
        lib.wal_live_bytes.restype = ctypes.c_uint64
        lib.wal_export_state.restype = ctypes.c_uint64
        lib.wal_export_state.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.wal_append_entries.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.wal_gc_begin.argtypes = [ctypes.c_void_p]
        lib.wal_gc_begin.restype = ctypes.c_int
        lib.wal_gc_rewrite.argtypes = [ctypes.c_void_p]
        lib.wal_gc_rewrite.restype = ctypes.c_int64
        lib.wal_gc_finish.argtypes = [ctypes.c_void_p]
        lib.wal_gc_finish.restype = ctypes.c_int
        lib.wal_gc_abort.argtypes = [ctypes.c_void_p]
        lib.wal_gc_abort.restype = None
        lib.wal_error.argtypes = [ctypes.c_void_p]
        lib.wal_error.restype = ctypes.c_char_p
        # Native host tier (hasattr-guarded so a stale prebuilt .so still
        # serves the classic surface — callers probe can_stage_native).
        if hasattr(lib, "wal_stage_and_sync"):
            lib.wal_stage_and_sync.restype = ctypes.c_int
            lib.wal_stage_and_sync.argtypes = (
                [ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint32,
                 ctypes.c_uint32]
                + [ctypes.c_void_p] * 13
                + [ctypes.c_int, ctypes.POINTER(ctypes.c_double),
                   ctypes.POINTER(ctypes.c_double)])
            lib.wal_pack_ae.restype = ctypes.c_int64
            lib.wal_pack_ae.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint32,
                ctypes.c_uint32, ctypes.c_uint64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
            lib.wal_buf_free.restype = None
            lib.wal_buf_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        # Injectable fault table (hasattr-guarded like the host tier: a
        # stale prebuilt .so still serves the classic surface).
        if hasattr(lib, "wal_fault_set"):
            lib.wal_fault_set.restype = ctypes.c_int
            lib.wal_fault_set.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64]
            lib.wal_fault_clear.restype = None
            lib.wal_fault_clear.argtypes = [ctypes.c_void_p]
            lib.wal_poisoned.restype = ctypes.c_int
            lib.wal_poisoned.argtypes = [ctypes.c_void_p]
            lib.wal_last_errno.restype = ctypes.c_int
            lib.wal_last_errno.argtypes = [ctypes.c_void_p]
        # Per-stripe instrumentation export (hasattr-guarded like the host
        # tier: a stale prebuilt .so still serves the classic surface).
        if hasattr(lib, "wal_stats"):
            lib.wal_stats.restype = None
            lib.wal_stats.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
        return lib


# wal_stats() export order — one schema for both engines (and the merged
# ShardedWal view): cumulative ns spent staging / fsyncing / packing, bytes
# staged, and call counts.  Counters never reset; consumers keep the last
# snapshot and fold deltas into the metrics registry.
WAL_STAT_KEYS = ("stage_ns", "fsync_ns", "pack_ns", "bytes",
                 "stage_calls", "fsync_calls", "pack_calls")


def native_available() -> bool:
    return _load() is not None


def native_host_available() -> bool:
    """True when the loaded .so exports the native host tier entry points
    (wal_stage_and_sync / wal_pack_ae)."""
    lib = _load()
    return lib is not None and hasattr(lib, "wal_stage_and_sync")


def _shard_split(n_shards: int, g_arr, cols):
    """Stable-sort rows by WAL stripe (``g % S``) into the CSR layout the
    native tier consumes: (sorted group column, sorted value columns,
    ``row_off[S+1]``).  The STABLE sort preserves the staging path's
    per-group ascending contiguous runs within each shard — the property
    the engine's hinted-emplace hot loop relies on."""
    import numpy as np
    stripe = g_arr % np.uint32(n_shards)
    order = np.argsort(stripe, kind="stable")
    sorted_stripe = stripe[order]
    row_off = np.ascontiguousarray(
        np.searchsorted(sorted_stripe, np.arange(n_shards + 1)), np.uint64)
    return (np.ascontiguousarray(g_arr[order]),
            [np.ascontiguousarray(c[order]) for c in cols],
            row_off)


def _native_stage_and_sync(handles, n_shards, engines, workers, sync,
                           groups, idxs, terms, ptrs, lens,
                           trunc_g, trunc_from,
                           floor_g, floor_idx, floor_term):
    """One ctypes crossing for a whole tick's durable work: entries (by raw
    payload pointer), truncations and milestones are split per stripe and
    handed to wal_stage_and_sync, which stages and fsyncs every shard with
    real OS threads (the GIL is released for the duration of the call).
    Returns ``(stage_s, fsync_s)`` — max per-worker wall times."""
    import numpy as np
    lib = _load()
    asc = np.ascontiguousarray
    eg, (ei, et, ep, el), eoff = _shard_split(
        n_shards, asc(groups, np.uint32),
        [asc(idxs, np.uint64), asc(terms, np.int64),
         asc(ptrs, np.uint64), asc(lens, np.uint32)])
    tg, (tf,), toff = _shard_split(
        n_shards, asc(trunc_g, np.uint32), [asc(trunc_from, np.uint64)])
    fg, (fi, ft), foff = _shard_split(
        n_shards, asc(floor_g, np.uint32),
        [asc(floor_idx, np.uint64), asc(floor_term, np.int64)])
    st = ctypes.c_double()
    fs = ctypes.c_double()
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    rc = lib.wal_stage_and_sync(
        handles, n_shards, max(1, int(workers)),
        ptr(eoff), ptr(eg), ptr(ei), ptr(et), ptr(ep), ptr(el),
        ptr(toff), ptr(tg), ptr(tf),
        ptr(foff), ptr(fg), ptr(fi), ptr(ft),
        1 if sync else 0, ctypes.byref(st), ctypes.byref(fs))
    if rc != 0:
        msg = "; ".join(e.error() for e in engines if e.error()) or "unknown"
        bad = [getattr(e, "shard_id", k) for k, e in enumerate(engines)
               if e.poisoned]
        nosp = [getattr(e, "shard_id", k) for k, e in enumerate(engines)
                if not e.poisoned and e.last_errno == _errno.ENOSPC]
        if bad:
            raise WalSyncError(f"wal_stage_and_sync: {msg}", bad, nosp)
        if nosp:
            raise WalNoSpace(f"wal_stage_and_sync: {msg}", nosp)
        raise WalSyncError(f"wal_stage_and_sync: {msg}", ())
    return float(st.value), float(fs.value)


def _native_pack_ae(handles, n_shards, workers, cols, starts, ns):
    """Native AppendEntries blob pack: returns ``(ok_mask, blob)`` where
    ``blob`` is byte-identical to the Python packer's lens-vector +
    payload concatenation for the kept columns, or ``None`` on failure
    (caller falls back to the Python pack loop)."""
    import numpy as np
    lib = _load()
    c = np.ascontiguousarray(cols, np.uint32)
    s = np.ascontiguousarray(starts, np.uint64)
    n = np.ascontiguousarray(ns, np.uint32)
    nc = int(len(c))
    ok = np.ones(nc, np.uint8)
    out = ctypes.POINTER(ctypes.c_uint8)()
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    total = lib.wal_pack_ae(handles, n_shards, max(1, int(workers)), nc,
                            ptr(c), ptr(s), ptr(n), ptr(ok),
                            ctypes.byref(out))
    if total < 0:
        return None
    try:
        blob = ctypes.string_at(out, total) if total else b""
    finally:
        if out:
            lib.wal_buf_free(out)
    return ok.astype(bool), blob


class _NativeWal:
    shard_id = 0  # ShardedWal pins the true stripe id per engine

    def __init__(self, path: str, segment_bytes: int):
        self._lib = _load()
        assert self._lib is not None
        self._h = self._lib.wal_open(path.encode(), segment_bytes)
        if not self._h:
            raise IOError(f"wal_open failed for {path}")
        self._handles = (ctypes.c_void_p * 1)(self._h)

    def error(self) -> str:
        if not self._h:
            return ""
        return (self._lib.wal_error(self._h) or b"").decode(
            "utf-8", "replace")

    # -- injectable fault table (testkit/faultfs) ----------------------
    def set_fault(self, op: str, after: int = 0, value: int = 0) -> None:
        if not hasattr(self._lib, "wal_fault_set"):
            raise RuntimeError("native fault table unavailable (stale .so)")
        if value == 0 and op in ("fsync", "write"):
            value = _errno.EIO
        self._lib.wal_fault_set(self._h, _FAULT_OPS[op], int(after),
                                int(value))

    def clear_faults(self) -> None:
        if self._h and hasattr(self._lib, "wal_fault_clear"):
            self._lib.wal_fault_clear(self._h)

    @property
    def poisoned(self) -> bool:
        if not self._h or not hasattr(self._lib, "wal_poisoned"):
            return False
        return bool(self._lib.wal_poisoned(self._h))

    @property
    def last_errno(self) -> int:
        if not self._h or not hasattr(self._lib, "wal_last_errno"):
            return 0
        return int(self._lib.wal_last_errno(self._h))

    def stats(self) -> Dict[str, int]:
        """Cumulative per-stripe instrumentation (WAL_STAT_KEYS), read
        zero-copy from the engine's atomic counters."""
        if not self._h or not hasattr(self._lib, "wal_stats"):
            return dict.fromkeys(WAL_STAT_KEYS, 0)
        out = (ctypes.c_uint64 * len(WAL_STAT_KEYS))()
        self._lib.wal_stats(self._h, out)
        return dict(zip(WAL_STAT_KEYS, (int(v) for v in out)))

    def _raise_sync_error(self):
        msg = self.error() or "wal_sync failed"
        if self.last_errno == _errno.ENOSPC and not self.poisoned:
            raise WalNoSpace(msg, (self.shard_id,))
        raise WalSyncError(msg, (self.shard_id,))

    @property
    def can_stage_native(self) -> bool:
        return native_host_available()

    def stage_and_sync(self, groups, idxs, terms, ptrs, lens,
                       trunc_g, trunc_from, floor_g, floor_idx, floor_term,
                       *, workers: int = 1, sync: bool = True):
        """Single-shard native host tier: see _native_stage_and_sync."""
        return _native_stage_and_sync(
            self._handles, 1, [self], workers, sync,
            groups, idxs, terms, ptrs, lens,
            trunc_g, trunc_from, floor_g, floor_idx, floor_term)

    def pack_ae(self, cols, starts, ns, *, workers: int = 1):
        if not self.can_stage_native:
            return None
        return _native_pack_ae(self._handles, 1, workers, cols, starts, ns)

    def close(self):
        if self._h:
            self._lib.wal_close(self._h)
            self._h = None

    def append_entry(self, g, idx, term, payload: bytes):
        self._lib.wal_append_entry(self._h, g, idx, term, payload,
                                   len(payload))

    def append_stable(self, g, term, ballot):
        self._lib.wal_append_stable(self._h, g, term, ballot)

    def truncate(self, g, frm):
        self._lib.wal_truncate(self._h, g, frm)

    def milestone(self, g, idx, term):
        self._lib.wal_milestone(self._h, g, idx, term)

    def reset(self, g):
        self._lib.wal_reset(self._h, g)

    def sync(self):
        if self._lib.wal_sync(self._h) != 0:
            self._raise_sync_error()

    def tail(self, g):
        return self._lib.wal_tail(self._h, g)

    def floor(self, g):
        return self._lib.wal_floor(self._h, g)

    def floor_term(self, g):
        return self._lib.wal_floor_term(self._h, g)

    def stable(self, g):
        t = ctypes.c_int64()
        b = ctypes.c_int64()
        if self._lib.wal_stable(self._h, g, ctypes.byref(t), ctypes.byref(b)):
            return int(t.value), int(b.value)
        return None

    def entry_term(self, g, idx):
        return self._lib.wal_entry_term(self._h, g, idx)

    def entry_payload(self, g, idx) -> Optional[bytes]:
        n = self._lib.wal_entry_len(self._h, g, idx)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(n)
        got = self._lib.wal_entry_payload(self._h, g, idx, buf, n)
        if got != n:
            return None
        return buf.raw[:n]

    def checkpoint(self):
        if self._lib.wal_checkpoint(self._h) != 0:
            raise IOError("wal_checkpoint failed")

    def gc_begin(self) -> int:
        return int(self._lib.wal_gc_begin(self._h))

    def gc_rewrite(self) -> int:
        return int(self._lib.wal_gc_rewrite(self._h))

    def gc_finish(self) -> int:
        return int(self._lib.wal_gc_finish(self._h))

    def gc_abort(self) -> None:
        self._lib.wal_gc_abort(self._h)

    def segment_count(self):
        return int(self._lib.wal_segment_count(self._h))

    def total_bytes(self):
        return int(self._lib.wal_total_bytes(self._h))

    def live_bytes(self):
        return int(self._lib.wal_live_bytes(self._h))

    def export_state(self, G: int, L: int) -> dict:
        """Bulk boot-time restore: one native call fills all per-group
        arrays + the [G, L] entry-term ring (wal_export_state)."""
        out = _export_arrays(G, L)
        ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        self._lib.wal_export_state(
            self._h, G, L, ptr(out["stable_term"]), ptr(out["ballot"]),
            ptr(out["has_stable"]), ptr(out["floor"]),
            ptr(out["floor_term"]), ptr(out["tail"]),
            ptr(out["live_count"]), ptr(out["ring"]))
        return out

    def append_batch(self, groups, idxs, terms, payloads) -> None:
        """Append many (group, idx, term, payload) records in one native
        call: payload bytes are concatenated host-side so the ctypes
        boundary is crossed once per tick, not once per entry."""
        import numpy as np
        n = len(groups)
        if n == 0:
            return
        lens = np.fromiter((len(p) for p in payloads), np.uint32, n)
        offs = np.zeros(n, np.uint64)
        offs[1:] = np.cumsum(lens[:-1], dtype=np.uint64)
        self.append_arena(groups, idxs, terms, b"".join(payloads), offs, lens)

    def append_arena(self, groups, idxs, terms, blob: bytes, offs,
                     lens) -> None:
        """Arena variant: the caller already holds payload bytes as ONE
        contiguous blob with per-entry offsets/lengths (the staging path's
        native currency) — pointers cross ctypes directly, nothing is
        re-joined or re-measured."""
        import numpy as np
        n = len(lens)
        if n == 0:
            return
        g_arr = np.ascontiguousarray(groups, np.uint32)
        i_arr = np.ascontiguousarray(idxs, np.uint64)
        t_arr = np.ascontiguousarray(terms, np.int64)
        o_arr = np.ascontiguousarray(offs, np.uint64)
        l_arr = np.ascontiguousarray(lens, np.uint32)
        ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        self._lib.wal_append_entries(
            self._h, n, ptr(g_arr), ptr(i_arr), ptr(t_arr), blob,
            ptr(o_arr), ptr(l_arr))


_MAGIC = 0x52574131
_ENTRY, _STABLE, _TRUNCATE, _MILESTONE, _RESET = 1, 2, 3, 4, 5


def _export_arrays(G: int, L: int) -> dict:
    """The shared export_state output schema — ONE definition so the two
    engines (and restore_raft_state, which depends on the exact defaults,
    e.g. ballot=-1 masked by has_stable) cannot drift."""
    import numpy as np
    return {
        "stable_term": np.zeros(G, np.int64),
        "ballot": np.full(G, -1, np.int64),
        "has_stable": np.zeros(G, np.uint8),
        "floor": np.zeros(G, np.int64),
        "floor_term": np.zeros(G, np.int64),
        "tail": np.zeros(G, np.int64),
        "live_count": np.zeros(G, np.int64),
        "ring": np.zeros((G, L), np.int32),
    }


class _PyGroup:
    __slots__ = ("tail", "floor", "floor_term", "stable", "entries")

    def __init__(self):
        self.tail = 0
        self.floor = 0
        self.floor_term = 0
        self.stable = None  # (term, ballot)
        self.entries: Dict[int, tuple] = {}  # idx -> (term, payload)

    def drop_suffix(self, frm):
        for i in [i for i in self.entries if i >= frm]:
            del self.entries[i]
        self.tail = min(self.tail, frm - 1)

    def drop_prefix(self, upto):
        for i in [i for i in self.entries if i <= upto]:
            del self.entries[i]


def _apply_record(groups: Dict[int, "_PyGroup"], body: bytes) -> None:
    """Apply one record body to a group map (shared by live replay and the
    GC worker's private replay)."""
    def G(g):
        return groups.setdefault(g, _PyGroup())
    t = body[0]
    if t == _ENTRY:
        g, idx, term, plen = struct.unpack_from("<IQQI", body, 1)
        gs = G(g)
        gs.drop_suffix(idx)
        gs.entries[idx] = (_signed(term), bytes(body[25:25 + plen]))
        gs.tail = idx
    elif t == _STABLE:
        g, term, ballot = struct.unpack_from("<IQQ", body, 1)
        G(g).stable = (_signed(term), _signed(ballot))
    elif t == _TRUNCATE:
        g, frm = struct.unpack_from("<IQ", body, 1)
        G(g).drop_suffix(frm)
    elif t == _MILESTONE:
        g, idx, term = struct.unpack_from("<IQQ", body, 1)
        gs = G(g)
        # `>=` (not `>`): re-applying the current milestone must be a full
        # state no-op incl. drop_prefix/tail-raise — the GC crash window
        # replays stale frozen segments AFTER the compacted base.
        if idx >= gs.floor:
            gs.floor, gs.floor_term = idx, _signed(term)
            gs.drop_prefix(idx)
            gs.tail = max(gs.tail, gs.floor)
    elif t == _RESET:
        (g,) = struct.unpack_from("<I", body, 1)
        groups.pop(g, None)


def _replay_file(path: str, groups: Dict[int, "_PyGroup"],
                 fix_tail: bool = True) -> None:
    with open(path, "rb") as f:
        data = f.read()
    off, n = 0, len(data)
    while off + 12 <= n:
        magic, blen, crc = struct.unpack_from("<III", data, off)
        if magic != _MAGIC or off + 12 + blen > n:
            break
        body = data[off + 12: off + 12 + blen]
        if zlib.crc32(body) != crc:
            break
        _apply_record(groups, body)
        off += 12 + blen
    if fix_tail and off < n:
        with open(path, "r+b") as f:
            f.truncate(off)


def _live_records(groups: Dict[int, "_PyGroup"]) -> bytes:
    """Framed compacted records for a group map (the GC base segment)."""
    out = bytearray()

    def emit(body: bytes):
        out.extend(struct.pack("<III", _MAGIC, len(body), zlib.crc32(body)))
        out.extend(body)

    for g, gs in groups.items():
        if gs.stable is not None:
            t, b = gs.stable
            emit(struct.pack("<BIQQ", _STABLE, g, t & M64, b & M64))
        if gs.floor > 0:
            emit(struct.pack("<BIQQ", _MILESTONE, g, gs.floor,
                             gs.floor_term & M64))
        for idx in sorted(gs.entries):
            term, payload = gs.entries[idx]
            emit(struct.pack("<BIQQI", _ENTRY, g, idx, term & M64,
                             len(payload)) + payload)
    return bytes(out)


class PyWal:
    """Pure-Python engine, byte-compatible with the native one."""

    def __init__(self, path: str, segment_bytes: int = 64 << 20):
        self.dir = path
        self.segment_bytes = segment_bytes
        os.makedirs(path, exist_ok=True)
        try:
            os.unlink(os.path.join(path, "gc.tmp"))  # crashed mid-GC: re-derivable
        except OSError:
            pass
        self.groups: Dict[int, _PyGroup] = {}
        segs = sorted(int(f[:8]) for f in os.listdir(path)
                      if f.endswith(".wal") and f[:8].isdigit())
        for sid in segs:
            self._replay(sid)
        self._segs = segs or [0]
        self._sid = self._segs[-1]
        self._f = open(self._seg_path(self._sid), "ab")
        self._buf = bytearray()
        self._gc = None  # {"frozen": [ids], "rewritten": bool}
        # Failure latches + injectable fault table, mirroring the native
        # engine: staging never raises — errors latch here and surface at
        # the sync barrier; `poisoned` is fail-stop for the engine's life.
        self.shard_id = 0
        self.poisoned = False
        self.last_errno = 0
        self._err = ""
        self._faults: Dict[str, list] = {}  # op -> [after, value]
        self._sync_delay_us = 0
        # Same stats schema as the native engine (WAL_STAT_KEYS).
        # stage_ns stays 0 here: Python staging is interleaved with the
        # caller's own loop, so a per-record clock read would measure the
        # clock, not the work; bytes/calls and fsync timing are exact.
        self._stat = dict.fromkeys(WAL_STAT_KEYS, 0)

    def _seg_path(self, sid):
        return os.path.join(self.dir, f"{sid:08d}.wal")

    def _g(self, g) -> _PyGroup:
        return self.groups.setdefault(g, _PyGroup())

    def _replay(self, sid):
        _replay_file(self._seg_path(sid), self.groups)

    def error(self) -> str:
        return self._err

    def set_fault(self, op: str, after: int = 0, value: int = 0) -> None:
        """Arm an injected fault: same op vocabulary and countdown
        semantics as the native engine's wal_fault_set (after=N fires on
        the (N+1)-th guarded call, then disarms)."""
        assert op in _FAULT_OPS
        if op == "delay":
            self._sync_delay_us = int(value)
            return
        if value == 0 and op in ("fsync", "write"):
            value = _errno.EIO
        self._faults[op] = [int(after), int(value)]

    def clear_faults(self) -> None:
        """Disarm pending countdowns; does NOT heal `poisoned`."""
        self._faults.clear()
        self._sync_delay_us = 0

    def _fault_fire(self, op: str):
        f = self._faults.get(op)
        if f is None:
            return None
        if f[0] == 0:
            del self._faults[op]
            return f[1]
        f[0] -= 1
        return None

    def _emit(self, body: bytes):
        self._buf += struct.pack("<III", _MAGIC, len(body), zlib.crc32(body))
        self._buf += body
        self._stat["bytes"] += 12 + len(body)
        self._stat["stage_calls"] += 1
        if self._f.tell() + len(self._buf) >= self.segment_bytes:
            if not self._flush():
                return  # failure surfaces at the sync barrier
            try:
                os.fsync(self._f.fileno())
            except OSError as e:
                self._latch(e)
                self.poisoned = True  # never retry fsync on a failed fd
                return
            self._f.close()
            self._sid += 1
            self._segs.append(self._sid)
            self._f = open(self._seg_path(self._sid), "wb")

    def _latch(self, e: OSError) -> None:
        self._err = str(e)
        self.last_errno = e.errno or _errno.EIO

    def _flush(self) -> bool:
        """Write the staged buffer; never raises — failures latch and
        surface at the barrier.  ENOSPC rewinds the segment to the last
        good offset and KEEPS the buffer (retriable); any other failure
        poisons the engine."""
        if self.poisoned:
            return False
        if not self._buf:
            return True
        good = self._f.tell()
        try:
            keep = self._fault_fire("short")
            if keep is not None:
                keep = max(0, min(int(keep), len(self._buf)))
                self._f.write(self._buf[:keep])
                self._f.flush()
                raise iofault.TornWrite(keep)
            inj = self._fault_fire("write")
            if inj is not None:
                raise OSError(int(inj), os.strerror(int(inj)))
            self._f.write(self._buf)
            self._f.flush()
        except OSError as e:
            self._latch(e)
            if self.last_errno == _errno.ENOSPC:
                try:
                    self._f.seek(good)
                    self._f.truncate(good)
                except OSError:
                    self.poisoned = True
            else:
                self.poisoned = True
            return False
        self._buf = bytearray()
        return True

    # -- same surface as _NativeWal ------------------------------------
    def append_entry(self, g, idx, term, payload: bytes):
        gs = self._g(g)
        gs.drop_suffix(idx)
        gs.entries[idx] = (term, bytes(payload))
        gs.tail = idx
        self._emit(struct.pack("<BIQQI", _ENTRY, g, idx, term & M64,
                               len(payload)) + payload)

    def append_stable(self, g, term, ballot):
        self._g(g).stable = (term, ballot)
        self._emit(struct.pack("<BIQQ", _STABLE, g, term & M64, ballot & M64))

    def truncate(self, g, frm):
        self._g(g).drop_suffix(frm)
        self._emit(struct.pack("<BIQ", _TRUNCATE, g, frm))

    def milestone(self, g, idx, term):
        gs = self._g(g)
        if idx >= gs.floor:  # mirror _apply_record's replay semantics
            gs.floor, gs.floor_term = idx, term
            gs.drop_prefix(idx)
            gs.tail = max(gs.tail, gs.floor)
        self._emit(struct.pack("<BIQQ", _MILESTONE, g, idx, term & M64))

    def reset(self, g):
        """Group destroyed: forget the lane's entire durable state."""
        self.groups.pop(g, None)
        self._emit(struct.pack("<BI", _RESET, g))

    def _raise_sync_error(self):
        msg = self._err or "wal_sync failed"
        if self.last_errno == _errno.ENOSPC and not self.poisoned:
            raise WalNoSpace(msg, (self.shard_id,))
        raise WalSyncError(msg, (self.shard_id,))

    def sync(self):
        if self.poisoned:
            self._raise_sync_error()
        # Timed from here (incl. injected sync delays) to mirror the
        # native engine's wal_sync stats window.
        _t0 = time.perf_counter()
        if self._sync_delay_us > 0:
            time.sleep(self._sync_delay_us / 1e6)
        if not self._flush():
            self._raise_sync_error()
        try:
            inj = self._fault_fire("fsync")
            if inj is not None:
                raise OSError(int(inj), "injected fsync failure")
            self._f.flush()
            os.fsync(self._f.fileno())
        except OSError as e:
            self._latch(e)
            self.poisoned = True
            self._raise_sync_error()
        self._stat["fsync_ns"] += int((time.perf_counter() - _t0) * 1e9)
        self._stat["fsync_calls"] += 1

    def stats(self) -> Dict[str, int]:
        return dict(self._stat)

    def tail(self, g):
        return self.groups[g].tail if g in self.groups else 0

    def floor(self, g):
        return self.groups[g].floor if g in self.groups else 0

    def floor_term(self, g):
        return self.groups[g].floor_term if g in self.groups else 0

    def stable(self, g):
        return self.groups[g].stable if g in self.groups else None

    def entry_term(self, g, idx):
        gs = self.groups.get(g)
        if gs is None:
            return -1
        if idx == gs.floor:
            return gs.floor_term
        e = gs.entries.get(idx)
        return e[0] if e else -1

    def entry_payload(self, g, idx):
        gs = self.groups.get(g)
        e = gs.entries.get(idx) if gs else None
        return e[1] if e else None

    # -- three-phase GC (begin/finish on the tick thread, rewrite on a
    # worker; same contract as the native engine's wal_gc_*) ------------

    def gc_begin(self) -> int:
        if self._gc is not None:
            return -1
        if not self._flush():
            return -1  # latched failure surfaces at the sync barrier
        try:
            os.fsync(self._f.fileno())
        except OSError as e:
            self._latch(e)
            self.poisoned = True
            return -1
        self._f.close()
        frozen = list(self._segs)
        self._sid += 1
        self._segs.append(self._sid)
        self._f = open(self._seg_path(self._sid), "wb")
        self._gc = {"frozen": frozen, "rewritten": False}
        return len(frozen)

    def gc_rewrite(self) -> int:
        """Worker-thread safe: replays the frozen FILES into a private map
        (never touches self.groups / self._buf) and writes the compacted
        base to gc.tmp."""
        gc = self._gc
        if gc is None or gc["rewritten"]:
            return -1
        priv: Dict[int, _PyGroup] = {}
        for sid in gc["frozen"]:
            _replay_file(self._seg_path(sid), priv, fix_tail=False)
        blob = _live_records(priv)
        tmp = os.path.join(self.dir, "gc.tmp")
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        gc["rewritten"] = True
        return len(blob)

    def gc_finish(self) -> int:
        gc = self._gc
        if gc is None or not gc["rewritten"]:
            return -1
        frozen = gc["frozen"]
        base = frozen[0]
        os.replace(os.path.join(self.dir, "gc.tmp"), self._seg_path(base))
        # Make the rename durable BEFORE the unlinks: without the directory
        # fsync, POSIX may persist the unlinks but not the rename, losing
        # every live record that lived in frozen[1:].
        dfd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        for sid in frozen[1:]:
            try:
                os.unlink(self._seg_path(sid))
            except OSError:
                pass
        self._segs = [base] + [s for s in self._segs if s not in frozen]
        self._gc = None
        return 0

    def gc_abort(self) -> None:
        try:
            os.unlink(os.path.join(self.dir, "gc.tmp"))
        except OSError:
            pass
        self._gc = None

    def checkpoint(self):
        if self._gc is not None:
            raise IOError("checkpoint refused: three-phase GC pending")
        if not self._flush():
            self._raise_sync_error()
        os.fsync(self._f.fileno())
        self._f.close()
        old = list(self._segs)
        self._sid += 1
        new_id = self._sid
        self._segs = [new_id]
        self._f = open(self._seg_path(new_id), "wb")
        # Same serialization as the GC base (one definition, no drift).
        self._buf += _live_records(self.groups)
        self.sync()
        for sid in old:
            if sid not in self._segs:
                os.unlink(self._seg_path(sid))

    def segment_count(self):
        return len(self._segs)

    def export_state(self, G: int, L: int) -> dict:
        """Bulk boot-time restore (same contract as the native engine's
        wal_export_state; loops only over live groups)."""
        out = _export_arrays(G, L)
        for g, gs in self.groups.items():
            if g >= G:
                continue
            if gs.stable is not None:
                out["stable_term"][g], out["ballot"][g] = gs.stable
                out["has_stable"][g] = 1
            out["floor"][g] = gs.floor
            out["floor_term"][g] = gs.floor_term
            out["tail"][g] = gs.tail
            cnt = 0
            for idx, (term, _) in gs.entries.items():
                if gs.floor < idx <= gs.tail:
                    out["ring"][g, idx % L] = term
                    cnt += 1
            out["live_count"][g] = cnt
        return out

    def append_batch(self, groups, idxs, terms, payloads) -> None:
        for g, i, t, p in zip(groups, idxs, terms, payloads):
            self.append_entry(int(g), int(i), int(t), p)

    def append_arena(self, groups, idxs, terms, blob, offs, lens) -> None:
        """Arena variant (same contract as the native engine's): slices the
        blob per entry — the Python engine is the no-compiler fallback, so
        per-entry cost is acceptable here."""
        mv = memoryview(blob)
        for g, i, t, o, ln in zip(groups, idxs, terms, offs, lens):
            o = int(o)
            self.append_entry(int(g), int(i), int(t), bytes(mv[o:o + int(ln)]))

    def total_bytes(self):
        total = len(self._buf) + self._f.tell()
        for sid in self._segs[:-1]:
            try:
                total += os.path.getsize(self._seg_path(sid))
            except OSError:
                pass
        return total

    def live_bytes(self):
        # Mirrors the native accounting: frame (12) + record body sizes.
        live = 0
        for gs in self.groups.values():
            if gs.stable is not None:
                live += 12 + 21
            if gs.floor > 0:
                live += 12 + 21
            for term, payload in gs.entries.values():
                live += 12 + 25 + len(payload)
        return live

    def close(self):
        try:
            self._flush()
            os.fsync(self._f.fileno())
        except OSError:
            pass  # closing a poisoned/failing engine must not raise
        self._f.close()


M64 = (1 << 64) - 1


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


class ConfMeta:
    """Durable membership-config sidecar: the WAL meta file that lets
    recovery restore the §6 active voter set.

    The engine's conf ring (core/types.py LogState.conf) carries one
    packed config word per live config entry; the WAL proper persists
    entry (term, payload) only — config entries travel with EMPTY
    payloads like the §8 no-op.  This sidecar records, per group, every
    LIVE config entry's (index, word) plus the config as of the
    compaction floor, so ``restore_raft_state`` rebuilds the conf ring
    and base_conf exactly.  Maintained write-through by the LogStore
    (put/truncate/set_floor/reset mirror the entry paths) and flushed —
    atomic tmp+rename+fsync — inside the store's ``sync()`` barrier, so
    a config is durable before any RPC built on it leaves the node.
    Config changes are rare; the whole file is a few entries per group
    that ever reconfigured, and a flush only happens on change."""

    def __init__(self, path: str):
        import json
        self.path = path
        self._g: dict = {}       # g -> {"floor": word, "entries": {idx: w}}
        self._dirty = False
        try:
            with open(path) as f:
                doc = json.load(f)
            for g, ent in doc.get("groups", {}).items():
                self._g[int(g)] = {
                    "floor": int(ent.get("floor", 0)),
                    "entries": {int(i): int(w)
                                for i, w in ent.get("entries", {}).items()},
                }
        except (OSError, ValueError):
            pass

    def _ent(self, g: int) -> dict:
        ent = self._g.get(g)
        if ent is None:
            ent = self._g[g] = {"floor": 0, "entries": {}}
        return ent

    def put(self, g: int, idx: int, word: int) -> None:
        ent = self._ent(g)
        # Overwrite semantics like the WAL itself: an append at idx kills
        # any recorded config entries at >= idx (they were truncated).
        for i in [i for i in ent["entries"] if i > idx]:
            del ent["entries"][i]
        ent["entries"][idx] = word
        self._dirty = True

    def truncate(self, g: int, tail: int) -> None:
        ent = self._g.get(g)
        if not ent:
            return
        drop = [i for i in ent["entries"] if i > tail]
        for i in drop:
            del ent["entries"][i]
        if drop:
            self._dirty = True

    def set_floor(self, g: int, index: int, conf_word: int = 0) -> None:
        """Fold config entries at/under the new floor into the floor word
        (the latest one wins — it IS the config as of ``index``).  A
        nonzero ``conf_word`` then pins the floor config explicitly (the
        snapshot-install path: the offered milestone's config is the
        config AS OF ``index``, newer than or equal to any folded
        entry)."""
        ent = self._g.get(g)
        if ent is None:
            if not conf_word:
                return
            ent = self._ent(g)
        folded = [i for i in sorted(ent["entries"]) if i <= index]
        for i in folded:
            ent["floor"] = ent["entries"].pop(i)
        if conf_word:
            ent["floor"] = int(conf_word)
        if folded or conf_word:
            self._dirty = True

    def reset(self, g: int) -> None:
        if self._g.pop(g, None) is not None:
            self._dirty = True

    def export(self) -> dict:
        """{g: (floor_word, {idx: word})} for recovery (groups that ever
        reconfigured only)."""
        return {g: (ent["floor"], dict(ent["entries"]))
                for g, ent in self._g.items()}

    def flush(self) -> None:
        if not self._dirty:
            return
        import json
        doc = {"groups": {str(g): {"floor": ent["floor"],
                                   "entries": {str(i): w for i, w
                                               in ent["entries"].items()}}
                          for g, ent in self._g.items()}}
        tmp = self.path + ".tmp"
        try:
            iofault.check("conf.flush", self.path)
            with open(tmp, "w") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except OSError as e:
            # Global transient, nothing poisoned: the dirty flag stays
            # set, so the next barrier retries the whole flush (tmp file
            # writes are idempotent).
            raise WalSyncError(f"conf flush: {e}", ()) from e
        # The rename itself must be durable before the caller's barrier
        # completes (same rule as the WAL GC swap): fsync the directory.
        try:
            dfd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
        self._dirty = False


_SHARD_META = "wal_shards.json"


class ShardedWal:
    """S independent WAL engines keyed by group stripe (``g % S``).

    Same surface as ``_NativeWal``/``PyWal``.  Groups are disjoint across
    shards, so every per-group operation routes to exactly one engine and
    recovery is the union of per-shard replays (torn-tail truncation runs
    per shard file, as ever).  ``sync`` fans the S fsyncs out to a worker
    pool and joins them — one barrier, S spindles' worth of parallelism.
    """

    def __init__(self, path: str, segment_bytes: int, shards: int, *,
                 force_python: bool = False):
        from concurrent.futures import ThreadPoolExecutor

        assert shards >= 1
        self.dir = path
        self.n_shards = shards
        os.makedirs(path, exist_ok=True)
        self.engines = []
        for k in range(shards):
            sub = os.path.join(path, f"shard{k:02d}")
            if not force_python and native_available():
                eng = _NativeWal(sub, segment_bytes)
            else:
                eng = PyWal(sub, segment_bytes)
            eng.shard_id = k  # barrier failures carry true stripe ids
            self.engines.append(eng)
        self._pool = ThreadPoolExecutor(
            max_workers=min(shards, 8),
            thread_name_prefix="wal-fsync") if shards > 1 else None
        self._gc_active = [False] * shards
        # Raw engine handles for the native host tier (one ctypes call
        # staging every shard) — only when EVERY shard is native.
        self._handles = None
        if all(isinstance(e, _NativeWal) for e in self.engines):
            self._handles = (ctypes.c_void_p * shards)(
                *[e._h for e in self.engines])

    def _e(self, g):
        return self.engines[g % self.n_shards]

    @property
    def can_stage_native(self) -> bool:
        return self._handles is not None and native_host_available()

    def stage_and_sync(self, groups, idxs, terms, ptrs, lens,
                       trunc_g, trunc_from, floor_g, floor_idx, floor_term,
                       *, workers: int = 1, sync: bool = True):
        """Stage a whole tick's entries/truncations/milestones across every
        shard — and fsync them — in ONE native call with real OS threads
        (worker k owns shards ``s % W == k``, the striped pool's ownership
        map, so per-shard record order and segment bytes are identical to
        the Python paths).  Returns ``(stage_s, fsync_s)``."""
        return _native_stage_and_sync(
            self._handles, self.n_shards, self.engines, workers, sync,
            groups, idxs, terms, ptrs, lens,
            trunc_g, trunc_from, floor_g, floor_idx, floor_term)

    def pack_ae(self, cols, starts, ns, *, workers: int = 1):
        """Native AppendEntries payload-blob pack over the shards' own
        entry indexes; ``None`` when the native tier is unavailable."""
        if not self.can_stage_native:
            return None
        return _native_pack_ae(self._handles, self.n_shards, workers,
                               cols, starts, ns)

    # -- staging (routes to one shard) ---------------------------------
    def append_entry(self, g, idx, term, payload: bytes):
        self._e(g).append_entry(g, idx, term, payload)

    def append_stable(self, g, term, ballot):
        self._e(g).append_stable(g, term, ballot)

    def truncate(self, g, frm):
        self._e(g).truncate(g, frm)

    def milestone(self, g, idx, term):
        self._e(g).milestone(g, idx, term)

    def reset(self, g):
        self._e(g).reset(g)

    def append_batch(self, groups, idxs, terms, payloads) -> None:
        import numpy as np
        n = len(groups)
        if n == 0:
            return
        lens = np.fromiter((len(p) for p in payloads), np.uint32, n)
        offs = np.zeros(n, np.uint64)
        offs[1:] = np.cumsum(lens[:-1], dtype=np.uint64)
        self.append_arena(groups, idxs, terms, b"".join(payloads), offs, lens)

    def append_arena(self, groups, idxs, terms, blob, offs, lens) -> None:
        """One arena call per MOVED stripe: the shared blob crosses into
        each engine with that stripe's (group, idx, term, off, len)
        columns — offsets stay absolute into the caller's blob, so no
        bytes are copied or re-joined on the split."""
        import numpy as np
        n = len(lens)
        if n == 0:
            return
        g_arr = np.ascontiguousarray(groups, np.uint32)
        i_arr = np.ascontiguousarray(idxs, np.uint64)
        t_arr = np.ascontiguousarray(terms, np.int64)
        o_arr = np.ascontiguousarray(offs, np.uint64)
        l_arr = np.ascontiguousarray(lens, np.uint32)
        stripe = g_arr % np.uint32(self.n_shards)
        for k in np.unique(stripe).tolist():
            m = stripe == k
            self.engines[k].append_arena(
                g_arr[m], i_arr[m], t_arr[m], blob, o_arr[m], l_arr[m])

    # -- the durability barrier ----------------------------------------
    def sync(self):
        """Parallel fsync across shards with a single barrier join:
        returns only when EVERY shard is durable (any failure raises —
        a partially durable barrier must never be acknowledged)."""
        if self._pool is None:
            self.engines[0].sync()
            return
        futs = [self._pool.submit(e.sync) for e in self.engines]
        errs = []
        for f in futs:
            try:
                f.result()
            except Exception as e:  # join ALL before raising
                errs.append(e)
        err = _merge_wal_errors(errs)
        if err is not None:
            raise err

    def sync_shards(self, shard_ids) -> None:
        """Fsync only the given shard engines, inline on the calling
        thread — the striped host tier's durability barrier: each worker
        owns a disjoint set of shards end-to-end (staging AND fsync), so
        no cross-thread coordination or pool handoff is needed.  Syncs
        EVERY requested shard before raising the merged failure (the
        caller must not acknowledge the tick, but healthy shards still
        become durable)."""
        errs = []
        for k in shard_ids:
            try:
                self.engines[k].sync()
            except Exception as e:
                errs.append(e)
        err = _merge_wal_errors(errs)
        if err is not None:
            raise err

    # -- injectable fault table (testkit/faultfs) ----------------------
    def set_fault(self, op: str, after: int = 0, value: int = 0,
                  shard: int = 0) -> None:
        self.engines[shard % self.n_shards].set_fault(op, after, value)

    def clear_faults(self) -> None:
        for e in self.engines:
            e.clear_faults()

    def poisoned_shards(self):
        return [k for k, e in enumerate(self.engines) if e.poisoned]

    # -- instrumentation -----------------------------------------------
    def stats(self) -> Dict[str, int]:
        """Sum of per-stripe engine stats (WAL_STAT_KEYS)."""
        out = dict.fromkeys(WAL_STAT_KEYS, 0)
        for e in self.engines:
            for k, v in e.stats().items():
                out[k] += v
        return out

    def stats_per_stripe(self):
        """Per-stripe stats, index-aligned with the engine list."""
        return [e.stats() for e in self.engines]

    # -- per-group reads -----------------------------------------------
    def tail(self, g):
        return self._e(g).tail(g)

    def floor(self, g):
        return self._e(g).floor(g)

    def floor_term(self, g):
        return self._e(g).floor_term(g)

    def stable(self, g):
        return self._e(g).stable(g)

    def entry_term(self, g, idx):
        return self._e(g).entry_term(g, idx)

    def entry_payload(self, g, idx):
        return self._e(g).entry_payload(g, idx)

    # -- maintenance / GC ----------------------------------------------
    def checkpoint(self):
        for e in self.engines:
            e.checkpoint()

    def gc_begin(self) -> int:
        """Begin on every shard; -1 (and full rollback) unless ALL shards
        enter the frozen state — a half-begun GC would desynchronize the
        runtime's single three-phase state machine."""
        begun = []
        for k, e in enumerate(self.engines):
            if e.gc_begin() < 0:
                for j in begun:
                    self.engines[j].gc_abort()
                    self._gc_active[j] = False
                return -1
            begun.append(k)
            self._gc_active[k] = True
        return len(begun)

    def gc_rewrite(self) -> int:
        total = 0
        for k, e in enumerate(self.engines):
            if not self._gc_active[k]:
                continue
            r = e.gc_rewrite()
            if r < 0:
                return -1
            total += r
        return total

    def gc_finish(self) -> int:
        rc = 0
        for k, e in enumerate(self.engines):
            if not self._gc_active[k]:
                continue
            r = e.gc_finish()
            if r != 0:
                rc = r
            else:
                self._gc_active[k] = False
        return rc

    def gc_abort(self) -> None:
        for k, e in enumerate(self.engines):
            e.gc_abort()
            self._gc_active[k] = False

    def segment_count(self):
        return sum(e.segment_count() for e in self.engines)

    def total_bytes(self):
        return sum(e.total_bytes() for e in self.engines)

    def live_bytes(self):
        return sum(e.live_bytes() for e in self.engines)

    def export_state(self, G: int, L: int) -> dict:
        """Merged boot-time restore: shards hold disjoint group stripes,
        so the union is a per-stripe masked copy of each shard's export."""
        import numpy as np
        out = _export_arrays(G, L)
        gi = np.arange(G)
        for k, e in enumerate(self.engines):
            ex = e.export_state(G, L)
            m = (gi % self.n_shards) == k
            for name, arr in out.items():
                arr[m] = ex[name][m]
        return out

    def close(self):
        for e in self.engines:
            e.close()
        if self._pool is not None:
            self._pool.shutdown(wait=True)


def _pin_shards(path: str, requested: int) -> int:
    """Resolve the stripe count for a WAL directory: a pinned meta wins
    (recovery must read the layout that was written); a legacy flat
    directory with segments is S=1; otherwise pin the requested count."""
    import json
    meta = os.path.join(path, _SHARD_META)
    try:
        with open(meta) as f:
            return max(1, int(json.load(f)["shards"]))
    except (OSError, ValueError, KeyError):
        pass
    try:
        has_flat = any(f.endswith(".wal") for f in os.listdir(path))
    except OSError:
        has_flat = False
    if has_flat:
        return 1
    if requested > 1:
        os.makedirs(path, exist_ok=True)
        tmp = meta + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"shards": requested}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, meta)
    return requested


def WalStore(path: str, segment_bytes: int = 64 << 20, *,
             force_python: bool = False, shards: int = 1):
    """Open a WAL store at `path`, preferring the native engine.

    ``shards`` > 1 stripes groups over that many independent engines
    (``ShardedWal``); the count is pinned in the directory's meta file,
    so a restart recovers with the layout the data was written under
    regardless of what the caller asks for."""
    shards = _pin_shards(path, shards)
    if shards > 1:
        return ShardedWal(path, segment_bytes, shards,
                          force_python=force_python)
    if not force_python and native_available():
        return _NativeWal(path, segment_bytes)
    return PyWal(path, segment_bytes)
