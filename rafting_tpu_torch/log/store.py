"""LogStore: the host-side log facade the node runtime drives each tick.

Responsibilities (mapping to the reference's storage contracts):

* durable entry payloads + terms  — RaftLog.newEntry/append
  (command/RaftLog.java:11-134, command/storage/RocksLog.java:82-196)
* suffix truncation on conflict   — RaftLog.truncate (RocksLog.java:219-225)
* compaction floor ("epoch")      — RaftLog.flush (RocksLog.java:228-242)
* durable (term, ballot)          — StableLock (support/StableLock.java:69-80)
* milestone (snapshot index/term) — StableLock milestone (82-91)
* crash recovery → device state   — RaftContext.initialize restore path
  (context/RaftContext.java:91-113)

The tick protocol (enforced by the node runtime): all writes implied by a
device step are staged, then ONE :meth:`sync` makes them durable *before*
any RPC produced by that step leaves the node — the reference's
persist-before-reply rule (context/member/RaftMember.java:25,
RocksLog.flushWal after append) amortized over every group at once.

A bounded in-memory payload cache keeps the replication hot path
(leader batch fetch) off the WAL read path; entries below the compaction
floor are pruned as the floor advances.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import os

from ..transport.codec import PayloadRun
from .wal import ConfMeta, WalStore


class LogStore:
    def __init__(self, path: str, segment_bytes: int = 64 << 20, *,
                 force_python: bool = False, shards: int = 1):
        """``shards`` > 1 stripes groups over that many independent WAL
        engines (log/wal.py ShardedWal): appends land as one arena call
        per moved stripe and :meth:`sync` fsyncs the stripes in parallel
        behind a single barrier.  The count is pinned in the directory at
        creation, so recovery always reads the written layout."""
        self.wal = WalStore(path, segment_bytes, force_python=force_python,
                            shards=shards)
        # Membership sidecar (§6 durable config): live config entries +
        # floor config per group, flushed inside sync()'s barrier.
        self.conf = ConfMeta(os.path.join(path, "conf_meta.json"))
        # group -> ([run starts], [PayloadRun]) sorted by start: the hot
        # mirror of the live window as contiguous arena runs — the same
        # currency the wire codec and the staging path speak, so cache
        # maintenance is O(runs touched) and reads for the replication/
        # apply windows are buffer slices, never per-entry dict ops (the
        # per-entry bytes cache was ~15% of the durable tick at 32k).
        # Keyed per group so floor/truncate/reset maintenance touches only
        # that group's runs.
        self._cache: Dict[int, Tuple[List[int], List[PayloadRun]]] = {}
        # last durable (term, ballot) per group, to skip no-op stable writes
        self._stable: Dict[int, tuple] = {}
        self._durable_tail: Dict[int, int] = {}

    # -- the run cache -------------------------------------------------------

    # Trim re-materialization thresholds: a milestone/truncate trim slices
    # a run's offs/lens but keeps ``buf`` — which may be (a view into) a
    # whole 64MB MSGS frame or staging arena.  When the surviving entries
    # cover under 1/_COMPACT_RATIO of the pinned frame and the frame is
    # big enough to matter, the remainder is copied into a compact buffer
    # so one cached entry can no longer pin a frame-sized allocation
    # (ADVICE r5: resident-memory inflation at 100k groups with mixed
    # progress).
    _COMPACT_MIN_FRAME = 1 << 16
    _COMPACT_RATIO = 4

    @staticmethod
    def _frame_bytes(buf) -> int:
        """True pinned size: a memoryview keeps its WHOLE exporter alive,
        so the slice length understates what the cache is holding."""
        if isinstance(buf, memoryview):
            base = buf.obj
            if base is not None:
                try:
                    return memoryview(base).nbytes
                except TypeError:
                    pass
            return buf.nbytes
        return len(buf)

    @classmethod
    def _maybe_compact(cls, run: PayloadRun) -> PayloadRun:
        """Re-materialize a trimmed run into a compact private buffer when
        it covers a small fraction of the frame it pins."""
        n = len(run.lens)
        if not n:
            # A fully trimmed run must not keep its (possibly frame-sized)
            # exporter alive through the buf reference.
            return PayloadRun(run.start, b"", run.offs[:0], run.lens[:0])
        frame = cls._frame_bytes(run.buf)
        if frame < cls._COMPACT_MIN_FRAME:
            return run
        live = int(run.offs[n - 1]) + int(run.lens[n - 1]) - int(run.offs[0])
        if live * cls._COMPACT_RATIO >= frame:
            return run
        return PayloadRun(run.start, bytes(run.piece(0, n)),
                          run.offs - run.offs[0], run.lens)

    def _add_run(self, g: int, run: PayloadRun) -> None:
        """Insert a freshly written run (overwrite semantics: any cached
        entry at >= run.start dies first, mirroring the WAL's replay)."""
        if not len(run.lens):
            return   # empty runs have no overwrite effect
        starts, runs = self._cache.setdefault(g, ([], []))
        while starts and starts[-1] >= run.start:
            starts.pop()
            runs.pop()
        if runs and runs[-1].end >= run.start:
            r = runs[-1]
            keep = run.start - r.start
            # Compact like every other trim site: an overwrite that lops a
            # run down to a sliver must not leave the sliver pinning a
            # frame-sized buffer (ROADMAP carry-forward, log/store.py:55).
            runs[-1] = self._maybe_compact(
                PayloadRun(r.start, r.buf, r.offs[:keep], r.lens[:keep]))
        starts.append(run.start)
        runs.append(run)

    def _run_at(self, g: int, idx: int) -> Optional[PayloadRun]:
        ent = self._cache.get(g)
        if not ent:
            return None
        starts, runs = ent
        i = bisect_right(starts, idx) - 1
        if i < 0:
            return None
        r = runs[i]
        return r if r.end >= idx else None

    def _backfill(self, g: int, idx: int, payload: bytes) -> None:
        """Cache a WAL read as a one-entry run WITHOUT the overwrite
        semantics of _add_run (a backfill of an OLD index must never
        evict newer cached runs).  Skipped if anything already covers or
        collides at the insertion point — the WAL stays authoritative."""
        starts, runs = self._cache.setdefault(g, ([], []))
        i = bisect_right(starts, idx)
        if i > 0 and runs[i - 1].end >= idx:
            return                      # already covered
        starts.insert(i, idx)
        runs.insert(i, PayloadRun.single(idx, payload))

    # -- staging writes (durable after sync()) ------------------------------

    def append_entries(self, g: int, start: int, terms: Sequence[int],
                       payloads: Sequence[bytes]) -> None:
        """Write entries [start, start+len) (overwrite semantics)."""
        if not len(payloads):
            return   # a degenerate empty run must not evict cached suffix
        for k, (t, p) in enumerate(zip(terms, payloads)):
            self.wal.append_entry(g, start + k, int(t), p)
        self._add_run(g, PayloadRun.from_payloads(start, list(payloads)))
        self._durable_tail[g] = max(self._durable_tail.get(g, 0),
                                    start + len(terms) - 1)

    def append_batch(self, groups: Sequence[int], idxs: Sequence[int],
                     terms: Sequence[int], payloads: Sequence[bytes]) -> None:
        """Stage a whole tick's appends across all groups in one engine
        call (native: one ctypes crossing; the batching analog of the
        reference's group-commit WAL flush, RocksLog flushWal after a
        batch, command/storage/RocksLog.java:87,195).  Cache maintenance
        is bulked per same-group contiguous RUN; non-contiguous batches
        remain correct (runs just get shorter)."""
        self.wal.append_batch(groups, idxs, terms, payloads)
        n = len(groups)
        start = 0
        while start < n:
            g = int(groups[start])
            i0 = int(idxs[start])
            end = start + 1
            # extend while same group AND contiguous indices
            while (end < n and groups[end] == g
                   and int(idxs[end]) == i0 + (end - start)):
                end += 1
            self._add_run(g, PayloadRun.from_payloads(
                i0, list(payloads[start:end])))
            hi = i0 + (end - start) - 1
            if hi > self._durable_tail.get(g, 0):
                self._durable_tail[g] = hi
            start = end

    def append_spans(self, spans: Sequence[tuple]) -> None:
        """The arena fast path (VERDICT r4 #2): stage a whole tick's
        appends as contiguous spans ``(g, start, piece, lens_u32,
        terms)`` — pieces are buffer slices whose entries sit
        back-to-back; ``terms`` is an int64 vector (adoption) or a plain
        int (own submissions, all at the leader's term).  The global
        arena's metadata is assembled with vector ops over the span
        HEADERS (np.repeat / one global cumsum) — per-span Python is
        three tight loop bodies, per-ENTRY Python is zero — and ONE
        native call writes everything; the cache records each span as a
        run sharing slices of the same global offset vector."""
        n_spans = len(spans)
        counts = np.empty(n_spans, np.int64)
        gs_v = np.empty(n_spans, np.int64)
        starts_v = np.empty(n_spans, np.int64)
        j = 0
        for sp in spans:
            gs_v[j] = sp[0]
            starts_v[j] = sp[1]
            counts[j] = len(sp[3])
            j += 1
        ends = np.cumsum(counts)
        total = int(ends[-1])
        span_pos = ends - counts           # flat start offset of each span
        g_all = np.repeat(gs_v, counts).astype(np.uint32)
        i_all = (np.arange(total, dtype=np.int64)
                 + np.repeat(starts_v - span_pos, counts)).astype(np.uint64)
        lens_all = np.empty(total, np.uint32)
        t_all = np.empty(total, np.int64)
        pos = 0
        for sp in spans:
            cnt = len(sp[3])
            sl = slice(pos, pos + cnt)
            lens_all[sl] = sp[3]
            t_all[sl] = sp[4]              # scalar or vector, both C-speed
            pos += cnt
        offs_all = np.zeros(total, np.uint64)
        if total > 1:
            np.cumsum(lens_all[:-1].astype(np.uint64), out=offs_all[1:])
        pos = 0
        dt = self._durable_tail
        for sp in spans:
            g, start = sp[0], sp[1]
            cnt = len(sp[3])
            offs = offs_all[pos:pos + cnt] - offs_all[pos]
            self._add_run(g, PayloadRun(start, sp[2], offs, sp[3]))
            pos += cnt
            tail_new = start + cnt - 1
            if tail_new > dt.get(g, 0):
                dt[g] = tail_new
        self.wal.append_arena(
            g_all, i_all, t_all,
            b"".join(sp[2] for sp in spans), offs_all, lens_all)

    # -- native host tier ----------------------------------------------------

    @property
    def can_stage_native(self) -> bool:
        """True when the WAL backend exposes the native host tier (every
        shard is a native engine and the .so exports wal_stage_and_sync)."""
        return bool(getattr(self.wal, "can_stage_native", False))

    def stage_and_sync(self, spans: Sequence[tuple],
                       trunc_gs, trunc_tails,
                       floor_gs, floor_idxs, floor_terms, *,
                       workers: int = 1, sync: bool = True):
        """Native-tier variant of the tick's span/truncate/floor staging +
        fsync: ONE ctypes call stages every shard with real OS threads.

        Spans use :meth:`append_spans`'s currency; truncations are
        ``truncate_to`` rows the CALLER pre-filtered with the same
        durable-tail guard (the record emitted is ``truncate(g, tail+1)``);
        floors are ``set_floor`` rows (the wal-floor guard is re-checked
        here).  Python-side effects — membership sidecar, payload-run
        cache, durable-tail map — are applied in the exact order of the
        serial path; only the WAL record staging and the fsync barrier
        cross into C.  Entry payloads are handed over as raw per-span base
        pointers (``spans`` must stay alive for the duration of the call).
        Returns ``(stage_s, fsync_s)``."""
        n_spans = len(spans)
        counts = np.empty(n_spans, np.int64)
        gs_v = np.empty(n_spans, np.int64)
        starts_v = np.empty(n_spans, np.int64)
        base_ptrs = np.empty(n_spans, np.uint64)
        j = 0
        for sp in spans:
            gs_v[j] = sp[0]
            starts_v[j] = sp[1]
            counts[j] = len(sp[3])
            base_ptrs[j] = np.frombuffer(sp[2], np.uint8).ctypes.data
            j += 1
        total = int(counts.sum()) if n_spans else 0
        ends = np.cumsum(counts)
        span_pos = ends - counts
        g_all = np.repeat(gs_v, counts).astype(np.uint32)
        i_all = (np.arange(total, dtype=np.int64)
                 + np.repeat(starts_v - span_pos, counts)).astype(np.uint64)
        lens_all = np.empty(total, np.uint32)
        t_all = np.empty(total, np.int64)
        pos = 0
        for sp in spans:
            cnt = len(sp[3])
            sl = slice(pos, pos + cnt)
            lens_all[sl] = sp[3]
            t_all[sl] = sp[4]
            pos += cnt
        offs_all = np.zeros(total, np.uint64)
        if total > 1:
            np.cumsum(lens_all[:-1].astype(np.uint64), out=offs_all[1:])
        # Per-entry payload ADDRESSES: span base pointer + offset within
        # the span — the native side reads the arena views in place, no
        # blob join, no copy.
        ptr_all = (np.repeat(base_ptrs, counts)
                   + (offs_all - np.repeat(offs_all[span_pos]
                                           if n_spans else offs_all,
                                           counts)))
        # Python-side bookkeeping in serial-path order: runs first
        # (append), then truncations, then floors.
        pos = 0
        dt = self._durable_tail
        for sp in spans:
            g, start = sp[0], sp[1]
            cnt = len(sp[3])
            offs = offs_all[pos:pos + cnt] - offs_all[pos]
            self._add_run(g, PayloadRun(start, sp[2], offs, sp[3]))
            pos += cnt
            tail_new = start + cnt - 1
            if tail_new > dt.get(g, 0):
                dt[g] = tail_new
        t_from = np.asarray(trunc_tails, np.uint64) + np.uint64(1)
        for g, tail in zip(np.asarray(trunc_gs).tolist(),
                           np.asarray(trunc_tails).tolist()):
            g, tail = int(g), int(tail)
            self.conf.truncate(g, tail)
            dt[g] = tail
            self._trim_cache_tail(g, tail)
        f_keep = []
        for k, (g, index) in enumerate(zip(np.asarray(floor_gs).tolist(),
                                           np.asarray(floor_idxs).tolist())):
            g, index = int(g), int(index)
            self.conf.set_floor(g, index, 0)
            if index <= self.wal.floor(g):
                continue   # same guard as set_floor: no record staged
            f_keep.append(k)
            self._trim_cache_floor(g, index)
            dt[g] = max(dt.get(g, 0), index)
        f_keep = np.asarray(f_keep, np.int64)
        f_gs = np.asarray(floor_gs, np.uint32)[f_keep]
        f_idx = np.asarray(floor_idxs, np.uint64)[f_keep]
        f_term = np.asarray(floor_terms, np.int64)[f_keep]
        return self.wal.stage_and_sync(
            g_all, i_all, t_all, ptr_all, lens_all,
            np.asarray(trunc_gs, np.uint32), t_from,
            f_gs, f_idx, f_term, workers=workers, sync=sync)

    def pack_ae_blob(self, cols, starts, ns, *, workers: int = 1):
        """Native AppendEntries blob pack (codec payload_blob_fn hook):
        ``(ok_mask, blob)`` or None when the native tier is unavailable
        (codec falls back to its Python per-column loop)."""
        pack = getattr(self.wal, "pack_ae", None)
        if pack is None:
            return None
        return pack(cols, starts, ns, workers=workers)

    def put_conf(self, g: int, idx: int, word: int) -> None:
        """Record a config entry (§6 membership plane) so recovery can
        rebuild the conf ring; durable at the next sync()."""
        self.conf.put(g, idx, word)

    def conf_overwrite(self, g: int, start: int) -> None:
        """Mirror an entry overwrite at ``start`` into the membership
        sidecar: recorded config entries at >= start die (the WAL's
        replay drops that suffix, and a conflicting adoption may replace
        a config entry with an ordinary one)."""
        self.conf.truncate(g, start - 1)

    def conf_export(self) -> dict:
        """{g: (floor_word, {idx: word})} — recovery input."""
        return self.conf.export()

    def _trim_cache_tail(self, g: int, tail: int) -> None:
        """Drop cached entries above ``tail`` (suffix truncation)."""
        ent = self._cache.get(g)
        if ent:
            starts, runs = ent
            while starts and starts[-1] > tail:
                starts.pop()
                runs.pop()
            if runs and runs[-1].end > tail:
                r = runs[-1]
                keep = tail - r.start + 1
                runs[-1] = self._maybe_compact(
                    PayloadRun(r.start, r.buf, r.offs[:keep],
                               r.lens[:keep]))

    def _trim_cache_floor(self, g: int, index: int) -> None:
        """Drop cached entries at/under ``index`` (compaction floor)."""
        ent = self._cache.get(g)
        if ent:
            starts, runs = ent
            drop = 0
            while drop < len(runs) and runs[drop].end <= index:
                drop += 1
            if drop:
                del starts[:drop]
                del runs[:drop]
            if runs and runs[0].start <= index:
                r = runs[0]
                k = index + 1 - r.start
                runs[0] = self._maybe_compact(
                    PayloadRun(index + 1, r.buf, r.offs[k:], r.lens[k:]))
                starts[0] = index + 1

    def truncate_to(self, g: int, tail: int) -> None:
        """Ensure the durable suffix beyond `tail` dies (conflict/snapshot
        discard).  No-op if the durable tail is already <= tail."""
        self.conf.truncate(g, tail)
        if self._durable_tail.get(g, self.wal.tail(g)) > tail:
            self.wal.truncate(g, tail + 1)
            self._durable_tail[g] = tail
            self._trim_cache_tail(g, tail)

    def put_stable(self, g: int, term: int, ballot: int) -> None:
        if self._stable.get(g) == (term, ballot):
            return
        self.wal.append_stable(g, term, ballot)
        self._stable[g] = (term, ballot)

    def put_stable_batch(self, groups, terms, ballots) -> None:
        """Stage many (term, ballot) records in one store call (the
        runtime's change-detected sweep hands over every moved lane at
        once; steady state is an empty call)."""
        st = self._stable
        append = self.wal.append_stable
        for g, t, b in zip(groups, terms, ballots):
            g, t, b = int(g), int(t), int(b)
            if st.get(g) == (t, b):
                continue
            append(g, t, b)
            st[g] = (t, b)

    def set_floor(self, g: int, index: int, term: int,
                  conf_word: int = 0) -> None:
        """Raise the compaction floor (snapshot milestone).  ``conf_word``
        (nonzero) additionally pins the config AS OF the milestone — the
        snapshot-install path passes the offer's config; ordinary
        compaction folds the group's own recorded entries instead."""
        self.conf.set_floor(g, index, conf_word)
        if index <= self.wal.floor(g):
            return
        self.wal.milestone(g, index, term)
        self._trim_cache_floor(g, index)
        self._durable_tail[g] = max(self._durable_tail.get(g, 0), index)

    def reset_group(self, g: int) -> None:
        """Forget a destroyed group's entire durable state (entries, stable
        record, milestone) so a future group can reuse the lane from
        scratch (the reference deletes the group's RocksDB dir,
        command/storage/RocksStateLoader.java:48-59)."""
        self.wal.reset(g)
        self.conf.reset(g)
        self._cache.pop(g, None)
        self._stable.pop(g, None)
        self._durable_tail.pop(g, None)

    def sync(self) -> None:
        """The durability barrier: one fsync covering all staged writes
        (the membership sidecar flushes inside the same barrier)."""
        self.conf.flush()
        self.wal.sync()

    def sync_stripes(self, stripes) -> None:
        """Fsync only the given WAL stripes (striped host tier: each
        worker barriers exactly the shards it staged).  The membership
        sidecar is NOT flushed here — it is a single global file, so the
        orchestrator flushes it once per tick before any ack leaves
        (conf-bearing ticks take the serial host path entirely)."""
        ss = getattr(self.wal, "sync_shards", None)
        if ss is not None:
            ss(stripes)
        else:
            self.wal.sync()

    @property
    def n_stripes(self) -> int:
        """How many independently fsync-able WAL stripes back this store
        (1 for an unsharded WAL) — the striped host tier's worker-count
        ceiling."""
        return int(getattr(self.wal, "n_shards", 1))

    def conf_flush(self) -> None:
        """Flush the membership sidecar alone (striped host tier: the
        orchestrator's share of the durability barrier)."""
        self.conf.flush()

    # -- injectable fault table (testkit/faultfs) ----------------------
    def set_fault(self, op: str, after: int = 0, value: int = 0,
                  shard: int = 0) -> None:
        """Arm an injected I/O fault on one WAL stripe (unsharded WALs
        have exactly stripe 0) — see log/wal.py _FAULT_OPS."""
        if hasattr(self.wal, "n_shards"):
            self.wal.set_fault(op, after, value, shard=shard)
        else:
            assert shard == 0
            self.wal.set_fault(op, after, value)

    def clear_faults(self) -> None:
        self.wal.clear_faults()

    def poisoned_stripes(self):
        """Stripe ids whose engines latched a fail-stop fault."""
        ps = getattr(self.wal, "poisoned_shards", None)
        if ps is not None:
            return ps()
        return [0] if getattr(self.wal, "poisoned", False) else []

    def checkpoint(self) -> None:
        """Rewrite live state, dropping dead segments (synchronous GC —
        test/offline use; the runtime uses the three-phase path below)."""
        self.wal.checkpoint()

    def should_gc(self, ratio: float = 4.0, min_bytes: int = 8 << 20) -> bool:
        """GC trigger: disk footprint exceeds ``min_bytes`` AND ``ratio`` x
        the live set (the reference reclaims continuously via RocksDB
        deleteRange, RocksLog.java:228-242; a segmented WAL reclaims by
        rewriting the live set, so the trigger ratio bounds disk at
        ~ratio x live)."""
        total = self.wal.total_bytes()
        if total < min_bytes:
            return False
        return total > ratio * max(self.wal.live_bytes(), 1)

    def maybe_gc(self, ratio: float = 4.0, min_bytes: int = 8 << 20) -> bool:
        """Synchronous trigger-then-checkpoint (tests/offline tools)."""
        if self.should_gc(ratio, min_bytes):
            self.wal.checkpoint()
            return True
        return False

    # Three-phase GC: begin/finish on the owning (tick) thread — both
    # bounded, memory-only plus a rename/unlink — with the live-set rewrite
    # on a worker thread (VERDICT r2 #6: the synchronous checkpoint was a
    # multi-second tick stall at scale).
    def gc_begin(self) -> int:
        return self.wal.gc_begin()

    def gc_rewrite(self) -> int:
        return self.wal.gc_rewrite()

    def gc_finish(self) -> int:
        return self.wal.gc_finish()

    def gc_abort(self) -> None:
        self.wal.gc_abort()

    def segment_count(self) -> int:
        return int(self.wal.segment_count())

    # -- reads ---------------------------------------------------------------

    def payload(self, g: int, idx: int) -> Optional[bytes]:
        r = self._run_at(g, idx)
        if r is not None:
            return r.entry(idx - r.start)
        p = self.wal.entry_payload(g, idx)
        if p is not None:
            # Cache the miss: a laggard catch-up re-reads the same window
            # every tick until the follower advances — one WAL read per
            # entry, not one per entry per tick.
            self._backfill(g, idx, p)
        return p

    def payload_batch(self, g: int, start: int, n: int) -> List[bytes]:
        return [b"" if p is None else p
                for p in self.payloads_window(g, start, n)]

    def payloads_window(self, g: int, start: int, n: int
                        ) -> List[Optional[bytes]]:
        """Payloads for [start, start+n) with None where absent — run
        lookups amortized over the window (the replication pack and apply
        paths call this once per window instead of once per entry).  WAL
        reads only run for the (rare) cache misses."""
        out: List[Optional[bytes]] = [None] * n
        idx = start
        while idx < start + n:
            r = self._run_at(g, idx)
            if r is None:
                p = self.wal.entry_payload(g, idx)
                if p is not None:
                    self._backfill(g, idx, p)
                out[idx - start] = p
                idx += 1
                continue
            k = idx - r.start
            m = min(r.end, start + n - 1) - idx + 1
            mv = memoryview(r.buf)
            offs, lens = r.offs, r.lens
            for j in range(m):
                a = int(offs[k + j])
                out[idx - start + j] = bytes(mv[a:a + int(lens[k + j])])
            idx += m
        return out

    def payload_runs(self, g: int, start: int, n: int):
        """Zero-copy window read: ``(pieces, lens)`` where pieces are
        contiguous buffer slices covering entries [start, start+n) in
        order and lens is the uint32 length vector — the wire pack path
        consumes this with no per-entry work.  Cache misses fall back to
        WAL reads (as one-entry pieces); returns None iff an entry is
        truly absent (caller drops the column, same loss semantics as
        ever)."""
        pieces: List = []
        len_parts: List[np.ndarray] = []
        idx = start
        while idx < start + n:
            r = self._run_at(g, idx)
            if r is None:
                p = self.wal.entry_payload(g, idx)
                if p is None:
                    return None
                self._backfill(g, idx, p)
                pieces.append(p)
                len_parts.append(np.asarray([len(p)], np.uint32))
                idx += 1
                continue
            k = idx - r.start
            m = min(r.end, start + n - 1) - idx + 1
            pieces.append(r.piece(k, m))
            len_parts.append(r.lens[k:k + m])
            idx += m
        lens = (len_parts[0] if len(len_parts) == 1
                else np.concatenate(len_parts))
        return pieces, lens

    def entry_term(self, g: int, idx: int) -> int:
        return int(self.wal.entry_term(g, idx))

    def export_state(self, G: int, L: int):
        """Bulk crash-recovery export (LogStoreSPI contract): one engine
        call fills every per-group array + the term ring."""
        return self.wal.export_state(G, L)

    def stable(self, g: int):
        return self.wal.stable(g)

    def tail(self, g: int) -> int:
        return int(self.wal.tail(g))

    def floor(self, g: int) -> int:
        return int(self.wal.floor(g))

    def floor_term(self, g: int) -> int:
        return int(self.wal.floor_term(g))

    def close(self) -> None:
        self.wal.close()


def restore_raft_state(cfg, node_id: int, store: LogStore, seed: int = 0,
                       device=None):
    """Rebuild the device RaftState from the durable store after a crash.

    Follows the reference's restore order (RaftContext.initialize,
    context/RaftContext.java:91-113): stable (term, ballot) first, then the
    log window above the milestone floor.  commitIndex is NOT persisted —
    it is rediscovered from leaderCommit traffic, exactly like the
    reference's volatile commitIndex (RocksLog.java:50, 92-109) — except
    entries at/below the floor, which are committed by definition.

    The state is one node's, without a node axis (the shape of
    ``init_state``), on ``device`` (default: the card; raises without
    one, as ``init_state`` does).
    """
    import torch

    from ..core.types import NIL, boot_conf_word, init_state

    state = init_state(cfg, node_id, seed=seed, device=device)
    dev = state.term.device

    def to_dev(a):
        return torch.from_numpy(np.array(a, order="C")).to(dev)
    G, L = cfg.n_groups, cfg.log_slots
    # One bulk export call instead of an O(G*L) Python walk (VERDICT r1
    # #8); the native engine fills every per-group array + the term ring
    # in C (wal_export_state).  Works against any LogStoreSPI store.
    ex = store.export_state(G, L)
    term = np.where(ex["has_stable"] > 0, ex["stable_term"], 0) \
        .astype(np.int32)
    voted = np.where(ex["has_stable"] > 0, ex["ballot"], NIL) \
        .astype(np.int32)
    base = ex["floor"].astype(np.int32)
    base_term = ex["floor_term"].astype(np.int32)
    last = np.maximum(ex["tail"], ex["floor"]).astype(np.int32)
    commit = ex["floor"].astype(np.int32)
    ring = ex["ring"]
    # Contiguity check without a per-entry walk: live_count must equal the
    # window size.  A gap above the floor (inconsistent WAL) falls back to
    # the slow scan for just that group.
    expected = (last.astype(np.int64) - base.astype(np.int64))
    suspect = np.nonzero(ex["live_count"] != expected)[0]
    for g in suspect.tolist():
        ring[g] = 0
        last[g] = base[g]
        for idx in range(int(base[g]) + 1, int(ex["tail"][g]) + 1):
            t = store.entry_term(g, idx)
            if t < 0:
                break
            ring[g, idx % L] = t
            last[g] = idx
        # Repair the durable store to the adopted tail: entries above the
        # gap are unreachable to the engine, and leaving them in the WAL
        # would let a later contiguous re-append resurrect stale
        # terms/payloads on the NEXT recovery (the runtime's truncation
        # change-detection assumes durable tail == device tail at boot).
        if int(ex["tail"][g]) > int(last[g]):
            store.truncate_to(g, int(last[g]))
    if len(suspect):
        store.sync()
    # Membership restore (§6 durable config): rebuild the conf ring from
    # the WAL's membership sidecar — live config entries back into their
    # ring slots, the floor config into base_conf.  Entries the WAL
    # truncated after their last sidecar write are dropped by the window
    # bound; a store without the sidecar (LogStoreSPI products) boots the
    # full-voter config, exactly like a fresh lane.
    cring = np.zeros((G, L), np.int32)
    bconf = np.full(G, boot_conf_word(cfg), np.int32)
    # The derived-config cache lanes (RaftState.conf_idx/conf_word) must
    # match latest_conf(log, last) at boot — rebuilt here alongside the
    # ring.
    conf_idx = np.zeros(G, np.int32)
    conf_word = bconf.copy()
    conf_export = getattr(store, "conf_export", None)
    if conf_export is not None:
        for g, (floor_word, entries) in conf_export().items():
            if g >= G:
                continue
            if floor_word:
                bconf[g] = floor_word
            for idx, word in sorted(entries.items()):
                if base[g] < idx <= last[g]:
                    cring[g, idx % L] = word
                    conf_idx[g], conf_word[g] = idx, word
                elif idx <= base[g]:
                    bconf[g] = word
            if conf_idx[g] == 0:
                conf_word[g] = bconf[g]
    return state.replace(
        conf_idx=to_dev(conf_idx), conf_word=to_dev(conf_word),
        term=to_dev(term), voted_for=to_dev(voted),
        commit=to_dev(commit),
        log=state.log.replace(
            term=to_dev(ring), conf=to_dev(cring),
            base=to_dev(base),
            base_term=to_dev(base_term),
            base_conf=to_dev(bconf), last=to_dev(last)),
        next_idx=to_dev(np.broadcast_to(last[:, None] + 1,
                                             (G, cfg.n_peers)).copy()),
        send_next=to_dev(np.broadcast_to(last[:, None] + 1,
                                              (G, cfg.n_peers)).copy()),
    )
