"""Wire codec for the host transport plane.

The reference moves RPCs one Java object at a time through a custom Netty
frame protocol (transport/EventCodec.java:25-40 — SOH/STX framing, Kryo
bodies, 64MB cap).  Here the unit of transfer is a *tick slice*: everything
one node says to one peer in one engine tick, for all groups at once, packed
as sparse columns of the dense ``Messages`` arrays (only groups with a valid
message travel).  This is the wire analog of the reference's single
scope-multiplexed connection per peer (transport/NettyNode.java:54-74) with
the per-RPC overhead amortized across every group.

Frame format (all little-endian):
    magic u32 | type u8 | body_len u32 | crc32(body) u32 | body

Types:
    HELLO     — connection handshake: (node_id, G, P, B) shape contract
                (reference ShakeHandEvent, transport/EventBus.java:71-97)
    MSGS      — one tick slice (see ``pack_slice``)
    SNAP_REQ  — snapshot fetch request: (group, index, term)
                (reference WaitSnapEvent, transport/event/WaitSnapEvent.java:8-38)
    SNAP_HDR  — snapshot response header: (group, index, term, ok, total_len)
                (reference TransSnapEvent, transport/event/TransSnapEvent.java:8-64).
                After an ok header the stream switches to TRANSPARENT
                mode: exactly `total_len` RAW file bytes follow, outside
                the frame codec — served zero-copy via sendfile and
                written to disk incrementally on the receiving side.
                This matches the reference byte-for-byte in spirit
                (DefaultFileRegion sendfile, transport/EventBus.java:98-111;
                "transparent mode", EventCodec.java:282-290): the CRC
                covers the header only, the bulk pays no per-chunk
                framing or checksum, and snapshot size is unbounded by
                MAX_BODY.
"""

from __future__ import annotations

import struct
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

MAGIC = 0x54505552  # "RUPT"
HELLO, MSGS, SNAP_REQ, SNAP_HDR, FWD_REQ, FWD_RESP = 1, 2, 3, 4, 5, 6
# Linearizable-read forward: same body format as FWD_REQ/FWD_RESP, routed
# to the serve side's read handler (RaftNode.read) instead of submit —
# reads must execute on the leader but never enter the log.
FWD_READ = 7
# Membership-op forward: a follower relays a §6 change or a leadership
# transfer to the current leader.  Body: group u32 | op u8 (CONF_OP_*) |
# timeout_ms u32 | a u32 | b u32 (conf: voters/learners masks; xfer:
# target/0).  Replies travel as FWD_RESP with a JSON result.
FWD_CONF = 8
CONF_OP_CHANGE, CONF_OP_TRANSFER = 1, 2
# Hop-tracing sideband (utils/latency.py HopTracer): a leader attaches a
# compact trace context to the AE traffic shipping a SAMPLED entry
# (direction 0, request), and the follower echoes it back with
# single-clock durability durations (direction 1, echo).  The frames
# piggyback on the same per-peer blob as the MSGS slice — one send, no
# extra wire round trips — and the kind is OUTSIDE SCHEMA_TAG (the tag
# covers the MSGS column layout only), so a hop-aware node interoperates
# with a hop-blind one: an unrecognized frame type falls through the
# reader's dispatch unhandled, and the ignored context simply expires
# leader-side (never fabricates a latency).
HOPS = 9

MAX_BODY = 64 << 20  # 64 MB cap, matching the reference (EventCodec.java:26)

_HDR = struct.Struct("<IBII")


class PayloadRun:
    """A contiguous run of entry payloads for ONE group, referencing a
    shared arena buffer: ``offs[k]``/``lens[k]`` locate entry
    ``start + k``'s bytes inside ``buf``.  The universal payload currency
    of the host tier (wire unpack -> adoption staging -> WAL -> cache ->
    wire pack): per-entry bytes objects are materialized only at the few
    consumers that truly need them (state-machine apply, SPI fallbacks).
    Entries are back-to-back in ``buf`` (offs strictly cumulative), so any
    sub-range is itself one contiguous slice — what lets the staging and
    pack paths work per-RUN instead of per-entry."""

    __slots__ = ("start", "buf", "offs", "lens", "end")

    def __init__(self, start: int, buf, offs: np.ndarray, lens: np.ndarray):
        self.start = start          # log index of entry 0
        self.buf = buf              # bytes-like arena
        self.offs = offs            # uint64 [n] absolute offsets into buf
        self.lens = lens            # uint32 [n]
        # Last covered log index, inclusive — precomputed: the run cache's
        # lookup path reads it millions of times per second.
        self.end = start + len(lens) - 1

    def __len__(self) -> int:
        return len(self.lens)

    def piece(self, k0: int, n: int):
        """The single contiguous buffer slice holding entries
        [start+k0, start+k0+n) — valid because entries are back-to-back."""
        a = int(self.offs[k0])
        b = int(self.offs[k0 + n - 1]) + int(self.lens[k0 + n - 1])
        return memoryview(self.buf)[a:b]

    def entry(self, k: int) -> bytes:
        a = int(self.offs[k])
        return bytes(memoryview(self.buf)[a:a + int(self.lens[k])])

    def materialize(self, k0: int = 0, n: int = -1) -> List[bytes]:
        """Per-entry bytes for [k0, k0+n) (n=-1: to the end)."""
        if n < 0:
            n = len(self.lens) - k0
        mv = memoryview(self.buf)
        offs, lens = self.offs, self.lens
        return [bytes(mv[int(offs[k]):int(offs[k]) + int(lens[k])])
                for k in range(k0, k0 + n)]

    @classmethod
    def single(cls, start: int, payload: bytes) -> "PayloadRun":
        """One-entry run (the submit() / cache-backfill shape) — ONE
        definition of the degenerate arena layout."""
        return cls(start, payload, np.zeros(1, np.uint64),
                   np.asarray([len(payload)], np.uint32))

    @classmethod
    def from_payloads(cls, start: int, payloads) -> "PayloadRun":
        """Build an arena run from a list of bytes (client submission
        path): one join + two vector ops, no per-entry records."""
        n = len(payloads)
        lens = np.fromiter(map(len, payloads), np.uint32, n)
        offs = np.zeros(n, np.uint64)
        if n > 1:
            np.cumsum(lens[:-1], dtype=np.uint64, out=offs[1:])
        return cls(start, b"".join(payloads), offs, lens)

# Message kinds -> (valid flag field, data fields).  Field order is the wire
# order; dtypes/shapes come from the Messages template at pack/unpack time.
KIND_FIELDS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "ae": ("ae_valid", ("ae_term", "ae_prev_idx", "ae_prev_term",
                        "ae_commit", "ae_n", "ae_ents", "ae_cents",
                        "ae_occ", "ae_tick")),
    "aer": ("aer_valid", ("aer_term", "aer_success", "aer_match",
                          "aer_empty", "aer_occ", "aer_tick")),
    "rv": ("rv_valid", ("rv_term", "rv_last_idx", "rv_last_term",
                        "rv_prevote")),
    "rvr": ("rvr_valid", ("rvr_term", "rvr_granted", "rvr_prevote",
                          "rvr_echo")),
    "is": ("is_valid", ("is_term", "is_idx", "is_last_term", "is_probe",
                        "is_conf")),
    "isr": ("isr_valid", ("isr_term", "isr_success", "isr_probe")),
    # TimeoutNow (§3.10 leadership transfer).
    "tn": ("tn_valid", ("tn_term",)),
}
KIND_IDS = {k: i for i, k in enumerate(KIND_FIELDS)}
KIND_BY_ID = {i: k for k, i in KIND_IDS.items()}


def frame(ftype: int, body: bytes) -> bytes:
    if len(body) > MAX_BODY:
        raise IOError(f"frame body {len(body)} exceeds MAX_BODY {MAX_BODY}")
    return _HDR.pack(MAGIC, ftype, len(body), zlib.crc32(body)) + body


class FrameReader:
    """Incremental frame decoder over a byte stream (the stateful analog of
    the reference's FrameDecoder, transport/EventCodec.java:219-335)."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[Tuple[int, bytes]]:
        self._buf += data
        out = []
        while True:
            if len(self._buf) < _HDR.size:
                break
            magic, ftype, blen, crc = _HDR.unpack_from(self._buf, 0)
            if magic != MAGIC or blen > MAX_BODY:
                raise IOError(f"bad frame header (magic={magic:#x})")
            if len(self._buf) < _HDR.size + blen:
                break
            body = bytes(self._buf[_HDR.size:_HDR.size + blen])
            if zlib.crc32(body) != crc:
                raise IOError("frame CRC mismatch")
            del self._buf[:_HDR.size + blen]
            out.append((ftype, body))
        return out



def peek_frame(buf) -> Optional[Tuple[int, bytes, int]]:
    """Decode exactly ONE frame from the head of ``buf``: returns
    (ftype, body, bytes_consumed), or None if the frame is still
    incomplete.  For streams that switch to transparent (raw) mode after
    a known frame — the snapshot channel after SNAP_HDR — where a greedy
    FrameReader would misparse the raw bytes that rode along in the same
    recv (the reference decoder makes the same one-frame-then-raw switch,
    EventCodec.java:282-290)."""
    if len(buf) < _HDR.size:
        return None
    magic, ftype, blen, crc = _HDR.unpack_from(buf, 0)
    if magic != MAGIC or blen > MAX_BODY:
        raise IOError(f"bad frame header (magic={magic:#x})")
    if len(buf) < _HDR.size + blen:
        return None
    body = bytes(buf[_HDR.size:_HDR.size + blen])
    if zlib.crc32(body) != crc:
        raise IOError("frame CRC mismatch")
    return ftype, body, _HDR.size + blen


def _schema_tag() -> int:
    """CRC of the per-kind field tables: two peers agree on the MSGS wire
    layout iff their tags match.  Carried in HELLO so a field-list change
    (e.g. aer_empty / is_probe) rejects a mixed-version peer with ONE
    clear log line instead of presenting as endless opaque connection
    drops when the misaligned columns fail the body bounds checks."""
    desc = ";".join(f"{k}:{v}:{','.join(d)}"
                    for k, (v, d) in KIND_FIELDS.items())
    return zlib.crc32(desc.encode())


SCHEMA_TAG = _schema_tag()


def pack_hello(node_id: int, G: int, P: int, B: int) -> bytes:
    return frame(HELLO, struct.pack("<IIIII", node_id, G, P, B, SCHEMA_TAG))


def unpack_hello(body: bytes) -> Tuple[int, int, int, int, int]:
    """Returns (node_id, G, P, B, schema_tag); a legacy 16-byte HELLO
    (no tag) yields tag 0, which never matches a real CRC."""
    if len(body) == 16:
        return struct.unpack("<IIII", body) + (0,)
    return struct.unpack("<IIIII", body)


# HOPS bodies: header (direction, origin node id, record count), then
# fixed-size records.  Requests carry the span's wire identity and the
# leader's send stamp (echoed back verbatim so the leader never needs a
# lookup to interpret an echo); echoes carry the follower's OWN-clock
# durations from frame arrival — receive->staged, receive->fsynced, and
# receive->echo-send (the residence the leader subtracts from its rtt
# for the clock-skew-free one-way estimate).
_HOPS_HDR = struct.Struct("<BBH")      # direction, origin, count
_HOP_REQ = struct.Struct("<IIiq")      # hop_id, group, idx, t_send_ns
_HOP_ECHO = struct.Struct("<Iqqqq")    # hop_id, t_send_ns, d_staged_ns,
#                                        d_fsync_ns, d_echo_ns
_HOPS_MAX = 0xFFFF


def pack_hops(direction: int, origin: int, records) -> bytes:
    """One HOPS frame.  ``records`` are request tuples
    ``(hop_id, group, idx, t_send_ns)`` when ``direction`` is
    HOP_REQUEST (0), echo tuples ``(hop_id, t_send_ns, d_staged_ns,
    d_fsync_ns, d_echo_ns)`` when HOP_ECHO (1)."""
    n = len(records)
    if n > _HOPS_MAX:
        records = records[:_HOPS_MAX]
        n = _HOPS_MAX
    rec = _HOP_REQ if direction == 0 else _HOP_ECHO
    return frame(HOPS, _HOPS_HDR.pack(direction, origin, n)
                 + b"".join(rec.pack(*r) for r in records))


def unpack_hops(body: bytes):
    """Returns ``(direction, origin, [record tuples])``; malformed
    bodies raise IOError like every other frame (reader treats it as a
    connection drop)."""
    if len(body) < _HOPS_HDR.size:
        raise IOError("truncated HOPS body")
    direction, origin, n = _HOPS_HDR.unpack_from(body, 0)
    rec = _HOP_REQ if direction == 0 else _HOP_ECHO
    if len(body) != _HOPS_HDR.size + n * rec.size:
        raise IOError("truncated HOPS body (malformed frame)")
    return direction, origin, [
        rec.unpack_from(body, _HOPS_HDR.size + i * rec.size)
        for i in range(n)]


def pack_snap_req(group: int, index: int, term: int) -> bytes:
    return frame(SNAP_REQ, struct.pack("<IQq", group, index, term))


def unpack_snap_req(body: bytes) -> Tuple[int, int, int]:
    return struct.unpack("<IQq", body)


def pack_fwd_req(group: int, payload: bytes,
                 timeout_s: float = 30.0, ftype: int = FWD_REQ) -> bytes:
    """Client-command forward: a follower relays a submission to the leader
    (the transport-level analog of the reference's NotLeader redirect hint,
    support/anomaly/NotLeaderException.java:11-27, resolved inside the
    cluster instead of bounced to the client).  The client's wait budget
    travels with the request so the serving side honors it.  ``ftype``
    FWD_READ carries a linearizable read instead (same body layout)."""
    tmo_ms = max(1, min(int(timeout_s * 1000), 0xFFFFFFFF))
    return frame(ftype, struct.pack("<II", group, tmo_ms) + payload)


def unpack_fwd_req(body: bytes) -> Tuple[int, float, bytes]:
    group, tmo_ms = struct.unpack_from("<II", body, 0)
    return group, tmo_ms / 1000.0, body[8:]


def pack_fwd_conf(group: int, op: int, a: int, b: int,
                  timeout_s: float = 30.0) -> bytes:
    """Membership-op forward frame (see FWD_CONF): ``op`` CONF_OP_CHANGE
    carries (voters, learners) masks in (a, b); CONF_OP_TRANSFER carries
    (target, 0)."""
    tmo_ms = max(1, min(int(timeout_s * 1000), 0xFFFFFFFF))
    return frame(FWD_CONF, struct.pack("<IBIII", group, op, tmo_ms, a, b))


def unpack_fwd_conf(body: bytes) -> Tuple[int, int, float, int, int]:
    group, op, tmo_ms, a, b = struct.unpack("<IBIII", body)
    return group, op, tmo_ms / 1000.0, a, b


def serve_conf(node, group: int, op: int, a: int, b: int,
               timeout_s: float) -> Tuple[bool, bytes]:
    """Shared serve-side contract for FWD_CONF (TCP and loopback): run
    the membership op on the local node and report the JSON-encoded
    result, with the same REFUSED/FAILED wire taxonomy as
    :func:`serve_forward` (a marked refusal provably never entered the
    log and is retry-safe)."""
    import json as _json

    from ..api.anomaly import is_refusal
    if node is None:
        return False, b"FAILED:forwarding disabled"
    try:
        if op == CONF_OP_CHANGE:
            fut = node.change_membership(group, a, b)
        elif op == CONF_OP_TRANSFER:
            fut = node.transfer_leadership(group, a)
        else:
            return False, f"FAILED:unknown membership op {op}".encode()
        return True, _json.dumps(fut.result(timeout=timeout_s)).encode()
    except Exception as e:
        tag = "REFUSED" if is_refusal(e) else "FAILED"
        return False, f"{tag}:{type(e).__name__}: {e}".encode()


def pack_fwd_resp(ok: bool, result: bytes) -> bytes:
    return frame(FWD_RESP, struct.pack("<B", 1 if ok else 0) + result)


def unpack_fwd_resp(body: bytes) -> Tuple[bool, bytes]:
    return bool(body[0]), body[1:]


def serve_forward(submit_handler: Optional[Callable], group: int,
                  payload: bytes, timeout_s: float,
                  encode_result: Optional[Callable] = None
                  ) -> Tuple[bool, bytes]:
    """Shared serve-side forward contract (TCP and loopback): run the
    submission, encode the apply result via the node's CmdSerializer
    (api/serial.py; default JSON).

    Error wire format: ``REFUSED:TypeName: msg`` when the error is a
    MARKED pre-log refusal (api/anomaly.py as_refusal — set only at the
    creation sites that provably never enqueued the command), so the
    client may safely retry it elsewhere; ``FAILED:TypeName: msg`` for
    anything else (abort on step-down of an accepted command, apply
    timeout, ...) where the command MAY still commit cluster-wide and a
    retry could double-apply.  Neither the exception TYPE (a step-down
    abort also raises NotLeaderError) nor future-completion TIMING (the
    tick thread can accept AND abort a command between our enqueue and
    our done() check) can carry the distinction — only the marker can."""
    import json as _json

    from ..api.anomaly import is_refusal
    if submit_handler is None:
        return False, b"FAILED:forwarding disabled"
    if encode_result is None:
        encode_result = lambda r: _json.dumps(r).encode()
    try:
        fut = submit_handler(group, payload)
    except Exception as e:
        tag = "REFUSED" if is_refusal(e) else "FAILED"
        return False, f"{tag}:{type(e).__name__}: {e}".encode()
    try:
        return True, encode_result(fut.result(timeout=timeout_s))
    except Exception as e:
        tag = "REFUSED" if is_refusal(e) else "FAILED"
        return False, f"{tag}:{type(e).__name__}: {e}".encode()


def pack_snap_hdr(group: int, index: int, term: int, ok: bool,
                  total_len: int) -> bytes:
    return frame(SNAP_HDR,
                 struct.pack("<IQqBQ", group, index, term,
                             1 if ok else 0, total_len))


def unpack_snap_hdr(body: bytes) -> Tuple[int, int, int, bool, int]:
    group, index, term, ok, total_len = struct.unpack("<IQqBQ", body)
    return group, index, term, bool(ok), total_len




# Kinds a leader may release BEFORE its tick's fsync in pipelined mode:
# AppendEntries (incl. heartbeats) only.  Safe because the commit rule
# counts a leader's own match at min(log.last, durable_tail) (core/step.py
# HostInbox.durable_tail clamp) — an un-fsynced local range can never be
# counted toward a majority.  Everything vote- or ack-bearing (rv/rvr, aer,
# is/isr, tn) reflects state that must be durable before it is announced
# and stays strictly behind the fsync barrier.
EAGER_KINDS = ("ae",)

_EMPTY_COLS = np.zeros(0, np.uint32)


def pack_kind_section(kind: str, fields: Dict[str, np.ndarray],
                      payload_window_fn: Optional[Callable[[int, int, int],
                                                           list]] = None,
                      payload_runs_fn: Optional[Callable] = None,
                      cols: Optional[np.ndarray] = None,
                      payload_blob_fn: Optional[Callable] = None
                      ) -> Tuple[bytes, int, np.ndarray]:
    """Pack ONE kind's wire section (the ``<BI>`` kind header + columns +
    field planes [+ ae payload blob]) for the given column ids.

    ``cols`` defaults to every valid column; a striped packer passes its
    own group subset so each stripe packs independently and the per-peer
    sections concatenate via :func:`assemble_slice` (``unpack_slice``
    accumulates repeated kinds).  Returns ``(section, n_cols, dropped)``:
    ``dropped`` lists the ``ae`` columns whose payloads were unavailable —
    an eager (pre-persist) packer defers them to the host phase, where the
    entries are staged; the serial pack path treats a drop as network loss
    (the engine's resend/timeout recovers).  Other kinds never drop.

    ``payload_blob_fn(cols, starts, ns) -> Optional[(ok_mask, blob)]``:
    the native host tier's bulk blob builder — when it returns a result,
    the whole per-column Python resolution loop is skipped and ``blob``
    (byte-identical layout: kept columns' u32 length words, then their
    payloads) lands in the section directly; columns with ``ok`` False
    are dropped/deferred exactly like a Python-path payload miss.  A
    ``None`` return falls back to the Python loop.
    """
    vfield, dfields = KIND_FIELDS[kind]
    if cols is None:
        cols = np.nonzero(fields[vfield])[0].astype(np.uint32)
    else:
        cols = np.asarray(cols, np.uint32)
    dropped = _EMPTY_COLS
    blob_section = b""
    if kind == "ae" and len(cols):
        # Resolve payloads for indices prev_idx+1 .. prev_idx+n per
        # column FIRST.  Blob layout: one u32 length VECTOR for all kept
        # entries, then the payload bytes concatenated — per-COLUMN bulk
        # ops (run slices when the store exposes runs, else a bytes
        # window), never a struct.pack per entry (the pack path is on the
        # per-tick critical section of every node).
        prevs = fields["ae_prev_idx"][cols]
        ns = fields["ae_n"][cols]
        if payload_blob_fn is not None:
            res = payload_blob_fn(
                cols, prevs.astype(np.int64) + 1, ns.astype(np.uint32))
            if res is not None:
                ok, blob_section = res
                dropped = cols[~ok]
                cols = cols[ok]
                n_cols = len(cols)
                parts = [struct.pack("<BI", KIND_IDS[kind], n_cols)]
                if n_cols:
                    parts.append(cols.tobytes())
                    for f in dfields:
                        parts.append(
                            np.ascontiguousarray(fields[f][cols]).tobytes())
                    parts.append(blob_section)
                return b"".join(parts), n_cols, dropped
        keep, drop, pieces, len_parts = [], [], [], []
        for g, prev, n in zip(cols.tolist(), prevs.tolist(), ns.tolist()):
            if n and payload_runs_fn is not None:
                run = payload_runs_fn(int(g), prev + 1, n)
                if run is None:
                    drop.append(g)
                    continue
                keep.append(g)
                pieces.extend(run[0])
                len_parts.append(np.asarray(run[1], np.uint32))
                continue
            win = (payload_window_fn(int(g), prev + 1, n)
                   if n and payload_window_fn is not None else
                   [None] * n if n else [])
            if any(p is None for p in win):
                drop.append(g)
                continue
            keep.append(g)
            pieces.extend(win)
            len_parts.append(np.fromiter(map(len, win), np.uint32,
                                         len(win)))
        cols = np.asarray(keep, np.uint32)
        dropped = np.asarray(drop, np.uint32)
        lens = (np.concatenate(len_parts) if len_parts
                else np.zeros(0, np.uint32))
        blob_section = lens.tobytes() + b"".join(pieces)
    n_cols = len(cols)
    parts = [struct.pack("<BI", KIND_IDS[kind], n_cols)]
    if n_cols:
        parts.append(cols.tobytes())
        for f in dfields:
            parts.append(np.ascontiguousarray(fields[f][cols]).tobytes())
        parts.append(blob_section)
    return b"".join(parts), n_cols, dropped


def assemble_slice(src: int, sections: List[bytes]) -> bytes:
    """Concatenate independently packed kind sections into ONE MSGS frame.

    One frame per (src, peer) per tick is a delivery invariant: the inbox
    accumulator drains one slice per source per tick, so per-stripe or
    eager/deferred sections must merge here rather than travel as separate
    frames (which would add a tick of latency each and grow the backlog).
    Sections may repeat a kind — ``unpack_slice`` concatenates them, and
    the dense scatter is last-wins in section order for any duplicated
    (kind, group) lane."""
    if len(sections) > 255:
        raise IOError(f"too many MSGS sections ({len(sections)})")
    return frame(MSGS,
                 struct.pack("<IB", src, len(sections)) + b"".join(sections))


def pack_slice(src: int, fields: Dict[str, np.ndarray],
               payload_fn: Optional[Callable[[int, int], Optional[bytes]]],
               payload_window_fn: Optional[Callable[[int, int, int], list]]
               = None,
               payload_runs_fn: Optional[Callable] = None) -> Optional[bytes]:
    """Pack one destination's tick slice into a MSGS frame body.

    ``fields`` maps Messages field name -> numpy array of shape [G] or
    [G, B] (this destination's slice of the outbox).  ``payload_fn(g, idx)``
    supplies AppendEntries command payloads (LogStore.payload);
    ``payload_window_fn(g, start, n) -> [bytes|None]`` is the batched
    variant (LogStore.payloads_window) used when provided — one call per
    column instead of one per entry.  ``payload_runs_fn(g, start, n) ->
    (pieces, lens) | None`` is the zero-copy variant (LogStore.
    payload_runs): contiguous buffer slices + a uint32 length vector, no
    per-entry Python at all — preferred when available.  Returns None when
    the slice is empty (nothing valid for this peer).  An ``ae`` column
    whose payload is unavailable (e.g. compacted between outbox build and
    pack) is dropped entirely — indistinguishable from network loss, which
    the engine's resend/timeout path already recovers; shipping a
    substitute empty command would silently diverge replica state.
    """
    if payload_window_fn is None and payload_fn is not None:
        # One resolution path: adapt the per-entry fetcher so the packing
        # logic (incl. column-drop-on-missing) has a single implementation
        # exercised by every caller and test.
        payload_window_fn = (lambda g, start, n:
                             [payload_fn(g, i)
                              for i in range(start, start + n)])
    sections: List[bytes] = []
    n_total = 0
    for kind in KIND_FIELDS:
        sec, n_cols, _dropped = pack_kind_section(
            kind, fields, payload_window_fn, payload_runs_fn)
        sections.append(sec)
        n_total += n_cols
    if n_total == 0:
        return None
    return assemble_slice(src, sections)


def unpack_slice(body: bytes, template: Dict[str, Tuple[np.dtype, tuple]],
                 n_groups: Optional[int] = None
                 ) -> Tuple[int, Dict[str, Tuple[np.ndarray, np.ndarray]],
                            Dict[int, "PayloadRun"]]:
    """Unpack a MSGS body.

    ``template`` maps field name -> (dtype, per-group trailing shape), e.g.
    ae_ents -> (int32, (B,)).  Returns (src, {field: (cols, values)},
    {group: PayloadRun}) — payloads as one contiguous arena RUN per group
    (an AE column is always a contiguous index range) referencing the
    frame body directly: offsets + lengths, ZERO per-entry bytes objects.
    The adoption path slices the run's numpy vectors; per-entry bytes are
    materialized only where a consumer truly needs them (PayloadRun.
    materialize).  ``n_groups`` bounds-checks column ids so a corrupt or
    shape-mismatched frame can't scatter out of range.

    A kind may appear in SEVERAL sections (striped packers and the
    eager/deferred AE split each contribute one per frame —
    :func:`assemble_slice`): their columns CONCATENATE in section order,
    so the consumer's dense scatter is last-wins for a duplicated
    (kind, group) lane, and a later section's payload run replaces an
    earlier one for the same group.
    """
    end = len(body)

    def need(n: int, off: int) -> None:
        # A CRC-valid but semantically malformed frame (buggy or hostile
        # peer) must fail as a clean IOError — the reader treats it as a
        # connection drop — never as silent truncation or a stray
        # struct.error that kills the reader thread.
        if off + n > end:
            raise IOError("truncated MSGS body (malformed frame)")

    need(struct.calcsize("<IB"), 0)
    src, n_kinds = struct.unpack_from("<IB", body, 0)
    off = struct.calcsize("<IB")
    # field -> list of (cols, vals) parts, one per section carrying it;
    # concatenated at the end (the single-section case stays zero-copy).
    acc: Dict[str, List[Tuple[np.ndarray, np.ndarray]]] = {}
    payloads: Dict[int, PayloadRun] = {}
    for _ in range(n_kinds):
        need(struct.calcsize("<BI"), off)
        kid, n_cols = struct.unpack_from("<BI", body, off)
        off += struct.calcsize("<BI")
        if kid not in KIND_BY_ID:
            raise IOError(f"unknown message kind id {kid}")
        kind = KIND_BY_ID[kid]
        vfield, dfields = KIND_FIELDS[kind]
        if n_cols == 0:
            continue
        need(4 * n_cols, off)
        cols = np.frombuffer(body, np.uint32, n_cols, off).astype(np.int64)
        if n_groups is not None and cols.size and int(cols.max()) >= n_groups:
            raise IOError("column id out of range (shape mismatch?)")
        off += 4 * n_cols
        acc.setdefault(vfield, []).append((cols, np.ones(n_cols, bool)))
        sec_vals: Dict[str, np.ndarray] = {}
        for f in dfields:
            dt, trail = template[f]
            count = n_cols * int(np.prod(trail, dtype=np.int64)) \
                if trail else n_cols
            need(count * np.dtype(dt).itemsize, off)
            vals = np.frombuffer(body, dt, count, off).reshape(
                (n_cols,) + trail)
            off += vals.nbytes
            sec_vals[f] = vals
            acc.setdefault(f, []).append((cols, vals))
        if kind == "ae":
            prevs = sec_vals["ae_prev_idx"]
            ns = sec_vals["ae_n"].astype(np.int64)
            total = int(ns.sum())
            need(4 * total, off)
            lens = np.frombuffer(body, np.uint32, total, off)
            off += 4 * total
            ends = np.cumsum(lens, dtype=np.uint64)
            need(int(ends[-1]) if total else 0, off)
            starts = (ends - lens) + np.uint64(off)
            k = 0
            for g, prev, n in zip(cols.tolist(), prevs.tolist(), ns.tolist()):
                n = int(n)
                if n:
                    # One run per group: numpy slices into the shared body
                    # buffer — no per-entry bytes objects on the unpack
                    # path (they were ~5% of the durable tick at 32k).
                    payloads[int(g)] = PayloadRun(
                        int(prev) + 1, body, starts[k:k + n], lens[k:k + n])
                    k += n
            off += int(ends[-1]) if total else 0
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for f, parts in acc.items():
        if len(parts) == 1:
            out[f] = parts[0]
        else:
            out[f] = (np.concatenate([p[0] for p in parts]),
                      np.concatenate([p[1] for p in parts]))
    return src, out, payloads


def messages_template(cfg) -> Dict[str, Tuple[np.dtype, tuple]]:
    """Field -> (dtype, trailing shape beyond [P, G]) from a Messages.empty."""
    from ..core.types import Messages

    # Built on the CPU: the template is host metadata, and a torch dtype
    # maps to its numpy twin through the tensor itself.
    m = Messages.empty(cfg, device="cpu")
    out = {}
    for name in dir(m):
        if name.startswith("_"):
            continue
        v = getattr(m, name)
        if hasattr(v, "shape") and hasattr(v, "dtype"):
            out[name] = (v.numpy().dtype, tuple(v.shape[2:]))
    return out
