"""CRC-32C (Castagnoli) — dependency-free software implementation.

Used for the snapshot-archive integrity sidecars (snapshot payloads are
opaque machine bytes; the WAL keeps its existing per-record CRC-32/IEEE
frames, which run at C speed via zlib in the Python tier and a table in
the native tier).  Castagnoli is the standard choice for storage
checksums (iSCSI, ext4, RocksDB) for its better burst-error detection;
this table-driven version is pure Python and therefore only lives on
cold paths — checkpoint copies (off the tick thread) and the background
scrubber (budgeted per maintain pass).
"""

from __future__ import annotations

_POLY = 0x82F63B78  # reversed Castagnoli polynomial


def _make_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_TABLE = _make_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    """Incremental CRC-32C: ``crc32c(b, crc32c(a)) == crc32c(a + b)``.

    The whole 64-byte lanes of an input of two lanes or more go through
    ``_lanes`` (numpy, all lanes a byte position at a time); the byte loop
    takes the rest.  The values are the byte loop's.  The archive checks
    every snapshot it saves, serves and installs; the byte loop holds the
    interpreter lock for the whole file, about eight times as long as
    ``_lanes`` on a 40 KB snapshot, and every node thread of the process
    waits it out."""
    table = _TABLE
    c = (crc ^ 0xFFFFFFFF) & 0xFFFFFFFF
    mv = memoryview(data).cast("B")
    whole = len(mv) // 64 * 64
    if whole >= 128:
        c = _lanes(mv[:whole], c)
        mv = mv[whole:]
    for b in mv:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return (c ^ 0xFFFFFFFF) & 0xFFFFFFFF


def _lanes(mv, c: int, _cache={}) -> int:
    """The CRC register after the bytes of ``mv`` (whole 64-byte lanes)
    from register ``c``.  The register is linear over GF(2) in the bytes
    and in its start, so each lane is advanced on its own from 0 (the
    first from ``c``; lanes of zeros pad the front to a power of two and
    add nothing), all lanes one byte position per numpy step, and the
    lanes' registers are folded pairwise: left advanced over the right
    lane's length of zero bytes, XOR right, with the zero-run advance of
    64 * 2**k bytes held as four 256-entry byte tables per k (built once,
    each from the last by applying it twice)."""
    import numpy as np
    if not _cache:
        _cache["table"] = np.array(_TABLE, dtype=np.uint32)
        _cache["shifts"] = []
    table, shifts = _cache["table"], _cache["shifts"]

    def advance(tabs, r):
        return (tabs[0][r & 0xFF] ^ tabs[1][(r >> 8) & 0xFF]
                ^ tabs[2][(r >> 16) & 0xFF] ^ tabs[3][r >> 24])

    def shift(k):
        while len(shifts) <= k:
            r = np.concatenate([np.arange(256, dtype=np.uint32) << (8 * j)
                                for j in range(4)])
            if not shifts:
                for _ in range(64):
                    r = table[r & 0xFF] ^ (r >> 8)
            else:
                r = advance(shifts[-1], advance(shifts[-1], r))
            shifts.append(r.reshape(4, 256))
        return shifts[k]

    m = len(mv) // 64
    n = 1 << (m - 1).bit_length()
    lanes = np.zeros((n, 64), dtype=np.uint8)
    lanes[n - m:] = np.frombuffer(mv, dtype=np.uint8).reshape(m, 64)
    cols = np.ascontiguousarray(lanes.T)
    r = np.zeros(n, dtype=np.uint32)
    r[n - m] = c
    for i in range(64):
        r = table[(r ^ cols[i]) & 0xFF] ^ (r >> 8)
    k = 0
    while r.size > 1:
        r = advance(shift(k), r[0::2]) ^ r[1::2]
        k += 1
    return int(r[0])


def crc32c_file(path: str, chunk: int = 1 << 20, limit: int = -1) -> int:
    """CRC-32C of a file's first ``limit`` bytes (whole file when -1)."""
    c = 0
    remaining = limit
    with open(path, "rb") as f:
        while True:
            n = chunk if remaining < 0 else min(chunk, remaining)
            if n == 0:
                break
            buf = f.read(n)
            if not buf:
                break
            c = crc32c(buf, c)
            if remaining > 0:
                remaining -= len(buf)
    return c
