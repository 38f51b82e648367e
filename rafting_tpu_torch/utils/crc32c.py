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
    """Incremental CRC-32C: ``crc32c(b, crc32c(a)) == crc32c(a + b)``."""
    table = _TABLE
    c = (crc ^ 0xFFFFFFFF) & 0xFFFFFFFF
    for b in memoryview(data):
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return (c ^ 0xFFFFFFFF) & 0xFFFFFFFF


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
