"""Durable host log tier for the TPU Multi-Raft node.

Device HBM holds only entry *terms* (the consensus metadata the kernels
need); this package owns the bytes: a native C++ segmented WAL engine
(:mod:`wal`) journaling all groups of a node with one fsync per tick, and
the :class:`LogStore` facade (:mod:`store`) that the node runtime drives —
the TPU-native replacement for the reference's per-group RocksDB stores
(curioloop/rafting command/storage/RocksLog.java) and StableLock records
(support/StableLock.java).
"""

from .wal import WalStore, native_available  # noqa: F401
from .store import LogStore  # noqa: F401
from .spi import LogStoreSPI  # noqa: F401
from .memstore import MemoryLogStore  # noqa: F401
