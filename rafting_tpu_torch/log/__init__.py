"""Durable host log tier of the port: the segmented WAL engine
(:mod:`wal`, native C++ with a Python fallback) and the :class:`LogStore`
facade the node runtime drives (:mod:`store`).  The in-memory store and
the store SPI of ``rafting_tpu.log`` are not ported yet."""

from .wal import WalStore, native_available  # noqa: F401
from .store import LogStore  # noqa: F401
