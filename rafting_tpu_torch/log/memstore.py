"""MemoryLogStore: a non-durable LogStoreSPI implementation.

The in-memory counterpart of the segmented WAL (the reference ships its log
SPI precisely so a user can swap the storage tier, command/spi/
StateLoader.java:8-12): same staging/sync/read/recovery contract, no disk.
``sync`` is a no-op — a crash loses everything, which is exactly the point
for unit tests, ephemeral groups and benchmarks that want to isolate the
engine from fsync cost.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class MemoryLogStore:
    def __init__(self, path: str = "", segment_bytes: int = 0):
        # Constructor shape-compatible with LogStore so factories can swap
        # the class; both args are ignored.
        self._entries: Dict[int, Dict[int, Tuple[int, bytes]]] = {}
        self._stable: Dict[int, Tuple[int, int]] = {}
        self._floor: Dict[int, Tuple[int, int]] = {}
        self._tail: Dict[int, int] = {}

    # -- staging writes ------------------------------------------------------

    def append_entries(self, g: int, start: int, terms: Sequence[int],
                       payloads: Sequence[bytes]) -> None:
        ge = self._entries.setdefault(g, {})
        for k, (t, p) in enumerate(zip(terms, payloads)):
            ge[start + k] = (int(t), p)
        self._tail[g] = max(self._tail.get(g, 0), start + len(terms) - 1)

    def append_batch(self, groups: Sequence[int], idxs: Sequence[int],
                     terms: Sequence[int], payloads: Sequence[bytes]) -> None:
        for g, i, t, p in zip(groups, idxs, terms, payloads):
            g, i = int(g), int(i)
            self._entries.setdefault(g, {})[i] = (int(t), p)
            if i > self._tail.get(g, 0):
                self._tail[g] = i

    def truncate_to(self, g: int, tail: int) -> None:
        ge = self._entries.get(g)
        if ge:
            for k in [k for k in ge if k > tail]:
                del ge[k]
        if self._tail.get(g, 0) > tail:
            self._tail[g] = tail

    def put_stable(self, g: int, term: int, ballot: int) -> None:
        self._stable[g] = (int(term), int(ballot))

    def set_floor(self, g: int, index: int, term: int) -> None:
        if index <= self.floor(g):
            return
        self._floor[g] = (int(index), int(term))
        ge = self._entries.get(g)
        if ge:
            for k in [k for k in ge if k <= index]:
                del ge[k]
        self._tail[g] = max(self._tail.get(g, 0), index)

    def reset_group(self, g: int) -> None:
        self._entries.pop(g, None)
        self._stable.pop(g, None)
        self._floor.pop(g, None)
        self._tail.pop(g, None)

    def sync(self) -> None:
        pass

    def checkpoint(self) -> None:
        pass

    # -- GC: nothing to reclaim ---------------------------------------------

    def should_gc(self, ratio: float = 4.0, min_bytes: int = 8 << 20) -> bool:
        return False

    def gc_begin(self) -> int:
        return -1

    def gc_rewrite(self) -> int:
        return -1

    def gc_finish(self) -> int:
        return -1

    def gc_abort(self) -> None:
        pass

    def segment_count(self) -> int:
        return 0

    # -- reads ---------------------------------------------------------------

    def payload(self, g: int, idx: int) -> Optional[bytes]:
        e = self._entries.get(g, {}).get(idx)
        return None if e is None else e[1]

    def payload_batch(self, g: int, start: int, n: int) -> List[bytes]:
        return [b"" if p is None else p
                for p in self.payloads_window(g, start, n)]

    def payloads_window(self, g: int, start: int, n: int
                        ) -> List[Optional[bytes]]:
        ge = self._entries.get(g, {})
        return [None if (e := ge.get(i)) is None else e[1]
                for i in range(start, start + n)]

    def entry_term(self, g: int, idx: int) -> int:
        e = self._entries.get(g, {}).get(idx)
        return -1 if e is None else e[0]

    def stable(self, g: int) -> Optional[Tuple[int, int]]:
        return self._stable.get(g)

    def tail(self, g: int) -> int:
        return self._tail.get(g, 0)

    def floor(self, g: int) -> int:
        return self._floor.get(g, (0, 0))[0]

    def floor_term(self, g: int) -> int:
        return self._floor.get(g, (0, 0))[1]

    # -- crash recovery ------------------------------------------------------

    def export_state(self, G: int, L: int) -> Dict[str, np.ndarray]:
        out = {
            "has_stable": np.zeros(G, np.int32),
            "stable_term": np.zeros(G, np.int64),
            "ballot": np.zeros(G, np.int64),
            "floor": np.zeros(G, np.int64),
            "floor_term": np.zeros(G, np.int64),
            "tail": np.zeros(G, np.int64),
            "live_count": np.zeros(G, np.int64),
            "ring": np.zeros((G, L), np.int32),
        }
        for g, (t, b) in self._stable.items():
            if g < G:
                out["has_stable"][g] = 1
                out["stable_term"][g] = t
                out["ballot"][g] = b
        for g, (i, t) in self._floor.items():
            if g < G:
                out["floor"][g] = i
                out["floor_term"][g] = t
        for g, t in self._tail.items():
            if g < G:
                out["tail"][g] = t
        for g, ge in self._entries.items():
            if g >= G:
                continue
            floor = int(out["floor"][g])
            tail = int(out["tail"][g])
            n = 0
            for idx, (t, _) in ge.items():
                if floor < idx <= tail:
                    out["ring"][g, idx % L] = t
                    n += 1
            out["live_count"][g] = n
        return out

    def close(self) -> None:
        pass
