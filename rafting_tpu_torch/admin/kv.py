"""MVCC KV engine + client-side STM for the admin control plane.

Re-creation of the reference's software-transactional-memory stack
(command/admin/stm/KVEngine.java:33-97, STM.java:23-51, Version.java,
Revision.java): values carry the transaction id that wrote them;
``commit_tx`` validates every touched key's version against the
transaction's read snapshot and applies the write-set atomically — the
optimistic-concurrency substrate the Administrator replicates its group
lifecycle through.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple


class KVEngine:
    """Versioned KV store.  Deterministic: driven only by replicated
    commands, so every replica's engine converges."""

    def __init__(self):
        # key -> (value, tx_id of the writing transaction)
        self.data: Dict[str, Tuple[Any, int]] = {}
        self.last_tx = 0

    def next_tx(self) -> int:
        """Allocate a transaction id (reference MVStore.nextTx,
        KVEngine.java:41-44)."""
        self.last_tx += 1
        return self.last_tx

    def get(self, key: str) -> Optional[Tuple[Any, int]]:
        return self.data.get(key)

    def version(self, key: str) -> int:
        ent = self.data.get(key)
        return ent[1] if ent is not None else 0

    def commit_tx(self, tx_id: int,
                  mods: Dict[str, Tuple[int, Any]]) -> bool:
        """Validate-then-apply (reference commitTx conflict check,
        KVEngine.java:46-64): every key's current version must equal the
        version the transaction read; on success all writes land
        atomically stamped with ``tx_id``.  A value of None deletes."""
        for key, (expect, _) in mods.items():
            if self.version(key) != expect:
                return False
        for key, (_, value) in mods.items():
            if value is None:
                self.data.pop(key, None)
            else:
                self.data[key] = (value, tx_id)
        return True

    # -- checkpoints (reference dumpTo/loadFrom, KVEngine.java:66-88) -------

    def dump(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"last_tx": self.last_tx,
                       "data": {k: [v, t] for k, (v, t)
                                in self.data.items()}}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def load(self, path: str) -> None:
        with open(path) as f:
            raw = json.load(f)
        self.last_tx = raw["last_tx"]
        self.data = {k: (v, t) for k, (v, t) in raw["data"].items()}

    def snapshot_view(self) -> Dict[str, Tuple[Any, int]]:
        return dict(self.data)


class STM:
    """Client-side transaction buffer (reference STM.java:23-51): reads
    record the version seen, writes are buffered; ``mods()`` produces the
    {key: (expected_version, new_value)} set for an optimistic commit."""

    def __init__(self, engine: KVEngine):
        self._engine = engine
        self._reads: Dict[str, int] = {}
        self._writes: Dict[str, Any] = {}

    def get(self, key: str) -> Any:
        if key in self._writes:
            return self._writes[key]
        ent = self._engine.get(key)
        self._reads[key] = ent[1] if ent is not None else 0
        return ent[0] if ent is not None else None

    def put(self, key: str, value: Any) -> None:
        if key not in self._reads:
            self._reads[key] = self._engine.version(key)
        self._writes[key] = value

    def delete(self, key: str) -> None:
        self.put(key, None)

    def mods(self) -> Dict[str, Tuple[int, Any]]:
        """The mod-set: only written keys travel, each guarded by the
        version this transaction observed (reference STM.mod:39-51)."""
        return {k: (self._reads.get(k, 0), v)
                for k, v in self._writes.items()}
