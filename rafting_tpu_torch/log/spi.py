"""LogStoreSPI: the pluggable durable-log contract (reference StateLoader
SPI, command/spi/StateLoader.java:8-12, consumed through RaftFactory.loadState,
support/RaftFactory.java:18).

A log store owns every durable bit of a node's consensus state: entry
payloads + terms, the (term, ballot) stable record, the compaction-floor
milestone, and crash recovery.  The node runtime drives it with the tick
protocol (stage writes, then ONE :meth:`sync` barrier before any RPC from
that tick leaves — the reference's persist-before-reply rule,
context/member/RaftMember.java:25).

Implementations in-tree: :class:`rafting_tpu.log.store.LogStore` (segmented
group-commit WAL, native C++ engine with a byte-compatible Python fallback)
and :class:`rafting_tpu.log.memstore.MemoryLogStore` (non-durable, for
tests/ephemeral groups).  Swap via ``RaftFactory.log_store``.

Optional arena fast paths (the node runtime probes with ``getattr`` and
falls back to the protocol methods below when absent, so third-party
stores keep working unchanged):

* ``append_spans(spans)`` — stage a whole tick's appends as contiguous
  spans ``(group, start_index, buffer, lens_u32, terms)`` whose payload
  bytes sit back-to-back in ``buffer`` (terms: int64 vector or a plain
  int).  LogStore crosses into its native engine ONCE per tick with
  pointer vectors; a store without it receives per-entry materialized
  lists through :meth:`append_batch`.
* ``payload_runs(g, start, n) -> (pieces, lens_u32) | None`` — zero-copy
  window read consumed by the wire pack path and arena-aware machines
  (``RaftMachine.apply_run``); ``None`` iff an entry is absent.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np


@runtime_checkable
class LogStoreSPI(Protocol):
    # -- staging writes (durable after sync()) ------------------------------
    def append_entries(self, g: int, start: int, terms: Sequence[int],
                       payloads: Sequence[bytes]) -> None: ...

    def append_batch(self, groups: Sequence[int], idxs: Sequence[int],
                     terms: Sequence[int],
                     payloads: Sequence[bytes]) -> None: ...

    def truncate_to(self, g: int, tail: int) -> None: ...

    def put_stable(self, g: int, term: int, ballot: int) -> None: ...

    def set_floor(self, g: int, index: int, term: int) -> None: ...

    def reset_group(self, g: int) -> None: ...

    def sync(self) -> None: ...

    # -- space reclamation (no-ops for stores without a disk tier) ----------
    def should_gc(self, ratio: float = 4.0,
                  min_bytes: int = 8 << 20) -> bool: ...

    def gc_begin(self) -> int: ...       # < 0: nothing to do / unsupported

    def gc_rewrite(self) -> int: ...     # worker-thread phase

    def gc_finish(self) -> int: ...      # 0 = swapped in

    def gc_abort(self) -> None: ...

    def segment_count(self) -> int: ...

    # -- reads --------------------------------------------------------------
    def payload(self, g: int, idx: int) -> Optional[bytes]: ...

    def payloads_window(self, g: int, start: int, n: int
                        ) -> List[Optional[bytes]]: ...

    def entry_term(self, g: int, idx: int) -> int: ...   # -1 = absent

    def stable(self, g: int) -> Optional[Tuple[int, int]]: ...

    def tail(self, g: int) -> int: ...

    def floor(self, g: int) -> int: ...

    def floor_term(self, g: int) -> int: ...

    # -- crash recovery ------------------------------------------------------
    def export_state(self, G: int, L: int) -> Dict[str, np.ndarray]:
        """Bulk recovery export: arrays ``has_stable, stable_term, ballot,
        floor, floor_term, tail, live_count`` ([G]) and the entry-term
        ``ring`` ([G, L]) — everything ``restore_raft_state`` needs in one
        call (the vectorized analog of RaftContext.initialize's restore,
        context/RaftContext.java:91-113)."""
        ...

    def close(self) -> None: ...
