"""SPI contracts: RaftMachine, MachineProvider, Checkpoint."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Protocol, runtime_checkable


@dataclasses.dataclass(frozen=True)
class Checkpoint:
    """A durable state-machine snapshot: file path + the log index it
    includes (reference RaftMachine.Checkpoint, command/RaftMachine.java:18-28)."""
    path: str
    index: int


@runtime_checkable
class RaftMachine(Protocol):
    """Per-group replicated state machine (command/RaftMachine.java:12-63).

    Contract:
    * :meth:`apply` is called exactly once per committed index, in index
      order, starting at ``last_applied() + 1``.  It must be atomic: apply
      fully or raise (a raise halts the group's apply frontier; the
      dispatcher retries later — reference RetryCommandException semantics,
      support/anomaly/RetryCommandException.java:10-25).
    * ``applies_empty`` (class attribute, default False): committed
      payloads may be EMPTY (``b""``) — a freshly elected leader appends
      one empty no-op entry (Raft §8 liveness, core/step.py phase 3).  A
      machine that sets ``applies_empty = True`` opts into seeing them
      (apply it as a harmless command, return anything) and keeps the
      strictly contiguous index stream.  WITHOUT the opt-in the
      dispatcher short-circuits empty payloads — the machine never sees
      them, its ``last_applied`` may lag the group frontier by trailing
      no-ops, and the index stream it observes has gaps at election
      no-ops (still strictly increasing).  This protects third-party
      machines that unconditionally parse payloads (e.g. ``json.loads``)
      from freezing their group on every election; the dispatcher logs
      loudly (once) when it engages.  Every in-tree machine opts in.
    * :meth:`checkpoint` produces a durable snapshot whose index is at
      least ``must_include`` (may block; called off the apply path).
    * :meth:`recover` atomically replaces state from a checkpoint.
    * :meth:`apply_batch` (optional — the dispatcher falls back to
      per-entry :meth:`apply` when absent): apply a CONTIGUOUS run of
      committed entries starting at ``start_index`` and return their
      results in order.  May return a SHORTER list than the input if an
      entry fails — the machine must have applied exactly the returned
      prefix; the dispatcher then retries the failing entry through
      :meth:`apply` for full diagnostics.  Lets a machine amortize
      per-entry overhead (one lock/transaction/fsync per batch — the
      analog of the reference's batched applyCommand loop over a commit
      advance, context/RaftRoutine.java:261-306).  CAUTION: a subclass
      overriding :meth:`apply` on a base that defines ``apply_batch``
      must override ``apply_batch`` too, or the dispatcher's batch path
      will bypass the override.
    * :meth:`apply_run` (optional, preferred over ``apply_batch`` when
      present): the ARENA variant — payload bytes arrive as contiguous
      buffer pieces plus a uint32 length vector instead of a per-entry
      list, so a machine that can consume slices (or ignores payloads)
      pays ZERO per-entry materialization.  Same shorter-prefix failure
      contract as ``apply_batch``, and the same caution about
      overriding ``apply``.
    * :meth:`read` (optional): serve a LINEARIZABLE QUERY against current
      machine state without going through the log (the read plane,
      core/step.py phase 8b: the runtime only calls this once the group's
      apply frontier covers the query's quorum-confirmed ReadIndex).
      Must not mutate state.  Called on the tick thread (the same
      single-writer thread as ``apply``), so no extra locking is needed.
      A machine WITHOUT ``read`` still gets linearizable reads: the
      runtime resolves the read future with the ReadIndex itself (the
      linearization point), which callers can pair with their own state
      access.
    * :meth:`expired_intents` (optional): 2PC participant hook.  A
      machine that implements the transaction vocabulary (see
      machine/kv_machine.py: ``txn_prepare`` buffers a write-intent
      under key locks with a wall-clock deadline; ``txn_commit`` /
      ``txn_abort`` finalize it — all replicated as ordinary log
      payloads, so the machine needs NO extra durability) exposes
      ``expired_intents(now) -> [{"txn", "coord", "deadline"}, ...]``
      so the runtime's recovery sweep (runtime/txn.py, driven off the
      tick loop on the leader) can find intents whose coordinator went
      quiet and resolve them by querying the coordinator group's
      replicated decision log.  Called on the tick thread (machine
      single-writer); must not mutate state and should be O(1) when no
      intents are live.  Machines without the hook simply never
      participate in cross-group transactions.  Contract obligations
      for implementers: prepare/commit/abort must be IDEMPOTENT
      (recovery replays them), commit/abort for an unknown txn must be
      safe no-ops, a finalized txn must never re-lock, and buffered
      intents must be INVISIBLE to both read paths (apply-side reads
      and this SPI's :meth:`read`) until commit.
    """

    applies_empty: bool = False

    def last_applied(self) -> int: ...

    def apply(self, index: int, payload: bytes) -> Any: ...

    def checkpoint(self, must_include: int) -> Checkpoint: ...

    def recover(self, checkpoint: Checkpoint) -> None: ...

    def close(self) -> None: ...

    def destroy(self) -> None: ...


class MachineProvider(Protocol):
    """Factory for per-group machines (command/spi/MachineProvider.java:9-13)."""

    def bootstrap(self, group: int) -> RaftMachine: ...
