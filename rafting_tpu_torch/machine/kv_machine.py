"""KVMachine: an in-memory key-value state machine with file checkpoints.

The "real application" example machine: commands are simple serialized
ops (set/del), checkpoints dump the dict to a file.  Used by examples and
as the substrate under the admin meta-group's MVCC engine.

Since the transaction plane (runtime/txn.py) this machine is also the
reference 2PC PARTICIPANT and COORDINATOR substrate.  The txn command
vocabulary rides the ordinary replicated log — prepare/commit/abort are
just payloads, so participant durability and ordering come from Raft
itself, not from any side channel:

* participant ops — ``txn_prepare`` buffers a write-intent (the ops are
  NOT applied; their keys are locked under the txn id with a wall-clock
  deadline), ``txn_commit`` replays the buffered ops atomically and
  releases the locks, ``txn_abort`` drops the intent.  All three are
  idempotent, and commit/abort for an unknown txn are safe no-ops (the
  done-ledger records them so the invariant checker can tell a
  duplicate from a phantom).
* coordinator ops — ``txn_begin`` allocates a replicated, monotone txn
  id and records the participant set + deadline; ``txn_decide`` records
  COMMIT or ABORT with FIRST-WRITER-WINS semantics (a later conflicting
  decision returns the winner instead of flipping), which is what makes
  recovery races safe: whoever replicates the decision first — the live
  coordinator driver or a deadline-expiry resolver — wins, and everyone
  else converges on that answer.

Intent visibility: buffered intent ops touch ``self.intents`` only, so
both read paths (``get`` via apply and the :meth:`read` SPI) naturally
serve committed state — an uncommitted transaction is invisible, full
stop.  Plain single-key ops deliberately BYPASS the lock table (they
stay lock-free and last-writer-wins against txn commit order in the
log); transactional and plain traffic should use disjoint keyspaces,
which the transfer workloads do.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional

from .spi import Checkpoint

# Ops a txn intent may buffer (replayed verbatim at commit).
_TXN_OPS = ("set", "del", "add", "incr")


class KVMachine:
    """Commands: JSON bytes {"op": "set"|"del"|"add"|"incr", "k": str, "v": any}
    plus the txn vocabulary in the module docstring.

    ``add`` appends to a list value — the chaos workload's observable-
    duplicate op: a client retry that double-applies shows up as two
    list elements, which the linearizability checker can then judge
    (testkit/linz.py).  ``incr`` adds a number to a counter (missing
    key counts as 0) — the bank-transfer workload's balance op.

    ``stale_reads=True`` is a TEST-ONLY defect knob: linearizable reads
    return each key's PREVIOUS value — the classic stale-read bug a
    correct ReadIndex/lease plane exists to prevent.  It proves the
    checker has teeth (tests/test_chaos.py drives it through the real
    read plane and demands a counterexample)."""

    applies_empty = True   # election no-ops advance last_applied, no-op op

    def __init__(self, path: str, stale_reads: bool = False,
                 group: int = -1):
        self.path = path
        self.stale_reads = stale_reads
        self.group = group
        self._prev: Dict[str, Any] = {}   # per-key previous value
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.data: Dict[str, Any] = {}
        # -- txn participant state (all checkpointed) --------------------
        self.intents: Dict[str, dict] = {}   # tid -> {ops, deadline, coord}
        self.locks: Dict[str, str] = {}      # key -> holding tid
        self.txn_done: Dict[str, str] = {}   # tid -> final disposition
        # -- txn coordinator state (this group AS the coordinator) -------
        self.txns: Dict[str, dict] = {}      # tid -> {parts, deadline, decision}
        self.txn_seq = 0                     # replicated monotone id counter
        self._last_applied = 0
        if os.path.exists(path):
            with open(path) as f:
                dump = json.load(f)
            self._load(dump)

    def _load(self, dump: dict) -> None:
        self.data = dump["data"]
        self._last_applied = dump["index"]
        # Pre-txn checkpoints lack these keys (backward compatible).
        self.intents = dump.get("intents", {})
        self.locks = dump.get("locks", {})
        self.txn_done = dump.get("txn_done", {})
        self.txns = dump.get("txns", {})
        self.txn_seq = dump.get("txn_seq", 0)

    def last_applied(self) -> int:
        return self._last_applied

    # -- plain op application (shared by direct apply and commit replay) --

    def _apply_op(self, cmd: dict) -> Any:
        op = cmd.get("op")
        if op == "set":
            self._prev[cmd["k"]] = self.data.get(cmd["k"])
            self.data[cmd["k"]] = cmd["v"]
            return cmd["v"]
        if op == "add":
            cur = self.data.get(cmd["k"])
            self._prev[cmd["k"]] = list(cur) if cur is not None else None
            lst = self.data.setdefault(cmd["k"], [])
            lst.append(cmd["v"])
            return len(lst)
        if op == "incr":
            cur = self.data.get(cmd["k"], 0)
            self._prev[cmd["k"]] = self.data.get(cmd["k"])
            self.data[cmd["k"]] = cur + cmd["v"]
            return self.data[cmd["k"]]
        if op == "del":
            self._prev[cmd["k"]] = self.data.get(cmd["k"])
            return self.data.pop(cmd["k"], None)
        if op == "get":
            return self.data.get(cmd["k"])
        return None

    def apply(self, index: int, payload: bytes) -> Any:
        assert index == self._last_applied + 1
        if not payload:
            # Election-win no-op (machine/spi.py: empty commands are
            # harmless by contract).
            self._last_applied = index
            return None
        cmd = json.loads(payload)
        op = cmd.get("op")
        if op in ("txn_prepare", "txn_commit", "txn_abort",
                  "txn_begin", "txn_decide"):
            result = self._apply_txn(op, cmd)
        else:
            result = self._apply_op(cmd)
        self._last_applied = index
        return result

    # -- 2PC vocabulary ----------------------------------------------------

    def _apply_txn(self, op: str, cmd: dict) -> Any:
        if op == "txn_prepare":
            return self._txn_prepare(cmd)
        if op == "txn_commit":
            return self._txn_finalize(cmd["txn"], "commit")
        if op == "txn_abort":
            return self._txn_finalize(cmd["txn"], "abort")
        if op == "txn_begin":
            return self._txn_begin(cmd)
        return self._txn_decide(cmd)

    def _txn_prepare(self, cmd: dict) -> dict:
        tid = cmd["txn"]
        done = self.txn_done.get(tid)
        if done is not None:
            # Already finalized here (a resolver beat a slow prepare, or
            # a retried prepare landed after commit).  Never re-lock.
            return {"prepared": False, "decision": done}
        if tid in self.intents:
            return {"prepared": True, "dup": True}
        ops = cmd.get("ops") or []
        for o in ops:
            if o.get("op") not in _TXN_OPS:
                return {"prepared": False,
                        "error": f"bad txn op {o.get('op')!r}"}
        for o in ops:
            holder = self.locks.get(o["k"])
            if holder is not None and holder != tid:
                # Immediate-conflict abort (no waiting => no deadlock).
                # Even a past-deadline holder is NOT stolen here: only a
                # replicated txn_abort may release it, so the resolver's
                # coordinator query stays the single source of truth.
                return {"prepared": False, "conflict": o["k"],
                        "holder": holder}
        self.intents[tid] = {"ops": ops,
                             "deadline": float(cmd.get("deadline", 0.0)),
                             "coord": int(cmd.get("coord", -1))}
        for o in ops:
            self.locks[o["k"]] = tid
        return {"prepared": True}

    def _txn_finalize(self, tid: str, decision: str) -> dict:
        prior = self.txn_done.get(tid)
        if prior is not None:
            # Idempotent; a conflicting retry reports the winner (never
            # flips — the coordinator's first-writer-wins decision is
            # what both callers replayed from).
            return {"done": prior, "applied": False,
                    "flip": prior != decision and not prior.startswith(decision)}
        intent = self.intents.pop(tid, None)
        if intent is not None:
            for o in intent["ops"]:
                if self.locks.get(o["k"]) == tid:
                    del self.locks[o["k"]]
            if decision == "commit":
                for o in intent["ops"]:
                    self._apply_op(o)
            self.txn_done[tid] = decision
            return {"done": decision, "applied": decision == "commit"}
        # No intent: a commit here would mean effects were LOST (the
        # prepare never replicated before the decision) — record it
        # distinctly so testkit/invariants.py can flag phantoms; aborts
        # without intents are the normal presumed-abort path.
        self.txn_done[tid] = "commit-noop" if decision == "commit" else "abort"
        return {"done": self.txn_done[tid], "applied": False}

    def _txn_begin(self, cmd: dict) -> dict:
        seq = self.txn_seq
        self.txn_seq += 1
        tid = f"x{self.group}.{seq}"
        self.txns[tid] = {"parts": list(cmd.get("parts") or []),
                          "deadline": float(cmd.get("deadline", 0.0)),
                          "decision": None}
        return {"txn": tid, "parts": self.txns[tid]["parts"]}

    def _txn_decide(self, cmd: dict) -> dict:
        tid = cmd["txn"]
        decision = cmd["decision"]
        assert decision in ("commit", "abort"), decision
        rec = self.txns.get(tid)
        if rec is None:
            # Decision for a txn this coordinator never began: a resolver
            # racing a begin that never replicated.  Recording it is safe
            # — nobody can have been told "commit" for an unbegun txn.
            rec = self.txns[tid] = {"parts": [], "deadline": 0.0,
                                    "decision": None}
        if rec["decision"] is None:
            rec["decision"] = decision
            return {"txn": tid, "decision": decision, "won": True}
        return {"txn": tid, "decision": rec["decision"], "won": False}

    # -- txn plane accessors (tick thread = machine single-writer) --------

    def expired_intents(self, now: float) -> List[dict]:
        """Intents whose deadline passed: the recovery sweep's input.
        Called on the tick thread, same single-writer as apply."""
        if not self.intents:
            return []
        return [{"txn": tid, "coord": rec["coord"],
                 "deadline": rec["deadline"]}
                for tid, rec in self.intents.items()
                if rec["deadline"] <= now]

    def txn_decision(self, tid: str) -> Optional[str]:
        rec = self.txns.get(tid)
        return rec["decision"] if rec else None

    def read(self, payload: bytes) -> Any:
        """Linearizable query (machine/spi.py read SPI): same JSON command
        vocabulary as apply, restricted to the read-only ops — served off
        the log by the read plane once the apply frontier covers the
        quorum-confirmed ReadIndex."""
        cmd = json.loads(payload)
        op = cmd.get("op")
        if op == "txn_status":
            # In-doubt recovery query against the coordinator group's
            # replicated decision log (runtime/txn.py resolver).
            tid = cmd["txn"]
            rec = self.txns.get(tid)
            return {"txn": tid, "known": rec is not None,
                    "decision": rec["decision"] if rec else None,
                    "parts": rec["parts"] if rec else []}
        if op != "get":
            raise ValueError(f"read supports op=get|txn_status only, "
                             f"got {op!r}")
        if self.stale_reads:
            # Injected defect (see class docstring): serve the previous
            # value, violating linearizability on purpose.
            return self._prev.get(cmd["k"], self.data.get(cmd["k"]))
        return self.data.get(cmd["k"])

    def _dump(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"index": self._last_applied, "data": self.data,
                       "intents": self.intents, "locks": self.locks,
                       "txn_done": self.txn_done, "txns": self.txns,
                       "txn_seq": self.txn_seq}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def checkpoint(self, must_include: int) -> Checkpoint:
        assert self._last_applied >= must_include
        self._prune_ckpts()
        p = f"{self.path}.ckpt.{self._last_applied}"
        self._dump(p)
        return Checkpoint(path=p, index=self._last_applied)

    def _prune_ckpts(self) -> None:
        for p in glob.glob(f"{self.path}.ckpt.*"):
            try:
                os.unlink(p)
            except OSError:
                pass

    def recover(self, checkpoint: Checkpoint) -> None:
        with open(checkpoint.path) as f:
            dump = json.load(f)
        self._load(dump)
        self._dump(self.path)

    def close(self) -> None:
        self._dump(self.path)

    def destroy(self) -> None:
        self._prune_ckpts()
        for p in (self.path, self.path + ".tmp"):
            if os.path.exists(p):
                os.unlink(p)


class KVMachineProvider:
    def __init__(self, root: str, stale_reads: bool = False):
        self.root = root
        self.stale_reads = stale_reads
        os.makedirs(root, exist_ok=True)

    def bootstrap(self, group: int) -> KVMachine:
        return KVMachine(os.path.join(self.root, f"kv_{group}.json"),
                         stale_reads=self.stale_reads, group=group)
