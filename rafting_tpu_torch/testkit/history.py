"""Client-history recording for linearizability checking (Jepsen's
invoke/ok/fail/info model).

A :class:`History` is a concurrent, append-only event log of client
operations as the CLIENTS saw them — the raw material testkit/linz.py
checks.  Each operation is an ``invoke`` event paired (maybe) with a
completion:

* ``ok``   — the operation returned a result; it MUST linearize.
* ``fail`` — the operation provably did NOT happen (a MARKED pre-log
  refusal, api/anomaly.py: the node guarantees the command never
  entered any log); the checker excludes it.
* ``info`` — outcome UNKNOWN: timeouts, crash windows, unmarked errors
  (an accept-then-abort ``NotLeaderError``, a bare ``StorageFaultError``
  after acceptance).  The operation MAY have taken effect at any point
  after its invocation — even after the "end" of the history — so the
  checker treats it as forever-concurrent: free to linearize anywhere
  after invoke, or never.

The classification rule is the repo's refusal-marking protocol
(api/anomaly.py as_refusal/is_refusal): marked = provably-not-executed =
``fail``; everything else that isn't a result is ``info``.  Getting this
wrong in the conservative direction (unknown recorded as ``fail``) makes
the checker UNSOUND — a retry of a command whose first attempt actually
committed then looks like a duplicate apply out of nowhere.
tests/test_linz.py pins both directions.

:class:`StubRecorder` is the RaftStub hook (``stub.attach_history``):
it wraps blocking ``execute``/``execute_read`` calls, parses the KV
command vocabulary (machine/kv_machine.py JSON ops) into typed ops, and
applies the classification rule.  When no recorder is attached the stub
pays exactly one is-None test (tests/test_hotpath_lint.py).
"""

from __future__ import annotations

import copy
import json
import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..api.anomaly import is_refusal

__all__ = ["Op", "History", "StubRecorder"]

# Op kinds: "w" register write (KV set), "a" list append (KV add),
# "r" read (KV get), "t" cross-group transaction (runtime/txn.py — a
# multi-key op the per-key Wing & Gong checker must NOT judge; linz.py
# refuses "t" ops and routes callers to the transfer invariant,
# testkit/invariants.py check_transfer_atomicity).
_KINDS = ("w", "a", "r", "t")


@dataclass
class Op:
    """One paired client operation (the checker's unit of work)."""
    id: int
    proc: str
    kind: str            # "w" | "a" | "r"
    key: str
    value: Any = None    # written value (w/a); None for reads
    status: str = "info"  # "ok" | "fail" | "info"
    result: Any = None   # returned value (ok reads)
    error: str = ""      # exception type name (fail/info)
    invoke_seq: int = 0  # global total order of invocations/completions
    resp_seq: float = math.inf   # inf = never completed (info forever)

    def describe(self) -> str:
        what = {"w": f"w {self.key}={self.value!r}",
                "a": f"a {self.key}+={self.value!r}",
                "r": f"r {self.key}",
                "t": f"t {self.key} {self.value!r}"}[self.kind]
        end = (f"{self.status}@{int(self.resp_seq)}"
               if math.isfinite(self.resp_seq) else f"{self.status}@∞")
        got = f" -> {self.result!r}" if self.status == "ok" else \
              (f" ({self.error})" if self.error else "")
        return (f"op {self.id:<4} [{self.proc}] {what:<24} "
                f"invoke@{self.invoke_seq:<5} {end}{got}")


class History:
    """Thread-safe invoke/ok/fail/info event log.

    Events carry a single global sequence number, so the real-time
    precedence relation the checker needs (op A completed before op B
    was invoked) is exact regardless of which client thread recorded
    what."""

    def __init__(self):
        self._lock = threading.Lock()
        self._seq = 0
        self.events: List[dict] = []
        self._next_id = 0

    def _stamp(self, ev: dict) -> dict:
        with self._lock:
            ev["seq"] = self._seq
            self._seq += 1
            self.events.append(ev)
        return ev

    # -- recording -----------------------------------------------------------

    def invoke(self, proc: str, kind: str, key: str,
               value: Any = None) -> int:
        assert kind in _KINDS, kind
        with self._lock:
            op_id = self._next_id
            self._next_id += 1
        self._stamp({"e": "invoke", "id": op_id, "proc": proc,
                     "kind": kind, "key": key, "v": value})
        return op_id

    def ok(self, op_id: int, result: Any = None) -> None:
        # Deep-copy: a local read may return a LIVE machine object (the
        # KV machine hands out its actual list); recording a reference
        # would let later appends rewrite what this read "saw".
        self._stamp({"e": "ok", "id": op_id,
                     "result": copy.deepcopy(result)})

    def fail(self, op_id: int, error: str = "") -> None:
        """The operation provably never happened (marked refusal ONLY)."""
        self._stamp({"e": "fail", "id": op_id, "error": error})

    def info(self, op_id: int, error: str = "") -> None:
        """Outcome unknown: may have happened, now or later."""
        self._stamp({"e": "info", "id": op_id, "error": error})

    # -- views ---------------------------------------------------------------

    def ops(self) -> List[Op]:
        """Pair events into Ops.  Invokes with no completion (a client
        thread that died in a crash window) are info-forever."""
        with self._lock:
            events = list(self.events)
        out: Dict[int, Op] = {}
        for ev in events:
            if ev["e"] == "invoke":
                out[ev["id"]] = Op(id=ev["id"], proc=ev["proc"],
                                   kind=ev["kind"], key=ev["key"],
                                   value=ev["v"], invoke_seq=ev["seq"])
            else:
                op = out[ev["id"]]
                op.status = ev["e"]
                op.resp_seq = ev["seq"]
                op.result = ev.get("result")
                op.error = ev.get("error", "")
        for op in out.values():
            if op.status == "info" and op.resp_seq != math.inf:
                # Explicit info: completion time is known but meaningless
                # for ordering — the op may take effect later than it.
                op.resp_seq = math.inf
            elif op.status not in ("ok", "fail"):
                op.status = "info"   # unpaired invoke
        return [out[k] for k in sorted(out)]

    def by_key(self) -> Dict[str, List[Op]]:
        keys: Dict[str, List[Op]] = {}
        for op in self.ops():
            keys.setdefault(op.key, []).append(op)
        return keys

    def counts(self) -> Dict[str, int]:
        c = {"ok": 0, "fail": 0, "info": 0}
        for op in self.ops():
            c[op.status] += 1
        return c

    def to_json(self) -> list:
        """JSON-shaped event list (chaos artifacts embed it verbatim)."""
        with self._lock:
            return [dict(ev) for ev in self.events]


class StubRecorder:
    """The RaftStub history hook: one instance per client process
    identity, installed with ``stub.attach_history(history, proc)``.

    Wraps the blocking paths only (``execute`` / ``execute_read``) —
    they are where a client learns an outcome, which is what a history
    is made of.  Classification (the load-bearing part):

    * return value            -> ``ok``
    * MARKED refusal          -> ``fail``  (provably pre-log: NotLeader
      hint bounce, NotReady, admission shed, quarantined stripe — the
      node promises the command never entered any log)
    * anything else           -> ``info``  (WaitTimeout: still in
      flight; unmarked NotLeader: accept-then-abort, may still commit
      under the new leader; unmarked StorageFault: accepted entries on
      a faulted stripe; transport RaftError: the forward channel died
      mid-call).  A retry the caller issues after ``info`` can
      therefore double-apply — by design the HISTORY stays sound:
      either zero or one effect per recorded op, duplicates show up as
      two ops of which one was info (legal) or as a non-linearizable
      read (caught), never as silent acceptance.
    """

    def __init__(self, history: History, proc: str):
        self.history = history
        self.proc = proc

    @staticmethod
    def _parse(command) -> tuple:
        """Map the KV JSON vocabulary to (kind, key, value); unknown
        commands become whole-machine register writes so arbitrary
        traffic still yields a checkable (if coarse) history."""
        try:
            raw = command.decode() if isinstance(command, bytes) else command
            cmd = json.loads(raw)
            op = cmd.get("op")
            if op == "set":
                return "w", str(cmd.get("k")), cmd.get("v")
            if op == "add":
                return "a", str(cmd.get("k")), cmd.get("v")
            if op == "get":
                return "r", str(cmd.get("k")), None
        except (ValueError, AttributeError, TypeError):
            pass
        return "w", "__cmd__", str(command)

    def _classify(self, op_id: int, exc: BaseException) -> None:
        if is_refusal(exc):
            self.history.fail(op_id, type(exc).__name__)
        else:
            self.history.info(op_id, type(exc).__name__)

    def execute(self, stub, command, timeout: Optional[float]) -> Any:
        kind, key, value = self._parse(command)
        op_id = self.history.invoke(self.proc, kind, key, value)
        try:
            result = stub._execute(command, timeout)
        except BaseException as e:
            self._classify(op_id, e)
            raise
        self.history.ok(op_id, result)
        return result

    def execute_read(self, stub, query, timeout: Optional[float]) -> Any:
        kind, key, _ = self._parse(query)
        op_id = self.history.invoke(self.proc, "r", key)
        try:
            result = stub._execute_read(query, timeout)
        except BaseException as e:
            # Reads never mutate state; fail vs info only affects whether
            # the checker may discard them — it discards both, so the
            # same refusal-marking rule keeps the bookkeeping honest.
            self._classify(op_id, e)
            raise
        self.history.ok(op_id, result)
        return result
