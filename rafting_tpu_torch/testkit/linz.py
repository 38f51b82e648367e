"""Wing & Gong linearizability checker over recorded client histories.

Checks the one property users actually buy: every completed operation
appears to take effect atomically at some instant between its invocation
and its response.  The algorithm is the classic Wing & Gong search
("Testing and Verifying Concurrent Objects", 1993) with the
memoization refinement popularized by Lowe/Horn ("Faster linearizability
checking via P-compositionality"): depth-first search over the states
``(set of linearized ops, model state)``, pruning re-visited pairs.

Tractability comes from LOCALITY (Herlihy & Wing): a history over a map
is linearizable iff its per-key sub-histories are — so the checker is
compositional per key and the search space is bounded by per-key
concurrency (the number of client threads), not total history length.

Semantics of the op statuses (testkit/history.py):

* ``ok``   ops MUST linearize between invoke and response.
* ``fail`` ops are excluded — the node proved they never happened.
* ``info`` WRITES are forever-concurrent: the search may linearize one
  at any point after its invocation or drop it entirely (the crash
  window / timeout / retry-duplicate ambiguity).  ``info`` reads
  constrain nothing and are excluded.

The model is a per-key register+list hybrid matching the KV machine's
vocabulary (machine/kv_machine.py): ``w`` sets the value, ``a`` appends
to a list, ``r`` must return exactly the current value.  A duplicated
append (client retry whose first attempt committed) is therefore
OBSERVABLE — an ok read returning ``[v, v]`` only verifies if two
appends of ``v`` may linearize, i.e. if the first attempt was recorded
``info``; recording it ``fail`` makes the same history non-linearizable
(tests/test_linz.py pins this).

Counterexamples: on failure the checker shrinks to the shortest
response-prefix of the key's sub-history that is already
non-linearizable and renders it op by op (LinzResult.render) — read it
bottom-up: the last ok op is the one no linearization order can
explain.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .history import History, Op

__all__ = ["LinzResult", "check", "check_ops"]


def _norm(v: Any) -> Any:
    """Hashable canonical form for model states and read results (JSON
    round-trips turn tuples into lists; the model must not care)."""
    if isinstance(v, (list, tuple)):
        return tuple(_norm(x) for x in v)
    return v


def _apply(state: Any, op: Op) -> Tuple[bool, Any]:
    """Step the register+list model: returns (legal, next_state)."""
    if op.kind == "w":
        return True, _norm(op.value)
    if op.kind == "a":
        base = state if isinstance(state, tuple) else ()
        return True, base + (_norm(op.value),)
    # read: legal iff it returned exactly the current value
    return _norm(op.result) == state, state


@dataclass
class LinzResult:
    ok: bool
    key: Optional[str] = None          # failing key (ok=False)
    counterexample: List[Op] = field(default_factory=list)
    checked_keys: int = 0
    n_ops: int = 0
    counts: Dict[str, int] = field(default_factory=dict)

    def render(self) -> str:
        if self.ok:
            return (f"linearizable: {self.n_ops} ops over "
                    f"{self.checked_keys} keys {self.counts}")
        lines = [f"NON-LINEARIZABLE at key {self.key!r} — minimal "
                 f"counterexample ({len(self.counterexample)} ops, "
                 f"in invocation order):"]
        for op in sorted(self.counterexample, key=lambda o: o.invoke_seq):
            lines.append("  " + op.describe())
        lines.append("  (no order of the ok/info ops explains every ok "
                     "read; the latest-responding ok op is the witness)")
        return "\n".join(lines)


def check_ops(ops: List[Op], initial: Any = None) -> bool:
    """Wing & Gong over ONE key's sub-history.  True = linearizable."""
    live = [o for o in ops
            if o.status == "ok" or (o.status == "info"
                                    and o.kind in ("w", "a"))]
    must = frozenset(o.id for o in live if o.status == "ok")
    if not must:
        return True      # nothing observable completed: vacuously fine
    initial = _norm(initial)
    seen = set()
    stack: List[Tuple[frozenset, Any]] = [(frozenset(), initial)]
    while stack:
        done, state = stack.pop()
        key = (done, state)
        if key in seen:
            continue
        seen.add(key)
        if must <= done:
            return True
        pending = [o for o in live if o.id not in done]
        # Minimal ops: nothing still pending responded before their
        # invocation (info ops respond at +inf, so they never bar
        # others but stay optional themselves).
        bar = min(o.resp_seq for o in pending)
        for o in pending:
            if o.invoke_seq < bar:
                legal, nxt = _apply(state, o)
                if legal:
                    stack.append((done | {o.id}, nxt))
    return False


def _clip(ops: List[Op], cutoff: float) -> List[Op]:
    """The history as the world looked at sequence time ``cutoff``:
    ops invoked later don't exist; ops still open at the cutoff have
    unknown outcomes — pending writes downgrade to info, pending reads
    constrain nothing and drop."""
    out = []
    for o in ops:
        if o.invoke_seq >= cutoff:
            continue
        if o.resp_seq >= cutoff and o.status == "ok":
            if o.kind == "r":
                continue
            c = Op(**{**o.__dict__})
            c.status = "info"
            c.resp_seq = math.inf
            out.append(c)
        else:
            out.append(o)
    return out


def _shrink(ops: List[Op], initial: Any = None) -> List[Op]:
    """Shortest failing response-prefix: walk completions in response
    order and return the first prefix that is already non-linearizable
    (minimal in the Jepsen sense — everything after the witness response
    is noise)."""
    resps = sorted(o.resp_seq for o in ops if math.isfinite(o.resp_seq))
    for r in resps:
        sub = _clip(ops, r + 0.5)
        if not check_ops(sub, initial):
            return sub
    return ops


def check(history, initial: Any = None) -> LinzResult:
    """Check a whole history (or a prepared per-key dict / op list),
    compositionally per key.

    SINGLE-KEY OPS ONLY: per-key composition is sound exactly because
    each op touches one key (Herlihy & Wing locality).  A cross-group
    TRANSACTION (op kind ``t``, runtime/txn.py) touches several keys
    atomically — splitting it per key would silently judge each leg as
    an independent single-key op and certify histories where atomicity
    was in fact violated.  Such histories must go to the transfer
    invariant instead (testkit/invariants.py check_transfer_atomicity);
    this guard makes the mis-route loud rather than silently unsound."""
    if isinstance(history, History):
        keys = history.by_key()
    elif isinstance(history, dict):
        keys = history
    else:
        keys = {}
        for op in history:
            keys.setdefault(op.key, []).append(op)
    for ops in keys.values():
        for o in ops:
            if o.kind not in ("w", "a", "r"):
                raise ValueError(
                    f"linz.check got a multi-key op (kind {o.kind!r}, "
                    f"op id {o.id}): per-key composition is unsound for "
                    f"transactions — route txn histories to "
                    f"testkit.invariants.check_transfer_atomicity")
    n_ops = sum(len(v) for v in keys.values())
    counts: Dict[str, int] = {"ok": 0, "fail": 0, "info": 0}
    for ops in keys.values():
        for o in ops:
            counts[o.status] = counts.get(o.status, 0) + 1
    for key, ops in sorted(keys.items()):
        if not check_ops(ops, initial):
            return LinzResult(ok=False, key=key,
                              counterexample=_shrink(ops, initial),
                              checked_keys=len(keys), n_ops=n_ops,
                              counts=counts)
    return LinzResult(ok=True, checked_keys=len(keys), n_ops=n_ops,
                      counts=counts)
