"""Administrator: the Multi-Raft control plane as a replicated state machine.

The reference's key design move (command/admin/Administrator.java:30-190):
group open/close/destroy are themselves Raft commands on a reserved meta
group (``"@raft"``, lane 0 here), so every node converges on the same set
of live groups — the control plane rides the same consensus it controls.

Commands (JSON payloads; reference domain/Echo|NextTx|OptimisticTx):

* ``{"op": "echo", "v": ...}``            — liveness probe, returns v
* ``{"op": "next_tx"}``                   — allocate a transaction id
* ``{"op": "tx", "tx": id, "mods": {...}}`` — optimistic commit; returns
  {"ok": bool}.  Lifecycle effects fire on ``ctx:<name>`` keys.

KV schema: ``ctx:<name>`` -> {"status": "NORMAL"|"SLEEPING"|"DESTROYED",
"lane": int}.  Every lifecycle transaction also touches ``admin_seq`` so
concurrent open/close attempts serialize through version conflicts.

Lane effects (node.set_active) are invoked on apply — identically on every
replica — and at recovery every NORMAL group re-opens (reference restart
re-creation, Administrator.java:50-57).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..machine.spi import Checkpoint
from .kv import KVEngine, STM

# Group status lattice (reference domain/CtxStatus.java:4-20).
NOT_FOUND, NORMAL, SLEEPING, DESTROYED = \
    "NOT_FOUND", "NORMAL", "SLEEPING", "DESTROYED"


class LifecycleBus:
    """Late-bound sink for lane open/close effects: the Administrator is
    constructed before the node exists, so effects queue until a handler
    binds, then flush in order.  Events carry the lane INCARNATION (``gen``)
    — bumped every time a lane is allocated to a new group — so a node that
    missed a destroy (e.g. it caught up via a meta-group snapshot) can
    detect that its local lane state belongs to a dead incarnation and
    purge before activating."""

    def __init__(self):
        self._handler: Optional[Callable[[str, int, str, int], None]] = None
        self._pending: List[Tuple[str, int, str, int]] = []

    def bind(self, handler: Callable[[str, int, str, int], None]) -> None:
        self._handler = handler
        pending, self._pending = self._pending, []
        for ev in pending:
            handler(*ev)

    def emit(self, name: str, lane: int, status: str, gen: int = 0) -> None:
        if self._handler is None:
            self._pending.append((name, lane, status, gen))
        else:
            self._handler(name, lane, status, gen)


class Administrator:
    """RaftMachine for the admin lane (machine/spi.py contract)."""

    applies_empty = True   # election no-ops advance last_applied, no effects

    def __init__(self, path: str, n_groups: int, bus: LifecycleBus):
        self.path = path       # checkpoint file directory
        self.n_groups = n_groups
        self.bus = bus
        self.engine = KVEngine()
        self._last_applied = 0
        os.makedirs(path, exist_ok=True)
        ckpt = self._ckpt_file()
        if os.path.exists(ckpt):
            self.recover(Checkpoint(path=ckpt, index=self._ckpt_index(ckpt)))

    # -- machine SPI ---------------------------------------------------------

    def last_applied(self) -> int:
        return self._last_applied

    def apply(self, index: int, payload: bytes) -> Any:
        assert index == self._last_applied + 1, \
            f"admin apply out of order: {index} after {self._last_applied}"
        if not payload:
            # Election-win no-op (machine/spi.py: empty commands are
            # harmless by contract).
            self._last_applied = index
            return None
        cmd = json.loads(payload)
        op = cmd["op"]
        result: Any
        if op == "echo":
            result = cmd.get("v")
        elif op == "next_tx":
            result = self.engine.next_tx()
        elif op == "tx":
            mods = {k: (int(ver), val) for k, (ver, val)
                    in cmd["mods"].items()}
            ok = self.engine.commit_tx(int(cmd["tx"]), mods)
            if ok:
                self._fire_effects(mods)
            result = {"ok": ok}
        else:
            raise ValueError(f"unknown admin op {op!r}")
        self._last_applied = index
        return result

    def checkpoint(self, must_include: int) -> Checkpoint:
        assert self._last_applied >= must_include
        path = os.path.join(self.path, f"admin_{self._last_applied}.ckpt")
        self.engine.dump(path)
        return Checkpoint(path=path, index=self._last_applied)

    def recover(self, checkpoint: Checkpoint) -> None:
        self.engine.load(checkpoint.path)
        self._last_applied = checkpoint.index
        # Reconcile EVERY lane with the recovered table, not just NORMAL
        # groups (reference restart re-creation, Administrator.java:50-57,
        # extended to closures a lagging replica may have skipped over a
        # meta snapshot).  Per lane the living context wins:
        # NORMAL > SLEEPING > DESTROYED.
        rank = {NORMAL: 2, SLEEPING: 1, DESTROYED: 0}
        by_lane: Dict[int, Tuple[str, str, int]] = {}
        for name, lane, status in self.contexts():
            if lane is None:
                continue
            cur = by_lane.get(lane)
            if cur is None or rank[status] > rank[cur[1]]:
                by_lane[lane] = (name, status, self._ctx_gen(name))
        for lane, (name, status, gen) in sorted(by_lane.items()):
            self.bus.emit(name, lane, status, gen)

    def _ctx_gen(self, name: str) -> int:
        ent = self.engine.get(f"ctx:{name}")
        return ent[0].get("gen", 0) if ent is not None else 0

    def close(self) -> None:
        pass

    def destroy(self) -> None:
        for f in os.listdir(self.path):
            if f.endswith(".ckpt"):
                os.unlink(os.path.join(self.path, f))

    # -- views ---------------------------------------------------------------

    def status_of(self, name: str) -> Tuple[str, Optional[int]]:
        ent = self.engine.get(f"ctx:{name}")
        if ent is None:
            return NOT_FOUND, None
        return ent[0]["status"], ent[0].get("lane")

    def contexts(self) -> List[Tuple[str, int, str]]:
        out = []
        for key, (val, _) in self.engine.data.items():
            if key.startswith("ctx:"):
                out.append((key[4:], val.get("lane"), val["status"]))
        return out

    def used_lanes(self) -> set:
        return {lane for _, lane, status in self.contexts()
                if status != DESTROYED and lane is not None}

    # -- internals -----------------------------------------------------------

    def _fire_effects(self, mods: Dict[str, Tuple[int, Any]]) -> None:
        for key, (_, val) in mods.items():
            if key.startswith("ctx:") and val is not None:
                self.bus.emit(key[4:], val.get("lane"), val["status"],
                              val.get("gen", 0))

    def _ckpt_file(self) -> str:
        files = sorted(
            (f for f in os.listdir(self.path) if f.endswith(".ckpt")),
            key=lambda f: int(f.split("_")[1].split(".")[0]))
        return os.path.join(self.path, files[-1]) if files else \
            os.path.join(self.path, "admin_0.ckpt.none")

    @staticmethod
    def _ckpt_index(path: str) -> int:
        return int(os.path.basename(path).split("_")[1].split(".")[0])


# -------------------------------------------------------- client-side txs --

def build_open_tx(admin: Administrator, name: str, n_groups: int,
                  tx_id: int) -> Optional[dict]:
    """Build an OptimisticTx opening (or waking) a group.  Returns None if
    the group is already NORMAL (nothing to do).  Lane allocation reads the
    current context table; the ``admin_seq`` guard serializes concurrent
    allocations (conflict -> caller retries)."""
    stm = STM(admin.engine)
    seq = stm.get("admin_seq") or 0
    ent = stm.get(f"ctx:{name}")
    if ent is not None and ent["status"] == NORMAL:
        return None
    if ent is not None and ent["status"] != DESTROYED:
        # SLEEPING -> wake on the same lane, SAME incarnation (its durable
        # state belongs to this group and must survive the nap).
        lane, gen = ent["lane"], ent.get("gen", 0)
    else:
        used = admin.used_lanes()
        lane = next((l for l in range(1, n_groups) if l not in used), None)
        if lane is None:
            from ..api.anomaly import RaftError
            raise RaftError(f"no free group lanes (n_groups={n_groups})")
        # Fresh allocation: bump the lane's incarnation so every node
        # purges any leftover state from a prior (destroyed) tenant.
        gen = (stm.get(f"lane_gen:{lane}") or 0) + 1
        stm.put(f"lane_gen:{lane}", gen)
    stm.put("admin_seq", seq + 1)
    stm.put(f"ctx:{name}", {"status": NORMAL, "lane": lane, "gen": gen})
    return {"op": "tx", "tx": tx_id, "mods": stm.mods()}


def build_close_tx(admin: Administrator, name: str, tx_id: int,
                   destroy: bool = False) -> Optional[dict]:
    """Close (SLEEPING) or destroy a group (reference exitContext /
    destroyContext, context/ContextManager.java:126-167)."""
    stm = STM(admin.engine)
    seq = stm.get("admin_seq") or 0
    ent = stm.get(f"ctx:{name}")
    if ent is None or ent["status"] in (DESTROYED,):
        return None
    if not destroy and ent["status"] == SLEEPING:
        return None
    stm.put("admin_seq", seq + 1)
    stm.put(f"ctx:{name}", {"status": DESTROYED if destroy else SLEEPING,
                            "lane": ent["lane"],
                            "gen": ent.get("gen", 0)})
    return {"op": "tx", "tx": tx_id, "mods": stm.mods()}


class AdminProvider:
    """MachineProvider wrapper: lane 0 gets the Administrator, everything
    else delegates to the user's provider (reference AdminBootstrap,
    command/admin/AdminBootstrap.java:25-34)."""

    def __init__(self, inner, admin_path: str, n_groups: int,
                 bus: LifecycleBus):
        self.inner = inner
        self.bus = bus
        self._admin = Administrator(admin_path, n_groups, bus)

    @property
    def admin(self) -> Administrator:
        return self._admin

    def bootstrap(self, group: int):
        if group == 0:
            return self._admin
        return self.inner.bootstrap(group)
