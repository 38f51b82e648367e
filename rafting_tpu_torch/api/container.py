"""RaftContainer: owns the lifecycle of one node and its group handles.

The reference's top-level object (RaftContainer.java:21-153): ``create``
wires the factory products and starts the runtime, ``open_context`` /
``close_context`` manage groups, ``get_stub`` hands out refcounted client
handles, ``destroy`` tears everything down (also registered atexit, the
shutdown-hook analog, RaftContainer.java:51).

Group identity: users name groups with strings (reference context ids);
the container maps names onto engine lanes through a ``GroupRegistry``.
The default registry is a local durable file; when the admin layer is
active the registry is the replicated Administrator state machine instead
(reference: group lifecycle is itself Raft-replicated through the
``@raft`` meta group, command/admin/Administrator.java:30-190).
"""

from __future__ import annotations

import atexit
import json
import os
import threading
from typing import Dict, Optional

import numpy as np

from ..core.types import resolve_device  # the device seam
from .anomaly import (
    NotReadyError, ObsoleteContextError, RaftError, WaitTimeoutError,
)
from .config import RaftConfig
from .factory import RaftFactory
from .stub import RaftStub

ADMIN_GROUP = "@raft"   # lane 0, reserved (reference Administrator.java:32)


class GroupRegistry:
    """Local durable name->(lane, open) map (superseded by the replicated
    Administrator when the admin layer is enabled).  Closed-but-not-
    destroyed groups keep their lane and stay closed across restarts,
    matching the admin layer's SLEEPING semantics."""

    def __init__(self, path: str, n_groups: int):
        self.path = path
        self.n_groups = n_groups
        self._lock = threading.Lock()
        # name -> [lane, open]
        self.groups: Dict[str, list] = {ADMIN_GROUP: [0, True]}
        if os.path.exists(path):
            with open(path) as f:
                self.groups.update(json.load(f))

    def _persist(self):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.groups, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def lookup(self, name: str) -> Optional[int]:
        with self._lock:
            ent = self.groups.get(name)
            return ent[0] if ent else None

    def allocate(self, name: str) -> int:
        with self._lock:
            ent = self.groups.get(name)
            if ent is not None:
                if not ent[1]:
                    ent[1] = True
                    self._persist()
                return ent[0]
            used = {e[0] for e in self.groups.values()}
            for lane in range(self.n_groups):
                if lane not in used:
                    self.groups[name] = [lane, True]
                    self._persist()
                    return lane
            raise RaftError(
                f"no free group lanes (n_groups={self.n_groups})")

    def mark_closed(self, name: str) -> Optional[int]:
        with self._lock:
            ent = self.groups.get(name)
            if ent is None:
                return None
            ent[1] = False
            self._persist()
            return ent[0]

    def release(self, name: str) -> Optional[int]:
        with self._lock:
            ent = self.groups.pop(name, None)
            if ent is not None:
                self._persist()
            return ent[0] if ent else None

    def open_lanes(self) -> np.ndarray:
        with self._lock:
            mask = np.zeros(self.n_groups, bool)
            for lane, is_open in self.groups.values():
                if is_open:
                    mask[lane] = True
            return mask


class RaftContainer:
    def __init__(self, config: RaftConfig,
                 factory: Optional[RaftFactory] = None,
                 admin: bool = True, device=None):
        """``admin=True`` (default) routes group lifecycle through the
        replicated Administrator meta group on lane 0 — every node converges
        on the same live-group set (reference Administrator.java:30-190).
        ``admin=False`` uses a local durable registry instead (each node
        manages its own lanes; useful for tests and single-node setups)."""
        # ``device``: where the node's engine runs, resolved once here:
        # the CUDA device by default, raising without one (``"cpu"`` runs
        # the plain version): nothing leaves the device asked for.
        self.device = resolve_device(device)
        self.config = config
        self.factory = factory or RaftFactory()
        self.admin_mode = admin
        self._node = None
        self._admin_provider = None
        self._stubs: Dict[str, tuple] = {}   # name -> (stub, refcount)
        self._stub_lock = threading.Lock()
        self._destroyed = False
        self.registry = None if admin else GroupRegistry(
            os.path.join(config.data_dir, "groups.json"), config.n_groups)

    # -- lifecycle -----------------------------------------------------------

    def create(self, start_loop: bool = True) -> "RaftContainer":
        """Wire factory products and start the runtime (reference
        RaftContainer.create:41-58).  With ``start_loop=False`` the caller
        drives ``tick()`` manually (tests)."""
        os.makedirs(self.config.data_dir, exist_ok=True)
        if self.admin_mode:
            from ..admin.administrator import AdminProvider, LifecycleBus
            bus = LifecycleBus()
            self._admin_provider = AdminProvider(
                self.factory.machine_provider(self.config,
                                              self.config.node_id),
                os.path.join(self.config.data_dir, "admin"),
                self.config.n_groups, bus)
            initial = np.zeros(self.config.n_groups, bool)
            initial[0] = True    # the meta group is always live
            self._node = self.factory.build_node(
                self.config, initial_active=initial,
                provider_override=self._admin_provider,
                device=self.device)
            # Effects recovered before the node existed flush now; later
            # applies call through directly.
            bus.bind(self._on_lifecycle)
        else:
            # Re-open every group known at last shutdown (the local-registry
            # analog of Administrator restart re-creation).
            self._node = self.factory.build_node(
                self.config, initial_active=self.registry.open_lanes(),
                device=self.device)
        if start_loop:
            self._node.start(self.config.tick_interval)
        else:
            self._node.transport.start()
        atexit.register(self.destroy)
        return self

    def _on_lifecycle(self, name: str, lane: int, status: str,
                      gen: int = 0) -> None:
        from ..admin.administrator import DESTROYED, NORMAL
        if status == NORMAL:
            # gen mismatch purges a dead incarnation before activating.
            self._node.activate_lane(lane, gen)
        else:
            self._node.set_active(lane, False, purge=(status == DESTROYED))
        if status == DESTROYED:
            # A destroyed name's cached stubs must never route again; the
            # lane may be re-allocated to a different group.
            with self._stub_lock:
                self._stubs.pop(name, None)

    @property
    def node(self):
        return self._node

    def destroy(self) -> None:
        """Graceful teardown (reference RaftContainer.destroy:113-152)."""
        if self._destroyed:
            return
        self._destroyed = True
        atexit.unregister(self.destroy)
        if self._node is not None:
            self._node.close()

    # -- group lifecycle -----------------------------------------------------

    def open_context(self, name: str, timeout: float = 30.0) -> int:
        """Open (or re-open) a named group; returns its lane (reference
        RaftContainer.openContext:65-74).

        Admin mode: the open is a replicated transaction on the meta group
        (reference Administrator.open, command/admin/Administrator.java:
        90-104) — it commits once cluster-wide, every node's Administrator
        applies it, and the lane activates everywhere.  Any node may call
        this; a follower simply waits to observe the committed status (or
        wins the race to submit when it holds meta-leadership)."""
        self._check_alive()
        if name == ADMIN_GROUP:
            return 0
        if not self.admin_mode:
            lane = self.registry.allocate(name)
            self._node.set_active(lane, True)
            return lane
        from ..admin.administrator import NORMAL, build_open_tx
        lane = self._lifecycle_tx(
            name, timeout,
            lambda adm, tx: build_open_tx(adm, name, self.config.n_groups,
                                          tx),
            lambda st: st == NORMAL,
            f"open of group {name!r}")
        # The committed open queues lane activation for the next tick; wait
        # for it so an immediate get_stub().submit() can't race a lane
        # that is still inert.
        import time as _time
        deadline = _time.monotonic() + max(1.0, timeout / 2)
        while not self._node.is_active(lane) and _time.monotonic() < deadline:
            _time.sleep(self.config.tick_interval / 2)
        return lane

    def close_context(self, name: str, destroy_group: bool = False,
                      timeout: float = 30.0) -> None:
        """Close a named group: its lane goes inert but durable state
        remains for re-open; ``destroy_group`` frees the lane permanently
        (reference exitContext/destroyContext,
        context/ContextManager.java:126-167)."""
        self._check_alive()
        if name == ADMIN_GROUP:
            raise RaftError("cannot close the admin group")
        if not self.admin_mode:
            lane = self.registry.lookup(name)
            if lane is None:
                raise ObsoleteContextError(f"unknown group {name!r}")
            if destroy_group:
                self.registry.release(name)
                self._node.set_active(lane, False, purge=True)
            else:
                self.registry.mark_closed(name)
                self._node.set_active(lane, False)
            return
        from ..admin.administrator import (
            DESTROYED, NOT_FOUND, SLEEPING, build_close_tx,
        )
        status, _ = self._admin_provider.admin.status_of(name)
        if status == NOT_FOUND:
            # Fail fast — retrying can't make an unknown group closeable.
            raise ObsoleteContextError(f"unknown group {name!r}")
        want = DESTROYED if destroy_group else SLEEPING
        self._lifecycle_tx(
            name, timeout,
            lambda adm, tx: build_close_tx(adm, name, tx,
                                           destroy=destroy_group),
            lambda st: st == want or st == DESTROYED,
            f"close of group {name!r}")

    def _admin_submit(self, payload: dict, timeout: float):
        """Submit a command to the meta group from ANY node: locally when we
        hold meta-leadership, else relayed to the leader over the transport
        forward channel (the cluster-internal resolution of the reference's
        NotLeader redirect)."""
        data = json.dumps(payload).encode()
        if self._node.is_leader(0):
            return self._node.submit(0, data).result(timeout=timeout)
        hint = self._node.leader_hint(0)
        if hint is None:
            raise NotReadyError("meta group has no known leader yet")
        ok, res = self._node.transport.forward_submit(hint, 0, data,
                                                      timeout=timeout)
        if not ok:
            raise RaftError(f"forwarded admin command failed: "
                            f"{res.decode(errors='replace')}")
        return json.loads(res)

    def _lifecycle_tx(self, name: str, timeout: float, build, reached,
                      what: str) -> int:
        """Drive one lifecycle change through the meta group.  Conflicts
        (version mismatch) retry — the ``admin_seq`` guard serializes
        concurrent lifecycle ops (reference OptimisticTx retry,
        command/admin/Administrator.java:90-115)."""
        import time as _time
        adm = self._admin_provider.admin
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            status, lane = adm.status_of(name)
            if reached(status):
                return lane
            step_timeout = max(0.1, min(5.0, deadline - _time.monotonic()))
            # Probe the builder BEFORE spending a replicated next_tx: if
            # there is nothing to do locally (state not yet replicated to
            # this node), just wait — don't spam the meta log.  Permanent
            # errors (e.g. no free lanes) surface immediately.
            if build(adm, 0) is None:
                _time.sleep(self.config.tick_interval)
                continue
            try:
                tx = self._admin_submit({"op": "next_tx"}, step_timeout)
                cmd = build(adm, tx)
                if cmd is None:   # resolved while we allocated the tx
                    continue
                res = self._admin_submit(cmd, step_timeout)
                if isinstance(res, dict) and not res.get("ok", True):
                    # Optimistic conflict: back off a tick, then rebuild.
                    _time.sleep(self.config.tick_interval)
            except Exception:
                _time.sleep(self.config.tick_interval)
        raise WaitTimeoutError(f"{what} did not commit in {timeout}s")

    # -- stubs ---------------------------------------------------------------

    def _lookup(self, name: str) -> Optional[int]:
        if name == ADMIN_GROUP:
            return 0
        if self.admin_mode:
            from ..admin.administrator import NORMAL
            status, lane = self._admin_provider.admin.status_of(name)
            return lane if status == NORMAL else None
        return self.registry.lookup(name)

    def get_stub(self, name: str) -> RaftStub:
        """Refcounted client handle (reference getStub:92-111)."""
        self._check_alive()
        with self._stub_lock:
            ent = self._stubs.get(name)
            if ent is not None:
                stub, rc = ent
                self._stubs[name] = (stub, rc + 1)
                return stub
            lane = self._lookup(name)
            if lane is None:
                raise ObsoleteContextError(
                    f"group {name!r} not open (open_context first)")
            stub = RaftStub(self, name, lane)
            self._stubs[name] = (stub, 1)
            return stub

    def _release_stub(self, name: str) -> int:
        """Decrement and return the remaining refcount."""
        with self._stub_lock:
            ent = self._stubs.get(name)
            if ent is None:
                return 0
            stub, rc = ent
            if rc <= 1:
                del self._stubs[name]
                return 0
            self._stubs[name] = (stub, rc - 1)
            return rc - 1

    def _check_alive(self):
        if self._destroyed or self._node is None:
            raise RaftError("container not created or already destroyed")
