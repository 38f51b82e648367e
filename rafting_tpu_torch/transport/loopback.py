"""In-process loopback transport: N nodes, zero sockets.

The generalization of the reference's loopback test trick (it connects the
EventBus to itself, transport/EventClusterTest.java:81-83): a
``LoopbackNetwork`` wires N transports directly accumulator-to-accumulator,
with per-link drop control for partition/chaos testing.  Same interface as
TcpTransport, so the node runtime is transport-agnostic.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from . import codec


class LoopbackNetwork:
    def __init__(self, n_nodes: int):
        self.n = n_nodes
        self.transports: Dict[int, "LoopbackTransport"] = {}
        self._lock = threading.Lock()
        # conn[s][d] False = link cut
        self.conn = [[True] * n_nodes for _ in range(n_nodes)]
        # dup[s][d] True = every MSGS frame over s->d is delivered twice
        # (nemesis duplicate-delivery regime: the host-path analog of
        # FaultSchedule.dup, exercising stale/duplicate RPC idempotency
        # through the real codec round-trip)
        self.dup = [[False] * n_nodes for _ in range(n_nodes)]
        # Optional shared LinkFaults table (transport/faults.py) — the
        # chaos conductor's richer per-directed-link plane (asymmetric
        # cuts, probabilistic drop/dup/delay/reorder), consulted in
        # ADDITION to the legacy conn/dup matrices above.
        self.faults = None
        # Frames a delay/reorder verdict held back, per directed link:
        # (frame, after) — after=False is a delayed frame (delivered
        # BEFORE the link's next frame: a one-frame time shift, order
        # kept), after=True is a reordered one (delivered AFTER the next
        # frame: the adjacent swap).
        self._held: Dict[Tuple[int, int],
                         List[Tuple[bytes, bool]]] = {}

    def _take_held(self, key) -> Tuple[list, list]:
        with self._lock:
            entries = self._held.pop(key, [])
        pre = [fr for fr, after in entries if not after]
        post = [fr for fr, after in entries if after]
        return pre, post

    def _hold(self, key, frame: bytes, after: bool) -> None:
        with self._lock:
            self._held.setdefault(key, []).append((frame, after))

    def flush_held(self) -> None:
        """Deliver every held-back frame now (heal-time drain so a link
        that goes quiet doesn't strand a delayed frame forever)."""
        with self._lock:
            held, self._held = self._held, {}
        for (src, dst), entries in held.items():
            t = self.transports.get(dst)
            if t is None:
                continue
            for frame, _after in entries:
                t._deliver(frame)

    def set_link(self, src: int, dst: int, up: bool) -> None:
        with self._lock:
            self.conn[src][dst] = up

    def set_conn(self, conn) -> None:
        """Adopt a whole [N, N] connectivity matrix at once — the bulk
        entry point nemesis schedule replay drives per tick
        (testkit/harness.py ``LocalCluster.replay_schedule``)."""
        with self._lock:
            for s in range(self.n):
                for d in range(self.n):
                    self.conn[s][d] = bool(conn[s][d])

    def set_dup(self, dup) -> None:
        """Adopt a whole [N, N] duplicate-delivery matrix."""
        with self._lock:
            for s in range(self.n):
                for d in range(self.n):
                    self.dup[s][d] = bool(dup[s][d])

    def partition(self, sides) -> None:
        with self._lock:
            for s in range(self.n):
                for d in range(self.n):
                    self.conn[s][d] = any(
                        s in side and d in side for side in sides)

    def heal(self) -> None:
        with self._lock:
            for s in range(self.n):
                for d in range(self.n):
                    self.conn[s][d] = True

    def _up(self, s: int, d: int) -> bool:
        with self._lock:
            return self.conn[s][d]

    def _dup(self, s: int, d: int) -> bool:
        with self._lock:
            return self.dup[s][d]


class LoopbackTransport:
    def __init__(self, network: LoopbackNetwork, node_id: int, cfg, template,
                 on_slice: Callable,
                 snapshot_provider: Optional[Callable] = None,
                 submit_handler: Optional[Callable] = None,
                 result_encoder: Optional[Callable] = None,
                 read_handler: Optional[Callable] = None,
                 conf_node=None):
        self.net = network
        self.node_id = node_id
        self.cfg = cfg
        self.template = template
        self.on_slice = on_slice
        self.snapshot_provider = snapshot_provider
        self.submit_handler = submit_handler
        self.result_encoder = result_encoder
        self.read_handler = read_handler
        self.conf_node = conf_node

    def start(self) -> None:
        self.net.transports[self.node_id] = self

    def close(self) -> None:
        self.net.transports.pop(self.node_id, None)

    def send_slice(self, dst: int, packed: bytes) -> None:
        """Deliver a packed MSGS frame to dst (round-trips through the real
        codec so loopback tests exercise the wire format too).  When the
        network carries a LinkFaults table, each frame's fate (cut /
        drop / delay / dup / reorder) is decided per directed link; held
        frames ride out with the link's NEXT frame — before it for a
        delay (order kept, time shifted), after it for a reorder (the
        adjacent swap)."""
        if not self.net._up(self.node_id, dst):
            return
        t = self.net.transports.get(dst)
        if t is None:
            return  # peer down
        key = (self.node_id, dst)
        frames = [packed]
        f = self.net.faults
        if f is not None:
            act = f.plan(self.node_id, dst)
            if act.cut:
                self._mirror("net_faults_cut_total")
                return  # link down: held frames stay held too
            pre, post = self.net._take_held(key)
            if not act.deliver:
                self._mirror("net_faults_dropped_total")
                frames = []
            elif act.delay_s > 0:
                self._mirror("net_faults_delayed_total")
                self.net._hold(key, packed, after=False)
                frames = []
            elif act.reorder:
                self._mirror("net_faults_reordered_total")
                self.net._hold(key, packed, after=True)
                frames = []
            elif act.dup:
                self._mirror("net_faults_duplicated_total")
                frames = [packed, packed]
            frames = pre + frames + post
        # Duplicate-delivery links (nemesis schedule replay) hand the same
        # frame to the receiver twice — the receiving stack must be
        # idempotent against replayed RPCs, exactly like the device
        # plane's FaultSchedule.dup lane.
        rounds = 2 if self.net._dup(self.node_id, dst) else 1
        for frame in frames:
            for _ in range(rounds):
                t._deliver(frame)

    def _deliver(self, packed: bytes) -> None:
        """Receiver half: unpack a frame and merge it into our inbox."""
        for ftype, body in codec.FrameReader().feed(packed):
            if ftype == codec.MSGS:
                src, fields, payloads = codec.unpack_slice(
                    body, self.template, self.cfg.n_groups)
                self.on_slice(src, fields, payloads)
            elif ftype == codec.HOPS:
                # Hop-tracing sideband — ``on_hops`` is assigned by the
                # runtime after construction (see TcpTransport); unset
                # means the owner is hop-blind and the frame is ignored.
                handler = getattr(self, "on_hops", None)
                if handler is not None:
                    import time as _time
                    t_recv = _time.perf_counter_ns()
                    direction, origin, records = codec.unpack_hops(body)
                    handler(origin, direction, records, t_recv)

    def _mirror(self, name: str) -> None:
        m = getattr(self, "metrics", None)
        if m is not None:
            try:
                m[name] += 1
            except Exception:
                pass

    def _link_open(self, peer: int) -> bool:
        """Forwards and snapshot fetches are round trips: a cut in either
        direction — legacy conn matrix or LinkFaults table — fails them."""
        if not (self.net._up(self.node_id, peer)
                and self.net._up(peer, self.node_id)):
            return False
        f = self.net.faults
        return f is None or (f.link_up(self.node_id, peer)
                             and f.link_up(peer, self.node_id))

    def forward_submit(self, peer: int, group: int, payload: bytes,
                       timeout: float = 30.0):
        if not self._link_open(peer):
            return False, b"link down"
        t = self.net.transports.get(peer)
        if t is None:
            return False, b"peer down"
        return codec.serve_forward(t.submit_handler, group, payload, timeout,
                                   t.result_encoder)

    def forward_read(self, peer: int, group: int, payload: bytes,
                     timeout: float = 30.0):
        """Relay a linearizable read to the leader (the loopback analog of
        TcpTransport.forward_read — serve side routes to RaftNode.read)."""
        if not self._link_open(peer):
            return False, b"link down"
        t = self.net.transports.get(peer)
        if t is None:
            return False, b"peer down"
        return codec.serve_forward(t.read_handler, group, payload, timeout,
                                   t.result_encoder)

    def forward_conf(self, peer: int, group: int, op: int, a: int, b: int,
                     timeout: float = 30.0):
        """Relay a membership op (§6 change / leadership transfer) to the
        leader — the loopback analog of TcpTransport.forward_conf."""
        if not self._link_open(peer):
            return False, b"link down"
        t = self.net.transports.get(peer)
        if t is None:
            return False, b"peer down"
        return codec.serve_conf(t.conf_node, group, op, a, b, timeout)

    def fetch_snapshot(self, peer: int, group: int, index: int, term: int,
                       dest_path: str, timeout: float = 60.0
                       ) -> Optional[Tuple[int, int]]:
        """File-to-file snapshot copy (the loopback analog of the TCP
        chunk stream): bytes never accumulate in memory."""
        if not self._link_open(peer):
            return None
        t = self.net.transports.get(peer)
        if t is None or t.snapshot_provider is None:
            return None
        res = t.snapshot_provider(group, index, term)
        if res is None:
            return None
        idx, tm, path = res
        try:
            import shutil
            shutil.copyfile(path, dest_path)
        except OSError:
            return None
        return idx, tm
