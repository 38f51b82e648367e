"""TCP transport: the host communication backend between Raft nodes.

Topology mirrors the reference (transport/EventBus.java, EventNode.java):
every node runs one listening server; every node maintains ONE persistent
outbound connection to each peer carrying all groups' consensus traffic
(scope-multiplexing inverted into dense tick slices, see codec.py), with
1-second auto-reconnect (reference EventNode.java:93-94).  Snapshot bulk
transfer uses a separate ephemeral connection per fetch so large state never
head-of-line-blocks consensus frames (reference SnapChannel,
transport/EventNode.java:122-267; zero-copy serve EventBus.java:98-111).

Inbound connections self-identify with their first frame: HELLO = a peer's
persistent message channel (reference handshake upgrade,
EventBus.java:71-97); SNAP_REQ = an ephemeral snapshot fetch.

Send-side queues are bounded and drop-oldest under backpressure: Raft
tolerates loss (resend on timeout), so shedding beats unbounded buffering —
the analog of the reference's busy-loop backpressure hint
(support/EventLoop.java:136-138).
"""

from __future__ import annotations

import logging
import os
import queue
import random
import socket
import struct
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from . import codec

log = logging.getLogger(__name__)

RECONNECT_DELAY = 1.0   # base backoff (reference EventNode.java:93-94)
RECONNECT_MAX = 15.0    # backoff ceiling for a persistently-down peer
SEND_QUEUE_CAP = 1024


class PeerSender:
    """One persistent outbound channel to a peer, with reconnect."""

    def __init__(self, my_id: int, peer_id: int, addr: Tuple[str, int],
                 hello: bytes, metrics=None, faults_get=None):
        """``faults_get()`` (optional) returns the cluster's current
        LinkFaults table or None — a getter, not the table itself, so the
        owning transport can install/replace faults at runtime and every
        sender sees the swap on its next frame."""
        self.my_id = my_id
        self.peer_id = peer_id
        self.addr = addr
        self.hello = hello
        self.metrics = metrics
        self.faults_get = faults_get
        self.q: "queue.Queue[bytes]" = queue.Queue(SEND_QUEUE_CAP)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"raft-send-{my_id}->{peer_id}",
            daemon=True)
        self.connected = False
        self._held: Optional[bytes] = None  # reorder nemesis holdback

    def start(self):
        self._thread.start()

    def send(self, data: Optional[bytes]) -> None:
        if not data:  # empty tick slice: nothing to say
            return
        try:
            self.q.put_nowait(data)
        except queue.Full:
            try:  # drop-oldest: newest consensus state supersedes stale
                self.q.get_nowait()
            except queue.Empty:
                pass
            try:
                self.q.put_nowait(data)
            except queue.Full:
                pass

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)

    def _backoff(self, attempts: int) -> float:
        """Jittered exponential backoff: 1s doubling to the 15s cap, with
        0.5-1.0x jitter so a restarted peer isn't hit by every sender in
        lockstep (a reconnect stampede is itself a storage-adjacent fault
        amplifier: N simultaneous hellos against a node mid-recovery)."""
        base = min(RECONNECT_MAX,
                   RECONNECT_DELAY * (2.0 ** min(attempts - 1, 6)))
        return base * (0.5 + 0.5 * random.random())

    def _count(self, name: str) -> None:
        if self.metrics is not None:
            try:
                self.metrics[name] += 1
            except Exception:  # metrics must never kill the sender
                pass

    def _flush_held(self, sock) -> None:
        """Send a frame the reorder nemesis held back — after the next
        frame (the adjacent swap), or on queue idle so it never starves."""
        if self._held is not None:
            h, self._held = self._held, None
            sock.sendall(h)

    def _faults(self):
        return self.faults_get() if self.faults_get is not None else None

    def _run(self):
        attempts = 0
        while not self._stop.is_set():
            f = self._faults()
            if f is not None and not f.link_up(self.my_id, self.peer_id):
                # Injected partition: behave exactly like an unreachable
                # peer — count a reconnect attempt and climb the backoff
                # ladder, so a flapping partition exercises the same
                # jittered-exponential path a flapping switch would.
                attempts += 1
                self._count("reconnects_total")
                # Full jittered-exponential ladder, but capped at 2s so a
                # healed partition is noticed promptly in bounded tests.
                self._stop.wait(min(2.0, self._backoff(attempts)))
                continue
            sock = None
            try:
                sock = socket.create_connection(self.addr, timeout=5)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.sendall(self.hello)
                self.connected = True
                attempts = 0  # established: next drop restarts the ladder
                while not self._stop.is_set():
                    try:
                        data = self.q.get(timeout=0.5)
                    except queue.Empty:
                        self._flush_held(sock)
                        continue
                    f = self._faults()
                    if f is None:
                        sock.sendall(data)
                        continue
                    act = f.plan(self.my_id, self.peer_id)
                    if act.cut:
                        # Partition dropped mid-connection: sever like a
                        # network failure.  The dequeued frame is lost
                        # (Raft resends on timeout), and so is any held
                        # one — buffered bytes die with the connection.
                        self._count("net_faults_cut_total")
                        raise OSError("injected link cut")
                    if not act.deliver:
                        self._count("net_faults_dropped_total")
                        continue
                    if act.delay_s > 0:
                        self._count("net_faults_delayed_total")
                        self._stop.wait(act.delay_s)
                    if act.reorder and self._held is None:
                        self._count("net_faults_reordered_total")
                        self._held = data
                        continue
                    sock.sendall(data)
                    if act.dup:
                        self._count("net_faults_duplicated_total")
                        sock.sendall(data)
                    self._flush_held(sock)
            except OSError:
                pass
            finally:
                self.connected = False
                self._held = None
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
            if not self._stop.is_set():
                attempts += 1
                self._count("reconnects_total")
                # stop.wait, not sleep: close() shouldn't stall on backoff
                self._stop.wait(self._backoff(attempts))


class TcpTransport:
    """The node's network endpoint.

    ``on_slice(src, fields, payloads)`` is called from reader threads with
    each arriving tick slice (typically InboxAccumulator.merge).
    ``snapshot_provider(group, index, term) -> (index, term, ok, bytes)``
    serves snapshot fetches (None payload -> not available).
    """

    def __init__(self, node_id: int, peers: Dict[int, Tuple[str, int]],
                 cfg, template,
                 on_slice: Callable,
                 snapshot_provider: Optional[Callable] = None,
                 submit_handler: Optional[Callable] = None,
                 result_encoder: Optional[Callable] = None,
                 read_handler: Optional[Callable] = None,
                 conf_node=None, faults=None):
        """``submit_handler(group, payload) -> Future`` serves forwarded
        client commands (None -> forwards are refused).
        ``read_handler(group, payload) -> Future`` serves forwarded
        linearizable reads (RaftNode.read; None -> read forwards refused).
        ``result_encoder(result) -> bytes`` encodes forwarded apply results
        (the node's CmdSerializer, api/serial.py; default JSON).
        ``conf_node`` serves forwarded membership ops (FWD_CONF): any
        object with change_membership/transfer_leadership — normally the
        RaftNode itself (None -> membership forwards refused).
        ``faults``: an optional shared LinkFaults table (transport/
        faults.py) — assignable at runtime (``transport.faults = ...``);
        sender threads read it through a getter so a mid-run swap takes
        effect on the next frame."""
        self.node_id = node_id
        self.faults = faults
        self.peers = peers
        self.cfg = cfg
        self.template = template
        self.on_slice = on_slice
        self.snapshot_provider = snapshot_provider
        self.submit_handler = submit_handler
        self.result_encoder = result_encoder
        self.read_handler = read_handler
        self.conf_node = conf_node
        self._hello = codec.pack_hello(node_id, cfg.n_groups, cfg.n_peers,
                                       cfg.batch)
        self._senders: Dict[int, PeerSender] = {}
        self._server: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._threads = []

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        host, port = self.peers[self.node_id]
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(16)
        srv.settimeout(0.5)
        self._server = srv
        t = threading.Thread(target=self._accept_loop,
                             name=f"raft-accept-{self.node_id}", daemon=True)
        t.start()
        self._threads.append(t)
        for pid, addr in self.peers.items():
            if pid == self.node_id:
                continue
            s = PeerSender(self.node_id, pid, addr, self._hello,
                           metrics=getattr(self, "metrics", None),
                           faults_get=lambda: self.faults)
            s.start()
            self._senders[pid] = s

    def close(self) -> None:
        self._stop.set()
        for s in self._senders.values():
            s.stop()
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5)

    @property
    def bound_port(self) -> int:
        return self._server.getsockname()[1]

    # -- sending -------------------------------------------------------------

    def send_slice(self, dst: int, packed: bytes) -> None:
        self._senders[dst].send(packed)

    def fetch_snapshot(self, peer: int, group: int, index: int, term: int,
                       dest_path: str, timeout: float = 60.0
                       ) -> Optional[Tuple[int, int]]:
        """Ephemeral snapshot fetch (reference SnapChannel,
        transport/EventNode.java:122-267).  After the SNAP_HDR frame the
        stream is TRANSPARENT: exactly ``total_len`` raw file bytes,
        written to ``dest_path`` incrementally — bytes never accumulate
        in memory, nothing is framed or checksummed per chunk (the serve
        side is a zero-copy sendfile), and snapshot size is unbounded by
        MAX_BODY.  Blocking — call from a worker thread.  Returns
        (index, term) or None."""
        if not self._link_open(peer):
            return None
        try:
            with socket.create_connection(self.peers[peer],
                                          timeout=timeout) as sock:
                sock.settimeout(timeout)
                sock.sendall(codec.pack_snap_req(group, index, term))
                # One-frame decode, NOT a greedy FrameReader: the raw
                # stream's head may ride in the same recv as the header
                # and must not be parsed as frames.
                buf = bytearray()
                meta = None          # (idx, term, total_len)
                while meta is None:
                    data = sock.recv(1 << 20)
                    if not data:
                        return None
                    buf += data
                    fr = codec.peek_frame(buf)
                    if fr is None:
                        continue
                    ftype, body, consumed = fr
                    if ftype != codec.SNAP_HDR:
                        return None
                    g, idx, tm, ok, total = codec.unpack_snap_hdr(body)
                    if not ok:
                        return None
                    meta = (idx, tm, total)
                    del buf[:consumed]
                received = 0
                with open(dest_path, "wb") as f:
                    if buf:              # raw bytes that rode along
                        f.write(buf[:meta[2]])
                        received = min(len(buf), meta[2])
                    while received < meta[2]:
                        data = sock.recv(1 << 20)
                        if not data:
                            return None     # short stream: fetch failed
                        f.write(data[:meta[2] - received])
                        received += min(len(data), meta[2] - received)
                return meta[0], meta[1]
        except (OSError, IOError, ValueError, struct.error, KeyError) as e:
            # Malformed frames / unknown peer fail like any transport error.
            log.debug("snapshot fetch from %d failed: %s", peer, e)
            return None

    def _link_open(self, peer: int) -> bool:
        """Ephemeral channels (forward / snapshot fetch) respect injected
        partitions too: a cut in EITHER direction fails the round trip —
        these connections need both the request and the reply to pass."""
        f = self.faults
        return f is None or (f.link_up(self.node_id, peer)
                             and f.link_up(peer, self.node_id))

    # -- inbound -------------------------------------------------------------

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._read_loop, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _read_loop(self, conn: socket.socket):
        reader = codec.FrameReader()
        src: Optional[int] = None
        conn.settimeout(1.0)
        try:
            while not self._stop.is_set():
                try:
                    data = conn.recv(1 << 20)
                except socket.timeout:
                    continue
                if not data:
                    return
                for ftype, body in reader.feed(data):
                    if ftype == codec.HELLO:
                        nid, G, P, B, tag = codec.unpack_hello(body)
                        if (G, P, B) != (self.cfg.n_groups, self.cfg.n_peers,
                                         self.cfg.batch):
                            log.error("shape mismatch from node %d", nid)
                            return
                        if tag != codec.SCHEMA_TAG:
                            log.error("wire-schema mismatch from node %d "
                                      "(tag %#x != ours %#x) — peer runs a "
                                      "different build", nid, tag,
                                      codec.SCHEMA_TAG)
                            return
                        src = nid
                    elif ftype == codec.MSGS:
                        if src is None:
                            # No handshake yet: refuse to trust the frame's
                            # claimed source (reference validates the channel
                            # identity, EventBus.java:119-147).
                            log.warning("MSGS before HELLO — connection drop")
                            return
                        s, fields, payloads = codec.unpack_slice(
                            body, self.template, self.cfg.n_groups)
                        if s != src:
                            log.warning("frame src %d != channel src %d — "
                                        "dropped", s, src)
                            continue  # source spoof guard
                        self.on_slice(s, fields, payloads)
                    elif ftype == codec.HOPS:
                        # Hop-tracing sideband (utils/latency.py): rides
                        # the persistent channel, so the HELLO identity
                        # guards it exactly like MSGS.  ``on_hops`` is
                        # assigned by the runtime after construction
                        # (same pattern as ``transport.metrics``); a
                        # hop-blind owner leaves it unset and the frame
                        # is ignored.
                        handler = getattr(self, "on_hops", None)
                        if handler is None or src is None:
                            continue
                        t_recv = time.perf_counter_ns()
                        direction, origin, records = codec.unpack_hops(body)
                        if origin != src:
                            log.warning("HOPS origin %d != channel src %d "
                                        "— dropped", origin, src)
                            continue
                        handler(origin, direction, records, t_recv)
                    elif ftype == codec.SNAP_REQ:
                        self._serve_snapshot(conn, body)
                        return  # ephemeral connection: one fetch, then close
                    elif ftype == codec.FWD_REQ:
                        self._serve_forward(conn, body)
                        return  # ephemeral: one command, then close
                    elif ftype == codec.FWD_READ:
                        self._serve_forward(conn, body, read=True)
                        return  # ephemeral: one read, then close
                    elif ftype == codec.FWD_CONF:
                        group, op, tmo, a, b = codec.unpack_fwd_conf(body)
                        ok, res = codec.serve_conf(self.conf_node, group,
                                                   op, a, b, tmo)
                        conn.sendall(codec.pack_fwd_resp(ok, res))
                        return  # ephemeral: one membership op, then close
        except (OSError, IOError, ValueError, struct.error):
            # Malformed frames (struct/ValueError from a buggy or hostile
            # peer) end the connection cleanly, same as transport errors.
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def forward_submit(self, peer: int, group: int, payload: bytes,
                       timeout: float = 30.0
                       ) -> Tuple[bool, bytes]:
        """Relay a client command to ``peer`` and wait for the apply result
        (JSON bytes).  Blocking — call from a worker/client thread."""
        return self._forward(peer, group, payload, timeout, codec.FWD_REQ)

    def forward_read(self, peer: int, group: int, payload: bytes,
                     timeout: float = 30.0) -> Tuple[bool, bytes]:
        """Relay a linearizable read to ``peer`` (the leader) and wait for
        the query result — the read-plane sibling of forward_submit."""
        return self._forward(peer, group, payload, timeout, codec.FWD_READ)

    def forward_conf(self, peer: int, group: int, op: int, a: int, b: int,
                     timeout: float = 30.0) -> Tuple[bool, bytes]:
        """Relay a membership op (§6 change / leadership transfer) to
        ``peer`` over an ephemeral FWD_CONF connection."""
        if not self._link_open(peer):
            return False, b"link cut (fault injection)"
        try:
            with socket.create_connection(self.peers[peer],
                                          timeout=timeout) as sock:
                sock.settimeout(timeout + 1.0)
                sock.sendall(codec.pack_fwd_conf(group, op, a, b, timeout))
                reader = codec.FrameReader()
                while True:
                    data = sock.recv(1 << 20)
                    if not data:
                        return False, b"connection closed"
                    for ftype_r, body in reader.feed(data):
                        if ftype_r == codec.FWD_RESP:
                            return codec.unpack_fwd_resp(body)
        except OSError as e:
            return False, str(e).encode()

    def _forward(self, peer: int, group: int, payload: bytes,
                 timeout: float, ftype: int) -> Tuple[bool, bytes]:
        if not self._link_open(peer):
            return False, b"link cut (fault injection)"
        try:
            with socket.create_connection(self.peers[peer],
                                          timeout=timeout) as sock:
                sock.settimeout(timeout + 1.0)  # serve side bounds the wait
                sock.sendall(codec.pack_fwd_req(group, payload, timeout,
                                                ftype))
                reader = codec.FrameReader()
                while True:
                    data = sock.recv(1 << 20)
                    if not data:
                        return False, b"connection closed"
                    for ftype_r, body in reader.feed(data):
                        if ftype_r == codec.FWD_RESP:
                            return codec.unpack_fwd_resp(body)
        except OSError as e:
            return False, str(e).encode()

    def _serve_forward(self, conn: socket.socket, body: bytes,
                       read: bool = False):
        group, timeout_s, payload = codec.unpack_fwd_req(body)
        handler = self.read_handler if read else self.submit_handler
        ok, res = codec.serve_forward(handler, group, payload,
                                      timeout_s, self.result_encoder)
        conn.sendall(codec.pack_fwd_resp(ok, res))

    def _serve_snapshot(self, conn: socket.socket, body: bytes):
        """Serve our snapshot file zero-copy (reference DefaultFileRegion
        sendfile, transport/EventBus.java:98-111): a CRC-framed SNAP_HDR,
        then the raw file bytes via ``socket.sendfile`` — the kernel moves
        pages straight from the file cache to the socket, so a laggard
        catch-up storm at 100k groups never pays a per-byte Python copy on
        the tick-adjacent host (falls back to plain send() internally on
        platforms without os.sendfile)."""
        group, index, term = codec.unpack_snap_req(body)
        # The read loop's 1s poll timeout is wrong for a bulk send: a >1s
        # receiver stall would abort the stream mid-transfer.  Give the
        # serve its own generous deadline.
        conn.settimeout(60.0)
        res = (self.snapshot_provider(group, index, term)
               if self.snapshot_provider is not None else None)
        if res is None:
            conn.sendall(codec.pack_snap_hdr(group, index, term, False, 0))
            return
        idx, tm, path = res
        try:
            total = os.path.getsize(path)
            with open(path, "rb") as f:
                conn.sendall(codec.pack_snap_hdr(group, idx, tm, True, total))
                sent = 0
                while sent < total:
                    n = conn.sendfile(f, offset=sent, count=total - sent)
                    if not n:
                        break   # file truncated under us: short stream,
                                # client's byte count check re-requests
                    sent += n
        except OSError:
            # File vanished (e.g. retention rotated it): the client's
            # byte-count check fails and it re-requests.
            log.debug("snapshot serve failed g=%d", group)
