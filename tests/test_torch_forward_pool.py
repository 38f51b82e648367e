"""Forwards without a thread each: a stub runs each forwarded operation as
a coroutine on its transport's reactor (``transport/forward_io.py``
``Task``), and the TCP transport sends and serves forwards on that same
thread, with the replies the blocking round trip gave.  Closing a
transport settles every forward it holds."""

import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutTimeout

import pytest

from rafting_tpu_torch.api.anomaly import RaftError
from rafting_tpu_torch.api.stub import RaftStub
from rafting_tpu_torch.transport.forward_io import Reactor, Reply, Task


def _wait_for(pred, seconds=20.0):
    deadline = time.monotonic() + seconds
    while not pred():
        assert time.monotonic() < deadline
        time.sleep(0.01)


def test_task_steps_a_coroutine_on_the_reactor():
    """A sleep, a settled and a pending future, a failed one and a
    timed-out wait, all on the reactor's one thread."""
    io = Reactor("test-io")
    seen = []
    later = Future()

    def coro():
        seen.append(threading.current_thread().name)
        yield 0.05
        done = Future()
        done.set_result(1)
        seen.append((yield done, 5.0))
        seen.append((yield later, 5.0))
        bad = Future()
        threading.Timer(0.05, bad.set_exception, (KeyError("k"),)).start()
        try:
            yield bad, 5.0
        except KeyError:
            seen.append("raised")
        try:
            yield Future(), 0.05
        except FutTimeout:
            seen.append("timed out")
        out.set_result("end")
    out = Future()
    try:
        Task(io, coro(), out)
        _wait_for(lambda: len(seen) == 2)
        later.set_result(2)
        assert out.result(timeout=10) == "end"
        assert seen == ["test-io", 1, 2, "raised", "timed out"]
    finally:
        io.close()


def test_a_coroutine_that_raises_fails_its_future_only():
    io = Reactor("test-io")

    def boom():
        yield 0.01
        raise ValueError("boom")

    def fine():
        yield 0.05
        ok.set_result("ok")
    bad, ok = Future(), Future()
    try:
        Task(io, boom(), bad)
        Task(io, fine(), ok)
        with pytest.raises(ValueError, match="boom"):
            bad.result(timeout=10)
        assert ok.result(timeout=10) == "ok"
    finally:
        io.close()


class _Serial:
    encode_command = staticmethod(lambda c: c.encode() if isinstance(c, str)
                                  else c)
    decode_result = staticmethod(lambda raw: raw.decode())


class _AsyncTransport:
    """A leader answering every forward through a future, once the test
    lets it (or never)."""

    def __init__(self):
        self.calls = 0
        self.replies = []
        self.lock = threading.Lock()

    def forward_async(self, peer, lane, payload, timeout, read=False):
        f = Future()
        with self.lock:
            self.calls += 1
            self.replies.append((f, (True, b"ok:" + payload)))
        return f


class _Node:
    node_id = 1
    serializer = _Serial()

    def __init__(self, transport):
        self.transport = transport

    def is_leader(self, lane):
        return False

    def leader_hint(self, lane):
        return 0


class _Container:
    def __init__(self, node):
        self._node = node

    def _lookup(self, name):
        return 1


def test_forward_wave_rides_one_thread():
    """201 forwards in flight at once through one container's stubs: all
    are sent while every reply is outstanding, the wave adds one thread
    (the transport's reactor), and each future resolves with its own
    result once its reply comes."""
    node = _Node(_AsyncTransport())
    c = _Container(node)
    stubs = [RaftStub(c, f"g{k}", 1) for k in range(4)]
    base = threading.active_count()
    try:
        futs = [stubs[k % 4].submit(f"op{k}", timeout=30)
                for k in range(200)]
        futs += [stubs[0].read("q", timeout=30)]
        _wait_for(lambda: node.transport.calls == 201)
        assert not any(f.done() for f in futs)
        assert threading.active_count() <= base + 1
        for f, reply in list(node.transport.replies):
            f.set_result(reply)
        results = [f.result(timeout=30) for f in futs]
        assert results[:3] == ["ok:op0", "ok:op1", "ok:op2"]
        assert results[-1] == "ok:q"
    finally:
        node.transport._reactor.close()


def test_the_client_timeout_bounds_a_forward_with_no_reply():
    """A reply that never comes: the stub's own timer ends the operation
    at its budget plus one second, as the blocking round trip's socket
    timeout did."""
    node = _Node(_AsyncTransport())
    stub = RaftStub(_Container(node), "g", 1)
    try:
        t0 = time.monotonic()
        fut = stub.submit("x", timeout=0.5)
        with pytest.raises(RaftError, match="forward failed: timed out"):
            fut.result(timeout=10)
        assert time.monotonic() - t0 < 5
    finally:
        node.transport._reactor.close()


class _FailingTransport:
    """A leader whose forwards fail: the reply raises, after a while."""

    def forward_async(self, peer, lane, payload, timeout, read=False):
        f = Future()
        threading.Timer(0.05, f.set_exception,
                        (ValueError("malformed reply"),)).start()
        return f


def test_a_failed_forward_settles_its_future():
    node = _Node(_FailingTransport())
    stub = RaftStub(_Container(node), "g", 1)
    try:
        futs = [stub.submit(f"op{k}", timeout=30) for k in range(20)]
        for f in futs:
            with pytest.raises(ValueError, match="malformed reply"):
                f.result(timeout=10)
    finally:
        node.transport._reactor.close()


class _BlockingTransport:
    """A transport with only the blocking calls of the reference's."""

    def forward_submit(self, peer, lane, payload, timeout):
        time.sleep(0.05)
        return True, b"ok:" + payload

    forward_read = forward_submit


def test_a_blocking_transport_gets_a_thread_a_forward():
    node = _Node(_BlockingTransport())
    stub = RaftStub(_Container(node), "g", 1)
    try:
        futs = [stub.submit(f"op{k}", timeout=30) for k in range(5)]
        futs += [stub.read("q", timeout=30)]
        assert [f.result(timeout=10) for f in futs] == \
            [f"ok:op{k}" for k in range(5)] + ["ok:q"]
    finally:
        node.transport._reactor.close()


def _tcp_pair(handler):
    from rafting_tpu_torch import EngineConfig
    from rafting_tpu_torch.testkit.harness import free_ports
    from rafting_tpu_torch.transport.tcp import TcpTransport
    cfg = EngineConfig(n_groups=4, n_peers=2)
    ports = free_ports(2)
    peers = {i: ("127.0.0.1", p) for i, p in enumerate(ports)}
    ts = [TcpTransport(i, peers, cfg, None, lambda *a: None,
                       submit_handler=handler if i == 1 else None)
          for i in range(2)]
    for t in ts:
        t.start()
    return ts


def test_tcp_forwards_ride_one_reactor_each_side():
    """Client and serving side of 100 TCP forwards in flight: each
    transport adds its reactor thread, not a thread per forward, at
    either end; every reply is serve_forward's."""
    pending = []

    def handler(group, payload):
        f = Future()
        if payload == b"never":
            return f                       # the serving deadline answers
        if payload == b"boom":
            raise ValueError("boom")
        if payload == b"warm":
            f.set_result("warm")
            return f
        pending.append((f, payload))
        return f
    a, b = _tcp_pair(handler)
    try:
        # Both reactors up, both peers' channels (a reader thread each)
        # connected, before the count.
        assert a.forward_async(1, 0, b"warm").result(10) == (True, b'"warm"')
        assert b.forward_async(1, 0, b"warm").result(10) == (True, b'"warm"')
        _wait_for(lambda: sum(t.name.endswith("(_read_loop)")
                              for t in threading.enumerate()) >= 2)
        base = threading.active_count()
        futs = [a.forward_async(1, 0, f"p{k}".encode(), timeout=60)
                for k in range(100)]
        _wait_for(lambda: len(pending) == 100, 60)
        assert threading.active_count() <= base   # none a forward
        for f, p in pending:
            f.set_result(p.decode())
        got = [f.result(timeout=60) for f in futs]
        assert got == [(True, f'"p{k}"'.encode()) for k in range(100)]
        assert a.forward_async(1, 0, b"never", timeout=0.3).result(10) == \
            (False, b"FAILED:TimeoutError: ")
        assert a.forward_async(1, 0, b"boom", timeout=5).result(10) == \
            (False, b"FAILED:ValueError: boom")
        assert b.forward_async(0, 0, b"x", timeout=5).result(10) == \
            (False, b"FAILED:forwarding disabled")
        assert a.forward_submit(1, 0, b"never", timeout=0.3) == \
            (False, b"FAILED:TimeoutError: ")
    finally:
        for t in (a, b):
            t.close()
    ok, why = a.forward_async(1, 0, b"x", timeout=1).result(10)
    assert not ok and why


def test_closing_a_transport_settles_the_forwards_in_flight():
    """Stub forwards and raw round trips over TCP to a leader that never
    answers: closing the client's transport fails each at once, long
    before its budget; closing the leader's then closes the connections
    it was serving, unanswered."""
    a, b = _tcp_pair(lambda group, payload: Future())
    node = _Node(a)
    node.node_id, node.leader_hint = 0, lambda lane: 1
    stub = RaftStub(_Container(node), "g", 1)
    try:
        futs = [stub.submit(f"op{k}", timeout=60) for k in range(20)]
        raw = [a.forward_async(1, 0, b"r", timeout=60) for _ in range(5)]
        def serving():          # the forwards b is answering
            if not hasattr(b, "_reactor"):
                return []
            with b._reactor._lock:
                live = list(b._reactor._live)
            return [r for r in live if isinstance(r, Reply)]
        _wait_for(lambda: len(serving()) == 25)
        replies = serving()
        assert not any(f.done() for f in futs + raw)
        t0 = time.monotonic()
        a.close()
        for f in futs:
            with pytest.raises(ConnectionAbortedError):
                f.result(timeout=10)
        assert [f.result(timeout=10) for f in raw] == \
            [(False, b"transport closed")] * 5
        assert time.monotonic() - t0 < 10
        b.close()
        assert all(r.sent and r.conn.fileno() == -1 for r in replies)
    finally:
        for t in (a, b):
            t.close()


def test_loopback_forwards_chain_the_leaders_future(tmp_path):
    """The loopback transport's forward_async answers from the leader
    future's done-callback, or at its timeout, with serve_forward's
    replies."""
    from rafting_tpu_torch.transport.loopback import (
        LoopbackNetwork, LoopbackTransport,
    )
    pending = {}

    def handler(group, payload):
        if payload == b"boom":
            raise ValueError("boom")
        f = pending[payload] = Future()
        return f
    net = LoopbackNetwork(2)
    ts = [LoopbackTransport(net, i, None, None, lambda *a: None,
                            submit_handler=handler if i == 1 else None)
          for i in range(2)]
    for t in ts:
        t.start()
    fut = ts[0].forward_async(1, 0, b"x")
    assert not fut.done()
    pending[b"x"].set_result("done")
    assert fut.result(timeout=1) == (True, b'"done"')
    assert ts[0].forward_async(1, 0, b"boom").result(timeout=1) == \
        (False, b"FAILED:ValueError: boom")
    assert ts[1].forward_async(0, 0, b"x").result(timeout=1) == \
        (False, b"FAILED:forwarding disabled")
    assert ts[0].forward_async(1, 0, b"late", timeout=0.2).result(
        timeout=5) == (False, b"FAILED:TimeoutError: ")
    ts[1].close()
    assert ts[0].forward_async(1, 0, b"x").result(timeout=1) == \
        (False, b"peer down")
    ts[0].close()


class _Leaderless(_Node):
    """A node that knows no leader for the lane (it was cut off)."""

    def leader_hint(self, lane):
        return None


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_chase_with_no_leader_gives_up_as_the_reference_does(pkg):
    """A forward with no leader to go to sends nothing, and once its
    budget is spent the operation fails with a NotLeaderError.  The
    reference leaves it unmarked, so a client records an operation that
    is in no log as of unknown outcome (a fault of the reference, pinned
    here as it is); the port marks it as a refusal, which is safe to
    retry."""
    if pkg == "jax":
        from rafting_tpu.api.anomaly import is_refusal
        from rafting_tpu.api.stub import RaftStub as Stub
        transport = _BlockingTransport()
    else:
        from rafting_tpu_torch.api.anomaly import is_refusal
        Stub = RaftStub
        transport = _AsyncTransport()
    node = _Leaderless(transport)
    stub = Stub(_Container(node), "g", 1)
    try:
        fut = stub.submit("x", timeout=0.3)
        exc = fut.exception(timeout=10)
        assert type(exc).__name__ == "NotLeaderError"
        assert is_refusal(exc) == (pkg == "port")
        assert getattr(transport, "calls", 0) == 0
    finally:
        if pkg == "port":
            transport._reactor.close()


class _LosesItsLeader(_Node):
    """A node that knows the leader until its stub has sent one forward,
    and none after."""

    def leader_hint(self, lane):
        return 0 if self.transport.calls == 0 else None


class _RefusingTransport(_AsyncTransport):
    """The leader refuses every forward at once: it stepped down."""

    def forward_async(self, peer, lane, payload, timeout, read=False):
        f = super().forward_async(peer, lane, payload, timeout, read)
        f.set_result((False, b"REFUSED:NotLeaderError:not the leader"))
        return f


def test_a_chase_that_sent_an_attempt_keeps_the_unmarked_error():
    """A chase that sent one forward and then lost the leader gives up
    with the unmarked NotLeaderError: it cannot know what its attempt
    became, so the client must treat the outcome as unknown."""
    from rafting_tpu_torch.api.anomaly import is_refusal
    transport = _RefusingTransport()
    stub = RaftStub(_Container(_LosesItsLeader(transport)), "g", 1)
    try:
        exc = stub.submit("x", timeout=0.3).exception(timeout=10)
        assert type(exc).__name__ == "NotLeaderError"
        assert not is_refusal(exc)
        assert transport.calls == 1
    finally:
        transport._reactor.close()
