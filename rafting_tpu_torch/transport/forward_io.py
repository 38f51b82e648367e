"""Forwarded operations without a thread each: one event loop per transport.

A forwarded client operation waits as long as the leader takes to commit
or serve it: seconds under load, many ticks of a busy node.  The TCP
transport (``transport/tcp.py``) used to spend a client thread blocked
on the reply and a serving thread blocked on the leader's future for each
one, so a wave of F forwards started 2F threads.  Here a ``Reactor`` (one
thread) multiplexes every forward a transport has in flight:

* ``Task`` runs a client operation written as a generator
  (``api/stub.py`` ``RaftStub._forwarded``) step by step, resuming it when
  the future it waits on settles or its timer fires;
* ``Exchange`` runs the client side of one FWD_REQ/FWD_READ round trip on
  a non-blocking socket and resolves a ``Future`` with ``(ok, raw)`` when
  the FWD_RESP frame arrives, exactly what the blocking round trip
  returned (``(False, reason)`` on a transport error or at the deadline);
* ``FirstFrame`` reads an accepted connection's first frame, so the
  serving side starts a forward without a thread, and ``Reply`` answers
  it from the leader future's done-callback, or at its deadline.  Other
  connections (a peer's persistent channel, a snapshot fetch, a
  membership relay) go on to a thread of their own as before.

Closing a reactor settles everything it holds: a round trip resolves with
``(False, b"transport closed")``, a task's future fails, a served
connection closes unanswered.  The wire format (``transport/codec.py``)
is unchanged.
"""

from __future__ import annotations

import errno
import heapq
import itertools
import logging
import selectors
import socket
import struct
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutTimeout

from . import codec

log = logging.getLogger(__name__)


class Reactor:
    """One daemon thread running registered socket handlers, calls handed
    in from other threads (``call_soon``) and timers (``call_later``)."""

    def __init__(self, name: str):
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        self._lock = threading.Lock()
        self._calls: list = []
        self._timers: list = []          # heap of [deadline, seq, fn]
        self._seq = itertools.count()
        self._stop = False
        self._live: set = set()          # what close() settles
        self._closed = False
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    def call_soon(self, fn) -> None:
        with self._lock:
            self._calls.append(fn)
        try:
            self._wake_w.send(b"\0")
        except (BlockingIOError, OSError):
            pass                # a wake-up is pending already, or closed

    def call_later(self, delay: float, fn) -> list:
        """Run ``fn`` on the loop after ``delay`` s; returns a handle that
        ``cancel`` takes."""
        entry = [time.monotonic() + max(0.0, delay), next(self._seq), fn]
        self.call_soon(lambda: heapq.heappush(self._timers, entry))
        return entry

    @staticmethod
    def cancel(entry: list) -> None:
        entry[2] = None

    def track(self, obj) -> None:
        """Hold ``obj`` until ``untrack``; if the reactor closes first, its
        ``abort()`` runs then (at once, if it has closed already)."""
        with self._lock:
            if not self._closed:
                self._live.add(obj)
                return
        obj.abort()

    def untrack(self, obj) -> None:
        with self._lock:
            self._live.discard(obj)

    def register(self, sock, events: int, handler) -> None:
        self._sel.register(sock, events, handler)

    def modify(self, sock, events: int, handler) -> None:
        self._sel.modify(sock, events, handler)

    def unregister(self, sock) -> None:
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError):
            pass

    def close(self) -> None:
        self._stop = True
        self.call_soon(lambda: None)
        self._thread.join(timeout=5)

    def _run(self, fn, *args) -> None:
        try:
            fn(*args)
        except Exception:      # one bad callback must not stop the loop
            log.exception("forward reactor callback failed")

    def _loop(self) -> None:
        while not self._stop:
            timeout = None
            if self._timers:
                timeout = max(0.0, self._timers[0][0] - time.monotonic())
            for key, mask in self._sel.select(timeout):
                if key.data is None:
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                else:
                    self._run(key.data, mask)
            with self._lock:
                calls, self._calls = self._calls, []
            for fn in calls:
                self._run(fn)
            now = time.monotonic()
            while self._timers and self._timers[0][0] <= now:
                fn = heapq.heappop(self._timers)[2]
                if fn is not None:
                    self._run(fn)
        with self._lock:
            self._closed = True
            live, self._live = self._live, set()
        # Round trips and served connections first, then the tasks that
        # may wait on them.
        for obj in sorted(live, key=lambda o: isinstance(o, Task)):
            self._run(obj.abort)
        self._sel.close()
        self._wake_r.close()
        self._wake_w.close()


class Task:
    """Run generator ``coro`` on ``reactor``, one step at a time.  It
    yields a delay in seconds (sleep), or ``(future, timeout)``: it is
    resumed with the future's result, with its exception thrown in, or
    with ``concurrent.futures.TimeoutError`` thrown in after ``timeout``
    s.  An exception that escapes ``coro`` fails ``out``; ``coro`` settles
    ``out`` itself otherwise.  Closing the reactor fails ``out`` with
    ``ConnectionAbortedError``."""

    def __init__(self, reactor: Reactor, coro, out: Future):
        self.reactor = reactor
        self.coro = coro
        self.out = out
        self.token = None       # the current wait's; a stale wake-up no-ops
        self.timer = None
        reactor.track(self)
        reactor.call_soon(self._step)

    def _step(self, value=None, exc=None) -> None:
        while True:
            try:
                req = self.coro.send(value) if exc is None \
                    else self.coro.throw(exc)
            except StopIteration:
                self.reactor.untrack(self)
                return
            except BaseException as e:
                self.reactor.untrack(self)
                if not self.out.done():
                    self.out.set_exception(e)
                if not isinstance(e, Exception):
                    raise
                return
            value = exc = None
            fut, timeout = req if isinstance(req, tuple) else (None, req)
            if fut is not None and fut.done():
                try:
                    value = fut.result()
                except BaseException as e:
                    exc = e
                continue
            self._wait(fut, timeout)
            return

    def _wait(self, fut, timeout: float) -> None:
        token = self.token = object()

        def wake(f=None):       # on the reactor thread
            if self.token is not token:
                return
            self.token = None
            Reactor.cancel(self.timer)
            if f is None:
                self._step(exc=FutTimeout() if fut is not None else None)
                return
            try:
                v = f.result()
            except BaseException as e:
                self._step(exc=e)
                return
            self._step(v)
        self.timer = self.reactor.call_later(timeout, wake)
        if fut is not None:
            fut.add_done_callback(
                lambda f: self.reactor.call_soon(lambda: wake(f)))

    def abort(self) -> None:
        self.token = None
        try:
            self.coro.close()
        except BaseException:
            pass
        if not self.out.done():
            self.out.set_exception(ConnectionAbortedError(
                "transport closed with the operation in flight"))


class Exchange:
    """The client side of one forward round trip on the reactor: connect,
    send ``frame``, read until FWD_RESP, then close.  ``future`` gets
    ``codec.unpack_fwd_resp``'s ``(ok, raw)``, ``(False, reason)`` on a
    socket error, EOF or past ``timeout`` + 1 s (the serving side bounds
    its own wait by ``timeout``), or the exception of a malformed reply."""

    def __init__(self, reactor: Reactor, addr, frame: bytes, timeout: float,
                 future: Future):
        self.reactor = reactor
        self.addr = addr
        self.out = frame
        self.timeout = timeout
        self.future = future
        self.reader = codec.FrameReader()
        self.sock = None
        self.timer = None
        self.connecting = True
        reactor.track(self)

    def start(self) -> None:
        """Runs on the reactor thread."""
        try:
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self.sock.setblocking(False)
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            err = self.sock.connect_ex(self.addr)
            if err not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK):
                raise OSError(err, errno.errorcode.get(err, str(err)))
            self.reactor.register(self.sock, selectors.EVENT_WRITE,
                                  self._on_event)
            self.timer = self.reactor.call_later(
                self.timeout + 1.0, lambda: self._finish(False, b"timed out"))
        except OSError as e:
            self._finish(False, str(e).encode())

    def _on_event(self, mask: int) -> None:
        try:
            if self.connecting:
                err = self.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
                if err:
                    raise OSError(err, errno.errorcode.get(err, str(err)))
                self.connecting = False
            if self.out:
                self.out = self.out[self.sock.send(self.out):]
                if not self.out:
                    self.reactor.modify(self.sock, selectors.EVENT_READ,
                                        self._on_event)
                return
            data = self.sock.recv(1 << 20)
            if not data:
                self._finish(False, b"connection closed")
                return
            for ftype, body in self.reader.feed(data):
                if ftype == codec.FWD_RESP:
                    self._finish(*codec.unpack_fwd_resp(body))
                    return
        except (BlockingIOError, InterruptedError):
            pass
        except OSError as e:
            self._finish(False, str(e).encode())
        except (ValueError, struct.error) as e:
            self._finish(error=e)

    def abort(self) -> None:
        self._finish(False, b"transport closed")

    def _finish(self, ok=False, raw=b"", error=None) -> None:
        if self.future.done():
            return
        self.reactor.untrack(self)
        if self.timer is not None:
            Reactor.cancel(self.timer)
        if self.sock is not None:
            self.reactor.unregister(self.sock)
            try:
                self.sock.close()
            except OSError:
                pass
        if error is not None:
            self.future.set_exception(error)
        else:
            self.future.set_result((ok, raw))


class FirstFrame:
    """Read an accepted connection's first frame on the reactor, then hand
    the connection on: ``on_frame(conn, ftype, body, raw)`` runs on the
    reactor with ``conn`` blocking again and ``raw`` every byte read so
    far.  A connection that closes, errs, sends a malformed frame or none
    within ``timeout`` s is closed.  So an ephemeral forward connection
    costs no thread at the serving end."""

    def __init__(self, reactor: Reactor, conn, on_frame,
                 timeout: float = 60.0):
        self.reactor = reactor
        self.conn = conn
        self.on_frame = on_frame
        self.timeout = timeout
        self.buf = bytearray()
        self.timer = None
        reactor.track(self)

    def start(self) -> None:
        """Runs on the reactor thread."""
        try:
            self.conn.setblocking(False)
            self.reactor.register(self.conn, selectors.EVENT_READ,
                                  self._on_event)
            self.timer = self.reactor.call_later(self.timeout, self._drop)
        except (OSError, ValueError):
            self._drop()

    def _on_event(self, mask: int) -> None:
        try:
            data = self.conn.recv(1 << 20)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            data = b""
        if not data:
            self._drop()
            return
        self.buf += data
        try:
            fr = codec.peek_frame(self.buf)
        except (OSError, ValueError, struct.error):
            self._drop()
            return
        if fr is None:
            return
        self._release()
        self.conn.setblocking(True)
        self.on_frame(self.conn, fr[0], fr[1], bytes(self.buf))

    def _release(self) -> None:
        self.reactor.untrack(self)
        if self.timer is not None:
            Reactor.cancel(self.timer)
        self.reactor.unregister(self.conn)

    def abort(self) -> None:
        self._drop()

    def _drop(self) -> None:
        self._release()
        try:
            self.conn.close()
        except OSError:
            pass


class Reply:
    """Answer one served forward on the reactor: ``frame()`` (the FWD_RESP
    frame for the leader's future ``fut``) goes out on ``conn``, which then
    closes, once ``fut`` is done or ``timeout`` s have passed.  So no
    thread waits on the future."""

    def __init__(self, reactor: Reactor, conn, fut: Future, timeout: float,
                 frame):
        self.reactor = reactor
        self.conn = conn
        self.frame = frame
        self.sent = False
        reactor.track(self)
        self.timer = reactor.call_later(timeout, self._send)
        fut.add_done_callback(lambda _: reactor.call_soon(self._send))

    def _send(self) -> None:
        if self.sent:
            return
        self.sent = True
        self.reactor.untrack(self)
        Reactor.cancel(self.timer)
        try:
            self.conn.sendall(self.frame())
        except OSError:
            pass
        self.abort()

    def abort(self) -> None:
        self.sent = True
        try:
            self.conn.close()
        except OSError:
            pass


_reactor_lock = threading.Lock()


def reactor_of(owner, name: str) -> Reactor:
    """``owner``'s reactor (attribute ``_reactor``), started at first use."""
    r = getattr(owner, "_reactor", None)
    if r is None:
        with _reactor_lock:
            r = getattr(owner, "_reactor", None)
            if r is None:
                r = owner._reactor = Reactor(name)
    return r
