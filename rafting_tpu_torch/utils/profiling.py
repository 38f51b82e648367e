"""Device profiling hooks of the port: ``torch.profiler`` in place of the
JAX profiler, with the same entry points and environment switch as
``rafting_tpu/utils/profiling.py``.

Two entry points:

* :func:`device_trace` — context manager wrapping a measurement region in
  a ``torch.profiler.profile`` whose chrome trace lands in ``log_dir``.
* :meth:`TickProfiler` — bounded capture of a live node's tick loop: each
  tick becomes a ``record_function`` range so host phases and the device
  kernels line up on one timeline.  Armed via RaftNode.profile_ticks() or
  the RAFT_PROFILE_DIR environment variable.

Traces are written with ``export_chrome_trace``
(``trace_<pid>_<ns>.json`` under the directory).  CUDA activity is
recorded when a card is present.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional


def _profile():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _export(prof, log_dir: str) -> None:
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Trace the enclosed region to ``log_dir`` (no-op if falsy)."""
    if not log_dir:
        yield
        return
    with _profile() as prof:
        yield
    _export(prof, log_dir)


# The torch profiler is process-global (one kineto session at a time), so
# at most one TickProfiler may hold a trace at a time — in-process
# multi-node harnesses construct several RaftNodes, and with
# RAFT_PROFILE_DIR set each would otherwise try to arm.
_TRACE_OWNER: list = []


class TickProfiler:
    """Capture N ticks of a node runtime into a profiler trace.

    Start/stop are explicit and bounded (a trace left running grows without
    bound); each tick is annotated so per-phase host time and device time
    correlate in the viewer.  Only the first profiler to arm in a process
    captures — later arms are silently skipped (the trace is process-global).
    """

    def __init__(self):
        self._remaining = 0
        self._active = False
        self._prof = None
        self._dir = ""

    def arm(self, log_dir: str, n_ticks: int = 64) -> None:
        if self._active or not log_dir or n_ticks <= 0 or _TRACE_OWNER:
            return
        os.makedirs(log_dir, exist_ok=True)
        prof = _profile()
        try:
            prof.start()
        except RuntimeError:  # someone else (outside this module) is tracing
            return
        _TRACE_OWNER.append(self)
        self._prof, self._dir = prof, log_dir
        self._remaining = n_ticks
        self._active = True

    @classmethod
    def from_env(cls) -> "TickProfiler":
        """Armed from RAFT_PROFILE_DIR / RAFT_PROFILE_TICKS if set."""
        p = cls()
        d = os.environ.get("RAFT_PROFILE_DIR", "")
        if d:
            p.arm(d, int(os.environ.get("RAFT_PROFILE_TICKS", "64")))
        return p

    def step(self, tick_no: int):
        """Context for one tick; stops the trace after the armed budget."""
        if not self._active:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(f"raft_tick#{tick_no}")

    def after_tick(self) -> None:
        if not self._active:
            return
        self._remaining -= 1
        if self._remaining <= 0:
            self._stop()

    def _stop(self) -> None:
        prof = self._prof
        self._active, self._prof = False, None
        if self in _TRACE_OWNER:
            _TRACE_OWNER.remove(self)
        prof.stop()
        _export(prof, self._dir)

    def close(self) -> None:
        if self._active:
            self._stop()
