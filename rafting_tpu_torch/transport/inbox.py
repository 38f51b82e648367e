"""InboxAccumulator: delivers asynchronously arriving peer slices to the
dense per-tick inbox the engine consumes.

Nodes tick independently; a peer may deliver zero, one or several slices
between two local ticks.  Slices are queued per source and drained **one
per source per tick, in arrival order** — the engine sees exactly the
per-tick message planes the sender emitted, just time-shifted.  Ordered
delivery is what makes the leader's pipelined AppendEntries window sound
(several un-acked batches in flight per (group, peer), core/step.py
phase 9): batch k+1's prev-entry check assumes batch k was offered first,
the same in-order contract the reference gets from one TCP connection per
peer (transport/EventNode.java:39-120).

Catch-up: a consumer that falls behind (tick-rate drift, a JIT-compile
stall) must not lag permanently — one-slice-per-tick service can never
drain a standing backlog under sustained traffic, and stale delivery makes
every reply look timed out.  When a source's queue exceeds
COLLAPSE_BACKLOG, the whole backlog is collapsed into one slice,
newest-wins per (kind, group).  Collapsing reorders nothing the protocol
can't absorb: replies/votes are idempotent, and a collapsed (= partially
lost) AppendEntries stream makes the follower reject at the gap, which
resets the leader's window and resends from the ack base — the engine's
normal loss recovery (the reference's per-request timeouts + stale-reply
term fencing, transport/rpc/AsyncService.java:120-132,
context/member/Leader.java:224-227).

AppendEntries payload bytes ride with their frame and are staged here until
the engine accepts the entries (StepInfo.appended_from/to), at which point
the runtime moves them into the durable LogStore.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, Tuple

import numpy as np

from .codec import KIND_FIELDS


class InboxAccumulator:
    MAX_QUEUED_SLICES = 64   # per source; beyond this, new slices drop
    COLLAPSE_BACKLOG = 3     # backlog beyond this collapses to one slice

    def __init__(self, cfg, template: Dict[str, Tuple[np.dtype, tuple]]):
        self.cfg = cfg
        self.template = template
        self._lock = threading.Lock()
        # src -> FIFO of (fields, payloads) slices, fields in the sparse
        # codec.unpack_slice format: field -> (group cols, values).
        self._queues: Dict[int, Deque[tuple]] = {}

    def merge(self, src: int,
              fields: Dict[str, Tuple[np.ndarray, np.ndarray]],
              payloads: Dict[int, Tuple[int, list]]) -> None:
        """Enqueue one unpacked slice from peer ``src`` (payloads as
        per-group contiguous runs, codec.unpack_slice format)."""
        with self._lock:
            q = self._queues.get(src)
            if q is None:
                q = self._queues[src] = deque()
            if len(q) >= self.MAX_QUEUED_SLICES:
                return   # = network loss; sender's resend timeout recovers
            q.append((fields, payloads))

    def drain(self) -> Tuple[Dict[str, np.ndarray],
                             Dict[Tuple[int, int], Tuple[int, list]]]:
        """Pop the oldest queued slice of every source and merge them into
        one dense inbox (different sources occupy disjoint [src, :] rows,
        so one slice per source never collides).  A source whose backlog
        exceeds COLLAPSE_BACKLOG has its entire queue collapsed instead
        (newest wins per lane) so lag stays bounded.

        Returns the dense arrays (ownership transfers to the caller) and
        the popped slices' payload runs keyed (src, group) — newest-wins
        per group under collapse, matching the field planes."""
        P, G = self.cfg.n_peers, self.cfg.n_groups
        arrays: Dict[str, np.ndarray] = {
            name: np.zeros((P, G) + trail, dt)
            for name, (dt, trail) in self.template.items()
        }
        payloads: Dict[Tuple[int, int], Tuple[int, list]] = {}
        with self._lock:
            for src, q in self._queues.items():
                if not q:
                    continue
                if len(q) > self.COLLAPSE_BACKLOG:
                    batch, q_new = list(q), deque()
                    self._queues[src] = q_new
                else:
                    batch = [q.popleft()]
                for fields, pl in batch:
                    for name, (cols, vals) in fields.items():
                        arrays[name][src, cols] = vals
                    for g, run in pl.items():
                        payloads[(src, g)] = run
        return arrays, payloads

    @property
    def has_traffic(self) -> bool:
        with self._lock:
            return any(self._queues.values())
