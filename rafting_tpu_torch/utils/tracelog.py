"""Flight-recorder decoding: device event rings -> structured timelines.

The device engine writes per-group event rings (core/types.py TraceState,
emitted branchlessly at core/step.py phase boundaries).  This module is
the host half: a stateless decoder for raw rings (post-mortem dumps, the
tools/dump_timeline.py CLI) and an incremental ``TraceLog`` accumulator
the node runtime drains each tick — turning device events into per-group
timelines plus *labeled* metrics the aggregate counters cannot express
(elections by cause, leader churn per group), the per-replica timeline
currency "Paxos vs Raft" (arxiv 2004.05074) identifies as the real
consensus-debugging need.

Dependency-free on purpose (numpy + stdlib json), like utils/metrics.py:
the decoder must work in a post-mortem context with no engine import.
This module therefore OWNS the event-kind taxonomy (core/types.py imports
it back for the kernel), imports nothing from the engine, and
tools/dump_timeline.py loads it by file path — a box with only
numpy + stdlib can decode dumps.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Dict, List, Optional

import numpy as np

# Flight-recorder event kinds (the device kernel in core/step.py emits,
# testkit/oracle.py mirrors; see core/types.py for the canonical
# intra-tick emission order and per-kind aux payloads).
TR_TERM_BUMP = 1
TR_STEPPED_DOWN = 2
TR_BECAME_PRE_CANDIDATE = 3
TR_BECAME_CANDIDATE = 4
TR_BECAME_LEADER = 5
TR_SNAPSHOT_INSTALL = 6
TR_COMMIT_ADVANCE = 7
TR_READ_RELEASE = 8
TR_CRASH_RESTART = 9
# Membership plane (Raft §6 joint consensus + §3.10 leadership transfer).
# CONF_CHANGE_ENTER fires whenever the group's ACTIVE config changes —
# enter-joint, auto-leave, learner-set change, follower adoption, and
# truncation rollback all count; aux = the new packed config word.
# CONF_CHANGE_COMMIT fires when the commit index first covers the active
# config entry; aux = that entry's log index.  LEADER_TRANSFER fires on
# the leader the tick it sends TimeoutNow; aux = the target peer.
TR_CONF_CHANGE_ENTER = 10
TR_CONF_CHANGE_COMMIT = 11
TR_LEADER_TRANSFER = 12

# Packed-config-word layout (§6 membership plane).  OWNED here like the
# event taxonomy — the decoder must unpack config words with no engine
# import, and core/types.py imports these back for the kernel, so both
# sides share one definition.
CONF_MASK_BITS = 10
CONF_MASK = (1 << CONF_MASK_BITS) - 1
CONF_NEW_SHIFT = CONF_MASK_BITS
CONF_LRN_SHIFT = 2 * CONF_MASK_BITS
CONF_FLAG = 1 << 30

TRACE_EVENTS = {
    TR_TERM_BUMP: "TERM_BUMP",
    TR_STEPPED_DOWN: "STEPPED_DOWN",
    TR_BECAME_PRE_CANDIDATE: "BECAME_PRE_CANDIDATE",
    TR_BECAME_CANDIDATE: "BECAME_CANDIDATE",
    TR_BECAME_LEADER: "BECAME_LEADER",
    TR_SNAPSHOT_INSTALL: "SNAPSHOT_INSTALL",
    TR_COMMIT_ADVANCE: "COMMIT_ADVANCE",
    TR_READ_RELEASE: "READ_RELEASE",
    TR_CRASH_RESTART: "CRASH_RESTART",
    TR_CONF_CHANGE_ENTER: "CONF_CHANGE_ENTER",
    TR_CONF_CHANGE_COMMIT: "CONF_CHANGE_COMMIT",
    TR_LEADER_TRANSFER: "LEADER_TRANSFER",
}

__all__ = ["TraceEvent", "TraceLog", "decode_group", "trace_to_numpy",
           "save_dump", "load_dump", "TRACE_EVENTS",
           "TR_TERM_BUMP", "TR_STEPPED_DOWN", "TR_BECAME_PRE_CANDIDATE",
           "TR_BECAME_CANDIDATE", "TR_BECAME_LEADER", "TR_SNAPSHOT_INSTALL",
           "TR_COMMIT_ADVANCE", "TR_READ_RELEASE", "TR_CRASH_RESTART",
           "TR_CONF_CHANGE_ENTER", "TR_CONF_CHANGE_COMMIT",
           "TR_LEADER_TRANSFER"]


class TraceEvent(dict):
    """One decoded event word: {seq, tick, event, kind, term, aux}.

    A dict subclass so timelines serialize to JSON as-is (HTTP timeline
    endpoint, dump CLI) while still reading naturally in test code."""

    __slots__ = ()

    @classmethod
    def make(cls, seq: int, tick: int, kind: int, term: int,
             aux: int) -> "TraceEvent":
        return cls(seq=seq, tick=tick, kind=kind,
                   event=TRACE_EVENTS.get(kind, f"UNKNOWN_{kind}"),
                   term=term, aux=aux)


def trace_to_numpy(trace) -> Dict[str, np.ndarray]:
    """Pull a TraceState (torch tensors on any device, or numpy; [G, D]
    or stacked [N, G, D]) into plain numpy arrays keyed by lane name.
    A tensor is copied to the host explicitly (``.cpu()``); this module
    still imports no torch."""
    def host(x):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
    return {name: host(getattr(trace, name))
            for name in ("tick", "kind", "term", "aux", "n")}


def decode_group(lanes: Dict[str, np.ndarray], g: int, since: int = 0,
                 node: Optional[int] = None):
    """Decode one group's ring into ``(events, dropped)``.

    ``lanes`` is a ``trace_to_numpy`` dict (2-D [G, D] lanes, or 3-D
    [N, G, D] stacked — then ``node`` selects the node).  ``since`` is
    the caller's drained-through event count: only events with sequence
    >= ``since`` are returned, and ``dropped`` counts events the ring
    overwrote before they could be read (n - since > depth)."""
    idx = (g,) if lanes["n"].ndim == 1 else ((0 if node is None else node), g)
    n = int(lanes["n"][idx])
    tick, kind = lanes["tick"][idx], lanes["kind"][idx]
    term, aux = lanes["term"][idx], lanes["aux"][idx]
    D = tick.shape[0]
    first = max(since, n - D)
    dropped = first - since
    events = [TraceEvent.make(seq, int(tick[seq % D]), int(kind[seq % D]),
                              int(term[seq % D]), int(aux[seq % D]))
              for seq in range(first, n)]
    return events, dropped


class TraceLog:
    """Incremental host accumulator over repeated ring drains.

    ``ingest`` is called with the freshly pulled lanes each sync; it
    appends only the NEW events per group (tracked by the drained-through
    count), keeps a bounded per-group timeline, and returns the tick's
    labeled-metric deltas so the caller can fold them into its Metrics
    registry:

    * ``elections_won``            — BECAME_LEADER events
    * ``elections_cause_timer``    — candidacies from timer expiry
    * ``elections_cause_prevote``  — candidacies from a PreVote majority
    * ``leader_churn``             — leadership changes past each group's
                                     first election (the stability signal)
    * ``elections_cause_transfer`` — candidacies from TimeoutNow (§3.10
                                     leadership transfer)
    * ``crash_restarts``           — in-scan crash-restart events
    * ``conf_changes_entered``     — active-config changes (ENTER events)
    * ``conf_changes_committed``   — config entries whose commit landed
    * ``leader_transfers``         — TimeoutNow sends (LEADER_TRANSFER)
    * ``trace_events``             — everything decoded this drain
    * ``trace_dropped``            — events the ring overwrote undrained
    """

    def __init__(self, cfg, timeline_cap: int = 256):
        self.depth = int(cfg.trace_depth)
        self.timeline_cap = timeline_cap
        self._seen = np.zeros(cfg.n_groups, np.int64)
        self._timelines: Dict[int, deque] = {}
        self._led_before = np.zeros(cfg.n_groups, bool)
        self.dropped_total = 0
        # ingest runs on the tick thread; timeline() is read by HTTP
        # handler threads (runtime/obsrv.py) — a lock keeps a scrape from
        # observing a deque mid-mutation.
        self._lock = threading.Lock()

    def moved(self, n_lane) -> bool:
        """Cheap pre-drain check against just the [G] event-count lane:
        lets the runtime skip pulling the full rings on quiet ticks."""
        return bool((np.asarray(n_lane).astype(np.int64)
                     > self._seen).any())

    def ingest(self, trace) -> Dict[str, int]:
        if trace is None or self.depth == 0:
            return {}
        with self._lock:
            return self._ingest(trace)

    def _ingest(self, trace) -> Dict[str, int]:
        lanes = trace_to_numpy(trace)
        deltas = {"elections_won": 0, "elections_cause_timer": 0,
                  "elections_cause_prevote": 0,
                  "elections_cause_transfer": 0, "leader_churn": 0,
                  "crash_restarts": 0, "conf_changes_entered": 0,
                  "conf_changes_committed": 0, "leader_transfers": 0,
                  "trace_events": 0, "trace_dropped": 0}
        moved = np.nonzero(lanes["n"].astype(np.int64) > self._seen)[0]
        for g in moved.tolist():
            events, dropped = decode_group(lanes, g,
                                           since=int(self._seen[g]))
            self._seen[g] = int(lanes["n"][g])
            deltas["trace_dropped"] += dropped
            deltas["trace_events"] += len(events)
            tl = self._timelines.get(g)
            if tl is None:
                tl = self._timelines[g] = deque(maxlen=self.timeline_cap)
            for ev in events:
                tl.append(ev)
                k = ev["kind"]
                if k == TR_BECAME_LEADER:
                    deltas["elections_won"] += 1
                    if self._led_before[g]:
                        deltas["leader_churn"] += 1
                    self._led_before[g] = True
                elif k == TR_BECAME_CANDIDATE:
                    # aux: 0 = PreVote majority, 1 = timer expiry,
                    # 2 = TimeoutNow (leadership transfer).
                    cause = ("elections_cause_prevote",
                             "elections_cause_timer",
                             "elections_cause_transfer")[min(ev["aux"], 2)]
                    deltas[cause] += 1
                elif k == TR_CRASH_RESTART:
                    deltas["crash_restarts"] += 1
                elif k == TR_CONF_CHANGE_ENTER:
                    deltas["conf_changes_entered"] += 1
                elif k == TR_CONF_CHANGE_COMMIT:
                    deltas["conf_changes_committed"] += 1
                elif k == TR_LEADER_TRANSFER:
                    deltas["leader_transfers"] += 1
        self.dropped_total += deltas["trace_dropped"]
        return deltas

    def timeline(self, g: int) -> List[TraceEvent]:
        with self._lock:
            return list(self._timelines.get(g, ()))

    def reset_group(self, g: int) -> None:
        """Lane purge support: a destroyed lane's recorder restarts from
        event 0 (the runtime zeroes the device ring with the lane)."""
        with self._lock:
            self._seen[g] = 0
            self._timelines.pop(g, None)
            self._led_before[g] = False


def format_aux(kind: int, aux: int) -> str:
    """Human rendering of an event's aux payload (decoder-owned, like the
    taxonomy itself): config words decode into voter/new/learner masks,
    candidacy causes into names — everything else prints raw."""
    if kind == TR_CONF_CHANGE_ENTER:
        v = aux & CONF_MASK
        n = (aux >> CONF_NEW_SHIFT) & CONF_MASK
        l = (aux >> CONF_LRN_SHIFT) & CONF_MASK
        s = f"voters={v:b}"
        if n:
            s += f" new={n:b}"
        if l:
            s += f" learners={l:b}"
        return s
    if kind == TR_BECAME_CANDIDATE:
        return ("prevote", "timer", "timeout_now")[min(int(aux), 2)]
    return str(aux)


# ------------------------------------------------------------------ dumps --

def _open_dump(path: str, mode: str = "rt"):
    """Gzip-transparent artifact open: a ``.gz`` path (de)compresses,
    and a bare path being READ falls back to its ``.gz`` sibling when
    only the compressed form exists on disk."""
    import gzip
    import os
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    if "r" in mode and not os.path.exists(path) \
            and os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", mode)
    return open(path, mode)


def save_dump(path: str, trace, meta: Optional[dict] = None) -> None:
    """Persist raw rings as a JSON artifact for post-mortem decoding
    (tools/dump_timeline.py).  Accepts a TraceState ([G, D] single node or
    [N, G, D] stacked cluster) or a ``trace_to_numpy`` dict.  A ``.gz``
    path writes gzip-compressed (ring dumps are big and repetitive)."""
    lanes = trace if isinstance(trace, dict) else trace_to_numpy(trace)
    doc = {name: np.asarray(arr).tolist() for name, arr in lanes.items()}
    doc["_meta"] = dict(meta or {})
    with _open_dump(path, "wt") as f:
        json.dump(doc, f)


def load_dump(path: str) -> Dict[str, np.ndarray]:
    with _open_dump(path) as f:
        doc = json.load(f)
    return {name: np.asarray(doc[name], np.int64)
            for name in ("tick", "kind", "term", "aux", "n")}
