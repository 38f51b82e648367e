"""RaftConfig: validated user-facing configuration.

Same semantics as the reference's XML-loaded immutable config
(support/RaftConfig.java:27-226):

* all timing derives from a ``tick`` base with multipliers, validated as
  ``broadcast < heartbeat < election`` (RaftConfig.java:116-118);
* election timeouts are randomized in [T, 2T) — in this engine that draw
  happens on-device per group per reset (core/step.py), matching
  RaftConfig.electionTimeout re-drawing on every read (187-190);
* ``pre_vote`` feature flag (97-100);
* snapshot cadence block (120-135) feeding the maintain policy;
* storage directory layout (143-158);
* cluster = 1 local + N remote ``raft://host:port`` URIs with an odd
  total-size check (83-95);
* peer-health metrics block: ``avail_critical_point`` consecutive-failure
  threshold and ``recovery_cool_down`` (137-141).

Loadable from an XML file with reference-shaped element names or built
directly; both paths funnel through the same validation.
"""

from __future__ import annotations

import dataclasses
import os
import re
import xml.etree.ElementTree as ET
from typing import List, Optional, Tuple

from ..core.types import EngineConfig

_URI = re.compile(r"^raft://([^:/]+):(\d+)$")


def _parse_uri(uri: str) -> Tuple[str, int]:
    m = _URI.match(uri.strip())
    if not m:
        raise ValueError(f"bad raft URI: {uri!r} (want raft://host:port)")
    return m.group(1), int(m.group(2))


@dataclasses.dataclass(frozen=True)
class RaftConfig:
    # cluster topology (reference RaftConfig.java:83-95)
    local: str                                  # raft://host:port of this node
    peers: Tuple[str, ...]                      # remote raft://host:port URIs
    # timing (reference RaftConfig.java:171-198): tick in ms, multipliers
    tick_ms: int = 100
    heartbeat_mul: float = 1.0
    election_mul: float = 3.0
    broadcast_mul: float = 0.5
    pre_vote: bool = True
    # engine shapes
    n_groups: int = 16
    log_slots: int = 64
    batch: int = 8
    max_submit: int = 8
    # snapshot / compaction cadence (reference RaftConfig.java:120-135)
    state_change_threshold: int = 64
    dirty_log_tolerance: int = 16
    snap_min_interval_ticks: int = 20
    compact_min_interval_ticks: int = 10
    compact_slack: int = 8
    # peer-health metrics (reference RaftConfig.java:137-141)
    avail_critical_point: int = 3
    recovery_cool_down_ticks: int = 10
    # end-to-end commit-latency SLO target (milliseconds): the latency
    # plane's burn gauges and /healthz latency block measure against it
    # (utils/latency.py; beyond-reference — the reference has no latency
    # instrumentation at all).
    latency_slo_ms: float = 500.0
    # submission backpressure (reference EventLoop queue capacity + busy
    # threshold, support/EventLoop.java:16-17, 136-138)
    group_queue_cap: int = 512
    total_queue_cap: int = 500_000
    busy_threshold: int = 1_000
    # storage layout (reference RaftConfig.java:143-158)
    data_dir: str = "raft-data"
    seed: int = 0

    def __post_init__(self):
        if len(self.peers) % 2 == 1:
            # total = remotes + 1 must be odd for clean majorities
            # (reference odd-size check, RaftConfig.java:92-94).
            raise ValueError(
                f"cluster size must be odd (got {len(self.peers) + 1})")
        if not (self.broadcast_mul < self.heartbeat_mul < self.election_mul):
            raise ValueError("need broadcast < heartbeat < election "
                             "(reference RaftConfig.java:116-118)")
        if self.tick_ms <= 0:
            raise ValueError("tick_ms must be positive")
        if self.latency_slo_ms <= 0:
            raise ValueError("latency_slo_ms must be positive")
        if self.group_queue_cap < 1:
            raise ValueError("group_queue_cap must be >= 1")
        if self.busy_threshold < 0:
            raise ValueError("busy_threshold must be >= 0")
        if self.total_queue_cap <= self.busy_threshold:
            raise ValueError(
                "total_queue_cap must exceed busy_threshold, or every "
                "submission would fail with BusyLoopError")
        _parse_uri(self.local)
        for p in self.peers:
            _parse_uri(p)

    # -- derived views -------------------------------------------------------

    @property
    def cluster_size(self) -> int:
        return len(self.peers) + 1

    def node_addresses(self) -> List[Tuple[str, int]]:
        """All node addresses sorted for a stable id assignment: node id =
        rank of its URI (the reference derives identity from config order;
        sorting makes every node compute the same ids)."""
        addrs = sorted(_parse_uri(u) for u in (self.local,) + self.peers)
        return addrs

    @property
    def node_id(self) -> int:
        return self.node_addresses().index(_parse_uri(self.local))

    def engine_config(self) -> EngineConfig:
        """Tick-denominated engine shape: wall-clock timing maps onto the
        abstract tick the device engine counts in."""
        import math
        election_ticks = max(2, round(self.election_mul))
        heartbeat_ticks = max(1, round(self.heartbeat_mul))
        # broadcast_mul is the reference's per-RPC (broadcast) timeout in
        # ticks (RaftConfig.broadcastTimeout, support/RaftConfig.java:
        # 196-198); the engine analog is the un-acked-window resend
        # deadline.  Floor of 3: a lockstep send->deliver->reply round trip
        # takes 3 ticks, so a shorter deadline would resend every tick.
        rpc_timeout = max(3, math.ceil(self.broadcast_mul))
        return EngineConfig(
            n_groups=self.n_groups,
            n_peers=self.cluster_size,
            log_slots=self.log_slots,
            batch=self.batch,
            max_submit=self.max_submit,
            election_ticks=election_ticks,
            heartbeat_ticks=heartbeat_ticks,
            rpc_timeout_ticks=rpc_timeout,
            pre_vote=self.pre_vote,
            avail_crit=self.avail_critical_point,
            recovery_ticks=self.recovery_cool_down_ticks,
        )

    def maintain(self):
        from ..snapshot.policy import MaintainAgreement
        return MaintainAgreement(
            self.n_groups,
            state_change_threshold=self.state_change_threshold,
            dirty_log_tolerance=self.dirty_log_tolerance,
            snap_min_interval=self.snap_min_interval_ticks,
            compact_min_interval=self.compact_min_interval_ticks,
            compact_slack=self.compact_slack,
        )

    @property
    def tick_interval(self) -> float:
        return self.tick_ms / 1000.0


def load_xml_config(path: str) -> RaftConfig:
    """Load an XML config with reference-shaped element names (the
    reference validates via XPath, support/RaftConfig.java:63-169;
    here the dataclass validation plays that role).

    Schema::

        <raft>
          <cluster>
            <local>raft://127.0.0.1:6001</local>
            <remote>raft://127.0.0.1:6002</remote>
            <remote>raft://127.0.0.1:6003</remote>
          </cluster>
          <timing tick="100" heartbeat="1" election="3" broadcast="0.5"
                  pre-vote="true"/>
          <engine groups="16" log-slots="64" batch="8" max-submit="8"/>
          <snapshot state-change-threshold="64" dirty-log-tolerance="16"
                    snap-min-interval="20" compact-min-interval="10"
                    slack="8"/>
          <metrics avail-critical-point="3" recovery-cool-down="10"
                   latency-slo-ms="500"/>
          <storage dir="/data/raft"/>
        </raft>
    """
    root = ET.parse(path).getroot()

    def attr(tag, name, default, cast):
        el = root.find(tag)
        if el is None or el.get(name) is None:
            return default
        v = el.get(name)
        return cast(v)

    def boolean(v: str) -> bool:
        return v.strip().lower() in ("1", "true", "yes", "on")

    cluster = root.find("cluster")
    if cluster is None or cluster.find("local") is None:
        raise ValueError(f"{path}: missing <cluster><local>")
    local = cluster.find("local").text.strip()
    remotes = tuple(el.text.strip() for el in cluster.findall("remote"))
    return RaftConfig(
        local=local, peers=remotes,
        tick_ms=attr("timing", "tick", 100, int),
        heartbeat_mul=attr("timing", "heartbeat", 1.0, float),
        election_mul=attr("timing", "election", 3.0, float),
        broadcast_mul=attr("timing", "broadcast", 0.5, float),
        pre_vote=attr("timing", "pre-vote", True, boolean),
        n_groups=attr("engine", "groups", 16, int),
        log_slots=attr("engine", "log-slots", 64, int),
        batch=attr("engine", "batch", 8, int),
        max_submit=attr("engine", "max-submit", 8, int),
        state_change_threshold=attr(
            "snapshot", "state-change-threshold", 64, int),
        dirty_log_tolerance=attr("snapshot", "dirty-log-tolerance", 16, int),
        snap_min_interval_ticks=attr("snapshot", "snap-min-interval", 20, int),
        compact_min_interval_ticks=attr(
            "snapshot", "compact-min-interval", 10, int),
        compact_slack=attr("snapshot", "slack", 8, int),
        avail_critical_point=attr("metrics", "avail-critical-point", 3, int),
        recovery_cool_down_ticks=attr("metrics", "recovery-cool-down", 10,
                                      int),
        latency_slo_ms=attr("metrics", "latency-slo-ms", 500.0, float),
        group_queue_cap=attr("engine", "group-queue-cap", 512, int),
        total_queue_cap=attr("engine", "total-queue-cap", 500_000, int),
        busy_threshold=attr("engine", "busy-threshold", 1_000, int),
        data_dir=attr("storage", "dir", "raft-data", str),
    )
