"""LocalCluster: N full RaftNodes in one process.

The system-test harness — the generalization of the reference's test
topology (three JVMs on localhost driven by TestNode1-3,
test cluster/TestNode1.java:16-56, README.md:28-33) collapsed into one
process: real node runtimes (device engine + WAL + machines + snapshots)
wired over the loopback transport, with deterministic lockstep ticking,
node kill/restart (crash = close without flushing anything extra; restart
= rebuild from the WAL) and link-level fault injection.
"""

from __future__ import annotations

import os
import shutil
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core.types import EngineConfig, LEADER
from ..machine.file_machine import FileMachineProvider
from ..runtime.node import RaftNode
from ..transport import LinkFaults, LoopbackNetwork, LoopbackTransport


def scaled_election_mul(tick_ms: int, base: float = 3.0,
                        floor_ms: float = 150.0) -> float:
    """Election multiplier with a wall-clock floor for starved hosts.

    On a multi-core host a vote round trip over localhost TCP completes
    well inside one tick, so ``base`` ticks of election timeout are
    plenty.  On a 1-vCPU runner, N node processes/threads time-share one
    core: the leader's heartbeat can sit unscheduled past base*tick_ms,
    followers start elections they would never start on real hardware,
    and the test flakes on election churn (the known
    test_replicated_group_lifecycle_tcp flake, ROADMAP).  Scale the
    multiplier so the election timeout is at least ``floor_ms`` of wall
    clock when cores are scarce; on >=4 cores the base wins unchanged.
    """
    cores = os.cpu_count() or 1
    if cores >= 4:
        return base
    need = floor_ms / max(1.0, float(tick_ms)) * (2.0 / max(2, cores))
    return max(base, need)


def free_ports(n: int) -> List[int]:
    """Reserve n distinct free localhost TCP ports (close-then-reuse; the
    usual bind(0) probe, shared by every TCP-based test)."""
    import socket
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class LocalCluster:
    def __init__(self, cfg: EngineConfig, root: str,
                 provider_factory: Optional[Callable[[int], object]] = None,
                 seed: int = 0,
                 maintain_factory: Optional[Callable[[], object]] = None,
                 store_factory: Optional[Callable[[int], object]] = None,
                 serializer_factory: Optional[Callable[[], object]] = None,
                 transport: str = "loopback",
                 pipeline: Optional[bool] = None,
                 wal_shards: Optional[int] = None,
                 host_workers: Optional[int] = None,
                 device=None):
        """``provider_factory(node_id)`` returns a MachineProvider; defaults
        to FileMachine per group under ``root/node<i>/machines`` (the
        reference's file-append oracle, cluster/cmd/FileMachine.java).
        ``maintain_factory()`` builds a per-node MaintainAgreement (e.g. the
        reference test configs' aggressive all-thresholds-1 snapshot cadence,
        test/resources/raft1.xml:22-28).
        ``store_factory(node_id)`` builds a LogStoreSPI product per node
        (log/spi.py; default: the durable WAL under the node's data dir).
        ``serializer_factory()`` builds a per-node CmdSerializer
        (api/serial.py; default JSON).
        ``transport``: ``"loopback"`` (in-process, default) or ``"tcp"`` —
        real localhost sockets per node, so the framing / sender-queue /
        reader-thread / accumulator plane is exercised under the same
        manual-tick control (the reference's system test runs real TCP,
        test/resources/raft1.xml:3-7).
        ``pipeline`` / ``wal_shards`` / ``host_workers``: forwarded to
        every RaftNode (see RaftNode.__init__; None = the node's
        env-driven defaults).
        ``device``: forwarded to every RaftNode — where its engine runs
        (default the CUDA card, raising without one; ``"cpu"`` for the
        plain version)."""
        self.cfg = cfg
        self.root = root
        self.seed = seed
        self.transport = transport
        self.pipeline = pipeline
        self.wal_shards = wal_shards
        self.host_workers = host_workers
        self.device = device
        self.net = LoopbackNetwork(cfg.n_peers)
        # Shared per-directed-link fault table (transport/faults.py):
        # one instance across every node's transport, so the chaos
        # conductor mutates a single source of truth for both backends.
        self.faults = LinkFaults(cfg.n_peers, seed=seed)
        self.net.faults = self.faults
        self._ports = free_ports(cfg.n_peers) if transport == "tcp" else None
        self.provider_factory = provider_factory or (
            lambda i: FileMachineProvider(
                os.path.join(root, f"node{i}", "machines")))
        self.maintain_factory = maintain_factory
        self.store_factory = store_factory
        self.serializer_factory = serializer_factory
        self.nodes: Dict[int, RaftNode] = {}
        for i in range(cfg.n_peers):
            self.start_node(i)

    # -- lifecycle -----------------------------------------------------------

    def _factory(self, node_id: int):
        def build(node, on_slice, snapshot_provider):
            if self.transport == "tcp":
                from ..transport.tcp import TcpTransport
                peers = {i: ("127.0.0.1", p)
                         for i, p in enumerate(self._ports)}
                return TcpTransport(node_id, peers, self.cfg,
                                    node.template, on_slice,
                                    snapshot_provider,
                                    submit_handler=node.submit,
                                    result_encoder=node.serializer
                                    .encode_result,
                                    read_handler=node.read,
                                    conf_node=node,
                                    faults=self.faults)
            return LoopbackTransport(self.net, node_id, self.cfg,
                                     node.template, on_slice,
                                     snapshot_provider,
                                     submit_handler=node.submit,
                                     result_encoder=node.serializer
                                     .encode_result,
                                     read_handler=node.read,
                                     conf_node=node)
        return build

    def start_node(self, i: int) -> RaftNode:
        assert i not in self.nodes
        node = RaftNode(
            self.cfg, i, os.path.join(self.root, f"node{i}"),
            self.provider_factory(i), self._factory(i), seed=self.seed,
            maintain=(self.maintain_factory()
                      if self.maintain_factory else None),
            store=(self.store_factory(i) if self.store_factory else None),
            serializer=(self.serializer_factory()
                        if self.serializer_factory else None),
            pipeline=self.pipeline,
            wal_shards=self.wal_shards,
            host_workers=self.host_workers,
            device=self.device)
        node.transport.start()
        self.nodes[i] = node
        return node

    def kill_node(self, i: int) -> None:
        """Simulated crash: drop off the network and release files.  No
        graceful flush beyond what each tick already made durable (close
        joins in-flight snapshot workers so the native WAL handle is never
        used after free)."""
        node = self.nodes.pop(i)
        node.close()

    def restart_node(self, i: int) -> RaftNode:
        return self.start_node(i)

    def close(self) -> None:
        for i in list(self.nodes):
            self.kill_node(i)

    # -- stepping ------------------------------------------------------------

    def tick(self, rounds: int = 1) -> None:
        """Lockstep: every live node ticks once per round (node order fixed;
        loopback delivery is immediate, so intra-round ordering mirrors the
        reference's asynchronous delivery)."""
        for _ in range(rounds):
            for node in self.nodes.values():
                node.tick()

    def tick_until(self, pred: Callable[[], bool], max_rounds: int = 500,
                   what: str = "condition") -> None:
        for _ in range(max_rounds):
            if pred():
                return
            self.tick()
        raise AssertionError(f"{what} not reached in {max_rounds} rounds")

    def replay_schedule(self, sched, audit: Optional[Callable[[int], None]]
                        = None) -> None:
        """Host-path nemesis parity: drive the SAME FaultSchedule the
        fused device scan consumes (core/sim.py run_cluster_ticks_nemesis)
        against the full event-loop runtime — real RaftNodes, WAL, state
        machines, codec round-trips over the loopback network.  Tick t:

        * ``crash[t, n]``  -> kill_node + restart_node (rebuild from WAL:
          the host mirror of the engine's in-scan ``crash_restart``);
        * ``link_up[t]``   -> bulk connectivity matrix on the network;
        * ``dup[t]``       -> duplicate-delivery links on the network;
        * ``stall[t, n]``  -> node n simply does not tick (its engine
          clock, timers and sends all freeze, like the device stall).

        ``audit(t)`` runs after every tick (invariant checks, snapshots).
        Used for CPU/TPU cross-validation: the same seed's schedule must
        keep both the vectorized and the event-loop paths safe.
        """
        import numpy as np
        link = np.asarray(sched.link_up)
        crash = np.asarray(sched.crash)
        stall = np.asarray(sched.stall)
        dup = np.asarray(sched.dup)
        try:
            for t in range(link.shape[0]):
                for n in np.nonzero(crash[t])[0].tolist():
                    if n in self.nodes:
                        self.kill_node(int(n))
                        self.restart_node(int(n))
                self.net.set_conn(link[t])
                self.net.set_dup(dup[t])
                for i, node in list(self.nodes.items()):
                    if not stall[t, i]:
                        node.tick()
                if audit is not None:
                    audit(t)
        finally:
            self.net.heal()
            self.net.set_dup(np.zeros((self.cfg.n_peers,) * 2, bool))

    # -- queries -------------------------------------------------------------

    def leader_of(self, group: int) -> Optional[int]:
        """Current leader (highest term if a stale minority leader is still
        deposed-but-unaware).  The election-safety invariant is at most one
        leader per (group, TERM) — two leaders at the SAME term is split
        brain (reference one-leader-per-term asserts, Follower.java:48-50,
        Leader.java:79-81); a stale lower-term claimant is legal Raft."""
        leaders = [(i, int(n.h_term[group])) for i, n in self.nodes.items()
                   if n.h_role[group] == LEADER]
        terms = [t for _, t in leaders]
        assert len(terms) == len(set(terms)), \
            f"split brain in group {group}: same-term leaders {leaders}"
        if not leaders:
            return None
        return max(leaders, key=lambda it: it[1])[0]

    def wait_leader(self, group: int, max_rounds: int = 500) -> int:
        self.tick_until(lambda: self.leader_of(group) is not None,
                        max_rounds, f"leader for group {group}")
        return self.leader_of(group)

    def submit_via_leader(self, group: int, payload: bytes,
                          max_rounds: int = 500):
        """Submit to whoever currently leads, retrying through elections.

        A retry happens ONLY after the previous attempt failed (NotLeader /
        aborted); a still-pending future is never abandoned and resubmitted,
        which could commit the command twice."""
        for _ in range(max_rounds):
            lead = self.leader_of(group)
            if lead is None:
                self.tick()
                continue
            fut = self.nodes[lead].submit(group, payload)
            for _ in range(max_rounds):
                if fut.done():
                    break
                self.tick()
            if not fut.done():
                raise AssertionError(
                    f"submission stuck pending in group {group}")
            if fut.exception() is None:
                return fut.result()
            self.tick()  # leadership moved: drive on, then retry
        raise AssertionError("submission never committed")

    def machine_file(self, node: int, group: int) -> str:
        return os.path.join(self.root, f"node{node}", "machines",
                            f"group_{group}.txt")

    def machine_lines(self, node: int, group: int) -> List[str]:
        path = self.machine_file(node, group)
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return f.readlines()

    def command_lines(self, node: int, group: int) -> List[str]:
        """machine_lines MINUS election no-ops (empty payloads — Raft §8,
        core/step.py phase 3): what client commands actually applied, for
        tests that assert content without depending on how many elections
        the run happened to need."""
        return [l for l in self.machine_lines(node, group)
                if l.split(":", 1)[1].strip()]

    def command_payloads(self, node: int, group: int) -> List[str]:
        return [l.split(":", 1)[1].strip()
                for l in self.command_lines(node, group)]

    def assert_file_parity(self, group: int, require_progress: bool = True
                           ) -> None:
        """The reference's whole-system oracle: replica output files must
        agree on their common prefix, and live nodes that applied everything
        must be byte-identical (README.md:28-33)."""
        files = {i: self.machine_lines(i, group) for i in self.nodes}
        lens = {i: len(ls) for i, ls in files.items()}
        if require_progress:
            assert max(lens.values()) > 0, "no entries applied anywhere"
        base = max(files.values(), key=len)
        for i, ls in files.items():
            assert ls == base[:len(ls)], \
                f"node {i} file diverges from longest replica in group {group}"
