"""Seeded chaos conductor: every nemesis under one replayable timeline.

The Jepsen control plane for this repo.  One seeded, audited timeline
composes every fault family the codebase owns against the REAL runtime
(RaftNode + WAL + machines + transport), while recording client
histories (testkit/history.py) for the linearizability checker
(testkit/linz.py):

* network  — asymmetric cuts, full partitions, flaky links
  (drop/dup/delay/reorder) through the shared LinkFaults table
  (transport/faults.py) — both loopback and TCP backends;
* process  — crash (node close, nothing flushed beyond what ticks made
  durable) + restart (WAL/snapshot rebuild) via LocalCluster, and REAL
  ``kill -9`` of separate OS processes via :class:`ProcCluster`;
* storage  — engine-level I/O faults (slow fsync, fail-stop EIO)
  through ``LogStore.set_fault`` (the testkit/faultfs.py plane);
* clock    — stall windows: a node simply does not tick, freezing its
  engine clock, timers and lease receipts;
* control  — membership churn (demote-to-learner / promote-back) and
  leadership transfers through the §6 joint-consensus plane.

Determinism: :func:`plan_chaos` is a pure function of (shape, seed) —
the same seed yields the byte-identical timeline
(:func:`timeline_json`), and the conductor applies events at fixed tick
boundaries over the lockstep harness, so a failing soak replays.  The
conductor records every applied event in ``.applied`` — the audit an
artifact embeds next to the history and the checker verdict
(tools/chaos_run.py).
"""

from __future__ import annotations

import errno
import json
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from random import Random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api.anomaly import UnavailableError, as_refusal, is_refusal
from .harness import LocalCluster, free_ports
from .history import History

__all__ = [
    "ChaosEvent", "plan_chaos", "plan_leader_isolate", "timeline_json",
    "ChaosConductor", "StubHost", "make_recording_stub", "KVWorkload",
    "TransferWorkload", "ProcCluster",
]


# ---------------------------------------------------------------- timeline --

@dataclass(frozen=True)
class ChaosEvent:
    """One nemesis action at one tick.  ``a``/``b`` are node ids (or a
    group id where noted), ``args`` carries kind-specific payload."""
    tick: int
    kind: str
    a: int = -1
    b: int = -1
    args: tuple = ()

    def to_dict(self) -> dict:
        return {"tick": self.tick, "kind": self.kind, "a": self.a,
                "b": self.b, "args": list(self.args)}


def timeline_json(events: Sequence[ChaosEvent]) -> str:
    """Canonical JSON for a timeline — byte-for-byte reproducible from
    the same (shape, seed), which is what the replay test pins."""
    return json.dumps([e.to_dict() for e in events],
                      sort_keys=True, separators=(",", ":"))


def plan_chaos(n_peers: int, n_ticks: int, seed: int = 0, *,
               period: int = 12,
               mix: Optional[Dict[str, float]] = None,
               max_dur: int = 10,
               storage_fsync_victim: Optional[int] = None,
               churn_group: int = 1) -> Tuple[ChaosEvent, ...]:
    """Compile a seeded mixed-nemesis scenario.

    Every ``period`` ticks one nemesis is drawn from ``mix`` (relative
    weights over: ``asym`` — one-directional cut, ``part`` — full
    partition, ``flaky`` — probabilistic drop/dup/delay/reorder on all
    links, ``kill`` — crash+restart, ``stall`` — clock freeze,
    ``storage`` — slow-I/O window, ``churn`` — leadership transfer or
    demote/promote membership cycle).  Each destructive event schedules
    its own undo (heal / restart / promote) ``dur`` ticks later, and at
    most one node is dead at a time, so a majority can always re-form.

    ``storage_fsync_victim``: additionally arm ONE fail-stop fsync EIO
    on that node mid-run (the quarantine path — its stripe goes silent
    for the rest of the run, so keep it off nodes you will assert final
    parity on).  Pure function of its arguments.
    """
    if mix is None:
        mix = {"asym": 2.0, "part": 2.0, "flaky": 1.5, "kill": 2.0,
               "stall": 1.0, "storage": 1.0, "churn": 1.0}
    kinds = sorted(mix)
    weights = np.array([mix[k] for k in kinds], dtype=float)
    weights = weights / weights.sum()
    rng = np.random.default_rng(seed)
    events: List[ChaosEvent] = []
    node_busy_until = -1   # one crashed node at a time
    net_busy_until = -1    # one network regime at a time (heals reset all)
    for t in range(period, n_ticks - max_dur, period):
        kind = kinds[int(rng.choice(len(kinds), p=weights))]
        dur = int(rng.integers(2, max_dur + 1))
        a = int(rng.integers(0, n_peers))
        b = int(rng.integers(0, n_peers - 1))
        b = b if b < a else b + 1   # a distinct peer
        if kind == "asym":
            if t <= net_busy_until:
                continue
            events.append(ChaosEvent(t, "asym_cut", a, b))
            events.append(ChaosEvent(t + dur, "heal"))
            net_busy_until = t + dur
        elif kind == "part":
            if t <= net_busy_until:
                continue
            side = sorted({a})
            rest = sorted(set(range(n_peers)) - set(side))
            events.append(ChaosEvent(t, "part", args=(tuple(side),
                                                      tuple(rest))))
            events.append(ChaosEvent(t + dur, "heal"))
            net_busy_until = t + dur
        elif kind == "flaky":
            if t <= net_busy_until:
                continue
            drop = round(float(rng.uniform(0.05, 0.3)), 3)
            dup = round(float(rng.uniform(0.0, 0.2)), 3)
            reorder = round(float(rng.uniform(0.0, 0.2)), 3)
            events.append(ChaosEvent(t, "flaky",
                                     args=(drop, dup, reorder)))
            events.append(ChaosEvent(t + dur, "heal"))
            net_busy_until = t + dur
        elif kind == "kill":
            if t <= node_busy_until:
                continue
            events.append(ChaosEvent(t, "kill", a))
            events.append(ChaosEvent(t + dur, "restart", a))
            node_busy_until = t + dur
        elif kind == "stall":
            if t <= node_busy_until:
                continue
            events.append(ChaosEvent(t, "stall", a, args=(dur,)))
            node_busy_until = t + dur
        elif kind == "storage":
            events.append(ChaosEvent(t, "storage_delay", a,
                                     args=(2000,)))
        elif kind == "churn":
            if int(rng.integers(0, 2)):
                events.append(ChaosEvent(t, "churn_transfer", a,
                                         args=(churn_group,)))
            else:
                events.append(ChaosEvent(t, "churn_demote", a,
                                         args=(churn_group,)))
                events.append(ChaosEvent(t + dur, "churn_promote", a,
                                         args=(churn_group,)))
    if storage_fsync_victim is not None:
        events.append(ChaosEvent(n_ticks // 2, "storage_fsync",
                                 int(storage_fsync_victim)))
    events.sort(key=lambda e: (e.tick, e.kind, e.a, e.b))
    return tuple(events)


def plan_leader_isolate(n_ticks: int, seed: int = 0, *,
                        group: int = 0, period: int = 40,
                        dur: int = 25) -> Tuple[ChaosEvent, ...]:
    """Compile the GRAY-FAILURE nemesis: periodically cut every link
    INTO ``group``'s current leader while its outbound links stay up.

    This is the asymmetric fault CheckQuorum exists for (tests/
    test_checkquorum.py): the victim's heartbeats still reach — and
    keep suppressing — every follower's election timer, but it hears no
    acks and no higher term, so neither phase-1 step-down nor a normal
    election can ever fire.  Without ``cfg.check_quorum`` the group is
    hostage for the whole window; with it the leader steps itself down
    within an election timeout and the healthy majority re-elects.

    The victim is resolved AT APPLY TIME (the conductor's
    ``_leader_node``), not at plan time — after the first step-down a
    later period isolates whoever leads NOW, so the nemesis keeps
    biting across re-elections.  Each cut schedules its heal ``dur``
    ticks later.  Pure function of its arguments (the timeline is
    replayable; only the victim binding is runtime state, and the
    conductor's ``applied`` audit records who it hit)."""
    events: List[ChaosEvent] = []
    rng = Random(seed)
    for t in range(period, n_ticks - dur, period):
        jitter = rng.randrange(0, max(period // 4, 1))
        events.append(ChaosEvent(t + jitter, "leader_isolate",
                                 args=(group,)))
        events.append(ChaosEvent(t + jitter + dur, "heal"))
    events.sort(key=lambda e: (e.tick, e.kind, e.a, e.b))
    return tuple(events)


# --------------------------------------------------------------- conductor --

class ChaosConductor:
    """Apply a timeline over a LocalCluster, tick by tick, while client
    threads drive load concurrently.  Audited: ``applied`` records every
    event actually applied, in order, for the artifact."""

    def __init__(self, cluster: LocalCluster, events: Sequence[ChaosEvent]):
        self.cluster = cluster
        self.events = list(events)
        self._by_tick: Dict[int, List[ChaosEvent]] = {}
        for ev in self.events:
            self._by_tick.setdefault(ev.tick, []).append(ev)
        self.horizon = max((e.tick for e in self.events), default=0)
        self.t = 0
        self.applied: List[dict] = []
        self._stalled_until: Dict[int, int] = {}

    # -- event application ---------------------------------------------------

    def _leader_node(self, group: int):
        try:
            lead = self.cluster.leader_of(group)
        except AssertionError:
            raise
        return None if lead is None else self.cluster.nodes.get(lead)

    def _apply(self, ev: ChaosEvent) -> None:
        c, f = self.cluster, self.cluster.faults
        extra: dict = {}
        try:
            if ev.kind == "asym_cut":
                f.set_link(ev.a, ev.b, False)
            elif ev.kind == "leader_isolate":
                # Gray failure: inbound-only cut of the group's CURRENT
                # leader — its outbound heartbeats keep flowing (that is
                # the whole point; LinkFaults.isolate cuts both ways and
                # would let ordinary elections handle it).  Victim is
                # resolved now and recorded in the audit.
                g = int(ev.args[0])
                node = self._leader_node(g)
                if node is None:
                    raise RuntimeError(f"group {g} has no leader to "
                                       "isolate")
                lead = node.node_id
                for o in range(c.cfg.n_peers):
                    if o != lead:
                        f.set_link(o, lead, False)
                extra["victim"] = int(lead)
            elif ev.kind == "part":
                f.partition([list(s) for s in ev.args])
            elif ev.kind == "flaky":
                drop, dup, reorder = ev.args[:3]
                f.set_all_flaky(drop_p=drop, dup_p=dup, reorder_p=reorder,
                                delay_p=0.0)
            elif ev.kind == "heal":
                f.heal()
                c.net.flush_held()
            elif ev.kind == "kill":
                if ev.a in c.nodes:
                    c.kill_node(ev.a)
            elif ev.kind == "restart":
                if ev.a not in c.nodes:
                    c.restart_node(ev.a)
            elif ev.kind == "stall":
                self._stalled_until[ev.a] = self.t + int(ev.args[0])
            elif ev.kind == "storage_delay":
                node = c.nodes.get(ev.a)
                if node is not None:
                    node.store.set_fault("delay", value=int(ev.args[0]))
            elif ev.kind == "storage_fsync":
                node = c.nodes.get(ev.a)
                if node is not None:
                    node.store.set_fault("fsync", value=errno.EIO)
            elif ev.kind == "churn_transfer":
                g = int(ev.args[0])
                node = self._leader_node(g)
                if node is not None and ev.a in c.nodes:
                    node.transfer_leadership(g, ev.a)   # fire and forget
            elif ev.kind == "churn_demote":
                g = int(ev.args[0])
                node = self._leader_node(g)
                full = (1 << c.cfg.n_peers) - 1
                if node is not None and node.node_id != ev.a:
                    node.change_membership(g, full & ~(1 << ev.a),
                                           1 << ev.a)
            elif ev.kind == "churn_promote":
                g = int(ev.args[0])
                node = self._leader_node(g)
                full = (1 << c.cfg.n_peers) - 1
                if node is not None:
                    node.change_membership(g, full, 0)
            self.applied.append({"t": self.t, **ev.to_dict(), **extra})
        except AssertionError:
            raise            # split-brain oracle must fail loudly
        except Exception as e:
            # Nemesis application is best-effort (the leader may be mid-
            # election, the membership plane busy) — record the miss.
            self.applied.append({"t": self.t, **ev.to_dict(),
                                 "error": type(e).__name__})

    # -- stepping ------------------------------------------------------------

    def step(self) -> None:
        for ev in self._by_tick.pop(self.t, []):
            self._apply(ev)
        for i, node in list(self.cluster.nodes.items()):
            if self._stalled_until.get(i, -1) > self.t:
                continue   # clock stall: the node's world freezes
            node.tick()
        self.t += 1

    def run(self, extra_ticks: int = 0, tick_sleep: float = 0.0) -> None:
        """Drive the whole timeline (plus ``extra_ticks``).  A small
        ``tick_sleep`` yields the GIL to client threads on starved
        hosts."""
        end = self.horizon + 1 + extra_ticks
        while self.t < end:
            self.step()
            if tick_sleep:
                time.sleep(tick_sleep)

    def finish(self, settle_rounds: int = 800) -> None:
        """Heal the world and drive to convergence: all faults cleared,
        dead nodes restarted (WAL/snapshot recovery), stalls released,
        full voter sets restored, every group led again."""
        c = self.cluster
        c.faults.heal()
        c.net.flush_held()
        self._stalled_until.clear()
        for i in range(c.cfg.n_peers):
            if i not in c.nodes:
                c.restart_node(i)
        for node in c.nodes.values():
            try:
                node.store.set_fault("delay", value=0)  # delay is sticky
                node.store.clear_faults()
            except Exception:
                pass
        c.tick(5)
        full = (1 << c.cfg.n_peers) - 1
        for g in range(c.cfg.n_groups):
            c.wait_leader(g, max_rounds=settle_rounds)
            node = self._leader_node(g)
            if node is None:
                continue
            m = node.membership(g)
            if m["voters"] != full or m["learners"] or m["joint"]:
                try:
                    node.change_membership(g, full, 0)
                except Exception:
                    pass
        c.tick(30)
        for g in range(c.cfg.n_groups):
            c.wait_leader(g, max_rounds=settle_rounds)


# ------------------------------------------------------------ client plane --

class StubHost:
    """Adapter giving RaftStub a container-shaped view of one LocalCluster
    node.  ``_node`` re-resolves per use, so a stub transparently follows
    its node through kill/restart cycles; while the node is down every
    call fails with a MARKED UnavailableError (the op provably never
    started — recorded ``fail``, the history stays sound)."""

    def __init__(self, cluster: LocalCluster, node_id: int):
        self.cluster = cluster
        self.node_id = node_id

    @property
    def _node(self):
        n = self.cluster.nodes.get(self.node_id)
        if n is None:
            raise as_refusal(UnavailableError(
                f"node {self.node_id} is down (chaos)"))
        return n

    def _lookup(self, name: str) -> Optional[int]:
        return int(name)        # the stub name IS the lane number here

    def _release_stub(self, name: str) -> int:
        return 0


def make_recording_stub(cluster: LocalCluster, node_id: int, group: int,
                        history: History, proc: str, *,
                        forward_budget: float = 6.0):
    """A RaftStub over ``cluster.nodes[node_id]`` for ``group``, with
    history recording attached as client process ``proc``."""
    from ..api.stub import RaftStub

    stub = RaftStub(StubHost(cluster, node_id), name=str(group),
                    lane=group, forward=True,
                    forward_budget=forward_budget)
    return stub.attach_history(history, proc)


class KVWorkload:
    """N client threads driving seeded set/add/get traffic at one group
    through recording stubs, while the conductor ticks concurrently.

    Register keys (``r*``) take unique writes (``{proc}-{seq}``), list
    keys (``l*``) take unique appends — so every read is unambiguously
    explained (or not) by the checker, and a duplicate apply of any
    append is observable."""

    def __init__(self, cluster: LocalCluster, history: History, *,
                 group: int = 1, clients: int = 3, seed: int = 0,
                 regs: int = 3, lists: int = 1, read_ratio: float = 0.4,
                 op_timeout: float = 6.0):
        self.cluster = cluster
        self.history = history
        self.group = group
        self.seed = seed
        self.regs = regs
        self.lists = lists
        self.read_ratio = read_ratio
        self.op_timeout = op_timeout
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._client, args=(c,),
                             name=f"chaos-client-{c}", daemon=True)
            for c in range(clients)]
        self.ops_attempted = 0

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()

    def join(self, tick_fn=None, timeout: float = 60.0) -> None:
        """Join the client threads; ``tick_fn`` keeps the cluster ticking
        while clients drain their in-flight (blocking) operations —
        without it a pending future never resolves and every client
        would ride out its full op timeout."""
        deadline = time.monotonic() + timeout
        while any(t.is_alive() for t in self._threads):
            if tick_fn is not None:
                tick_fn()
            time.sleep(0.01)
            if time.monotonic() > deadline:
                break
        for t in self._threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()))

    def _client(self, c: int) -> None:
        rng = Random(self.seed * 9176 + c)
        n_peers = self.cluster.cfg.n_peers
        stub = make_recording_stub(self.cluster, c % n_peers, self.group,
                                   self.history, f"c{c}",
                                   forward_budget=self.op_timeout)
        seq = 0
        while not self._stop.is_set():
            r = rng.random()
            try:
                if r < self.read_ratio:
                    pool = self.regs + self.lists
                    j = rng.randrange(pool)
                    key = (f"r{j}" if j < self.regs
                           else f"l{j - self.regs}")
                    stub.execute_read(json.dumps({"op": "get", "k": key}),
                                      timeout=self.op_timeout)
                elif r < self.read_ratio + (1 - self.read_ratio) * 0.6:
                    key = f"r{rng.randrange(self.regs)}"
                    stub.execute(json.dumps(
                        {"op": "set", "k": key, "v": f"c{c}-{seq}"}),
                        timeout=self.op_timeout)
                else:
                    key = f"l{rng.randrange(self.lists)}"
                    stub.execute(json.dumps(
                        {"op": "add", "k": key, "v": f"c{c}-{seq}"}),
                        timeout=self.op_timeout)
            except Exception:
                pass    # outcome already classified into the history
            seq += 1
            self.ops_attempted += 1
            # Brief jittered pause: yields the GIL to the tick thread
            # (1-vCPU hosts) and decorrelates the clients.
            time.sleep(0.002 + rng.random() * 0.006)


class TransferWorkload:
    """N client threads driving seeded cross-group bank transfers through
    the 2PC plane (runtime/txn.py) while the conductor ticks concurrently.

    Each transfer moves ``amount`` between two accounts in two DIFFERENT
    Raft groups via ``stub.txn().transfer(...)``.  Outcomes are recorded
    as kind-``t`` ops in the history — linz.py refuses those by design;
    the judgment for this workload is check_transfer_atomicity over the
    converged machines, plus balance conservation (transfers are
    zero-sum, so the acct* total never moves).

    History classification mirrors StubRecorder: a returned decision
    (commit OR abort) is ``ok`` — both are definite outcomes; a MARKED
    refusal (admission txn-shed, node down) is ``fail`` — the plane
    proves no PREPARE was sent; anything else is ``info`` — the txn is
    in doubt and the deadline sweep owns its resolution."""

    def __init__(self, cluster: LocalCluster, history: History, *,
                 coord_group: int = 0, groups: Sequence[int] = (1, 2),
                 clients: int = 3, seed: int = 0, accounts: int = 8,
                 max_amount: int = 5, deadline_s: float = 4.0,
                 op_timeout: float = 8.0):
        assert len(groups) >= 2, "transfers need two distinct groups"
        assert coord_group not in groups, \
            "coordinator group must not double as a participant"
        self.cluster = cluster
        self.history = history
        self.coord_group = coord_group
        self.groups = list(groups)
        self.seed = seed
        self.accounts = accounts
        self.max_amount = max_amount
        self.deadline_s = deadline_s
        self.op_timeout = op_timeout
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._client, args=(c,),
                             name=f"xfer-client-{c}", daemon=True)
            for c in range(clients)]
        self.attempted = 0
        self.committed = 0
        self.aborted = 0
        self.refused = 0
        self.unknown = 0

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()

    def join(self, tick_fn=None, timeout: float = 60.0) -> None:
        """Join the client threads while ``tick_fn`` keeps the cluster
        ticking (a blocked 2PC driver needs the coordinator and both
        participants to keep committing)."""
        deadline = time.monotonic() + timeout
        while any(t.is_alive() for t in self._threads):
            if tick_fn is not None:
                tick_fn()
            time.sleep(0.01)
            if time.monotonic() > deadline:
                break
        for t in self._threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()))

    def counts(self) -> dict:
        return {"attempted": self.attempted, "committed": self.committed,
                "aborted": self.aborted, "refused": self.refused,
                "unknown": self.unknown}

    def _client(self, c: int) -> None:
        rng = Random(self.seed * 7841 + c)
        n_peers = self.cluster.cfg.n_peers
        host = StubHost(self.cluster, c % n_peers)
        from ..api.stub import RaftStub
        coord = RaftStub(host, name=str(self.coord_group),
                         lane=self.coord_group, forward=True,
                         forward_budget=self.op_timeout)
        parts = {g: RaftStub(host, name=str(g), lane=g, forward=True,
                             forward_budget=self.op_timeout)
                 for g in self.groups}
        while not self._stop.is_set():
            sg = self.groups[rng.randrange(len(self.groups))]
            dg = sg
            while dg == sg:
                dg = self.groups[rng.randrange(len(self.groups))]
            sk = f"acct{rng.randrange(self.accounts)}"
            dk = f"acct{rng.randrange(self.accounts)}"
            amt = 1 + rng.randrange(self.max_amount)
            op_id = self.history.invoke(
                f"x{c}", "t", f"{sg}/{sk}->{dg}/{dk}", amt)
            self.attempted += 1
            try:
                r = (coord.txn(deadline_s=self.deadline_s)
                     .transfer(parts[sg], sk, parts[dg], dk, amt)
                     .execute(timeout=self.op_timeout))
            except Exception as e:
                if is_refusal(e):
                    self.refused += 1
                    self.history.fail(op_id, type(e).__name__)
                else:
                    self.unknown += 1
                    self.history.info(op_id, type(e).__name__)
            else:
                if r.committed:
                    self.committed += 1
                else:
                    self.aborted += 1
                self.history.ok(op_id, {"txn": r.txn,
                                        "decision": r.decision})
            # Yield to the tick thread and decorrelate the clients.
            time.sleep(0.002 + rng.random() * 0.006)


# ------------------------------------------------------- real-process tier --

PROC_XML = """<raft>
  <cluster>
    <local>{local}</local>
    {remotes}
  </cluster>
  <timing tick="10" heartbeat="1" election="{election}" broadcast="0.5"
          pre-vote="true"/>
  <engine groups="{groups}" log-slots="64" batch="8" max-submit="8"/>
  <snapshot state-change-threshold="64" dirty-log-tolerance="16"
            snap-min-interval="20" compact-min-interval="10" slack="8"/>
  <storage dir="{data_dir}"/>
</raft>
"""


class ProcCluster:
    """Real OS processes on localhost TCP: the SIGKILL nemesis substrate
    (extracted from tests/test_system_procs.py so the chaos plane and
    the system test share one set of plumbing).  Each node runs
    ``rafting_tpu_torch.tools.noderun`` in its own interpreter — separate
    address spaces, hard kills, crash recovery from disk alone."""

    def __init__(self, root, n: int = 3, groups: int = 4,
                 election_mul: float = 3.0, *, device: str):
        self.root = root
        self.device = str(device)   # every node's --device; no default
        self.n = n
        self.repo = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        ports = free_ports(n)
        self.uris = [f"raft://127.0.0.1:{p}" for p in ports]
        self.cfgs = []
        for i in range(n):
            remotes = "\n    ".join(f"<remote>{u}</remote>"
                                    for j, u in enumerate(self.uris)
                                    if j != i)
            p = os.path.join(str(root), f"node{i}.xml")
            with open(p, "w") as fh:
                fh.write(PROC_XML.format(
                    local=self.uris[i], remotes=remotes, groups=groups,
                    election=election_mul,
                    data_dir=os.path.join(str(root), f"node{i}")))
            self.cfgs.append(p)
        self.procs: Dict[int, subprocess.Popen] = {}

    # -- lifecycle -----------------------------------------------------------

    def start(self, i: int) -> subprocess.Popen:
        env = dict(os.environ)
        env["PYTHONPATH"] = self.repo
        out = open(os.path.join(str(self.root), f"node{i}.out"), "ab")
        p = subprocess.Popen(
            [sys.executable, "-m", "rafting_tpu_torch.tools.noderun",
             "--device", self.device,
             self.cfgs[i]],
            env=env, cwd=self.repo, stdout=out, stderr=out)
        self.procs[i] = p
        return p

    def start_all(self) -> None:
        for i in range(self.n):
            self.start(i)

    def sigkill(self, i: int) -> None:
        """The nemesis: ``kill -9``, no flush, no goodbye."""
        os.kill(self.procs[i].pid, signal.SIGKILL)
        self.procs[i].wait(timeout=10)

    def sigterm_all(self, timeout: float = 120.0) -> List[int]:
        for p in self.procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        return [p.wait(timeout=timeout) for p in self.procs.values()]

    def close(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()

    # -- observation ---------------------------------------------------------

    def out_path(self, i: int) -> str:
        return os.path.join(str(self.root), f"node{i}.out")

    def ready_count(self, i: int) -> int:
        p = self.out_path(i)
        if not os.path.exists(p):
            return 0
        with open(p, "rb") as f:
            return f.read().count(b"READY lane=")

    def ready_lanes(self, i: int) -> List[int]:
        p = self.out_path(i)
        if not os.path.exists(p):
            return []
        lanes = []
        with open(p, "rb") as f:
            for ln in f.read().splitlines():
                if ln.startswith(b"READY lane="):
                    lanes.append(int(ln.split(b"=")[1].split(b" ")[0]))
        return lanes

    def status(self, i: int) -> Optional[dict]:
        try:
            with open(os.path.join(str(self.root), f"node{i}",
                                   "status.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def total_acked(self, alive=None) -> int:
        total = 0
        for i in (alive if alive is not None else range(self.n)):
            s = self.status(i)
            if s:
                total += s["acked"]
        return total

    def leader(self) -> Optional[int]:
        for i in range(self.n):
            s = self.status(i)
            if s and s.get("leader"):
                return i
        return None

    def machine_lines(self, i: int, lane: int) -> List[str]:
        p = os.path.join(str(self.root), f"node{i}", "machines",
                         f"group_{lane}.txt")
        if not os.path.exists(p):
            return []
        with open(p) as f:
            return f.read().splitlines()

    def acked_payloads(self, i: int) -> List[str]:
        """Payloads node i's load loop saw acknowledged (the runner's
        client-side oracle file)."""
        p = os.path.join(str(self.root), f"node{i}", "acked.txt")
        if not os.path.exists(p):
            return []
        with open(p) as f:
            return f.read().split()

    def wal_dirs(self) -> List[str]:
        return [os.path.join(str(self.root), f"node{i}", "wal")
                for i in range(self.n)]

    @staticmethod
    def wait(pred, what: str, timeout: float) -> None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if pred():
                return
            time.sleep(0.25)
        raise AssertionError(f"{what} not reached in {timeout}s")

    # -- the seeded kill schedule -------------------------------------------

    def run_kill_schedule(self, events: Sequence[ChaosEvent], *,
                          step_s: float = 1.0,
                          progress_per_step: int = 0) -> List[dict]:
        """Interpret a timeline's kill/restart events in wall-clock time
        (``tick`` * ``step_s`` seconds from start).  Other kinds are
        ignored — real processes expose no mid-run fault controls.
        Returns the applied audit."""
        applied = []
        t0 = time.time()
        for ev in sorted(events, key=lambda e: e.tick):
            if ev.kind not in ("kill", "restart"):
                continue
            when = t0 + ev.tick * step_s
            while time.time() < when:
                time.sleep(0.1)
            if ev.kind == "kill" and self.procs[ev.a].poll() is None:
                self.sigkill(ev.a)
                applied.append({"t": ev.tick, **ev.to_dict()})
            elif ev.kind == "restart" and self.procs[ev.a].poll() is not None:
                self.start(ev.a)
                applied.append({"t": ev.tick, **ev.to_dict()})
        return applied
