"""The port's node runtime (``RaftNode`` + WAL + loopback transport +
``LocalCluster``) on the CPU, against the JAX package's.

* Lockstep parity: a JAX ``LocalCluster`` and the port's run one scripted
  scenario (``rafting_tpu_torch/testkit/lockstep.py``) round by round at
  64 groups x 3 nodes, with the durable pipeline off and on: the host
  mirrors of every node are equal at every round, the machine files are
  byte-equal and every node's WAL exports the same state.
* The scenarios of ``tests/test_node_runtime.py`` on the port.
* One linearizable read through ``RaftNode.read``, port against JAX, and
  one behind a standing inbox backlog (served by the port only); the
  pipelined late shed beside the in-flight offer (the reference asserts,
  the port keeps the offer queued); admission's tick on a paced node (the
  reference counts the busy time, the port the interval).
* WAL interchange: a WAL written by one package restores lane for lane
  the same in the other (a group with a gap takes the slow-scan branch).
* Guards: the copied modules stay byte-equal to the reference, the
  device seams of the container, the factory and ``noderun`` change
  nothing else, the port exports every public name of the reference,
  imports without jax, and its entry points refuse to drift to the CPU.

Every port object runs with ``device="cpu"``.
"""

import os
import re
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rafting_tpu.api import anomaly as jax_anomaly
from rafting_tpu.core.types import EngineConfig as JaxEngineConfig
from rafting_tpu.log.store import LogStore as JaxLogStore
from rafting_tpu.log.store import restore_raft_state as jax_restore
from rafting_tpu.testkit.harness import LocalCluster as JaxLocalCluster
from rafting_tpu_torch import LEADER, EngineConfig, LocalCluster, RaftNode
from rafting_tpu_torch.api import anomaly as port_anomaly
from rafting_tpu_torch.api.anomaly import BatchAbortedError, NotLeaderError
from rafting_tpu_torch.bridge import state_to_numpy
from rafting_tpu_torch.log.store import LogStore
from rafting_tpu_torch.log.store import restore_raft_state
from rafting_tpu_torch.snapshot.policy import MaintainAgreement
from rafting_tpu_torch.testkit.lockstep import PINNED_ENV, run_script

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG_KW = dict(n_groups=4, n_peers=3, log_slots=32, batch=4, max_submit=4,
              election_ticks=10, heartbeat_ticks=3, rpc_timeout_ticks=8)
CFG = EngineConfig(**CFG_KW)
LOCKSTEP_KW = dict(CFG_KW, n_groups=64)


def _cluster(tmp_path, cfg=CFG, **kw):
    return LocalCluster(cfg, str(tmp_path), device="cpu", **kw)


# -------------------------------------------------------- lockstep parity --

@pytest.mark.parametrize("pipeline", [False, True])
def test_lockstep_parity_with_jax(tmp_path, monkeypatch, pipeline):
    for k, v in PINNED_ENV.items():
        monkeypatch.setenv(k, v)
    G, L = LOCKSTEP_KW["n_groups"], LOCKSTEP_KW["log_slots"]
    jc = JaxLocalCluster(JaxEngineConfig(**LOCKSTEP_KW),
                         str(tmp_path / "jax"), pipeline=pipeline)
    tc = LocalCluster(EngineConfig(**LOCKSTEP_KW), str(tmp_path / "port"),
                      pipeline=pipeline, device="cpu")
    try:
        r = run_script([jc, tc])
        assert len(r["acked"]) == 2 * 2 * G   # every submission acked
        assert sum(len(b) for b in r["files"].values()) > 0
        for i in jc.nodes:
            a = jc.nodes[i].store.export_state(G, L)
            b = tc.nodes[i].store.export_state(G, L)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    finally:
        jc.close()
        tc.close()


# ------------------------------------ the scenarios of test_node_runtime --

def _elect_submit_apply(c):
    c.wait_leader(0)
    res = c.submit_via_leader(0, b"hello-0")
    assert res == len(c.machine_lines(c.leader_of(0), 0))
    for k in range(1, 6):
        c.submit_via_leader(0, f"cmd-{k}".encode())
    c.tick(10)
    c.assert_file_parity(0)
    for i in c.nodes:
        cmds = c.command_payloads(i, 0)
        assert len(cmds) == 6
        assert cmds[0] == "hello-0"


def _not_leader(c):
    lead = c.wait_leader(0)
    follower = next(i for i in c.nodes if i != lead)
    fut = c.nodes[follower].submit(0, b"nope")
    assert isinstance(fut.exception(timeout=1), NotLeaderError)


def _failover_and_restart(c):
    lead = c.wait_leader(0)
    for k in range(4):
        c.submit_via_leader(0, f"before-{k}".encode())
    c.tick(5)
    c.kill_node(lead)
    new_lead = c.wait_leader(0)
    assert new_lead != lead
    for k in range(4):
        c.submit_via_leader(0, f"after-{k}".encode())
    c.restart_node(lead)
    c.tick_until(lambda: len(c.command_lines(lead, 0)) == 8, 600,
                 "restarted node catch-up")
    c.assert_file_parity(0)
    assert c.command_payloads(lead, 0) == \
        [f"before-{k}" for k in range(4)] + [f"after-{k}" for k in range(4)]


def _multi_group_independence(c):
    for g in range(CFG.n_groups):
        c.wait_leader(g)
    for g in range(CFG.n_groups):
        c.submit_via_leader(g, f"g{g}-x".encode())
    c.tick(10)
    for g in range(CFG.n_groups):
        c.assert_file_parity(g)
        assert c.command_payloads(c.leader_of(g), g) == [f"g{g}-x"]


def _submit_batch_in_order(c):
    lead = c.wait_leader(0)
    n = c.nodes[lead]
    c.tick_until(lambda: n.is_ready(0), 100, "leader ready")
    fut = n.submit_batch(0, [f"b-{k}".encode() for k in range(3)])
    c.tick_until(fut.done, 200, "batch committed")
    results = fut.result()
    assert results == sorted(results) and len(results) == 3
    c.tick(10)
    c.assert_file_parity(0)
    other = next(i for i in range(3) if i != lead)
    assert isinstance(c.nodes[other].submit_batch(0, [b"x"]).exception(),
                      NotLeaderError)
    assert n.submit_batch(0, []).result() == []


def _submit_batch_fails_wholesale(c):
    lead = c.wait_leader(0)
    n = c.nodes[lead]
    c.tick_until(lambda: n.is_ready(0), 100, "leader ready")
    c.net.partition([[lead], [i for i in range(3) if i != lead]])
    fut = n.submit_batch(0, [b"doomed-1", b"doomed-2"])
    c.tick(40)
    assert not fut.done()
    c.net.heal()
    c.tick_until(fut.done, 400, "batch aborted on step-down")
    err = fut.exception()
    assert isinstance(err, BatchAbortedError)
    assert err.completed == [False, False]
    assert err.cause is not None


def _snapshot_install(tmp_path):
    """A follower behind the compaction floor catches up through a
    snapshot install (the aggressive MaintainAgreement)."""
    cfg = EngineConfig(n_groups=2, n_peers=3, log_slots=16, batch=4,
                       max_submit=4, election_ticks=10, heartbeat_ticks=3)
    aggressive = lambda: MaintainAgreement(
        cfg.n_groups, state_change_threshold=2, dirty_log_tolerance=1,
        snap_min_interval=2, compact_min_interval=2, compact_slack=2)
    c = _cluster(tmp_path, cfg, maintain_factory=aggressive)
    try:
        lead = c.wait_leader(0)
        victim = next(i for i in c.nodes if i != lead)
        c.kill_node(victim)
        victim_tail = len(c.machine_lines(victim, 0))
        k = 0
        while k < 30 or not all(
                n.h_base[0] > victim_tail for n in c.nodes.values()):
            c.submit_via_leader(0, f"deep-{k}".encode())
            c.tick(3)
            k += 1
            assert k < 200, "compaction floor never passed victim tail"
        c.tick(30)
        c.restart_node(victim)
        c.tick_until(lambda: len(c.machine_lines(victim, 0)) >= k,
                     800, "snapshot catch-up")
        c.assert_file_parity(0)
        assert any(n.metrics["snapshots_installed"] > 0
                   for n in c.nodes.values())
    finally:
        c.close()


def _full_cluster_restart(tmp_path):
    c = _cluster(tmp_path)
    try:
        c.wait_leader(0)
        for k in range(5):
            c.submit_via_leader(0, f"persist-{k}".encode())
        c.tick(10)
    finally:
        c.close()
    c2 = _cluster(tmp_path)
    try:
        c2.wait_leader(0)
        c2.tick(20)
        c2.assert_file_parity(0)
        res = c2.submit_via_leader(0, b"persist-5")
        assert res == len(c2.machine_lines(c2.leader_of(0), 0))
        assert c2.command_payloads(c2.leader_of(0), 0)[-1] == "persist-5"
    finally:
        c2.close()


def _profiled(tmp_path):
    """RaftNode.profile_ticks captures ticks through torch.profiler and
    writes one chrome trace when the armed budget runs out."""
    c = _cluster(tmp_path / "c")
    try:
        c.nodes[0].profile_ticks(str(tmp_path / "prof"), n_ticks=2)
        c.tick(3)
        traces = os.listdir(tmp_path / "prof")
        assert len(traces) == 1 and traces[0].endswith(".json")
        assert os.path.getsize(tmp_path / "prof" / traces[0]) > 0
    finally:
        c.close()


# Scenarios on one 4-group cluster, and those that build their own.
SCENARIOS = {
    "elect_submit_apply": _elect_submit_apply,
    "not_leader": _not_leader,
    "failover_and_restart": _failover_and_restart,
    "multi_group_independence": _multi_group_independence,
    "submit_batch_in_order": _submit_batch_in_order,
    "submit_batch_fails_wholesale": _submit_batch_fails_wholesale,
}
OWN_CLUSTER = {
    "snapshot_install": _snapshot_install,
    "full_cluster_restart": _full_cluster_restart,
    "tick_profiler": _profiled,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS) + sorted(OWN_CLUSTER))
def test_node_scenario(tmp_path, name):
    if name in OWN_CLUSTER:
        OWN_CLUSTER[name](tmp_path)
        return
    c = _cluster(tmp_path)
    try:
        SCENARIOS[name](c)
    finally:
        c.close()


# ------------------------------------------------------- linearizable read --

def _read_script(lc, anomaly):
    """test_read_runtime.py's flow on a FileMachine cluster (no read SPI:
    a read resolves to its quorum-confirmed ReadIndex); ``anomaly`` is
    the cluster's package's error module."""
    lead = lc.wait_leader(0)
    node = lc.nodes[lead]
    lc.tick_until(lambda: node.is_ready(0), what="leader ready")
    wf = node.submit(0, b"w-1")
    lc.tick_until(wf.done, what="write applied")
    tail = node.store.tail(0)
    rf = node.read(0, b"q")
    lc.tick_until(rf.done, what="read served")
    refused = lc.nodes[(lead + 1) % 3].read(0, b"q").exception()
    assert isinstance(refused, anomaly.NotLeaderError)
    assert anomaly.is_refusal(refused)
    assert node.store.tail(0) == tail    # reads never grow the log
    return wf.result(), rf.result(), node.metrics["reads_served"]


def test_linearizable_read_matches_jax(tmp_path, monkeypatch):
    for k, v in PINNED_ENV.items():
        monkeypatch.setenv(k, v)
    jc = JaxLocalCluster(JaxEngineConfig(**CFG_KW), str(tmp_path / "jax"))
    try:
        want = _read_script(jc, jax_anomaly)
    finally:
        jc.close()
    tc = _cluster(tmp_path / "port")
    try:
        got = _read_script(tc, port_anomaly)
    finally:
        tc.close()
    assert got == want
    w, r, served = got
    assert r >= w and served >= 1


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_read_survives_standing_inbox_backlog(tmp_path, monkeypatch, pkg):
    """Two slices queued ahead on every link stay queued for good under
    the reference's inbox (at 64 groups a slice arrives every tick, one
    drains per tick, and only a backlog beyond 3 collapses): every AE ->
    AER round trip then takes more than read_fresh_ticks, and a
    linearizable read never releases.  The port's node collapses any
    backlog, so the read is served."""
    for k, v in PINNED_ENV.items():
        monkeypatch.setenv(k, v)
    lc = JaxLocalCluster(JaxEngineConfig(**LOCKSTEP_KW), str(tmp_path)) \
        if pkg == "jax" else _cluster(tmp_path, EngineConfig(**LOCKSTEP_KW))
    try:
        lead = lc.wait_leader(0)
        node = lc.nodes[lead]
        lc.tick_until(lambda: node.is_ready(0), what="leader ready")
        wf = node.submit(0, b"w-1")
        lc.tick_until(wf.done, what="write applied")
        for dst in lc.nodes:
            for src in lc.nodes:
                if src != dst:
                    for _ in range(2):
                        lc.nodes[dst].acc.merge(src, {}, {})
        lc.tick(10)     # past any lease evidence from before
        rf = node.read(0, b"q")
        lc.tick(60)
        assert rf.done() == (pkg == "port")
    finally:
        lc.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_pipelined_late_shed_keeps_the_inflight_offer(tmp_path, monkeypatch,
                                                      pkg):
    """Pipelined, the step in flight was offered entries from the
    submission queue; admission's late shed (a 1 ms delay target, so
    every queued batch is past its age cap) expires untouched batches.
    The reference expires the in-flight offer too, and the next fetch
    finds the device ahead of the queue.  The port's queue keeps at
    least the in-flight offer.  256 groups, 8 x 64 B per led group per
    round, as bench_runtime.py offers."""
    for k, v in dict(RAFT_PIPELINE="1", RAFT_ADMISSION="1",
                     RAFT_ADMISSION_TARGET_MS="1",
                     RAFT_ADMISSION_TARGET_TICKS="0").items():
        monkeypatch.setenv(k, v)
    from rafting_tpu_torch import LEADER
    from rafting_tpu_torch.testkit.fixtures import NullProvider
    kw = dict(CFG_KW, n_groups=256, log_slots=64, batch=32, max_submit=32)
    if pkg == "jax":
        lc = JaxLocalCluster(JaxEngineConfig(**kw), str(tmp_path),
                             provider_factory=NullProvider, seed=0,
                             pipeline=True)
    else:
        lc = _cluster(tmp_path, EngineConfig(**kw),
                      provider_factory=NullProvider, seed=0, pipeline=True)
    burst = [b"x" * 64] * 8

    def rounds(n):
        for _ in range(n):
            for node in lc.nodes.values():
                led = (node.h_role == LEADER) & node.h_ready
                node.submit_batch_many(np.nonzero(led)[0], burst)
            for node in lc.nodes.values():
                node.tick()
    try:
        lc.wait_leader(0, max_rounds=300)
        if pkg == "jax":
            with pytest.raises(AssertionError,
                               match="beyond the queued depth"):
                rounds(40)
        else:
            rounds(40)
            assert sum(n.admission.expired for n in lc.nodes.values()) > 0
            assert min(int(n.h_commit.sum()) for n in lc.nodes.values()) > 0
    finally:
        lc.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_paced_node_counts_admission_ticks_at_its_interval(
        tmp_path, monkeypatch, pkg):
    """Admission's delay target is ``target_ticks`` ticks of the tick's
    wall time, and a submission waits at least one tick.  A node paced at
    an interval (``start()``, as a container runs it) ticks once per
    interval however short its busy time.  The reference feeds the busy
    time, so its target falls below the wait of every queued submission
    and it sheds a burst it would absorb; the port feeds the interval."""
    for k, v in PINNED_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("RAFT_ADMISSION", "1")
    interval = 30.0
    lc = JaxLocalCluster(JaxEngineConfig(**CFG_KW), str(tmp_path)) \
        if pkg == "jax" else _cluster(tmp_path)
    try:
        lc.wait_leader(0)
        for node in lc.nodes.values():
            # The paced loop's interval, without its thread; the ticks
            # before it (the first compiles) leave the estimate.
            node._tick_interval = interval
            node.admission._tick_ewma = None
        lc.tick(3)
        targets = [n.admission.target_now() for n in lc.nodes.values()]
        bound = lc.nodes[0].admission.target_ticks * interval
        if pkg == "jax":
            assert max(targets) < bound, targets
        else:
            assert min(targets) >= bound, targets
    finally:
        lc.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("pipeline", [False, True])
def test_a_pipelined_leader_waits_out_its_followers_reply(
        tmp_path, monkeypatch, pkg, pipeline):
    """A container's timing gives the engine the 3-tick RPC deadline of a
    lockstep round trip.  A pipelined follower sends its reply a tick
    after the tick that handled the request (behind its fsync), so with
    its followers ticking at half the leader's rate (ticks of twice the
    interval, as a collector pause or a slow host phase makes them) the
    reply reaches the leader at its fourth tick after the send: the
    reference's pipelined leader times out both peers and loses its
    healthy majority.  Serial followers reply within the deadline, and the
    port's pipelined node waits one tick longer."""
    for k, v in PINNED_ENV.items():
        monkeypatch.setenv(k, v)
    kw = dict(CFG_KW, n_groups=4, rpc_timeout_ticks=3)
    lc = JaxLocalCluster(JaxEngineConfig(**kw), str(tmp_path),
                         pipeline=pipeline) \
        if pkg == "jax" else _cluster(tmp_path, EngineConfig(**kw),
                                      pipeline=pipeline)
    if pkg == "jax":
        # The port collapses any standing inbox backlog (a fault of the
        # reference's inbox fixed in the port only); with it, the two
        # packages differ here only in the deadline.
        for n in lc.nodes.values():
            n.acc.COLLAPSE_BACKLOG = 1
    try:
        lc.tick_until(lambda: all(
            (lead := lc.leader_of(g)) is not None
            and bool(lc.nodes[lead].h_ready[g]) for g in range(4)), 300,
            "every group led and ready")
        leader = lc.leader_of(0)
        node = lc.nodes[leader]
        led = np.nonzero(node.h_role == LEADER)[0]
        lost = 0
        for step in range(48):
            for i, n in lc.nodes.items():
                if i == leader or step % 2 == 0:
                    n.tick()
            lost += int((~node.h_ready[led]).sum())
        slow = pkg == "jax" and pipeline
        assert (lost > 0) == slow, (pkg, pipeline, lost)
    finally:
        lc.close()


# ---------------------------------------------------------- WAL interchange --

def _write_wal(kind, root):
    """Run a cluster of one package, then give group 3 of node 0 a WAL
    with a hole above its tail (the slow-scan branch of restore)."""
    if kind == "jax":
        c = JaxLocalCluster(JaxEngineConfig(**CFG_KW), root)
        Store = JaxLogStore
    else:
        c = LocalCluster(CFG, root, device="cpu")
        Store = LogStore
    try:
        for g in range(CFG.n_groups):
            c.submit_via_leader(g, f"g{g}".encode())
        c.tick(5)
    finally:
        c.close()
    st = Store(os.path.join(root, "node0", "wal"), shards=4)
    try:
        tail = st.tail(3)
        st.append_entries(3, tail + 2, [1, 1], [b"past-the-hole"] * 2)
        st.sync()
    finally:
        st.close()


def _assert_state_equal(port, ref, path="state"):
    for name, v in port.items():
        r = getattr(ref, name)
        if isinstance(v, dict):
            _assert_state_equal(v, r, f"{path}.{name}")
        elif v is None:
            assert r is None, f"{path}.{name}"
        else:
            r = np.asarray(r)
            assert v.dtype == r.dtype and v.shape == r.shape, \
                f"{path}.{name}: {v.dtype}{v.shape} vs {r.dtype}{r.shape}"
            np.testing.assert_array_equal(v, r, err_msg=f"{path}.{name}")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_interchange(tmp_path, writer):
    _write_wal(writer, str(tmp_path / "w"))
    for i in range(CFG.n_peers):
        src = tmp_path / "w" / f"node{i}" / "wal"
        shutil.copytree(src, tmp_path / f"j{i}")
        shutil.copytree(src, tmp_path / f"t{i}")
        js = JaxLogStore(str(tmp_path / f"j{i}"), shards=4)
        ts = LogStore(str(tmp_path / f"t{i}"), shards=4)
        try:
            G, L = CFG.n_groups, CFG.log_slots
            if i == 0:
                ex = ts.export_state(G, L)
                assert ex["live_count"][3] != ex["tail"][3] - ex["floor"][3]
            want = jax_restore(JaxEngineConfig(**CFG_KW), i, js, seed=0)
            got = restore_raft_state(CFG, i, ts, seed=0, device="cpu")
            assert got.term.device.type == "cpu"
            _assert_state_equal(state_to_numpy(got),
                                jax.tree.map(np.asarray, want))
            a, b = js.export_state(G, L), ts.export_state(G, L)
            for k in a:     # the repair of the hole, too
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        finally:
            js.close()
            ts.close()


# ------------------------------------------------------------------ guards --

# Modules the port copies from the reference byte for byte.
COPIES = [
    "utils/__init__.py", "utils/iofault.py",
    "utils/metrics.py", "utils/latency.py", "utils/health.py",
    "utils/heat.py", "api/anomaly.py", "api/serial.py",
    "transport/__init__.py", "transport/faults.py", "transport/inbox.py",
    "machine/spi.py",
    "machine/dispatch.py", "machine/file_machine.py", "log/wal.py",
    "log/native/wal.cpp", "snapshot/__init__.py", "snapshot/archive.py",
    "snapshot/policy.py", "runtime/__init__.py", "runtime/admission.py",
    "runtime/txn.py", "runtime/obsrv.py", "testkit/fixtures.py",
    # The public API slice.
    "log/spi.py", "log/memstore.py", "log/__init__.py",
    "machine/kv_machine.py", "machine/__init__.py", "api/retry.py",
    "api/config.py", "api/__init__.py",
    "testkit/history.py", "testkit/linz.py", "testkit/logcheck.py",
    "admin/__init__.py", "admin/kv.py", "admin/administrator.py",
    "admin/rebalance.py", "tools/__init__.py",
    # The verification plane.
    "testkit/faultfs.py", "testkit/openloop.py",
]
# Copies with named edits: the file outside these top-level functions and
# classes ("name"), methods ("Class.method") and module docstrings
# ("__doc__") equals the reference, once EDIT_MAPS has put the port's
# lines in place of the reference's.  Every name is the port's; the
# reference may lack one (a helper the port adds), and REF_ONLY names what
# only the reference has.  The port's forwards hold
# no thread while they wait: a stub runs each as a coroutine on its
# transport's reactor (transport/forward_io.py), which also sends and
# serves the TCP transport's forwards, instead of a thread per operation
# at each end; closing a transport closes its reactor.
EDITED = {"utils/tracelog.py": ["trace_to_numpy"],
          # The same values, the whole 64-byte lanes advanced by numpy.
          "utils/crc32c.py": ["crc32c", "_lanes"],
          "transport/codec.py": ["messages_template"],
          "api/stub.py": ["RaftStub._forwarded"],
          # Restores one node's state as torch tensors on ``device``.
          "log/store.py": ["restore_raft_state"],
          "transport/loopback.py": ["LoopbackTransport.close",
                                    "LoopbackTransport.forward_async"],
          "transport/tcp.py": ["TcpTransport.close",
                               "TcpTransport._accept_loop",
                               "TcpTransport._on_first_frame",
                               "TcpTransport._read_loop",
                               "TcpTransport.forward_async",
                               "TcpTransport._serve_forward"],
          # The node's device seam: torch in place of jax.numpy, the
          # stepper (runtime/step_graph.py) in place of the jitted
          # node_step, the WAL's restore onto ``device``; the node's state
          # at [G] lanes as the reference's.  The port also collapses any
          # standing inbox backlog, keeps an in-flight tick's offers
          # queued under admission shedding and feeds admission a paced
          # tick's interval (faults of the reference).  It gives each
          # snapshot download a file of its own (the reference's shared
          # name lets a newer download rewrite a file being installed) and
          # makes a tick's installs durable with one barrier, not one each;
          # a pipelined node's RPC deadline is at least 4 ticks.
          "runtime/node.py": [
              "_host_lane", "_fetch_trees", "_reset_lanes", "_TickCtx",
              "RaftNode.__init__", "RaftNode.close",
              "RaftNode.profile_ticks", "RaftNode.tick",
              "RaftNode._health_tick", "RaftNode._dispatch",
              "RaftNode._fetch", "RaftNode._persist_prepare",
              "RaftNode.catch_up_gap", "RaftNode._purge_lanes",
              "RaftNode._download_snapshot", "RaftNode._install_snapshots"],
          # torch.profiler in place of jax.profiler, same entry points.
          "utils/profiling.py": [
              "__doc__", "_profile", "_export", "device_trace",
              "TickProfiler.__init__", "TickProfiler.arm",
              "TickProfiler.step", "TickProfiler.after_tick",
              "TickProfiler._stop", "TickProfiler.close"]}
REF_ONLY = {"utils/profiling.py": ["TickProfiler._release"]}
# The reference's lines (left) that a named-edit copy holds in its own
# words (right), outside its named parts: the import blocks, and the
# profiler's note on why one trace runs at a time.
EDIT_MAPS = {
    "runtime/node.py": [
        (b"import jax\nimport jax.numpy as jnp\nimport numpy as np\n",
         b"import numpy as np\nimport torch\n"),
        (b"from ..core.step import node_step\n"
         b"from ..core.types import (\n"
         b"    I32, I32_SAFE_MAX, LEADER, NIL, EngineConfig, HostInbox, "
         b"Messages,\n"
         b"    StepInfo, boot_conf_word as _boot_conf_word, init_state,\n)\n",
         b"from ..core.types import (\n"
         b"    I32_SAFE_MAX, LEADER, NIL, EngineConfig, StepInfo,\n"
         b"    boot_conf_word as _boot_conf_word, resolve_device,\n)\n"),
        (b"from .admission import admission_from_env\n",
         b"from .admission import admission_from_env\n"
         b"from .step_graph import NodeStepper, to_host\n"),
    ],
    "utils/profiling.py": [
        (b"import os\nfrom typing", b"import os\nimport time\nfrom typing"),
        ("# jax.profiler traces are PROCESS-global (start_trace raises if "
         "one is\n# already running), so at most one TickProfiler may hold "
         "a trace at a time \u2014\n# in-process multi-node harnesses "
         "construct several RaftNodes, and with\n".encode(),
         "# The torch profiler is process-global (one kineto session at a "
         "time), so\n# at most one TickProfiler may hold a trace at a time "
         "\u2014 in-process\n# multi-node harnesses construct several "
         "RaftNodes, and with\n".encode()),
    ],
}


def _read(pkg, rel):
    with open(os.path.join(REPO, pkg, rel), "rb") as f:
        return f.read()


def _cut(src: bytes, names, added=False) -> bytes:
    """``src`` without the named top-level functions and classes, methods
    named ``Class.method`` (each up to the next line at its own
    indentation or less) and ``__doc__`` (the module docstring).  A name
    missing from ``src`` fails, unless ``added`` (the reference lacks what
    the port adds)."""
    for name in names:
        if name == "__doc__":
            m = re.match(rb'""".*?"""\n', src, re.S)
            assert m, name
            src = src[m.end():]
            continue
        cls, _, meth = name.rpartition(".")
        if cls:
            c = re.search(rb"^class " + cls.encode() + rb"\b.*?(?=^\S|\Z)",
                          src, re.S | re.M)
            assert c, cls
            lo, hi = c.start(), c.end()
            pat = rb"^    def " + meth.encode() + rb"\b.*?(?=^ {0,4}\S|\Z)"
        else:
            lo, hi = 0, len(src)
            pat = rb"^(?:def|class) " + name.encode() + rb"\b.*?(?=^\S|\Z)"
        m = re.compile(pat, re.S | re.M).search(src, lo, hi)
        if m is None and added:
            continue
        assert m, name
        src = src[:m.start()] + src[m.end():]
    return src


@pytest.mark.parametrize("rel", COPIES + sorted(EDITED))
def test_copied_module_matches_reference(rel):
    port, ref = _read("rafting_tpu_torch", rel), _read("rafting_tpu", rel)
    for theirs, ours in EDIT_MAPS.get(rel, ()):
        assert ref.count(theirs) == 1, theirs
        ref = ref.replace(theirs, ours)
    names = EDITED.get(rel)
    if names:
        assert port != ref
        port = _cut(port, names)
        ref = _cut(_cut(ref, REF_ONLY.get(rel, ())), names, added=True)
    assert port == ref, f"rafting_tpu_torch/{rel} drifted from the reference"


# Classes with a device seam: the port passes ``device`` through.  Taking
# out every trailing ``, device=...`` argument and then every line that
# mentions ``device`` must give the reference back, so no line outside
# the seam can drift.  noderun also swaps its jax platform pin for
# ``--device`` and imports the port's API relatively; those reference
# lines are mapped as listed.  The chaos kit's ``ProcCluster`` takes the
# device as a keyword with no default and spawns the port's noderun with
# ``--device`` instead of pinning JAX to the CPU.  ``LocalCluster`` hands
# its ``device`` to every node.
DEVICE_SEAMS = {
    "api/factory.py": [],
    "api/container.py": [],
    "tools/noderun.py": [
        (rb"^.*\b(platform|jax)\b.*\n", b""),
        (rb"rafting_tpu\.tools\.noderun", b"rafting_tpu_torch.tools.noderun"),
        (rb"from rafting_tpu\.api import", b"from ..api import"),
    ],
    "testkit/harness.py": [],
    "testkit/chaos.py": [
        (rb"^.*\bJAX_PLATFORMS\b.*\n", b""),
        (rb"^.*election_mul: float = 3\.0\):\n", b""),
        (rb"rafting_tpu\.tools\.noderun", b"rafting_tpu_torch.tools.noderun"),
    ],
}


def _without_device(src: bytes) -> bytes:
    src = re.sub(rb",\s*device=[\w.]+", b"", src)
    src = re.sub(rb"^.*\bdevice\b.*\n", b"", src, flags=re.M)
    return re.sub(rb"\n{3,}", b"\n\n", src)


@pytest.mark.parametrize("rel", sorted(DEVICE_SEAMS))
def test_device_seam_matches_reference(rel):
    port, ref = _read("rafting_tpu_torch", rel), _read("rafting_tpu", rel)
    assert b"device" in port and port != ref
    for pattern, repl in DEVICE_SEAMS[rel]:
        ref, n = re.subn(pattern, repl, ref, flags=re.M)
        assert n, pattern
    assert _without_device(port) == _without_device(ref), \
        f"rafting_tpu_torch/{rel} drifted outside its device seam"


def test_package_exports_match_reference():
    """Every public name of ``rafting_tpu`` (the API's included) is a
    public name of the port."""
    import types
    import rafting_tpu
    import rafting_tpu_torch
    names = {n for n, v in vars(rafting_tpu).items()
             if not n.startswith("_") and not isinstance(v, types.ModuleType)}
    assert names - set(rafting_tpu_torch.__all__) == set()
    for n in ("RaftContainer", "RaftConfig", "RaftFactory", "RaftStub",
              "load_xml_config"):
        assert getattr(rafting_tpu_torch, n).__module__.startswith(
            "rafting_tpu_torch.api.")


def test_runtime_imports_without_jax():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'rafting_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import rafting_tpu_torch.runtime.node\n"
        "import rafting_tpu_torch.testkit.harness\n"
        "import rafting_tpu_torch.transport\n"
        "import rafting_tpu_torch.log.store\n"
        "import rafting_tpu_torch.utils.profiling\n"
        "import rafting_tpu_torch.api\n"
        "import rafting_tpu_torch.admin\n"
        "import rafting_tpu_torch.machine.kv_machine\n"
        "import rafting_tpu_torch.log.memstore\n"
        "import rafting_tpu_torch.testkit.linz\n"
        "import rafting_tpu_torch.testkit.logcheck\n"
        "import rafting_tpu_torch.tools.noderun\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and\n"
        "       m.split('.')[0] in ('jax', 'flax', 'rafting_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


NODE_XML = """<raft>
  <cluster>
    <local>raft://127.0.0.1:7301</local>
    <remote>raft://127.0.0.1:7302</remote>
    <remote>raft://127.0.0.1:7303</remote>
  </cluster>
  <engine groups="4" log-slots="32" batch="4" max-submit="4"/>
  <storage dir="{dir}"/>
</raft>
"""


@pytest.mark.parametrize("entry", ["RaftNode", "LocalCluster",
                                   "RaftContainer", "noderun"])
def test_entry_points_need_a_card(tmp_path, monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if entry == "noderun":
        xml = tmp_path / "node0.xml"
        xml.write_text(NODE_XML.format(dir=tmp_path / "node0"))
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        res = subprocess.run(
            [sys.executable, "-m", "rafting_tpu_torch.tools.noderun",
             str(xml)], cwd=REPO, env=env, capture_output=True, text=True,
            timeout=120)
        assert res.returncode != 0 and "CUDA device" in res.stderr, \
            res.stderr[-2000:]
        assert "READY" not in res.stdout
        return
    with pytest.raises(RuntimeError, match="CUDA device"):
        if entry == "LocalCluster":
            LocalCluster(CFG, str(tmp_path))
        elif entry == "RaftContainer":
            from rafting_tpu_torch import RaftConfig, RaftContainer
            from rafting_tpu_torch.api import load_xml_config
            xml = tmp_path / "node0.xml"
            xml.write_text(NODE_XML.format(dir=tmp_path / "node0"))
            assert isinstance(load_xml_config(str(xml)), RaftConfig)
            RaftContainer(load_xml_config(str(xml))).create()
        else:
            RaftNode(CFG, 0, str(tmp_path), None, None)
