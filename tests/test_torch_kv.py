"""The KV machine, the log-store SPI and the read plane through the
port's ``RaftStub``, on the CPU, against the JAX package's.

* Lockstep KV parity: a JAX ``LocalCluster`` and the port's, each with
  its package's ``KVMachineProvider``, run KV ``set``/``get`` traffic
  through their package's ``RaftStub`` round by round (a leader dies and
  restarts from its log store half way).  The host mirrors of every node
  are equal at every round, every outcome is equal, and at the end every
  node's KV machine holds the same data.  Once on the WAL, once on
  ``MemoryLogStore``.
* The ``kv_cluster`` flows and the stub redirect cap of
  ``tests/test_read_runtime.py``, and the cluster cases of
  ``tests/test_log_spi.py``, on the port.

Port clusters run with ``device="cpu"``, ticked by hand.
"""

import json
import os
import threading
import time

import pytest

from rafting_tpu.api.stub import RaftStub as JaxRaftStub
from rafting_tpu.core.types import EngineConfig as JaxEngineConfig
from rafting_tpu.log.memstore import MemoryLogStore as JaxMemoryLogStore
from rafting_tpu.machine.kv_machine import (
    KVMachineProvider as JaxKVMachineProvider,
)
from rafting_tpu.testkit.harness import LocalCluster as JaxLocalCluster
from rafting_tpu_torch import EngineConfig, LocalCluster
from rafting_tpu_torch.api import NotLeaderError, RaftConfig, RaftFactory
from rafting_tpu_torch.api.anomaly import is_refusal
from rafting_tpu_torch.api.serial import JsonSerializer
from rafting_tpu_torch.api.stub import RaftStub
from rafting_tpu_torch.log import LogStoreSPI, MemoryLogStore
from rafting_tpu_torch.machine import KVMachineProvider
from rafting_tpu_torch.testkit.lockstep import PINNED_ENV, Lockstep


def _kv(op, k, v=None) -> bytes:
    cmd = {"op": op, "k": k}
    if v is not None:
        cmd["v"] = v
    return json.dumps(cmd).encode()


class _Container:
    """What a stub reads of its container: the node and the name->lane
    lookup (tests/test_read_runtime.py's ``_FakeContainer``)."""

    def __init__(self, node):
        self._node = node

    def _lookup(self, name):
        return int(name[1:])


# ------------------------------------------------------ lockstep KV parity --

KV_KW = dict(n_groups=16, n_peers=3, log_slots=32, batch=4, max_submit=4,
             election_ticks=10, heartbeat_ticks=3, rpc_timeout_ticks=8)


def _kv_wave(ls, stubs_of, w):
    """Two sets of wave-``w`` keys and one get of the previous wave's key
    in every group, through each cluster's stub on the group's leader;
    returns the outcomes (equal in every cluster)."""
    lead = ls.leaders()
    futs = []
    for c, Stub in stubs_of:
        cf = []
        for g in range(lead.size):
            stub = Stub(_Container(c.nodes[int(lead[g])]), f"g{g}", g,
                        forward=False)
            cf.append(stub.submit(_kv("set", f"a{w}", f"g{g}w{w}")))
            cf.append(stub.submit(_kv("set", f"b{w}", w * 100 + g)))
            cf.append(stub.read(_kv("get", f"a{w - 1}")))
        futs.append(cf)
    ls.tick_until(lambda: all(f.done() for cf in futs for f in cf), 400,
                  f"wave {w} settled")
    out = [[(type(f.exception()).__name__, None) if f.exception()
            else ("ok", f.result()) for f in cf] for cf in futs]
    for k, o in enumerate(out[1:], 1):
        assert o == out[0], f"wave {w}: outcomes differ in cluster {k}"
    return out[0]


def _kv_data(cluster) -> dict:
    return {(i, g): (n.dispatcher.machine(g).data,
                     n.dispatcher.machine(g).last_applied())
            for i, n in sorted(cluster.nodes.items())
            for g in range(cluster.cfg.n_groups)}


@pytest.mark.parametrize("store", ["wal", "memory"])
def test_kv_lockstep_parity_with_jax(tmp_path, monkeypatch, store):
    for k, v in PINNED_ENV.items():
        monkeypatch.setenv(k, v)
    root_j, root_t = str(tmp_path / "jax"), str(tmp_path / "port")
    memory = store == "memory"
    jc = JaxLocalCluster(
        JaxEngineConfig(**KV_KW), root_j,
        provider_factory=lambda i: JaxKVMachineProvider(
            os.path.join(root_j, f"kv{i}")),
        store_factory=(lambda i: JaxMemoryLogStore()) if memory else None)
    tc = LocalCluster(
        EngineConfig(**KV_KW), root_t, device="cpu",
        provider_factory=lambda i: KVMachineProvider(
            os.path.join(root_t, f"kv{i}")),
        store_factory=(lambda i: MemoryLogStore()) if memory else None)
    try:
        ls = Lockstep([jc, tc])
        stubs_of = [(jc, JaxRaftStub), (tc, RaftStub)]
        ls.check()
        ls.tick_until(ls.all_led_ready, 600, "every group led and ready")
        outcomes = [_kv_wave(ls, stubs_of, w) for w in range(3)]
        victim = int(ls.leaders()[0])
        ls.each(lambda c: c.kill_node(victim))
        ls.tick_until(ls.all_led_ready, 600, "re-led among the survivors")
        outcomes += [_kv_wave(ls, stubs_of, w) for w in range(3, 5)]
        ls.each(lambda c: c.restart_node(victim))
        ls.tick_until(ls.all_led_ready, 600, "led after the restart")
        outcomes.append(_kv_wave(ls, stubs_of, 5))
        ls.tick(40)
        G = KV_KW["n_groups"]
        for w, wave in enumerate(outcomes):
            # Each get reads the key the previous wave set.
            assert wave == [o for g in range(G) for o in (
                ("ok", f"g{g}w{w}"), ("ok", w * 100 + g),
                ("ok", f"g{g}w{w - 1}" if w else None))], f"wave {w}"
        want, got = _kv_data(jc), _kv_data(tc)
        assert got == want
        for (i, g), (data, _) in got.items():   # the restarted node too
            assert data["b5"] == 500 + g and data["a5"] == f"g{g}w5"
    finally:
        jc.close()
        tc.close()


# -------------------------------- the kv_cluster flows of test_read_runtime --

def _cfg(**kw) -> EngineConfig:
    base = dict(n_groups=2, n_peers=3, log_slots=32, batch=4, max_submit=4,
                election_ticks=6, heartbeat_ticks=2, rpc_timeout_ticks=5,
                pre_vote=True)
    base.update(kw)
    return EngineConfig(**base)


@pytest.fixture
def kv_cluster(tmp_path):
    root = str(tmp_path)
    lc = LocalCluster(
        _cfg(), root, device="cpu",
        provider_factory=lambda i: KVMachineProvider(
            os.path.join(root, f"kv{i}")))
    try:
        yield lc
    finally:
        lc.close()


def _ready_leader(lc, group=0):
    leader = lc.wait_leader(group)
    node = lc.nodes[leader]
    lc.tick_until(lambda: node.is_ready(group), what="leader ready")
    return leader, node


def _read_after_write(lc):
    _, node = _ready_leader(lc)
    wf = node.submit(0, _kv("set", "a", 42))
    lc.tick_until(wf.done, what="write applied")
    assert wf.result() == 42
    rf = node.read(0, _kv("get", "a"))
    lc.tick_until(rf.done, what="read served")
    assert rf.result() == 42
    bf = node.read_batch(0, [_kv("get", "a"), _kv("get", "missing")])
    lc.tick_until(bf.done, what="read batch served")
    assert bf.result() == [42, None]
    assert node.metrics["reads_served"] >= 3
    tail_after = node.store.tail(0)
    rf2 = node.read(0, _kv("get", "a"))
    lc.tick_until(rf2.done, what="second read")
    assert node.store.tail(0) == tail_after


def _follower_read_refused(lc):
    leader, _ = _ready_leader(lc)
    fut = lc.nodes[(leader + 1) % 3].read(0, _kv("get", "a"))
    assert fut.done()
    exc = fut.exception()
    assert isinstance(exc, NotLeaderError)
    assert exc.leader == leader
    assert is_refusal(exc)


def _forward_read(lc):
    leader, node = _ready_leader(lc)
    wf = node.submit(0, _kv("set", "k", "v1"))
    lc.tick_until(wf.done, what="write applied")
    follower = lc.nodes[(leader + 1) % 3]
    box = {}

    def relay():
        box["res"] = follower.transport.forward_read(
            leader, 0, _kv("get", "k"), timeout=60.0)

    th = threading.Thread(target=relay, daemon=True)
    th.start()
    lc.tick_until(lambda: "res" in box, what="forwarded read",
                  max_rounds=20000)
    th.join(timeout=60)
    ok, raw = box["res"]
    assert ok, raw
    assert json.loads(raw) == "v1"


def _read_survives_veto_pause(lc):
    _, node = _ready_leader(lc)
    wf = node.submit(0, _kv("set", "p", 7))
    lc.tick_until(wf.done, what="write applied")
    node._tick_interval = 0.02
    node._last_tick_wall = time.monotonic() - 10.0
    rf = node.read(0, _kv("get", "p"))
    node.tick()
    assert node.metrics["read_vetoes"] >= 1
    assert node._read_veto_hold == max(node.cfg.read_fresh_ticks, 2) - 1
    lc.tick_until(rf.done, what="read after pause")
    assert rf.result() == 7
    node._tick_interval = None


def _metrics_expose_read_counters(lc):
    _, node = _ready_leader(lc)
    wf = node.submit(0, _kv("set", "m", 1))
    lc.tick_until(wf.done, what="write applied")
    rf = node.read(0, _kv("get", "m"))
    lc.tick_until(rf.done, what="read served")
    text = node.metrics.render_prometheus()
    assert "raft_reads_served_total" in text
    assert "raft_read_barrier_latency_s_count" in text
    assert "raft_read_lease_hits_total" in text


def _stub_on_every_node(lc):
    """The port's RaftStub on each node: the leader's serves locally, a
    follower's relays to the leader over the forward channel."""
    leader, node = _ready_leader(lc)
    stubs = {i: RaftStub(_Container(n), "g0", 0)
             for i, n in lc.nodes.items()}
    wf = stubs[leader].submit(_kv("set", "s", "local"))
    lc.tick_until(wf.done, what="local submit")
    assert wf.result() == "local"
    fol = (leader + 1) % 3
    futs = [stubs[fol].submit(_kv("set", "s", "relayed")),
            stubs[fol].read(_kv("get", "s"))]
    lc.tick_until(lambda: all(f.done() for f in futs), 20000,
                  "forwarded submit and read")
    assert futs[0].result() == "relayed"
    assert futs[1].result() in ("local", "relayed")
    rf = stubs[fol].read(_kv("get", "s"))
    lc.tick_until(rf.done, 20000, "forwarded read after the write")
    assert rf.result() == "relayed"


KV_SCENARIOS = {
    "read_after_write_linearizable": _read_after_write,
    "follower_read_refused_with_hint": _follower_read_refused,
    "forward_read_follower_to_leader": _forward_read,
    "read_survives_veto_pause": _read_survives_veto_pause,
    "node_metrics_expose_read_counters": _metrics_expose_read_counters,
    "stub_on_every_node": _stub_on_every_node,
}


@pytest.mark.parametrize("name", sorted(KV_SCENARIOS))
def test_kv_scenario(kv_cluster, name):
    KV_SCENARIOS[name](kv_cluster)


class _StuckFollowerNode:
    """Never leads, never learns a hint (test_read_runtime.py's fake):
    counts how often the stub asks."""

    node_id = 0
    serializer = JsonSerializer()

    def __init__(self):
        self.asked = 0

        class _T:
            def forward_submit(self, peer, lane, payload, timeout=None):
                raise AssertionError("no hint -> no forward expected")

            forward_read = forward_submit

        self.transport = _T()

    def is_leader(self, lane):
        return False

    def leader_hint(self, lane):
        self.asked += 1
        return None

    def submit(self, lane, payload):
        raise AssertionError("not leader -> no local submit expected")

    read = submit


@pytest.mark.parametrize("op", ["submit", "read"])
def test_stub_redirect_cap_no_hint(op):
    """With a budget of minutes left, a hintless election fails after
    ``max_redirects`` retries (counted, not timed)."""
    node = _StuckFollowerNode()
    stub = RaftStub(_Container(node), "g0", 0, forward=True,
                    forward_budget=300.0, max_redirects=3)
    with pytest.raises(NotLeaderError):
        getattr(stub, op)(b"x").result(timeout=120)
    assert node.asked == 4


# --------------------------------------- the cluster cases of test_log_spi --

SPI_CFG = EngineConfig(n_groups=4, n_peers=3, log_slots=32, batch=4,
                       max_submit=4, election_ticks=10, heartbeat_ticks=3,
                       rpc_timeout_ticks=5)


def test_cluster_runs_on_memory_store(tmp_path):
    c = LocalCluster(SPI_CFG, str(tmp_path), device="cpu",
                     store_factory=lambda i: MemoryLogStore())
    try:
        assert c.submit_via_leader(0, b"hello-spi") is not None
        c.assert_file_parity(0)
        for i in range(3):
            assert not os.path.exists(tmp_path / f"node{i}" / "wal")
            assert isinstance(c.nodes[i].store, MemoryLogStore)
            assert isinstance(c.nodes[i].store, LogStoreSPI)
    finally:
        c.close()


def test_factory_log_store_hook(tmp_path):
    class MemFactory(RaftFactory):
        def log_store(self, config, node_id):
            return MemoryLogStore()

    cfg = RaftConfig(local="raft://127.0.0.1:7101",
                     peers=("raft://127.0.0.1:7102", "raft://127.0.0.1:7103"),
                     data_dir=str(tmp_path / "n0"), n_groups=2)
    node = MemFactory().build_node(cfg, device="cpu")
    try:
        assert isinstance(node.store, MemoryLogStore)
        assert node.state.term.device.type == "cpu"
    finally:
        node.close()


def test_memstore_node_crash_restarts_empty_and_catches_up(tmp_path):
    c = LocalCluster(SPI_CFG, str(tmp_path), device="cpu",
                     store_factory=lambda i: MemoryLogStore())
    try:
        c.submit_via_leader(0, b"before-crash")
        lead = c.leader_of(0)
        victim = next(i for i in c.nodes if i != lead)
        c.kill_node(victim)
        for k in range(6):
            c.submit_via_leader(0, f"during-{k}".encode())
        v = c.restart_node(victim)
        assert v.store.tail(0) == 0, "memory store must restart empty"
        c.submit_via_leader(0, b"after-restart")
        c.tick_until(
            lambda: int(v.h_commit[0]) > 0
            and int(v.h_commit[0]) >= int(c.nodes[c.leader_of(0)]
                                          .h_commit[0]) - 1,
            500, "blank memstore node catch-up")
    finally:
        c.close()
