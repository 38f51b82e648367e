"""The node's device step on static buffers (``runtime/step_graph.py``), on
the CPU, against the JAX package's ``RaftNode``.

* Lane for lane: a JAX ``LocalCluster`` and the port's run in lockstep at
  8 groups x 3 nodes, with the durable pipeline off and on (and on with
  the flight recorder, heat lanes, CheckQuorum and debug checks), through an
  election, submissions, a lane closed and reopened, a follower killed
  while the others compact past its tail, and its restart with a
  snapshot install.  After every round, every node's whole engine state
  and the step info and outbox of its last tick are equal in the two
  packages (exact: every lane is int32 or bool).  Snapshot downloads and
  checkpoints run on worker threads, so each round waits for them before
  the next, in both clusters alike (``testkit/lockstep.py``,
  ``lanes=True``).
* The capture code's own rules, without a card: a graph needs a CUDA
  device; a capture records the kernel's launches and every replay
  counts them; a failed capture raises and leaves no graph; a closed
  node holds no graph, with no pass of the garbage collector; a lane the
  node replaced reaches the static state.
* The node's state at ``[G]`` lanes: the stepper hands back row-0 views
  of its static ``[1, G]`` buffers, copies into them only the leaves the
  node replaced (none on a tick where it replaced nothing), and the next
  step sees each such write.
"""

import contextlib
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from rafting_tpu.core.types import EngineConfig as JaxEngineConfig
from rafting_tpu.snapshot.policy import MaintainAgreement as JaxMaintain
from rafting_tpu.testkit.harness import LocalCluster as JaxLocalCluster
from rafting_tpu_torch import EngineConfig, LocalCluster
from rafting_tpu_torch.bridge import state_to_numpy
from rafting_tpu_torch.core import step as step_mod
from rafting_tpu_torch.core.step import node_step
from rafting_tpu_torch.core.types import (
    HostInbox, Messages, init_state, stack_states, tree_map,
)
from rafting_tpu_torch.ops import quorum
from rafting_tpu_torch.runtime.node import _fetch_trees
from rafting_tpu_torch.runtime.step_graph import NodeStepper, to_host
from rafting_tpu_torch.snapshot.policy import MaintainAgreement
from rafting_tpu_torch.testkit.lockstep import (
    PINNED_ENV, Lockstep, same_lanes,
)

CFG_KW = dict(n_groups=8, n_peers=3, log_slots=16, batch=4, max_submit=4,
              election_ticks=10, heartbeat_ticks=3, rpc_timeout_ticks=8)
MAINTAIN_KW = dict(state_change_threshold=2, dirty_log_tolerance=1,
                   snap_min_interval=2, compact_min_interval=2,
                   compact_slack=2)


# ------------------------------------------------- lane for lane with JAX --

def _fields(obj):
    return [f.name for f in dataclasses.fields(obj)]


def _collapse_backlog(cluster) -> None:
    """The port collapses any standing inbox backlog (``RaftNode`` sets
    ``COLLAPSE_BACKLOG`` 1, a fault of the reference's inbox fixed in the
    port only).  A pipeline barrier (the lane close) leaves two slices
    from one peer, so the JAX nodes here collapse them as the port's do,
    restarts included."""
    real = cluster.start_node

    def start_node(i):
        node = real(i)
        node.acc.COLLAPSE_BACKLOG = 1
        return node
    cluster.start_node = start_node
    for n in cluster.nodes.values():
        n.acc.COLLAPSE_BACKLOG = 1


SUBTREES = dict(trace_depth=16, heat=True, check_quorum=True,
                debug_checks=True)


@pytest.mark.parametrize("pipeline,subtrees", [
    (False, False), (True, False), (True, True)])
def test_carried_step_matches_jax_lane_for_lane(tmp_path, monkeypatch,
                                                 pipeline, subtrees):
    for k, v in PINNED_ENV.items():
        monkeypatch.setenv(k, v)
    G = CFG_KW["n_groups"]
    kw = dict(CFG_KW, **SUBTREES) if subtrees else CFG_KW
    jc = JaxLocalCluster(
        JaxEngineConfig(**kw), str(tmp_path / "jax"), pipeline=pipeline,
        maintain_factory=lambda: JaxMaintain(G, **MAINTAIN_KW))
    tc = LocalCluster(
        EngineConfig(**kw), str(tmp_path / "port"), pipeline=pipeline,
        maintain_factory=lambda: MaintainAgreement(G, **MAINTAIN_KW),
        device="cpu")
    try:
        assert all(n._stepper.capture is False for n in tc.nodes.values())
        _collapse_backlog(jc)
        ls = Lockstep([jc, tc], lanes=True)
        ls.tick_until(ls.all_led_ready, 400, "every group led and ready")
        ls.submit_all("a", 2)
        # A lane closed and reopened on every node.
        ls.each(lambda c: [n.set_active(3, False) for n in c.nodes.values()])
        ls.tick(4)
        ls.each(lambda c: [n.set_active(3, True) for n in c.nodes.values()])
        ls.tick_until(ls.all_led_ready, 400, "lane 3 led again")
        # A follower of group 0 misses the log past the compaction floor
        # and catches up through a snapshot install.
        victim = next(i for i in sorted(jc.nodes)
                      if i != int(ls.leaders()[0]))
        tail = int(tc.nodes[victim].h_commit[0])
        ls.each(lambda c: c.kill_node(victim))
        ls.tick_until(ls.all_led_ready, 400, "every group re-led")
        k = 0
        while not all(n.h_base[0] > tail for n in tc.nodes.values()):
            ls.submit_all(f"d{k}", 1)
            k += 1
            assert k < 60, "the compaction floor never passed the tail"
        ls.each(lambda c: c.restart_node(victim))
        lead = tc.nodes[int(ls.leaders()[0])]
        ls.tick_until(lambda: int(tc.nodes[victim].h_commit[0])
                      >= int(lead.h_commit[0]), 400, "snapshot catch-up")
        assert tc.nodes[victim].metrics["snapshots_installed"] > 0
        assert jc.nodes[victim].metrics["snapshots_installed"] > 0
        ls.tick_until(ls.all_led_ready, 400, "every group led and ready")
        ls.submit_all("z", 2)
        ls.tick(10)
        assert ls.rounds >= 64
    finally:
        jc.close()
        tc.close()


# ----------------------------------------------- the capture code's rules --

CFG = EngineConfig(**CFG_KW)


def _inputs(cfg):
    host = {f: np.asarray(getattr(HostInbox.empty(cfg, "cpu"), f))
            for f in _fields(HostInbox.empty(cfg, "cpu"))
            if getattr(HostInbox.empty(cfg, "cpu"), f) is not None}
    host["read_veto"] = np.asarray(False)
    host["submit_n"] = np.full(cfg.n_groups, 2, np.int32)
    arrays = {f: np.asarray(getattr(Messages.empty(cfg, "cpu"), f))
              for f in _fields(Messages.empty(cfg, "cpu"))}
    return host, arrays


def _state(cfg):
    return init_state(cfg, 0, seed=3, device="cpu")


def _row0(tree):
    return tree_map(lambda t: t[0], tree)


def test_a_graph_needs_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        NodeStepper(CFG, torch.device("cpu"), _fetch_trees, capture=True)


def test_uncaptured_step_equals_node_step_and_adopts_replaced_lanes():
    host, arrays = _inputs(CFG)
    st = NodeStepper(CFG, torch.device("cpu"), _fetch_trees,
                     capture=False)
    ref = stack_states([_state(CFG)])
    s = _state(CFG)
    to_t = lambda d: {k: torch.from_numpy(np.array(v)).unsqueeze(0)
                      for k, v in d.items()}
    for t in range(30):
        if t == 12:
            # The node replaces a lane (a lifecycle write): the static
            # state takes it at the next step.
            closed = s.active.clone()
            closed[5] = False
            s = s.replace(active=closed)
            ref = ref.replace(active=closed[None].clone())
        ref, ro, ri = node_step(CFG, ref, Messages(**to_t(arrays)),
                                HostInbox(**to_t(host)))
        s, so, si, packed = st.step(s, host, arrays)
        assert s is st.state
        # [G] lanes, shape and value: node_step's row 0.
        same_lanes(s, _row0(ref), f"tick {t} state")
        same_lanes(so, _row0(ro), f"tick {t} outbox")
        same_lanes(si, _row0(ri), f"tick {t} info")
        # What the step packed reads back as the lanes themselves do.
        for a, b in zip(to_host(_fetch_trees(s, so, si), packed),
                        to_host(_fetch_trees(s, so, si))):
            tree_map(np.testing.assert_array_equal, a, b)
    assert not bool(st.state.active[5])
    assert st.copied == 1


def test_adopt_copies_only_the_leaves_the_node_replaced():
    """After the first step the node holds the stepper's own views: a step
    given them back copies nothing; a step given one replaced leaf copies
    that leaf alone, into the static state the views read, and the step
    runs on it (as ``node_step`` does on the same state)."""
    host, arrays = _inputs(CFG)
    to_t = lambda d: {k: torch.from_numpy(np.array(v)).unsqueeze(0)
                      for k, v in d.items()}
    ref = stack_states([_state(CFG)])

    def ref_step():
        nonlocal ref
        ref, _, ri = node_step(CFG, ref, Messages(**to_t(arrays)),
                               HostInbox(**to_t(host)))
        return ri
    st = NodeStepper(CFG, torch.device("cpu"), _fetch_trees,
                     capture=False)
    s, *_ = st.step(_state(CFG), host, arrays)
    ref_step()
    static = {t.untyped_storage().data_ptr()
              for t in (st._static.term, st._static.log.last)}
    assert s.term.untyped_storage().data_ptr() in static
    assert s.now.shape == () and st._static.now.shape == (1,)
    for _ in range(6):
        s, *_ = st.step(s, host, arrays)
        ref_step()
    assert st.copied == 0
    closed = s.active.clone()
    closed[2] = False
    ref = ref.replace(active=closed[None].clone())
    s, _, info, _ = st.step(s.replace(active=closed), host, arrays)
    same_lanes(info, _row0(ref_step()), "info")
    same_lanes(s, _row0(ref), "state")
    assert st.copied == 1
    assert not bool(st._static.active[0, 2]) and s.active is st.state.active
    for _ in range(12):
        s, *_ = st.step(s, host, arrays)
        ref_step()
    same_lanes(s, _row0(ref), "state")
    assert st.copied == 1 and not bool(s.active[2])


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph on the CPU: the captured body
    runs for real (nothing intercepts it) and a replay does nothing."""
    fail = False
    replays = 0

    def capture_begin(self, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"

    def capture_end(self):
        if self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    def replay(self):
        _FakeGraph.replays += 1


@pytest.fixture
def fake_capture(monkeypatch):
    """A stepper on the CPU whose capture and replay go through fakes, and
    a quorum_commit that counts a launch per call, as the card's does."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    real = step_mod.quorum_commit

    def counted(*a, **k):
        quorum._count_launch("quorum_commit")
        return real(*a, **k)
    monkeypatch.setattr(step_mod, "quorum_commit", counted)
    monkeypatch.setattr(_FakeGraph, "fail", False)
    _FakeGraph.replays = 0
    quorum.reset_launch_counts()
    st = NodeStepper(CFG, torch.device("cpu"), _fetch_trees,
                     capture=False)
    st.capture, st._stream = True, _FakeStream()
    yield st
    quorum.reset_launch_counts()


def test_replays_count_the_launches_their_capture_recorded(fake_capture):
    st = fake_capture
    host, arrays = _inputs(CFG)
    s = _state(CFG)
    s, *_ = st.step(s, host, arrays)          # warm-up: runs, counts 1
    assert quorum.launch_counts["quorum_commit"] == 1
    s, *_ = st.step(s, host, arrays)          # capture (counts nothing
    assert st.captures == 1                   # itself), then one replay
    assert _FakeGraph.replays == 1
    assert quorum.launch_counts["quorum_commit"] == 2
    for _ in range(5):
        s, *_ = st.step(s, host, arrays)
    assert st.captures == 1 and st.replays == 6 and _FakeGraph.replays == 6
    assert quorum.launch_counts["quorum_commit"] == 7
    assert quorum.strided_launches["quorum_commit"] == 0
    # A new layout of the host lanes (durable_tail appears) is captured
    # once more.
    host2 = dict(host, durable_tail=np.zeros(CFG.n_groups, np.int32))
    st.step(s, host2, arrays)
    assert st.captures == 2 and quorum.launch_counts["quorum_commit"] == 8


def test_a_capture_records_its_layout_and_its_wait_for_the_lock(
        fake_capture):
    """Each capture lists its layout's lanes with the seconds it waited
    for the process-wide capture lock (held here by another thread) and
    the seconds it took."""
    import threading
    from rafting_tpu_torch.runtime import step_graph
    st = fake_capture
    host, arrays = _inputs(CFG)
    s, *_ = st.step(_state(CFG), host, arrays)
    held, release = threading.Event(), threading.Event()

    def hold():
        with step_graph._CAPTURE_LOCK:
            held.set()
            release.wait(10)
    t = threading.Thread(target=hold)
    t.start()
    held.wait(10)
    threading.Timer(0.2, release.set).start()
    s, *_ = st.step(s, host, arrays)
    t.join(10)
    assert not t.is_alive()
    st.step(s, dict(host, durable_tail=np.zeros(CFG.n_groups, np.int32)),
            arrays)
    assert st.captures == len(st.layouts) == 2
    (k1, w1, c1), (k2, w2, c2) = st.layouts
    assert w1 >= 0.15 and st.lock_wait_s >= w1 and c1 > 0 and c2 > 0
    lanes = lambda key: {(i, name) for i, name, _, _ in key}
    assert lanes(k2) - lanes(k1) == {(0, "durable_tail")}


def test_a_failed_capture_raises_and_leaves_no_graph(fake_capture,
                                                      monkeypatch):
    st = fake_capture
    host, arrays = _inputs(CFG)
    s = _state(CFG)
    s, *_ = st.step(s, host, arrays)
    monkeypatch.setattr(_FakeGraph, "fail", True)
    with pytest.raises(RuntimeError, match="does not run eagerly"):
        st.step(s, host, arrays)
    assert st.captures == 0 and _FakeGraph.replays == 0
    assert all(lay.graph is None for lay in st._layouts.values())
    # Nothing it recorded was counted, and counting is back on.
    assert quorum.launch_counts["quorum_commit"] == 1
    quorum._count_launch("quorum_commit")
    assert quorum.launch_counts["quorum_commit"] == 2



def test_a_closed_node_holds_no_graph(fake_capture, monkeypatch, tmp_path):
    """``RaftNode.close`` releases its step's graphs, their outputs and
    buffers and the static state once the tick thread has stopped: the
    graph is gone when close returns, with the collector off throughout,
    so it never dies later on another node's capturing thread."""
    for k, v in PINNED_ENV.items():
        monkeypatch.setenv(k, v)
    tc = LocalCluster(CFG, str(tmp_path / "port"), device="cpu")
    try:
        for n in tc.nodes.values():
            n._stepper.capture, n._stepper._stream = True, _FakeStream()
        tc.tick(4)
        node = tc.nodes[0]
        st = node._stepper
        graphs = [weakref.ref(lay.graph) for lay in st._layouts.values()]
        assert st.captures >= 1 and st.replays >= 1 and graphs
        gc.disable()
        try:
            tc.kill_node(0)
            assert not st._layouts and st.state is None
            assert st._static is None
            assert all(g() is None for g in graphs)
            # What the node read last stays readable after its close.
            assert node.state.term.shape == (CFG.n_groups,)
        finally:
            gc.enable()
    finally:
        tc.close()
