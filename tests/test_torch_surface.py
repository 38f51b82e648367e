"""The port's public surface against the reference's, on the CPU: twins of
the reference's own test cases, each run on both packages from the same
seeds and held lane for lane.

* ``RaftNode.state`` at ``[G]`` lanes: a destroyed lane read back as
  ``node.state.log.last[1]`` (``tests/test_admin.py``), a term written at
  lane 0 that trips the int32 guard (``tests/test_i32_guard.py``; the
  port writes it with torch), the flight recorder's rings saved from
  ``node.state.trace`` (``utils/tracelog.save_dump``), and every leaf's
  shape and dtype, ``now`` 0-d, before the first tick and after.
* numpy operands at the cluster entry points: a ``DeviceCluster.conn``
  assigned a numpy array (``tests/test_invariants_chaos.py``'s message
  drops, ``tests/test_health_ready.py``'s wedged window, cut to a few
  ticks), and ``run_cluster_ticks`` / ``run_cluster_ticks_nemesis`` /
  ``committed_entries`` given numpy ``conn``, ``submit_n`` and fault
  masks.
* The node's step copies into its static state only the leaves the node
  replaced: none on a tick where it replaced nothing.

Each case runs as ``[jax]`` (the reference package, its own assertions)
and ``[port]`` (the same assertions on the port, then every lane it ends
with against the JAX run's, exactly: shape and value).  The node cases
run inside ``pinned_env`` (no wall-clock planes), so both packages tick
the same rounds.
"""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from rafting_tpu_torch.bridge import state_to_numpy
from rafting_tpu_torch.core.types import tree_map
from rafting_tpu_torch.testkit.lockstep import pinned_env, same_lanes

PKGS = ["jax", "port"]


@functools.lru_cache(maxsize=None)
def _pkg(name: str) -> SimpleNamespace:
    """One package's entry points, each on the CPU."""
    if name == "jax":
        import rafting_tpu as R
        from rafting_tpu.core import sim
        from rafting_tpu.core.types import FaultSchedule, I32_SAFE_MAX
        from rafting_tpu.testkit import ClusterChecker
        from rafting_tpu.testkit.fixtures import NullProvider
        from rafting_tpu.testkit.harness import LocalCluster
        from rafting_tpu.utils import tracelog
        return SimpleNamespace(
            EngineConfig=R.EngineConfig, DeviceCluster=R.DeviceCluster,
            LocalCluster=LocalCluster, sim=sim, run={}, tracelog=tracelog,
            FaultSchedule=FaultSchedule, I32_SAFE_MAX=I32_SAFE_MAX,
            ClusterChecker=ClusterChecker, NullProvider=NullProvider,
            set_lane=lambda a, i, v: a.at[i].set(v),
            host=lambda tree: jax.tree.map(np.asarray, tree))
    import rafting_tpu_torch as R
    from rafting_tpu_torch.core import sim
    from rafting_tpu_torch.core.types import FaultSchedule, I32_SAFE_MAX
    from rafting_tpu_torch.testkit import ClusterChecker
    from rafting_tpu_torch.testkit.fixtures import NullProvider
    from rafting_tpu_torch.testkit.harness import LocalCluster
    from rafting_tpu_torch.utils import tracelog

    def set_lane(a, i, v):
        a = a.clone()
        a[i] = v
        return a
    return SimpleNamespace(
        EngineConfig=R.EngineConfig,
        DeviceCluster=functools.partial(R.DeviceCluster, device="cpu"),
        LocalCluster=functools.partial(LocalCluster, device="cpu"),
        sim=sim, run={"device": "cpu"}, tracelog=tracelog,
        FaultSchedule=FaultSchedule,
        I32_SAFE_MAX=I32_SAFE_MAX, ClusterChecker=ClusterChecker,
        NullProvider=NullProvider, set_lane=set_lane,
        host=lambda tree: tree_map(lambda t: t.detach().cpu().clone(),
                                   tree))


def _node_lanes(P, c) -> dict:
    return {f"node{i}": P.host(n.state) for i, n in sorted(c.nodes.items())}


# ------------------------------------------------------------------ twins --

def destroy_purges_lane_for_reuse(P, root):
    """tests/test_admin.py::test_destroy_purges_lane_for_reuse."""
    cfg = P.EngineConfig(n_groups=3, n_peers=3, log_slots=16, batch=4,
                         max_submit=4)
    c = P.LocalCluster(cfg, root)
    try:
        c.wait_leader(1)
        for k in range(3):
            c.submit_via_leader(1, f"old-{k}".encode())
        c.tick(5)
        assert c.command_payloads(c.leader_of(1), 1) == \
            ["old-0", "old-1", "old-2"]
        for node in c.nodes.values():
            node.set_active(1, False, purge=True)
        c.tick(3)
        purged = _node_lanes(P, c)
        for i, node in c.nodes.items():
            assert node.store.tail(1) == 0
            assert node.store.stable(1) is None
            assert int(node.state.log.last[1]) == 0
            assert int(node.state.term[1]) == 0
            assert c.machine_lines(i, 1) == []
        for node in c.nodes.values():
            node.set_active(1, True)
        c.wait_leader(1)
        res = c.submit_via_leader(1, b"new-0")
        c.tick(5)
        lead = c.leader_of(1)
        assert c.command_payloads(lead, 1) == ["new-0"]
        assert res == len(c.machine_lines(lead, 1))
        return {"purged": purged, "reused": _node_lanes(P, c)}
    finally:
        c.close()


def runtime_guard_trips_loudly(P, root):
    """tests/test_i32_guard.py::test_runtime_guard_trips_loudly (the port
    writes lane 0 of ``term`` with torch)."""
    cfg = P.EngineConfig(n_groups=2, n_peers=3, log_slots=16, batch=4,
                         max_submit=4, election_ticks=10, heartbeat_ticks=3)
    c = P.LocalCluster(cfg, root, provider_factory=lambda i: P.NullProvider())
    try:
        c.tick(2)
        node = c.nodes[0]
        before = P.host(node.state)
        node.state = node.state.replace(
            term=P.set_lane(node.state.term, 0, P.I32_SAFE_MAX))
        with pytest.raises(OverflowError, match="I32_SAFE_MAX"):
            node.tick()
        if hasattr(node, "_stepper"):
            # The replaced term reached the static state: one leaf copied.
            assert node._stepper.copied == 1
        return {"before": before, "tripped": P.host(node.state)}
    finally:
        c.close()


def trace_dump_of_node_state(P, root):
    """``save_dump(path, node.state.trace)`` (the flight recorder's rings
    of one node, as tools/dump_timeline.py reads them) after an election
    and a few commands: the dump's lanes, loaded back."""
    cfg = P.EngineConfig(n_groups=3, n_peers=3, log_slots=16, batch=4,
                         max_submit=4, trace_depth=16)
    c = P.LocalCluster(cfg, root)
    try:
        c.wait_leader(0)
        for k in range(3):
            c.submit_via_leader(0, f"t-{k}".encode())
        c.tick(3)
        path = f"{root}/dump.json.gz"
        P.tracelog.save_dump(path, c.nodes[c.leader_of(0)].state.trace)
        lanes = P.tracelog.load_dump(path)
        assert lanes["n"].shape == (3,) and lanes["tick"].shape == (3, 16)
        assert int(lanes["n"][0]) > 0
        return lanes
    finally:
        c.close()


def chaos_message_level_drops(P, root):
    """tests/test_invariants_chaos.py::test_chaos_message_level_drops at
    seed 21, 60 flapping ticks and 20 healed (the reference runs 150 and
    30): ``c.conn`` is assigned a numpy array every tick."""
    seed = 21
    cfg = P.EngineConfig(n_groups=8, n_peers=3, log_slots=16, batch=4,
                         max_submit=2, election_ticks=6, heartbeat_ticks=2,
                         rpc_timeout_ticks=5, pre_vote=True)
    rng = np.random.default_rng(seed)
    c = P.DeviceCluster(cfg, seed=seed)
    chk = P.ClusterChecker(cfg)
    for t in range(60):
        conn = rng.random((3, 3)) > 0.2
        np.fill_diagonal(conn, True)
        c.conn = np.asarray(conn)
        c.tick(submit_n=2)
        if t % 3 == 0:
            chk.check(c.snapshot())
    c.heal()
    for _ in range(20):
        c.tick(submit_n=2)
    snap = c.snapshot()
    chk.check(snap)
    chk.check_log_matching(snap)
    assert (snap["commit"].max(axis=0) > 0).all()
    return {"states": P.host(c.states)}


def heartbeats_flow_through_wedged_window(P, root):
    """tests/test_health_ready.py::test_heartbeats_flow_through_wedged_window
    at two of its three configs, with the reply links cut by a numpy
    ``conn``."""
    out = {}
    for il, et, hb in [(1, 4, 3), (4, 10, 3)]:
        cfg = P.EngineConfig(n_groups=1, n_peers=3, log_slots=32, batch=4,
                             max_submit=4, election_ticks=et,
                             heartbeat_ticks=hb, rpc_timeout_ticks=8,
                             inflight_limit=il)
        c = P.DeviceCluster(cfg, seed=2)
        for _ in range(40 * et):
            c.tick(submit_n=cfg.max_submit)
            if len(c.leaders(0)) == 1:
                break
        leads = c.leaders(0)
        assert len(leads) == 1, f"no leader elected (cfg {il},{et},{hb})"
        lead = leads[0]
        followers = [n for n in range(3) if n != lead]
        conn = np.ones((3, 3), bool)
        for f in followers:
            conn[f, lead] = False
        c.conn = conn
        term0 = int(np.asarray(c.snapshot()["term"])[lead, 0])
        for t in range(6 * 2 * et):
            c.tick(submit_n=cfg.max_submit)
            roles = c.snapshot()["role"]
            for f in followers:
                assert roles[f, 0] == 0, (
                    f"follower {f} left FOLLOWER at tick {t} "
                    f"(cfg {il},{et},{hb})")
            assert int(c.snapshot()["term"][lead, 0]) == term0
        out[f"cfg{il}_{et}_{hb}"] = P.host(c.states)
    return out


def cluster_ticks_take_numpy(P, root):
    """``run_cluster_ticks`` with a numpy ``conn`` and ``submit_n``, then a
    numpy partition, ``run_cluster_ticks_nemesis`` with numpy fault masks
    and ``submit_n``, and ``committed_entries``."""
    N, G, T = 3, 8, 12
    cfg = P.EngineConfig(n_groups=G, n_peers=N, log_slots=16, batch=4,
                         max_submit=2, election_ticks=6, heartbeat_ticks=2)
    c = P.DeviceCluster(cfg, seed=5)
    submit = np.full((N, G), 2, np.int32)
    st, fl, info = P.sim.run_cluster_ticks(
        cfg, 30, c.states, c.inflight, c.last_info, np.ones((N, N), bool),
        submit, **P.run)
    healthy = P.host(st)
    cut = np.ones((N, N), bool)
    cut[0, 1:] = cut[1:, 0] = False
    st, fl, info = P.sim.run_cluster_ticks(cfg, 10, st, fl, info, cut,
                                           submit, **P.run)
    rng = np.random.default_rng(7)
    link = rng.random((T, N, N)) > 0.3
    sched = P.FaultSchedule(
        link_up=link, crash=rng.random((T, N)) < 0.1,
        stall=rng.random((T, N)) < 0.1, dup=rng.random((T, N, N)) < 0.2)
    st, fl, info = P.sim.run_cluster_ticks_nemesis(
        cfg, st, fl, info, sched, submit, **P.run)
    total = int(P.sim.committed_entries(st))
    assert total > 0
    return {"healthy": healthy, "chaos": P.host(st), "info": P.host(info),
            "inflight": P.host(fl), "total": total}


CASES = {f.__name__: f for f in (
    destroy_purges_lane_for_reuse, runtime_guard_trips_loudly,
    trace_dump_of_node_state, chaos_message_level_drops,
    heartbeats_flow_through_wedged_window, cluster_ticks_take_numpy)}
_RUNS: dict = {}


def _run(case: str, pkg: str, tmp_path_factory):
    if (case, pkg) not in _RUNS:
        root = str(tmp_path_factory.mktemp(f"{case}-{pkg}"))
        with pinned_env():
            _RUNS[case, pkg] = CASES[case](_pkg(pkg), root)
    return _RUNS[case, pkg]


def _same(port, ref, path):
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref), path
        for k in port:
            _same(port[k], ref[k], f"{path}.{k}")
    elif dataclasses.is_dataclass(port):
        same_lanes(port, ref, path)
    elif isinstance(port, np.ndarray):
        assert port.shape == ref.shape, path
        np.testing.assert_array_equal(port, ref, err_msg=path)
    else:
        assert port == ref, f"{path}: {port} vs {ref}"


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_case_on_both_packages(case, pkg, tmp_path_factory):
    got = _run(case, pkg, tmp_path_factory)
    if pkg == "port":
        _same(got, _run(case, "jax", tmp_path_factory), case)


# ------------------------------------------- RaftNode.state's own shapes --

def _shapes(tree, path="state") -> dict:
    """path -> (shape, dtype) of every leaf of a container (a dataclass or
    a dict); a ``None`` subtree or leaf as ``None``."""
    items = tree.items() if isinstance(tree, dict) else \
        ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree))
    out = {}
    for name, v in items:
        where = f"{path}.{name}"
        if isinstance(v, dict) or dataclasses.is_dataclass(v):
            out.update(_shapes(v, where))
        elif v is None:
            out[where] = None
        else:
            v = np.asarray(v)
            out[where] = (v.shape, v.dtype)
    return out


@pytest.mark.parametrize("subtrees", [False, True],
                         ids=["default", "subtrees"])
def test_node_state_leaves_have_the_reference_shapes(tmp_path, subtrees):
    """Every leaf of a port ``RaftNode.state`` has the shape and dtype of
    the reference's for the same config (through the bridge, whose one
    change of dtype is the PRNG key's words), ``now`` 0-d: as restored
    from the WAL, and as the step's views after ticks."""
    kw = dict(n_groups=4, n_peers=3, log_slots=16, batch=4, max_submit=4)
    if subtrees:
        kw.update(trace_depth=16, heat=True, check_quorum=True,
                  debug_checks=True)
    J, T = _pkg("jax"), _pkg("port")
    with pinned_env():
        jc = J.LocalCluster(J.EngineConfig(**kw), str(tmp_path / "jax"))
        tc = T.LocalCluster(T.EngineConfig(**kw), str(tmp_path / "port"))
    try:
        for ticks in (0, 3):
            jc.tick(ticks)
            tc.tick(ticks)
            for i, n in tc.nodes.items():
                want = _shapes(jc.nodes[i].state)
                got = _shapes(state_to_numpy(n.state))
                assert got == want, (ticks, i)
                assert n.state.now.shape == ()
                assert n.state.term.shape == (kw["n_groups"],)
                if ticks:
                    assert n.state is n._stepper.state
    finally:
        jc.close()
        tc.close()


# ------------------------------------------ the step's copies of the state --

def test_a_node_copies_only_the_lanes_it_replaced(tmp_path):
    """A node that replaces nothing copies no leaf into the step's static
    state after its first step; ``set_active`` replaces one leaf, which
    is copied once, and the next step runs with the lane closed."""
    T = _pkg("port")
    cfg = T.EngineConfig(n_groups=4, n_peers=3, log_slots=16, batch=4,
                         max_submit=4)
    with pinned_env():
        c = T.LocalCluster(cfg, str(tmp_path))
    try:
        c.tick(6)
        assert [n._stepper.copied for n in c.nodes.values()] == [0, 0, 0]
        node = c.nodes[0]
        node.set_active(2, False)
        c.tick(1)
        assert [n._stepper.copied for n in c.nodes.values()] == [1, 0, 0]
        assert not bool(node.state.active[2]) and not node.h_active[2]
        assert node.state.active is node._stepper.state.active
        c.tick(4)
        assert [n._stepper.copied for n in c.nodes.values()] == [1, 0, 0]
        assert not bool(node._stepper._static.active[0, 2])
        assert bool(node.state.active[3])
    finally:
        c.close()
