"""The port's device nemesis against the JAX engine, exactly.

Every schedule generator of ``rafting_tpu_torch.testkit.nemesis`` gives,
on the same seed, the same arrays as the JAX package's.  The same
``chaos_mix`` schedule run through ``run_cluster_ticks_nemesis`` in both
engines, with the optional flags off and all on, gives the same state
(subtrees included), step info and in-flight messages at every audit
window.  The port's ``ClusterChecker`` keeps the same history as the JAX
one over those snapshots and raises the same message on the same seeded
violation.  Also the port's own audited run, determinism check, stall
and healthy-schedule semantics.  Every lane is an integer, so every
comparison is exact.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafting_tpu.core import cluster as jcl
from rafting_tpu.core import sim as jsim
from rafting_tpu.core import types as jty
from rafting_tpu.testkit import invariants as jinv
from rafting_tpu.testkit import nemesis as jnem
from rafting_tpu_torch import (
    LEADER, DeviceCluster, EngineConfig, run_cluster_ticks,
    run_cluster_ticks_nemesis,
)
from rafting_tpu_torch.bridge import state_from_numpy, state_to_numpy
from rafting_tpu_torch.core import types as tty
from rafting_tpu_torch.testkit import invariants as tinv
from rafting_tpu_torch.testkit import nemesis as tnem

KW = dict(n_groups=32, log_slots=16, batch=4, max_submit=4, election_ticks=8,
          heartbeat_ticks=2, rpc_timeout_ticks=6, pre_vote=True)
ALL = dict(trace_depth=16, heat=True, check_quorum=True, debug_checks=True)
CPU = dict(device="cpu")


def assert_same(jx, tn, path=""):
    if tn is None:
        assert jx is None, path
        return
    if isinstance(tn, dict):
        for k, v in tn.items():
            assert_same(getattr(jx, k), v, f"{path}.{k}")
        return
    a = np.asarray(jx)
    assert a.dtype == tn.dtype and a.shape == tn.shape, \
        (path, a.dtype, tn.dtype, a.shape, tn.shape)
    if not np.array_equal(a, tn):
        raise AssertionError(f"{path} differs at "
                             f"{np.argwhere(a != tn)[:5].tolist()}")


# Each generator as ``make(module, device_kwargs)``: the JAX package's
# generators take no device, the port's take one.
GENERATORS = {
    "healthy": lambda m, d: m.healthy(4, 12, **d),
    "split_brain": lambda m, d: m.split_brain(5, 40, start=5, stop=30,
                                              seed=3, **d),
    "split_brain_sides": lambda m, d: m.split_brain(
        3, 20, sides=[[0], [1, 2]], **d),
    "rolling_partition": lambda m, d: m.rolling_partition(
        5, 60, period=16, heal_gap=4, **d),
    "crash_storm": lambda m, d: m.crash_storm(5, 200, rate=0.3, seed=1, **d),
    "crash_storm_capped": lambda m, d: m.crash_storm(
        3, 100, rate=0.5, seed=2, max_down=2, **d),
    "clock_stalls": lambda m, d: m.clock_stalls(3, 200, rate=0.05,
                                                max_len=6, seed=2, **d),
    "lossy_links": lambda m, d: m.lossy_links(4, 50, drop_p=0.3, dup_p=0.2,
                                              seed=7, **d),
    "compose": lambda m, d: m.compose(
        m.split_brain(3, 20, sides=[[0], [1, 2]], **d),
        m.lossy_links(3, 20, drop_p=0.5, dup_p=0.3, seed=7, **d),
        m.crash_storm(3, 20, rate=0.2, seed=5, **d)),
    "concat": lambda m, d: m.concat(
        m.rolling_partition(3, 24, period=8, heal_gap=2, **d),
        m.clock_stalls(3, 16, rate=0.2, seed=9, **d)),
    "chaos_mix": lambda m, d: m.chaos_mix(5, 91, seed=4, **d),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generator_matches_jax(name):
    make = GENERATORS[name]
    want, got = make(jnem, {}), make(tnem, CPU)
    assert got.n_ticks == want.n_ticks
    for f in dataclasses.fields(got):
        t = getattr(got, f.name)
        assert t.dtype == torch.bool and t.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(getattr(want, f.name)),
                                      t.numpy(), err_msg=f.name)


def test_schedule_bridges_both_ways():
    want = jnem.chaos_mix(3, 30, seed=1)
    got = state_from_numpy(jax.tree.map(np.asarray, want), "cpu")
    assert isinstance(got, tty.FaultSchedule)
    _same_tree(got, tnem.chaos_mix(3, 30, seed=1, **CPU))
    assert_same(want, state_to_numpy(got))


# One schedule length per config: three equal windows share one JAX
# compile of the nemesis scan.
CHAOS, TAIL, WINDOW = 90, 30, 40


@pytest.mark.parametrize("P,flags", [(3, {}), (3, ALL), (5, {}), (5, ALL)],
                         ids=["P3-off", "P3-all", "P5-off", "P5-all"])
def test_nemesis_run_matches_jax(P, flags):
    kw = dict(KW, n_peers=P, **flags)
    jcfg, tcfg = jty.EngineConfig(**kw), EngineConfig(**kw)
    jsched = jnem.concat(jnem.chaos_mix(P, CHAOS, seed=P + 1),
                         jnem.healthy(P, TAIL))
    tsched = tnem.concat(tnem.chaos_mix(P, CHAOS, seed=P + 1, **CPU),
                         tnem.healthy(P, TAIL, **CPU))
    # The schedule exercises every fault kind.
    for f in ("crash", "stall", "dup"):
        assert getattr(tsched, f).any(), f
    assert not tsched.link_up.all()
    jc = jcl.DeviceCluster(jcfg, seed=P)
    tc = DeviceCluster(tcfg, seed=P, **CPU)
    js, ji, jf = jc.states, jc.inflight, jc.last_info
    ts, ti, tf = tc.states, tc.inflight, tc.last_info
    sub = np.full((P, KW["n_groups"]), 3, np.int32)
    jchk, tchk = jinv.ClusterChecker(jcfg), tinv.ClusterChecker(tcfg)
    crash = tsched.crash.numpy()
    for lo in range(0, CHAOS + TAIL, WINDOW):
        hi = lo + WINDOW
        js, ji, jf = jsim.run_cluster_ticks_nemesis(
            jcfg, js, ji, jf, jax.tree.map(lambda a: a[lo:hi], jsched),
            jnp.asarray(sub))
        ts, ti, tf = run_cluster_ticks_nemesis(
            tcfg, ts, ti, tf, tty.tree_map(lambda a: a[lo:hi], tsched),
            torch.from_numpy(sub), **CPU)
        for name, w, g in (("state", js, ts), ("inflight", ji, ti),
                           ("info", jf, tf)):
            assert_same(w, state_to_numpy(g), f"ticks {lo}..{hi} {name}")
        snap = tinv.cluster_snapshot(ts)
        crashed = crash[lo:hi].any(axis=0)
        jchk.check(snap, crashed=crashed)
        tchk.check(snap, crashed=crashed)
        assert tchk.leaders == jchk.leaders
        floor = tchk._floor
        assert tchk.committed_terms == {
            k: v for k, v in jchk.committed_terms.items()
            if k[1] > floor[k[0]]}
    jchk.check_log_matching(snap)
    tchk.check_log_matching(snap)
    assert tchk.committed_terms
    assert (snap["commit"].max(axis=0) > 0).all()
    if flags:
        assert not tf.debug_viol.any()
        assert int(ts.trace.n.min()) > 0 and int(ts.heat.sent.min()) > 0


@pytest.fixture(scope="module")
def settled_snapshot():
    """A 3-node cluster after 40 ticks of load: committed entries in every
    group and one leader each."""
    c = DeviceCluster(EngineConfig(**dict(KW, n_groups=16, n_peers=3)),
                      seed=5, **CPU)
    for _ in range(40):
        c.tick(submit_n=2)
    snap = c.snapshot()
    assert (snap["commit"] > snap["base"] + 2).all()
    return c.cfg, snap


def _committed_changed(s):
    g, n, L = 7, 2, s["log_term"].shape[-1]
    s["log_term"][n, g, s["commit"][n, g] % L] += 5


def _two_leaders(s):
    s["role"][:, 3] = LEADER


def _term_regressed(s):
    s["term"][1, 5] -= 1


def _commit_regressed(s):
    s["commit"][1, 5] -= 1


def _ring_overflow(s):
    s["last"][2, 9] = s["base"][2, 9] + s["log_term"].shape[-1] + 1


def _log_mismatch(s):
    g, L = 4, s["log_term"].shape[-1]
    lo = max(s["base"][0, g], s["base"][1, g]) + 1
    s["log_term"][0, g, lo % L] += 1


@pytest.mark.parametrize("mutate,primed,matching", [
    (_committed_changed, True, False), (_two_leaders, False, False),
    (_term_regressed, True, False), (_commit_regressed, True, False),
    (_ring_overflow, False, False), (_log_mismatch, False, True),
], ids=["committed_changed", "two_leaders", "term_regressed",
        "commit_regressed", "ring_overflow", "log_matching"])
def test_checker_raises_as_jax(settled_snapshot, mutate, primed, matching):
    """The port's checker raises the JAX checker's message on each seeded
    violation, and passes the snapshot it was seeded from."""
    cfg, base = settled_snapshot
    bad = copy.deepcopy(base)
    mutate(bad)
    msgs = []
    for cls in (jinv.ClusterChecker, tinv.ClusterChecker):
        chk = cls(cfg)
        chk.check(base)
        chk.check_log_matching(base)
        if not primed:
            chk = cls(cfg)
        with pytest.raises(AssertionError) as e:
            if matching:
                chk.check_log_matching(bad)
            else:
                chk.check(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_port_audited_run_and_determinism():
    cfg = EngineConfig(**dict(KW, n_peers=3, **ALL))
    sched = tnem.chaos_mix(3, 90, seed=7, **CPU)
    states, chk, snap = tnem.run_nemesis_audited(
        cfg, sched, seed=7, submit=2, audit_every=30, settle_ticks=60, **CPU)
    assert ((snap["role"] == LEADER).sum(axis=0) == 1).all()
    assert (snap["commit"].max(axis=0) > 0).all()
    assert chk.committed_terms
    tnem.assert_nemesis_deterministic(cfg, sched, seed=7, **CPU)


def test_stall_freezes_node_and_cluster_survives():
    cfg = EngineConfig(**dict(KW, n_groups=16, n_peers=3))
    c = DeviceCluster(cfg, seed=2, **CPU)
    T = 60
    sched = tnem.healthy(3, T, **CPU)
    stall = torch.zeros((T, 3), dtype=torch.bool)
    stall[:, 1] = True
    sched = sched.replace(stall=stall)
    now0 = c.states.now.clone()
    sub = torch.full((3, 16), 2, dtype=torch.int32)
    s, _, info = run_cluster_ticks_nemesis(cfg, c.states, c.inflight,
                                           c.last_info, sched, sub, **CPU)
    assert int(s.now[1]) == int(now0[1])
    assert int(s.now[0]) == int(now0[0]) + T
    roles = s.role.numpy()
    assert ((roles == LEADER).sum(axis=0) == 1).all()
    assert (roles[1] != LEADER).all()
    # The stalled node's StepInfo stayed as it was before the run.
    assert torch.equal(info.commit[1], c.last_info.commit[1])


def test_healthy_schedule_equals_plain_run():
    cfg = EngineConfig(**dict(KW, n_peers=3))
    a = DeviceCluster(cfg, seed=3, **CPU)
    b = DeviceCluster(cfg, seed=3, **CPU)
    sub = torch.full((3, 32), 2, dtype=torch.int32)
    want = run_cluster_ticks(cfg, 48, a.states, a.inflight, a.last_info,
                             a.conn, sub, **CPU)
    got = run_cluster_ticks_nemesis(cfg, b.states, b.inflight, b.last_info,
                                    tnem.healthy(3, 48, **CPU), sub, **CPU)
    for w, g in zip(want, got):
        _same_tree(w, g)


def _same_tree(a, b, path=""):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            _same_tree(x, y, f"{path}.{f.name}")
        elif x is None:
            assert y is None, path
        else:
            assert torch.equal(x, y), f"{path}.{f.name}"


def test_schedule_on_another_device_is_refused():
    cfg = EngineConfig(**dict(KW, n_groups=4, n_peers=3))
    c = DeviceCluster(cfg, **CPU)
    sched = tnem.healthy(3, 2, **CPU)
    sched = tty.tree_map(lambda a: a.to("meta"), sched)
    with pytest.raises(ValueError, match="fault schedule"):
        run_cluster_ticks_nemesis(cfg, c.states, c.inflight, c.last_info,
                                  sched, torch.zeros((3, 4), dtype=torch.int32),
                                  **CPU)
