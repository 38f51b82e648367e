"""The port's cluster driver and tick loops against the JAX engine.

``DeviceCluster`` runs tick for tick beside the JAX one under load with a
partition and a heal; ``run_cluster_ticks``/``run_cluster_ticks_reads``
run beside the JAX scans; the reference's invariant checker audits the
port's snapshots unchanged.  All comparisons are exact.  Also: the port
imports without jax, and its entry points refuse to drift to the CPU.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafting_tpu.core import cluster as jcl
from rafting_tpu.core import sim as jsim
from rafting_tpu.core import types as jty
from rafting_tpu.testkit.invariants import ClusterChecker
from rafting_tpu_torch import (
    DeviceCluster, EngineConfig, run_cluster_ticks, run_cluster_ticks_reads,
)
from rafting_tpu_torch.bridge import state_from_numpy, state_to_numpy
from rafting_tpu_torch.core import types as tty

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(n_groups=32, n_peers=3, log_slots=16, batch=4, max_submit=4)


def assert_same(jx, tn, path=""):
    if tn is None:
        assert jx is None, path
        return
    if isinstance(tn, dict):
        for k, v in tn.items():
            assert_same(getattr(jx, k), v, f"{path}.{k}")
        return
    a = np.asarray(jx)
    assert a.dtype == tn.dtype and a.shape == tn.shape, path
    if not np.array_equal(a, tn):
        raise AssertionError(f"{path} differs at "
                             f"{np.argwhere(a != tn)[:5].tolist()}")


def test_dataclass_fields_match_jax():
    pairs = [(jty.EngineConfig, tty.EngineConfig),
             (jty.RaftState, tty.RaftState), (jty.LogState, tty.LogState),
             (jty.Messages, tty.Messages), (jty.HostInbox, tty.HostInbox),
             (jty.StepInfo, tty.StepInfo), (jty.TraceState, tty.TraceState),
             (jty.HeatState, tty.HeatState),
             (jty.QuorumContact, tty.QuorumContact),
             (jty.FaultSchedule, tty.FaultSchedule)]
    for j, t in pairs:
        assert {f.name for f in dataclasses.fields(j)} == \
            {f.name for f in dataclasses.fields(t)}, t.__name__
    jf = {f.name: f.default for f in dataclasses.fields(jty.EngineConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tty.EngineConfig)}
    assert jf == tf


def test_empty_containers_match_jax():
    jcfg, tcfg = jty.EngineConfig(**KW), tty.EngineConfig(**KW)
    for jx, tn in ((jty.Messages.empty(jcfg), tty.Messages.empty(tcfg, "cpu")),
                   (jty.HostInbox.empty(jcfg),
                    tty.HostInbox.empty(tcfg, "cpu")),
                   (jty.StepInfo.empty(jcfg), tty.StepInfo.empty(tcfg, "cpu"))):
        assert_same(jx, state_to_numpy(tn))
    for node in range(3):
        for nv in (None, 2):
            assert_same(jty.init_state(jcfg, node, seed=7, n_voters=nv,
                                       n_active=20),
                        state_to_numpy(tty.init_state(
                            tcfg, node, seed=7, n_voters=nv, n_active=20,
                            device="cpu")))


def test_crash_restart_matches_jax():
    jc = jcl.DeviceCluster(jty.EngineConfig(**KW), seed=2)
    for _ in range(40):
        jc.tick(submit_n=2)
    one = jax.tree.map(lambda a: np.array(a[1]), jc.states)
    want = jty.crash_restart(jty.EngineConfig(**KW),
                             jax.tree.map(jnp.asarray, one))
    got = tty.crash_restart(tty.EngineConfig(**KW),
                            state_from_numpy(one, "cpu"))
    assert_same(want, state_to_numpy(got))


def test_device_cluster_tick_for_tick():
    """120 ticks under load with partition/heal: the snapshot every tick,
    the full state and in-flight traffic at the end.  The port's
    snapshots also pass the reference's invariant checker."""
    jc = jcl.DeviceCluster(jty.EngineConfig(**KW), seed=3)
    tc = DeviceCluster(EngineConfig(**KW), seed=3, device="cpu")
    jc.compact = tc.compact = 4
    checker = ClusterChecker(tc.cfg)
    for t in range(120):
        if t == 35:
            jc.isolate(0)
            tc.isolate(0)
        if t == 55:
            jc.set_partition([[0, 1], [2]])
            tc.set_partition([[0, 1], [2]])
        if t == 80:
            jc.heal()
            tc.heal()
        jc.tick(submit_n=2)
        tc.tick(submit_n=2)
        js, ts = jc.snapshot(), tc.snapshot()
        for k in js:
            np.testing.assert_array_equal(js[k], ts[k], err_msg=f"{t} {k}")
        checker.check(ts)
    assert_same(jc.states, state_to_numpy(tc.states), "state")
    assert_same(jc.inflight, state_to_numpy(tc.inflight), "inflight")
    assert_same(jc.last_info, state_to_numpy(tc.last_info), "info")
    assert jc.leaders(0) == tc.leaders(0)
    assert jc.log_terms(1, 3, 1, 20) == tc.log_terms(1, 3, 1, 20)
    assert jc.membership(5) == tc.membership(5)


@pytest.mark.parametrize("reads", [False, True])
def test_run_cluster_ticks_matches_jax(reads):
    jcfg, tcfg = jty.EngineConfig(**KW), tty.EngineConfig(**KW)
    jc = jcl.DeviceCluster(jcfg, seed=4)
    tc = DeviceCluster(tcfg, seed=4, device="cpu")
    N, G = 3, KW["n_groups"]
    sub = np.full((N, G), 3, np.int32)
    rd = np.full((N, G), 2, np.int32)
    args_j = (jc.states, jc.inflight, jc.last_info, jc.conn,
              jnp.asarray(sub))
    args_t = (tc.states, tc.inflight, tc.last_info, tc.conn,
              torch.from_numpy(sub))
    if reads:
        want = jsim.run_cluster_ticks_reads(jcfg, 64, *args_j,
                                            jnp.asarray(rd))
        got = run_cluster_ticks_reads(tcfg, 64, *args_t,
                                      torch.from_numpy(rd), device="cpu")
        for w, g in zip(want[3:], got[3:]):
            assert int(w) == int(g)
        assert int(got[3]) > 0 and int(got[4]) > 0
    else:
        want = jsim.run_cluster_ticks(jcfg, 64, *args_j)
        got = run_cluster_ticks(tcfg, 64, *args_t, device="cpu")
    for name, w, g in zip(("state", "inflight", "info"), want, got):
        assert_same(w, state_to_numpy(g), name)
    assert (np.asarray(want[0].commit) > 0).all()


def test_checker_audits_port_under_chaos():
    tc = DeviceCluster(EngineConfig(**KW), seed=9, device="cpu")
    checker = ClusterChecker(tc.cfg)
    rng = np.random.default_rng(9)
    for t in range(220):
        if t % 17 == 0 and t < 120:
            perm = rng.permutation(3)
            tc.set_partition([list(perm[:2]), [int(perm[2])]])
        if t == 120:
            tc.heal()
        tc.tick(submit_n=2)
        checker.check(tc.snapshot())
    snap = tc.snapshot()
    assert ((snap["role"] == 3).sum(axis=0) == 1).all()


def test_port_runs_without_jax():
    """A subprocess that cannot import jax, flax or rafting_tpu imports
    the port and runs a 16-group cluster to a leader in every group."""
    code = textwrap.dedent("""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax",
                                          "rafting_tpu"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import rafting_tpu_torch as rt
        from rafting_tpu_torch.testkit import invariants, nemesis
        from rafting_tpu_torch.utils import tracelog
        c = rt.DeviceCluster(rt.EngineConfig(n_groups=16, n_peers=3),
                             seed=1, device="cpu")
        for _ in range(30):
            c.tick(submit_n=1)
        role = c.snapshot()["role"]
        assert ((role == rt.LEADER).sum(axis=0) == 1).all(), role
        cfg = rt.EngineConfig(n_groups=8, n_peers=3, trace_depth=12,
                              heat=True, check_quorum=True,
                              debug_checks=True)
        _, chk, snap = nemesis.run_nemesis_audited(
            cfg, nemesis.chaos_mix(3, 30, seed=1, device="cpu"), seed=1,
            audit_every=15, settle_ticks=30, device="cpu",
            checker=invariants.ClusterChecker(cfg))
        assert chk.committed_terms and tracelog.TRACE_EVENTS
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "flax", "rafting_tpu")]
        assert not bad, bad
        print("NOJAX-OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "NOJAX-OK" in res.stdout


def test_entry_points_refuse_to_drift_to_cpu(monkeypatch):
    cfg = EngineConfig(n_groups=4, n_peers=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tty.init_state(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceCluster(cfg)
    c = DeviceCluster(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_cluster_ticks(cfg, 1, c.states, c.inflight, c.last_info, c.conn,
                          torch.zeros((3, 4), dtype=torch.int32))


@pytest.mark.parametrize("flag", [dict(trace_depth=16), dict(heat=True),
                                  dict(check_quorum=True),
                                  dict(debug_checks=True)])
def test_unported_subtrees_raise(flag):
    """Each optional flag builds its subtree (and its StepInfo lanes) with
    the JAX engine's shapes, dtypes and values, every lane in its own
    buffer, and a cluster with it steps."""
    kw = dict(KW, **flag)
    jcfg, tcfg = jty.EngineConfig(**kw), tty.EngineConfig(**kw)
    for node in range(3):
        got = tty.init_state(tcfg, node, seed=2, device="cpu")
        assert_same(jty.init_state(jcfg, node, seed=2),
                    state_to_numpy(got), f"node {node}")
        for sub in (got.trace, got.heat, got.qc):
            if sub is not None:
                ptrs = [getattr(sub, f.name).data_ptr()
                        for f in dataclasses.fields(sub)]
                assert len(set(ptrs)) == len(ptrs)
    assert_same(jty.StepInfo.empty(jcfg),
                state_to_numpy(tty.StepInfo.empty(tcfg, "cpu")))
    c = DeviceCluster(tcfg, device="cpu")
    info = c.tick(submit_n=1)
    assert (info.cq_stepdown is None) == (not tcfg.check_quorum)
    assert not info.debug_viol.any()
