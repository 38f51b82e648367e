"""bench.py's member, open-loop, txn, latency and heat stages on the twin
(``rafting_tpu_torch/tools/bench.py``) against the repo's ``bench.py``.

The P = 6 rebalance walk of the member stage runs through the port's
``member_walk`` and through the JAX ``DeviceCluster`` and scan on the
same schedule (bench.py:371-410): every state lane is equal after every
chunk and each request tick, and both converge in the same chunk.  The
fixed-majority baseline is bit-exact with JAX.  On the CPU the stages
print bench.py's metric strings and keys, plus ``device``; the A/Bs'
arithmetic and their 2% assertion run on a stubbed ``bench_runtime.run``
(no wall-clock threshold is asserted here).  Without a card and without
``--device cpu`` every stage exits non-zero.
"""

import dataclasses
import inspect
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as reference
import bench_runtime as reference_runtime
from rafting_tpu.core import cluster as jcl
from rafting_tpu.core import sim as jsim
from rafting_tpu.core import types as jty
from rafting_tpu_torch.bridge import state_to_numpy
from rafting_tpu_torch.core.cluster import DeviceCluster
from rafting_tpu_torch.ops import quorum
from rafting_tpu_torch.tools import _artifact, bench_runtime
from rafting_tpu_torch.tools import bench as twin

G = 256
# bench.py:414-422, the member child's result keys.
MEMBER_KEYS = {"scale", "platform", "member_stage", "walk_groups_per_sec",
               "walk_elapsed_s", "cps_masked", "cps_fixed",
               "masked_vs_fixed"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them as fast,
    and several only spin against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _jax_cfg(cfg):
    return jty.EngineConfig(**dataclasses.asdict(cfg))


def _jax_chunk(jcfg, c, load):
    c.states, c.inflight, c.last_info = jsim.run_cluster_ticks(
        jcfg, twin.MEMBER_CHUNK, c.states, c.inflight, c.last_info, c.conn,
        load)


def test_member_walk_matches_jax():
    """bench.py:371-410's walk at 256 groups x 6 nodes, 3 voters, seed 0:
    the port's record and every intermediate state equal the JAX
    engine's, lane for lane."""
    cfg6 = dataclasses.replace(twin.member_cfg(G), n_peers=6)
    seen = []
    walk = twin.member_walk(cfg6, "cpu", on_step=lambda label, c: seen.append(
        (label, state_to_numpy(c.states), state_to_numpy(c.inflight),
         state_to_numpy(c.last_info))))

    jcfg = _jax_cfg(cfg6)
    jc = jcl.DeviceCluster(jcfg, seed=0, n_voters=3)
    full = jnp.full((6, G), cfg6.max_submit, jnp.int32)
    light = jnp.ones((6, G), jnp.int32)
    steps = iter(seen)

    def check(label):
        got, st, infl, info = next(steps)
        assert got == label
        assert_same(jc.states, st, f"{label}.states")
        assert_same(jc.inflight, infl, f"{label}.inflight")
        assert_same(jc.last_info, info, f"{label}.info")

    def chunks(n, load, label):
        for _ in range(n // twin.MEMBER_CHUNK):
            _jax_chunk(jcfg, jc, load)
            check(label)

    def walk_done():
        w = np.asarray(jc.last_info.conf_word)[3:6]
        ok = ((jty.conf_voters_of(w) == 0b111000)
              & (jty.conf_new_of(w) == 0)).all()
        roles = np.asarray(jc.states.role)[3:6]
        return bool(ok and ((roles == jty.LEADER).sum(axis=0) == 1).all())

    chunks(64, full, "warm-up")
    pre = np.asarray(jc.states.commit).max(axis=0)
    chunks(16, light, "light")
    jc.request_membership(voters=0b000111, learners=0b111000)
    check("learners")
    chunks(48, light, "catch-up")
    jc.request_membership(voters=0b111000, learners=0)
    check("joint")
    n = 0
    while not walk_done():
        chunks(16, light, "walk")
        n += 1
    post = np.asarray(jc.states.commit)[3:6].max(axis=0)
    chunks(16, full, "resume")
    resume = np.asarray(jc.states.commit)[3:6].max(axis=0)
    assert next(steps, None) is None
    assert walk["chunks"] == n > 0
    for k, want in (("pre", pre), ("post", post), ("resume", resume)):
        np.testing.assert_array_equal(walk[k], want, err_msg=k)
    assert walk["ticks"] == 64 + 16 + 1 + 48 + 1 + 16 * n + 16


def test_fixed_majority_matches_jax(monkeypatch):
    """The member stage's P = 3 baseline (``quorum_fixed=True``) over 48
    ticks at full load, chunk for chunk equal to JAX; every tick took
    the fixed-majority path."""
    calls = []
    real = quorum.quorum_commit_fixed

    def counted(*a):
        calls.append(1)
        return real(*a)
    monkeypatch.setattr(quorum, "quorum_commit_fixed", counted)
    cfg = dataclasses.replace(twin.member_cfg(G), quorum_fixed=True)
    c = DeviceCluster(cfg, seed=0, device="cpu")
    jcfg = _jax_cfg(cfg)
    jc = jcl.DeviceCluster(jcfg, seed=0)
    load = torch.full((3, G), cfg.max_submit, dtype=torch.int32)
    for _ in range(3):
        twin._scan_chunks(cfg, c, twin.MEMBER_CHUNK, load)
        _jax_chunk(jcfg, jc, jnp.asarray(load.numpy()))
        assert_same(jc.states, state_to_numpy(c.states))
        assert_same(jc.last_info, state_to_numpy(c.last_info))
    assert len(calls) == 48
    assert int(c.states.commit.amin()) > 0


def test_member_child_keys(capfd, monkeypatch):
    """``--member-child 256 cpu`` prints bench.py's keys plus
    ``device``.  Its wall-clock assertion (kernel >= 0.95x fixed) is off
    here: on the CPU both arms are plain torch on a shared host."""
    src = inspect.getsource(reference.member_child)
    assert all(f'"{k}":' in src for k in MEMBER_KEYS)
    real = twin.member_run
    monkeypatch.setattr(twin, "member_run", lambda g, device="", check=True:
                        real(g, device, check=False))
    twin.main(["--member-child", str(G), "cpu"])
    out, err = capfd.readouterr()
    res = json.loads(out.strip().splitlines()[-1])
    assert set(res) == MEMBER_KEYS | {"device"}
    assert res["platform"] == res["device"] == "cpu"
    assert res["member_stage"] and res["walk_groups_per_sec"] > 0
    assert res["cps_masked"] > 0 and res["cps_fixed"] > 0
    assert "walk converged in" in err
    line = twin.member_line(res)
    assert line["metric"].startswith(
        "membership rebalance walk-throughs/sec @0k Raft groups")
    assert "P=6, cpu" in line["metric"]


def _lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_openloop_stage_matches_bench_py(tmp_path, monkeypatch, capsys):
    """The open-loop sweep at 2 groups on the CPU: the same lines, metric
    for metric and key for key, as bench.py's stage (plus ``device``);
    the artifact goes to the port's artifact directory."""
    for k, v in (("BENCH_OPENLOOP_GROUPS", "2"), ("BENCH_OPENLOOP_DUR", "0.3"),
                 ("BENCH_OPENLOOP_MULTS", "0.5,2.0")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(reference, "ARTIFACT_DIR", str(tmp_path / "ref"))
    monkeypatch.setattr(_artifact, "ARTIFACT_DIR", str(tmp_path / "port"))
    try:
        reference.run_openloop_stage()
    except AssertionError:
        pass            # the verdict is wall-clock; the lines are the test
    want = _lines(capsys.readouterr().out)
    monkeypatch.setenv("BENCH_OPENLOOP", "1")
    try:
        twin.main(["--device", "cpu"])
    except AssertionError as e:
        assert "no-collapse property failed" in str(e)
    got = _lines(capsys.readouterr().out)
    assert [ln["metric"] for ln in got] == [ln["metric"] for ln in want]
    assert len(got) == 1 + 2 + 1 + 2 + 1
    for g, w in zip(got, want):
        assert set(g) == set(w) | {"device"} and g["device"] == "cpu"
    (name,) = os.listdir(tmp_path / "port")
    assert name == "bench_cpu_2_000.json"
    with open(tmp_path / "port" / name) as f:
        doc = json.load(f)
    assert doc["note"] == "BENCH_OPENLOOP stage: open-loop overload sweep"
    assert doc["result"]["platform"] == doc["result"]["device"] == "cpu"
    assert set(doc["result"]["sweep"]) == {"on", "off"}
    assert doc["result"]["sweep"]["on"][0]["ok"] > 0


def test_txn_stage_commits(tmp_path, monkeypatch, capsys):
    """The 2PC stage at 3 groups, 2 clients, 0.5 s a phase on the CPU:
    transfers commit, and the line and result keys are bench.py's plus
    ``device``."""
    for k, v in (("BENCH_TXN", "1"), ("BENCH_TXN_GROUPS", "3"),
                 ("BENCH_TXN_CLIENTS", "2"), ("BENCH_TXN_DUR", "0.5")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(_artifact, "ARTIFACT_DIR", str(tmp_path))
    twin.main(["--device", "cpu"])
    (line,) = _lines(capsys.readouterr().out)
    assert line["metric"].startswith(
        "cross-group 2PC transfers/sec @3 groups (1 coordinator + 2 "
        "participants, 2-key Zipf(1) transfers, 2 closed-loop clients, "
        "durable 3-node cluster) [abort rate ")
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "device"}
    assert line["unit"] == "txn/sec" and line["value"] > 0
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        res = json.load(f)["result"]
    src = inspect.getsource(reference.run_txn_stage)
    keys = set(res) - {"device"}
    assert all(f'"{k}":' in src for k in keys)
    assert keys == {"platform", "scale", "participants", "clients",
                    "duration_s", "account_zipf", "txn",
                    "independent_writes", "txn_per_sec", "abort_rate",
                    "independent_pairs_per_sec", "atomicity_tax"}
    assert res["txn"]["ok"] > 0 and res["device"] == "cpu"


def test_runtime_run_reports_heat_and_hops():
    """One attributed run at 64 groups on the CPU: the pins took, the
    heat active set is non-empty and the hop tracer counted."""
    res = bench_runtime.run(64, lat_sample=64, heat=True, hops=True,
                            device="cpu")
    assert res["latency"]["sample_rate"] == 64
    assert res["heat"]["enabled"] and res["heat"]["active_set"] > 0
    hops = res["hops"]
    assert hops["enabled"] and hops["hop_requests_sent"] > 0
    assert hops["hop_finalized"] > 0 and hops["hop_echoes"] > 0
    off = bench_runtime.run(64, rounds=3, lat_sample=0, heat=False,
                            hops=False, device="cpu")
    assert off["latency"]["sample_rate"] == 0
    assert not off["heat"]["enabled"] and not off["hops"]["enabled"]


def _stub_run(values, calls):
    """A ``bench_runtime.run`` that records its pins and returns the
    next commits/s of ``values``."""
    it = iter(values)

    def run(n_groups, rounds=0, lat_sample=None, heat=None, hops=None,
            device=None):
        calls.append((lat_sample, heat, hops))
        return {"value": next(it),
                "latency": {"sample_rate": lat_sample or 0,
                            "e2e": {"count": 1}, "counts": {"ok": 1}},
                "heat": ({"enabled": True, "active_set": 3} if heat
                         else {"enabled": False})}
    return run


@pytest.mark.parametrize("stage", ["lat", "heat"])
def test_ab_stages_abba_and_budget(stage, tmp_path, monkeypatch, capsys):
    """ABBA order, the overhead's arithmetic and the 2% assertion on a
    stubbed run, with bench.py's own stage beside it on the same stub:
    the same line, plus ``device``."""
    monkeypatch.setattr(_artifact, "ARTIFACT_DIR", str(tmp_path))
    monkeypatch.setattr(reference, "ARTIFACT_DIR", str(tmp_path / "ref"))
    port, ref = ((twin.run_latency_ab, reference.run_latency_ab)
                 if stage == "lat" else
                 (twin.run_heat_ab, reference.run_heat_ab))
    on = ({"lat_sample": 64, "heat": None, "hops": None} if stage == "lat"
          else {"lat_sample": 64, "heat": True, "hops": True})
    off = ({"lat_sample": 0, "heat": None, "hops": None} if stage == "lat"
           else {"lat_sample": 0, "heat": False, "hops": False})
    # off 1000, on 990, on 990, off 1000: 1% overhead, inside the budget.
    calls = []
    monkeypatch.setattr(bench_runtime, "run",
                        _stub_run([1000, 990, 990, 1000], calls))
    res = port("cpu", scale=2000)
    assert calls == [tuple(d.values()) for d in (off, on, on, off)]
    key = "lat_overhead" if stage == "lat" else "heat_overhead"
    assert res[key] == pytest.approx(0.01)
    assert res["order"] == "ABBA (off, on, on, off)"
    (got,) = _lines(capsys.readouterr().out)
    monkeypatch.setenv(f"BENCH_{stage.upper()}_SCALE", "2000")
    monkeypatch.setattr(reference_runtime, "run",
                        _stub_run([1000, 990, 990, 1000], []))
    ref()
    (want,) = _lines(capsys.readouterr().out)
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    assert {k: v for k, v in got.items() if k != "device"} == want
    # Drift that ABBA cancels: off 1000 -> 1040 linearly, on pays 1%.
    monkeypatch.setattr(bench_runtime, "run",
                        _stub_run([1000, 1003.2, 1016.8, 1040], []))
    assert port("cpu", scale=2000)[key] < 0.02
    # 3% overhead: the assertion fails.
    monkeypatch.setattr(bench_runtime, "run",
                        _stub_run([1000, 970, 970, 1000], []))
    with pytest.raises(AssertionError, match=r"costs 3\.00% .*budget: 2%"):
        port("cpu", scale=2000)
    # The pins are checked.
    monkeypatch.setattr(bench_runtime, "run", lambda **kw: {
        "value": 1, "latency": {"sample_rate": 0}, "heat": {"enabled": False}})
    with pytest.raises(AssertionError, match="pins did not take"):
        port("cpu", scale=2000)


@pytest.mark.parametrize("flag", [f for f, _ in twin.STAGES])
def test_stage_needs_a_card(flag, monkeypatch):
    """No card and no ``--device cpu``: each stage exits non-zero before
    it runs anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv(flag, "1")
    ran = []
    monkeypatch.setattr(twin, "STAGES", tuple(
        (f, lambda *a, **k: ran.append(1)) for f, _ in twin.STAGES))
    with pytest.raises(SystemExit, match="no CUDA device"):
        twin.main([])
    assert not ran
