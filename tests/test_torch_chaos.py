"""The port's chaos plane on the CPU (``testkit/chaos.py``, the
``check_transfer_atomicity`` judgment, ``ProcCluster``).

* The cases of ``tests/test_chaos.py`` (the timeline replay pin, the
  mixed-nemesis KV smoke with lease reads on and off, the stale-read
  counterexample, the conductor's audit, the TCP soak, the real-process
  SIGKILL schedule) and the transfer cases of ``tests/test_txn.py`` (the
  checker's violation classes, the guard that keeps transactions away
  from the per-key checker, the bank soak, the open-loop sweep), each
  compiled from the reference test file's own source with its
  ``rafting_tpu.`` imports pointed at ``rafting_tpu_torch.`` and its
  ``LocalCluster``/``ProcCluster`` bound to ``device="cpu"``.  A case the
  reference marks ``slow`` is ``slow`` here.
* ``plan_chaos`` and ``plan_leader_isolate`` give the JAX package's
  byte-identical ``timeline_json`` for several shapes and seeds, and the
  canonical timelines committed in ``artifacts/``.
* One short seeded bank soak, judged by ``check_transfer_atomicity``.
* ``ProcCluster`` spawns the port's ``noderun`` with the device it was
  given, and has no default device.
"""

import functools
import gzip
import inspect
import json
import os

import pytest

from rafting_tpu.testkit import chaos as jchaos
from rafting_tpu_torch.testkit.chaos import (
    ProcCluster, plan_chaos, plan_leader_isolate, timeline_json,
)
from rafting_tpu_torch.testkit.harness import LocalCluster
from test_torch_admin import _on_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REFERENCE_CASES = {
    "test_chaos.py": [
        "test_timeline_replay_byte_for_byte",
        "test_mixed_nemesis_smoke_linearizable",
        "test_stale_read_bug_produces_minimal_counterexample",
        "test_conductor_audit_and_metrics_surface",
        "test_chaos_soak_tcp_linearizable",
        "test_proc_cluster_seeded_sigkill_schedule",
    ],
    "test_txn.py": [
        "test_linz_refuses_multi_key_txn_ops",
        "test_transfer_atomicity_checker_has_teeth",
        "test_txn_chaos_soak_bank_transfers",
        "test_txn_openloop_admission_no_collapse",
    ],
}
_NS = {}


def _namespace(fname: str) -> dict:
    """The reference test module on the port, its clusters on the CPU."""
    if fname not in _NS:
        ns = _on_port(fname)
        ns["LocalCluster"] = functools.partial(LocalCluster, device="cpu")
        ns["ProcCluster"] = functools.partial(ProcCluster, device="cpu")
        _NS[fname] = ns
    return _NS[fname]


def _cases():
    """One case per reference test and parameter value, with the
    reference's ``slow`` mark."""
    out = []
    for fname, names in sorted(REFERENCE_CASES.items()):
        ns = _namespace(fname)
        for name in names:
            marks = getattr(ns[name], "pytestmark", [])
            slow = [pytest.mark.slow] if any(m.name == "slow"
                                             for m in marks) else []
            grid = [m.args for m in marks if m.name == "parametrize"]
            kws = ([{grid[0][0]: v} for v in grid[0][1]] if grid else [{}])
            for kw in kws:
                tag = "".join(f"[{k}={v}]" for k, v in kw.items())
                out.append(pytest.param(fname, name, kw, marks=slow,
                                        id=f"{fname}::{name}{tag}"))
    return out


@pytest.mark.parametrize("fname,name,kw", _cases())
def test_reference_case_on_port(fname, name, kw, tmp_path, monkeypatch):
    fn = _namespace(fname)[name]
    params = inspect.signature(fn).parameters
    extra = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn(**kw, **{k: v for k, v in extra.items() if k in params})


# ---------------------------------------------------------------- timelines --

PLANS = [
    (3, 120, 7, {}), (3, 400, 11, {}), (5, 300, 5, {}),
    (3, 400, 17, dict(churn_group=2)),
    (5, 200, 3, dict(period=7, max_dur=6, storage_fsync_victim=4)),
    (3, 40, 21, dict(period=10, mix={"kill": 1.0}, max_dur=8)),
]


@pytest.mark.parametrize("peers,ticks,seed,kw", PLANS)
def test_plan_chaos_matches_reference(peers, ticks, seed, kw):
    a = timeline_json(plan_chaos(peers, ticks, seed=seed, **kw))
    b = jchaos.timeline_json(jchaos.plan_chaos(peers, ticks, seed=seed,
                                               **kw))
    assert a.encode() == b.encode()


@pytest.mark.parametrize("seed", [0, 7, 19])
def test_plan_leader_isolate_matches_reference(seed):
    a = timeline_json(plan_leader_isolate(400, seed=seed, group=1,
                                          period=60, dur=30))
    b = jchaos.timeline_json(jchaos.plan_leader_isolate(
        400, seed=seed, group=1, period=60, dur=30))
    assert a.encode() == b.encode()


def _artifact(name: str) -> dict:
    opener = gzip.open if name.endswith(".gz") else open
    with opener(os.path.join(REPO, "artifacts", name), "rt") as f:
        return json.load(f)


def test_plans_equal_the_committed_artifacts():
    """The canonical timelines of the JAX package's committed chaos
    artifacts, planned again by the port from their own arguments."""
    kv = _artifact("chaos_soak_cpu_000.json")
    assert kv["argv"] == ["--seed", "7", "--ticks", "120"]
    assert kv["config"]["timeline_canonical"] == timeline_json(
        plan_chaos(3, 120, seed=7, period=12, churn_group=1))
    iso = _artifact("chaos_soak_isolate_cpu_000.json.gz")
    assert iso["config"]["timeline_canonical"] == timeline_json(
        plan_leader_isolate(240, seed=7, group=1, period=100, dur=70))
    xfer = _artifact("chaos_soak_transfer_cpu_000.json.gz")
    tls = xfer["config"]["timelines_canonical"]
    for rnd in (0, 1, len(tls) - 1):
        assert tls[rnd] == timeline_json(
            plan_chaos(3, 400, seed=17 + rnd, period=12, churn_group=1))


# -------------------------------------------------------- bank transfers --

def test_bank_transfer_soak_short(tmp_path):
    """``tests/test_txn.py``'s bank soak at 120 ticks and three clients:
    at least one committed transfer, every balance conserved, no
    stranded intent."""
    ns = _namespace("test_txn.py")
    G1, G2, COORD = ns["G1"], ns["G2"], ns["COORD"]
    cluster = ns["_mk_cluster"](tmp_path, seed=17)
    try:
        for g in range(3):
            cluster.wait_leader(g)
        for n in cluster.nodes.values():
            n.txn.sweep_every = 8
        accounts, seed_val = 12, 100
        with ns["_Ticker"](cluster):
            ns["_seed_accounts"](
                [ns["_stub"](cluster, 0, G1), ns["_stub"](cluster, 0, G2)],
                value=seed_val, keys=[f"acct{i}" for i in range(accounts)])
        history = ns["History"]()
        conductor = ns["ChaosConductor"](cluster, plan_chaos(
            cluster.cfg.n_peers, 120, seed=17, churn_group=G1))
        load = ns["TransferWorkload"](
            cluster, history, coord_group=COORD, groups=(G1, G2),
            clients=3, seed=17, accounts=accounts, deadline_s=2.0,
            op_timeout=6.0)
        load.start()
        conductor.run(extra_ticks=40, tick_sleep=0.002)
        load.stop()
        load.join(tick_fn=conductor.step)
        conductor.finish()
        ns["_drain_txn_plane"](cluster, conductor)
        counts = load.counts()
        machine = functools.partial(ns["_leader_machine"], cluster)
        rep = ns["check_transfer_atomicity"](
            machine(COORD), {G1: machine(G1), G2: machine(G2)},
            initial_total=2 * accounts * seed_val)
        assert counts["committed"] >= 1, counts
        assert rep["committed"] >= counts["committed"], (rep, counts)
    finally:
        cluster.close()


# ------------------------------------------------------------ processes --

def test_proc_cluster_spawns_port_noderun(tmp_path):
    """The node command line names the port's noderun and the device."""
    pc = ProcCluster(tmp_path, n=3, groups=4, device="cpu")
    try:
        argv = pc.start(0).args
        assert argv[1:3] == ["-m", "rafting_tpu_torch.tools.noderun"]
        assert argv[3:] == ["--device", "cpu", pc.cfgs[0]]
    finally:
        pc.close()
    with pytest.raises(TypeError):
        ProcCluster(tmp_path / "x", n=3, groups=4)
