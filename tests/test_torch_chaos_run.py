"""``python -m rafting_tpu_torch.tools.chaos_run`` (the twin of the repo's
``tools/chaos_run.py``) on the CPU, in the settings of the JAX package's
committed artifacts: the KV soak (its planned timeline equals the
committed one byte for byte), the stale-read self-test (the checker must
catch the injected defect), and one seeded round of the bank transfer
soak judged by ``check_transfer_atomicity``.  The leader-isolate mode is
in ``tests/test_torch_chaos_isolate.py``.  Each run saves its artifact
under ``tmp_path`` (``_artifact.ARTIFACT_DIR``), named with the
device."""

import gzip
import json
import os

import pytest

from rafting_tpu_torch.tools import _artifact, chaos_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _artifacts_in_tmp(tmp_path, monkeypatch):
    monkeypatch.setattr(_artifact, "ARTIFACT_DIR", str(tmp_path / "art"))


def _run(tmp_path, *argv):
    args = chaos_run.parse_args(["--device", "cpu",
                                 "--root", str(tmp_path / "data"), *argv])
    ok, doc, path = chaos_run.soak(args)
    with gzip.open(path, "rt") as f:
        saved = json.load(f)
    assert saved["config"]["device"] == "cpu"
    assert os.path.basename(path).split("_")[-2] == "torch-cpu"
    return ok, doc, saved


def _acked_per_client(history: list) -> dict:
    """proc -> [acknowledged writes, acknowledged reads] from the
    artifact's raw event list."""
    kinds, out = {}, {}
    for ev in history:
        if ev["e"] == "invoke":
            kinds[ev["id"]] = (ev["proc"], ev["kind"])
        elif ev["e"] == "ok":
            proc, kind = kinds[ev["id"]]
            out.setdefault(proc, [0, 0])[kind == "r"] += 1
    return out


def test_kv_soak_matches_committed_timeline(tmp_path):
    ok, doc, saved = _run(tmp_path, "--seed", "7", "--ticks", "120")
    assert ok and doc["verdict"]["ok"]
    with open(os.path.join(REPO, "artifacts", "chaos_soak_cpu_000.json")) \
            as f:
        committed = json.load(f)
    assert doc["timeline_canonical"] == \
        committed["config"]["timeline_canonical"]
    assert saved["argv"][-4:] == ["--seed", "7", "--ticks", "120"]
    per = _acked_per_client(doc["history"])
    assert sorted(per) == ["c0", "c1", "c2"]
    assert all(w >= 1 and r >= 1 for w, r in per.values()), per


def test_stale_reads_are_caught(tmp_path):
    ok, doc, _ = _run(tmp_path, "--seed", "3", "--ticks", "100",
                      "--stale-reads")
    assert ok, "the verdict did not match the expectation"
    assert not doc["verdict"]["ok"] and doc["verdict"]["counterexample"]


def test_bank_transfer_round(tmp_path):
    ok, doc, _ = _run(tmp_path, "--workload", "transfer", "--seed", "17",
                      "--ticks", "100", "--clients", "6")
    assert ok, doc["verdict"]
    report = doc["verdict"]["report"]
    assert doc["verdict"]["drained"] and doc["verdict"]["violation"] is None
    assert report["committed"] >= 1
    assert report["balance_total"] == 2 * 12 * 1000
    assert len(doc["timelines_canonical"]) == 1


def test_device_is_required(capsys):
    with pytest.raises(SystemExit):
        chaos_run.parse_args(["--seed", "7"])
    assert "--device" in capsys.readouterr().err


def test_judge_refuses_a_history_of_unknown_outcomes():
    from rafting_tpu_torch.testkit.history import History

    h = History()
    for i in range(chaos_run.INFO_LIMIT + 1):
        h.info(h.invoke("c0", "w", "r0", f"v{i}"), "timeout")
    with pytest.raises(RuntimeError, match="cannot be judged"):
        chaos_run.judge(h)
    h = History()
    h.info(h.invoke("c0", "w", "r0", "v0"), "timeout")
    h.ok(h.invoke("c1", "r", "r0"), "v0")
    assert chaos_run.judge(h).ok


def test_calibrate_measures_a_throwaway_cluster(tmp_path):
    from rafting_tpu_torch import EngineConfig

    cfg = EngineConfig(n_groups=3, n_peers=3, log_slots=64, batch=8,
                       max_submit=8, election_ticks=10, heartbeat_ticks=3,
                       rpc_timeout_ticks=8)
    root = tmp_path / "calibration"
    assert chaos_run.calibrate(cfg, str(root), "cpu") > 0
    assert not root.exists()


def _random_history(seed: int, mode: str):
    """One key's seeded history from a real register+list run: three
    clients, each op taking effect (or, for an unknown outcome, maybe
    not) between its invocation and its response; one read in four
    then has its result corrupted, so some histories are not
    linearizable."""
    import random

    from rafting_tpu_torch.testkit.history import History

    rng = random.Random(seed)
    kinds = {"a": "ar", "w": "wr", "mixed": "war"}[mode]
    plan = []
    for i in range(rng.randint(4, 11)):
        t0 = rng.random() * 10
        t1 = t0 + rng.random() * 3
        plan.append((t0, rng.uniform(t0, t1), t1, f"c{i % 3}",
                     rng.choice(kinds), f"v{i}", rng.random() < 0.35))
    events = []
    for i, (t0, te, t1, *_rest) in enumerate(plan):
        events += [(t0, 0, i), (te, 1, i), (t1, 2, i)]
    h, ids, got, state = History(), {}, {}, None
    for _t, what, i in sorted(events):
        _t0, _te, _t1, proc, kind, value, unknown = plan[i]
        if what == 0:
            ids[i] = h.invoke(proc, kind, "k", None if kind == "r" else value)
        elif what == 1 and not (unknown and kind != "r"
                                and rng.random() < 0.5):
            if kind == "w":
                state = value
            elif kind == "a":
                state = (list(state) if isinstance(state, list) else []) \
                    + [value]
            got[i] = list(state) if isinstance(state, list) else state
        elif what == 2:
            if unknown:
                h.info(ids[i], "timeout")
            else:
                res = got.get(i)
                if kind == "r" and rng.random() < 0.25:
                    res = rng.choice([None, "v0", ["v1"], ["v0", "v2"]])
                h.ok(ids[i], res)
    return h


@pytest.mark.parametrize("mode", ["a", "w", "mixed"])
def test_judge_pruning_keeps_the_checkers_verdict(mode):
    """``judge`` drops unobserved unknown-outcome writes before the
    search: over 300 seeded histories per key kind its verdict equals
    the unpruned checker's, and both verdicts occur."""
    from rafting_tpu_torch.testkit import linz

    verdicts = set()
    for seed in range(300):
        h = _random_history(seed, mode)
        want = linz.check(h).ok
        assert chaos_run.judge(h).ok == want, (seed, h.to_json())
        verdicts.add(want)
    assert verdicts == {True, False}


def test_judge_prunes_the_writes_a_cut_strands():
    """Twenty unknown-outcome appends that no read observed, each
    concurrent with every later op, are dropped before the search (the
    unpruned search walks their orderings); one an acknowledged read
    saw is kept, and a read that misses an acknowledged append still
    fails."""
    from rafting_tpu_torch.testkit.history import History

    h = History()
    ok = h.invoke("c0", "a", "l0", "x")
    h.ok(ok, 1)
    seen = h.invoke("c1", "a", "l0", "s")
    for i in range(20):
        h.invoke("c2", "a", "l0", f"lost{i}")
    h.info(seen, "timeout")
    read = h.invoke("c0", "r", "l0")
    h.ok(read, ["x", "s"])
    kept = chaos_run.prune_unobserved(h.by_key()["l0"])
    assert sorted(o.value for o in kept if o.kind == "a") == ["s", "x"]
    verdict = chaos_run.judge(h)
    assert verdict.ok and verdict.n_ops == 23
    assert verdict.counts == {"ok": 2, "fail": 0, "info": 21}
    bad = h.invoke("c1", "r", "l0")
    h.ok(bad, ["s"])
    assert not chaos_run.judge(h).ok
