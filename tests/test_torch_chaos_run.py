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
