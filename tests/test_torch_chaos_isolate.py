"""``rafting_tpu_torch.tools.chaos_run --nemesis leader-isolate`` on the
CPU: one inbound-only cut of the KV group's leader, CheckQuorum on.  The
leader steps itself down, goodput resumes within ``--recovery-ticks``
while the cut is still open, and the history stays linearizable.  The
reference's settings (0.25 s per tick, a 70-tick cut, a 60-tick budget),
with the cut placed early (period 20) so the run stays short."""

from rafting_tpu_torch.tools import _artifact, chaos_run


def test_leader_isolate_recovers_with_check_quorum(tmp_path, monkeypatch):
    monkeypatch.setattr(_artifact, "ARTIFACT_DIR", str(tmp_path / "art"))
    args = chaos_run.parse_args([
        "--device", "cpu", "--root", str(tmp_path / "data"),
        "--seed", "7", "--ticks", "100",
        "--nemesis", "leader-isolate", "--isolate-period", "20"])
    ok, doc, _ = chaos_run.soak(args)
    # On a failure, the verdict, the recovery window and the step-downs.
    assert ok, (doc["verdict"], doc["recovery_windows"],
                doc["checkquorum_stepdowns"])
    assert doc["checkquorum_stepdowns"] >= 1
    windows = doc["recovery_windows"]
    assert len(windows) == 1 and windows[0]["recovered"], windows
    assert doc["verdict"]["ok"]
