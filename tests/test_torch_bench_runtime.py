"""The port's durable-runtime benchmark and its profiler against the
repo's ``bench_runtime.py``.

``rafting_tpu_torch.tools.bench_runtime.run`` on the CPU returns the
reference's result keys, level by level, with commits; the reference
runs at the same size beside it (JAX on the CPU).  ``profile_runtime``
prints its tables and the sampled split of the tick thread, and saves
its artifact, labelled with the device it ran on.  Without a card and
without ``--device cpu`` both refuse.
"""

import gzip
import json
import os

import pytest
import torch

import bench_runtime as reference
from rafting_tpu_torch.tools import _artifact, bench_runtime, profile_runtime


def test_run_keys_match_reference():
    want = reference.run(n_groups=64, rounds=3)
    got = bench_runtime.run(n_groups=64, rounds=3, device="cpu")
    # The shape of the result, level by level.  The latency plane's
    # per-phase entries depend on which sampled spans completed in the
    # run, so they are held to the reference's phase names only.
    assert set(got) == set(want)
    for k in ("tick_latency", "tick_stages_mean_s", "latency", "heat"):
        assert set(got[k]) == set(want[k]), k
    assert set(got["latency"]["counts"]) == set(want["latency"]["counts"])
    phases = ("submit_offer", "offer_stage", "stage_fsync", "fsync_send",
              "send_commit", "commit_apply", "apply_ack")
    assert set(got["latency"]["phases"]) <= set(phases)
    assert got["metric"] == want["metric"]
    assert got["value"] > 0 and want["value"] > 0
    assert got["rounds"] == want["rounds"] == 3
    assert got["burst_per_group"] == want["burst_per_group"] == 32
    # The CPU default is the serial runtime in both packages.
    assert got["pipeline"] == want["pipeline"]
    assert got["tick_latency"]["ticks"] == want["tick_latency"]["ticks"]


def test_profile_runtime_writes_its_artifact(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(_artifact, "ARTIFACT_DIR", str(tmp_path))
    profile_runtime.main(["64", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "==== top by cumulative ====" in out
    assert "==== top by tottime ====" in out
    res = json.loads(next(ln for ln in out.splitlines()
                          if ln.startswith("{")))
    assert res["value"] > 0
    (name,) = os.listdir(tmp_path)
    assert name == "profile_runtime_cpu_000.json.gz"
    with gzip.open(tmp_path / name, "rt") as f:
        doc = json.load(f)
    assert doc["platform"] == "cpu" and doc["ok"]
    assert doc["config"] == {"n_groups": 64, "rounds": 3, "device": "cpu"}
    phases = {p["phase"]: p for p in doc["phases"]}
    assert phases["bench"]["commits_per_sec"] == res["value"]
    for key in ("top_cumulative", "top_tottime"):
        rows = phases[key]["rows"]
        assert len(rows) == profile_runtime.TOP_N
        assert all(r["ncalls"] >= 1 for r in rows)
    # The sampled split of the tick thread: every node tick of the loaded
    # rounds, the step's launch inside _dispatch, the named stages inside
    # _host_phase.
    split = phases["tick_split"]
    assert split["node_ticks"] == 3 * (5 + 3)
    assert split["commits_per_sec"] > 0
    ms = split["ms_per_tick"]
    assert {"tick/_dispatch", "tick/_host_phase", "tick/_fetch"} <= set(ms)
    assert all(v >= 0 for v in ms.values())
    chains = dict(split["top_chains"])
    assert any(k.startswith("tick/_dispatch/node_step") for k in chains)
    assert "[tick split]" in out


def test_no_card_refuses(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        bench_runtime.main(["64"])
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_runtime.main(["64", "3"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_runtime.run(n_groups=64, rounds=3)
