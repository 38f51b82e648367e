"""BASELINE configs[3]'s partition scenario on the port against the JAX
package, tick for tick.

``rafting_tpu_torch/tools/validate_config4.py``'s ``run_config4`` drives
the port's ``DeviceCluster``; the same steps (``tools/validate_config4.py``
of the repo) drive the JAX package's.  At 1,024 groups x 5 nodes on the
CPU, every partitioned window's ``progressed_pct``, the commit totals and
the final ``commit``/``term``/``role`` lanes must be equal exactly; both
clusters run their split-brain check every tick (``debug_checks``).
"""

import dataclasses
import gzip
import json

import numpy as np
import pytest
import torch

from rafting_tpu.core import cluster as jcl
from rafting_tpu.core import types as jty
from rafting_tpu_torch.tools import _artifact
from rafting_tpu_torch.tools import validate_config4 as vc4

G = 1024


def _jax_config4(n_groups):
    """The repo's tools/validate_config4.py:30-78 on the JAX package,
    returning its phase numbers and final cluster."""
    kw = dataclasses.asdict(vc4.config4_cfg(n_groups))
    c = jcl.DeviceCluster(jty.EngineConfig(**kw), seed=vc4.SEED)
    for _ in range(60):
        c.tick(submit_n=4)
    commit0 = np.asarray(c.states.commit).max(axis=0)
    phases = [int(commit0.astype(np.int64).sum())]
    c.set_partition([[0, 1, 2], [3, 4]])
    commit1 = commit0
    for k in range(6):
        for _ in range(30):
            c.tick(submit_n=4)
        commit1 = np.asarray(c.states.commit)[:3].max(axis=0)
        frac = float((commit1 > commit0).mean())
        phases.append(round(frac * 100, 3))
        if frac == 1.0:
            break
    c.heal()
    for _ in range(60):
        c.tick(submit_n=4)
    for _ in range(15):
        c.tick()
    commit2 = np.asarray(c.states.commit).max(axis=0)
    phases.append(int(commit2.astype(np.int64).sum()))
    return phases, c


@pytest.fixture(scope="module")
def both():
    plog, tc = vc4.run_config4(G, "cpu")
    return plog.phases, tc, _jax_config4(G)


def test_config4_windows_match_jax(both):
    phases, _, (want, _) = both
    got = ([phases[0]["committed"]]
           + [p["progressed_pct"] for p in phases
              if p["phase"] == "partitioned"]
           + [phases[-1]["committed"]])
    assert got == want
    windows = [p for p in phases if p["phase"] == "partitioned"]
    assert windows[-1]["progressed_pct"] == 100.0
    assert [p["ticks"] for p in windows] == [30 * (k + 1)
                                             for k in range(len(windows))]


def test_config4_final_lanes_match_jax(both):
    _, tc, (_, jc) = both
    for name in ("commit", "term", "role"):
        np.testing.assert_array_equal(
            getattr(tc.states, name).numpy(),
            np.asarray(getattr(jc.states, name)), err_msg=name)
    role = tc.states.role.numpy()
    assert ((role == 3).sum(axis=0) == 1).all(), "one leader per group"


def test_config4_records_each_phase(both):
    phases, _, _ = both
    names = [p["phase"] for p in phases]
    assert names[0] == "elect+replicate" and names[-1] == "healed"
    assert phases[-1]["split_brain"] == 0
    assert phases[-1]["commits_after_heal"] > 0
    for p in phases:
        assert p["ms_per_tick"] > 0 and p["elapsed_s"] > 0
    assert phases[1]["tpu_progressed_pct"] == 95.7


def test_config4_main_writes_the_artifact(tmp_path, monkeypatch, capsys):
    """The command line at 64 groups on the CPU: the artifact names the
    device and holds every phase."""
    monkeypatch.setattr(_artifact, "ARTIFACT_DIR", str(tmp_path))
    assert vc4.main(["64", "--device", "cpu"]) == 0
    (path,) = tmp_path.glob("config4_cpu_*.json.gz")
    doc = json.load(gzip.open(path, "rt"))
    assert doc["config"]["device"] == "cpu"
    assert doc["config"]["n_groups"] == 64
    assert doc["phases"][-1]["phase"] == "healed"
    assert "config-4 OK on cpu" in capsys.readouterr().out


def test_config4_refuses_to_drift_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        vc4.main(["64"])
    with pytest.raises(RuntimeError, match="CUDA"):
        vc4.run_config4(64)
