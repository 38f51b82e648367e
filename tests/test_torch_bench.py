"""The port's benchmark entry point (``rafting_tpu_torch/tools/bench.py``)
against the repo's ``bench.py``.

A scale's child of each, on the CPU in subprocesses at the same seed,
scale and blocking, reports the same committed count (and the same read
totals, trace events and faulted commits in those stages): the two
engines are bit-exact, so the counts are exact.  Without a card and
without ``--device cpu`` the twin exits non-zero (the five stages that
replace the ladder: tests/test_torch_bench_stages.py).  The new modules
import without jax.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from rafting_tpu_torch.tools import bench as twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _children(args, extra):
    """Start bench.py's child (JAX) and the twin's side by side; return
    both result dicts."""
    cmds = ([sys.executable, os.path.join(REPO, "bench.py"), "--child",
             *args, "cpu"],
            [sys.executable, "-m", "rafting_tpu_torch.tools.bench",
             "--child", *args, "cpu"])
    procs = [subprocess.Popen(c, cwd=REPO, env=_env(extra), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for c in cmds]
    out = []
    for p in procs:
        so, se = p.communicate(timeout=300)
        assert p.returncode == 0, se[-2000:]
        out.append(json.loads(so.strip().splitlines()[-1]))
    return out


@pytest.mark.parametrize("args,extra,same", [
    (("96", "32", "32"), {}, ("commits",)),
    (("200", "32", "32"), {"BENCH_GROUP_BLOCK": "64"}, ("commits",)),
    (("200", "32", "32"), {"BENCH_GROUP_BLOCK": "64", "BENCH_READS": "1"},
     ("commits", "reads", "lease_hits", "appended")),
    (("96", "32", "32"), {"BENCH_NEMESIS": "1"}, ("commits",)),
    (("96", "32", "32"), {"BENCH_TRACE": "1"}, ("commits", "trace_events")),
], ids=["unblocked", "blocked", "reads-blocked", "nemesis", "trace"])
def test_child_matches_bench_py(args, extra, same):
    ref, got = _children(args, extra)
    for k in same:
        assert got[k] == ref[k] > 0, (k, ref, got)
    assert set(ref) <= set(got), set(ref) - set(got)
    assert got["platform"] == got["device"] == "cpu"
    blocked = "BENCH_GROUP_BLOCK" in extra
    assert (got["n_blocks"], got["group_block"]) == \
        ((4, 50) if blocked else (1, 0))


def test_no_card_exits_nonzero():
    """No card and no ``--device``: the twin and its child exit non-zero
    (this machine has no card) and run nothing on the CPU."""
    env = _env({"CUDA_VISIBLE_DEVICES": ""})
    for args in ([], ["--child", "32", "4", "4"]):
        r = subprocess.run([sys.executable, "-m",
                            "rafting_tpu_torch.tools.bench", *args],
                           cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode != 0, r.stdout
        assert "CUDA" in r.stderr, r.stderr[-1000:]
        assert not r.stdout.strip(), r.stdout


def test_member_child_and_bad_device_refuse(monkeypatch):
    """The member child needs the card unless it is given ``cpu``; a
    device other than cpu or cuda is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        twin.main(["--member-child", "64"])
    with pytest.raises(SystemExit, match="--device"):
        twin.main(["--device", "tpu"])


NEW_MODULES = ("core/shard.py", "core/sim.py", "tools/bench.py",
               "tools/bench_runtime.py", "tools/profile_runtime.py")


def test_bench_modules_import_without_jax():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'rafting_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import rafting_tpu_torch.core.shard\n"
        "import rafting_tpu_torch.tools.bench\n"
        "import rafting_tpu_torch.tools.bench_runtime\n"
        "import rafting_tpu_torch.tools.profile_runtime\n"
        "from rafting_tpu_torch import run_cluster_ticks_blocked\n"
        # What the member, open-loop, txn, lat and heat stages import.
        "import rafting_tpu_torch.api.stub\n"
        "import rafting_tpu_torch.machine.kv_machine\n"
        "import rafting_tpu_torch.runtime.txn\n"
        "import rafting_tpu_torch.testkit.chaos\n"
        "import rafting_tpu_torch.testkit.harness\n"
        "import rafting_tpu_torch.testkit.openloop\n"
        "from rafting_tpu_torch.tools.bench import STAGES, member_walk\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and\n"
        "       m.split('.')[0] in ('jax', 'flax', 'rafting_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=_env({}), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


@pytest.mark.parametrize("rel", NEW_MODULES)
def test_no_reference_package_names(rel):
    with open(os.path.join(REPO, "rafting_tpu_torch", rel)) as f:
        src = f.read()
    assert "import jax" not in src and "from jax" not in src
    assert not [ln for ln in src.splitlines()
                if "rafting_tpu." in ln.replace("rafting_tpu_torch.", "")]
