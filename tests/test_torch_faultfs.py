"""The port's storage-fault and open-loop test kits on the CPU
(``testkit/faultfs.py`` and ``testkit/openloop.py``, byte-for-byte copies
of the reference's; ``tests/test_torch_node.py`` holds them equal).

* Every case of ``tests/test_faultfs.py`` (the seeded planner, the engine
  fault table on both WAL tiers, the injector on ``LogStore``, cold-path
  faults, at-rest bit flips) and the pure open-loop cases of
  ``tests/test_overload.py``, each compiled from the reference test
  file's own source with its ``rafting_tpu.`` imports pointed at
  ``rafting_tpu_torch.``.
* The planners give the JAX package's schedules for the same seeds:
  ``plan_storage_faults``, ``gen_schedule`` and ``gen_transfers``.
* ``FaultInjector`` drives the port's ``LogStore`` on both tiers.
* Every module of the port's verification plane imports with ``jax``
  blocked and pulls in nothing of the JAX package.
"""

import dataclasses
import errno
import inspect
import os
import subprocess
import sys

import pytest

from rafting_tpu.testkit import faultfs as jfaultfs
from rafting_tpu.testkit import openloop as jopenloop
from rafting_tpu_torch.log import LogStore, native_available
from rafting_tpu_torch.log.wal import WalSyncError
from rafting_tpu_torch.testkit import faultfs, openloop
from test_torch_admin import _on_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = ["python"] + (["native"] if native_available() else [])

REFERENCE_CASES = {
    "test_faultfs.py": [
        "test_plan_deterministic_and_seed_sensitive",
        "test_plan_max_events_caps", "test_injector_arms_on_schedule",
        "test_fsync_fault_is_fail_stop", "test_enospc_is_retriable",
        "test_short_write_poisons_and_recovery_truncates",
        "test_delay_fault_slows_the_barrier",
        "test_sharded_barrier_merges_per_stripe_failures",
        "test_sharded_mixed_enospc_and_poison",
        "test_cold_faults_one_shot_and_restore",
        "test_cold_faults_torn_and_after",
        "test_cold_faults_break_archive_seal",
        "test_flip_bits_deterministic", "test_flip_bits_defeats_snapshot_crc",
    ],
    "test_overload.py": ["test_openloop_schedule_properties",
                         "test_no_collapse_check_predicate"],
}
CASES = [f"{f}::{n}" for f, names in sorted(REFERENCE_CASES.items())
         for n in names]
_NS: dict = {}


@pytest.mark.parametrize("case", CASES)
def test_reference_case_on_port(case, tmp_path):
    fname, name = case.split("::")
    if fname not in _NS:
        _NS[fname] = _on_port(fname)
    ns = _NS[fname]
    fn = ns[name]
    params = inspect.signature(fn).parameters
    backends = BACKENDS if "backend" in params else [None]
    for i, backend in enumerate(backends):
        kw = {}
        if "tmp_path" in params:
            kw["tmp_path"] = tmp_path / f"b{i}"
            kw["tmp_path"].mkdir()
        if backend is not None:
            kw["backend"] = backend
        fn(**kw)
    if fname == "test_faultfs.py":
        assert ns["faultfs"] is faultfs


# ------------------------------------------------------- the same plans --

@pytest.mark.parametrize("seed", [0, 3, 11, 29])
def test_storage_fault_plan_matches_reference(seed):
    kw = dict(fsync_p=0.05, enospc_p=0.05, short_p=0.03, delay_p=0.03)
    for ticks, shards, extra in ((128, 4, {}), (256, 2, {"max_events": 5}),
                                 (64, 1, {})):
        got = faultfs.plan_storage_faults(ticks, shards, seed=seed, **kw,
                                          **extra)
        want = jfaultfs.plan_storage_faults(ticks, shards, seed=seed, **kw,
                                            **extra)
        assert [dataclasses.astuple(e) for e in got] == \
            [dataclasses.astuple(e) for e in want]


SPECS = [dict(rate=500.0, duration_s=1.0, n_tenants=4, n_groups=4, seed=11),
         dict(rate=2000.0, duration_s=1.0, n_tenants=4, n_groups=4,
              hot_tenant_share=0.8, seed=7),
         dict(rate=500.0, duration_s=1.0, n_tenants=4, n_groups=4,
              mmpp=(5000.0, 0.1, 0.05), seed=11),
         dict(rate=75.0, duration_s=2.0, n_tenants=2, n_groups=2,
              deadline_s=2.0, seed=23)]


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_openloop_schedules_match_reference(i):
    spec, jspec = (openloop.OpenLoopSpec(**SPECS[i]),
                   jopenloop.OpenLoopSpec(**SPECS[i]))
    assert openloop.gen_schedule(spec) == jopenloop.gen_schedule(jspec)
    assert openloop.gen_transfers(spec, n_accounts=16, account_zipf=0.6) \
        == jopenloop.gen_transfers(jspec, n_accounts=16, account_zipf=0.6)
    assert len(openloop.gen_schedule(spec)) > 0


def test_no_collapse_check_matches_reference():
    def sweep(mod, points):
        out = []
        for ok, offered, p999 in points:
            r = mod.OpenLoopResult(duration_s=1.0)
            r.ok, r.offered, r.p999_s = ok, offered, p999
            out.append(r)
        return out
    for points in ([(400, 500, 0.2), (800, 1000, 0.3), (820, 2000, 0.4)],
                   [(400, 500, 0.2), (800, 1000, 0.3), (300, 2000, 0.4)],
                   [(400, 500, 0.2), (800, 1000, 2.5)], [(0, 10, 0.1)], []):
        assert openloop.no_collapse_check(sweep(openloop, points), 1.0) == \
            jopenloop.no_collapse_check(sweep(jopenloop, points), 1.0)


# --------------------------------------------- the injector, both tiers --

@pytest.mark.parametrize("backend", BACKENDS)
def test_injector_drives_logstore(tmp_path, backend):
    """A seeded plan armed tick by tick: ENOSPC on stripe 0 is retried
    with the staged record kept; fsync EIO on stripe 1 poisons it."""
    store = LogStore(str(tmp_path / "wal"), shards=2,
                     force_python=(backend == "python"))
    plan = (faultfs.FaultEvent(2, "write", 0, 0, errno.ENOSPC),
            faultfs.FaultEvent(4, "fsync", 1, 0, errno.EIO))
    inj = faultfs.FaultInjector(store, plan)
    nospace = 0
    for t in range(4):
        assert len(inj.advance(t)) == (1 if t == 2 else 0)
        store.wal.append_entry(0, t + 1, 1, b"g0-%d" % t)
        try:
            store.sync()
        except Exception as e:          # WalNoSpace: retriable
            assert not isinstance(e, WalSyncError), e
            nospace += 1
            store.sync()
    assert nospace == 1
    assert len(inj.advance(4)) == 1 and inj.pending == 0
    store.wal.append_entry(1, 1, 1, b"g1-doomed")
    with pytest.raises(WalSyncError):
        store.sync()
    assert store.poisoned_stripes() == [1]
    store.close()
    reopened = LogStore(str(tmp_path / "wal"), shards=2,
                        force_python=(backend == "python"))
    assert reopened.tail(0) == 4
    assert reopened.wal.entry_payload(0, 3) == b"g0-2"
    reopened.close()


# -------------------------------------------------------------- imports --

def test_verification_plane_imports_without_jax():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'rafting_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import rafting_tpu_torch.testkit.oracle\n"
        "import rafting_tpu_torch.testkit.parity\n"
        "import rafting_tpu_torch.testkit.chaos\n"
        "import rafting_tpu_torch.testkit.faultfs\n"
        "import rafting_tpu_torch.testkit.openloop\n"
        "from rafting_tpu_torch.testkit.invariants import "
        "check_transfer_atomicity\n"
        "import rafting_tpu_torch.tools.chaos_run\n"
        "import rafting_tpu_torch.testkit as tk\n"
        "assert tk.check_transfer_atomicity is check_transfer_atomicity\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and\n"
        "       m.split('.')[0] in ('jax', 'flax', 'rafting_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.mark.parametrize("rel", [
    "testkit/oracle.py", "testkit/parity.py", "testkit/chaos.py",
    "testkit/faultfs.py", "testkit/openloop.py", "testkit/invariants.py",
    "testkit/__init__.py", "tools/chaos_run.py", "tools/_artifact.py"])
def test_no_reference_package_names(rel):
    with open(os.path.join(REPO, "rafting_tpu_torch", rel)) as f:
        src = f.read()
    assert "import jax" not in src and "from jax" not in src
    assert not [ln for ln in src.splitlines()
                if "rafting_tpu." in ln.replace("rafting_tpu_torch.", "")]
