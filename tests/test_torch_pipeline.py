"""Twins of ``tests/test_pipeline.py``'s cases on both packages: the
durable pipeline's double-buffered tick (``runtime/node.py``), its
ack-after-fsync crash window, close draining the pending tick, the
sharded WAL's recovery, the off-thread checkpoint pool, the durable-tail
lane of the fused scan, and the pipelined and serial runtimes agreeing.
Each case runs on the reference (``jax``) and on the port (``port``, on
the CPU), and the fused scan's case also holds the two equal.

The invariant throughout: no submit future completes, and no RPC leaves
the node, for a log range that has not been fsynced, though the next
tick's scan is already dispatched while the fsync runs."""

import importlib
import os
import shutil
import threading

import numpy as np
import pytest

PKGS = ["jax", "port"]
PINNED_ENV = {"RAFT_ADMISSION": "0", "RAFT_HEALTH": "0"}


class _Pkg:
    """One package's pieces, by the same names in both."""

    def __init__(self, name: str):
        self.name = name
        base = "rafting_tpu" if name == "jax" else "rafting_tpu_torch"
        mod = lambda m: importlib.import_module(f"{base}.{m}")
        types = mod("core.types")
        store = mod("log.store")
        self.EngineConfig, self.LEADER = types.EngineConfig, types.LEADER
        self.LogStore = store.LogStore
        self.native_available = mod("log.wal").native_available
        self.MaintainAgreement = mod("snapshot.policy").MaintainAgreement
        self.NullProvider = mod("testkit.fixtures").NullProvider
        self._cluster = mod("testkit.harness").LocalCluster
        self._restore = store.restore_raft_state
        self.kw = {"device": "cpu"} if name == "port" else {}

    def cluster(self, cfg, root, **kw):
        return self._cluster(cfg, root, **kw, **self.kw)

    def restore(self, cfg, node_id, store):
        return self._restore(cfg, node_id, store, **self.kw)


def _cfg(p: _Pkg):
    return p.EngineConfig(n_groups=4, n_peers=3, log_slots=32, batch=4,
                          max_submit=4, election_ticks=10, heartbeat_ticks=3,
                          rpc_timeout_ticks=8)


@pytest.fixture(params=PKGS)
def pkg(request, monkeypatch):
    # The planes that decide from wall-clock time are off, so a loaded
    # host cannot shed a pipelined node's queue mid-flight (the
    # reference's late shed races its in-flight offer: ROADMAP queue 3).
    for k, v in PINNED_ENV.items():
        monkeypatch.setenv(k, v)
    return _Pkg(request.param)


# ---------------------------------------------------------------- crash window


def test_crash_between_dispatch_and_fsync_completes_nothing(pkg, tmp_path):
    """Kill the node inside the overlap window (tick N's scan accepted
    entries, its host phase has not run): the crash image recovers to the
    pre-accept durable tail, and no future completed for the range."""
    cfg = _cfg(pkg)
    c = pkg.cluster(cfg, str(tmp_path), pipeline=True, wal_shards=2)
    try:
        lead = c.wait_leader(0)
        c.tick(5)
        node = c.nodes[lead]
        tail_before = int(node._durable_tail_m[0])

        fut = node.submit_batch(0, [b"crash-%d" % k for k in range(3)])
        c.tick(1)
        pend = node._pending
        assert pend is not None, "pipelined node must hold a pending tick"
        acc = int(np.asarray(pend.info.submit_acc)[0])
        assert acc == 3, f"device should have accepted the batch, got {acc}"
        start = int(np.asarray(pend.info.submit_start)[0])
        assert not fut.done(), \
            "submit future completed before the range was fsynced"
        assert int(node._durable_tail_m[0]) == tail_before

        img = str(tmp_path / "crash-img")
        shutil.copytree(os.path.join(node.data_dir, "wal"), img)
        store = pkg.LogStore(img)
        try:
            assert store.tail(0) == tail_before < start
            state = pkg.restore(cfg, lead, store)
            assert int(np.asarray(state.log.last)[0]) == tail_before
            for idx in range(start, start + acc):
                assert store.payload(0, idx) is None
        finally:
            store.close()

        for _ in range(30):
            c.tick(1)
            if fut.done():
                break
        assert fut.done() and len(fut.result(timeout=1)) == 3
        assert int(node._durable_tail_m[0]) >= start + acc - 1
    finally:
        c.close()


def test_close_drains_pending_tick(pkg, tmp_path):
    """A graceful close settles the pending tick's host phase: the
    accepted range is durable and survives the restart."""
    c = pkg.cluster(_cfg(pkg), str(tmp_path), pipeline=True)
    try:
        lead = c.wait_leader(0)
        c.tick(5)
        node = c.nodes[lead]
        node.submit_batch(0, [b"drain-%d" % k for k in range(2)])
        c.tick(1)
        pend = node._pending
        assert pend is not None
        acc = int(np.asarray(pend.info.submit_acc)[0])
        assert acc == 2
        end = int(np.asarray(pend.info.submit_start)[0]) + acc - 1
        wal_dir = os.path.join(node.data_dir, "wal")
        c.kill_node(lead)
        store = pkg.LogStore(wal_dir)
        try:
            assert store.tail(0) >= end
            assert store.payload(0, end) == b"drain-1"
        finally:
            store.close()
        node = c.restart_node(lead)
        assert int(node._durable_tail_m[0]) >= end
    finally:
        c.close()


# ------------------------------------------------------- sharded WAL recovery


def _drive(store) -> None:
    """One deterministic durable workload over several groups (appends,
    overwrites, stable records, truncation, floor moves)."""
    for g in range(6):
        store.append_entries(g, 1, [1] * 4,
                             [b"g%d-%d" % (g, i) for i in range(4)])
        store.put_stable(g, 3, g % 3)
    store.append_spans([
        (1, 5, b"aabbb", np.asarray([2, 3], np.uint32),
         np.asarray([2, 2], np.int64)),
        (2, 3, b"xyz", np.asarray([3], np.uint32), 2),
    ])
    store.truncate_to(3, 2)
    store.set_floor(4, 2, 1)
    store.put_stable(5, 7, 1)
    store.sync()


def _exports_equal(a: dict, b: dict) -> None:
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("force_python", [True, False],
                         ids=["python", "native"])
def test_sharded_wal_recovery_parity(pkg, tmp_path, force_python):
    """The same workload under 4 stripes and under one flat WAL recovers
    to the same state: the overwrite, the truncation and the floor
    included."""
    if not force_python and not pkg.native_available():
        pytest.skip("no native WAL toolchain")
    flat, striped = str(tmp_path / "flat"), str(tmp_path / "striped")
    for path, shards in ((flat, 1), (striped, 4)):
        s = pkg.LogStore(path, force_python=force_python, shards=shards)
        _drive(s)
        s.close()

    G, L = 8, 32
    s1 = pkg.LogStore(flat, force_python=force_python)
    s4 = pkg.LogStore(striped, force_python=force_python)
    try:
        assert s4.wal.n_shards == 4
        _exports_equal(s1.export_state(G, L), s4.export_state(G, L))
        for g in range(6):
            assert s1.stable(g) == s4.stable(g)
            for idx in range(1, 8):
                assert s1.payload(g, idx) == s4.payload(g, idx), (g, idx)
        assert s4.payload(2, 3) == b"xyz" and s4.payload(2, 4) is None
        assert s4.tail(3) == 2 and s4.floor(4) == 2
    finally:
        s1.close()
        s4.close()


def test_sharded_wal_torn_tail_truncation(pkg, tmp_path):
    """Garbage at every shard's segment tail (a torn write) is cut on
    reopen; the recovered state equals the cleanly synced image."""
    path = str(tmp_path / "torn")
    s = pkg.LogStore(path, force_python=True, shards=4)
    _drive(s)
    clean = s.export_state(8, 32)
    s.close()
    for root, _dirs, files in os.walk(path):
        for f in files:
            if f.endswith(".wal"):
                with open(os.path.join(root, f), "ab") as fh:
                    fh.write(b"\x7ftorn-garbage\x00\x01")
    s2 = pkg.LogStore(path, force_python=True)
    try:
        assert s2.wal.n_shards == 4
        _exports_equal(clean, s2.export_state(8, 32))
    finally:
        s2.close()


def test_shard_meta_pins_layout(pkg, tmp_path):
    """Reopening with another stripe count keeps the pinned layout."""
    path = str(tmp_path / "pin")
    s = pkg.LogStore(path, force_python=True, shards=4)
    _drive(s)
    s.close()
    s2 = pkg.LogStore(path, force_python=True, shards=1)
    try:
        assert s2.wal.n_shards == 4
        assert s2.tail(1) == 6
    finally:
        s2.close()


# --------------------------------------------------- off-thread checkpoints


def test_tick_thread_never_runs_save_checkpoint(pkg, tmp_path):
    """Under a fast maintain cadence every archive save runs on a
    checkpoint worker, never on the tick thread."""
    cfg = _cfg(pkg)
    c = pkg.cluster(
        cfg, str(tmp_path), provider_factory=pkg.NullProvider,
        maintain_factory=lambda: pkg.MaintainAgreement(
            cfg.n_groups, state_change_threshold=1, dirty_log_tolerance=1,
            snap_min_interval=1, compact_min_interval=1, compact_slack=1),
        pipeline=True)
    tick_thread = threading.get_ident()
    saver_threads = []
    try:
        for node in c.nodes.values():
            orig = node.archive.save_checkpoint

            def spy(g, src, idx, term, _orig=orig):
                saver_threads.append(threading.get_ident())
                return _orig(g, src, idx, term)
            node.archive.save_checkpoint = spy
        c.wait_leader(0)
        for _ in range(40):
            for g in range(cfg.n_groups):
                lead = c.leader_of(g)
                if lead is not None and c.nodes[lead].is_ready(g):
                    c.nodes[lead].submit(g, b"x" * 16)
            c.tick(1)
        taken = sum(n.metrics["snapshots_taken"] for n in c.nodes.values())
        assert taken > 0, "no checkpoints ran"
        assert saver_threads
        assert tick_thread not in set(saver_threads)
    finally:
        c.close()


# -------------------------------------------------- durable-tail feedback lane


def _durable_lag_run(name: str):
    cfg_kw = dict(n_groups=16, n_peers=3, log_slots=64, batch=8,
                  max_submit=4, election_ticks=10, heartbeat_ticks=3,
                  rpc_timeout_ticks=8)
    if name == "jax":
        import jax
        import jax.numpy as jnp

        from rafting_tpu.core.sim import committed_entries, run_cluster_ticks
        from rafting_tpu.core.types import (
            EngineConfig, Messages, StepInfo, init_state,
        )
        cfg = EngineConfig(**cfg_kw)
        states = jax.vmap(lambda i: init_state(cfg, i, seed=7))(
            jnp.arange(3, dtype=jnp.int32))
        inflight = jax.vmap(lambda _: Messages.empty(cfg))(jnp.arange(3))
        info = jax.vmap(lambda _: StepInfo.empty(cfg))(jnp.arange(3))
        states, _, _ = run_cluster_ticks(
            cfg, 120, states, inflight, info, jnp.ones((3, 3), bool),
            jnp.full((3, cfg.n_groups), 2, jnp.int32), None, True)
    else:
        import torch

        from rafting_tpu_torch.core.sim import (
            committed_entries, run_cluster_ticks,
        )
        from rafting_tpu_torch.core.types import (
            EngineConfig, Messages, StepInfo, init_state, stack_states,
        )
        cfg = EngineConfig(**cfg_kw)
        states = stack_states([init_state(cfg, i, seed=7, device="cpu")
                               for i in range(3)])
        inflight = Messages.empty(cfg, device="cpu", lead=(3,))
        info = StepInfo.empty(cfg, device="cpu", lead=(3,))
        states, _, _ = run_cluster_ticks(
            cfg, 120, states, inflight, info,
            torch.ones((3, 3), dtype=torch.bool),
            torch.full((3, cfg.n_groups), 2, dtype=torch.int32),
            None, True, device="cpu")
    commit = np.asarray(states.commit)
    last = np.asarray(states.log.last)
    return int(committed_entries(states)), commit, last


@pytest.mark.parametrize("name", PKGS)
def test_fused_scan_durable_lag_still_commits(name):
    """With ``durable_lag=True`` every node's own commit-quorum match is
    clamped to the previous tick's tail; the cluster still elects and
    commits, and commit never outruns the log tail."""
    committed, commit, last = _durable_lag_run(name)
    assert committed > 0, "no commits under the durable-lag barrier"
    assert bool((commit <= last).all())


def test_fused_scan_durable_lag_port_equals_reference():
    """The same 120 durable-lag ticks give the same commits and tails in
    both packages, lane for lane."""
    a, b = _durable_lag_run("jax"), _durable_lag_run("port")
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])


def test_pipeline_serial_convergence(pkg, tmp_path):
    """The pipelined and serial runtimes drive one workload to the same
    applied outcome (the pipeline reorders work, never effects)."""
    results = {}
    cfg = _cfg(pkg)
    for mode in (True, False):
        root = str(tmp_path / f"m{int(mode)}")
        c = pkg.cluster(cfg, root, provider_factory=pkg.NullProvider,
                        seed=3, pipeline=mode)
        try:
            lead = c.wait_leader(0)
            c.tick_until(lambda: c.nodes[lead].is_ready(0),
                         what="leader ready")
            futs = [c.nodes[lead].submit_batch(0, [b"c%d" % k])
                    for k in range(8)]
            for _ in range(60):
                c.tick(1)
                if all(f.done() for f in futs):
                    break
            results[mode] = [f.result(timeout=1) for f in futs]
        finally:
            c.close()
    assert results[True] == results[False]
    assert results[True] == [[k + results[True][0][0]] for k in range(8)]
