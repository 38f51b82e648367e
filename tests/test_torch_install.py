"""The durable snapshot plane and the group lifecycle, on the CPU, in both
packages.

* Lane for lane: a JAX ``LocalCluster`` and the port's, 16 groups x 3
  ``RaftNode``s with FileMachines and the aggressive maintain policy of
  ``tests/test_torch_step_graph.py``, run
  ``testkit/lockstep.py::run_lifecycle_script`` in lockstep over loopback:
  4 lanes closed and reopened and 4 purged and reused, the node leading
  the fewest groups killed until both survivors' WAL floor has passed its
  log tail in every group, restarted and caught up by a snapshot install
  in every group, then 4 more lanes closed and 4 more purged.  Every
  node's whole engine state, step info and outbox are equal in the two
  packages after every round.  Each package case holds its own run to the
  install and file gates; the port's steps copy a replaced leaf into
  their static state on exactly the rounds after a lifecycle write (the
  CPU runs the step graph's static buffers uncaptured,
  ``runtime/step_graph.py``).
* Over TCP (the port alone): the same script with the snapshot fetches
  crossing real localhost sockets.
* A rehearsal of ``chip_smoke.py``'s ``[install]`` phase with the device
  pointed at the CPU, at 64 groups.
* Two repairs of the port's node that ``[install]`` led to, each beside
  the reference's behaviour: every snapshot download keeps a file of its
  own (the reference's shared name lets a newer download of the group
  rewrite the file the tick is about to install), and the installs of one
  tick share one durability barrier (the reference syncs the WAL once per
  install).  And the port's CRC-32C, which the archive runs over every
  snapshot it saves, serves and installs, gives the reference's values.
"""

import importlib.util
import os

import numpy as np
import pytest

from rafting_tpu.core.types import EngineConfig as JaxEngineConfig
from rafting_tpu.snapshot.policy import MaintainAgreement as JaxMaintain
from rafting_tpu.testkit.harness import LocalCluster as JaxLocalCluster
from rafting_tpu.utils.crc32c import crc32c as jax_crc32c
from rafting_tpu_torch import EngineConfig, LocalCluster
from rafting_tpu_torch.core import step as step_mod
from rafting_tpu_torch.ops import quorum
from rafting_tpu_torch.snapshot.policy import MaintainAgreement
from rafting_tpu_torch.testkit.lockstep import (
    PINNED_ENV, pinned_env, run_lifecycle_script,
)
from rafting_tpu_torch.transport.tcp import TcpTransport
from rafting_tpu_torch.utils.crc32c import crc32c, crc32c_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G = 16
CFG_KW = dict(n_groups=G, n_peers=3, log_slots=16, batch=4, max_submit=4,
              election_ticks=10, heartbeat_ticks=3, rpc_timeout_ticks=8)
MAINTAIN_KW = dict(state_change_threshold=2, dirty_log_tolerance=1,
                   snap_min_interval=2, compact_min_interval=2,
                   compact_slack=2)
# Lifecycle round 0 (before the install) and round 1 (after it).
CLOSED = ((3, 4, 7, 8), (9, 10, 11, 12))
PURGED = ((5, 6, 13, 14), (0, 1, 2, 15))
PACKAGES = ("jax", "port")


def _collapse_backlog(cluster) -> None:
    """The port's node collapses any standing inbox backlog (a fault of
    the reference's inbox fixed in the port only); the JAX nodes here do
    the same, restarts included (as in tests/test_torch_step_graph.py)."""
    real = cluster.start_node

    def start_node(i):
        node = real(i)
        node.acc.COLLAPSE_BACKLOG = 1
        return node
    cluster.start_node = start_node
    for n in cluster.nodes.values():
        n.acc.COLLAPSE_BACKLOG = 1


@pytest.fixture(scope="module")
def lockstep_run(tmp_path_factory):
    """The lifecycle-and-install script on both packages in lockstep,
    lanes compared at every round (the script raises where they differ)."""
    root = tmp_path_factory.mktemp("install")
    with pinned_env():
        jc = JaxLocalCluster(
            JaxEngineConfig(**CFG_KW), str(root / "jax"), pipeline=False,
            maintain_factory=lambda: JaxMaintain(G, **MAINTAIN_KW))
        tc = LocalCluster(
            EngineConfig(**CFG_KW), str(root / "port"), pipeline=False,
            maintain_factory=lambda: MaintainAgreement(G, **MAINTAIN_KW),
            device="cpu")
        try:
            _collapse_backlog(jc)
            r = run_lifecycle_script([jc, tc], lanes=True, closed=CLOSED,
                                     purged=PURGED, drain_rounds=4)
        finally:
            jc.close()
            tc.close()
    return r


@pytest.mark.parametrize("pkg", PACKAGES)
def test_the_restarted_node_installs_in_every_group(lockstep_run, pkg):
    r = lockstep_run
    k = PACKAGES.index(pkg)
    installs = r["installs"][k]
    assert installs.shape == (G,) and (installs >= 1).all(), installs
    assert r["installed"][k] == int(installs.sum())
    assert r["fetched"][k] == int(installs.sum())
    # The same groups, as often, in both packages.
    assert np.array_equal(installs, r["installs"][1 - k])
    assert r["rounds"] > 60 and r["loads"] >= 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_machine_files_agree_across_nodes_and_packages(lockstep_run, pkg):
    r = lockstep_run
    files, other = r["files"][PACKAGES.index(pkg)], r["files"][0]
    assert files == other
    for g in range(G):
        copies = {files[(i, g)] for i in range(3)}
        assert len(copies) == 1 and copies != {b""}, g
    payloads = lambda g: {ln.split(b":", 1)[1]
                          for ln in files[(0, g)].splitlines()}
    # Purged after the install: only what the new incarnation committed.
    for g in PURGED[1]:
        assert all(p.startswith(f"g{g}-l1-".encode())
                   for p in payloads(g) - {b""}), g
    # Closed after the install: the whole history kept.
    for g in CLOSED[1]:
        got = payloads(g)
        for tag in (b"a", b"z", b"l1-"):
            assert any(p.startswith(f"g{g}-".encode() + tag) for p in got)


def test_port_copies_into_static_state_only_after_lifecycle_writes(
        lockstep_run):
    """The reference's nodes hold no step buffers (None); the port's copy
    the replaced leaves on the four rounds after a lifecycle write (the
    purge replaces every engine lane of a node, a close or reopen only
    ``active``) and nothing on any other round, the install rounds among
    them (the script raises otherwise)."""
    r = lockstep_run
    jax_copies, port_copies = r["copied"]
    assert jax_copies is None
    assert len(r["writes"]) == 4 and all(c > 0 for c in port_copies)
    purge, reopen = port_copies[0], port_copies[1]
    assert purge > reopen == 3 and port_copies == [purge, 3, purge, 3]


def test_install_over_tcp(tmp_path, monkeypatch):
    """The port alone over localhost TCP: every snapshot the restarted
    node installs was fetched through ``TcpTransport.fetch_snapshot``."""
    for k, v in PINNED_ENV.items():
        monkeypatch.setenv(k, v)
    seen = {"calls": 0, "bytes": 0}
    real = TcpTransport.fetch_snapshot

    def fetch_snapshot(self, peer, group, index, term, dest_path, *a, **k):
        res = real(self, peer, group, index, term, dest_path, *a, **k)
        seen["calls"] += 1
        if res is not None:
            seen["bytes"] += os.path.getsize(dest_path)
        return res
    monkeypatch.setattr(TcpTransport, "fetch_snapshot", fetch_snapshot)
    tc = LocalCluster(
        EngineConfig(**CFG_KW), str(tmp_path), pipeline=False,
        transport="tcp",
        maintain_factory=lambda: MaintainAgreement(G, **MAINTAIN_KW),
        device="cpu")
    try:
        assert all(isinstance(n.transport, TcpTransport)
                   for n in tc.nodes.values())
        r = run_lifecycle_script([tc], closed=CLOSED, purged=PURGED,
                                 drain_rounds=4)
    finally:
        tc.close()
    installs = r["installs"][0]
    assert (installs >= 1).all()
    assert seen["calls"] >= int(installs.sum()) and seen["bytes"] > 0
    assert r["copied"][0] is not None and all(r["copied"][0])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_install_phase_rehearsal(monkeypatch):
    """``[install]`` through ``chip_smoke.phase_install`` on the CPU at
    64 groups (serial: the CPU's default; the card runs it pipelined), with
    a launch counted per ``quorum_commit`` call as the card's wrapper
    counts it, and the kernel's timing entry stubbed (it needs the card);
    the wall-clock planes pinned off, so a loaded host does not evacuate
    leaders mid-run."""
    for k, v in PINNED_ENV.items():
        monkeypatch.setenv(k, v)
    cs = _chip_smoke()
    real = step_mod.quorum_commit

    def counted(*a, **k):
        quorum._count_launch("quorum_commit")
        return real(*a, **k)
    monkeypatch.setattr(step_mod, "quorum_commit", counted)
    entries = []

    def kernel_entry(name, launches):
        entries.append((name, launches))
        return {"name": name, "launches": launches, "ms": 0.0,
                "device_us": 1.0, "share_of_bound": 0.0,
                "v1_device_us": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "bytes": 0, "shape": []}
    monkeypatch.setattr(cs, "_kernel_entry", kernel_entry)
    try:
        kern = cs.phase_install(device="cpu", groups=64, pipeline=False)
    finally:
        quorum.reset_launch_counts()
    assert kern["name"] == "quorum_commit[install]"
    assert entries == [("quorum_commit[install]", kern["launches"])]
    assert kern["launches"] > 90


def _node_cluster(pkg, root):
    """A 4-group cluster of ``pkg``'s nodes (not ticked)."""
    cfg = dict(CFG_KW, n_groups=4)
    if pkg == "jax":
        return JaxLocalCluster(JaxEngineConfig(**cfg), str(root))
    return LocalCluster(EngineConfig(**cfg), str(root), device="cpu")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_each_snapshot_download_keeps_its_own_file(tmp_path, monkeypatch,
                                                  pkg):
    """A download of group 1 is handed to the tick; before the tick
    installs it, a newer milestone of the group is downloaded.  The
    port's first download still holds its own bytes; the reference
    names both files by group and epoch, so the second rewrote the
    first's (a fault of the reference, fixed in the port only)."""
    for k, v in PINNED_ENV.items():
        monkeypatch.setenv(k, v)
    c = _node_cluster(pkg, tmp_path)
    try:
        node = c.nodes[0]

        def fetch_snapshot(peer, group, index, term, dest_path, *a, **k):
            with open(dest_path, "wb") as f:
                f.write(f"milestone {index}\n".encode())
            return index, term
        node.transport.fetch_snapshot = fetch_snapshot
        node._download_snapshot(1, 2, 10, 1, 0)
        node._download_snapshot(1, 2, 20, 1, 0)
        (_, i1, _, p1), (_, i2, _, p2) = node._snap_fetched
        with open(p1) as f:
            first = f.read()
        assert (i1, i2) == (10, 20)
        if pkg == "port":
            assert p1 != p2 and first == "milestone 10\n"
        else:
            assert p1 == p2 and first == "milestone 20\n"
    finally:
        c.close()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_one_barrier_makes_a_ticks_installs_durable(tmp_path, monkeypatch,
                                                    pkg):
    """Three snapshots installed in one tick: the same installs, floors
    and metric in both packages; the port syncs the WAL once for all
    three, the reference once for each."""
    for k, v in PINNED_ENV.items():
        monkeypatch.setenv(k, v)
    c = _node_cluster(pkg, tmp_path / "c")
    try:
        node = c.nodes[0]
        fetched = []
        for g in (1, 2, 3):
            assert node.archive.pend_snapshot(g, 2, 1, 1) is not None
            tmp = str(tmp_path / f"snap-{g}")
            with open(tmp, "w") as f:
                f.write(f"1:g{g}-a\n2:g{g}-b\n")
            fetched.append((g, 2, 1, tmp))
        syncs = []
        real = node.store.sync
        node.store.sync = lambda *a, **k: (syncs.append(1), real(*a, **k))
        done = node._install_snapshots(fetched)
        assert [d[:3] for d in done] == [(1, 2, 1), (2, 2, 1), (3, 2, 1)]
        assert node.metrics["snapshots_installed"] == 3
        assert [node.store.floor(g) for g in (1, 2, 3)] == [2, 2, 2]
        assert [node.dispatcher.applied(g) for g in (1, 2, 3)] == [2, 2, 2]
        assert len(syncs) == (1 if pkg == "port" else 3)
    finally:
        c.close()


@pytest.mark.parametrize("n", [0, 1, 63, 64, 127, 128, 129, 192, 1000,
                               4096, 40_000, 65_537])
def test_crc32c_matches_the_reference(tmp_path, n):
    """The port's CRC-32C (numpy over whole 64-byte lanes) against the
    reference's byte loop: any length, any starting value, chained, and
    over a file read in chunks that split the lanes."""
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    for start in (0, 1, 0x89ABCDEF, 0xFFFFFFFF):
        assert crc32c(data, start) == jax_crc32c(data, start)
    cut = n // 3
    assert crc32c(data[cut:], crc32c(data[:cut])) == jax_crc32c(data)
    assert crc32c(bytearray(data)) == jax_crc32c(data)
    path = tmp_path / "blob"
    path.write_bytes(data)
    assert crc32c_file(str(path), chunk=1000) == jax_crc32c(data)
    if n == 0:
        assert crc32c(b"123456789") == 0xE3069283
