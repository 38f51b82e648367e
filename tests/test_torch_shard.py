"""The port's axis tables and group-blocked tick loop against the JAX
package.

``core/shard.py``'s tables name the node and group axes of every field of
the stacked containers; each must equal ``tuple(spec)`` of the JAX
PartitionSpec tables, for every combination of the optional subtrees.
``run_cluster_ticks_blocked`` pads, tiles, folds the per-block keys and
runs each block's tick loop: every lane of its result must equal the JAX
function's, padded and unpadded, with the optional subtrees on.  The two
protocol tests of ``tests/test_sim_scan.py`` run on the port too.  All
comparisons are exact.
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafting_tpu.core import cluster as jcl
from rafting_tpu.core import shard as jshard
from rafting_tpu.core import sim as jsim
from rafting_tpu.core import types as jty
from rafting_tpu_torch import (
    DeviceCluster, EngineConfig, run_cluster_ticks, run_cluster_ticks_blocked,
)
from rafting_tpu_torch.bridge import state_to_numpy
from rafting_tpu_torch.core import shard
from rafting_tpu_torch.core.types import _Tree

from test_torch_cluster import assert_same


def same_table(jx, tn, path=""):
    """Walk the port's table; every leaf tuple equals ``tuple(spec)``."""
    if isinstance(tn, _Tree):
        assert type(jx).__name__ == type(tn).__name__, path
        assert {f.name for f in dataclasses.fields(jx)} == \
            {f.name for f in dataclasses.fields(tn)}, path
        for f in dataclasses.fields(tn):
            same_table(getattr(jx, f.name), getattr(tn, f.name),
                       f"{path}.{f.name}")
        return
    if tn is None:
        assert jx is None, path
        return
    assert type(tn) is tuple and tn == tuple(jx), (path, tn, jx)


@pytest.mark.parametrize("trace,heat,qc",
                         list(itertools.product((False, True), repeat=3)))
def test_state_table_matches_jax(trace, heat, qc):
    same_table(jshard.state_pspecs(trace=trace, heat=heat, qc=qc),
               shard.state_pspecs(trace=trace, heat=heat, qc=qc))


@pytest.mark.parametrize("qc", [False, True])
def test_info_table_matches_jax(qc):
    same_table(jshard.info_pspecs(qc=qc), shard.info_pspecs(qc=qc))


@pytest.mark.parametrize("durable", [False, True])
def test_host_table_matches_jax(durable):
    same_table(jshard.host_pspecs(durable=durable),
               shard.host_pspecs(durable=durable))


def test_message_fault_and_input_tables_match_jax():
    same_table(jshard.messages_pspecs(), shard.messages_pspecs())
    same_table(jshard.fault_schedule_pspecs(), shard.fault_schedule_pspecs())
    assert shard.CONN_PSPEC == tuple(jshard.CONN_PSPEC)
    assert shard.SUBMIT_PSPEC == tuple(jshard.SUBMIT_PSPEC)
    assert shard._STATE_NODE_ONLY == jshard._STATE_NODE_ONLY


def _cfg(G=48, **kw):
    # tests/test_sim_scan.py's shape.
    return dict(n_groups=G, n_peers=3, log_slots=32, batch=4, max_submit=4,
                election_ticks=10, heartbeat_ticks=3, **kw)


@pytest.mark.parametrize("G,block,ticks,seed,flags", [
    # 4 blocks of 32, 28 padding lanes.
    (100, 32, 48, 0, {}),
    # 3 blocks of 16, 8 padding lanes; every optional subtree but debug.
    (40, 16, 48, 0, dict(trace_depth=12, heat=True, check_quorum=True)),
    # Block 20 divides 40: no padding.
    (40, 20, 32, 3, {}),
])
def test_blocked_matches_jax(G, block, ticks, seed, flags):
    kw = _cfg(G, **flags)
    jcfg, tcfg = jty.EngineConfig(**kw), EngineConfig(**kw)
    jc = jcl.DeviceCluster(jcfg, seed=seed)
    tc = DeviceCluster(tcfg, seed=seed, device="cpu")
    sub = np.random.default_rng(seed).integers(0, 5, (3, G)).astype(np.int32)
    want = jsim.run_cluster_ticks_blocked(
        jcfg, ticks, jc.states, jc.inflight, jc.last_info, jc.conn,
        jnp.asarray(sub), block)
    got = run_cluster_ticks_blocked(
        tcfg, ticks, tc.states, tc.inflight, tc.last_info, tc.conn,
        torch.from_numpy(sub), block, device="cpu")
    for name, w, g in zip(("state", "inflight", "info"), want, got):
        assert_same(w, state_to_numpy(g), name)
    assert (np.asarray(want[0].commit).max(axis=0) > 0).any()
    if flags:
        assert int(np.asarray(want[0].trace.n).sum()) > 0


def test_blocked_runner_invariants():
    """tests/test_sim_scan.py::test_blocked_runner_invariants on the port:
    4 blocks of 32, padded from 100, keep the protocol invariants."""
    cfg = EngineConfig(**_cfg(G=100))
    c = DeviceCluster(cfg, seed=0, device="cpu")
    sub = torch.full((cfg.n_peers, cfg.n_groups), 3, dtype=torch.int32)
    s, inflight, info = run_cluster_ticks_blocked(
        cfg, 96, c.states, c.inflight, c.last_info, c.conn, sub, 32,
        device="cpu")

    roles = s.role.numpy()
    commit = s.commit.numpy()
    last = s.log.last.numpy()
    term = s.term.numpy()
    assert roles.shape == (3, 100)
    assert ((roles == 3).sum(axis=0) == 1).all(), "one leader per group"
    assert (commit.max(axis=0) > 0).all(), "every group commits"
    assert (commit <= last).all(), "commit never passes the log tail"
    lead_term = (term * (roles == 3)).max(axis=0)
    assert (lead_term == term.max(axis=0)).all()
    assert inflight.ae_valid.shape == (3, 3, 100)
    assert info.commit.shape == (3, 100)


def test_blocked_equals_unblocked_when_block_covers_all():
    """tests/test_sim_scan.py's case on the port: a block that covers
    every group is the plain loop."""
    cfg = EngineConfig(**_cfg(G=40))
    a = DeviceCluster(cfg, seed=1, device="cpu")
    b = DeviceCluster(cfg, seed=1, device="cpu")
    sub = torch.full((cfg.n_peers, cfg.n_groups), 2, dtype=torch.int32)
    s1, _, _ = run_cluster_ticks(
        cfg, 48, a.states, a.inflight, a.last_info, a.conn, sub,
        device="cpu")
    s2, _, _ = run_cluster_ticks_blocked(
        cfg, 48, b.states, b.inflight, b.last_info, b.conn, sub, 64,
        device="cpu")
    assert torch.equal(s1.commit, s2.commit)
    assert torch.equal(s1.term, s2.term)


def test_blocked_refuses_to_drift_to_cpu(monkeypatch):
    cfg = EngineConfig(**_cfg(G=8))
    c = DeviceCluster(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    idle = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_cluster_ticks_blocked(cfg, 1, c.states, c.inflight, c.last_info,
                                  c.conn, idle, 4)
