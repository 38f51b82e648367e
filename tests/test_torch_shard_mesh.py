"""The port's cluster sharded over ``torch.distributed`` against the
unsharded port and the JAX package.

The contract is ``tests/test_shard_mesh.py``'s: a whole cluster sharded
over a (node x group) mesh, advanced with the tick loop, equals the
unsharded run on every lane, exactly.  Here the mesh is four gloo
processes on the CPU (``rafting_tpu_torch/tools/dryrun_multichip.py``,
one spawn per mesh shape); the gathered result is held against the
port's unsharded ``run_cluster_ticks`` and the JAX package's.  The slice
shapes, the reassembly and the shape guard are pure functions, tested in
this process.  The spawned ranks import neither jax nor ``rafting_tpu``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafting_tpu.core import sim as jsim
from rafting_tpu.core import types as jty
from rafting_tpu_torch import (
    EngineConfig, Messages, StepInfo, init_state, run_cluster_ticks,
    run_cluster_ticks_nemesis,
)
from rafting_tpu_torch.bridge import state_to_numpy
from rafting_tpu_torch.core import prng, shard
from rafting_tpu_torch.core.types import stack_states, tree_map
from rafting_tpu_torch.testkit import nemesis
from rafting_tpu_torch.tools import dryrun_multichip as dm

from test_torch_cluster import assert_same

# tests/test_shard_mesh.py:55-56 and 103-105.
BASE = dict(n_groups=256, n_peers=4, log_slots=32, batch=4, max_submit=4,
            election_ticks=10, heartbeat_ticks=3)
BENCH5 = dict(n_groups=512, n_peers=5, log_slots=256, batch=32,
              max_submit=32, election_ticks=10, heartbeat_ticks=3,
              rpc_timeout_ticks=8)
# The nemesis case: every optional subtree on, as configs[3] runs it.
NEMESIS = dict(BASE, n_groups=64, pre_vote=True, rpc_timeout_ticks=8,
               trace_depth=16, heat=True, check_quorum=True,
               debug_checks=True)


def _port_cluster(kw, seed=0, submit=2):
    cfg = EngineConfig(**kw)
    N, G = cfg.n_peers, cfg.n_groups
    return cfg, (stack_states([init_state(cfg, i, seed=seed, device="cpu")
                               for i in range(N)]),
                 Messages.empty(cfg, "cpu", lead=(N,)),
                 StepInfo.empty(cfg, "cpu", lead=(N,)),
                 torch.ones((N, N), dtype=torch.bool),
                 torch.full((N, G), submit, dtype=torch.int32))


def _jax_run(kw, ticks):
    """tests/test_shard_mesh.py's unsharded baseline."""
    cfg = jty.EngineConfig(**kw)
    N = cfg.n_peers
    states = jax.tree.map(lambda *xs: jnp.stack(xs),
                          *[jty.init_state(cfg, i, seed=0) for i in range(N)])
    inflight = jax.tree.map(lambda a: jnp.broadcast_to(a, (N,) + a.shape),
                            jty.Messages.empty(cfg))
    info = jax.tree.map(lambda a: jnp.broadcast_to(a, (N,) + a.shape),
                        jty.StepInfo.empty(cfg))
    conn = jnp.ones((N, N), jnp.bool_)
    submit = jnp.full((N, cfg.n_groups), 2, jnp.int32)
    return jsim.run_cluster_ticks(cfg, ticks, states, inflight, info, conn,
                                  submit)


def _same(a, b, path=""):
    """Two nested dicts of numpy arrays (``state_to_numpy``), exactly."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
        return
    if a is None:
        assert b is None, path
        return
    assert a.dtype == b.dtype and a.shape == b.shape, path
    if not np.array_equal(a, b):
        raise AssertionError(f"{path} differs at "
                             f"{np.argwhere(a != b)[:5].tolist()}")


def _assert_gathered(rank0, port=None, jax_run=None):
    for k, name in enumerate(("state", "inflight", "info")):
        if port is not None:
            _same(state_to_numpy(port[k]), rank0[name], f"port.{name}")
        if jax_run is not None:
            assert_same(jax_run[k], rank0[name], f"jax.{name}")


# ---------------------------------------------------------------- (a) ----

@pytest.mark.parametrize("coords", list(itertools.product(range(2),
                                                          range(4))))
def test_local_slice_shapes(coords):
    """test_shard_mesh.py:137-154 at every coordinate of a 2 x 4 mesh:
    G = 64, P = 2 gives local term (1, 16), ae_valid (1, 2, 16), log.term
    (1, 16, 16); every slice is dense, in storage of its own."""
    kw = dict(n_groups=64, n_peers=2, log_slots=16, batch=4, max_submit=4,
              election_ticks=10, heartbeat_ticks=3)
    cfg, full = _port_cluster(kw)
    mesh = shard.Mesh(shape=(2, 4), coords=coords,
                      device=torch.device("cpu"))
    s, m, i, conn, sub = shard.shard_cluster(mesh, cfg, *full)
    assert tuple(s.term.shape) == (1, 16)
    assert tuple(m.ae_valid.shape) == (1, 2, 16)
    assert tuple(s.log.term.shape) == (1, 16, 16)
    assert tuple(s.next_idx.shape) == (1, 16, 2)
    assert tuple(s.rng.shape) == (1, 2)
    assert tuple(conn.shape) == (1, 2) and tuple(sub.shape) == (1, 16)
    n, g = coords
    assert torch.equal(s.term, full[0].term[n:n + 1, 16 * g:16 * g + 16])
    assert torch.equal(s.log.term,
                       full[0].log.term[n:n + 1, 16 * g:16 * g + 16])
    for t in (s.term, s.log.term, m.ae_ents, s.next_idx, i.commit):
        assert t.is_contiguous() and t.storage_offset() == 0


def _bad_cases():
    kw = dict(n_groups=64, n_peers=2, log_slots=16, batch=4, max_submit=4,
              election_ticks=10, heartbeat_ticks=3)
    cfg, (s, m, i, conn, sub) = _port_cluster(kw)
    return cfg, {
        "group_axis_halved": (s.replace(term=s.term[:, :32]), m, i, conn,
                              sub),
        "conn_rows": (s, m, i, conn[:1], sub),
        "message_group_axis": (s, m.replace(ae_valid=m.ae_valid[..., :32]),
                               i, conn, sub),
    }


@pytest.mark.parametrize("case", ["group_axis_halved", "conn_rows",
                                  "message_group_axis"])
def test_validate_cluster_shapes_rejects_mismatch(case):
    """test_shard_mesh.py:157-170: a declared group axis that does not
    hold G, or conn of the wrong shape, fails loudly."""
    cfg, cases = _bad_cases()
    with pytest.raises(AssertionError):
        shard.validate_cluster_shapes(cfg, *cases[case])
    # The same inputs whole pass.
    _, (s, m, i, conn, sub) = _port_cluster(dict(
        n_groups=64, n_peers=2, log_slots=16, batch=4, max_submit=4,
        election_ticks=10, heartbeat_ticks=3))
    shard.validate_cluster_shapes(cfg, s, m, i, conn, sub)


def _reassemble(parts, specs, shape):
    if isinstance(specs, tuple):
        return shard.assemble(parts, specs, shape)
    return tree_map(lambda spec, *ps: shard.assemble(list(ps), spec, shape),
                    specs, *parts)


def _np(tree):
    return ({"t": tree.numpy()} if torch.is_tensor(tree)
            else state_to_numpy(tree))


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1), (1, 4)])
def test_slices_reassemble_to_the_cluster(mesh_shape):
    """Every leaf sliced at every coordinate and put back together by
    ``assemble`` is the leaf, with the optional subtrees on."""
    cfg, (s, m, i, conn, sub) = _port_cluster(NEMESIS)
    st, msg, inf = shard._tables(s, i)
    a, b = mesh_shape
    coords = [(x, y) for x in range(a) for y in range(b)]
    for tree, specs in ((s, st), (m, msg), (i, inf),
                        (conn, shard.CONN_PSPEC), (sub, shard.SUBMIT_PSPEC)):
        parts = [shard.slice_tree(tree, specs, mesh_shape, c)
                 for c in coords]
        _same(_np(tree), _np(_reassemble(parts, specs, mesh_shape)),
              type(tree).__name__)


# ---------------------------------------------------------------- (b) ----

@pytest.fixture(scope="module")
def jax_runs():
    return {"base": _jax_run(BASE, 64), "bench5": _jax_run(BENCH5, 48)}


@pytest.mark.parametrize("mesh_shape,kw_name,ticks", [
    ((2, 2), "base", 64), ((4, 1), "base", 64), ((1, 4), "bench5", 48)])
def test_sharded_matches_unsharded_and_jax(jax_runs, mesh_shape, kw_name,
                                           ticks):
    """Four gloo ranks run the cluster sharded; gathered, it equals the
    port's unsharded run and the JAX package's on every lane."""
    kw = {"base": BASE, "bench5": BENCH5}[kw_name]
    job = {"cfg": kw, "mesh": mesh_shape, "ticks": ticks, "seed": 0,
           "submit": 2, "nemesis": None}
    ranks = dm.launch(job, 4, "gloo", "cpu")
    cfg, full = _port_cluster(kw)
    want = run_cluster_ticks(cfg, ticks, *full, device="cpu")
    _assert_gathered(ranks[0], port=want, jax_run=jax_runs[kw_name])

    a, b = mesh_shape
    N, G = cfg.n_peers, cfg.n_groups
    assert [r["coords"] for r in ranks] == [(x, y) for x in range(a)
                                            for y in range(b)]
    for r in ranks:
        assert r["local_term"] == (N // a, G // b)
        assert r["local_ae_valid"] == (N // a, N, G // b)
        assert r["foreign"] == [], r["foreign"]
    total = int(want[0].commit.amax(dim=0).to(torch.int64).sum())
    assert {r["committed"] for r in ranks} == {total}
    roles = ranks[0]["state"]["role"]
    assert ((roles == 3).sum(axis=0) == 1).all(), "one leader per group"
    assert (ranks[0]["state"]["commit"].max(axis=0) > 0).all()


# ---------------------------------------------------------------- (c) ----

def test_sharded_nemesis_matches_unsharded():
    """run_cluster_ticks_nemesis under chaos_mix on a 2 x 2 mesh, all four
    optional subtrees on: crash-restart draws, stalls, duplicate delivery
    and the per-tick crash/stall exchange, bit-exact with the unsharded
    run."""
    T = 90
    job = {"cfg": NEMESIS, "mesh": (2, 2), "ticks": T, "seed": 3,
           "submit": 4, "nemesis": {"seed": 5}}
    ranks = dm.launch(job, 4, "gloo", "cpu")
    cfg, (s, m, i, _, sub) = _port_cluster(NEMESIS, seed=3, submit=4)
    sched = nemesis.chaos_mix(cfg.n_peers, T, seed=5, device="cpu")
    assert bool(sched.crash.any()) and bool(sched.stall.any())
    want = run_cluster_ticks_nemesis(cfg, s, m, i, sched, sub, device="cpu")
    _assert_gathered(ranks[0], port=want)
    assert int(ranks[0]["state"]["trace"]["n"].sum()) > 0
    assert all(r["foreign"] == [] for r in ranks)


# ---------------------------------------------------------------- (d) ----

@pytest.mark.parametrize("g0,n", [(0, 96), (1000, 24), (4000, 96)])
def test_randint_base_is_a_slice_of_the_draw(g0, n):
    """randint(key, n, base=g0) is [g0:g0+n] of the whole draw, and of
    jax.random.randint's: what a shard of the group axis draws."""
    G = 4096
    for seed in (0, 7, 2 ** 31 - 1):
        key = prng.prng_key(seed)
        whole = prng.randint(key, G, 10, 20)
        part = prng.randint(key, n, 10, 20, base=g0)
        assert torch.equal(part, whole[g0:g0 + n])
        ref = np.asarray(jax.random.randint(
            jax.random.PRNGKey(seed), (G,), 10, 20, dtype=jnp.int32))
        np.testing.assert_array_equal(part.numpy(), ref[g0:g0 + n])


# ------------------------------------------------------------ the tool ---

def test_dryrun_refuses_what_the_machine_cannot_give(monkeypatch):
    """No card and no gloo: exit non-zero, never the CPU; nccl on the CPU
    is refused; a mesh that does not cover the world is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        dm.main(["--world", "4"])
    with pytest.raises(SystemExit, match="gloo"):
        dm.main(["--world", "1", "--backend", "nccl", "--device", "cpu"])
    with pytest.raises(SystemExit, match="mesh"):
        dm.main(["--world", "4", "--backend", "gloo", "--device", "cpu",
                 "--mesh", "2x1"])
    assert dm.factor(8) == (4, 2) and dm.factor(6) == (3, 2)
    assert dm.factor(2) == (2, 1) and dm.factor(1) == (1, 1)
    job = dm.dryrun_job(dm.factor(8))
    assert job["cfg"]["n_peers"] == 4 and job["cfg"]["n_groups"] == 32_768
