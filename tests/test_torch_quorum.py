"""The port's quorum ops (ops/quorum.py) against the JAX package, exactly.

Same inputs, made with numpy from a seed, go through the JAX function and
its torch counterpart; every lane is int32 or bool, so the tolerance is
exact equality.  The JAX Pallas kernel runs in interpret mode on the CPU,
as tests/test_ops.py runs it, and is held equal to the port's plain
version — the function the CUDA kernel replaces.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafting_tpu.core.types import EngineConfig as JaxConfig
from rafting_tpu.ops import quorum as jq
from rafting_tpu_torch.core.types import EngineConfig
from rafting_tpu_torch.ops import quorum as tq

SHAPES = [(3, 16), (5, 256), (7, 64)]


def _case(rng, G, P, L):
    """tests/test_ops.py's input space, plus a few empty-mask lanes."""
    base = rng.integers(0, 5, G)
    last = base + rng.integers(0, L - 5, G)
    match = rng.integers(0, L, (G, P))
    match[:, 0] = last
    commit = np.minimum(rng.integers(0, L, G), last)
    own_from = rng.integers(0, L + 4, G)
    lead = rng.random(G) < 0.7
    full = (1 << P) - 1
    voters = rng.integers(1, full + 1, G)
    vnew = np.where(rng.random(G) < 0.5, rng.integers(1, full + 1, G), 0)
    voters[:4] = 0
    i32 = lambda a: np.asarray(a, np.int32)
    return (i32(match), i32(own_from), i32(last), i32(commit), lead,
            i32(voters), i32(vnew))


def _both(case):
    return [jnp.asarray(a) for a in case], [torch.from_numpy(np.asarray(a))
                                           for a in case]


@pytest.mark.parametrize("P,L", SHAPES)
def test_quorum_commit_ref_matches_jax(P, L):
    j, t = _both(_case(np.random.default_rng(42 + P), 1000, P, L))
    want = np.asarray(jq.quorum_commit_ref(*j))
    got = tq.quorum_commit_ref(*t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("P,L", SHAPES)
def test_masked_order_stat_matches_jax(P, L):
    rng = np.random.default_rng(7 + P)
    match = rng.integers(-1, L, (500, P)).astype(np.int32)
    bits = rng.random((500, P)) < 0.5
    want = np.asarray(jq.masked_order_stat(jnp.asarray(match),
                                           jnp.asarray(bits)))
    got = tq.masked_order_stat(torch.from_numpy(match),
                               torch.from_numpy(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("P,L", SHAPES)
def test_pallas_interpret_matches_port_plain_version(P, L):
    """The TPU kernel itself (interpret mode) against the port's plain
    version of the CUDA kernel, on the same inputs."""
    case = _case(np.random.default_rng(42 + P), 1000, P, L)
    j, t = _both(case)
    match, own_from, last, commit, lead, voters, vnew = j
    state_vec = jnp.stack([commit, last, lead.astype(jnp.int32), voters,
                           vnew])
    want = np.asarray(jq.quorum_commit_pallas(match, own_from, state_vec,
                                              True))
    np.testing.assert_array_equal(want, tq.quorum_commit_ref(*t).numpy())


@pytest.mark.parametrize("P", [3, 5])
def test_quorum_commit_fixed_matches_jax(P):
    rng = np.random.default_rng(3 + P)
    match, own_from, last, commit, lead, _, _ = _case(rng, 400, P, 32)
    jcfg = JaxConfig(n_groups=400, n_peers=P)
    tcfg = EngineConfig(n_groups=400, n_peers=P)
    want = np.asarray(jq.quorum_commit_fixed(
        jcfg, *(jnp.asarray(a) for a in (match, last, commit, own_from,
                                         lead))))
    got = tq.quorum_commit_fixed(
        tcfg, *(torch.from_numpy(np.asarray(a)) for a in (
            match, last, commit, own_from, lead)))
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("P,K", [(3, 4), (5, 2)])
def test_read_barrier_release_matches_jax(P, K):
    rng = np.random.default_rng(11 + P)
    G = 512
    full = (1 << P) - 1
    voters = rng.integers(1, full + 1, G).astype(np.int32)
    vnew = np.where(rng.random(G) < 0.5, rng.integers(1, full + 1, G),
                    0).astype(np.int32)
    evid = rng.integers(0, 20, (G, P)).astype(np.int32)
    stamp = np.sort(rng.integers(1, 20, (G, K)), axis=1).astype(np.int32)
    head = rng.integers(0, K, G).astype(np.int32)
    rlen = rng.integers(0, K + 1, G).astype(np.int32)
    rn = rng.integers(0, 9, (G, K)).astype(np.int32)
    for me in range(P):
        want = jq.read_barrier_release(
            jnp.asarray(voters), jnp.asarray(vnew), jnp.int32(me),
            *(jnp.asarray(a) for a in (evid, stamp, head, rlen, rn)))
        got = tq.read_barrier_release(
            torch.from_numpy(voters), torch.from_numpy(vnew),
            torch.tensor(me, dtype=torch.int32),
            *(torch.from_numpy(a) for a in (evid, stamp, head, rlen, rn)))
        for w, g in zip(want, got):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_dispatch_on_cpu_uses_plain_version_without_launching():
    """A CPU tensor never reaches the kernel; quorum_fixed keeps its
    bench meaning; the kernel wrapper refuses CPU tensors."""
    case = _case(np.random.default_rng(1), 300, 3, 16)
    t = [torch.from_numpy(np.asarray(a)) for a in case]
    match, own_from, last, commit, lead, voters, vnew = t

    @dataclasses.dataclass
    class Log:
        last: torch.Tensor

    tq.reset_launch_counts()
    cfg = EngineConfig(n_groups=300, n_peers=3)
    got = tq.quorum_commit(cfg, match, Log(last), commit, own_from, lead,
                           voters, vnew)
    np.testing.assert_array_equal(got.numpy(),
                                  tq.quorum_commit_ref(*t).numpy())
    fixed = tq.quorum_commit(dataclasses.replace(cfg, quorum_fixed=True),
                             match, Log(last), commit, own_from, lead,
                             voters, vnew)
    np.testing.assert_array_equal(
        fixed.numpy(), tq.quorum_commit_fixed(cfg, match, last, commit,
                                              own_from, lead).numpy())
    assert tq.launch_counts["quorum_commit"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tq.quorum_commit_cuda(*t)
