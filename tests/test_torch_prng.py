"""The port's threefry2x32 twin against ``jax.random``, bit for bit.

The engine's election timeouts come from ``PRNGKey``/``split``/``randint``
(and the blocked runner's ``fold_in``); tick-for-tick parity between the
two packages rests on these draws being identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafting_tpu_torch.core import prng

N_KEYS = 1000


@pytest.fixture(scope="module")
def keys():
    seeds = np.random.default_rng(0).integers(0, 2 ** 31, N_KEYS,
                                              dtype=np.int64)
    seeds[:3] = [0, 1, 2 ** 31 - 1]
    jk = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.int32))
    tk = torch.stack([prng.prng_key(int(s)) for s in seeds])
    return seeds, jk, tk


def test_prng_key(keys):
    _, jk, tk = keys
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    # Seeds past 32 bits wrap as jax's x64-off key does.
    for s in (7919 * 5 + 2, 2 ** 32 + 5, -1):
        np.testing.assert_array_equal(np.asarray(jax.random.PRNGKey(s)),
                                      prng.prng_key(s).numpy())


@pytest.mark.parametrize("num", [2, 3])
def test_split(keys, num):
    _, jk, tk = keys
    want = jax.vmap(lambda k: jax.random.split(k, num))(jk)
    np.testing.assert_array_equal(np.asarray(want),
                                  prng.split(tk, num).numpy())


@pytest.mark.parametrize("data", [0, 5, 2 ** 31 + 3])
def test_fold_in(keys, data):
    _, jk, tk = keys
    want = jax.vmap(lambda k: jax.random.fold_in(k, data))(jk)
    np.testing.assert_array_equal(np.asarray(want),
                                  prng.fold_in(tk, data).numpy())


# [T, 2T) is the engine's election-timeout range.
@pytest.mark.parametrize("lo,hi", [(10, 20), (7, 14), (0, 1), (-100, 100),
                                   (3, 3 + 65537), (0, 2 ** 31 - 1),
                                   (-2 ** 31, 2 ** 31 - 1), (5, 5)])
def test_randint(keys, lo, hi):
    _, jk, tk = keys
    n = 37
    want = jax.vmap(lambda k: jax.random.randint(
        k, (n,), lo, hi, dtype=jnp.int32))(jk)
    got = prng.randint(tk, n, lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_engine_draw_chain(keys):
    """The step's chain: split the carried key, draw [T, 2T) from the
    second half, carry the first — repeated over ticks."""
    _, jk, tk = keys
    jk, tk = jk[:64], tk[:64]
    for _ in range(5):
        jsub = jax.vmap(jax.random.split)(jk)
        jk, jdraw = jsub[:, 0], jax.vmap(lambda k: jax.random.randint(
            k, (128,), 10, 20, dtype=jnp.int32))(jsub[:, 1])
        tsub = prng.split(tk)
        tk, tdraw = tsub[:, 0], prng.randint(tsub[:, 1], 128, 10, 20)
        np.testing.assert_array_equal(np.asarray(jdraw), tdraw.numpy())
        np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
