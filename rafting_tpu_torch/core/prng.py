"""Bit-exact twin of the ``jax.random`` calls the engine makes.

The JAX engine draws its randomized election timeouts from ``jax.random``
under jax's defaults: the ``threefry2x32`` generator with
``jax_threefry_partitionable=True``.  Tick-for-tick parity between the two
packages needs the very same bits, so this module reimplements the four
calls the engine uses — ``PRNGKey``, ``split``, ``fold_in`` and
``randint`` — on torch tensors.

Torch's uint32 support is partial, so every value is carried in int64 and
masked back to 32 bits after each add, multiply and shift.  A key is a
``[..., 2]`` int64 tensor holding the two uint32 words; a batch of node
keys is ``[N, 2]``.  Everything here is elementwise tensor math with no
host synchronisation, so it runs on the device inside the tick loop.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 block (20 rounds), elementwise over broadcast
    int64 tensors holding uint32 values.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with x64 off: the seed is taken as a
    32-bit value, so the key is ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (fold-like, partitionable): key ``[..., 2]`` ->
    ``[..., num, 2]``; subkey i hashes the counter pair ``(0, i)``."""
    k1, k2 = key[..., 0:1], key[..., 1:2]                       # [..., 1]
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)     # [..., num]
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter pair ``(0, data)``."""
    k1, k2 = key[..., 0], key[..., 1]
    z = torch.zeros_like(k1)
    b1, b2 = threefry2x32(k1, k2, z, z + (int(data) & _M32))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, n: int, base: int = 0) -> torch.Tensor:
    """32-bit random words for a flat shape ``(n,)``: key ``[..., 2]`` ->
    ``[..., n]`` (partitionable: counter i hashes to ``b1 ^ b2``).

    ``base`` offsets the counters: the words of ``base .. base+n-1``, which
    are the slice ``[base:base+n]`` of a larger draw from the same key.  A
    shard that holds groups ``[g0, g0+n)`` draws with ``base=g0``, as
    jax's partitionable threefry does for each shard of a sharded draw."""
    k1, k2 = key[..., 0:1], key[..., 1:2]
    lo = torch.arange(base, base + n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def randint(key: torch.Tensor, n: int, minval: int, maxval: int,
            base: int = 0) -> torch.Tensor:
    """``jax.random.randint(key, (n,), minval, maxval, dtype=int32)``:
    two 32-bit draws per value reduced modulo the span, as jax does.
    key ``[..., 2]`` -> int32 ``[..., n]``; ``base`` as in
    :func:`random_bits` (values ``base .. base+n-1`` of the draw)."""
    span = maxval - minval
    if span <= 0:
        span = 1
    span &= _M32
    m = 2 ** 16 % span
    mult = ((m * m) & _M32) % span         # the square wraps in uint32
    sub = split(key)
    hi = random_bits(sub[..., 0, :], n, base)
    lo = random_bits(sub[..., 1, :], n, base)
    # (hi % span) * mult wraps in uint32 in the reference; the int64
    # product keeps the same low 32 bits.
    off = (((hi % span) * mult) & _M32) + (lo % span)
    off = (off & _M32) % span
    return (minval + off).to(torch.int32)
