"""Threefry-2x32 random numbers as pure tensor arithmetic.

Counterpart of the parts of ``jax.random`` the MD rollout uses:
``PRNGKey``, ``split``, ``bits`` (32-bit) and ``normal`` (float32), as
jax 0.9.0 computes them with ``jax_threefry_partitionable`` on (its
default): a key's children and a draw's bits hash the 64-bit counter of
each output position, split into (hi, lo) words.

A key is an int64 tensor ``[2]`` holding two uint32 words. Every add and
rotate is masked back to 32 bits (torch's uint32 has too few operations
on CUDA). Nothing here reads a value back to the host, keeps hidden
state or branches on a value, so a draw is a function of the key alone:
it replays inside a captured CUDA graph, gives the JAX package's bits on
the CPU and on the card, and a key saved in a checkpoint resumes the
stream exactly. ``normal`` matches ``jax.random.normal`` within float32
rounding only, because ``torch.erfinv`` is not XLA's polynomial.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# float32's neighbour of -1 towards 0 (numpy's nextafter in float32)
_NEXT_ABOVE_MINUS_ONE = -1.0 + 2.0 ** -24


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as JAX computes it with 64-bit types
    off (its default): the seed taken to 32 bits, the words ``(0, seed &
    0xFFFFFFFF)``."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of the counter words ``(x1, x2)`` under the
    key words ``(k1, k2)``: 20 rounds with the key injected every four,
    as ``jax._src.prng._threefry2x32_lowering``. Every argument holds
    uint32 values in int64; the key words broadcast against the
    counters."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x[0], x[1]


def _counters(n: int, device) -> tuple:
    """The (hi, lo) words of the 64-bit iota ``0 .. n-1``."""
    iota = torch.arange(n, dtype=torch.int64, device=device)
    return iota >> 32, iota & _MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[num, 2]`` child keys, child i
    being the hash of counter i."""
    hi, lo = _counters(int(num), key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` for 32-bit words: the two words of
    each position's hash XOR-ed (uint32 values in int64)."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _counters(math.prod(shape), key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float,
            maxval: float) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa
    of a float in [1, 2), shifted and scaled to [minval, maxval), and
    clamped below at ``minval``."""
    bits = random_bits(key, shape)
    one = 0x3F800000  # the bits of 1.0f
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) *
    erfinv(u)`` with ``u`` uniform on (nextafter(-1, 0), 1)."""
    u = uniform(key, shape, _NEXT_ABOVE_MINUS_ONE, 1.0)
    return torch.erfinv(u) * math.sqrt(2.0)
