"""JAX's default PRNG in numpy: ``PRNGKey``, ``split`` and float32
``uniform`` of ``jax.random`` with ``jax_threefry_partitionable`` on (the
default of the jax the JAX package runs on), bit for bit.

A key is a ``(2,)`` uint32 array.  Threefry-2x32 with 20 rounds hashes a
64-bit counter per output element: the element's flat index, split into
its high and low words (``iota_2x32_shape``).  ``split(key, n)[i]`` is the
hash pair of counter ``i``; ``uniform`` takes the xor of the pair, keeps
its top 23 bits as the mantissa of a float in [1, 2), subtracts 1 and
scales to ``[minval, maxval)`` in float32 with one rounding, as XLA's CPU
backend computes ``jax._src.random``'s multiply-add.

The port needs it where a result must equal the JAX package's without jax
at hand (the card has none): the learned shortcut's seed draw of a
reference ``.pth`` import (``utils/torch_interop.py``), and a replay of a
JAX key chain.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x0, x1)``
    under ``key``; returns the two output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: ``[seed >> 32, seed & 0xFFFFFFFF]``
    (a seed of 32 bits or fewer has a zero high word)."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF if seed >= 0 else 0,
                     seed & 0xFFFFFFFF], np.uint32)


def _counters(n: int):
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``(num, 2)`` uint32 keys."""
    hi, lo = _counters(num)
    b0, b1 = threefry2x32(np.asarray(key, np.uint32), hi, lo)
    return np.stack([b0, b1], axis=1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32 random bits per element of ``shape`` (``_random_bits``)."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _counters(int(np.prod(shape, dtype=np.int64)))
    b0, b1 = threefry2x32(np.asarray(key, np.uint32), hi, lo)
    return (b0 ^ b1).reshape(shape)


def fma_f32(a: np.ndarray, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as XLA's CPU backend contracts
    it.  ``a * b`` of two float32 is exact in float64; the float64 sum's
    error (TwoSum) settles the one case a second rounding gets wrong, a
    float64 sum that lands on a float32 tie."""
    p = np.asarray(a, np.float64) * np.float64(b)
    c = np.float64(c)
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    other = (2.0 * s - r64).astype(np.float32)  # the neighbour across s
    tie = (other.astype(np.float64) - s == s - r64) & (err != 0)
    fix = tie & ((err > 0) == (other.astype(np.float64) > s))
    return np.where(fix, other, r)


def uniform(key: np.ndarray, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)``:
    ``max(minval, f * (maxval - minval) + minval)`` with ``f`` in [0, 1)
    and the multiply-add rounded once (:func:`fma_f32`)."""
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    floats = floats - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, fma_f32(floats, hi - lo, lo))
