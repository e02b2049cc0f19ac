"""Threefry-2x32 keys and integer draws in plain numpy.

A frozen copy of the arithmetic of ``pymgrid_tpu_torch/core/prng.py``
(``threefry2x32``, ``split``, ``fold_in``, ``bits`` and the int32 path of
``randint``, which follow ``jax.random``'s partitionable layout), rewritten
for numpy ``uint64`` words that hold 32-bit values.  A key is an array
``(..., 2)`` of two uint32 words; every function maps over its leading axes.
"""
import numpy as np

MASK = np.uint64(0xFFFFFFFF)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u64(x):
    return np.asarray(x, dtype=np.uint64)


def _rotl(x, r):
    return ((x << np.uint64(r)) & MASK) | (x >> np.uint64(32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The 20-round Threefry-2x32 hash of counter words ``(x1, x2)`` under
    key words ``(k1, k2)``; uint64 arrays of 32-bit values that broadcast."""
    k1, k2, x1, x2 = (_u64(v) for v in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ np.uint64(0x1BD11BDA))
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + np.uint64(i + 1)) & MASK
    return x1, x2


def split(key, num=2):
    """``(..., 2)`` keys -> ``(..., num, 2)``: the hash of counters
    ``(0, i)`` for ``i < num``."""
    key = _u64(key)
    counters = np.arange(num, dtype=np.uint64)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None], np.uint64(0), counters)
    return np.stack([b1, b2], axis=-1)


def fold_in(key, data):
    """The hash of counter words ``(0, data mod 2**32)`` under each key."""
    key = _u64(key)
    x1, x2 = threefry2x32(key[..., 0], key[..., 1], np.uint64(0),
                         np.uint64(int(data) & 0xFFFFFFFF))
    return np.stack([x1, x2], axis=-1)


def bits32(key):
    """One uint32 per key (counter 0): ``b1 ^ b2``."""
    key = _u64(key)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], np.uint64(0), np.uint64(0))
    return b1 ^ b2


def randint32(key, low, high):
    """One int32 in ``[low, high)`` per key, as ``jax.random.randint`` draws
    it with 32-bit integers: two draws folded by the modular span, every
    uint32 product and sum wrapping mod 2**32."""
    low = np.asarray(low, dtype=np.int64)
    high = np.asarray(high, dtype=np.int64)
    span = np.where(high <= low, 1, high - low).astype(np.uint64)
    pair = split(key)
    higher = bits32(pair[..., 0, :])
    lower = bits32(pair[..., 1, :])
    multiplier = ((np.uint64(2**16) % span) ** np.uint64(2) & MASK) % span
    offset = ((((higher % span) * multiplier) & MASK) + lower % span & MASK) % span
    value = (low.astype(np.uint64) + offset) & MASK
    return value.astype(np.int64).astype(np.uint32).view(np.int32).astype(np.int64)
