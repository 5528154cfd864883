"""JAX's ``random.permutation(PRNGKey(seed), n)`` in numpy, bit for bit.

The relax family's rounding breaks fraction ties in a seeded order: the
reference draws ``jax.random.permutation(jax.random.PRNGKey(seed), n_cells)``
(``karpenter_core_tpu/relax/kernel.py:281``).  The card's machine has no JAX,
so this module reproduces that draw on the host, in the mode the reference
runs under (``jax_threefry_partitionable=True``):

  - ``threefry2x32``: Random123's Threefry-2x32, 20 rounds (JAX's
    ``_src/prng.py`` ``threefry_2x32``);
  - ``prng_key(seed)``: ``PRNGKey`` of a 32-bit seed, ``[seed >> 32, seed &
    0xFFFFFFFF]`` (``threefry_seed``);
  - ``split`` and ``random_bits``: the partitionable forms
    (``_threefry_split_foldlike``, ``_threefry_random_bits_partitionable``):
    counters ``(0, i)`` from ``iota_2x32_shape``; 32-bit bits are
    ``b1 ^ b2``;
  - ``permutation``: ``_src/random.py`` ``_shuffle``: ``ceil(3 ln n /
    ln(2^32 - 1))`` rounds, each a split and a stable sort of ``arange(n)``
    by fresh 32-bit keys (2 rounds at n = 3,000, 1 up to n = 1,625).

The permutation depends on two host integers only, so ``permutation`` is
memoized by ``(seed, n)``: it is computed once and, in ``relax.kernel``,
uploaded once per device.  That memo stands in for the reference's
``utils/compilecache.relax_callable`` (:580): the port runs eagerly and has
no executable to cache, and the permutation is the one input worth keeping.
The mesh programs' ``jax.random.uniform`` masks (ROADMAP 1.8) draw from the
same generator.
"""

from __future__ import annotations

import functools
import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 of the counter pairs ``(x0, x1)`` (uint32 arrays) under
    ``key`` (two uint32)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.asarray(x0, dtype=np.uint32) + ks[0], np.asarray(x1, dtype=np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` (raw uint32[2]) for 0 <= seed < 2**64."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=np.uint32)


def _bits_pair(key, n: int):
    counts = np.arange(n, dtype=np.uint32)
    return threefry2x32(key, np.zeros(n, dtype=np.uint32), counts)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: uint32[num, 2]."""
    b1, b2 = _bits_pair(key, num)
    return np.stack([b1, b2], axis=1)


def random_bits(key, n: int) -> np.ndarray:
    """``jax.random.bits(key, (n,), uint32)``."""
    b1, b2 = _bits_pair(key, n)
    return b1 ^ b2


@functools.lru_cache(maxsize=64)
def _permutation(seed: int, n: int) -> np.ndarray:
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    key = prng_key(seed)
    x = np.arange(n, dtype=np.int32)
    for _ in range(rounds):
        key, sub = split(key)
        order = np.argsort(random_bits(sub, n), kind="stable")
        x = x[order]
    x.setflags(write=False)
    return x


def permutation(seed: int, n: int) -> np.ndarray:
    """``jax.random.permutation(jax.random.PRNGKey(seed), n)`` as int32[n]
    (read-only: it is shared by every caller of the same ``(seed, n)``)."""
    return _permutation(int(seed), int(n))


def shuffle_rounds(n: int) -> int:
    """Sort rounds of ``_shuffle`` at size n."""
    return int(math.ceil(3 * math.log(max(1, n)) / math.log(2**32 - 1)))
