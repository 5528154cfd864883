"""JAX's ``random.permutation(PRNGKey(seed), n)`` in numpy, bit for bit.

The relax family's rounding breaks fraction ties in a seeded order: the
reference draws ``jax.random.permutation(jax.random.PRNGKey(seed), n_cells)``
(``karpenter_core_tpu/relax/kernel.py:281``).  The card's machine has no JAX,
so this module reproduces that draw on the host, in the mode the reference
runs under (``jax_threefry_partitionable=True``):

  - ``threefry2x32``: Random123's Threefry-2x32, 20 rounds (JAX's
    ``_src/prng.py`` ``threefry_2x32``);
  - ``prng_key(seed)``: ``PRNGKey(seed)`` as the reference builds it with
    64-bit types off: the seed becomes an int32 (its low 32 bits), so the
    key is ``[0, seed & 0xFFFFFFFF]`` (``threefry_seed``; a seed of 2**32 + 3
    gives the key of 3);
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
The what-if studies' ``jax.random.uniform`` draws (``parallel.mesh``) come
from the same generator: ``uniform`` here is the host version, and K19
(``kernels/perturb.py``) computes the same draw on the card.
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
    """``jax.random.PRNGKey(seed)`` (raw uint32[2]) with 64-bit types off:
    only the seed's low 32 bits reach the key."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


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


def uniform(key, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32)`` (minval 0, maxval 1) in
    the partitionable mode, bit for bit: each cell's 32 bits are ``b1 ^ b2``
    at counters ``(hi, lo)`` of its row-major flat index
    (``iota_2x32_shape``); their top 23 bits become the mantissa of a float
    in [1, 2), less 1.  The reference then takes ``max(0, x * (1 - 0) +
    0)``, which leaves every such x as it is."""
    shape = tuple(int(d) for d in shape)
    idx = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    b1, b2 = threefry2x32(key, (idx >> np.uint64(32)).astype(np.uint32),
                          (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = ((b1 ^ b2) >> np.uint32(9)) | np.uint32(0x3F800000)
    return (bits.view(np.float32) - np.float32(1.0)).reshape(shape)


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
