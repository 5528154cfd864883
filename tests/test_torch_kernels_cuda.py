"""The port's CUDA kernels against their plain torch twins, on the card.

Each test builds random inputs with numpy from a fixed seed, runs the
kernel on CUDA tensors and the plain twin on the same tensors, and requires
exact equality (no tolerance: the kernels reproduce the twins' integer,
boolean and IEEE float arithmetic).  They need a CUDA card and the CUDA
toolkit, and skip without them.  This file imports neither JAX nor the JAX
package, so on the machine with the card it runs without the repository's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from karpenter_core_tpu_torch.kernels import capacity, fill, packbits, reqmerge
from karpenter_core_tpu_torch.ops import masks as mask_ops
from karpenter_core_tpu_torch.ops import solve as solve_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _req(rng, rows, k, v, bounds, dev):
    words = mask_ops.words_for(v)
    mask = rng.integers(-2**31, 2**31, size=(rows, k, words), dtype=np.int64).astype(np.int32)
    mask &= mask_ops.full_words(v)
    gt = np.full((rows, k), -np.inf, np.float32)
    lt = np.full((rows, k), np.inf, np.float32)
    if bounds:
        gt = np.where(rng.random((rows, k)) < 0.5, rng.integers(-3, 5, (rows, k)), gt)
        lt = np.where(rng.random((rows, k)) < 0.5, rng.integers(0, 12, (rows, k)), lt)
    t = (mask, rng.random((rows, k)) < 0.6, rng.random((rows, k)) < 0.3,
         gt.astype(np.float32), lt.astype(np.float32))
    return mask_ops.ReqTensor(*(torch.as_tensor(x).to(dev) for x in t))


def _vocab_ints(rng, k, v, dev):
    vi = np.where(rng.random((k, v - 1)) < 0.7, rng.integers(0, 10, (k, v - 1)), np.inf)
    return torch.as_tensor(vi.astype(np.float32)).to(dev)


def _equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,types,k,v,bounds,size", [
    (8192, 1000, 8, 9, False, (0.25, 0.25, 1.0)),
    (300, 77, 3, 40, True, (0.25, 0.0, 1.0)),
    (64, 40, 2, 70, True, (0.0, 0.0, 0.0)),  # BIG must saturate to INT32_MAX
])
def test_it_capacity_matches_plain(card, n, types, k, v, bounds, size):
    rng = np.random.default_rng(n)

    def b(shape, p):
        return torch.as_tensor(rng.random(shape) < p).to(card)

    khb = tuple(bool(x) for x in rng.random(k) < 0.7) if bounds else (False,) * k
    args = (
        b((n, types), 0.9), b((types,), 0.9), _req(rng, n, k, v, bounds, card),
        _req(rng, types, k, v, bounds, card), _vocab_ints(rng, k, v, card), v, khb,
        b((n, 3), 0.6), b((n, 2), 0.6), b((types, 3, 2), 0.5),
        torch.as_tensor(rng.integers(0, 20, (n, 3)).astype(np.float32) * 0.25).to(card),
        torch.tensor(size, dtype=torch.float32, device=card),
        torch.as_tensor(rng.integers(0, 64, (types, 3)).astype(np.float32) * 0.5).to(card),
    )
    _equal(capacity.it_capacity(*args), capacity.it_capacity_plain(*args))


@pytest.mark.parametrize("n,k,v,bounds", [(8192, 8, 9, False), (500, 3, 40, True),
                                          (77, 1, 70, True)])
def test_req_merge_matches_plain(card, n, k, v, bounds):
    rng = np.random.default_rng(k)
    node, cls = _req(rng, n, k, v, bounds, card), _req(rng, 1, k, v, bounds, card)
    valid = mask_ops.pack_mask(torch.as_tensor(rng.random((k, v)) < 0.8).to(card))
    args = (node, cls, valid, _vocab_ints(rng, k, v, card),
            torch.as_tensor(rng.random(k) < 0.5).to(card), v, (bounds,) * k)
    got, want = reqmerge.merge_compat(*args), reqmerge.merge_compat_plain(*args)
    _equal(tuple(got[0]) + (got[1],), tuple(want[0]) + (want[1],))


@pytest.mark.parametrize("n", [1, 1023, 1025, 8192, 16384])
def test_fill_priority_matches_plain(card, n):
    rng = np.random.default_rng(n)
    cap = torch.as_tensor(rng.integers(0, 5, n).astype(np.int32)).to(card)
    prio = torch.as_tensor(rng.integers(0, 4, n).astype(np.int32)).to(card)
    prio = torch.where(cap > 0, prio, 2**31 - 1)
    pref = torch.as_tensor(rng.integers(0, 3, n).astype(np.int32)).to(card)
    for quota in (0, n // 3, 3 * n):
        q = torch.tensor(quota, dtype=torch.int32, device=card)
        assert torch.equal(fill.fill_by_priority(q, cap, prio),
                           fill.fill_by_priority_plain(q, cap, prio))
        assert torch.equal(
            solve_ops._fill_with_pref(solve_ops.KERNELS, q, cap, prio, pref),
            solve_ops._fill_with_pref(solve_ops.PLAIN, q, cap, prio, pref))
    # an int32 cumsum that wraps, as the reference's does
    big = torch.full((n,), 2**30, dtype=torch.int32, device=card)
    q = torch.tensor(2**31 - 1, dtype=torch.int32, device=card)
    assert torch.equal(fill.fill_by_priority(q, big, prio), fill.fill_by_priority_plain(q, big, prio))


@pytest.mark.parametrize("shape", [(8192, 1000), (8192, 3), (5, 13), (2, 3, 9)])
def test_pack_bool_matches_plain(card, shape):
    bits = torch.as_tensor(np.random.default_rng(len(shape)).random(shape) < 0.5).to(card)
    assert torch.equal(packbits.pack_bool(bits), packbits.pack_bool_plain(bits))
