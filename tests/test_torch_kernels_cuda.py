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

from karpenter_core_tpu_torch.kernels import (
    batch,
    capacity,
    classfinish,
    commit,
    consolidate,
    existing,
    fill,
    montecarlo,
    objective,
    packbits,
    perturb,
    relax,
    repair,
    reqmerge,
    spread,
)
from karpenter_core_tpu_torch.ops import masks as mask_ops
from karpenter_core_tpu_torch.relax import kernel as relax_kernel
from karpenter_core_tpu_torch.relax import prng as relax_prng
from karpenter_core_tpu_torch.ops import solve as solve_ops
from karpenter_core_tpu_torch.testing import workloads

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


def _class_merge(rng, k, v, bounds, dev):
    """K6's commit's class operands: one class row, its valid words and
    vocabulary, and the per-key bounds flags."""
    valid = mask_ops.pack_mask(torch.as_tensor(rng.random((k, v)) < 0.8).to(dev))
    return reqmerge.ClassMerge(_req(rng, 1, k, v, bounds, dev), valid, _vocab_ints(rng, k, v, dev),
                               v, _khb(k, bounds))


def _khb(k, bounds):
    """The per-key bounds flags: one problem's, shared by its tenants."""
    return tuple(bounds and j % 3 != 1 for j in range(k))


def _equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,types,k,v,bounds,size", [
    (8192, 1000, 8, 9, False, (0.25, 0.25, 1.0)),
    (300, 77, 3, 40, True, (0.25, 0.0, 1.0)),
    (64, 40, 2, 70, True, (0.0, 0.0, 0.0)),  # BIG must saturate to INT32_MAX
    (300, 1001, 3, 40, True, (0.25, 0.0, 1.0)),  # types not a multiple of a lane's four
    (300, 7, 2, 9, True, (0.25, 0.5, 1.0)),  # one group of four and a ragged one
    (200, 77, 2, 9, False, (0.5,)),  # R = 1
    (200, 77, 2, 9, False, tuple(0.25 * (r % 5) for r in range(16))),  # R = 16
    (1, 1000, 8, 9, False, (0.25, 0.25, 1.0)),  # N = 1
    (17, 1000, 8, 9, False, (0.25, 0.25, 1.0)),  # a block's 16 rows + 1
])
def test_it_capacity_matches_plain(card, n, types, k, v, bounds, size):
    rng = np.random.default_rng(n)

    def b(shape, p):
        return torch.as_tensor(rng.random(shape) < p).to(card)

    n_res = len(size)
    khb = tuple(bool(x) for x in rng.random(k) < 0.7) if bounds else (False,) * k
    args = (
        b((n, types), 0.9), b((types,), 0.9), _req(rng, n, k, v, bounds, card),
        _req(rng, types, k, v, bounds, card), _vocab_ints(rng, k, v, card), v, khb,
        b((n, 3), 0.6), b((n, 2), 0.6), b((types, 3, 2), 0.5),
        torch.as_tensor(rng.integers(0, 20, (n, n_res)).astype(np.float32) * 0.25).to(card),
        torch.tensor(size, dtype=torch.float32, device=card),
        torch.as_tensor(rng.integers(0, 64, (types, n_res)).astype(np.float32) * 0.5).to(card),
    )
    _equal(capacity.it_capacity(*args), capacity.it_capacity_plain(*args))


@pytest.mark.parametrize("entry", ["merge_compat", "req_compat"])
@pytest.mark.parametrize("n_b,n,k,v,bounds,offset", [
    (64, 6144, 8, 9, False, False),   # the consolidation lanes' existing rows
    (1, 8192, 8, 9, False, False),    # the headline's slot plane
    (3, 6145, 8, 9, True, False),     # no block divides the rows
    (2, 129, 8, 9, True, True),       # planes one row off 16 bytes: the key-by-key path
    (1, 500, 3, 40, True, False),
    (4, 77, 1, 70, True, False),
    (1, 1, 8, 9, False, False),
])
def test_req_merge_matches_plain(card, entry, n_b, n, k, v, bounds, offset):
    """Both entry points against the twin, tenant by tenant, and each tenant
    solo."""
    sets = []
    for b in range(n_b):
        rng = np.random.default_rng(k * 1000 + n + b)
        node, cls = _req(rng, n + offset, k, v, bounds, card), _req(rng, 1, k, v, bounds, card)
        if offset:
            node = mask_ops.ReqTensor(*(t[1:] for t in node))
        valid = mask_ops.pack_mask(torch.as_tensor(rng.random((k, v)) < 0.8).to(card))
        sets.append((node, cls, valid, _vocab_ints(rng, k, v, card),
                     torch.as_tensor(rng.random(k) < 0.5).to(card), v, _khb(k, bounds)))
    kernel = reqmerge.merge_compat if entry == "merge_compat" else reqmerge.req_compat
    plain = (reqmerge.merge_compat_plain if entry == "merge_compat"
             else reqmerge.req_compat_plain)
    if n_b == 1:
        got, want = kernel(*sets[0]), plain(*sets[0])
        _equal(_leaves_of(got), _leaves_of(want))
    else:
        _check_batched(kernel, plain, sets)


def _fill_case(rng, n, case):
    """(cap, priority) of one K2 case, as numpy int32 planes: random caps and
    few distinct priorities, or a shape the redesigned kernel branches on."""
    cap = rng.integers(0, 5, n).astype(np.int32)
    prio = rng.integers(0, 4, n).astype(np.int32)
    if case in ("ordered", "ordered_but_last"):
        # the existing-node fills' priorities: index order (ties included)
        prio = np.sort(rng.integers(0, n, n)).astype(np.int32)
        if case == "ordered_but_last":
            last = np.flatnonzero(cap)[-1]
            prio[last] = -1  # one kept entry out of order, at the end
    elif case == "equal":
        prio = np.full(n, 7, np.int32)
    elif case == "span":
        prio = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
        prio[:2] = (-2**31, 2**31 - 2)
        cap[:2] = (1, 3)
    elif case == "negative":
        prio = rng.integers(-50, 5, n).astype(np.int32)
        cap = rng.integers(-3, 5, n).astype(np.int32)
    elif case == "zero":
        cap[:] = 0
    elif case == "one":
        cap[:] = 0
        cap[n // 2] = 4
    if case not in ("span", "negative"):
        prio = np.where(cap > 0, prio, 2**31 - 1).astype(np.int32)
    return cap, prio


@pytest.mark.parametrize("n,case", [
    *(pytest.param(n, "", id=str(n)) for n in (1, 1023, 1025, 8192, 16384, 32768, 100003)),
    (16, ""), (1024, ""),  # the lanes' and the churn window's planes
    (8192, "ordered"), (8192, "ordered_but_last"), (8192, "equal"), (8192, "span"),
    (8192, "negative"), (8192, "zero"), (8192, "one"), (40, "ordered_but_last"),
    (1024, "span"), (16, "negative"), (100, ""), (513, "ordered"), (4097, "span"),
])
def test_fill_priority_matches_plain(card, n, case):
    rng = np.random.default_rng(n)
    cap, prio = (torch.as_tensor(a).to(card) for a in _fill_case(rng, n, case))
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


def _intake_args(rng, n, dev, host_ports, volume_limits, zero_request=False):
    def b(shape, p):
        return torch.as_tensor(rng.random(shape) < p).to(dev)

    def i(shape, lo, hi):
        return torch.as_tensor(rng.integers(lo, hi, shape).astype(np.int32)).to(dev)

    alloc = torch.as_tensor((rng.integers(0, 64, (n, 3)) * 0.25).astype(np.float32)).to(dev)
    used = torch.as_tensor((rng.integers(0, 64, (n, 3)) * 0.25).astype(np.float32)).to(dev)
    req = (0.0, 0.0, 0.0) if zero_request else (0.25, 0.0, 1.0)
    vol_limit = torch.where(b((n, 2), 0.5), i((n, 2), 0, 6), torch.tensor(1 << 30, device=dev))
    return (alloc, used, b((n,), 0.9), b((n,), 0.8), b((n,), 0.9), b((n, 3), 0.6),
            b((3,), 0.8), b((n, 2), 0.7), b((2,), 0.9), b((n, 4), 0.2), b((4,), 0.3),
            vol_limit, i((n, 2), 0, 4), i((n, 2), 0, 2), i((2,), 0, 2),
            torch.tensor(req, dtype=torch.float32, device=dev), i((n,), 0, 50),
            host_ports, volume_limits)


@pytest.mark.parametrize("n,host_ports,volume_limits,zero_request", [
    (6144, True, False, False), (6144, True, True, False), (1, True, False, False),
    (1000, False, True, True),  # BIG must saturate to INT32_MAX
])
def test_existing_intake_matches_plain(card, n, host_ports, volume_limits, zero_request):
    args = _intake_args(np.random.default_rng(n), n, card, host_ports, volume_limits,
                        zero_request)
    _equal(existing.existing_intake(*args), existing.existing_intake_plain(*args))


def _mask_args(rng, n, card, extra, single, negative=False):
    cap = np.where(rng.random(n) < 0.3, rng.integers(0, 9, n), 0).astype(np.int32)
    zone = torch.as_tensor(rng.random((n, 3)) < 0.5).to(card)
    extra_elig = torch.as_tensor(rng.random(n) < 0.7).to(card) if extra else None
    if negative:
        cap[rng.integers(0, n, 3)] = -2  # K5 never makes one; the twin takes it
    return (torch.as_tensor(cap).to(card), zone, torch.tensor([True, True, False], device=card),
            torch.tensor([True, False, True], device=card), extra_elig, single)


@pytest.mark.parametrize("n,extra,single,negative", [
    *(pytest.param(n, e, s, False, id=f"{n}-{e}-{s}") for n, e, s in (
        (6144, True, False), (6144, False, True), (5000, True, True), (1, False, False))),
    (6144, False, False, True), (5000, True, False, False), (1, True, True, False),
    (6144, True, True, True), (2049, False, False, False),
])
def test_existing_mask_matches_plain(card, n, extra, single, negative):
    """Both mask entry points: the caps and priorities, and the fused fill
    (assigned, placed, zone_ok) at quotas below, at and past the caps' sum."""
    args = _mask_args(np.random.default_rng(n), n, card, extra, single, negative)
    _equal(existing.existing_mask(*args), existing.existing_mask_plain(*args))
    total = int(args[0].clamp(min=0).sum())
    for quota in (0, total // 2, total, 2**31 - 1):
        q = torch.tensor(quota, dtype=torch.int32, device=card)
        _equal(existing.existing_mask_fill(*args, q), existing.existing_mask_fill_plain(*args, q))


@pytest.mark.parametrize("n,host_ports,volume_limits,sel", [
    *(pytest.param(n, h, v, "", id=f"{n}-{h}-{v}") for n, h, v in (
        (6144, True, True), (6144, True, False), (1, False, False))),
    (6144, True, True, "all"), (6144, False, True, "none"),
    (6144, True, True, "offset"), (777, False, False, "offset"),
])
def test_existing_commit_matches_plain(card, n, host_ports, volume_limits, sel):
    """``sel``: every row selected, none, or (offset) every plane a view one
    row into a larger one, so no plane is 16-byte aligned and the commit
    takes narrower vectors."""
    rng = np.random.default_rng(n + 1)
    k, words = 8, 1
    rows = existing.ExistingState(
        torch.as_tensor((rng.integers(0, 64, (n, 3)) * 0.1).astype(np.float32)).to(card),
        _req(rng, n, k, 9, False, card).mask,
        *(t for t in _req(rng, n, k, 9, True, card)[1:]),
        torch.as_tensor(rng.random((n, 3)) < 0.5).to(card),
        torch.as_tensor(rng.random((n, 2)) < 0.5).to(card),
        torch.as_tensor(rng.random((n, 4)) < 0.2).to(card),
        torch.as_tensor(rng.integers(0, 5, (n, 2)).astype(np.int32)).to(card),
        torch.as_tensor(rng.integers(0, 50, n).astype(np.int32)).to(card),
        torch.as_tensor(rng.random(n) < 0.8).to(card),
    )
    merge = _class_merge(rng, k, 9, True, card)
    assigned = torch.as_tensor(np.where(rng.random(n) < 0.3, rng.integers(1, 7, n), 0)
                               .astype(np.int32)).to(card)
    args = (rows, merge, torch.as_tensor(rng.random((n, 3)) < 0.5).to(card),
            torch.as_tensor(rng.random((n, 2)) < 0.5).to(card),
            torch.as_tensor(rng.random(4) < 0.5).to(card),
            torch.as_tensor(rng.integers(0, 3, (n, 2)).astype(np.int32)).to(card),
            torch.as_tensor(rng.integers(0, 3, 2).astype(np.int32)).to(card),
            torch.tensor((0.1, 0.3, 1.0), dtype=torch.float32, device=card), assigned,
            host_ports, volume_limits)
    assert words == merge.cls.mask.shape[-1]
    if sel in ("all", "none"):
        args = args[:8] + (assigned.clamp(min=1) if sel == "all" else 0 * assigned,) + args[9:]
    elif sel == "offset":
        def shifted(t):
            return torch.cat([t[:1], t])[1:] if t.dim() >= 1 and t.shape[0] == n else t

        args = tuple(batch.tree_map(shifted, a) for a in args)
    _equal(existing.existing_commit(*args), existing.existing_commit_plain(*args))


@pytest.mark.parametrize("seed", range(40))
def test_spread_quota_matches_plain(card, seed):
    rng = np.random.default_rng(seed)
    z = 3 if seed < 30 else int(rng.integers(1, 8))
    unlimited = np.int32(1 << 30)
    caps = np.where(rng.random(z) < 0.5, rng.integers(0, 60, z), unlimited).astype(np.int32)
    args = [
        rng.integers(0, 40, z).astype(np.int32), rng.random(z) < 0.8, rng.random(z) < 0.8, caps,
        np.int32(rng.integers(1, 5) if seed % 5 else unlimited),
        np.int32(rng.integers(0, 300)), np.bool_(seed % 7 != 0),
    ]
    t = [torch.as_tensor(np.asarray(a)).to(card) for a in args]
    _equal(spread.spread_quota(*t), spread.spread_quota_plain(*t))


@pytest.mark.parametrize("n_lanes,n_ex,n_cls,case", [
    pytest.param(64, 6144, 16, "", id="64-6144-16"),  # the full-size sweep's shapes
    pytest.param(1, 6144, 16, "", id="1-6144-16"),   # one lane
    # E not a multiple of the block, C not a power of two
    pytest.param(13, 1000, 9, "", id="13-1000-9"),
    pytest.param(5, 1, 1, "", id="5-1-1"),
    (64, 6144, 16, "tied"),      # several nodes share each rank
    (64, 6144, 33, ""),          # C past one 16-class chunk
    (64, 6144, 16, "same"),      # every lane the same size
    (64, 6144, 16, "wrap"),      # counts near 2^31: the int32 sums wrap
    (512, 6144, 16, ""),         # the crossed grid's R x S lanes
])
def test_sweep_lanes_matches_plain(card, n_lanes, n_ex, n_cls, case):
    rng = np.random.default_rng(n_lanes * 7 + n_ex)
    n_cand = max(n_ex * 4 // 5, 1)
    rank = np.full(n_ex, 1 << 30, np.int32)
    ranks = np.arange(n_cand, dtype=np.int32)
    if case == "tied":
        ranks //= 3
    rank[rng.permutation(n_ex)[:n_cand]] = ranks
    sizes = np.sort(rng.integers(1, n_cand + 1, n_lanes)).astype(np.int32)
    if case == "same":
        sizes[:] = sizes[n_lanes // 2]
    base = rng.integers(0, 500, n_cls).astype(np.int32)
    counts = rng.integers(0, 40, (n_cls, n_ex)).astype(np.int32)
    if case == "wrap":
        base = np.full(n_cls, 2**31 - 7, np.int32)
        counts = rng.integers(2**30, 2**31 - 1, (n_cls, n_ex)).astype(np.int32)
    args = [rank, rng.random(n_ex) < 0.9, base, counts, sizes]
    t = [torch.as_tensor(a).to(card) for a in args]
    _equal(consolidate.sweep_lanes(*t), consolidate.sweep_lanes_plain(*t))


def _finish_args(rng, dev, n_lanes, n_slots, n_it, n_cls, n_ex, closed=False, no_offer=False):
    viable = rng.random((n_lanes, n_slots, n_it)) < 0.3
    if no_offer:
        viable[:, ::2] = False  # every other slot has no viable type: +inf price
    price = (rng.integers(1, 4000, (n_it, 3, 2)) * 0.001).astype(np.float32)
    price[rng.random((n_it, 3, 2)) < 0.2] = np.inf  # unavailable offerings
    open_ = np.zeros((n_lanes, n_slots), bool) if closed else rng.random((n_lanes, n_slots)) < 0.7
    assign = np.where(rng.random((n_lanes, n_cls, n_ex)) < 0.01,
                      rng.integers(1, 4, (n_lanes, n_cls, n_ex)), 0).astype(np.int32)
    init = rng.random(n_ex) < 0.97
    assign[1::2][:, :, ~init] = 0  # odd lanes use no uninitialized node
    args = [viable, rng.random((n_lanes, n_slots, 3)) < 0.7, rng.random((n_lanes, n_slots, 2)) < 0.7,
            open_, rng.integers(0, 3, (n_lanes, n_slots)).astype(np.int32),
            rng.integers(0, 5, (n_lanes, n_cls)).astype(np.int32), assign, init, price]
    return [torch.as_tensor(a).to(dev) for a in args]


@pytest.mark.parametrize("n_lanes,n_slots,n_it,n_cls,n_ex,closed,no_offer", [
    (64, 16, 1000, 16, 6144, False, False),  # the full-size sweep's shapes
    (1, 16, 1000, 16, 6144, False, False),   # one lane
    (7, 16, 77, 9, 1000, False, True),       # E off the block; slots with no offering
    (9, 16, 40, 3, 50, True, False),         # every slot closed
])
def test_lane_finish_matches_plain(card, n_lanes, n_slots, n_it, n_cls, n_ex, closed, no_offer):
    args = _finish_args(np.random.default_rng(n_lanes + n_ex), card, n_lanes, n_slots, n_it,
                        n_cls, n_ex, closed, no_offer)
    got, want = consolidate.lane_finish(*args), consolidate.lane_finish_plain(*args)
    _equal(got, want)
    if closed:
        assert not got[0].any() and not got[1].any()
    if no_offer:
        assert torch.isinf(got[0]).any()
    assert not got[3][1::2].any()


# -- K10-K12: the warm repair's carry programs ----------------------------------


def _free_args(rng, dev, n_new, n_ex, n_cls=16, g1=8):
    """A carry's freed planes with sparse evictions, a slot freed by two
    classes on each side, and inexact requests (so the f32 sum's order
    shows)."""
    free_new = np.where(rng.random((n_cls, n_new)) < 0.02, rng.integers(1, 3, (n_cls, n_new)), 0)
    free_ex = np.where(rng.random((n_cls, n_ex)) < 0.05, rng.integers(1, 3, (n_cls, n_ex)), 0)
    if n_new > 5:
        free_new[2, 5] = free_new[7, 5] = 1  # slot 5 freed by two classes
    if n_ex:
        free_ex[3, 0] = free_ex[11, 0] = 2
    req = (rng.integers(1, 40, (n_cls, 3)) * 0.1).astype(np.float32)
    args = [
        (rng.integers(0, 400, (n_new, 3)) * 0.1).astype(np.float32),
        rng.integers(0, 6, n_new), rng.integers(0, 4, (g1, n_new)), rng.integers(0, 2, (g1, n_new)),
        (rng.integers(0, 400, (n_ex, 3)) * 0.1).astype(np.float32),
        rng.integers(0, 6, n_ex), rng.integers(0, 4, (g1, n_ex)), rng.integers(0, 2, (g1, n_ex)),
        free_new, free_ex, req, rng.integers(0, 2, (n_cls, g1)), rng.integers(0, 2, (n_cls, g1)),
    ]
    return [torch.as_tensor(a if a.dtype == np.float32 else a.astype(np.int32)).to(dev)
            for a in args]


# the headline tick, a wider cluster, a narrow window; then C past one
# 16-class chunk, an empty or one-column side, and a block-edge column count
FREE_SHAPES = [
    pytest.param(8192, 1, 16, id="8192-1"), pytest.param(8192, 1536, 16, id="8192-1536"),
    pytest.param(77, 6144, 16, id="77-6144"), (8192, 1536, 33), (8192, 0, 16), (0, 6144, 16),
    (1, 6144, 16), (1, 1, 33), (8193, 1, 16),
]


@pytest.mark.parametrize("n_new,n_ex,n_cls", FREE_SHAPES)
def test_repair_free_matches_plain(card, n_new, n_ex, n_cls):
    args = _free_args(np.random.default_rng(n_new + n_ex), card, n_new, n_ex, n_cls)
    before = [a.clone() for a in args]
    got, want = repair.repair_free(*args), repair.repair_free_plain(*args)
    _equal(got, want)
    _equal(args, before)  # nothing given is written into
    assert (got[1] >= 0).all() and (got[2] >= 0).all()


@pytest.mark.parametrize("wide", (False, True))
def test_repair_free_dense_full_mantissa_matches_plain(card, wide):
    """Dense evictions (most columns freed by several classes) on
    full-mantissa requests, and requests spanning 2^-20 .. 2^20: the
    kernel's fused class sum equals the twin's bit for bit."""
    rng = np.random.default_rng(11 + wide)
    args = _free_args(rng, card, 8192, 1536)
    req = rng.random((16, 3))
    if wide:
        req = req * np.exp2(rng.integers(-20, 21, (16, 3)))
    args[10] = torch.as_tensor((req * 4).astype(np.float32)).to(card)
    args[8] = torch.as_tensor(rng.integers(0, 8, (16, 8192)).astype(np.int32)).to(card)
    args[9] = torch.as_tensor(rng.integers(0, 8, (16, 1536)).astype(np.int32)).to(card)
    _equal(repair.repair_free(*args), repair.repair_free_plain(*args))


def _rows(rng, dev, n, n_it=1000, k=8, words=1, z=3, ct=2, p=4):
    """Random per-slot planes in ROW_PLANES order (kmask words use bit 31)."""
    b = lambda *shape: rng.random(shape) < 0.5  # noqa: E731
    planes = [
        (rng.integers(0, 64, (n, 3)) * 0.25).astype(np.float32),
        rng.integers(-2**31, 2**31, (n, k, words), dtype=np.int64).astype(np.int32),
        b(n, k), b(n, k), rng.normal(size=(n, k)).astype(np.float32),
        rng.normal(size=(n, k)).astype(np.float32), b(n, z), b(n, ct), b(n, n_it), b(n, p),
        rng.integers(0, 30, n).astype(np.int32), rng.integers(0, 5, n).astype(np.int32),
        rng.random(n) < 0.8,
    ]
    return tuple(torch.as_tensor(a).to(dev) for a in planes)


def _window(n_slots, holes, n_next, window_min):
    from karpenter_core_tpu_torch.solver.incremental import _window_indices

    idx, n_open = _window_indices(holes, n_next, n_slots, window_min)
    return idx, n_open


@pytest.mark.parametrize("n_slots,holes,n_next,window_min", [
    (8192, list(range(3, 7000, 16)), 7162, 256),   # 437 holes: a 512-slot window
    (8192, [17, 4001, 6000], 7162, 256),            # three holes and a fresh tail
    (4096, [5, 9], 4090, 64),                       # filler rows below n_next
    (1000, [0, 998], 999, 16),                      # N off the word; filler and one fresh
])
def test_repair_window_gather_and_scatter_match_plain(card, n_slots, holes, n_next, window_min):
    rng = np.random.default_rng(n_slots + len(holes))
    rows = _rows(rng, card, n_slots, n_it=1000 if n_slots > 1000 else 77, z=3)
    g1 = 8
    fwd = torch.as_tensor(rng.integers(0, 5, (g1, n_slots)).astype(np.int32)).to(card)
    inv = torch.as_tensor(rng.integers(0, 3, (g1, n_slots)).astype(np.int32)).to(card)
    idx_np, n_open = _window(n_slots, holes, n_next, window_min)
    idx = torch.as_tensor(idx_np).to(card)
    before = [t.clone() for t in rows + (fwd, inv)]
    got = repair.gather_window(rows, fwd, inv, idx, n_open)
    want = repair.gather_window_plain(rows, fwd, inv, idx, n_open)
    _equal(got[0], want[0])
    _equal(got[1:4] + got[4], want[1:4] + want[4])
    assert int(got[1]) == n_open
    assert int(want[4][1].sum()) > 0
    # the repair's window state, perturbed, written back
    w_rows = _rows(np.random.default_rng(1), card, len(idx_np), n_it=rows[8].shape[1])
    w_fwd = torch.as_tensor(rng.integers(0, 9, (g1, len(idx_np))).astype(np.int32)).to(card)
    w_inv = torch.as_tensor(rng.integers(0, 9, (g1, len(idx_np))).astype(np.int32)).to(card)
    n_next_t = torch.tensor(n_next, dtype=torch.int32, device=card)
    w_next = torch.tensor(n_open + 5, dtype=torch.int32, device=card)
    args = (rows, fwd, inv, n_next_t, w_rows, w_fwd, w_inv, w_next, idx, n_open)
    got = repair.scatter_window(*args)
    want = repair.scatter_window_plain(*args)
    _equal(got[0], want[0])
    _equal(got[1:], want[1:])
    assert int(got[3]) == n_next + 5
    _equal(rows + (fwd, inv), before)  # the full-width carry stays as it was


# -- K21, K22: K10 and K12 in place on the carry --------------------------------


@pytest.mark.parametrize("n_new,n_ex,n_cls", FREE_SHAPES)
def test_repair_free_inplace_matches_plain(card, n_new, n_ex, n_cls):
    """K21 against its in-place twin, and against K10 on a clone: the
    carry's eight planes freed where they lie, f32 bit for bit."""
    args = _free_args(np.random.default_rng(21 + n_new + n_ex), card, n_new, n_ex, n_cls)
    carry = args[:8]
    twin = [a.clone() for a in carry]
    out_of_place = repair.repair_free(*args)
    got = repair.repair_free(*args, inplace=True)
    assert all(g is c for g, c in zip(got, carry))
    want = repair.repair_free_inplace_plain(*twin, *args[8:])
    _equal(got, want)
    _equal(got, out_of_place)


@pytest.mark.parametrize("n_slots,holes,n_next,window_min", [
    (8192, list(range(3, 7000, 16)), 7162, 256),
    (8192, [17, 4001, 6000], 7162, 256),
    (1000, [0, 998], 999, 16),
])
def test_repair_scatter_inplace_matches_plain(card, n_slots, holes, n_next, window_min):
    """K22 against its in-place twin, and against K12 on a clone: only the
    window's rows, columns and n_next written, into the full carry's own
    planes."""
    rng = np.random.default_rng(22 + n_slots + len(holes))
    rows = _rows(rng, card, n_slots, n_it=1000 if n_slots > 1000 else 77, z=3)
    g1 = 8
    fwd = torch.as_tensor(rng.integers(0, 5, (g1, n_slots)).astype(np.int32)).to(card)
    inv = torch.as_tensor(rng.integers(0, 3, (g1, n_slots)).astype(np.int32)).to(card)
    n_next_t = torch.tensor(n_next, dtype=torch.int32, device=card)
    idx_np, n_open = _window(n_slots, holes, n_next, window_min)
    idx = torch.as_tensor(idx_np).to(card)
    w_rows = _rows(np.random.default_rng(2), card, len(idx_np), n_it=rows[8].shape[1])
    w_fwd = torch.as_tensor(rng.integers(0, 9, (g1, len(idx_np))).astype(np.int32)).to(card)
    w_inv = torch.as_tensor(rng.integers(0, 9, (g1, len(idx_np))).astype(np.int32)).to(card)
    w_next = torch.tensor(n_open + 5, dtype=torch.int32, device=card)
    window = (w_rows, w_fwd, w_inv, w_next, idx, n_open)
    full = rows + (fwd, inv, n_next_t)
    twin = [t.clone() for t in full]
    out_of_place = repair.scatter_window(rows, fwd, inv, n_next_t, *window)
    got = repair.scatter_window(rows, fwd, inv, n_next_t, *window, inplace=True)
    assert all(g is f for g, f in zip(got[0] + got[1:], full))
    want = repair.scatter_window_inplace_plain(tuple(twin[:13]), *twin[13:], *window)
    _equal(got[0], want[0])
    _equal(got[1:], want[1:])
    _equal(got[0], out_of_place[0])
    _equal(got[1:], out_of_place[1:])
    assert int(got[3]) == n_next + 5


# -- K13: the policy objective's offering selection -----------------------------


@pytest.mark.parametrize("n,n_it,n_z,n_ct,knobs", [
    (8192, 1000, 3, 2, (1.0, 0.0, 0.0, True)),                 # the headline's shapes
    (8192, 1000, 3, 2, (0.7310001, 0.3330001, 0.6170001, True)),
    (300, 40, 3, 2, (0.2023, 0.9241, 0.8531, False)),
    (86, 38, 3, 1, (1.0, 0.0, 0.25, True)),
    (250, 24, 1, 2, (1.0, 0.0, 0.0, False)),                   # 0 * inf: a NaN score
    (100003, 7, 2, 2, (3.0, 1.5, 1.0, True)),                  # three sum levels
])
def test_select_offerings_matches_plain(card, n, n_it, n_z, n_ct, knobs):
    case = workloads.objective_case(np.random.default_rng(n + n_it), n, n_it, n_z, n_ct)
    t = {k: torch.as_tensor(v).to(card) for k, v in case.items()}
    args = (t["viable"], t["zone"], t["ct"], t["open_"], t["pod_count"], t["price"], t["risk"],
            t["throughput"], t["is_spot"], objective.Weights(*knobs))
    got, want = objective.select_offerings(*args), objective.select_offerings_plain(*args)
    _equal(got, want)
    assert not bool(got[5][0]) and not bool(got[5][1])  # nothing allowed; a NaN score


# -- K15: device-side class finishing -------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_class_finish_matches_plain(card, seed):
    rng = np.random.default_rng(seed)
    c, k, v, g1, p = (int(rng.integers(1, 20)), int(rng.integers(1, 9)),
                      int(rng.integers(1, 40)), int(rng.integers(2, 12)), int(rng.integers(1, 6)))
    b = lambda *shape: torch.as_tensor(rng.random(shape) < 0.5)  # noqa: E731
    f = lambda *shape: torch.as_tensor(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    i = lambda hi, *shape: torch.as_tensor(rng.integers(-1, hi, shape).astype(np.int32))  # noqa: E731
    cls = solve_ops.ClassTensors(
        mask=b(c, k, v + 1), defined=b(c, k), negative=b(c, k), gt=f(c, k), lt=f(c, k),
        zone=b(c, 3), ct=b(c, 2), it=b(c, 1000), requests=f(c, 3), count=i(50, c),
        tol=b(c, 5), ports=b(c, p), groups=i(g1, c, 6), relax_next=i(c, c), anti_soft=b(c, 2),
        root=i(c, c))
    ext = classfinish.Extents(solve_ops.bucket(c), solve_ops.bucket(k), solve_ops.bucket(v), g1,
                              solve_ops.bucket(g1 - 1, floor=4) + 1,
                              solve_ops.bucket(p, floor=4))
    cls = solve_ops.ClassTensors(*(x.to(card) for x in cls))
    _equal(classfinish.finish_class_planes(cls, ext), classfinish.finish_class_planes_plain(cls, ext))


# -- K14, K16-K18: the relax family -----------------------------------------------


def _relax_inputs(seed, dev, n_c=16, n_t=5, n_it=1000, n_z=3, n_ct=2):
    case = workloads.relax_case(np.random.default_rng(seed), n_c, n_t, n_it, n_z, n_ct)
    t = {k: torch.as_tensor(v).to(dev) for k, v in case.items()}
    planes = relax.RelaxPlanes(*(t[f] for f in relax.RelaxPlanes._fields))
    return t, planes


RELAX_KNOBS = [(1.0, 0.0, 0.0), (0.7310001, 0.6170001, 0.3330001)]


@pytest.mark.parametrize("shape", [(16, 5, 1000, 3, 2), (12, 2, 77, 2, 3), (3, 1, 5, 1, 1)])
@pytest.mark.parametrize("knobs", RELAX_KNOBS)
def test_relax_cost_matches_plain(card, shape, knobs):
    t, planes = _relax_inputs(sum(shape), card, *shape)
    w = torch.tensor(knobs, dtype=torch.float32, device=card)
    args = (planes, t["price"], t["risk"], t["throughput"], w, t["counts"])
    _equal(relax.relax_cost(*args), relax.relax_cost_plain(*args))


def _relax_chain(seed, dev, knobs=(1.0, 0.0, 0.0), **shape):
    t, planes = _relax_inputs(seed, dev, **shape)
    w = torch.tensor(knobs, dtype=torch.float32, device=dev)
    cost, support, tstar, feas, cost_max = relax.relax_cost_plain(
        planes, t["price"], t["risk"], t["throughput"], w, t["counts"])
    return t, planes, cost, support, tstar, feas, cost_max


@pytest.mark.parametrize("max_iters", [64, 1, 0])
@pytest.mark.parametrize("seed", [0, 1])
def test_simplex_pgd_matches_plain(card, seed, max_iters):
    t, _, cost, support, _, _, cost_max = _relax_chain(seed, card)
    args = (cost, support, cost_max, t["counts"], max_iters, 1e-4)
    got, want = relax.simplex_pgd(*args), relax.simplex_pgd_plain(*args)
    _equal(got[1:], want[1:])  # cost_eff, iters, converged
    # the iterate: every row with support, bit for bit
    _equal((got[0],), (want[0],))
    if max_iters == 1:
        assert not bool(got[3])


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("knobs", RELAX_KNOBS)
def test_relax_round_matches_plain(card, seed, knobs):
    t, planes, cost, support, tstar, _, cost_max = _relax_chain(3, card, knobs)
    x, cost_eff, _, _ = relax.simplex_pgd_plain(cost, support, cost_max, t["counts"], 64, 1e-4)
    perm = torch.as_tensor(relax_prng.permutation(seed, cost.shape[1]).copy()).to(card)
    args = (x, cost, cost_eff, support, t["counts"], perm, tstar, planes)
    _equal(relax.relax_round(*args), relax.relax_round_plain(*args))


@pytest.mark.parametrize("n_it,n_z", [(1, 3), (2, 3), (4, 2)])
def test_relax_round_small_catalog_matches_plain(card, n_it, n_z):
    """K17 where the relaxed cost sums at most 8 cells a class (S = I * Z of
    3, 6 and 8) over several rows: one thread's row-major order."""
    t, planes, cost, support, tstar, _, cost_max = _relax_chain(
        11, card, n_c=8, n_t=2, n_it=n_it, n_z=n_z)
    x, cost_eff, _, _ = relax.simplex_pgd_plain(cost, support, cost_max, t["counts"], 64, 1e-4)
    perm = torch.as_tensor(relax_prng.permutation(1, cost.shape[1]).copy()).to(card)
    args = (x, cost, cost_eff, support, t["counts"], perm, tstar, planes)
    assert cost.shape == (8, n_it * n_z)
    _equal(relax.relax_round(*args), relax.relax_round_plain(*args))


@pytest.mark.parametrize("n_slots", [8192, 64, 1])
def test_relax_materialize_matches_plain(card, n_slots):
    t, planes, cost, support, tstar, feas, cost_max = _relax_chain(5, card)
    x, cost_eff, _, _ = relax.simplex_pgd_plain(cost, support, cost_max, t["counts"], 64, 1e-4)
    perm = torch.as_tensor(relax_prng.permutation(0, cost.shape[1]).copy()).to(card)
    n_ok, _, _ = relax.relax_round_plain(x, cost, cost_eff, support, t["counts"], perm, tstar,
                                         planes)
    merged = mask_ops.ReqTensor(t["mask"], t["defined"], t["negative"], t["gt"], t["lt"])
    t_ct = planes.tmpl_ct[None] & planes.cls_ct[:, None]
    kmask0 = mask_ops.const_words("full", 40, card)
    args = (n_ok, tstar, t["per_pod"], t["counts"], merged, t_ct, feas, t["daemon"],
            t["requests"], kmask0, n_slots, 3)
    got, want = relax.relax_materialize(*args), relax.relax_materialize_plain(*args)
    _equal(got.state, want.state)
    _equal((got.assign, got.leftover, got.placed, got.spilled),
           (want.assign, want.leftover, want.placed, want.spilled))
    if n_slots < 8192:
        assert int(got.spilled) > 0


@pytest.mark.parametrize("sizes,n_pods", [(workloads.HEADLINE_SIZES, 2000),
                                          (({"cpu": "500m", "memory": "512Mi"},), 4000)])
def test_relax_solve_matches_plain(card, sizes, n_pods):
    """The relax family through CudaSolver on the card, kernels against
    twins, every SolveOutputs leaf."""
    from karpenter_core_tpu_torch.models.columnar import PodIngest

    outs = []
    for use_kernels in (True, False):
        solver, pods = workloads.relax_fleet(n_pods, 24, sizes, device=card,
                                             use_kernels=use_kernels)
        ingest = PodIngest()
        ingest.add_all(pods)
        solver.solve(ingest)
        assert solver.last_solve_mode == "relax"
        outs.append((solver.last_outputs, solver.last_relax_stats))
    (a, sa), (b, sb) = outs
    assert sa == sb
    for group in ("state", "ex_state", "topo"):
        _equal(tuple(getattr(a, group)), tuple(getattr(b, group)))
    _equal((a.assign, a.assign_existing, a.failed, a.spread_suspect, a.remaining),
           (b.assign, b.assign_existing, b.failed, b.spread_suspect, b.remaining))


# -- the tenant axis (the coalesced multi-tenant solve) -------------------------------
#
# Each batched entry point takes B tenants' operands stacked on a leading axis,
# every tenant's drawn from its own seed (catalogs and class rows included), and
# must equal its twin applied tenant by tenant, and the solo kernel on each
# tenant's slice.

TENANTS = [1, 3, 8]


def _leaves_of(tree):
    out = []
    batch.tree_map(out.append, tree)
    return out


def _check_batched(kernel, plain, arg_sets):
    args = batch.stack(arg_sets)
    got = _leaves_of(kernel(*args))
    want = _leaves_of(batch.stack([plain(*a) for a in arg_sets]))
    solo = _leaves_of(batch.stack([kernel(*a) for a in arg_sets]))
    assert len(got) == len(want) == len(solo)
    for a, b, c in zip(got, want, solo):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b) and torch.equal(a, c)


def _k1_args(rng, card, n, types, k, v, khb, size):
    def b(shape, p):
        return torch.as_tensor(rng.random(shape) < p).to(card)

    return (
        b((n, types), 0.9), b((types,), 0.9), _req(rng, n, k, v, True, card),
        _req(rng, types, k, v, True, card), _vocab_ints(rng, k, v, card), v, khb,
        b((n, 3), 0.6), b((n, 2), 0.6), b((types, 3, 2), 0.5),
        torch.as_tensor(rng.integers(0, 20, (n, 3)).astype(np.float32) * 0.25).to(card),
        torch.tensor(size, dtype=torch.float32, device=card),
        torch.as_tensor(rng.integers(0, 64, (types, 3)).astype(np.float32) * 0.5).to(card),
    )


@pytest.mark.parametrize("n_b", TENANTS)
def test_it_capacity_tenant_axis_matches_plain(card, n_b):
    khb = (True, False, True, False)
    sets = [_k1_args(np.random.default_rng(100 + b), card, 300, 77, 4, 40, khb,
                     (0.25, 0.0 if b % 2 else 0.5, 1.0)) for b in range(n_b)]
    _check_batched(capacity.it_capacity, capacity.it_capacity_plain, sets)


@pytest.mark.parametrize("case", ["inf_bounds", "no_ok_row", "rows_block_plus_one",
                                  "tenants_own_catalogs", "wide_cells", "type_tiles"])
def test_it_capacity_edges_match_plain(card, case):
    """Bounded keys whose bounds are all infinite; rows where no type is ok
    (cap_n 0); 16 tenants of 8,193 rows (16 rows a warp: blocks of 128 rows
    and one more); three tenants whose catalogs differ; more than 32 zone x
    capacity-type cells; a catalog of 9,000 types (three staged tiles)."""
    rng = np.random.default_rng(len(case))
    k, v, n, types = 3, 40, 300, 77
    khb = (True, False, True)
    n_b = {"rows_block_plus_one": 16, "tenants_own_catalogs": 3}.get(case, 1)
    if case == "rows_block_plus_one":
        n = 8193
    if case == "type_tiles":
        n, types = 64, 9000
    sets = []
    for t in range(n_b):
        args = list(_k1_args(rng, card, n, types, k, v, khb, (0.25, 0.5, 1.0)))
        if case == "inf_bounds":
            for req in (args[2], args[3]):
                req.gt.fill_(float("-inf"))
                req.lt.fill_(float("inf"))
            args[6] = (True,) * k
        elif case == "no_ok_row":
            args[0][::7] = False  # every seventh row has no viable type
            args[7][1::7] = False  # and the next no allowed zone
        elif case == "tenants_own_catalogs":
            args[1] = torch.as_tensor(rng.random(types) < 0.3 + 0.3 * t).to(card)
        elif case == "wide_cells":
            z, c = 8, 5
            args[7] = torch.as_tensor(rng.random((n, z)) < 0.4).to(card)
            args[8] = torch.as_tensor(rng.random((n, c)) < 0.4).to(card)
            args[9] = torch.as_tensor(rng.random((types, z, c)) < 0.2).to(card)
        sets.append(tuple(args))
    if len(sets) == 1:
        got = capacity.it_capacity(*sets[0])
        want = capacity.it_capacity_plain(*sets[0])
        _equal(got, want)
        if case == "no_ok_row":
            assert not bool(got[0][::7].any()) and not bool(got[2][::7].any())
    else:
        _check_batched(capacity.it_capacity, capacity.it_capacity_plain, sets)


def test_it_capacity_tenant_axis_headline_shape(card):
    """Eight tenants at the headline's slot and catalog widths."""
    sets = [_k1_args(np.random.default_rng(200 + b), card, 8192, 1000, 8, 9, (False,) * 8,
                     (0.25, 0.25, 1.0)) for b in range(8)]
    _check_batched(capacity.it_capacity, capacity.it_capacity_plain, sets)


@pytest.mark.parametrize("n_b", TENANTS)
def test_req_merge_tenant_axis_matches_plain(card, n_b):
    k, v = 3, 40
    sets = []
    for b in range(n_b):
        rng = np.random.default_rng(300 + b)
        valid = mask_ops.pack_mask(torch.as_tensor(rng.random((k, v)) < 0.8).to(card))
        sets.append((_req(rng, 500, k, v, True, card), _req(rng, 1, k, v, True, card), valid,
                     _vocab_ints(rng, k, v, card), torch.as_tensor(rng.random(k) < 0.5).to(card),
                     v, (True, False, True)))
    _check_batched(reqmerge.merge_compat, reqmerge.merge_compat_plain, sets)


def _fill_args(rng, n, card, quota):
    cap = torch.as_tensor(rng.integers(0, 5, n).astype(np.int32)).to(card)
    prio = torch.as_tensor(rng.integers(0, 4, n).astype(np.int32)).to(card)
    prio = torch.where(cap > 0, prio, 2**31 - 1)
    return torch.tensor(quota, dtype=torch.int32, device=card), cap, prio


@pytest.mark.parametrize("n_b,n", [
    *(pytest.param(n_b, n, id=f"{n}-{n_b}") for n in (1025, 8192) for n_b in TENANTS),
    (147, 8192),  # the what-if study's largest chunk
    (64, 16),     # the consolidation lanes' slots
])
def test_fill_priority_tenant_axis_matches_plain(card, n_b, n):
    sets = [_fill_args(np.random.default_rng(400 + b), n, card, (0, n // 3, 3 * n)[b % 3])
            for b in range(n_b)]
    _check_batched(fill.fill_by_priority, fill.fill_by_priority_plain, sets)


@pytest.mark.parametrize("n_b,n", [(147, 8192), (8, 1024)])
def test_fill_priority_tenant_axis_mixed_cases_matches_plain(card, n_b, n):
    """Tenants of one launch on different paths: in order (no sort), one out
    of order, a wide key range, every cap 0, one kept entry."""
    cases = ("ordered", "ordered_but_last", "span", "zero", "one", "", "negative", "equal")
    sets = []
    for b in range(n_b):
        rng = np.random.default_rng(450 + b)
        cap, prio = _fill_case(rng, n, cases[b % len(cases)])
        sets.append((torch.tensor(int(rng.integers(0, 3 * n)), dtype=torch.int32, device=card),
                     torch.as_tensor(cap).to(card), torch.as_tensor(prio).to(card)))
    _check_batched(fill.fill_by_priority, fill.fill_by_priority_plain, sets)


@pytest.mark.parametrize("n_b,n", [(2, 32768), (3, 100003)])
def test_fill_priority_tenant_axis_multi_block_matches_plain(card, n_b, n):
    """The multi-block path: one sort, a segment a tenant, the tile scan
    restarting at each segment."""
    sets = [_fill_args(np.random.default_rng(500 + b), n, card, (n // 3, 3 * n, 7)[b % 3])
            for b in range(n_b)]
    _check_batched(fill.fill_by_priority, fill.fill_by_priority_plain, sets)


@pytest.mark.parametrize("n_b", TENANTS)
def test_existing_intake_tenant_axis_matches_plain(card, n_b):
    sets = [_intake_args(np.random.default_rng(600 + b), 1000, card, True, True, b == 1)
            for b in range(n_b)]
    _check_batched(existing.existing_intake, existing.existing_intake_plain, sets)


@pytest.mark.parametrize("n_b", TENANTS)
@pytest.mark.parametrize("extra,single", [(True, False), (False, True)])
def test_existing_mask_tenant_axis_matches_plain(card, n_b, extra, single):
    sets = []
    for b in range(n_b):
        rng = np.random.default_rng(700 + b)
        n = 2000
        cap = torch.as_tensor(np.where(rng.random(n) < 0.3, rng.integers(0, 9, n), 0)
                              .astype(np.int32)).to(card)
        sets.append((cap, torch.as_tensor(rng.random((n, 3)) < 0.5).to(card),
                     torch.as_tensor(rng.random(3) < 0.7).to(card),
                     torch.as_tensor(rng.random(3) < 0.7).to(card),
                     torch.as_tensor(rng.random(n) < 0.7).to(card) if extra else None, single))
    _check_batched(existing.existing_mask, existing.existing_mask_plain, sets)


@pytest.mark.parametrize("n_b,n,extra,single,negative", [
    (8, 6144, True, False, False), (64, 6144, False, False, False), (64, 6144, True, False, True),
    (8, 5000, False, True, False), (64, 5000, True, True, True), (8, 1, False, False, False),
    (64, 1, True, True, False),
])
def test_existing_mask_fill_tenant_axis_matches_plain(card, n_b, n, extra, single, negative):
    """K6's fused entry at the lanes' and tenants' B, each tenant its own
    quota (0, within, or past its caps' sum)."""
    sets = []
    for b in range(n_b):
        rng = np.random.default_rng(750 + b)
        args = _mask_args(rng, n, card, extra, single, negative)
        total = int(args[0].clamp(min=0).sum())
        quota = (0, total // 3, total, 2**31 - 1)[b % 4]
        sets.append(args + (torch.tensor(quota, dtype=torch.int32, device=card),))
    _check_batched(existing.existing_mask_fill, existing.existing_mask_fill_plain, sets)


@pytest.mark.parametrize("sel", ["all", "none", "some"])
def test_existing_commit_lanes_matches_plain(card, sel):
    """The commit at the consolidation lanes' B = 64 x E = 6,144, each
    tenant's selected rows merged with its own class row."""
    n_b, n, k = 64, 6144, 8
    rng = np.random.default_rng(880)
    rows = existing.ExistingState(
        torch.as_tensor((rng.integers(0, 64, (n_b, n, 3)) * 0.1).astype(np.float32)).to(card),
        torch.as_tensor(rng.integers(-2**31, 2**31, (n_b, n, k, 1)).astype(np.int32)).to(card),
        *(torch.as_tensor(rng.random((n_b, n, k)) < p).to(card) for p in (0.6, 0.3)),
        *(torch.as_tensor(rng.integers(-3, 12, (n_b, n, k)).astype(np.float32)).to(card)
          for _ in range(2)),
        torch.as_tensor(rng.random((n_b, n, 3)) < 0.5).to(card),
        torch.as_tensor(rng.random((n_b, n, 2)) < 0.5).to(card),
        torch.as_tensor(rng.random((n_b, n, 4)) < 0.2).to(card),
        torch.as_tensor(rng.integers(0, 5, (n_b, n, 2)).astype(np.int32)).to(card),
        torch.as_tensor(rng.integers(0, 50, (n_b, n)).astype(np.int32)).to(card),
        torch.as_tensor(rng.random((n_b, n)) < 0.8).to(card),
    )
    merge = batch.stack([_class_merge(rng, k, 9, True, card) for b in range(n_b)])
    assigned = {"all": rng.integers(1, 7, (n_b, n)), "none": np.zeros((n_b, n), np.int64),
                "some": np.where(rng.random((n_b, n)) < 0.05, rng.integers(1, 7, (n_b, n)), 0)}
    args = (rows, merge, torch.as_tensor(rng.random((n_b, n, 3)) < 0.5).to(card),
            torch.as_tensor(rng.random((n_b, n, 2)) < 0.5).to(card),
            torch.as_tensor(rng.random((n_b, 4)) < 0.5).to(card),
            torch.as_tensor(rng.integers(0, 3, (n_b, n, 2)).astype(np.int32)).to(card),
            torch.as_tensor(rng.integers(0, 3, (n_b, 2)).astype(np.int32)).to(card),
            torch.as_tensor(rng.random((n_b, 3)).astype(np.float32)).to(card),
            torch.as_tensor(assigned[sel].astype(np.int32)).to(card), True, True)
    _equal(tuple(existing.existing_commit(*args)), tuple(existing.existing_commit_twin(*args)))


@pytest.mark.parametrize("n_b", TENANTS)
def test_existing_commit_tenant_axis_matches_plain(card, n_b):
    sets = []
    for b in range(n_b):
        rng = np.random.default_rng(800 + b)
        n, k = 1000, 8
        rows = existing.ExistingState(
            torch.as_tensor((rng.integers(0, 64, (n, 3)) * 0.1).astype(np.float32)).to(card),
            _req(rng, n, k, 9, False, card).mask,
            *(t for t in _req(rng, n, k, 9, True, card)[1:]),
            torch.as_tensor(rng.random((n, 3)) < 0.5).to(card),
            torch.as_tensor(rng.random((n, 2)) < 0.5).to(card),
            torch.as_tensor(rng.random((n, 4)) < 0.2).to(card),
            torch.as_tensor(rng.integers(0, 5, (n, 2)).astype(np.int32)).to(card),
            torch.as_tensor(rng.integers(0, 50, n).astype(np.int32)).to(card),
            torch.as_tensor(rng.random(n) < 0.8).to(card),
        )
        assigned = torch.as_tensor(np.where(rng.random(n) < 0.3, rng.integers(1, 7, n), 0)
                                   .astype(np.int32)).to(card)
        sets.append((rows, _class_merge(rng, k, 9, True, card),
                     torch.as_tensor(rng.random((n, 3)) < 0.5).to(card),
                     torch.as_tensor(rng.random((n, 2)) < 0.5).to(card),
                     torch.as_tensor(rng.random(4) < 0.5).to(card),
                     torch.as_tensor(rng.integers(0, 3, (n, 2)).astype(np.int32)).to(card),
                     torch.as_tensor(rng.integers(0, 3, 2).astype(np.int32)).to(card),
                     torch.as_tensor(rng.random(3).astype(np.float32)).to(card), assigned,
                     True, True))
    _check_batched(existing.existing_commit, existing.existing_commit_plain, sets)


def _quota_args(rng, n_zones, kind):
    """One tenant's K7 operands: ties and BIG (non-allowed) zones, UNLIMITED
    and finite caps; counts small, near 2^24 (the float sums round) or near
    2^31 (the int32 sums wrap)."""
    unlimited = np.int32(1 << 30)
    lo = (0, 2**24 - 8, 2**31 - 60)[kind]
    counts = lo + rng.integers(0, 4 if kind == 0 else 16, n_zones)
    caps = np.where(rng.random(n_zones) < 0.5, rng.integers(0, 40, n_zones), unlimited)
    args = (counts.astype(np.int32), rng.random(n_zones) < 0.8, rng.random(n_zones) < 0.85,
            caps.astype(np.int32), np.int32(rng.choice([1, 2, 5, unlimited])),
            np.int32(rng.choice([0, 3, 17, 100, 2**24 + 3, 2**31 - 1])),
            np.bool_(rng.random() < 0.8))
    return tuple(torch.as_tensor(np.asarray(a)) for a in args)


@pytest.mark.parametrize("n_b", [1, 147])
@pytest.mark.parametrize("n_zones", [1, 2, 3, 5, 8, 16, 32])
def test_spread_quota_zones_matches_plain(card, n_zones, n_b):
    """Every zone count the warp kernel takes a lane each, one launch for
    the batch against the twin tenant by tenant (on CPU copies of the same
    inputs: the twin's many small operations are slow on the card)."""
    rng = np.random.default_rng(1000 * n_zones + n_b)
    sets = [_quota_args(rng, n_zones, b % 3) for b in range(n_b)]
    got = spread.spread_quota(*(t.to(card) for t in batch.stack(sets)))
    want = batch.stack([spread.spread_quota_plain(*a) for a in sets])
    _equal(tuple(t.cpu() for t in got), want)
    if n_b == 1:
        solo = spread.spread_quota(*(t.to(card) for t in sets[0]))
        _equal(tuple(t.cpu() for t in solo), spread.spread_quota_plain(*sets[0]))


@pytest.mark.parametrize("n_b", TENANTS)
def test_spread_quota_tenant_axis_matches_plain(card, n_b):
    sets = []
    for b in range(n_b):
        rng = np.random.default_rng(900 + b)
        unlimited = np.int32(1 << 30)
        caps = np.where(rng.random(3) < 0.5, rng.integers(0, 60, 3), unlimited).astype(np.int32)
        args = [rng.integers(0, 40, 3).astype(np.int32), rng.random(3) < 0.8,
                rng.random(3) < 0.8, caps, np.int32(rng.integers(1, 5) if b % 4 else unlimited),
                np.int32(rng.integers(0, 300)), np.bool_(b % 3 != 2)]
        sets.append(tuple(torch.as_tensor(np.asarray(a)).to(card) for a in args))
    _check_batched(spread.spread_quota, spread.spread_quota_plain, sets)


# -- K19 and K20: the what-if studies -------------------------------------------


@pytest.mark.parametrize("n_rep,n_it,n_ct", [(1024, 1000, 2), (7, 13, 3), (1, 1, 1)])
@pytest.mark.parametrize("seed", [0, 7, 2**32 + 3])
def test_perturb_avail_matches_plain(card, n_rep, n_it, n_ct, seed):
    """Both modes bit for bit: a spot rate (0, 0.3, 1) and a risk plane
    with zeros, ones and a NaN."""
    rng = np.random.default_rng(n_it)
    avail = torch.as_tensor(rng.random((n_it, 3, n_ct)) < 0.8).to(card)
    is_spot = torch.as_tensor(np.arange(n_ct) % 2 == 0).to(card)
    for rate in (0.0, 0.3, 1.0):
        got = perturb.perturb_avail(avail, n_rep, seed, rate=rate, is_spot=is_spot)
        assert torch.equal(got, perturb.perturb_avail_plain(avail, n_rep, seed, rate=rate,
                                                            is_spot=is_spot))
    risk = rng.random((n_it, 3, n_ct)).astype(np.float32)
    risk[rng.random(risk.shape) < 0.2] = 0.0
    risk[rng.random(risk.shape) < 0.2] = 1.0
    risk.flat[0] = np.nan
    risk = torch.as_tensor(risk).to(card)
    assert torch.equal(perturb.perturb_avail(avail, n_rep, seed, risk=risk),
                       perturb.perturb_avail_plain(avail, n_rep, seed, risk=risk))


@pytest.mark.parametrize("n_rep,n_slots,n_it,n_cls", [
    (8, 8192, 1000, 16),  # the headline's slots
    (5, 100, 40, 3),  # windows padded at both ends
    (3, 16, 40, 2),  # one window
    (2, 40000, 7, 1),  # three levels of the tree
    (4, 33, 7, 2),  # two windows, a row shorter than a 16-byte load
    (3, 8193, 1001, 5),  # rows that start at every alignment
])
def test_replica_finish_matches_plain(card, n_rep, n_slots, n_it, n_cls):
    rng = np.random.default_rng(n_slots)

    def t(a):
        return torch.as_tensor(a).to(card)

    price = (rng.integers(1, 5000, (n_it, 3, 2)) * 1.7e-3).astype(np.float32)
    price[rng.random(price.shape) < 0.3] = np.inf
    args = (
        t(rng.integers(-3, 2**20, (n_rep, n_cls, n_slots)).astype(np.int32)),
        t(rng.integers(0, 2**30, (n_rep, n_cls)).astype(np.int32)),  # sums wrap
        t(rng.random((n_rep, n_slots, n_it)) < 0.3), t(rng.random((n_rep, n_slots, 3)) < 0.6),
        t(rng.random((n_rep, n_slots, 2)) < 0.7), t(rng.random((n_rep, n_slots)) < 0.9),
        t(rng.integers(0, 3, (n_rep, n_slots)).astype(np.int32)), t(price),
    )
    _equal(montecarlo.replica_finish(*args), montecarlo.replica_finish_plain(*args))


@pytest.mark.parametrize("case", ["wide_cells", "no_priced_slot", "nan_prices",
                                  "wide_rows"])
def test_replica_finish_edges_match_plain(card, case):
    """40 zone x capacity-type cells (more than one word); a replica with
    no priced slot (all closed or empty); NaN prices (a slot that can reach
    one prices NaN, and its cost drops it); rows wider than the kernel's
    shared buffers (read where the rank walk lands)."""
    rng = np.random.default_rng(len(case))
    n_rep, n_slots, n_it, n_cls, z, c = 4, 700, 60, 3, 3, 2
    if case == "wide_cells":
        z, c = 8, 5
    if case == "wide_rows":
        n_rep, n_slots, n_it = 2, 300, 5000

    def t(a):
        return torch.as_tensor(a).to(card)

    price = (rng.integers(1, 5000, (n_it, z, c)) * 1.7e-3).astype(np.float32)
    price[rng.random(price.shape) < 0.3] = np.inf
    if case == "nan_prices":
        price[rng.random(price.shape) < 0.02] = np.nan
    open_ = rng.random((n_rep, n_slots)) < 0.9
    pods = rng.integers(0, 3, (n_rep, n_slots)).astype(np.int32)
    if case == "no_priced_slot":
        open_[1] = False
        pods[2] = 0
    args = (
        t(rng.integers(-3, 2**20, (n_rep, n_cls, n_slots)).astype(np.int32)),
        t(rng.integers(0, 2**30, (n_rep, n_cls)).astype(np.int32)),
        t(rng.random((n_rep, n_slots, n_it)) < 0.3), t(rng.random((n_rep, n_slots, z)) < 0.6),
        t(rng.random((n_rep, n_slots, c)) < 0.7), t(open_), t(pods), t(price),
    )
    got = montecarlo.replica_finish(*args)
    _equal(got, montecarlo.replica_finish_plain(*args))
    if case == "no_priced_slot":
        assert float(got[3][1]) == 0.0 and float(got[3][2]) == 0.0


@pytest.mark.parametrize("n_pods,n_types", [(700, 50), (50_000, 1000)])
def test_class_planes_with_the_class_axis_match_plain(card, n_pods, n_types):
    """K3 and K1 with the class as their batch axis (the relax family's
    class planes): one launch each, every plane equal to the twins' class
    by class."""
    from karpenter_core_tpu_torch.models.columnar import PodIngest

    solver, pods = workloads.build_inputs(n_pods, n_types, 5, device="cpu")
    ingest = PodIngest()
    ingest.add_all(pods)
    prep = solver.prepare_encoded(solver.encode(ingest))
    on_card = batch.tree_map(lambda t: t.to(card), (prep.cls, prep.statics_arrays))
    planes = {}
    for use in (True, False):
        k1, k3 = capacity.launches, reqmerge.launches
        packed = relax_kernel.packed_statics(*on_card, prep.key_has_bounds, use_kernels=use)
        merged, key_ok, it_int, per_pod = relax_kernel.class_template_planes(*packed)
        planes[use] = (*merged, key_ok, it_int, per_pod)
        launched = (capacity.launches - k1, reqmerge.launches - k3)
        assert launched == ((1, 1) if use else (0, 0))
    _equal(planes[True], planes[False])


# -- K23: the slot commit --------------------------------------------------------


def _slot_commit_case(rng, dev, n_b, n, n_types, site, host_ports, skip, t=5, k=8, v=9, z=3,
                      ct=2, p=4, r=3):
    """A random slot state [B, N, ...] and the sources of one commit: open
    rows that took pods below each tenant's n_next, a run of fresh rows from
    random templates past it (one of them given no pods), K1 planes with
    caps around the pod counts, one zone set (a phase) or Z with a zone
    index a row (the committal block), and with ``skip`` some tenants off
    (every row of theirs kept, as ``commit.keep_skipped`` gives them)."""
    def b(*shape, p_=0.5):
        return torch.as_tensor(rng.random(shape) < p_).to(dev)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(dev)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    def req(rows):
        return mask_ops.ReqTensor(*(x.reshape((n_b, rows) + x.shape[1:])
                                    for x in _req(rng, n_b * rows, k, v, True, dev)))

    node = req(n)
    state = solve_ops.NodeState(
        f32(rng.integers(0, 64, (n_b, n, r)) * 0.1), node.mask, node.defined, node.negative,
        node.gt, node.lt, b(n_b, n, z), b(n_b, n, ct), b(n_b, n, n_types), b(n_b, n, p, p_=0.2),
        i32(rng.integers(0, 30, (n_b, n))), i32(rng.integers(0, t, (n_b, n))),
        b(n_b, n, p_=0.6), i32(np.zeros(n_b)))
    a = np.where(rng.random((n_b, n)) < 0.3, rng.integers(1, 7, (n_b, n)), 0)
    fresh_t = np.full((n_b, n), -1)
    for bi in range(n_b):
        start = int(rng.integers(0, n))
        stop = min(n, start + int(rng.integers(1, max(2, n // 4))))
        fresh_t[bi, start:stop] = rng.integers(0, t, stop - start)
        a[bi, start:stop] = rng.integers(1, 9, stop - start)
        a[bi, start] = 0  # a fresh row given no pods
    n_vz = 1 if site == "phase" else z
    src = commit.SlotSource(
        i32(a), i32(fresh_t), i32(rng.integers(0, z, (n_b, n))) if site == "committal" else None,
        req(n), req(t), b(n_b, n, z) if site == "phase" else None,
        b(n_b, t, z) if site == "phase" else None, b(n_b, n, ct), b(n_b, t, ct),
        tuple(b(n_b, n, n_types, p_=0.7) for _ in range(n_vz)),
        tuple(i32(rng.integers(-1, 9, (n_b, n, n_types))) for _ in range(n_vz)),
        tuple(b(n_b, t, n_types, p_=0.7) for _ in range(n_vz)),
        tuple(i32(rng.integers(-1, 9, (n_b, t, n_types))) for _ in range(n_vz)))
    on = b(n_b, p_=0.5) if skip else None
    if skip:
        on[0], on[-1] = True, False
    return (state, commit.keep_skipped(src, on), b(n_b, p, p_=0.4),
            f32((rng.integers(1, 20, (n_b, r)) * 0.1)), f32(rng.integers(1, 20, (n_b, t, r)) * 0.1),
            host_ports)


def _misaligned(x):
    """A copy of ``x`` one element into a larger buffer: contiguous, on no
    16-byte boundary."""
    buf = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    view = buf[1:1 + x.numel()].view(x.shape)
    view.copy_(x)
    return view


def _commit_on_clone(state, *rest, copy=torch.clone):
    """K23 on a copy of ``state`` (it commits in place; ``copy`` makes each
    plane's), checked to return the copy's own planes; returns (the copy's
    planes, the copy)."""
    work = batch.tree_map(copy, state)
    before = commit.launches
    got = commit.slot_commit(work, *rest)
    assert commit.launches == before + 1
    assert all(g is w for g, w in zip(got, work))
    return got, work


def _bits(x):
    """``x`` with float planes as their int32 bits (exact comparison)."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("site", ["phase", "committal"])
@pytest.mark.parametrize("n_b,n,n_types,host_ports,skip", [
    (1, 8192, 1000, True, False),     # the cold path's shape; I off the 16-byte vector
    (1, 8192, 1000, False, False),
    (8, 1024, 1000, True, False),     # eight tenants
    (8, 1024, 1024, False, False),    # I a multiple of 16
    (24, 512, 1000, True, True),      # a replica chunk, some replicas skipped
    (24, 512, 1000, False, True),
    (3, 77, 13, True, True),          # rows narrower than one vector
])
def test_slot_commit_matches_plain(card, site, n_b, n, n_types, host_ports, skip):
    rng = np.random.default_rng(n_b * 1000 + n + n_types + host_ports + 7 * skip)
    args = _slot_commit_case(rng, card, n_b, n, n_types, site, host_ports, skip)
    state = args[0]
    got, work = _commit_on_clone(*args)
    want = commit.slot_commit_twin(*args)
    _equal(got, want)
    if not host_ports:  # the ports plane handed back as it is, by both
        assert got[9] is work.ports and want[9] is state.ports
    fresh = args[1].fresh_t >= 0
    assert bool(fresh.any()) and bool(((args[1].a > 0) & ~fresh).any())
    if skip:  # the last tenant is off: every plane of its rows is its input
        for new, old in zip(got, state):
            assert torch.equal(_bits(new[-1]), _bits(old[-1]))


@pytest.mark.parametrize("site", ["phase", "committal"])
def test_slot_commit_misaligned_planes_match_plain(card, site):
    """Every plane on no 16-byte boundary: the viable rows go byte by byte."""
    rng = np.random.default_rng(23)
    state, src, *rest = _slot_commit_case(rng, card, 2, 700, 1000, site, True, False)
    state, src, rest = batch.tree_map(_misaligned, (state, src, tuple(rest)))
    got, _ = _commit_on_clone(state, src, *rest, copy=_misaligned)
    _equal(got, commit.slot_commit_twin(state, src, *rest))


@pytest.mark.parametrize("site", ["phase", "committal"])
@pytest.mark.parametrize("host_ports", [False, True])
def test_slot_commit_of_kept_rows_leaves_every_byte(card, site, host_ports):
    """A commit whose every row is kept (no pods, no template) writes
    nothing: every byte of every plane is as it was."""
    rng = np.random.default_rng(31 + host_ports)
    state, src, *rest = _slot_commit_case(rng, card, 24, 512, 1000, site, host_ports, False)
    src = src._replace(a=torch.zeros_like(src.a), fresh_t=torch.full_like(src.fresh_t, -1))
    got, _ = _commit_on_clone(state, src, *rest)
    for new, old in zip(got, state):
        assert torch.equal(_bits(new), _bits(old))
    _equal(got, commit.slot_commit_twin(state, src, *rest))


@pytest.mark.parametrize("site", ["phase", "committal"])
@pytest.mark.parametrize("n_types", [1000, 700])
@pytest.mark.parametrize("start,length", [(0, 1), (1, 1), (0, 33), (1, 33), (2, 33), (3, 33),
                                          (5, 200)])
def test_slot_commit_fresh_runs_match_plain(card, site, n_types, start, length):
    """Runs of fresh rows as ``_phase`` opens them (one template and pod
    count, the last row with the rest; one zone in the committal block),
    starting at each 16-byte phase a row of I = 1,000 or 700 bytes takes,
    one row long to past a tile, beside open and kept rows."""
    rng = np.random.default_rng(start * 1000 + length + n_types)
    n_b, n = 3, 300
    state, src, *rest = _slot_commit_case(rng, card, n_b, n, n_types, site, True, False)
    a = src.a.clone()  # the rows outside the runs open (a > 0) or kept
    fresh_t = torch.full_like(src.fresh_t, -1)
    for bi in range(n_b):
        s = start + 7 * bi
        fresh_t[bi, s:s + length] = bi % 5
        a[bi, s:s + length] = 3 + bi
        a[bi, s + length - 1] = 1 + bi % 3  # the last row takes the rest
    src = src._replace(a=a, fresh_t=fresh_t)
    if site == "committal":
        zone_idx = src.zone_idx.clone()
        zone_idx[fresh_t >= 0] = 1
        src = src._replace(zone_idx=zone_idx)
    got, _ = _commit_on_clone(state, src, *rest)
    _equal(got, commit.slot_commit_twin(state, src, *rest))
