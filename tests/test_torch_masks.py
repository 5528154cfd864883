"""The port's packed mask algebra (karpenter_core_tpu_torch/ops/masks.py) and
the plain twins of the requirement-merge (K3) and bit-pack (K4) kernels,
held against the JAX package's functions on the same numpy inputs.

Tolerance: none.  Words, bools and counts must be equal exactly; the words
are compared as int32 bit patterns (the reference stores uint32).  The JAX
side runs under one ``jax.jit`` per case so each case costs one compile.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_history

from karpenter_core_tpu.ops import masks as jmasks
from karpenter_core_tpu.ops import solve as jsolve
from karpenter_core_tpu_torch.kernels import packbits, reqmerge
from karpenter_core_tpu_torch.ops import masks as tmasks

# both packages' slot and feature histories start empty for this module and
# are put back after it (tests/torch_history.py)
isolated_history = torch_history.isolated_history


# v = V+1 slots: one word, a word ending on bit 31, just past it, two words
WIDTHS = (5, 32, 33, 70)


def _random_req(rng, batch, k, v, bounds):
    mask = rng.random((batch, k, v)) < 0.5
    defined = rng.random((batch, k)) < 0.7
    negative = rng.random((batch, k)) < 0.3
    gt = np.full((batch, k), -np.inf, np.float32)
    lt = np.full((batch, k), np.inf, np.float32)
    if bounds:
        gt = np.where(rng.random((batch, k)) < 0.4, rng.integers(-2, 6, (batch, k)), gt)
        lt = np.where(rng.random((batch, k)) < 0.4, rng.integers(2, 12, (batch, k)), lt)
    return mask, defined, negative, gt.astype(np.float32), lt.astype(np.float32)


def _case(seed, v, bounds=True, batch=24, k=3):
    rng = np.random.default_rng(seed)
    a = _random_req(rng, batch, k, v, bounds)
    b = _random_req(rng, 1, k, v, bounds)
    valid = rng.random((k, v)) < 0.8
    vocab_ints = np.where(
        rng.random((k, v - 1)) < 0.7, rng.integers(0, 10, (k, v - 1)), np.inf
    ).astype(np.float32)
    is_custom = rng.random(k) < 0.5
    return a, b, valid, vocab_ints, is_custom


@functools.partial(jax.jit, static_argnames=("v", "khb"))
def _jax_ops(a, b, valid, vocab_ints, is_custom, v, khb):
    pa = jmasks.ReqTensor(jmasks.pack_mask(a[0]), *a[1:])
    pb = jmasks.ReqTensor(jmasks.pack_mask(b[0]), *b[1:])
    pvalid = jmasks.pack_mask(valid)
    merged = jmasks.add(pa, pb, pvalid, vocab_ints, v=v, key_has_bounds=khb)
    inter_nv = jmasks.intersection(pa, pb, v=v)
    return dict(
        words=pa.mask,
        other=jmasks.other_bit(pa.mask, v),
        unpacked=jmasks.unpack_mask(pa.mask, v),
        negative=jmasks.derive_negative(pa.mask, pa.gt, pa.lt, pvalid, vocab_ints, v, khb),
        merged_mask=merged.mask, merged_defined=merged.defined,
        merged_negative=merged.negative, merged_gt=merged.gt, merged_lt=merged.lt,
        inter_nv_negative=inter_nv.negative,
        nonempty=jmasks.nonempty_intersection(pa, pb, vocab_ints, v=v),
        intersects=jmasks.intersects(pa, pb, vocab_ints, v=v),
        compatible=jmasks.compatible(pa, pb, is_custom, vocab_ints, v=v),
        count_allowed=jmasks.count_allowed(pa, pvalid, v=v),
    )


def _torch_ops(a, b, valid, vocab_ints, is_custom, v, khb):
    t = torch.as_tensor
    pa = tmasks.ReqTensor(tmasks.pack_mask(t(a[0])), *(t(x) for x in a[1:]))
    pb = tmasks.ReqTensor(tmasks.pack_mask(t(b[0])), *(t(x) for x in b[1:]))
    pvalid = tmasks.pack_mask(t(valid))
    vi, custom = t(vocab_ints), t(is_custom)
    merged = tmasks.add(pa, pb, pvalid, vi, v=v, key_has_bounds=khb)
    inter_nv = tmasks.intersection(pa, pb, v=v)
    return dict(
        words=pa.mask,
        other=tmasks.other_bit(pa.mask, v),
        unpacked=tmasks.unpack_mask(pa.mask, v),
        negative=tmasks.derive_negative(pa.mask, pa.gt, pa.lt, pvalid, vi, v, khb),
        merged_mask=merged.mask, merged_defined=merged.defined,
        merged_negative=merged.negative, merged_gt=merged.gt, merged_lt=merged.lt,
        inter_nv_negative=inter_nv.negative,
        nonempty=tmasks.nonempty_intersection(pa, pb, vi, v=v),
        intersects=tmasks.intersects(pa, pb, vi, v=v),
        compatible=tmasks.compatible(pa, pb, custom, vi, v=v),
        count_allowed=tmasks.count_allowed(pa, pvalid, v=v),
    )


def _as_np(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.uint32 else x


@pytest.mark.parametrize("bounds", [True, False])
@pytest.mark.parametrize("v", WIDTHS)
def test_mask_ops_match_reference(v, bounds):
    a, b, valid, vocab_ints, is_custom = _case(100 + v, v, bounds)
    khb = (True, False, True) if bounds else (False, False, False)
    ref = _jax_ops(a, b, valid, vocab_ints, is_custom, v=v, khb=khb)
    got = _torch_ops(a, b, valid, vocab_ints, is_custom, v=v, khb=khb)
    for name in ref:
        r, g = _as_np(ref[name]), got[name].numpy()
        assert r.dtype == g.dtype, name
        np.testing.assert_array_equal(r, g, err_msg=name)


@pytest.mark.parametrize("v", WIDTHS)
def test_constant_words_match_reference(v):
    np.testing.assert_array_equal(jmasks.full_words(v).view(np.int32), tmasks.full_words(v))
    np.testing.assert_array_equal(jmasks.vocab_words(v).view(np.int32), tmasks.vocab_words(v))
    assert tmasks.words_for(v) == jmasks.words_for(v)


def test_popcount_counts_the_sign_bit():
    words = torch.tensor([0, 1, -1, -(2**31), 2**31 - 1, 0x55555555, -0x55555556], dtype=torch.int32)
    want = [bin(int(w) & 0xFFFFFFFF).count("1") for w in words.tolist()]
    assert tmasks.popcount(words).tolist() == want


@pytest.mark.parametrize("entry", ["merge_compat", "req_compat"])
@pytest.mark.parametrize("bounds", [True, False])
@pytest.mark.parametrize("v", (5, 33))
def test_merge_compat_plain_matches_reference(v, bounds, entry):
    """K3's plain twin against the reference's _merge_node_class /
    _key_compat_node_class pair (ops/masks.py add + compatible); the compat
    entry point's twin against ``compatible`` alone."""
    a, b, valid, vocab_ints, is_custom = _case(7 + v, v, bounds)
    khb = (True, True, False) if bounds else (False, False, False)
    ref = _jax_ops(a, b, valid, vocab_ints, is_custom, v=v, khb=khb)
    t = torch.as_tensor
    node = tmasks.ReqTensor(tmasks.pack_mask(t(a[0])), *(t(x) for x in a[1:]))
    cls = tmasks.ReqTensor(tmasks.pack_mask(t(b[0])), *(t(x) for x in b[1:]))
    args = (node, cls, tmasks.pack_mask(t(valid)), t(vocab_ints), t(is_custom), v, khb)
    if entry == "req_compat":
        compat = reqmerge.req_compat(*args)
        assert compat.dtype == torch.bool and compat.shape == node.defined.shape[:-1]
    else:
        merged, compat = reqmerge.merge_compat(*args)
        for name, g in zip(("merged_mask", "merged_defined", "merged_negative", "merged_gt",
                            "merged_lt"), merged):
            np.testing.assert_array_equal(_as_np(ref[name]), g.numpy(), err_msg=name)
    np.testing.assert_array_equal(_as_np(ref["compatible"]), compat.numpy())


@pytest.mark.parametrize("m", (1, 3, 8, 13, 1000))
def test_pack_bool_plain_matches_reference(m):
    """K4's plain twin against the reference's pack_bool, and the unpack."""
    bits = np.random.default_rng(m).random((5, m)) < 0.5
    ref = np.asarray(jsolve.pack_bool(jnp.asarray(bits)))
    got = packbits.pack_bool(torch.as_tensor(bits)).numpy()
    np.testing.assert_array_equal(ref, got)
    np.testing.assert_array_equal(packbits.unpack_bool(got, m), bits)
