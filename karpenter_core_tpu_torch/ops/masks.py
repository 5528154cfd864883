"""Requirement-set algebra on bit-packed masks, in torch.

The port of ``karpenter_core_tpu/ops/masks.py`` (packed layout only — the
layout the production solve runs).  A requirement over key k is a set of
``V+1`` slots: the V vocabulary values plus a trailing "unseen values" slot
that carries the complement bit.  Slots are packed into 32-bit words, bit j
of word w being slot ``w*32+j``.

Words are stored as **int32**, never uint32: torch's CPU uint32 has no shift
operators, and int32 shares the bit pattern.  Bit 31 is then the sign bit, so
every single-bit test here is an ``&`` against the int32 value of that bit
(``bit(31) == -2**31``) — never an arithmetic ``>>``, which would smear the
sign into the bits above.  Torch has no popcount; ``popcount`` below is the
SWAR form, whose masks drop the bits an arithmetic shift drags in.

Gt/Lt bounds ride as separate ±inf float planes; ``vocab_ints`` is f32[K, V],
each key's vocabulary values as numbers (+inf where non-numeric).

All functions broadcast over leading batch axes.  ``v`` — the semantic slot
count V+1 — is required, because a word plane cannot recover it.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

WORD = 32  # bits per packed mask word
INT32_MIN = -(1 << 31)


def bit(j: int) -> int:
    """The int32 value whose only set bit is bit ``j`` (0 <= j < 32)."""
    return (1 << j) if j < WORD - 1 else INT32_MIN


def words_for(v: int) -> int:
    """Packed words needed for ``v`` slots."""
    return -(-int(v) // WORD)


class ReqTensor(NamedTuple):
    """A batch of requirement sets in packed-mask form.

    mask:     int32[..., K, W]  allowed slots per key (undefined keys = all
                                ones), bit-packed (``pack_mask``)
    defined:  bool[..., K]      key explicitly present
    negative: bool[..., K]      operator is NotIn or DoesNotExist
    gt:       f32[..., K]       exclusive lower bound (-inf when absent)
    lt:       f32[..., K]       exclusive upper bound (+inf when absent)
    """

    mask: torch.Tensor
    defined: torch.Tensor
    negative: torch.Tensor
    gt: torch.Tensor
    lt: torch.Tensor


_BIT_WEIGHTS: Dict[torch.device, torch.Tensor] = {}


def _bit_weights(device: torch.device) -> torch.Tensor:
    w = _BIT_WEIGHTS.get(device)
    if w is None:
        w = torch.tensor([bit(j) for j in range(WORD)], dtype=torch.int32, device=device)
        _BIT_WEIGHTS[device] = w
    return w


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """int32[..., W] packing of bool[..., M]: bit j of word w is slot
    ``w*32+j``; pad bits beyond M are zero.  The words are sums of distinct
    bit values, which never overflow int32 in any order (the one negative
    weight is bit 31), so the sum is the OR."""
    m = mask.shape[-1]
    pad = (-m) % WORD
    if pad:
        mask = torch.cat(
            [mask, torch.zeros(mask.shape[:-1] + (pad,), dtype=torch.bool, device=mask.device)],
            dim=-1,
        )
    grouped = mask.reshape(mask.shape[:-1] + (-1, WORD)).to(torch.int32)
    return (grouped * _bit_weights(mask.device)).sum(dim=-1, dtype=torch.int32)


def unpack_mask(words: torch.Tensor, m: int) -> torch.Tensor:
    """bool[..., m] inverse of pack_mask."""
    bits = (words[..., None] & _bit_weights(words.device)) != 0
    flat = bits.reshape(bits.shape[:-2] + (-1,))
    return flat[..., :m]


@functools.lru_cache(maxsize=64)
def full_words(v: int) -> np.ndarray:
    """int32[W] constant with bits 0..v-1 set (all semantic slots)."""
    bits = np.ones(v, dtype=bool)
    bits = np.pad(bits, (0, (-v) % WORD))
    weights = (np.uint32(1) << np.arange(WORD, dtype=np.uint32)).astype(np.uint32)
    words = (bits.reshape(-1, WORD) * weights).sum(axis=-1).astype(np.uint32)
    return words.view(np.int32)


@functools.lru_cache(maxsize=64)
def vocab_words(v: int) -> np.ndarray:
    """int32[W] constant selecting the V in-vocabulary slots (drops the
    trailing "unseen" slot v-1)."""
    w = full_words(v).view(np.uint32).copy()
    w[(v - 1) // WORD] &= ~np.uint32(1 << ((v - 1) % WORD))
    return w.view(np.int32)


_CONSTS: Dict[Tuple[str, int, torch.device], torch.Tensor] = {}


def const_words(kind: str, v: int, device: torch.device) -> torch.Tensor:
    """``full_words``/``vocab_words`` as a device tensor, cached per device so
    the solve loop never re-uploads them."""
    key = (kind, int(v), torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        src = full_words(v) if kind == "full" else vocab_words(v)
        t = torch.as_tensor(np.array(src), device=device)
        _CONSTS[key] = t
    return t


def other_bit(words: torch.Tensor, v: int) -> torch.Tensor:
    """bool[...]: the trailing "unseen values" slot of a packed mask."""
    return (words[..., (v - 1) // WORD] & bit((v - 1) % WORD)) != 0


def popcount(words: torch.Tensor) -> torch.Tensor:
    """int32 per-word set-bit count (SWAR).  Each mask excludes the top bits
    an arithmetic right shift fills with the sign, and the final multiply
    wraps mod 2**32 exactly as the unsigned form does."""
    x = words - ((words >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


def pack_req(t: ReqTensor) -> ReqTensor:
    """Bit-pack a bool-layout ReqTensor's mask plane (no-op when packed)."""
    if t.mask.dtype == torch.int32:
        return t
    return t._replace(mask=pack_mask(t.mask))


def _unseen_range_overlap(
    gt: torch.Tensor, lt: torch.Tensor, vocab_ints: Optional[torch.Tensor]
) -> torch.Tensor:
    """bool[..., K]: the combined (gt, lt) range admits some integer value
    outside the vocabulary (requirement.go:227-243 withinIntPtrs).  Infinite
    bounds give an infinite range."""
    n_range = torch.clamp(torch.ceil(lt) - torch.floor(gt) - 1.0, min=0.0)
    if vocab_ints is None:
        n_vocab_in_range = torch.zeros_like(gt)
    else:
        inside = (vocab_ints > gt[..., None]) & (vocab_ints < lt[..., None])
        n_vocab_in_range = inside.to(torch.float32).sum(dim=-1)
    return n_range - n_vocab_in_range >= 1.0


def _unseen_overlap(
    a: ReqTensor, b: ReqTensor, vocab_ints: Optional[torch.Tensor], v: int
) -> torch.Tensor:
    """bool[..., K]: both sides admit some value OUTSIDE the vocabulary."""
    both_other = other_bit(a.mask, v) & other_bit(b.mask, v)
    gt = torch.maximum(a.gt, b.gt)
    lt = torch.minimum(a.lt, b.lt)
    return both_other & _unseen_range_overlap(gt, lt, vocab_ints)


def nonempty_intersection(
    a: ReqTensor, b: ReqTensor, vocab_ints: Optional[torch.Tensor], v: int
) -> torch.Tensor:
    """bool[..., K]: per-key Intersection(a, b).Len() > 0."""
    vw = const_words("vocab", v, a.mask.device)
    vocab_overlap = ((a.mask & b.mask & vw) != 0).any(dim=-1)
    return vocab_overlap | _unseen_overlap(a, b, vocab_ints, v)


def derive_negative(
    mask: torch.Tensor,
    gt: torch.Tensor,
    lt: torch.Tensor,
    valid: torch.Tensor,
    vocab_ints: Optional[torch.Tensor],
    v: int,
    key_has_bounds=None,
) -> torch.Tensor:
    """bool[..., K]: operator ∈ {NotIn, DoesNotExist} for a packed set.

    A complement is NotIn iff its exclusion list is non-empty, where bounds
    drop out-of-range values from that list (requirement.go:139-143, 186-197);
    a concrete empty set is DoesNotExist.  The bounds correction unpacks the
    exclusion words, and is skipped when ``key_has_bounds`` (static per-key
    tuple) says no key carries Gt/Lt anywhere in the problem."""
    vw = const_words("vocab", v, mask.device)
    excl_words = valid & ~mask & vw
    exclusions = (excl_words != 0).any(dim=-1)
    needs_bounds = vocab_ints is not None and (
        key_has_bounds is None or any(key_has_bounds)
    )
    if needs_bounds:
        bounds_set = torch.isfinite(gt) | torch.isfinite(lt)
        in_range = (vocab_ints > gt[..., None]) & (vocab_ints < lt[..., None])
        excl_bits = unpack_mask(excl_words, v)[..., : v - 1]
        excl_bounded = (excl_bits & in_range).any(dim=-1)
        exclusions = torch.where(bounds_set, excl_bounded, exclusions)
    empty = ~(mask != 0).any(dim=-1)
    return (other_bit(mask, v) & exclusions) | empty


def intersection(
    a: ReqTensor,
    b: ReqTensor,
    valid: Optional[torch.Tensor] = None,
    vocab_ints: Optional[torch.Tensor] = None,
    v: Optional[int] = None,
    key_has_bounds=None,
) -> ReqTensor:
    """Key-wise intersection (requirement.go:117-150 under the mask
    encoding): words AND, defined OR, bounds max/min, negativity re-derived
    from the result when ``valid`` is given."""
    mask = a.mask & b.mask
    defined = a.defined | b.defined
    gt = torch.maximum(a.gt, b.gt)
    lt = torch.minimum(a.lt, b.lt)
    if valid is not None:
        negative = derive_negative(mask, gt, lt, valid, vocab_ints, v, key_has_bounds)
    else:
        empty = ~(mask != 0).any(dim=-1)
        negative = (a.negative & b.negative) | empty
    return ReqTensor(mask, defined, negative, gt, lt)


def intersects(
    a: ReqTensor, b: ReqTensor, vocab_ints: Optional[torch.Tensor], v: int
) -> torch.Tensor:
    """bool[...]: requirements.go:189-206 Intersects == nil — only keys
    defined on both sides are checked; an empty intersection is forgiven when
    both operators are negative."""
    checked = a.defined & b.defined
    nonempty = nonempty_intersection(a, b, vocab_ints, v)
    both_negative = a.negative & b.negative
    return (~checked | nonempty | both_negative).all(dim=-1)


def compatible(
    a: ReqTensor,
    b: ReqTensor,
    is_custom: torch.Tensor,
    vocab_ints: Optional[torch.Tensor] = None,
    v: Optional[int] = None,
) -> torch.Tensor:
    """bool[...]: requirements.go:123-133 Compatible == nil, a = node side,
    b = incoming (pod) side: Intersects plus the custom-label rule (a custom
    key required positively by ``b`` must be defined on ``a``)."""
    denied = is_custom & b.defined & ~b.negative & ~a.defined
    return intersects(a, b, vocab_ints, v) & ~denied.any(dim=-1)


def add(
    a: ReqTensor,
    b: ReqTensor,
    valid: Optional[torch.Tensor] = None,
    vocab_ints: Optional[torch.Tensor] = None,
    v: Optional[int] = None,
    key_has_bounds=None,
) -> ReqTensor:
    """Requirements.Add: a tightened by b (requirements.go:87-94)."""
    return intersection(a, b, valid, vocab_ints, v, key_has_bounds)


def count_allowed(a: ReqTensor, valid: torch.Tensor, v: int) -> torch.Tensor:
    """int32[..., K]: number of in-vocabulary values allowed per key (the
    "other" slot excluded)."""
    vw = const_words("vocab", v, a.mask.device)
    return popcount(a.mask & valid & vw).sum(dim=-1, dtype=torch.int32)
