"""K1: instance-type viability and capacity per node slot.

``it_capacity`` returns ``(it_ok bool[N, I], cap_ni i32[N, I], cap_n i32[N])``
for one pod class against N slot rows (node slots or templates):

    it_ok  = viable & cls_it & Intersects(merged, it) & hasOffering
    cap_ni = where(it_ok, min_r floor((alloc - used + 1e-4) / size_r), 0)
    cap_n  = max_i cap_ni

It replaces the jnp program that ``karpenter_core_tpu/ops/solve.py`` builds
from ``_it_intersects`` (:334), ``_offering_ok`` (:402) and ``_capacity``
(:386) at every placement phase.  The plain torch pieces below are the CPU
path and the kernel's oracle on the card.  The CUDA source is
``csrc/it_capacity.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from karpenter_core_tpu_torch.kernels import batch, build
from karpenter_core_tpu_torch.models import snapshot
from karpenter_core_tpu_torch.ops import masks as mask_ops

# the constants every kernel module and ops/solve.py share
BIG = 1e30  # ops/solve.py's BIG, an f32 1e30 once it meets an f32 tensor
INT32_MAX = 2**31 - 1
UNLIMITED = int(snapshot.UNLIMITED)  # 1 << 30: no cap

launches = 0  # kernel launches (CUDA path only)


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 with XLA's saturating convert.  torch's cast wraps: on
    this torch 1e30 becomes -2**31, and clamping to 2**31-1 first does not
    help, because 2**31-1 rounds to 2**31 in f32.  A class whose requests are
    all zero reaches ``_capacity`` as BIG, which must become INT32_MAX."""
    y = torch.nan_to_num(x, nan=0.0).clamp(-2147483648.0, 2147483520.0).to(torch.int32)
    return torch.where(x >= 2147483648.0, torch.full_like(y, INT32_MAX), y)


def it_intersects(merged, it, vocab_ints, v, key_has_bounds) -> torch.Tensor:
    """bool[N, I]: InstanceType.Requirements.Intersects(nodeReqs) for every
    (row, instance type) pair (node.go:143-145), on packed words: a
    word-wide AND + nonzero test per key, plus the unseen-value overlap."""
    vw = mask_ops.const_words("vocab", v, merged.mask.device)
    a_other = mask_ops.other_bit(merged.mask, v)  # [N, K]
    b_other = mask_ops.other_bit(it.mask, v)  # [I, K]
    ok_all = None
    for k in range(it.defined.shape[-1]):  # K is small: unrolled
        a_mask = merged.mask[:, k, :]  # [N, W]
        b_mask = it.mask[:, k, :]  # [I, W]
        vocab_overlap = ((a_mask[:, None, :] & vw & b_mask[None, :, :]) != 0).any(dim=-1)
        both_other = a_other[:, k, None] & b_other[None, :, k]
        if key_has_bounds[k]:
            gt = torch.maximum(merged.gt[:, k, None], it.gt[None, :, k])
            lt = torch.minimum(merged.lt[:, k, None], it.lt[None, :, k])
            n_range = torch.clamp(torch.ceil(lt) - torch.floor(gt) - 1.0, min=0.0)
            ints_k = vocab_ints[k]  # [V]
            inside = (ints_k[None, None, :] > gt[..., None]) & (ints_k[None, None, :] < lt[..., None])
            n_in = inside.to(torch.float32).sum(dim=-1)
            unseen = both_other & (n_range - n_in >= 1.0)
        else:
            unseen = both_other
        nonempty = vocab_overlap | unseen
        checked = merged.defined[:, k, None] & it.defined[None, :, k]
        both_neg = merged.negative[:, k, None] & it.negative[None, :, k]
        ok = ~checked | nonempty | both_neg
        ok_all = ok if ok_all is None else (ok_all & ok)
    return ok_all


def capacity(used: torch.Tensor, size: torch.Tensor, it_alloc: torch.Tensor) -> torch.Tensor:
    """i32[N, I]: how many more pods of the class fit on row n as instance
    type i — min over resources of floor((alloc - used) / size)."""
    count = None
    for r in range(it_alloc.shape[-1]):  # R is small: unrolled
        free = it_alloc[None, :, r] - used[:, r, None]  # [N, I]
        per = torch.where(
            size[r] > 0,
            torch.floor((free + 1e-4) / torch.clamp(size[r], min=1e-9)),
            BIG,
        )
        per = torch.clamp(per, min=0.0)
        count = per if count is None else torch.minimum(count, per)
    return to_i32(torch.clamp(count, max=BIG))


def offering_ok(zone_ok: torch.Tensor, ct_ok: torch.Tensor, it_avail: torch.Tensor) -> torch.Tensor:
    """bool[N, I]: some available offering lies in the row's allowed zone x
    capacity-type rectangle (node.go:151-159 hasOffering)."""
    n = zone_ok.shape[0]
    zc = (zone_ok[:, :, None] & ct_ok[:, None, :]).reshape(n, -1)  # [N, Z*CT]
    avail2 = it_avail.reshape(it_avail.shape[0], -1)  # [I, Z*CT]
    return (zc[:, None, :] & avail2[None, :, :]).any(dim=-1)


def it_capacity_plain(viable, cls_it, merged, it, vocab_ints, v, key_has_bounds,
                      zone_ok, ct_ok, it_avail, used, size, it_alloc):
    """The plain torch version of K1 (CPU path and the kernel's oracle)."""
    it_ok = (
        viable
        & cls_it[None, :]
        & it_intersects(merged, it, vocab_ints, v, key_has_bounds)
        & offering_ok(zone_ok, ct_ok, it_avail)
    )
    cap_ni = torch.where(it_ok, capacity(used, size, it_alloc), 0)
    return it_ok, cap_ni, cap_ni.amax(dim=-1)


_FLAGS: Dict[Tuple[tuple, torch.device], torch.Tensor] = {}


def _key_flags(key_has_bounds, device) -> torch.Tensor:
    key = (tuple(bool(b) for b in key_has_bounds), device)
    t = _FLAGS.get(key)
    if t is None:
        t = torch.tensor([int(b) for b in key[0]], dtype=torch.uint8, device=device)
        _FLAGS[key] = t
    return t


it_capacity_twin = batch.tenantwise(it_capacity_plain, lambda viable, *_: viable.dim() == 2)


_ARGTYPES = [ctypes.c_int] * 11 + [ctypes.c_void_p] * 25


def it_capacity(viable, cls_it, merged, it, vocab_ints, v, key_has_bounds,
                zone_ok, ct_ok, it_avail, used, size, it_alloc):
    """K1 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (no fallback between them).  Every operand may carry a
    leading tenant axis B (``viable`` bool[B, N, I], the catalog planes
    [B, I, ...]): one launch covers every tenant."""
    args = (viable, cls_it, merged, it, vocab_ints, v, key_has_bounds,
            zone_ok, ct_ok, it_avail, used, size, it_alloc)
    if viable.device.type != "cuda":
        return it_capacity_twin(*args)
    if viable.dim() == 2:
        return batch.drop_axis(_it_capacity_cuda(*batch.add_axis(args)))
    return _it_capacity_cuda(*args)


def _it_capacity_cuda(viable, cls_it, merged, it, vocab_ints, v, key_has_bounds,
                      zone_ok, ct_ok, it_avail, used, size, it_alloc):
    global launches
    dev = viable.device
    n_b, n, n_it = viable.shape
    _, _, n_keys, n_words = it.mask.shape
    n_vocab = vocab_ints.shape[-1]
    n_res = it_alloc.shape[-1]
    n_zones, n_ct = it_avail.shape[2], it_avail.shape[3]
    b, i32, f32 = torch.bool, torch.int32, torch.float32
    for name, t, dt, shape in (
        ("viable", viable, b, (n_b, n, n_it)), ("cls_it", cls_it, b, (n_b, n_it)),
        ("merged.mask", merged.mask, i32, (n_b, n, n_keys, n_words)),
        ("merged.defined", merged.defined, b, (n_b, n, n_keys)),
        ("merged.negative", merged.negative, b, (n_b, n, n_keys)),
        ("merged.gt", merged.gt, f32, (n_b, n, n_keys)),
        ("merged.lt", merged.lt, f32, (n_b, n, n_keys)),
        ("it.mask", it.mask, i32, (n_b, n_it, n_keys, n_words)),
        ("it.defined", it.defined, b, (n_b, n_it, n_keys)),
        ("it.negative", it.negative, b, (n_b, n_it, n_keys)),
        ("it.gt", it.gt, f32, (n_b, n_it, n_keys)), ("it.lt", it.lt, f32, (n_b, n_it, n_keys)),
        ("vocab_ints", vocab_ints, f32, (n_b, n_keys, n_vocab)),
        ("zone_ok", zone_ok, b, (n_b, n, n_zones)), ("ct_ok", ct_ok, b, (n_b, n, n_ct)),
        ("it_avail", it_avail, b, (n_b, n_it, n_zones, n_ct)),
        ("used", used, f32, (n_b, n, n_res)), ("size", size, f32, (n_b, n_res)),
        ("it_alloc", it_alloc, f32, (n_b, n_it, n_res)),
    ):
        build.check_input(name, t, dt, shape, dev)
    if mask_ops.words_for(v) != n_words:
        raise ValueError(f"mask width {n_words} words does not hold v={v} slots")
    it_ok = torch.empty((n_b, n, n_it), dtype=b, device=dev)
    cap_ni = torch.empty((n_b, n, n_it), dtype=i32, device=dev)
    cap_n = torch.empty((n_b, n), dtype=i32, device=dev)
    vw = mask_ops.const_words("vocab", v, dev)
    flags = _key_flags(key_has_bounds, dev)
    fn = build.function("it_capacity", "kc_it_capacity", _ARGTYPES)
    ptrs = [t.data_ptr() for t in (
        viable, cls_it, merged.mask, merged.defined, merged.negative, merged.gt, merged.lt,
        it.mask, it.defined, it.negative, it.gt, it.lt, vw, vocab_ints, flags,
        zone_ok, ct_ok, it_avail, used, size, it_alloc, it_ok, cap_ni, cap_n,
    )]
    rc = fn(n_b, n, n_it, n_keys, n_words, n_vocab, (v - 1) // 32, (v - 1) % 32, n_res,
            n_zones, n_ct, *ptrs, build.stream(dev))
    build.check(rc, "it_capacity")
    launches += 1
    return it_ok, cap_ni, cap_n
