"""K8 and K9: the consolidation sweep's lane set-up and lane finish.

The sweep (``ops.consolidate``) simulates closing the first k
disruption-sorted candidates for up to 64 values of k at once; each value is
a lane.  ``sweep_lanes`` (K8, ``csrc/sweep_lanes.cu``) is the set-up of
every lane of a pass, ``sweep.one_prefix`` :69-78 of
karpenter_core_tpu/ops/consolidate.py:

    subset[s, e] = rank[e] < k[s]
    open[s, e]   = open_[e] & ~subset[s, e]
    count[s, c]  = base[c] + sum_e ex_cls_count[c, e] * subset[s, e]   (int32)

``lane_finish`` (K9, ``csrc/lane_finish.cu``) is the rest of ``one_prefix``
(:83-100) over the stacked lane outputs, with ``node_prices``
(karpenter_core_tpu/ops/solve.py:2140):

    price[s, n]  = min over viable i, allowed z, allowed ct of it_price[i, z, ct]
                   (+inf when none; 0 where the slot is closed or empty)
    new_cost[s]  = sum over n of the finite prices, in slot order
    failed[s]    = sum_c failed[s, c]                                 (int32)
    uninit[s]    = any_(c, e) assign_existing[s, c, e] > 0 & ~init[e]

Each wrapper runs its plain torch twin for CPU tensors and launches its
kernel for CUDA tensors; the twins are the CPU path and the kernels' oracle.
"""

from __future__ import annotations

import ctypes

import torch

from karpenter_core_tpu_torch.kernels import build

I32 = torch.int32

lanes_launches = 0  # K8 launches (CUDA path only)
finish_launches = 0  # K9 launches (CUDA path only)

_K8_ARGS = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
_K9_ARGS = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 14


# -- K8 -------------------------------------------------------------------------


def sweep_lanes_plain(rank, open_, base, ex_cls_count, sizes):
    """The plain torch version of K8: (open bool[S, E], count i32[S, C])."""
    subset = rank[None, :] < sizes[:, None]  # [S, E]
    lane_open = open_[None, :] & ~subset
    displaced = (ex_cls_count[None, :, :] * subset[:, None, :].to(I32)).sum(dim=-1, dtype=I32)
    return lane_open, base[None, :] + displaced


def sweep_lanes(rank, open_, base, ex_cls_count, sizes):
    """K8 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (no fallback between them)."""
    global lanes_launches
    dev = rank.device
    if dev.type != "cuda":
        return sweep_lanes_plain(rank, open_, base, ex_cls_count, sizes)
    n_ex, n_cls, n_lanes = rank.shape[0], base.shape[0], sizes.shape[0]
    for name, t, dt, shape in (
        ("rank", rank, I32, (n_ex,)), ("open_", open_, torch.bool, (n_ex,)),
        ("base", base, I32, (n_cls,)), ("ex_cls_count", ex_cls_count, I32, (n_cls, n_ex)),
        ("sizes", sizes, I32, (n_lanes,)),
    ):
        build.check_input(name, t, dt, shape, dev)
    lane_open = rank.new_empty((n_lanes, n_ex), dtype=torch.bool)
    count = rank.new_empty((n_lanes, n_cls))
    fn = build.function("sweep_lanes", "kc_sweep_lanes", _K8_ARGS)
    rc = fn(n_lanes, n_ex, n_cls, rank.data_ptr(), open_.data_ptr(), base.data_ptr(),
            ex_cls_count.data_ptr(), sizes.data_ptr(), lane_open.data_ptr(), count.data_ptr(),
            build.stream(dev))
    build.check(rc, "sweep_lanes")
    lanes_launches += 1
    return lane_open, count


# -- K9 -------------------------------------------------------------------------


def slot_prices_plain(viable, zone, ct, open_, pod_count, it_price):
    """f32[..., N]: each slot's cheapest offering over its viable instance
    types, allowed zones and allowed capacity types; +inf when it has none,
    0 for a closed or empty slot.  The port of ``node_prices``
    (karpenter_core_tpu/ops/solve.py:2140), batched over leading dims."""
    allowed = viable[..., :, None, None] & zone[..., None, :, None] & ct[..., None, None, :]
    priced = torch.where(allowed, it_price, torch.inf)  # [..., N, I, Z, CT]
    best = priced.flatten(-3).amin(dim=-1)
    return torch.where(open_ & (pod_count > 0), best, 0.0)


def lane_finish_plain(viable, zone, ct, open_, pod_count, failed, assign_existing, init,
                      it_price):
    """The plain torch version of K9: (price f32[S, N], new_cost f32[S],
    failed i32[S], uninit bool[S])."""
    price = slot_prices_plain(viable, zone, ct, open_, pod_count, it_price)
    finite = torch.where(torch.isfinite(price), price, 0.0)
    # slot order, one rounding per add: the kernel's summation order
    cost = torch.zeros(price.shape[0], dtype=torch.float32, device=price.device)
    for n in range(price.shape[1]):
        cost = cost + finite[:, n]
    uninit = ((assign_existing > 0) & ~init[None, None, :]).flatten(1).any(dim=-1)
    return price, cost, failed.sum(dim=-1, dtype=I32), uninit


def lane_finish(viable, zone, ct, open_, pod_count, failed, assign_existing, init, it_price):
    """K9 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (no fallback between them)."""
    global finish_launches
    dev = viable.device
    if dev.type != "cuda":
        return lane_finish_plain(viable, zone, ct, open_, pod_count, failed, assign_existing,
                                 init, it_price)
    n_lanes, n_slots, n_it = viable.shape
    n_zones, n_ct = zone.shape[-1], ct.shape[-1]
    n_cls, n_ex = assign_existing.shape[1], assign_existing.shape[2]
    b, f32 = torch.bool, torch.float32
    for name, t, dt, shape in (
        ("viable", viable, b, (n_lanes, n_slots, n_it)),
        ("zone", zone, b, (n_lanes, n_slots, n_zones)), ("ct", ct, b, (n_lanes, n_slots, n_ct)),
        ("open_", open_, b, (n_lanes, n_slots)), ("pod_count", pod_count, I32, (n_lanes, n_slots)),
        ("failed", failed, I32, (n_lanes, n_cls)),
        ("assign_existing", assign_existing, I32, (n_lanes, n_cls, n_ex)),
        ("init", init, b, (n_ex,)), ("it_price", it_price, f32, (n_it, n_zones, n_ct)),
    ):
        build.check_input(name, t, dt, shape, dev)
    price = torch.empty((n_lanes, n_slots), dtype=f32, device=dev)
    cost = torch.empty((n_lanes,), dtype=f32, device=dev)
    failed_sum = torch.empty((n_lanes,), dtype=I32, device=dev)
    uninit = torch.empty((n_lanes,), dtype=b, device=dev)
    fn = build.function("lane_finish", "kc_lane_finish", _K9_ARGS)
    ptrs = [t.data_ptr() for t in (
        viable, zone, ct, open_, pod_count, failed, assign_existing, init, it_price,
        price, cost, failed_sum, uninit,
    )]
    rc = fn(n_lanes, n_slots, n_it, n_zones, n_ct, n_cls, n_ex, *ptrs, build.stream(dev))
    build.check(rc, "lane_finish")
    finish_launches += 1
    return price, cost, failed_sum, uninit
