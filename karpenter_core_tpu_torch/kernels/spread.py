"""K7: the per-zone quotas of one zone-spread class.

``spread_quota(counts, allowed, fillable, cap_pods, skew, m, member)`` runs
the capped quota rounds of the reference's class step
(karpenter_core_tpu/ops/solve.py:1440-1475) with the ``_water_fill`` (:277)
they call, then the member gate and the under-placement flag.  It returns
``(quotas i32[Z], sat bool[Z], m_rem i32[], fill_residual bool[])``.  Every
input is a tensor on the device (``skew``, ``m`` and ``member`` 0-dim), so
the class loop reads nothing on the host.  The CUDA source is
``csrc/spread_quota.cu``; the plain torch twin below is the CPU path and the
kernel's oracle.
"""

from __future__ import annotations

import ctypes

import torch

from karpenter_core_tpu_torch.kernels import batch, build
from karpenter_core_tpu_torch.kernels.capacity import BIG, UNLIMITED, to_i32
from karpenter_core_tpu_torch.kernels.fp32 import cumsum_xla_plain, fma_f32

BIGI = UNLIMITED  # the reference's BIGI, the count of a zone that bounds nothing

launches = 0  # kernel launches (CUDA path only)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for a 0-dim index, gathered on the device (no host read)."""
    return x.index_select(0, idx.reshape(1))[0]


def water_fill(count0: torch.Tensor, allowed: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """i32[Z] quotas: distribute m pods over allowed zones, always filling
    the lowest-count zone first (topologygroup.go:155-182 telescoped).  Ties
    among allowed zones keep index order: the sort is stable.  The floats
    round as the reference's jitted ``_water_fill`` rounds them on the CPU:
    its running sum in XLA's cumsum order (``fp32.cumsum_xla_plain``:
    sequential up to 16 zones), and ``idx * s - prefix`` and ``rem - floor
    * k`` each one fused multiply-add (XLA contracts both; torch.cumsum
    would sum in double on the CPU and in a parallel order on the card)."""
    z = count0.shape[0]
    dev = count0.device
    c = torch.where(allowed, count0.to(torch.float32), BIG)
    order = torch.argsort(c, stable=True)
    s = c[order]
    idx = torch.arange(z, dtype=torch.float32, device=dev)
    prefix = cumsum_xla_plain(s) - s
    cost = fma_f32(idx, s, -prefix)
    cost = torch.where(torch.isfinite(cost), cost, BIG)
    mf = m.to(torch.float32)
    k_star = (cost <= mf).sum(dtype=torch.int32) - 1
    k_star = torch.clamp(k_star, 0, z - 1).long()
    base_level = _take(s, k_star)
    spent = _take(cost, k_star)
    rem = mf - spent
    k_count = (k_star + 1).to(torch.float32)
    fl = torch.floor(rem / k_count)
    level = base_level + fl
    leftover = fma_f32(-fl, k_count, rem)
    ar = torch.arange(z, dtype=torch.int32, device=dev)
    in_fill = ar <= k_star
    extra = (ar < leftover).to(torch.float32)
    final_sorted = torch.where(in_fill, torch.maximum(s, level + extra), s)
    final = torch.zeros_like(c).scatter(0, order, final_sorted)
    quota = torch.where(allowed, final - c, 0.0)
    return to_i32(torch.clamp(quota, min=0.0))


def spread_quota_plain(counts, allowed, fillable, cap_pods, skew, m, member):
    """The plain torch version of K7."""
    n_zones = counts.shape[0]
    unreachable = allowed & ~fillable
    finite_cap = cap_pods < UNLIMITED
    quotas = torch.zeros(n_zones, dtype=torch.int32, device=counts.device)
    sat = torch.zeros(n_zones, dtype=torch.bool, device=counts.device)
    m_rem = m
    # worst case: one round per sequentially-saturating finite-cap zone, plus
    # a final redistribution round for the unbounded zones
    for _ in range(n_zones + 1):
        counts_now = counts + quotas
        min_frozen = torch.where(unreachable | sat, counts_now, BIGI).amin()
        skew_cap = torch.clamp(min_frozen + skew - counts_now, 0, UNLIMITED)
        active = allowed & fillable & ~sat
        cap_rem = torch.clamp(cap_pods - quotas, 0, UNLIMITED)
        lvl_sat = torch.where(active & finite_cap, counts_now + cap_rem, BIGI).amin()
        q = water_fill(counts_now, active, m_rem)
        q = torch.minimum(q, torch.clamp(lvl_sat - counts_now, 0, UNLIMITED))
        q = torch.minimum(q, torch.minimum(skew_cap, cap_rem))
        q = torch.where(active, q, 0)
        quotas = quotas + q
        m_rem = m_rem - q.sum(dtype=torch.int32)
        sat = sat | (active & finite_cap & (quotas >= cap_pods))
    quotas = torch.where(member, quotas, 0)
    counts_end = counts + quotas
    min_frozen_end = torch.where(unreachable | sat, counts_end, BIGI).amin()
    skew_headroom = (counts_end - min_frozen_end) < skew
    cap_headroom = (cap_pods - quotas) > 0
    fill_residual = (m_rem > 0) & (
        allowed & fillable & ~sat & skew_headroom & cap_headroom
    ).any()
    return quotas, sat, m_rem, fill_residual


spread_quota_twin = batch.tenantwise(spread_quota_plain, lambda counts, *_: counts.dim() == 1)


def spread_quota(counts, allowed, fillable, cap_pods, skew, m, member):
    """K7 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (no fallback between them).  With a leading tenant axis
    (``counts`` i32[B, Z], ``skew`` / ``m`` / ``member`` [B]) each tenant
    runs its own rounds, in one launch."""
    args = (counts, allowed, fillable, cap_pods, skew, m, member)
    if counts.device.type != "cuda":
        return spread_quota_twin(*args)
    if counts.dim() == 1:
        return batch.drop_axis(_spread_quota_cuda(*batch.add_axis(args)))
    return _spread_quota_cuda(*args)


def _spread_quota_cuda(counts, allowed, fillable, cap_pods, skew, m, member):
    global launches
    dev = counts.device
    n_b, n_zones = counts.shape
    b, i32 = torch.bool, torch.int32
    for name, t, dt, shape in (
        ("counts", counts, i32, (n_b, n_zones)), ("allowed", allowed, b, (n_b, n_zones)),
        ("fillable", fillable, b, (n_b, n_zones)), ("cap_pods", cap_pods, i32, (n_b, n_zones)),
        ("skew", skew, i32, (n_b,)), ("m", m, i32, (n_b,)), ("member", member, b, (n_b,)),
    ):
        build.check_input(name, t, dt, shape, dev)
    max_zones = build.function("spread_quota", "kc_spread_quota_max_zones", [])()
    if n_zones > max_zones:
        raise ValueError(f"spread_quota takes at most {max_zones} zones")
    quotas = torch.empty((n_b, n_zones), dtype=i32, device=dev)
    sat = torch.empty((n_b, n_zones), dtype=b, device=dev)
    m_rem = torch.empty((n_b,), dtype=i32, device=dev)
    residual = torch.empty((n_b,), dtype=b, device=dev)
    fn = build.function("spread_quota", "kc_spread_quota", [ctypes.c_int] * 2 + [ctypes.c_void_p] * 12)
    rc = fn(n_b, n_zones, *(t.data_ptr() for t in (
        counts, allowed, fillable, cap_pods, skew, m, member, quotas, sat, m_rem, residual,
    )), build.stream(dev))
    build.check(rc, "spread_quota")
    launches += 1
    return quotas, sat, m_rem, residual
