"""K13: the policy objective's offering selection.

``select_offerings`` is ``select_offerings`` (karpenter_core_tpu/ops/
objective.py:87): for every new-node slot n, the cheapest allowed
(instance type i, zone z, capacity type c) cell under the policy score::

    expected[i,z,c] = price[i,z,c] * fma(risk_aversion, risk[i,z,c], 1)
    score[i,z,c]    = fma(cost_weight, expected[i,z,c],
                          -(throughput_weight * throughput[i]))
    scored[n, j]    = score[j] if viable[n,i] & zone[n,z] & ct[n,c]
                                    & isfinite(price[j]) else +inf
    best[n]         = min_j scored[n, j]          (NaN propagates)
    ties            = scored[n, j] == best[n]     (over every cell j)
    sel[n]          = first spot tie when spot_preference and one exists,
                      else the first tie, else 0  (row-major (i, z, c))

with ``sel_it, sel_zone, sel_ct``, the selected cell's ``price`` and
``expected``, ``active = open_ & pod_count > 0 & isfinite(best)`` and the
float32 sums ``fleet_cost`` / ``fleet_expected`` of price and expected over
the active slots.  The two FMAs are XLA's: its CPU code contracts
``1 + ra * risk`` and ``cw * expected - tw * thr`` that way (the reference's
``cell_scores`` jitted alone gives exactly these planes).  The sums take
XLA's CPU order: windows of 32 summed in order from 0, the vector padded
evenly at both ends to a multiple of 32, repeated on the window sums until
at most 32 remain, which are summed in order.

The CUDA source is ``csrc/select_offerings.cu``; ``select_offerings_plain``
is its twin (the CPU path and the kernel's oracle).  The wrapper takes the
twin for CPU tensors and launches the kernel for CUDA tensors, never one in
place of the other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from karpenter_core_tpu_torch.kernels import build
from karpenter_core_tpu_torch.kernels.fp32 import WINDOW, fma_f32, tree_sum_plain

launches = 0  # kernel launches (CUDA path only)


class Weights(NamedTuple):
    """The objective's scalar knobs, as float32 values and a flag."""

    cost_weight: float
    throughput_weight: float
    risk_aversion: float
    spot_preference: bool


def cell_scores_plain(price, risk, throughput, weights: Weights):
    """(expected f32[I,Z,CT], score f32[I,Z,CT]) of every offering cell."""
    one = fma_f32(torch.tensor(weights.risk_aversion, dtype=torch.float32, device=price.device),
                  risk, torch.ones((), dtype=torch.float32, device=price.device))
    expected = price * one
    penalty = torch.tensor(weights.throughput_weight, dtype=torch.float32,
                           device=price.device) * throughput[:, None, None]
    score = fma_f32(torch.tensor(weights.cost_weight, dtype=torch.float32, device=price.device),
                    expected, -penalty)
    return expected, score


def select_offerings_plain(viable, zone, ct, open_, pod_count, price, risk, throughput,
                           is_spot, weights: Weights):
    """The plain torch version of K13: (sel_it, sel_zone, sel_ct, price,
    expected, active, fleet_cost, fleet_expected)."""
    n = viable.shape[0]
    n_z, n_ct = zone.shape[1], ct.shape[1]
    expected, score = cell_scores_plain(price, risk, throughput, weights)
    allowed = (viable[:, :, None, None] & zone[:, None, :, None] & ct[:, None, None, :]
               & torch.isfinite(price)[None])
    scored = torch.where(allowed, score[None], float("inf")).reshape(n, -1)
    best = torch.amin(scored, dim=1)  # propagates NaN, as XLA's minimum does
    is_best = scored == best[:, None]
    spot_ties = is_best & is_spot[None, None, :].expand(price.shape).reshape(1, -1)
    use_spot = bool(weights.spot_preference) & spot_ties.any(dim=1)
    candidates = torch.where(use_spot[:, None], spot_ties, is_best)
    sel = torch.argmax(candidates.to(torch.uint8), dim=1).to(torch.int32)  # first, or 0
    sel_price = price.reshape(-1)[sel.long()]
    sel_expected = expected.reshape(-1)[sel.long()]
    active = open_ & (pod_count > 0) & torch.isfinite(best)
    zero = torch.zeros((), dtype=torch.float32, device=price.device)
    return (sel // (n_z * n_ct), (sel % (n_z * n_ct)) // n_ct, sel % n_ct, sel_price,
            sel_expected, active, tree_sum_plain(torch.where(active, sel_price, zero)),
            tree_sum_plain(torch.where(active, sel_expected, zero)))


def select_offerings(viable, zone, ct, open_, pod_count, price, risk, throughput, is_spot,
                     weights: Weights):
    """K13 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors."""
    global launches
    dev = viable.device
    if dev.type != "cuda":
        return select_offerings_plain(viable, zone, ct, open_, pod_count, price, risk,
                                      throughput, is_spot, weights)
    n, n_it = viable.shape
    n_z, n_ct = zone.shape[1], ct.shape[1]
    for name, t, dt, shape in (
        ("viable", viable, torch.bool, (n, n_it)), ("zone", zone, torch.bool, (n, n_z)),
        ("ct", ct, torch.bool, (n, n_ct)), ("open_", open_, torch.bool, (n,)),
        ("pod_count", pod_count, torch.int32, (n,)),
        ("price", price, torch.float32, (n_it, n_z, n_ct)),
        ("risk", risk, torch.float32, (n_it, n_z, n_ct)),
        ("throughput", throughput, torch.float32, (n_it,)), ("is_spot", is_spot, torch.bool, (n_ct,)),
    ):
        build.check_input(name, t, dt, shape, dev)
    cells = n_it * n_z * n_ct
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    sel_it, sel_zone, sel_ct = (torch.empty(n, **i32) for _ in range(3))
    sel_price, sel_expected = torch.empty(n, **f32), torch.empty(n, **f32)
    active = torch.empty(n, dtype=torch.bool, device=dev)
    sums = torch.empty(2, **f32)
    windows = max(-(-n // WINDOW), 1)
    # the cell planes (expected, masked score) and the sum levels' ping-pong
    scratch = torch.empty(2 * cells + 4 * windows, **f32)
    fn = build.function("select_offerings", "kc_select_offerings",
                        [ctypes.c_int] * 4 + [ctypes.c_float] * 3 + [ctypes.c_int]
                        + [ctypes.c_void_p] * 18)
    rc = fn(n, n_it, n_z, n_ct, weights.cost_weight, weights.throughput_weight,
            weights.risk_aversion, int(bool(weights.spot_preference)), viable.data_ptr(),
            zone.data_ptr(), ct.data_ptr(), open_.data_ptr(), pod_count.data_ptr(),
            price.data_ptr(), risk.data_ptr(), throughput.data_ptr(), is_spot.data_ptr(),
            sel_it.data_ptr(), sel_zone.data_ptr(), sel_ct.data_ptr(), sel_price.data_ptr(),
            sel_expected.data_ptr(), active.data_ptr(), sums.data_ptr(), scratch.data_ptr(),
            build.stream(dev))
    build.check(rc, "select_offerings")
    launches += 1
    return sel_it, sel_zone, sel_ct, sel_price, sel_expected, active, sums[0], sums[1]
