"""K20: the what-if studies' replica summary.

``replica_finish`` is the finish of ``_monte_carlo_fn.one_replica``
(karpenter_core_tpu/parallel/mesh.py:480-487) over a chunk of B replica
solves stacked on a leading axis::

    scheduled[b] = sum_(c, n) assign[b, c, n]                 (int32)
    failed[b]    = sum_c failed[b, c]                          (int32)
    nodes[b]     = #{n : pod_count[b, n] > 0}                  (int32)
    cost[b]      = sum_n price[b, n] where finite              (float32)

with ``price`` the slots' cheapest offerings, ``node_prices``
(karpenter_core_tpu/ops/solve.py:2140): ``kernels.consolidate
.slot_prices_plain`` in the twin; the kernel ranks the catalog by price
within each offering cell once a call and takes, for each allowed cell, the
first viable type in that order (the same minimum).
The cost sums in XLA's CPU tree order (``kernels.fp32.tree_sum_plain``):
that is what ``jit(vmap(one_replica))`` computes on the CPU.

The CUDA source is ``csrc/replica_finish.cu``: two launches a call (the
rank, then every replica of the chunk).  ``replica_finish_plain`` is its
twin (the CPU path and the kernel's oracle).  The wrapper takes the twin
for CPU tensors and launches the kernel for CUDA tensors, never one in
place of the other.
"""

from __future__ import annotations

import ctypes

import torch

from karpenter_core_tpu_torch.kernels import build
from karpenter_core_tpu_torch.kernels.consolidate import slot_prices_plain
from karpenter_core_tpu_torch.kernels.fp32 import WINDOW, tree_sum_plain

I32 = torch.int32

launches = 0  # kernel launches (CUDA path only)


def replica_finish_plain(assign, failed, viable, zone, ct, open_, pod_count, it_price):
    """The plain version of K20: (scheduled i32[B], failed i32[B], nodes
    i32[B], cost f32[B]).  Prices one replica at a time: the [N, I, Z, CT]
    price plane of a full-size replica is 0.2 GB."""
    price = torch.stack([
        slot_prices_plain(viable[b], zone[b], ct[b], open_[b], pod_count[b], it_price)
        for b in range(viable.shape[0])
    ])
    cost = tree_sum_plain(torch.where(torch.isfinite(price), price, 0.0))
    return (assign.flatten(1).sum(dim=1, dtype=I32), failed.sum(dim=1, dtype=I32),
            (pod_count > 0).sum(dim=1, dtype=I32), cost)


def replica_finish(assign, failed, viable, zone, ct, open_, pod_count, it_price):
    """K20 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (no fallback between them)."""
    global launches
    dev = viable.device
    if dev.type != "cuda":
        return replica_finish_plain(assign, failed, viable, zone, ct, open_, pod_count,
                                    it_price)
    n_rep, n_slots, n_it = viable.shape
    n_zones, n_ct, n_cls = zone.shape[-1], ct.shape[-1], assign.shape[1]
    b, f32 = torch.bool, torch.float32
    for name, t, dt, shape in (
        ("assign", assign, I32, (n_rep, n_cls, n_slots)), ("failed", failed, I32, (n_rep, n_cls)),
        ("viable", viable, b, (n_rep, n_slots, n_it)),
        ("zone", zone, b, (n_rep, n_slots, n_zones)), ("ct", ct, b, (n_rep, n_slots, n_ct)),
        ("open_", open_, b, (n_rep, n_slots)), ("pod_count", pod_count, I32, (n_rep, n_slots)),
        ("it_price", it_price, f32, (n_it, n_zones, n_ct)),
    ):
        build.check_input(name, t, dt, shape, dev)
    n_win = -(-n_slots // WINDOW) if n_slots > WINDOW else 1
    n_cells = n_zones * n_ct
    ord_idx = torch.empty((n_cells, n_it), dtype=I32, device=dev)
    ord_price = torch.empty((n_cells, n_it), dtype=f32, device=dev)
    part_cost = torch.empty((n_rep, n_win), dtype=f32, device=dev)
    part_int = torch.empty((n_rep, n_win, 2), dtype=I32, device=dev)
    ticket = torch.zeros((n_rep,), dtype=I32, device=dev)
    outs = [torch.empty((n_rep,), dtype=I32, device=dev) for _ in range(3)]
    cost = torch.empty((n_rep,), dtype=f32, device=dev)
    fn = build.function("replica_finish", "kc_replica_finish",
                        [ctypes.c_int] * 6 + [ctypes.c_void_p] * 18)
    ptrs = [t.data_ptr() for t in (assign, failed, viable, zone, ct, open_, pod_count, it_price,
                                   ord_idx, ord_price, part_cost, part_int, ticket, *outs,
                                   cost)]
    rc = fn(n_rep, n_slots, n_it, n_zones, n_ct, n_cls, *ptrs, build.stream(dev))
    build.check(rc, "replica_finish")
    launches += 1
    return (*outs, cost)
