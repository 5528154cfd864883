"""K2: fill a quota of pods over slots in ascending priority order.

``fill_by_priority(quota, cap, priority)`` is ``_fill_by_priority``
(karpenter_core_tpu/ops/solve.py:419): the vectorized "sort nodes, first node
that accepts wins" of scheduler.go:183-190.  The sort must be STABLE — empty
slots all share pod count 0, and ``jnp.argsort`` keeps their index order —
and the cumsum stays int32 and wraps exactly as the reference's does.
The CUDA source is ``csrc/fill_priority.cu``: one block up to
``kc_fill_priority_max_n()`` = 16,384 slots (read once), which drops the
zero caps, skips the sort when the kept priorities already run in index
order and otherwise sorts only the kept slots over the key bits in use; a
multi-block sort, scan and scatter above it (any N, as the reference
takes); one block a tenant, or one segment of the sort a tenant, under a
leading tenant axis.
"""

from __future__ import annotations

import ctypes

import torch

from karpenter_core_tpu_torch.kernels import batch, build

launches = 0  # kernel launches (CUDA path only)
_max_n = None  # the one-block path's largest plane, read from the library once

_ONE_ARGS = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
_MULTI_ARGS = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6


def fill_by_priority_plain(quota: torch.Tensor, cap: torch.Tensor,
                           priority: torch.Tensor) -> torch.Tensor:
    """The plain torch version of K2 (CPU path and the kernel's oracle)."""
    order = torch.argsort(priority, stable=True)
    cap_sorted = cap[order]
    before = torch.cumsum(cap_sorted, dim=0, dtype=torch.int32) - cap_sorted
    assigned_sorted = torch.minimum(torch.clamp(quota - before, min=0), cap_sorted)
    return torch.zeros_like(cap).scatter(0, order, assigned_sorted)


fill_by_priority_twin = batch.tenantwise(
    fill_by_priority_plain, lambda quota, cap, priority: cap.dim() == 1)


def fill_by_priority(quota: torch.Tensor, cap: torch.Tensor,
                     priority: torch.Tensor) -> torch.Tensor:
    """K2 wrapper: i32[N] pods per slot.  ``quota`` is a 0-dim int32 tensor
    on the slots' device; the kernel reads it there (no host sync).  With a
    leading tenant axis (``quota`` i32[B], ``cap`` / ``priority`` i32[B, N])
    each tenant is filled on its own, in one launch."""
    args = (quota, cap, priority)
    if cap.device.type != "cuda":
        return fill_by_priority_twin(*args)
    if cap.dim() == 1:
        return _fill_cuda(*batch.add_axis(args))[0]
    return _fill_cuda(*args)


def _fill_cuda(quota, cap, priority):
    global launches, _max_n
    n_b, n = cap.shape
    for name, t, shape in (("quota", quota, (n_b,)), ("cap", cap, (n_b, n)),
                           ("priority", priority, (n_b, n))):
        build.check_input(name, t, torch.int32, shape, cap.device)
    out = torch.empty_like(cap)
    stream = build.stream(cap.device)
    if _max_n is None:
        _max_n = build.function("fill_priority", "kc_fill_priority_max_n", [])()
    if n <= _max_n:
        fn = build.function("fill_priority", "kc_fill_priority", _ONE_ARGS)
        rc = fn(n_b, n, quota.data_ptr(), cap.data_ptr(), priority.data_ptr(), out.data_ptr(),
                stream)
    else:
        size = build.function("fill_priority", "kc_fill_priority_scratch_bytes",
                              [ctypes.c_int, ctypes.c_int], ctypes.c_size_t)
        scratch = torch.empty(size(n_b, n), dtype=torch.uint8, device=cap.device)
        fn = build.function("fill_priority", "kc_fill_priority_multi", _MULTI_ARGS)
        rc = fn(n_b, n, quota.data_ptr(), cap.data_ptr(), priority.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), stream)
    build.check(rc, "fill_priority")
    launches += 1
    return out
