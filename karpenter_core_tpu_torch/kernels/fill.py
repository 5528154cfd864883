"""K2: fill a quota of pods over slots in ascending priority order.

``fill_by_priority(quota, cap, priority)`` is ``_fill_by_priority``
(karpenter_core_tpu/ops/solve.py:419): the vectorized "sort nodes, first node
that accepts wins" of scheduler.go:183-190.  The sort must be STABLE — empty
slots all share pod count 0, and ``jnp.argsort`` keeps their index order —
and the cumsum stays int32 and wraps exactly as the reference's does.
The CUDA source is ``csrc/fill_priority.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from karpenter_core_tpu_torch.kernels import build

launches = 0  # kernel launches (CUDA path only)


def fill_by_priority_plain(quota: torch.Tensor, cap: torch.Tensor,
                           priority: torch.Tensor) -> torch.Tensor:
    """The plain torch version of K2 (CPU path and the kernel's oracle)."""
    order = torch.argsort(priority, stable=True)
    cap_sorted = cap[order]
    before = torch.cumsum(cap_sorted, dim=0, dtype=torch.int32) - cap_sorted
    assigned_sorted = torch.minimum(torch.clamp(quota - before, min=0), cap_sorted)
    return torch.zeros_like(cap).scatter(0, order, assigned_sorted)


def fill_by_priority(quota: torch.Tensor, cap: torch.Tensor,
                     priority: torch.Tensor) -> torch.Tensor:
    """K2 wrapper: i32[N] pods per slot.  ``quota`` is a 0-dim int32 tensor
    on the slots' device; the kernel reads it there (no host sync)."""
    global launches
    if cap.device.type != "cuda":
        return fill_by_priority_plain(quota, cap, priority)
    n = cap.shape[0]
    for name, t, shape in (("quota", quota, ()), ("cap", cap, (n,)), ("priority", priority, (n,))):
        build.check_input(name, t, torch.int32, shape, cap.device)
    lib = build.load("fill_priority")
    if n > lib.kc_fill_priority_max_n():
        raise ValueError(f"fill_priority takes at most {lib.kc_fill_priority_max_n()} slots, got {n}")
    out = torch.empty_like(cap)
    fn = lib.kc_fill_priority
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    rc = fn(n, quota.data_ptr(), cap.data_ptr(), priority.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(cap.device).cuda_stream)
    build.check(rc, "fill_priority")
    launches += 1
    return out
