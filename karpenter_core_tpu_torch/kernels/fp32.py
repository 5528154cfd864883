"""A correctly rounded float32 fused multiply-add for the plain twins.

XLA's CPU code contracts some ``a * b + c`` into one FMA (one rounding), and
the kernels that must match it use ``__fmaf_rn``.  Eager torch has no float32
FMA, so the twins compute it in float64 and round once more to float32.  That
second rounding is a double rounding and can land on the wrong side of a
float32 midpoint, so ``fma_f32`` rounds to odd first: with ``p = a * b``
(exact in float64: two 24-bit significands need 48 bits) and ``s = p + c``
rounded to nearest, TwoSum gives the exact error ``err = (p + c) - s``; where
``err`` is not 0 and ``s`` has an even last bit, ``s`` moves one float64 step
towards ``err``.  That is ``p + c`` rounded to odd at 53 bits, and rounding a
53-bit round-to-odd value to 24 bits gives the correctly rounded result
(53 >= 24 + 2), which is what ``__fmaf_rn`` returns.
"""

from __future__ import annotations

import torch


def fma_f32(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (inputs float32 tensors or
    Python numbers, broadcast together)."""
    a64, b64, c64 = (torch.as_tensor(x).double() for x in (a, b, c))
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    fix = torch.isfinite(s) & torch.isfinite(err) & (err != 0) & even
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where(fix, torch.nextafter(s, toward), s).float()
