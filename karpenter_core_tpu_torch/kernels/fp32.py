"""Float32 arithmetic in XLA's CPU order, for the plain twins.

``fma_f32``: a correctly rounded float32 fused multiply-add.

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

``cumsum_xla_plain``: ``jnp.cumsum`` of float32 rows as XLA's CPU code
computes it.  Up to 16 elements it is the sequential sum.  Past 16, XLA
rewrites the scan into a blocked one of base 16 (its HLO shows a
``reduce-window`` of size 16 over the row padded to a multiple of 16, then a
window over the block totals): each block of 16 is summed in order from
+0.0, the block totals get the same scan (recursively, once there are more
than 16 of them), and each block's exclusive prefix (+0.0 for the first) is
added to its elements.  Held bit for bit against ``jax.jit(jnp.cumsum)`` at
lengths 1-40, 255-257, 3,000 and 4,097 with values across 2^-20 .. 2^20
(tests/test_torch_relax.py); a sequential f32 scan differs from it in most
elements past 16.  The relax family's simplex projection (K16) sums in this
order.

``tree_sum_plain``: ``jnp.sum`` of float32 rows as XLA's CPU code computes
it (its tree-reduction rewrite: a reduce-window of 32, then a reduce).
While a row is longer than 32, it is padded with zeros evenly at both ends
to a multiple of 32 and each window of 32 is summed in order from +0.0;
the last row of at most 32 is summed in order from +0.0.  K13's fleet sums
and K20's replica costs take this order.
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


CUMSUM_BLOCK = 16  # XLA's CPU scan block
WINDOW = 32  # XLA's CPU tree-reduction window


def _block_scan(x: torch.Tensor) -> torch.Tensor:
    """Sequential inclusive float32 scan of the last axis, begun at +0.0."""
    out = torch.empty_like(x)
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
        out[..., j] = acc
    return out


def cumsum_xla_plain(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 cumsum of the last axis in XLA's CPU order (module
    doc)."""
    n = x.shape[-1]
    if n <= CUMSUM_BLOCK:
        return _block_scan(x)
    nb = -(-n // CUMSUM_BLOCK)
    pad = torch.zeros(x.shape[:-1] + (nb * CUMSUM_BLOCK - n,), dtype=x.dtype, device=x.device)
    within = _block_scan(torch.cat([x, pad], dim=-1).reshape(x.shape[:-1] + (nb, CUMSUM_BLOCK)))
    inclusive = cumsum_xla_plain(within[..., -1])
    exclusive = torch.cat([torch.zeros_like(inclusive[..., :1]), inclusive[..., :-1]], dim=-1)
    out = exclusive[..., None] + within
    return out.reshape(x.shape[:-1] + (nb * CUMSUM_BLOCK,))[..., :n]


def tree_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """The float32 sum of the last axis in XLA's CPU tree order (module
    doc); leading axes are independent rows."""
    rows = x.shape[:-1]
    while x.shape[-1] > WINDOW:
        n = x.shape[-1]
        pad = -(-n // WINDOW) * WINDOW - n
        lo = pad // 2
        # padding adds +0.0, which leaves a sum started at +0.0 unchanged
        zeros = torch.zeros(rows + (pad,), dtype=torch.float32, device=x.device)
        x = torch.cat([zeros[..., :lo], x, zeros[..., lo:]], dim=-1)
        x = x.reshape(rows + (-1, WINDOW))
        acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
        for k in range(WINDOW):
            acc = acc + x[..., k]
        x = acc
    acc = torch.zeros(rows, dtype=torch.float32, device=x.device)
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
    return acc
