"""K19: the what-if studies' sampled interruptions.

``perturb_avail`` is the draw of ``perturb_spot_availability`` and
``perturb_offering_availability`` (karpenter_core_tpu/parallel/mesh.py:397,
:498): every replica's offering availability, bool[R, I, Z, CT], with each
cell interrupted where ``jax.random.uniform(PRNGKey(seed), (R, I, Z, CT))``
falls below its threshold::

    out[r, i, z, c] = avail[i, z, c] & ~(u[r, i, z, c] < rate & is_spot[c])
    out[r, i, z, c] = avail[i, z, c] & ~(u[r, i, z, c] < risk[i, z, c])

the first with a scalar rate (``risk=None``), the second with a per-cell
risk plane.  The CUDA source is ``csrc/perturb_avail.cu``: one launch
computes the threefry draw of every cell on the card.  Its twin,
``perturb_avail_plain``, draws the same uniforms on the host
(``relax.prng.uniform``) and compares in torch.  The wrapper takes the twin
for CPU tensors and launches the kernel for CUDA tensors, never one in
place of the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from karpenter_core_tpu_torch.kernels import build
from karpenter_core_tpu_torch.relax import prng

launches = 0  # kernel launches (CUDA path only)


def perturb_avail_plain(avail: torch.Tensor, n_replicas: int, seed: int,
                        rate: Optional[float] = None, is_spot: Optional[torch.Tensor] = None,
                        risk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of K19: bool[R, I, Z, CT]."""
    shape = (int(n_replicas),) + tuple(avail.shape)
    u = torch.from_numpy(prng.uniform(prng.prng_key(seed), shape)).to(avail.device)
    if risk is None:
        hit = (u < torch.tensor(np.float32(rate), device=avail.device)) & is_spot
    else:
        hit = u < risk
    return avail[None] & ~hit


def perturb_avail(avail: torch.Tensor, n_replicas: int, seed: int,
                  rate: Optional[float] = None, is_spot: Optional[torch.Tensor] = None,
                  risk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K19 wrapper: ``avail`` bool[I, Z, CT]; either ``rate`` (a Python
    float, compared as float32) with ``is_spot`` bool[CT], or ``risk``
    f32[I, Z, CT].  The plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (no fallback between them)."""
    global launches
    if (risk is None) == (rate is None):
        raise ValueError("perturb_avail takes either a rate (with is_spot) or a risk plane")
    dev = avail.device
    if dev.type != "cuda":
        return perturb_avail_plain(avail, n_replicas, seed, rate, is_spot, risk)
    n_it, n_zones, n_ct = avail.shape
    build.check_input("avail", avail, torch.bool, (n_it, n_zones, n_ct), dev)
    if risk is None:
        build.check_input("is_spot", is_spot, torch.bool, (n_ct,), dev)
        mode, thresh, spot_ptr, risk_ptr = 0, float(np.float32(rate)), is_spot.data_ptr(), None
    else:
        build.check_input("risk", risk, torch.float32, (n_it, n_zones, n_ct), dev)
        mode, thresh, spot_ptr, risk_ptr = 1, 0.0, None, risk.data_ptr()
    out = torch.empty((int(n_replicas), n_it, n_zones, n_ct), dtype=torch.bool, device=dev)
    k0, k1 = (int(w) for w in prng.prng_key(seed))
    fn = build.function("perturb_avail", "kc_perturb_avail",
                        [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                                                   ctypes.c_int, ctypes.c_float]
                        + [ctypes.c_void_p] * 5)
    rc = fn(int(n_replicas), n_it * n_zones * n_ct, n_ct, k0, k1, mode, thresh,
            avail.data_ptr(), spot_ptr, risk_ptr, out.data_ptr(), build.stream(dev))
    build.check(rc, "perturb_avail")
    launches += 1
    return out
