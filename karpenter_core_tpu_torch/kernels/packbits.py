"""K4: bit-pack bool planes for the device-to-host decode fetch.

``pack_bool(arr)`` is ``pack_bool`` (karpenter_core_tpu/ops/solve.py:2121):
uint8[..., ceil(M/8)], most significant bit first; ``unpack_bool`` is its
host-side numpy inverse.  The CUDA source is ``csrc/pack_bool.cu``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from karpenter_core_tpu_torch.kernels import build

launches = 0  # kernel launches (CUDA path only)

_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_bool_plain(arr: torch.Tensor) -> torch.Tensor:
    """The plain torch version of K4 (CPU path and the kernel's oracle)."""
    m = arr.shape[-1]
    pad = (-m) % 8
    if pad:
        arr = torch.cat(
            [arr, torch.zeros(arr.shape[:-1] + (pad,), dtype=torch.bool, device=arr.device)],
            dim=-1,
        )
    grouped = arr.reshape(arr.shape[:-1] + (-1, 8)).to(torch.uint8)
    weights = torch.tensor(_WEIGHTS, dtype=torch.uint8, device=arr.device)
    return (grouped * weights).sum(dim=-1, dtype=torch.uint8)


def pack_bool(arr: torch.Tensor) -> torch.Tensor:
    """K4 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors."""
    global launches
    if arr.device.type != "cuda":
        return pack_bool_plain(arr)
    build.check_input("arr", arr, torch.bool, (None,) * arr.dim(), arr.device)
    m = arr.shape[-1]
    n_rows = arr.numel() // m if m else 0
    out = torch.empty(arr.shape[:-1] + ((m + 7) // 8,), dtype=torch.uint8, device=arr.device)
    lib = build.load("pack_bool")
    fn = lib.kc_pack_bool
    fn.argtypes = [ctypes.c_int64, ctypes.c_int] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    rc = fn(n_rows, m, arr.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(arr.device).cuda_stream)
    build.check(rc, "pack_bool")
    launches += 1
    return out


def unpack_bool(packed: np.ndarray, m: int) -> np.ndarray:
    """Host-side inverse of pack_bool."""
    bits = np.unpackbits(packed, axis=-1)
    return bits[..., :m].astype(bool)
