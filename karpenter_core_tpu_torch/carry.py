"""Carry the encoded snapshot's kernel inputs into the port's tensors.

The solve has no weights: its state is the encoded snapshot.  These map the
numpy NamedTuples that ``prepare_host`` produces — the port's own, or the
reference package's, matched by field name without importing it — onto the
port's torch NamedTuples on one device, so both packages' ``solve_core`` can
be fed one encoded input.  Bools stay bool, every integer plane becomes
int32 and every float plane float32: the reference's dtypes with x64 off.
"""

from __future__ import annotations

import numpy as np
import torch

from karpenter_core_tpu_torch import device as device_mod
from karpenter_core_tpu_torch.ops import masks as mask_ops
from karpenter_core_tpu_torch.ops import solve as solve_ops


def to_tensor(a, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype == np.bool_:
        dtype = torch.bool
    elif np.issubdtype(arr.dtype, np.integer):
        dtype = torch.int32
    elif np.issubdtype(arr.dtype, np.floating):
        dtype = torch.float32
    else:
        raise TypeError(f"unsupported plane dtype {arr.dtype}")
    if arr.dtype != np.bool_ and arr.dtype.itemsize != 4:
        arr = arr.astype(np.int32 if dtype == torch.int32 else np.float32)
    return torch.as_tensor(np.ascontiguousarray(arr)).to(device=device, dtype=dtype)


def _req(t, device) -> mask_ops.ReqTensor:
    return mask_ops.ReqTensor(*(to_tensor(getattr(t, f), device) for f in mask_ops.ReqTensor._fields))


def _by_name(cls, src, device, req_fields=()):
    return cls(*(
        _req(getattr(src, f), device) if f in req_fields else to_tensor(getattr(src, f), device)
        for f in cls._fields
    ))


def tensors_from_numpy(class_tensors, statics_arrays, key_has_bounds, device=None):
    """(ClassTensors, StaticArrays, key_has_bounds) on ``device`` from the
    numpy ``prepare_host`` output (``device=None`` means CUDA)."""
    dev = device_mod.resolve(device)
    cls = _by_name(solve_ops.ClassTensors, class_tensors, dev)
    sa = _by_name(solve_ops.StaticArrays, statics_arrays, dev, req_fields=("it", "tmpl"))
    return cls, sa, tuple(bool(b) for b in key_has_bounds)


def existing_from_numpy(ex_state, ex_static, device=None):
    """(ExistingState, ExistingStatic) on ``device`` from numpy planes."""
    dev = device_mod.resolve(device)
    return (
        _by_name(solve_ops.ExistingState, ex_state, dev),
        _by_name(solve_ops.ExistingStatic, ex_static, dev),
    )
