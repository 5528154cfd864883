"""Carry the encoded snapshot's kernel inputs into the port's tensors.

The solve has no weights: its state is the encoded snapshot.  These map the
numpy NamedTuples that ``prepare_host`` produces — the port's own, or the
reference package's, matched by field name without importing it — onto the
port's torch NamedTuples on one device, so both packages' ``solve_core`` can
be fed one encoded input.  Bools stay bool, every integer plane becomes
int32 and every float plane float32: the reference's dtypes with x64 off.
Packed mask words (uint32 in the reference) keep their bits as int32.
"""

from __future__ import annotations

import numpy as np
import torch

from karpenter_core_tpu_torch import device as device_mod
from karpenter_core_tpu_torch.ops import masks as mask_ops
from karpenter_core_tpu_torch.ops import objective as objective_ops
from karpenter_core_tpu_torch.ops import solve as solve_ops
from karpenter_core_tpu_torch.policy.planes import ObjectivePlanes


def to_tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # a plane already finished on a device
        return a.to(device)
    arr = np.asarray(a)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)  # packed mask words keep their bits
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
    return torch.as_tensor(np.ascontiguousarray(arr)).to(device=device, dtype=dtype).reshape(
        arr.shape)


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


def warm_carry_from_numpy(carry, device=None) -> solve_ops.WarmCarry:
    """The port's ``WarmCarry`` on ``device`` from a reference ``WarmCarry``
    fetched as numpy (``jax.device_get``), its masks packed as they are."""
    dev = device_mod.resolve(device)
    return solve_ops.WarmCarry(
        state=_by_name(solve_ops.NodeState, carry.state, dev),
        ex_state=_by_name(solve_ops.ExistingState, carry.ex_state, dev),
        topo=_by_name(solve_ops.TopoCounts, carry.topo, dev),
        remaining=to_tensor(carry.remaining, dev),
    )


def objective_planes_from_numpy(planes, device=None) -> ObjectivePlanes:
    """The port's ``ObjectivePlanes`` as f32 tensors on ``device`` from
    numpy price / risk / throughput planes (either package's
    ``ObjectivePlanes``, matched by field name)."""
    dev = device_mod.resolve(device)
    return ObjectivePlanes(*(to_tensor(getattr(planes, f), dev) for f in ObjectivePlanes._fields))


def weights_from_config(config) -> objective_ops.ObjectiveWeights:
    """K13's weights from either package's ``PolicyConfig`` (its knobs read
    by name, rounded to float32 as the reference's ``weights_of`` does)."""
    return objective_ops.weights_of(config)
