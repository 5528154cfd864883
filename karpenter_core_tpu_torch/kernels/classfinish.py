"""K15: the compact class rows padded into the bucket on the device.

``finish_class_planes`` is ``finish_class_planes_device`` / ``_cls_finish_fn``
(karpenter_core_tpu/ops/solve.py:2655, :2623): the sixteen ClassTensors
planes of ``prepare_host``, C rows each, padded to the bucket extents the way
``ops.solve.pad_planes``' host branch pads them — padded classes are inert
(mask True, count 0, group "none", ``relax_next`` -1), padded keys undefined
(mask True), new vocabulary slots False before the trailing "unseen" slot,
padded ports False — and every group index at or past the old "none" row
moved to the new one.  The CUDA source is ``csrc/class_finish.cu`` (one
launch for all sixteen planes); ``finish_class_planes_plain`` is its twin.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple

import torch

from karpenter_core_tpu_torch.kernels import build

launches = 0  # kernel launches (CUDA path only)


class Extents(NamedTuple):
    """The bucket targets and the group extents of one finish."""

    c_new: int
    k_new: int
    v_new: int
    g1_old: int
    g1_new: int
    p_new: int


def _specs(cls, ext: Extents):
    """Per plane, in ClassTensors order: (name, the source viewed as
    [C, A, B], the output's [C, A, B], its shape, widen, fill_c, fill_a,
    fill_b, remap)."""
    inf = float("inf")
    out = []
    for name in cls._fields:
        t = getattr(cls, name)
        c = t.shape[0]
        widen, fill_a, fill_b = False, None, None
        if name == "mask":
            view, new, widen = tuple(t.shape), (ext.c_new, ext.k_new, ext.v_new + 1), True
            shape = new
            fill_c = fill_a = True
            fill_b = False
        elif name in ("defined", "negative", "gt", "lt"):
            view, new = (c, t.shape[1], 1), (ext.c_new, ext.k_new, 1)
            shape = (ext.c_new, ext.k_new)
            fill_c = fill_a = {"defined": False, "negative": False, "gt": -inf, "lt": inf}[name]
        else:
            width = t.shape[1] if t.dim() == 2 else 1
            width_new = ext.p_new if name == "ports" else width
            view, new = (c, 1, width), (ext.c_new, 1, width_new)
            shape = (ext.c_new, width_new) if t.dim() == 2 else (ext.c_new,)
            fill_c = {"zone": True, "ct": True, "it": True, "requests": 0.0, "count": 0,
                      "tol": False, "ports": False, "groups": ext.g1_new - 1,
                      "relax_next": -1, "anti_soft": False, "root": 0}[name]
            fill_b = False if name == "ports" else None
        out.append((name, view, new, shape, widen, fill_c, fill_a, fill_b, name == "groups"))
    return out


def _pad3(t3, new, fill_c, fill_a, fill_b, widen):
    c, a, b = t3.shape
    c_new, a_new, b_new = new

    def full(shape, value):
        return torch.full(shape, value, dtype=t3.dtype, device=t3.device)

    if widen and b_new > b:
        t3 = torch.cat([t3[:, :, : b - 1], full((c, a, b_new - b), fill_b), t3[:, :, b - 1:]], 2)
    elif b_new > b:
        t3 = torch.cat([t3, full((c, a, b_new - b), fill_b)], 2)
    if a_new > a:
        t3 = torch.cat([t3, full((c, a_new - a, b_new), fill_a)], 1)
    if c_new > c:
        t3 = torch.cat([t3, full((c_new - c, a_new, b_new), fill_c)], 0)
    return t3


def finish_class_planes_plain(cls, ext: Extents):
    """The plain torch version of K15: the padded planes, in ClassTensors
    order (a tuple)."""
    out = []
    for name, view, new, shape, widen, fill_c, fill_a, fill_b, remap in _specs(cls, ext):
        t = getattr(cls, name)
        if remap:
            t = torch.where(t >= ext.g1_old - 1, torch.full_like(t, ext.g1_new - 1), t)
        out.append(_pad3(t.reshape(view), new, fill_c, fill_a, fill_b, widen).reshape(shape))
    return tuple(out)


def _bits(value, dtype) -> int:
    """A fill value as the int32 bit pattern of one output cell."""
    if value is None:
        return 0
    if dtype == torch.float32:
        return struct.unpack("<i", struct.pack("<f", float(value)))[0]
    return int(value)


def finish_class_planes(cls, ext: Extents):
    """K15 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors.  ``cls`` is a ClassTensors of compact rows."""
    global launches
    dev = cls.count.device
    if dev.type != "cuda":
        return finish_class_planes_plain(cls, ext)
    specs = _specs(cls, ext)
    spec_words, srcs, outs = [], [], []
    for name, view, new, shape, widen, fill_c, fill_a, fill_b, remap in specs:
        t = getattr(cls, name)
        if t.dtype not in (torch.bool, torch.int32, torch.float32):
            raise ValueError(f"class plane {name}: dtype {t.dtype}")
        build.check_input(name, t, t.dtype, tuple(t.shape), dev)
        spec_words += [t.element_size(), *view, *new, int(widen), _bits(fill_c, t.dtype),
                       _bits(fill_a, t.dtype), _bits(fill_b, t.dtype), int(remap),
                       ext.g1_old - 1, ext.g1_new - 1]
        srcs.append(t.data_ptr())
        outs.append(torch.empty(shape, dtype=t.dtype, device=dev))
    n = build.function("class_finish", "kc_class_finish_planes", [])()
    if n != len(specs):
        raise ValueError(f"class_finish takes {n} planes, got {len(specs)}")
    fn = build.function("class_finish", "kc_class_finish", [ctypes.c_void_p] * 4)
    spec_arr = (ctypes.c_int32 * len(spec_words))(*spec_words)
    src_arr = (ctypes.c_void_p * n)(*srcs)
    dst_arr = (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs))
    rc = fn(ctypes.cast(spec_arr, ctypes.c_void_p), ctypes.cast(src_arr, ctypes.c_void_p),
            ctypes.cast(dst_arr, ctypes.c_void_p), build.stream(dev))
    build.check(rc, "class_finish")
    launches += 1
    return tuple(outs)
