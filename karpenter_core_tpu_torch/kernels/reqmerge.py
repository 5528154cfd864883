"""K3: merge one class's requirements into a row plane, with compatibility.

``merge_compat(node, cls, valid, vocab_ints, is_custom, v, key_has_bounds)``
returns ``(merged ReqTensor [N, K, W], compat bool[N])``: the pair that
``_merge_node_class`` / ``_key_compat_node_class``
(karpenter_core_tpu/ops/solve.py:312-331) compute with ops/masks.py ``add``
and ``compatible``.  ``cls`` is one class row with a leading axis of 1.
``req_compat`` (same operands) is the second entry point: ``compat`` alone,
for the existing rows, whose merge K6's commit takes over for the rows it
selects (``ClassMerge`` carries the operands it needs).
The CUDA source is ``csrc/req_merge.cu``, its row code ``csrc/req_merge.cuh``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from karpenter_core_tpu_torch.kernels import batch, build
from karpenter_core_tpu_torch.ops import masks as mask_ops

launches = 0  # kernel launches, both entry points (CUDA path only)


class ClassMerge(NamedTuple):
    """What a merge of rows with one class needs besides the rows: the class
    row (leading axis of 1), the valid words, the vocabulary ints, the slot
    count and the per-key bounds flags (``mask_ops.add``'s operands)."""

    cls: mask_ops.ReqTensor
    valid: torch.Tensor
    vocab_ints: torch.Tensor
    v: int
    key_has_bounds: Tuple[bool, ...]


def merge_plain(rows, m: ClassMerge) -> mask_ops.ReqTensor:
    """``rows`` merged with the class (ops/masks.py ``add``)."""
    return mask_ops.add(rows, m.cls, m.valid, m.vocab_ints, v=m.v,
                        key_has_bounds=m.key_has_bounds)


def merge_compat_plain(node, cls, valid, vocab_ints, is_custom, v, key_has_bounds):
    """The plain torch version of K3 (CPU path and the kernel's oracle)."""
    merged = mask_ops.add(node, cls, valid, vocab_ints, v=v, key_has_bounds=key_has_bounds)
    compat = mask_ops.compatible(node, cls, is_custom, vocab_ints, v=v)
    return merged, compat


merge_compat_twin = batch.tenantwise(merge_compat_plain, lambda node, *_: node.mask.dim() == 3)


def req_compat_plain(node, cls, valid, vocab_ints, is_custom, v, key_has_bounds):
    """The plain torch version of K3's compat entry point."""
    return mask_ops.compatible(node, cls, is_custom, vocab_ints, v=v)


req_compat_twin = batch.tenantwise(req_compat_plain, lambda node, *_: node.mask.dim() == 3)


def merge_compat(node, cls, valid, vocab_ints, is_custom, v, key_has_bounds):
    """K3 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors.  Every operand may carry a leading tenant axis B (rows
    [B, N, K, W], the class row [B, 1, K, W], the vocabulary planes
    [B, K, ...]): one launch covers every tenant."""
    args = (node, cls, valid, vocab_ints, is_custom, v, key_has_bounds)
    if node.mask.device.type != "cuda":
        return merge_compat_twin(*args)
    if node.mask.dim() == 3:
        return batch.drop_axis(_launch(*batch.add_axis(args), merge=True))
    return _launch(*args, merge=True)


def req_compat(node, cls, valid, vocab_ints, is_custom, v, key_has_bounds):
    """K3 wrapper, compat entry point: ``compat`` alone (no merged planes),
    with the operands and tenant axis of ``merge_compat``."""
    args = (node, cls, valid, vocab_ints, is_custom, v, key_has_bounds)
    if node.mask.device.type != "cuda":
        return req_compat_twin(*args)
    if node.mask.dim() == 3:
        return batch.drop_axis(_launch(*batch.add_axis(args), merge=False))
    return _launch(*args, merge=False)


def _launch(node, cls, valid, vocab_ints, is_custom, v, key_has_bounds, merge: bool):
    global launches
    dev = node.mask.device
    n_b, n, n_keys, n_words = node.mask.shape
    n_vocab = vocab_ints.shape[-1]
    b, i32, f32 = torch.bool, torch.int32, torch.float32
    for name, t, dt, shape in (
        ("node.mask", node.mask, i32, (n_b, n, n_keys, n_words)),
        ("node.defined", node.defined, b, (n_b, n, n_keys)),
        ("node.negative", node.negative, b, (n_b, n, n_keys)),
        ("node.gt", node.gt, f32, (n_b, n, n_keys)), ("node.lt", node.lt, f32, (n_b, n, n_keys)),
        ("cls.mask", cls.mask, i32, (n_b, 1, n_keys, n_words)),
        ("cls.defined", cls.defined, b, (n_b, 1, n_keys)),
        ("cls.negative", cls.negative, b, (n_b, 1, n_keys)),
        ("cls.gt", cls.gt, f32, (n_b, 1, n_keys)), ("cls.lt", cls.lt, f32, (n_b, 1, n_keys)),
        ("valid", valid, i32, (n_b, n_keys, n_words)),
        ("vocab_ints", vocab_ints, f32, (n_b, n_keys, n_vocab)),
        ("is_custom", is_custom, b, (n_b, n_keys)),
    ):
        build.check_input(name, t, dt, shape, dev)
    if mask_ops.words_for(v) != n_words:
        raise ValueError(f"mask width {n_words} words does not hold v={v} slots")
    compat = torch.empty((n_b, n), dtype=b, device=dev)
    vw = mask_ops.const_words("vocab", v, dev)
    ptrs = [t.data_ptr() for t in (*node, *cls, valid, vw, vocab_ints, is_custom)]
    shape = (n_b, n, n_keys, n_words, n_vocab, (v - 1) // 32, (v - 1) % 32)
    if not merge:
        fn = build.function("req_merge", "kc_req_compat",
                            [ctypes.c_int] * 7 + [ctypes.c_void_p] * 16)
        build.check(fn(*shape, *ptrs, compat.data_ptr(), build.stream(dev)), "req_merge (compat)")
        launches += 1
        return compat
    merged = mask_ops.ReqTensor(
        torch.empty((n_b, n, n_keys, n_words), dtype=i32, device=dev),
        torch.empty((n_b, n, n_keys), dtype=b, device=dev),
        torch.empty((n_b, n, n_keys), dtype=b, device=dev),
        torch.empty((n_b, n, n_keys), dtype=f32, device=dev),
        torch.empty((n_b, n, n_keys), dtype=f32, device=dev),
    )
    fn = build.function("req_merge", "kc_req_merge", [ctypes.c_int] * 8 + [ctypes.c_void_p] * 21)
    rc = fn(*shape, int(any(key_has_bounds)), *ptrs, *(t.data_ptr() for t in merged),
            compat.data_ptr(), build.stream(dev))
    build.check(rc, "req_merge")
    launches += 1
    return merged, compat
