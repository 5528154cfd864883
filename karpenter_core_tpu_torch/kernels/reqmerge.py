"""K3: merge one class's requirements into a slot plane, with compatibility.

``merge_compat(node, cls, valid, vocab_ints, is_custom, v, key_has_bounds)``
returns ``(merged ReqTensor [N, K, W], compat bool[N])``: the pair that
``_merge_node_class`` / ``_key_compat_node_class``
(karpenter_core_tpu/ops/solve.py:312-331) compute with ops/masks.py ``add``
and ``compatible``.  ``cls`` is one class row with a leading axis of 1.
The CUDA source is ``csrc/req_merge.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from karpenter_core_tpu_torch.kernels import batch, build
from karpenter_core_tpu_torch.ops import masks as mask_ops

launches = 0  # kernel launches (CUDA path only)


def merge_compat_plain(node, cls, valid, vocab_ints, is_custom, v, key_has_bounds):
    """The plain torch version of K3 (CPU path and the kernel's oracle)."""
    merged = mask_ops.add(node, cls, valid, vocab_ints, v=v, key_has_bounds=key_has_bounds)
    compat = mask_ops.compatible(node, cls, is_custom, vocab_ints, v=v)
    return merged, compat


merge_compat_twin = batch.tenantwise(merge_compat_plain, lambda node, *_: node.mask.dim() == 3)


def merge_compat(node, cls, valid, vocab_ints, is_custom, v, key_has_bounds):
    """K3 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors.  Every operand may carry a leading tenant axis B (rows
    [B, N, K, W], the class row [B, 1, K, W], the vocabulary planes
    [B, K, ...]): one launch covers every tenant."""
    args = (node, cls, valid, vocab_ints, is_custom, v, key_has_bounds)
    if node.mask.device.type != "cuda":
        return merge_compat_twin(*args)
    if node.mask.dim() == 3:
        return batch.drop_axis(_merge_compat_cuda(*batch.add_axis(args)))
    return _merge_compat_cuda(*args)


def _merge_compat_cuda(node, cls, valid, vocab_ints, is_custom, v, key_has_bounds):
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
    merged = mask_ops.ReqTensor(
        torch.empty((n_b, n, n_keys, n_words), dtype=i32, device=dev),
        torch.empty((n_b, n, n_keys), dtype=b, device=dev),
        torch.empty((n_b, n, n_keys), dtype=b, device=dev),
        torch.empty((n_b, n, n_keys), dtype=f32, device=dev),
        torch.empty((n_b, n, n_keys), dtype=f32, device=dev),
    )
    compat = torch.empty((n_b, n), dtype=b, device=dev)
    needs_bounds = int(any(key_has_bounds))
    fn = build.function("req_merge", "kc_req_merge", [ctypes.c_int] * 8 + [ctypes.c_void_p] * 21)
    vw = mask_ops.const_words("vocab", v, dev)
    ptrs = [t.data_ptr() for t in (
        *node, *cls, valid, vw, vocab_ints, is_custom, *merged, compat,
    )]
    rc = fn(n_b, n, n_keys, n_words, n_vocab, (v - 1) // 32, (v - 1) % 32, needs_bounds,
            *ptrs, build.stream(dev))
    build.check(rc, "req_merge")
    launches += 1
    return merged, compat
