"""K10-K12: the warm repair's eviction free, window gather and window scatter.

A warm-start repair (``solver.incremental``) resumes the class scan from the
previous solve's final carry instead of empty slots.  Before it runs, three
device programs of karpenter_core_tpu/ops/solve.py reshape the carry:

``repair_free`` (K10, ``csrc/repair_free.cu``) is ``_repair_free_impl``
(:1960): evicted pods' capacity and counts go back to the carry, on the new
slots and the existing nodes alike::

    used[n]      -= sum_c free[c, n] * req[c]        (f32, one FMA a class, in order)
    pod_count[n]  = max(pod_count[n] - sum_c free[c, n], 0)
    fwd[g, n]     = max(fwd[g, n] - sum_c member[c, g] * free[c, n], 0)
    inv[g, n]     = max(inv[g, n] - sum_c own_inv[c, g] * free[c, n], 0)

``gather_window`` (K11, ``csrc/repair_gather.cu``) is
``gather_repair_window`` (:2016): the S rows ``idx`` of every per-slot plane
and the S columns of the new-slot topology counts, the window's ``n_next``
(= ``n_open_w``), and the [G1, Z] zone counts of every open slot outside the
window, which the windowed repair adds back as constants::

    excl[n]  = open_[n] & n not in idx;  zone_i[n, z] = zone[n, z] & excl[n]
    sing     = zone_i on rows whose zone sum is 1, else 0
    bases    = (fwd @ sing, fwd @ zone_i, inv @ zone_i)          (int32)

``scatter_window`` (K12, ``csrc/repair_scatter.cu``) is
``_scatter_repair_window_impl`` (:2070): the window's rows and columns
written back over a copy of the full-width planes, and ``n_next`` advanced
by the fresh slots the repair opened.

The per-slot planes travel as a tuple in ``ROW_PLANES`` order (NodeState's
fields but ``n_next``).  ``idx`` holds unique slot indices in [0, N); a
wrapper cannot check that without reading the device, so it does not.  The
f32 sum of K10 is XLA's CPU dot behind the reference's einsum: from 0, one
fused multiply-add a class, classes ascending (``fma_f32`` in the twin,
``__fmaf_rn`` in the kernel), so the three agree bit for bit; every int32
sum wraps as the reference's does.

``repair_free(..., inplace=True)`` (K21, ``kc_repair_free_inplace``) and
``scatter_window(..., inplace=True)`` (K22, ``kc_repair_scatter_inplace``)
are the reference's donated twins, ``repair_free_donated`` (:2012) and
``scatter_repair_window_donated`` (:2115): the same functions written into
the carry's own tensors, which they return.  K21 is K10 with each output
its input; K22 writes only the window's S rows and columns (and
``n_next``) into the full-width planes, where K12 copies all N.  The
planes they write must not share storage with one another (checked); the
caller must not read the carry as it was.

Each wrapper runs its plain torch twin for CPU tensors and launches its
kernel for CUDA tensors; the twins are the CPU path and the kernels' oracle.
The out-of-place wrappers write into no tensor they were given.
"""

from __future__ import annotations

import ctypes

import torch

from karpenter_core_tpu_torch.kernels import build
from karpenter_core_tpu_torch.kernels.fp32 import fma_f32

I32 = torch.int32
F32 = torch.float32

ROW_PLANES = ("used", "kmask", "kdef", "kneg", "kgt", "klt", "zone", "ct", "viable", "ports",
              "pod_count", "tmpl_id", "open_")
_ZONE, _POD_COUNT, _OPEN = 6, 10, 12
MAX_ZONES = 8  # K11 keeps a thread's zone sums in registers
MAX_BITMAP_SLOTS = 32 * 1024 * 8  # K11's window bitmap lives in 32 KB of shared memory

free_launches = 0  # K10 launches (CUDA path only)
gather_launches = 0  # K11 launches (CUDA path only)
scatter_launches = 0  # K12 launches (CUDA path only)
free_inplace_launches = 0  # K21 launches (CUDA path only)
scatter_inplace_launches = 0  # K22 launches (CUDA path only)

_K10_ARGS = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 22
_K21_ARGS = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 14
_K11_ARGS = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
             + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 12)
_K12_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 11
_K22_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 8


def _row_bytes(t: torch.Tensor) -> int:
    return (t.numel() // t.shape[0]) * t.element_size() if t.shape[0] else 0


def _check_distinct(label: str, tensors) -> None:
    """Raise when two of the planes an in-place kernel writes share storage:
    each would then be written twice."""
    seen = {}
    for name, t in tensors:
        if t.numel() == 0:
            continue
        ptr = t.untyped_storage().data_ptr()
        if ptr in seen:
            raise ValueError(f"{label}: {name} shares storage with {seen[ptr]}; an in-place "
                             "update needs planes of their own")
        seen[ptr] = name


# -- K10 ------------------------------------------------------------------------


def _free_side_plain(used, pod_count, fwd, inv, free, requests, member, own_inv):
    s = torch.zeros_like(used)
    freed = torch.zeros_like(pod_count)
    fwd_sub = torch.zeros_like(fwd)
    inv_sub = torch.zeros_like(inv)
    for c in range(free.shape[0]):
        f = free[c]
        s = fma_f32(f.to(F32)[:, None], requests[c][None, :], s)
        freed = freed + f
        fwd_sub = fwd_sub + member[c][:, None] * f[None, :]
        inv_sub = inv_sub + own_inv[c][:, None] * f[None, :]
    return (used - s, torch.clamp(pod_count - freed, min=0), torch.clamp(fwd - fwd_sub, min=0),
            torch.clamp(inv - inv_sub, min=0))


def repair_free_plain(used_new, pod_count_new, fwd_new, inv_new, used_ex, pod_count_ex,
                      fwd_ex, inv_ex, free_new, free_ex, requests, member, own_inv):
    """The plain torch version of K10: (used_new, pod_count_new, fwd_new,
    inv_new, used_ex, pod_count_ex, fwd_ex, inv_ex) after the free."""
    return (
        _free_side_plain(used_new, pod_count_new, fwd_new, inv_new, free_new, requests, member,
                         own_inv)
        + _free_side_plain(used_ex, pod_count_ex, fwd_ex, inv_ex, free_ex, requests, member,
                           own_inv)
    )


def _free_side_inplace_plain(used, pod_count, fwd, inv, free, requests, member, own_inv):
    s = torch.zeros_like(used)
    freed = torch.zeros_like(pod_count)
    fwd_sub = torch.zeros_like(fwd)
    inv_sub = torch.zeros_like(inv)
    for c in range(free.shape[0]):
        f = free[c]
        s = fma_f32(f.to(F32)[:, None], requests[c][None, :], s)
        freed += f
        fwd_sub += member[c][:, None] * f[None, :]
        inv_sub += own_inv[c][:, None] * f[None, :]
    used.sub_(s)
    pod_count.sub_(freed).clamp_min_(0)
    fwd.sub_(fwd_sub).clamp_min_(0)
    inv.sub_(inv_sub).clamp_min_(0)
    return used, pod_count, fwd, inv


def repair_free_inplace_plain(used_new, pod_count_new, fwd_new, inv_new, used_ex, pod_count_ex,
                              fwd_ex, inv_ex, free_new, free_ex, requests, member, own_inv):
    """The plain torch version of K21: K10's free written into the eight
    carry planes it was given (in-place ops), which it returns."""
    return (
        _free_side_inplace_plain(used_new, pod_count_new, fwd_new, inv_new, free_new, requests,
                                 member, own_inv)
        + _free_side_inplace_plain(used_ex, pod_count_ex, fwd_ex, inv_ex, free_ex, requests,
                                   member, own_inv)
    )


_FREE_PLANES = ("used_new", "pod_count_new", "fwd_new", "inv_new", "used_ex", "pod_count_ex",
                "fwd_ex", "inv_ex")


def repair_free(used_new, pod_count_new, fwd_new, inv_new, used_ex, pod_count_ex, fwd_ex,
                inv_ex, free_new, free_ex, requests, member, own_inv, inplace: bool = False):
    """K10 wrapper (K21 with ``inplace=True``: the eight carry planes are
    freed where they lie and returned): the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (no fallback between them)."""
    global free_launches, free_inplace_launches
    dev = used_new.device
    carry_planes = (used_new, pod_count_new, fwd_new, inv_new, used_ex, pod_count_ex, fwd_ex,
                    inv_ex)
    if inplace:
        _check_distinct("repair_free", zip(_FREE_PLANES, carry_planes))
    if dev.type != "cuda":
        twin = repair_free_inplace_plain if inplace else repair_free_plain
        return twin(*carry_planes, free_new, free_ex, requests, member, own_inv)
    n_new, n_res = used_new.shape
    n_ex = used_ex.shape[0]
    n_cls, g1 = member.shape
    for name, t, dt, shape in (
        ("used_new", used_new, F32, (n_new, n_res)), ("pod_count_new", pod_count_new, I32, (n_new,)),
        ("fwd_new", fwd_new, I32, (g1, n_new)), ("inv_new", inv_new, I32, (g1, n_new)),
        ("used_ex", used_ex, F32, (n_ex, n_res)), ("pod_count_ex", pod_count_ex, I32, (n_ex,)),
        ("fwd_ex", fwd_ex, I32, (g1, n_ex)), ("inv_ex", inv_ex, I32, (g1, n_ex)),
        ("free_new", free_new, I32, (n_cls, n_new)), ("free_ex", free_ex, I32, (n_cls, n_ex)),
        ("requests", requests, F32, (n_cls, n_res)), ("member", member, I32, (n_cls, g1)),
        ("own_inv", own_inv, I32, (n_cls, g1)),
    ):
        build.check_input(name, t, dt, shape, dev)
    if inplace:
        fn = build.function("repair_free", "kc_repair_free_inplace", _K21_ARGS)
        ptrs = [t.data_ptr() for t in (
            requests, member, own_inv, free_new, used_new, pod_count_new, fwd_new, inv_new,
            free_ex, used_ex, pod_count_ex, fwd_ex, inv_ex,
        )]
        rc = fn(n_new, n_ex, n_cls, n_res, g1, *ptrs, build.stream(dev))
        build.check(rc, "repair_free_inplace")
        free_inplace_launches += 1
        return carry_planes
    outs = [torch.empty_like(t) for t in carry_planes]
    fn = build.function("repair_free", "kc_repair_free", _K10_ARGS)
    ptrs = [t.data_ptr() for t in (
        requests, member, own_inv, free_new, used_new, pod_count_new, fwd_new, inv_new,
        free_ex, used_ex, pod_count_ex, fwd_ex, inv_ex, *outs,
    )]
    rc = fn(n_new, n_ex, n_cls, n_res, g1, *ptrs, build.stream(dev))
    build.check(rc, "repair_free")
    free_launches += 1
    return tuple(outs)


# -- K11 ------------------------------------------------------------------------


def _zone_counts(counts: torch.Tensor, zone_i: torch.Tensor) -> torch.Tensor:
    """i32[G1, Z] = counts @ zone_i as an int32 broadcast-multiply-sum."""
    return (counts[:, :, None] * zone_i[None, :, :]).sum(dim=1, dtype=I32)


def gather_window_plain(rows, fwd_new, inv_new, idx, n_open_w: int):
    """The plain torch version of K11: (window rows in ROW_PLANES order,
    n_next i32[], fwd_w i32[G1, S], inv_w i32[G1, S], (base_fwd_sing,
    base_fwd_full, base_inv_full) i32[G1, Z])."""
    at = idx.long()
    w_rows = tuple(p.index_select(0, at) for p in rows)
    n_slots = rows[_POD_COUNT].shape[0]
    in_window = torch.zeros(n_slots, dtype=torch.bool, device=idx.device).index_fill(0, at, True)
    excl = rows[_OPEN] & ~in_window
    zone_i = rows[_ZONE].to(I32) * excl.to(I32)[:, None]
    sing = torch.where(zone_i.sum(dim=-1, dtype=I32)[:, None] == 1, zone_i, 0)
    bases = (_zone_counts(fwd_new, sing), _zone_counts(fwd_new, zone_i),
             _zone_counts(inv_new, zone_i))
    n_next = torch.full((), n_open_w, dtype=I32, device=idx.device)
    return w_rows, n_next, fwd_new.index_select(1, at), inv_new.index_select(1, at), bases


def _check_rows(rows, n, dev, label):
    if len(rows) != len(ROW_PLANES):
        raise ValueError(f"{label}: {len(rows)} row planes, expected {len(ROW_PLANES)}")
    for name, t in zip(ROW_PLANES, rows):
        if t.device != dev or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"{label}.{name}: shape {tuple(t.shape)} on {t.device}, expected "
                             f"{n} contiguous rows on {dev}")


def gather_window(rows, fwd_new, inv_new, idx, n_open_w: int):
    """K11 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (no fallback between them)."""
    global gather_launches
    dev = idx.device
    if dev.type != "cuda":
        return gather_window_plain(rows, fwd_new, inv_new, idx, n_open_w)
    n_slots = rows[_POD_COUNT].shape[0]
    n_window = idx.shape[0]
    g1 = fwd_new.shape[0]
    n_zones = rows[_ZONE].shape[1]
    _check_rows(rows, n_slots, dev, "rows")
    for name, t, dt, shape in (
        ("zone", rows[_ZONE], torch.bool, (n_slots, n_zones)),
        ("open_", rows[_OPEN], torch.bool, (n_slots,)),
        ("fwd_new", fwd_new, I32, (g1, n_slots)), ("inv_new", inv_new, I32, (g1, n_slots)),
        ("idx", idx, I32, (n_window,)),
    ):
        build.check_input(name, t, dt, shape, dev)
    if n_zones > MAX_ZONES or n_slots > MAX_BITMAP_SLOTS:
        raise ValueError(f"gather_window takes Z <= {MAX_ZONES} and N <= {MAX_BITMAP_SLOTS}")
    w_rows = tuple(torch.empty((n_window,) + tuple(p.shape[1:]), dtype=p.dtype, device=dev)
                   for p in rows)
    n_next = torch.empty((), dtype=I32, device=dev)
    fwd_w = torch.empty((g1, n_window), dtype=I32, device=dev)
    inv_w = torch.empty((g1, n_window), dtype=I32, device=dev)
    bases = tuple(torch.empty((g1, n_zones), dtype=I32, device=dev) for _ in range(3))
    n_planes = len(rows)
    fn = build.function("repair_gather", "kc_repair_gather", _K11_ARGS)
    srcs = (ctypes.c_void_p * n_planes)(*[p.data_ptr() for p in rows])
    dsts = (ctypes.c_void_p * n_planes)(*[p.data_ptr() for p in w_rows])
    row_bytes = (ctypes.c_int * n_planes)(*[_row_bytes(p) for p in rows])
    rc = fn(n_planes, srcs, dsts, row_bytes, n_slots, n_window, g1, n_zones, int(n_open_w),
            idx.data_ptr(), fwd_new.data_ptr(), inv_new.data_ptr(), rows[_ZONE].data_ptr(),
            rows[_OPEN].data_ptr(), n_next.data_ptr(), fwd_w.data_ptr(), inv_w.data_ptr(),
            *(b.data_ptr() for b in bases), build.stream(dev))
    build.check(rc, "repair_gather")
    gather_launches += 1
    return w_rows, n_next, fwd_w, inv_w, bases


# -- K12 ------------------------------------------------------------------------


def scatter_window_plain(rows, fwd_new, inv_new, n_next, w_rows, w_fwd, w_inv, w_n_next, idx,
                         n_open_w: int):
    """The plain torch version of K12: (rows in ROW_PLANES order, fwd_new,
    inv_new, n_next) of the full-width carry with the window written back."""
    at = idx.long()
    out_rows = tuple(p.index_copy(0, at, w) for p, w in zip(rows, w_rows))
    return (out_rows, fwd_new.index_copy(1, at, w_fwd), inv_new.index_copy(1, at, w_inv),
            n_next + (w_n_next - n_open_w))


def scatter_window_inplace_plain(rows, fwd_new, inv_new, n_next, w_rows, w_fwd, w_inv,
                                 w_n_next, idx, n_open_w: int):
    """The plain torch version of K22: the window written into the
    full-width planes it was given (``index_copy_`` on dim 0 and dim 1,
    ``n_next`` advanced in place), which it returns."""
    at = idx.long()
    for p, w in zip(rows, w_rows):
        p.index_copy_(0, at, w)
    fwd_new.index_copy_(1, at, w_fwd)
    inv_new.index_copy_(1, at, w_inv)
    n_next.add_(w_n_next - n_open_w)
    return tuple(rows), fwd_new, inv_new, n_next


def scatter_window(rows, fwd_new, inv_new, n_next, w_rows, w_fwd, w_inv, w_n_next, idx,
                   n_open_w: int, inplace: bool = False):
    """K12 wrapper (K22 with ``inplace=True``: the window goes into the
    full-width planes given, which are returned): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (no fallback between them)."""
    global scatter_launches, scatter_inplace_launches
    dev = idx.device
    if inplace:
        _check_distinct("scatter_window", list(zip(ROW_PLANES, rows))
                        + [("fwd_new", fwd_new), ("inv_new", inv_new), ("n_next", n_next)])
    if dev.type != "cuda":
        twin = scatter_window_inplace_plain if inplace else scatter_window_plain
        return twin(rows, fwd_new, inv_new, n_next, w_rows, w_fwd, w_inv, w_n_next, idx,
                    n_open_w)
    n_slots = rows[_POD_COUNT].shape[0]
    n_window = idx.shape[0]
    g1 = fwd_new.shape[0]
    _check_rows(rows, n_slots, dev, "rows")
    _check_rows(w_rows, n_window, dev, "window rows")
    for p, w, name in zip(rows, w_rows, ROW_PLANES):
        if p.dtype != w.dtype or p.shape[1:] != w.shape[1:]:
            raise ValueError(f"window row plane {name} does not match the full-width plane")
    for name, t, dt, shape in (
        ("fwd_new", fwd_new, I32, (g1, n_slots)), ("inv_new", inv_new, I32, (g1, n_slots)),
        ("n_next", n_next, I32, ()), ("w_fwd", w_fwd, I32, (g1, n_window)),
        ("w_inv", w_inv, I32, (g1, n_window)), ("w_n_next", w_n_next, I32, ()),
        ("idx", idx, I32, (n_window,)),
    ):
        build.check_input(name, t, dt, shape, dev)
    n_planes = len(rows)
    row_bytes = (ctypes.c_int * n_planes)(*[_row_bytes(p) for p in rows])
    wins = (ctypes.c_void_p * n_planes)(*[p.data_ptr() for p in w_rows])
    if inplace:
        fn = build.function("repair_scatter", "kc_repair_scatter_inplace", _K22_ARGS)
        fulls = (ctypes.c_void_p * n_planes)(*[p.data_ptr() for p in rows])
        rc = fn(n_planes, fulls, wins, row_bytes, n_slots, n_window, g1, int(n_open_w),
                idx.data_ptr(), fwd_new.data_ptr(), inv_new.data_ptr(), n_next.data_ptr(),
                w_fwd.data_ptr(), w_inv.data_ptr(), w_n_next.data_ptr(), build.stream(dev))
        build.check(rc, "repair_scatter_inplace")
        scatter_inplace_launches += 1
        return tuple(rows), fwd_new, inv_new, n_next
    out_rows = tuple(torch.empty_like(p) for p in rows)
    fwd_out = torch.empty_like(fwd_new)
    inv_out = torch.empty_like(inv_new)
    n_next_out = torch.empty_like(n_next)
    fn = build.function("repair_scatter", "kc_repair_scatter", _K12_ARGS)
    fulls = (ctypes.c_void_p * n_planes)(*[p.data_ptr() for p in rows])
    dsts = (ctypes.c_void_p * n_planes)(*[p.data_ptr() for p in out_rows])
    rc = fn(n_planes, fulls, wins, dsts, row_bytes, n_slots, n_window, g1, int(n_open_w),
            idx.data_ptr(), fwd_new.data_ptr(), inv_new.data_ptr(), n_next.data_ptr(),
            w_fwd.data_ptr(), w_inv.data_ptr(), w_n_next.data_ptr(), fwd_out.data_ptr(),
            inv_out.data_ptr(), n_next_out.data_ptr(), build.stream(dev))
    build.check(rc, "repair_scatter")
    scatter_launches += 1
    return out_rows, fwd_out, inv_out, n_next_out
