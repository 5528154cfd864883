"""K5 and K6: the existing-node half of a class step.

``existing_intake`` (K5) is ``_prep_existing``
(karpenter_core_tpu/ops/solve.py:548) without its key compatibility (K3's
compat entry point) and its requirement merge (K6's commit): each existing
node's intake of one class — the resource fit, the
host-port and CSI attach caps and the hostname cap — and 0 where the node is
closed, key-incompatible, intolerant, outside the class's zones or capacity
types, port-conflicting or volume-blocked.  Its source is
``csrc/existing_intake.cu``.

``existing_mask_fill``, ``existing_mask`` and ``existing_commit`` (K6,
three entry points of ``csrc/existing_phase.cu``) are ``_phase_existing``
(:624): the fused mask and priority fill of a phase without hole
preferences (its assigned pods, their sum and the live zone mask, in one
launch); the caps and index priorities alone, for the phases whose fill
takes hole preferences (K2 twice, ``ops.solve._fill_with_pref``); and the
existing-node state after the fill's pods land, each row that took pods
merged with the class (``reqmerge.ClassMerge``; the row code is K3's).  The zone-committal sweep
uses the same entry points for its existing-node fills and commit.

Each wrapper runs its plain torch twin for CPU tensors and launches its
kernel for CUDA tensors; the twins are the CPU path and the kernels' oracle.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from karpenter_core_tpu_torch.kernels import batch, build, reqmerge
from karpenter_core_tpu_torch.kernels.capacity import BIG, INT32_MAX, UNLIMITED, to_i32
from karpenter_core_tpu_torch.kernels.fill import fill_by_priority_plain
from karpenter_core_tpu_torch.kernels.fp32 import fma_f32
from karpenter_core_tpu_torch.ops import masks as mask_ops

intake_launches = 0  # K5 launches (CUDA path only)
phase_launches = 0  # K6 launches, every entry point (CUDA path only)


class ExistingState(NamedTuple):
    """Per-existing-node solver state (leading dim E), which K6 commits;
    ``ops.solve`` re-exports it."""

    used: torch.Tensor  # f32[E, R]
    kmask: torch.Tensor  # int32[E, K, W] (bool[E, K, V+1] before packing)
    kdef: torch.Tensor  # bool[E, K]
    kneg: torch.Tensor  # bool[E, K]
    kgt: torch.Tensor  # f32[E, K]
    klt: torch.Tensor  # f32[E, K]
    zone: torch.Tensor  # bool[E, Z]
    ct: torch.Tensor  # bool[E, CT]
    ports: torch.Tensor  # bool[E, P]
    vol_used: torch.Tensor  # i32[E, D]
    pod_count: torch.Tensor  # i32[E]
    open_: torch.Tensor  # bool[E]; no phase changes it


# -- K5 -------------------------------------------------------------------------


def existing_intake_plain(alloc, used, open_, key_ok, tol, zone, cls_zone, ct, cls_ct,
                          ports, cls_ports, vol_limit, vol_used, vol_add, vol_per_pod,
                          requests, host_cap, host_ports: bool, volume_limits: bool):
    """The plain torch version of K5: (cap i32[E], zone_full bool[E, Z],
    ct_ok bool[E, CT])."""
    zone_full = zone & cls_zone[None, :]
    ct_ok = ct & cls_ct[None, :]
    cap = None
    for r in range(alloc.shape[-1]):
        free = alloc[:, r] - used[:, r]
        per = torch.where(
            requests[r] > 0,
            torch.floor((free + 1e-4) / torch.clamp(requests[r], min=1e-9)),
            BIG,
        )
        per = torch.clamp(per, min=0.0)
        cap = per if cap is None else torch.minimum(cap, per)
    cap = to_i32(torch.clamp(cap, max=BIG))

    elig = open_ & key_ok & tol & zone_full.any(dim=-1) & ct_ok.any(dim=-1)
    if host_ports:
        has_ports = cls_ports.any()
        port_conflict = (ports & cls_ports[None, :]).any(dim=-1)
        elig = elig & ~port_conflict
        cap = torch.minimum(cap, torch.where(has_ports, 1, UNLIMITED).to(torch.int32))
    if volume_limits:
        vol_free = vol_limit - vol_used - vol_add  # [E, D]
        vol_ok = (vol_free >= vol_per_pod[None, :]).all(dim=-1)
        cap_vol = torch.where(
            vol_per_pod[None, :] > 0,
            torch.div(vol_free, torch.clamp(vol_per_pod, min=1)[None, :], rounding_mode="floor"),
            UNLIMITED,
        ).amin(dim=-1).to(torch.int32)
        cap = torch.minimum(cap, torch.clamp(cap_vol, min=0))
        elig = elig & vol_ok
    cap = torch.where(elig, torch.minimum(cap, host_cap), 0)
    return cap, zone_full, ct_ok


existing_intake_twin = batch.tenantwise(existing_intake_plain, lambda alloc, *_: alloc.dim() == 2)


def existing_intake(alloc, used, open_, key_ok, tol, zone, cls_zone, ct, cls_ct,
                    ports, cls_ports, vol_limit, vol_used, vol_add, vol_per_pod,
                    requests, host_cap, host_ports: bool, volume_limits: bool):
    """K5 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (no fallback between them).  Every operand may carry a
    leading tenant axis B (rows [B, E, ...], class vectors [B, ...]): one
    launch covers every tenant."""
    args = (alloc, used, open_, key_ok, tol, zone, cls_zone, ct, cls_ct, ports, cls_ports,
            vol_limit, vol_used, vol_add, vol_per_pod, requests, host_cap, host_ports,
            volume_limits)
    if alloc.device.type != "cuda":
        return existing_intake_twin(*args)
    if alloc.dim() == 2:
        return batch.drop_axis(_existing_intake_cuda(*batch.add_axis(args)))
    return _existing_intake_cuda(*args)


def _existing_intake_cuda(alloc, used, open_, key_ok, tol, zone, cls_zone, ct, cls_ct,
                          ports, cls_ports, vol_limit, vol_used, vol_add, vol_per_pod,
                          requests, host_cap, host_ports: bool, volume_limits: bool):
    global intake_launches
    dev = alloc.device
    n_b, n, n_res = alloc.shape
    n_zones, n_ct, n_ports = zone.shape[2], ct.shape[2], ports.shape[2]
    n_drivers = vol_used.shape[2]
    b, i32, f32 = torch.bool, torch.int32, torch.float32
    for name, t, dt, shape in (
        ("alloc", alloc, f32, (n_b, n, n_res)), ("used", used, f32, (n_b, n, n_res)),
        ("open_", open_, b, (n_b, n)), ("key_ok", key_ok, b, (n_b, n)), ("tol", tol, b, (n_b, n)),
        ("zone", zone, b, (n_b, n, n_zones)), ("cls_zone", cls_zone, b, (n_b, n_zones)),
        ("ct", ct, b, (n_b, n, n_ct)), ("cls_ct", cls_ct, b, (n_b, n_ct)),
        ("ports", ports, b, (n_b, n, n_ports)), ("cls_ports", cls_ports, b, (n_b, n_ports)),
        ("vol_limit", vol_limit, i32, (n_b, n, n_drivers)),
        ("vol_used", vol_used, i32, (n_b, n, n_drivers)),
        ("vol_add", vol_add, i32, (n_b, n, n_drivers)),
        ("vol_per_pod", vol_per_pod, i32, (n_b, n_drivers)),
        ("requests", requests, f32, (n_b, n_res)), ("host_cap", host_cap, i32, (n_b, n)),
    ):
        build.check_input(name, t, dt, shape, dev)
    cap = torch.empty((n_b, n), dtype=i32, device=dev)
    zone_full = torch.empty((n_b, n, n_zones), dtype=b, device=dev)
    ct_ok = torch.empty((n_b, n, n_ct), dtype=b, device=dev)
    fn = build.function("existing_intake", "kc_existing_intake",
                        [ctypes.c_int] * 9 + [ctypes.c_void_p] * 21)
    ptrs = [t.data_ptr() for t in (
        alloc, used, open_, key_ok, tol, zone, cls_zone, ct, cls_ct, ports, cls_ports,
        vol_limit, vol_used, vol_add, vol_per_pod, requests, host_cap, cap, zone_full, ct_ok,
    )]
    rc = fn(n_b, n, n_res, n_zones, n_ct, n_ports, n_drivers, int(host_ports),
            int(volume_limits), *ptrs, build.stream(dev))
    build.check(rc, "existing_intake")
    intake_launches += 1
    return cap, zone_full, ct_ok


# -- K6 -------------------------------------------------------------------------


def existing_mask_plain(prep_cap, zone, cls_zone, zone_restrict,
                        extra_elig: Optional[torch.Tensor], single_node: bool):
    """The plain torch version of K6's first entry point: (cap i32[E],
    priority i32[E], zone_ok bool[E, Z])."""
    n = prep_cap.shape[0]
    arange = torch.arange(n, dtype=torch.int32, device=prep_cap.device)
    zone_ok = zone & cls_zone[None, :] & zone_restrict[None, :]
    cap = torch.where(zone_ok.any(dim=-1), prep_cap, 0)
    if extra_elig is not None:
        cap = torch.where(extra_elig, cap, 0)
    if single_node:
        first = torch.argmax((cap > 0).to(torch.uint8))  # 0 when none
        cap = torch.where(arange == first, cap, 0)
    priority = torch.where(cap > 0, arange, INT32_MAX)
    return cap, priority, zone_ok


existing_mask_twin = batch.tenantwise(
    existing_mask_plain, lambda prep_cap, *_: prep_cap.dim() == 1)


def existing_mask(prep_cap, zone, cls_zone, zone_restrict,
                  extra_elig: Optional[torch.Tensor], single_node: bool):
    """K6 wrapper, first entry point: the caps and index priorities of one
    existing-node fill.  Every operand may carry a leading tenant axis B."""
    args = (prep_cap, zone, cls_zone, zone_restrict, extra_elig, single_node)
    if prep_cap.device.type != "cuda":
        return existing_mask_twin(*args)
    if prep_cap.dim() == 1:
        return batch.drop_axis(_existing_mask_cuda(*batch.add_axis(args)))
    return _existing_mask_cuda(*args)


def _existing_mask_cuda(prep_cap, zone, cls_zone, zone_restrict,
                        extra_elig: Optional[torch.Tensor], single_node: bool):
    global phase_launches
    dev = prep_cap.device
    n_b, n, n_zones = zone.shape
    b, i32 = torch.bool, torch.int32
    for name, t, dt, shape in (
        ("prep_cap", prep_cap, i32, (n_b, n)), ("zone", zone, b, (n_b, n, n_zones)),
        ("cls_zone", cls_zone, b, (n_b, n_zones)),
        ("zone_restrict", zone_restrict, b, (n_b, n_zones)),
    ):
        build.check_input(name, t, dt, shape, dev)
    if extra_elig is not None:
        build.check_input("extra_elig", extra_elig, b, (n_b, n), dev)
    cap = torch.empty((n_b, n), dtype=i32, device=dev)
    priority = torch.empty((n_b, n), dtype=i32, device=dev)
    zone_ok = torch.empty((n_b, n, n_zones), dtype=b, device=dev)
    fn = build.function("existing_phase", "kc_existing_mask",
                        [ctypes.c_int] * 5 + [ctypes.c_void_p] * 9)
    rc = fn(n_b, n, n_zones, int(extra_elig is not None), int(single_node), prep_cap.data_ptr(),
            zone.data_ptr(), cls_zone.data_ptr(), zone_restrict.data_ptr(),
            extra_elig.data_ptr() if extra_elig is not None else 0, cap.data_ptr(),
            priority.data_ptr(), zone_ok.data_ptr(), build.stream(dev))
    build.check(rc, "existing_phase (mask)")
    phase_launches += 1
    return cap, priority, zone_ok


def existing_mask_fill_plain(prep_cap, zone, cls_zone, zone_restrict,
                             extra_elig: Optional[torch.Tensor], single_node: bool, quota):
    """The plain torch version of K6's fused entry point: the mask, K2's
    fill of ``quota`` and the int32 sum, (assigned i32[E], placed i32,
    zone_ok bool[E, Z])."""
    cap, priority, zone_ok = existing_mask_plain(prep_cap, zone, cls_zone, zone_restrict,
                                                 extra_elig, single_node)
    assigned = fill_by_priority_plain(quota, cap, priority)
    return assigned, assigned.sum(dtype=torch.int32), zone_ok


existing_mask_fill_twin = batch.tenantwise(
    existing_mask_fill_plain, lambda prep_cap, *_: prep_cap.dim() == 1)


def existing_mask_fill(prep_cap, zone, cls_zone, zone_restrict,
                       extra_elig: Optional[torch.Tensor], single_node: bool, quota):
    """K6 wrapper, fused entry point: one existing-node fill without hole
    preferences, (assigned, placed, zone_ok).  ``quota`` is an int32 scalar
    on the rows' device (read there; no host sync).  Every operand may carry
    a leading tenant axis B (``quota`` and ``placed`` then [B])."""
    args = (prep_cap, zone, cls_zone, zone_restrict, extra_elig, single_node, quota)
    if prep_cap.device.type != "cuda":
        return existing_mask_fill_twin(*args)
    if prep_cap.dim() == 1:
        return batch.drop_axis(_existing_mask_fill_cuda(*batch.add_axis(args)))
    return _existing_mask_fill_cuda(*args)


def _existing_mask_fill_cuda(prep_cap, zone, cls_zone, zone_restrict,
                             extra_elig: Optional[torch.Tensor], single_node: bool, quota):
    global phase_launches
    dev = prep_cap.device
    n_b, n, n_zones = zone.shape
    b, i32 = torch.bool, torch.int32
    for name, t, dt, shape in (
        ("prep_cap", prep_cap, i32, (n_b, n)), ("zone", zone, b, (n_b, n, n_zones)),
        ("cls_zone", cls_zone, b, (n_b, n_zones)),
        ("zone_restrict", zone_restrict, b, (n_b, n_zones)), ("quota", quota, i32, (n_b,)),
    ):
        build.check_input(name, t, dt, shape, dev)
    if extra_elig is not None:
        build.check_input("extra_elig", extra_elig, b, (n_b, n), dev)
    assigned = torch.empty((n_b, n), dtype=i32, device=dev)
    zone_ok = torch.empty((n_b, n, n_zones), dtype=b, device=dev)
    if n == 0:  # nothing to fill: the kernel would not write the sums
        return assigned, torch.zeros(n_b, dtype=i32, device=dev), zone_ok
    placed = torch.empty(n_b, dtype=i32, device=dev)
    fn = build.function("existing_phase", "kc_existing_mask_fill",
                        [ctypes.c_int] * 5 + [ctypes.c_void_p] * 10)
    rc = fn(n_b, n, n_zones, int(extra_elig is not None), int(single_node), prep_cap.data_ptr(),
            zone.data_ptr(), cls_zone.data_ptr(), zone_restrict.data_ptr(),
            extra_elig.data_ptr() if extra_elig is not None else 0, quota.data_ptr(),
            assigned.data_ptr(), placed.data_ptr(), zone_ok.data_ptr(), build.stream(dev))
    build.check(rc, "existing_phase (mask_fill)")
    phase_launches += 1
    return assigned, placed, zone_ok


def existing_commit_plain(ex: ExistingState, merge: reqmerge.ClassMerge, zone_new, ct_ok,
                          cls_ports, vol_add, vol_per_pod, requests, assigned, host_ports: bool,
                          volume_limits: bool) -> ExistingState:
    """The plain torch version of K6's second entry point: the state after
    ``assigned`` pods of the class land.  A selected row's requirement
    planes are the row merged with the class (``merge``, ops/masks.py
    ``add``); ``used + assigned * req`` is one fused multiply-add, as XLA's
    CPU code contracts it in the reference."""
    sel = (assigned > 0)[:, None]
    merged = reqmerge.merge_plain(
        mask_ops.ReqTensor(ex.kmask, ex.kdef, ex.kneg, ex.kgt, ex.klt), merge)
    return ExistingState(
        used=fma_f32(assigned[:, None].to(torch.float32), requests[None, :], ex.used),
        kmask=torch.where(sel[..., None], merged.mask, ex.kmask),
        kdef=torch.where(sel, merged.defined, ex.kdef),
        kneg=torch.where(sel, merged.negative, ex.kneg),
        kgt=torch.where(sel, merged.gt, ex.kgt),
        klt=torch.where(sel, merged.lt, ex.klt),
        zone=torch.where(sel, zone_new, ex.zone),
        ct=torch.where(sel, ct_ok, ex.ct),
        ports=torch.where(sel, ex.ports | cls_ports[None, :], ex.ports)
        if host_ports else ex.ports,
        vol_used=torch.where(
            sel, ex.vol_used + vol_add + assigned[:, None] * vol_per_pod[None, :], ex.vol_used,
        ) if volume_limits else ex.vol_used,
        pod_count=ex.pod_count + assigned,
        open_=ex.open_,
    )


existing_commit_twin = batch.tenantwise(existing_commit_plain, lambda ex, *_: ex.used.dim() == 2)


def existing_commit(ex: ExistingState, merge: reqmerge.ClassMerge, zone_new, ct_ok, cls_ports,
                    vol_add, vol_per_pod, requests, assigned, host_ports: bool,
                    volume_limits: bool) -> ExistingState:
    """K6 wrapper, second entry point: the state commit after a fill, the
    selected rows merged with the class (``merge``: the class row [1, K, W],
    the valid words, the vocabulary ints, v and the bounds flags).  Every
    operand may carry a leading tenant axis B."""
    args = (ex, merge, zone_new, ct_ok, cls_ports, vol_add, vol_per_pod, requests, assigned,
            host_ports, volume_limits)
    if ex.used.device.type != "cuda":
        return existing_commit_twin(*args)
    if ex.used.dim() == 2:
        return batch.drop_axis(_existing_commit_cuda(*batch.add_axis(args)))
    return _existing_commit_cuda(*args)


def _existing_commit_cuda(ex: ExistingState, merge: reqmerge.ClassMerge, zone_new, ct_ok,
                          cls_ports, vol_add, vol_per_pod, requests, assigned, host_ports: bool,
                          volume_limits: bool) -> ExistingState:
    global phase_launches
    dev = ex.used.device
    n_b, n, n_res = ex.used.shape
    _, _, n_keys, n_words = ex.kmask.shape
    n_zones, n_ct, n_ports = ex.zone.shape[2], ex.ct.shape[2], ex.ports.shape[2]
    n_drivers = ex.vol_used.shape[2]
    cls, v = merge.cls, merge.v
    n_vocab = merge.vocab_ints.shape[-1]
    b, i32, f32 = torch.bool, torch.int32, torch.float32
    shapes = {
        "used": (f32, (n_b, n, n_res)), "kmask": (i32, (n_b, n, n_keys, n_words)),
        "kdef": (b, (n_b, n, n_keys)), "kneg": (b, (n_b, n, n_keys)),
        "kgt": (f32, (n_b, n, n_keys)), "klt": (f32, (n_b, n, n_keys)),
        "zone": (b, (n_b, n, n_zones)), "ct": (b, (n_b, n, n_ct)),
        "ports": (b, (n_b, n, n_ports)), "vol_used": (i32, (n_b, n, n_drivers)),
        "pod_count": (i32, (n_b, n)),
    }
    for name, (dt, shape) in shapes.items():
        build.check_input(name, getattr(ex, name), dt, shape, dev)
    for name, t, dt, shape in (
        ("cls.mask", cls.mask, i32, (n_b, 1, n_keys, n_words)),
        ("cls.defined", cls.defined, b, (n_b, 1, n_keys)),
        ("cls.negative", cls.negative, b, (n_b, 1, n_keys)),
        ("cls.gt", cls.gt, f32, (n_b, 1, n_keys)), ("cls.lt", cls.lt, f32, (n_b, 1, n_keys)),
        ("valid", merge.valid, i32, (n_b, n_keys, n_words)),
        ("vocab_ints", merge.vocab_ints, f32, (n_b, n_keys, n_vocab)),
        ("zone_new", zone_new, b, (n_b, n, n_zones)), ("ct_ok", ct_ok, b, (n_b, n, n_ct)),
        ("cls_ports", cls_ports, b, (n_b, n_ports)),
        ("vol_add", vol_add, i32, (n_b, n, n_drivers)),
        ("vol_per_pod", vol_per_pod, i32, (n_b, n_drivers)),
        ("requests", requests, f32, (n_b, n_res)), ("assigned", assigned, i32, (n_b, n)),
    ):
        build.check_input(name, t, dt, shape, dev)
    if mask_ops.words_for(v) != n_words:
        raise ValueError(f"mask width {n_words} words does not hold v={v} slots")
    rows = [torch.empty(shape, dtype=dt, device=dev) for dt, shape in shapes.values()]
    fn = build.function("existing_phase", "kc_existing_commit",
                        [ctypes.c_int] * 15 + [ctypes.c_void_p] * 38)
    ptrs = [t.data_ptr() for t in (
        *ex[:-1], *cls, merge.valid, mask_ops.const_words("vocab", v, dev), merge.vocab_ints,
        zone_new, ct_ok, cls_ports, vol_add, vol_per_pod, requests, assigned, *rows,
    )]
    rc = fn(n_b, n, n_res, n_keys, n_words, n_vocab, (v - 1) // 32, (v - 1) % 32,
            int(any(merge.key_has_bounds)), n_zones, n_ct, n_ports, n_drivers,
            int(host_ports), int(volume_limits), *ptrs, build.stream(dev))
    build.check(rc, "existing_phase (commit)")
    phase_launches += 1
    return ExistingState(*rows, open_=ex.open_)
