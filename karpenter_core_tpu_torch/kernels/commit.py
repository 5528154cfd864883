"""K23: the slot commit of a placement phase or a zone-committal block.

``slot_commit(state, src, cls_ports, requests, tmpl_daemon, host_ports)``
commits a fill's pods into the new-node slot planes IN PLACE: it writes
into ``state``'s own planes and returns those same tensors, in
``NodeState``'s order without ``n_next`` (used, kmask, kdef, kneg, kgt, klt,
zone, ct, viable, ports, pod_count, tmpl_id, open_).  It replaces the
commits of ``_phase`` (karpenter_core_tpu/ops/solve.py:755-772, the open
slots, and :851-870, the fresh slots) and of the fused committal block's
one-shot commit (:1325-1360).  Every row is fresh (``src.fresh_t >= 0``: a
slot opened from that template), open (otherwise ``src.a > 0``) or kept, and
a tenant a phase skips has every row kept (``keep_skipped``).  A kept row is
neither read nor written; ``SlotSource`` says what the other rows take.
``src.zone_idx`` is given by the committal block alone, where each row's
zone picks its K1 planes (one pair a zone) and its one-hot zone mask.  With
host ports off the ``ports`` plane is returned as it is.

The caller owns the state it passes: the scan commits into its carry
(``ops.solve``), and a warm carry that is not donated is cloned once at the
solve's entry.  The wrapper raises, on the card and on the CPU alike, when
a state plane it writes is not contiguous (an expanded, stride-0 plane or
one that overlaps itself) or shares storage with a source plane.

``slot_commit_twin`` is the pure version: the glue ``ops/solve.py`` ran
before the kernel, moved here, returning new tensors.  On the CPU the
wrapper runs it and copies its result into the state planes (``copy_``), so
the CPU tests see the aliasing the card does; on the card it is the
kernel's oracle.  Its ``used + a * req`` is one float32 FMA
(``fp32.fma_f32``) as XLA's CPU code contracts the slot commits in the
reference's jitted solve, on the rows that took pods (a kept row's
``fma(0, req, used)`` in the reference equals its ``used``).  The CUDA
source is ``csrc/slot_commit.cu``.  Every operand carries the leading
tenant axis B (a solo solve is B = 1).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from karpenter_core_tpu_torch.kernels import build
from karpenter_core_tpu_torch.kernels.fp32 import fma_f32
from karpenter_core_tpu_torch.ops import masks as mask_ops

launches = 0  # kernel launches (CUDA path only)

MAX_ZONE_SETS = 32  # the kernel's table of K1 plane pairs
# the state planes K23 commits into, in its output order (``NodeState``'s)
NODE_PLANES = ("used", "kmask", "kdef", "kneg", "kgt", "klt", "zone", "ct", "viable", "ports",
               "pod_count", "tmpl_id", "open_")


class SlotSource(NamedTuple):
    """What one commit site gives the slot rows (every plane [B, ...])."""

    a: torch.Tensor  # i32[B, N]: the pods each row takes, open or fresh
    fresh_t: torch.Tensor  # i32[B, N]: a fresh row's template, -1 elsewhere
    zone_idx: Optional[torch.Tensor]  # i32[B, N]: the committal block's zones; None in a phase
    merged: mask_ops.ReqTensor  # the rows merged with the class (K3) [B, N, ...]
    tmpl_merged: mask_ops.ReqTensor  # the templates merged with the class [B, T, ...]
    zone_ok: Optional[torch.Tensor]  # bool[B, N, Z]: an open row's zone mask (a phase)
    t_zone: Optional[torch.Tensor]  # bool[B, T, Z]: a fresh row's zone mask (a phase)
    ct_ok: torch.Tensor  # bool[B, N, CT]
    t_ct: torch.Tensor  # bool[B, T, CT]
    ok: Tuple[torch.Tensor, ...]  # K1's it_ok over the rows, a zone set each: bool[B, N, I]
    cap: Tuple[torch.Tensor, ...]  # K1's cap_ni over the rows: i32[B, N, I]
    t_ok: Tuple[torch.Tensor, ...]  # K1's it_ok over the templates: bool[B, T, I]
    t_cap: Tuple[torch.Tensor, ...]  # K1's cap_ni over the templates: i32[B, T, I]


def _rows_at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, n]]``: rows of ``x`` [B, T, ...] named by ``idx`` [B, N]."""
    at = idx.long().view(tuple(idx.shape) + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, at.expand(tuple(idx.shape) + tuple(x.shape[2:])))


def _by_zone(planes, zone_idx, rows):
    """Each row's plane of its zone set: ``planes[zone_idx[b, n]][b, n]``
    (set 0 where there is no index or it is out of range), the planes taken
    at ``rows`` (a row-gather of template planes) or as they are."""
    pick = [p if rows is None else _rows_at(p, rows) for p in planes]
    out = pick[0]
    for z in range(1, len(pick)):
        out = torch.where((zone_idx == z)[..., None], pick[z], out)
    return out


def keep_skipped(src: SlotSource, on: Optional[torch.Tensor]) -> SlotSource:
    """``src`` with every row of a tenant whose ``on[b]`` is false kept (no
    pods, no template; None: every tenant on): vmap's select for a phase
    some tenants skip, whose kept rows K23 leaves as they are."""
    if on is None:
        return src
    col = on[:, None]
    return src._replace(a=torch.where(col, src.a, 0), fresh_t=torch.where(col, src.fresh_t, -1))


def slot_commit_twin(state, src: SlotSource, cls_ports, requests, tmpl_daemon,
                     host_ports: bool) -> tuple:
    """The plain torch version of K23 (module doc)."""
    a = src.a
    fresh = src.fresh_t >= 0
    tmpl_idx = torch.clamp(src.fresh_t, min=0)
    sel = (a > 0)[..., None]
    seln = fresh[..., None]
    a_f = a[..., None].to(torch.float32)
    req = requests[:, None, :]
    used = torch.where(sel, fma_f32(a_f, req, state.used), state.used)
    used = torch.where(seln, fma_f32(a_f, req, _rows_at(tmpl_daemon, tmpl_idx)), used)
    planes = []
    for name, m, t in zip(("kmask", "kdef", "kneg", "kgt", "klt"), src.merged, src.tmpl_merged):
        old = getattr(state, name)
        s, sn = (sel[..., None], seln[..., None]) if name == "kmask" else (sel, seln)
        planes.append(torch.where(sn, _rows_at(t, tmpl_idx), torch.where(s, m, old)))
    if src.zone_idx is None:
        zone_open, zone_fresh = src.zone_ok, _rows_at(src.t_zone, tmpl_idx)
    else:
        hot = torch.arange(state.zone.shape[-1], device=a.device) == src.zone_idx[..., None]
        zone_open = zone_fresh = hot
    zone = torch.where(seln, zone_fresh, torch.where(sel, zone_open, state.zone))
    ct = torch.where(seln, _rows_at(src.t_ct, tmpl_idx), torch.where(sel, src.ct_ok, state.ct))
    # the reference's it_ok & (cap_ni >= a) of the row's zone set
    zi = src.zone_idx if src.zone_idx is not None else torch.zeros_like(a)
    v_open = _by_zone(src.ok, zi, None) & (_by_zone(src.cap, zi, None) >= a[..., None])
    v_fresh = (_by_zone(src.t_ok, zi, tmpl_idx)
               & (_by_zone(src.t_cap, zi, tmpl_idx) >= a[..., None]))
    viable = torch.where(seln, v_fresh, torch.where(sel, v_open, state.viable))
    if host_ports:
        ports = torch.where(sel, state.ports | cls_ports[:, None, :], state.ports)
        ports = torch.where(seln, (a > 0)[..., None] & cls_ports[:, None, :], ports)
    else:
        ports = state.ports
    pod_count = torch.where(fresh, a, state.pod_count + a)
    tmpl_id = torch.where(fresh, src.fresh_t, state.tmpl_id)
    open_ = state.open_ | fresh
    return (used, *planes, zone, ct, viable, ports, pod_count, tmpl_id, open_)


def _sources(src: SlotSource, cls_ports, requests, tmpl_daemon) -> tuple:
    """(name, tensor) of every operand K23 reads besides the state."""
    named = [("a", src.a), ("fresh_t", src.fresh_t), ("zone_idx", src.zone_idx),
             ("zone_ok", src.zone_ok), ("t_zone", src.t_zone), ("ct_ok", src.ct_ok),
             ("t_ct", src.t_ct), ("cls_ports", cls_ports), ("requests", requests),
             ("tmpl_daemon", tmpl_daemon)]
    for label, req in (("merged", src.merged), ("tmpl_merged", src.tmpl_merged)):
        named += [(f"{label}.{f}", t) for f, t in zip(req._fields, req)]
    for label in ("ok", "cap", "t_ok", "t_cap"):
        named += [(f"{label}[{z}]", t) for z, t in enumerate(getattr(src, label))]
    return tuple((name, t) for name, t in named if t is not None)


def check_in_place(state, src: SlotSource, cls_ports, requests, tmpl_daemon,
                   host_ports: bool) -> None:
    """Raise unless K23 can write ``state``'s planes in place: each plane it
    writes is contiguous (no zero stride, no overlap with itself) and no
    source shares its storage."""
    names = NODE_PLANES if host_ports else tuple(n for n in NODE_PLANES if n != "ports")
    owned = {}
    for name in names:
        t = getattr(state, name)
        if any(st == 0 and n > 1 for st, n in zip(t.stride(), t.shape)):
            raise ValueError(f"slot_commit: state plane {name} is expanded (a zero stride); "
                             "K23 writes it in place")
        if not t.is_contiguous():
            raise ValueError(f"slot_commit: state plane {name} is not contiguous; K23 writes it "
                             "in place")
        if t.numel():
            owned[t.untyped_storage().data_ptr()] = name
    for name, t in _sources(src, cls_ports, requests, tmpl_daemon):
        hit = owned.get(t.untyped_storage().data_ptr()) if t.numel() else None
        if hit is not None:
            raise ValueError(f"slot_commit: source {name} shares storage with state plane {hit}, "
                             "which K23 writes in place")


def slot_commit(state, src: SlotSource, cls_ports, requests, tmpl_daemon,
                host_ports: bool) -> tuple:
    """K23 wrapper: the commit written into ``state``'s planes, which it
    returns (module doc).  CPU tensors take the twin and ``copy_``, CUDA
    tensors the kernel (no fallback between them); one launch a commit
    site."""
    check_in_place(state, src, cls_ports, requests, tmpl_daemon, host_ports)
    planes = tuple(getattr(state, name) for name in NODE_PLANES)
    if state.used.device.type != "cuda":
        out = slot_commit_twin(state, src, cls_ports, requests, tmpl_daemon, host_ports)
        for dst, val in zip(planes, out):
            if val is not dst:
                dst.copy_(val)
        return planes
    _slot_commit_cuda(state, src, cls_ports, requests, tmpl_daemon, host_ports)
    return planes


def _slot_commit_cuda(state, src: SlotSource, cls_ports, requests, tmpl_daemon,
                      host_ports: bool) -> None:
    global launches
    dev = state.used.device
    n_b, n, n_res = state.used.shape
    _, _, n_keys, n_words = state.kmask.shape
    n_zones, n_ct, n_ports = state.zone.shape[2], state.ct.shape[2], state.ports.shape[2]
    n_types = state.viable.shape[2]
    n_tmpl = tmpl_daemon.shape[1]
    n_vz = len(src.ok)
    b, i32, f32 = torch.bool, torch.int32, torch.float32
    by_index = src.zone_idx is not None
    if not 1 <= n_vz <= MAX_ZONE_SETS or not (len(src.cap) == len(src.t_ok) == len(src.t_cap)
                                              == n_vz):
        raise ValueError(f"slot_commit: {n_vz} zone sets of K1 planes, the kernel takes 1 to "
                         f"{MAX_ZONE_SETS} pairs of each kind")
    if not by_index and (src.zone_ok is None or src.t_zone is None):
        raise ValueError("slot_commit: a phase's commit needs zone_ok and t_zone")
    state_planes = (
        ("used", state.used, f32, (n_b, n, n_res)),
        ("kmask", state.kmask, i32, (n_b, n, n_keys, n_words)),
        ("kdef", state.kdef, b, (n_b, n, n_keys)), ("kneg", state.kneg, b, (n_b, n, n_keys)),
        ("kgt", state.kgt, f32, (n_b, n, n_keys)), ("klt", state.klt, f32, (n_b, n, n_keys)),
        ("zone", state.zone, b, (n_b, n, n_zones)), ("ct", state.ct, b, (n_b, n, n_ct)),
        ("viable", state.viable, b, (n_b, n, n_types)),
        ("ports", state.ports, b, (n_b, n, n_ports)),
        ("pod_count", state.pod_count, i32, (n_b, n)), ("tmpl_id", state.tmpl_id, i32, (n_b, n)),
        ("open_", state.open_, b, (n_b, n)),
    )
    checks = list(state_planes) + [
        ("a", src.a, i32, (n_b, n)), ("fresh_t", src.fresh_t, i32, (n_b, n)),
        ("ct_ok", src.ct_ok, b, (n_b, n, n_ct)), ("t_ct", src.t_ct, b, (n_b, n_tmpl, n_ct)),
        ("cls_ports", cls_ports, b, (n_b, n_ports)), ("requests", requests, f32, (n_b, n_res)),
        ("tmpl_daemon", tmpl_daemon, f32, (n_b, n_tmpl, n_res)),
    ]
    for rows, req, label in ((n, src.merged, "merged"), (n_tmpl, src.tmpl_merged, "tmpl_merged")):
        checks += [
            (f"{label}.mask", req.mask, i32, (n_b, rows, n_keys, n_words)),
            (f"{label}.defined", req.defined, b, (n_b, rows, n_keys)),
            (f"{label}.negative", req.negative, b, (n_b, rows, n_keys)),
            (f"{label}.gt", req.gt, f32, (n_b, rows, n_keys)),
            (f"{label}.lt", req.lt, f32, (n_b, rows, n_keys)),
        ]
    for z in range(n_vz):
        checks += [
            (f"ok[{z}]", src.ok[z], b, (n_b, n, n_types)),
            (f"cap[{z}]", src.cap[z], i32, (n_b, n, n_types)),
            (f"t_ok[{z}]", src.t_ok[z], b, (n_b, n_tmpl, n_types)),
            (f"t_cap[{z}]", src.t_cap[z], i32, (n_b, n_tmpl, n_types)),
        ]
    if by_index:
        checks.append(("zone_idx", src.zone_idx, i32, (n_b, n)))
    else:
        checks += [("zone_ok", src.zone_ok, b, (n_b, n, n_zones)),
                   ("t_zone", src.t_zone, b, (n_b, n_tmpl, n_zones))]
    for name, t, dt, shape in checks:
        build.check_input(name, t, dt, shape, dev)

    def table(planes):
        return (ctypes.c_void_p * n_vz)(*(p.data_ptr() for p in planes))

    def opt(t):
        return 0 if t is None else t.data_ptr()

    fn = build.function("slot_commit", "kc_slot_commit",
                        [ctypes.c_int] * 12 + [ctypes.c_void_p] * 30
                        + [ctypes.POINTER(ctypes.c_void_p)] * 4 + [ctypes.c_void_p] * 4)
    rc = fn(n_b, n, n_tmpl, n_res, n_keys, n_words, n_zones, n_ct, n_ports, n_types, n_vz,
            int(by_index),
            *(t.data_ptr() if name != "ports" or host_ports else 0
              for name, t, _, _ in state_planes),
            src.a.data_ptr(), src.fresh_t.data_ptr(), opt(src.zone_idx),
            *(t.data_ptr() for t in src.merged), *(t.data_ptr() for t in src.tmpl_merged),
            opt(src.zone_ok), opt(src.t_zone), src.ct_ok.data_ptr(), src.t_ct.data_ptr(),
            table(src.ok), table(src.cap), table(src.t_ok), table(src.t_cap),
            cls_ports.data_ptr(), requests.data_ptr(), tmpl_daemon.data_ptr(),
            build.stream(dev))
    build.check(rc, "slot_commit")
    launches += 1
