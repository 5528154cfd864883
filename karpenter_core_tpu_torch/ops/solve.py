"""The bin-packing solve, in torch.

The port of ``karpenter_core_tpu/ops/solve.py`` for the cold solve (no warm
carry, no real existing node): pods grouped into equivalence classes are
scanned class by class; each class step runs the zone-spread committal block
(with ``_water_fill``), the affinity / anti-affinity phases and the
unconstrained phase, every one of them dense work over N node slots x I
instance types, then records topology counts.

Device work goes through four hand-written CUDA kernels (``kernels/``):

  K1 ``it_capacity``   viability + per-type capacity + row max
  K2 ``fill``          priority fill (stable sort + exclusive scan)
  K3 ``merge_compat``  requirement merge + compatibility
  K4 ``pack_bool``     the decode fetch's bit-packing

``solve_core(..., use_kernels=False)`` runs their plain torch twins instead:
the oracle a card run holds the kernels against.  On CPU tensors the
wrappers run the twins anyway.

Where the reference runs ``lax.scan`` over classes and ``lax.cond`` around
each class and phase, this runs a Python loop with explicit skips; each skip
decision reads one device scalar on the host (``host_syncs`` counts them).

Every integer plane is int32 exactly where the reference's is (JAX's default
with x64 off; torch would default to int64): sums pass ``dtype=torch.int32``
and the packed slot priority ``pod_count * n_slots + arange`` wraps as it does
in the reference.  Float-to-int32 casts saturate (``kernels.capacity.to_i32``).
Integer "einsums" are broadcast-multiply-sums in int32 (CUDA has no int32
matmul); the reference's bf16 0/1 einsums tested ``> 0.5`` are boolean
``any`` reductions here.  Sorts are stable (``jnp.argsort`` is).

Only the production configuration exists here: bit-packed masks
(``packed_masks=True``) and the fused zone-committal block
(``fuse_zones=True``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from karpenter_core_tpu_torch.kernels import capacity as k1
from karpenter_core_tpu_torch.kernels import fill as k2
from karpenter_core_tpu_torch.kernels import packbits as k4
from karpenter_core_tpu_torch.kernels import reqmerge as k3
from karpenter_core_tpu_torch.models.snapshot import UNLIMITED as _UNLIMITED
from karpenter_core_tpu_torch.models.snapshot import EncodedSnapshot
from karpenter_core_tpu_torch.ops import masks as mask_ops

BIG = k1.BIG
UNLIMITED = int(_UNLIMITED)
I32_MAX = 2**31 - 1
I32 = torch.int32
F32 = torch.float32

to_i32 = k1.to_i32
unpack_bool = k4.unpack_bool

host_syncs = 0  # skip decisions read on the host (class / phase branches)


class SnapshotFeatures(NamedTuple):
    """Static phase-plan flags: which constraint families the snapshot can
    exercise at all (see the reference's docstring).  A False flag means the
    family's phases are never run; a True flag with the feature absent from
    the data is sound (the phases are runtime no-ops)."""

    zone_spread: bool = True
    host_spread: bool = True
    zone_affinity: bool = True
    host_affinity: bool = True
    zone_anti: bool = True
    required_zone_anti: bool = True
    host_anti: bool = True
    inv_zone_anti: bool = True
    inv_host_anti: bool = True
    host_ports: bool = True
    volume_limits: bool = True

    def canonical(self) -> "SnapshotFeatures":
        """Required zonal anti implies the zonal-anti family and inverse plane."""
        f = self
        if f.required_zone_anti:
            f = f._replace(zone_anti=True, inv_zone_anti=True)
        return f

    def union(self, other: "SnapshotFeatures") -> "SnapshotFeatures":
        return SnapshotFeatures(*(a or b for a, b in zip(self, other)))


ALL_FEATURES = SnapshotFeatures()


class NodeState(NamedTuple):
    """Per-new-node-slot solver state (all leading dim N)."""

    used: torch.Tensor  # f32[N, R]
    kmask: torch.Tensor  # int32[N, K, W] packed words
    kdef: torch.Tensor  # bool[N, K]
    kneg: torch.Tensor  # bool[N, K]
    kgt: torch.Tensor  # f32[N, K]
    klt: torch.Tensor  # f32[N, K]
    zone: torch.Tensor  # bool[N, Z]
    ct: torch.Tensor  # bool[N, CT]
    viable: torch.Tensor  # bool[N, I]
    ports: torch.Tensor  # bool[N, P]
    pod_count: torch.Tensor  # i32[N]
    tmpl_id: torch.Tensor  # i32[N]
    open_: torch.Tensor  # bool[N]
    n_next: torch.Tensor  # i32[] next free slot


class ExistingState(NamedTuple):
    """Per-existing-node solver state (leading dim E)."""

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
    open_: torch.Tensor  # bool[E]


class ExistingStatic(NamedTuple):
    """Constants for existing nodes."""

    alloc: torch.Tensor  # f32[E, R]
    init: torch.Tensor  # bool[E]
    tol: torch.Tensor  # bool[C, E]
    grp_node_member: torch.Tensor  # i32[G1, E]
    grp_node_owner: torch.Tensor  # i32[G1, E]
    node_capacity: torch.Tensor  # f32[E, R]
    node_tmpl: torch.Tensor  # i32[E]
    node_owned: torch.Tensor  # bool[E]
    vol_limit: torch.Tensor  # i32[E, D]
    cls_vol_add: torch.Tensor  # i32[C, E, D]
    cls_vol_per_pod: torch.Tensor  # i32[C, D]


class TopoCounts(NamedTuple):
    """Shared per-node topology-group counts carried through the class scan:
    forward (member pods) and inverse (anti-term owners), on existing nodes
    and new slots.  Per-zone counts are derived at each class step from the
    nodes' current zone masks."""

    fwd_ex: torch.Tensor  # i32[G1, E]
    inv_ex: torch.Tensor  # i32[G1, E]
    fwd_new: torch.Tensor  # i32[G1, N]
    inv_new: torch.Tensor  # i32[G1, N]


class SolveOutputs(NamedTuple):
    assign: torch.Tensor  # i32[C, N] pods of class c on new node n
    assign_existing: torch.Tensor  # i32[C, E]
    failed: torch.Tensor  # i32[C]
    state: NodeState
    ex_state: ExistingState
    spread_suspect: torch.Tensor = None  # bool[C]
    topo: TopoCounts = None
    remaining: torch.Tensor = None  # f32[T, R]


class Kernels(NamedTuple):
    """The four device kernels the solve calls: the CUDA wrappers, or their
    plain torch twins (``use_kernels=False``)."""

    it_capacity: object
    fill: object
    merge_compat: object
    pack_bool: object


KERNELS = Kernels(k1.it_capacity, k2.fill_by_priority, k3.merge_compat, k4.pack_bool)
PLAIN = Kernels(k1.it_capacity_plain, k2.fill_by_priority_plain,
                k3.merge_compat_plain, k4.pack_bool_plain)


class Statics(NamedTuple):
    """Constants bundled for the solve."""

    it: mask_ops.ReqTensor
    it_alloc: torch.Tensor
    it_avail: torch.Tensor
    tmpl: mask_ops.ReqTensor
    tmpl_zone: torch.Tensor
    tmpl_ct: torch.Tensor
    tmpl_it: torch.Tensor
    tmpl_daemon: torch.Tensor
    tmpl_limits0: torch.Tensor  # f32[T, R]
    it_capacity: torch.Tensor  # f32[I, R]
    valid: torch.Tensor
    is_custom: torch.Tensor
    vocab_ints: torch.Tensor
    grp_skew: torch.Tensor  # i32[G1]
    grp_is_zone: torch.Tensor  # bool[G1]
    grp_is_anti: torch.Tensor  # bool[G1]
    grp_member: torch.Tensor  # bool[C, G1]
    key_has_bounds: Tuple[bool, ...]
    mask_v: int = 0  # semantic slot count V+1
    k: Kernels = KERNELS


class StaticArrays(NamedTuple):
    """The array part of Statics — field order matches Statics."""

    it: mask_ops.ReqTensor
    it_alloc: torch.Tensor
    it_avail: torch.Tensor
    tmpl: mask_ops.ReqTensor
    tmpl_zone: torch.Tensor
    tmpl_ct: torch.Tensor
    tmpl_it: torch.Tensor
    tmpl_daemon: torch.Tensor
    tmpl_limits0: torch.Tensor
    it_capacity: torch.Tensor
    valid: torch.Tensor
    is_custom: torch.Tensor
    vocab_ints: torch.Tensor
    grp_skew: torch.Tensor
    grp_is_zone: torch.Tensor
    grp_is_anti: torch.Tensor
    grp_member: torch.Tensor


class ClassTensors(NamedTuple):
    mask: torch.Tensor
    defined: torch.Tensor
    negative: torch.Tensor
    gt: torch.Tensor
    lt: torch.Tensor
    zone: torch.Tensor
    ct: torch.Tensor
    it: torch.Tensor
    requests: torch.Tensor
    count: torch.Tensor
    tol: torch.Tensor
    ports: torch.Tensor  # bool[C, P]
    groups: torch.Tensor  # i32[C, 6] owned group per kind (G = none):
    # [zone_spread, host_spread, zone_aff, host_aff, zone_anti, host_anti]
    relax_next: torch.Tensor  # i32[C] preference-ladder successor (-1 none)
    anti_soft: torch.Tensor  # bool[C, 2] (zone, host) anti slot is preferred
    root: torch.Tensor  # i32[C] ladder root index


class ExClassPrep(NamedTuple):
    """Per-(class, existing-node) quantities constant across one class
    step's phases (see the reference's docstring)."""

    cap: torch.Tensor  # i32[E]
    merged: mask_ops.ReqTensor
    zone_full: torch.Tensor  # bool[E, Z]
    ct_ok: torch.Tensor  # bool[E, CT]
    vol_add: torch.Tensor  # i32[E, D]
    vol_per_pod: torch.Tensor  # i32[D]


# -- small helpers ------------------------------------------------------------


def _isum(x: torch.Tensor, dim=None) -> torch.Tensor:
    """int32 sum (torch would widen to int64)."""
    if dim is None:
        return x.sum(dtype=I32)
    return x.sum(dim=dim, dtype=I32)


def _ar(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)


def _i32c(cond: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """``jnp.where(cond, a, b)`` on int32 scalars."""
    return torch.where(cond, a, b).to(I32)


def _argmax_first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True (0 when none) — ``jnp.argmax`` of a bool."""
    return torch.argmax(mask.to(torch.uint8))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for a 0-dim index tensor, gathered on the device.  Plain
    indexing with a 0-dim integer tensor reads the index on the host
    (``.item()``), a hidden synchronisation per use."""
    return x.index_select(0, idx.reshape(1))[0]


def _sync_positive(x: torch.Tensor) -> bool:
    """Host read of ``x > 0``: the port's ``lax.cond`` predicate."""
    global host_syncs
    host_syncs += 1
    return bool(x > 0)


def _cls_req(cls) -> mask_ops.ReqTensor:
    return mask_ops.ReqTensor(
        cls.mask[None], cls.defined[None], cls.negative[None], cls.gt[None], cls.lt[None]
    )


def _merge_compat(rows: mask_ops.ReqTensor, cls, statics: Statics):
    """(merged, compat) of every row against one class (K3)."""
    return statics.k.merge_compat(
        rows, _cls_req(cls), statics.valid, statics.vocab_ints, statics.is_custom,
        statics.mask_v, statics.key_has_bounds,
    )


def _it_cap(statics: Statics, viable, cls, merged, zone_ok, ct_ok, used):
    """(it_ok, cap_ni, cap_n) of one class over rows (K1)."""
    return statics.k.it_capacity(
        viable, cls.it, merged, statics.it, statics.vocab_ints, statics.mask_v,
        statics.key_has_bounds, zone_ok, ct_ok, statics.it_avail, used,
        cls.requests, statics.it_alloc,
    )


def _onehot_rows(n: int, n_zones: int, z: int, device) -> torch.Tensor:
    """bool[n, Z] with only column z set: a single-zone restriction."""
    out = torch.zeros((n, n_zones), dtype=torch.bool, device=device)
    out[:, z] = True
    return out


def _water_fill(count0: torch.Tensor, allowed: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """i32[Z] quotas: distribute m pods over allowed zones, always filling
    the lowest-count zone first (topologygroup.go:155-182 telescoped).  Ties
    among allowed zones keep index order: the sort is stable."""
    z = count0.shape[0]
    dev = count0.device
    c = torch.where(allowed, count0.to(F32), BIG)
    order = torch.argsort(c, stable=True)
    s = c[order]
    idx = torch.arange(z, dtype=F32, device=dev)
    prefix = torch.cumsum(s, dim=0) - s
    cost = idx * s - prefix
    cost = torch.where(torch.isfinite(cost), cost, BIG)
    mf = m.to(F32)
    k_star = _isum(cost <= mf) - 1
    k_star = torch.clamp(k_star, 0, z - 1).long()
    base_level = _take(s, k_star)
    spent = _take(cost, k_star)
    rem = mf - spent
    k_count = (k_star + 1).to(F32)
    level = base_level + torch.floor(rem / k_count)
    leftover = rem - torch.floor(rem / k_count) * k_count
    ar = _ar(z, dev)
    in_fill = ar <= k_star
    extra = (ar < leftover).to(F32)
    final_sorted = torch.where(in_fill, torch.maximum(s, level + extra), s)
    final = torch.zeros_like(c).scatter(0, order, final_sorted)
    quota = torch.where(allowed, final - c, 0.0)
    return to_i32(torch.clamp(quota, min=0.0))


def _fill_with_pref(k: Kernels, quota, cap, priority, pref):
    """Priority fill (K2); with ``pref`` (warm repair holes) the holes take
    the quota first, capped at their freed counts."""
    if pref is None:
        return k.fill(quota, cap, priority)
    idx = _ar(cap.shape[0], cap.device)
    hole_cap = torch.minimum(cap, pref)
    a0 = k.fill(quota, hole_cap, torch.where(hole_cap > 0, idx, I32_MAX))
    cap_rest = cap - a0
    a1 = k.fill(quota - _isum(a0), cap_rest, torch.where(cap_rest > 0, priority, I32_MAX))
    return a0 + a1


def _and_opt(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


# -- phases -------------------------------------------------------------------


def _prep_existing(ex, ex_static, cls, statics, host_cap_vec, tol_row, vol_add_row,
                   vol_per_pod_row, ft=ALL_FEATURES) -> ExClassPrep:
    """Intake of the class on each existing node (0 = ineligible), with the
    merged requirement planes (existingnode.go:77-130 at class granularity)."""
    node_t = mask_ops.ReqTensor(ex.kmask, ex.kdef, ex.kneg, ex.kgt, ex.klt)
    merged, key_ok = _merge_compat(node_t, cls, statics)
    zone_full = ex.zone & cls.zone[None, :]
    ct_ok = ex.ct & cls.ct[None, :]

    cap = None
    for r in range(ex_static.alloc.shape[-1]):
        free = ex_static.alloc[:, r] - ex.used[:, r]
        per = torch.where(
            cls.requests[r] > 0,
            torch.floor((free + 1e-4) / torch.clamp(cls.requests[r], min=1e-9)),
            BIG,
        )
        per = torch.clamp(per, min=0.0)
        cap = per if cap is None else torch.minimum(cap, per)
    cap = to_i32(torch.clamp(cap, max=BIG))

    elig = ex.open_ & key_ok & tol_row & zone_full.any(dim=-1) & ct_ok.any(dim=-1)
    if ft.host_ports:
        has_ports = cls.ports.any()
        port_conflict = (ex.ports & cls.ports[None, :]).any(dim=-1)
        elig = elig & ~port_conflict
        cap = torch.minimum(cap, _i32c(has_ports, 1, UNLIMITED))
    if ft.volume_limits:
        vol_free = ex_static.vol_limit - ex.vol_used - vol_add_row  # [E, D]
        vol_ok = (vol_free >= vol_per_pod_row[None, :]).all(dim=-1)
        cap_vol = torch.where(
            vol_per_pod_row[None, :] > 0,
            torch.div(vol_free, torch.clamp(vol_per_pod_row, min=1)[None, :], rounding_mode="floor"),
            UNLIMITED,
        ).amin(dim=-1).to(I32)
        cap = torch.minimum(cap, torch.clamp(cap_vol, min=0))
        elig = elig & vol_ok
    cap = torch.where(elig, torch.minimum(cap, host_cap_vec), 0)
    return ExClassPrep(cap=cap, merged=merged, zone_full=zone_full, ct_ok=ct_ok,
                       vol_add=vol_add_row, vol_per_pod=vol_per_pod_row)


def _commit_existing(ex, prep, cls, assigned, zone_new, ft):
    """The existing-node state after ``assigned`` pods of the class land."""
    sel = (assigned > 0)[:, None]
    merged = prep.merged
    return ExistingState(
        used=ex.used + assigned[:, None].to(F32) * cls.requests[None, :],
        kmask=torch.where(sel[..., None], merged.mask, ex.kmask),
        kdef=torch.where(sel, merged.defined, ex.kdef),
        kneg=torch.where(sel, merged.negative, ex.kneg),
        kgt=torch.where(sel, merged.gt, ex.kgt),
        klt=torch.where(sel, merged.lt, ex.klt),
        zone=torch.where(sel, zone_new, ex.zone),
        ct=torch.where(sel, prep.ct_ok, ex.ct),
        ports=torch.where(sel, ex.ports | cls.ports[None, :], ex.ports)
        if ft.host_ports else ex.ports,
        vol_used=torch.where(
            sel, ex.vol_used + prep.vol_add + assigned[:, None] * prep.vol_per_pod[None, :],
            ex.vol_used,
        ) if ft.volume_limits else ex.vol_used,
        pod_count=ex.pod_count + assigned,
        open_=ex.open_,
    )


def _phase_existing(ex, prep, cls, quota, zone_restrict, k: Kernels, extra_elig=None,
                    single_node=False, ft=ALL_FEATURES, pref=None):
    """Place up to ``quota`` pods of the class onto existing nodes in index
    order (scheduler.go:176-180).  Zone eligibility reads the LIVE zone mask."""
    n_ex = ex.used.shape[0]
    dev = ex.used.device
    zone_ok = ex.zone & cls.zone[None, :] & zone_restrict[None, :]
    cap = torch.where(zone_ok.any(dim=-1), prep.cap, 0)
    if extra_elig is not None:
        cap = torch.where(extra_elig, cap, 0)
    if single_node:
        first = _argmax_first(cap > 0)
        cap = torch.where(_ar(n_ex, dev) == first, cap, 0)
    priority = torch.where(cap > 0, _ar(n_ex, dev), I32_MAX)
    assigned = _fill_with_pref(k, quota, cap, priority, pref)
    placed = _isum(assigned)
    return _commit_existing(ex, prep, cls, assigned, zone_ok, ft), assigned, placed


def _phase(state: NodeState, cls, statics: Statics, quota, zone_restrict, host_cap_vec,
           fresh_host_cap, remaining, extra_elig=None, max_new_nodes=None,
           ft=ALL_FEATURES, pref=None):
    """Place up to ``quota`` pods of the class on slots whose zone mask meets
    ``zone_restrict`` — open slots first (emptiest first), then fresh slots
    from the first viable template.  Returns (state, assigned[N], placed,
    remaining)."""
    k = statics.k
    n_slots = state.used.shape[0]
    dev = state.used.device

    node_t = mask_ops.ReqTensor(state.kmask, state.kdef, state.kneg, state.kgt, state.klt)
    merged, key_ok = _merge_compat(node_t, cls, statics)
    zone_ok = state.zone & zone_restrict[None, :] & cls.zone[None, :]  # [N, Z]
    ct_ok = state.ct & cls.ct[None, :]  # [N, CT]
    tol_ok = cls.tol[state.tmpl_id.long()]  # [N]

    it_ok, cap_ni, cap_n = _it_cap(statics, state.viable, cls, merged, zone_ok, ct_ok, state.used)

    elig = state.open_ & key_ok & tol_ok & zone_ok.any(dim=-1) & ct_ok.any(dim=-1)
    if extra_elig is not None:
        elig = elig & extra_elig
    has_ports = None
    if ft.host_ports:
        has_ports = cls.ports.any()
        port_conflict = (state.ports & cls.ports[None, :]).any(dim=-1)
        elig = elig & ~port_conflict
        cap_n = torch.minimum(cap_n, _i32c(has_ports, 1, UNLIMITED))
    cap_n = torch.where(elig, torch.minimum(cap_n, host_cap_vec), 0)
    if max_new_nodes is not None and max_new_nodes == 1:
        first = _argmax_first(cap_n > 0)
        cap_n = torch.where(_ar(n_slots, dev) == first, cap_n, 0)

    # emptiest first (pod count, then slot index), packed into int32 exactly
    # as the reference packs it — the product wraps the same way if it ever
    # overflowed
    priority = state.pod_count * n_slots + _ar(n_slots, dev)
    priority = torch.where(cap_n > 0, priority, I32_MAX)
    assigned = _fill_with_pref(k, quota, cap_n, priority, pref)
    placed_existing = _isum(assigned)

    sel = (assigned > 0)[:, None]
    used = state.used + assigned[:, None].to(F32) * cls.requests[None, :]
    kmask = torch.where(sel[..., None], merged.mask, state.kmask)
    kdef = torch.where(sel, merged.defined, state.kdef)
    kneg = torch.where(sel, merged.negative, state.kneg)
    kgt = torch.where(sel, merged.gt, state.kgt)
    klt = torch.where(sel, merged.lt, state.klt)
    new_zone = torch.where(sel, zone_ok, state.zone)
    new_ct = torch.where(sel, ct_ok, state.ct)
    viable = torch.where(sel, it_ok & (cap_ni >= assigned[:, None]), state.viable)
    ports_plane = (
        torch.where(sel, state.ports | cls.ports[None, :], state.ports)
        if ft.host_ports else state.ports
    )
    pod_count = state.pod_count + assigned

    # -- open fresh nodes (scheduler.go:192-217) ------------------------------
    rem = quota - placed_existing
    tmpl_merged, tmpl_key_ok = _merge_compat(statics.tmpl, cls, statics)
    t_zone = statics.tmpl_zone & zone_restrict[None, :] & cls.zone[None, :]  # [T, Z]
    t_ct = statics.tmpl_ct & cls.ct[None, :]
    # provisioner limits: drop types whose launch would breach the remaining
    # budget (scheduler.go:292-309)
    within_limits = (
        statics.it_capacity[None, :, :] <= remaining[:, None, :] + 1e-4
    ).all(dim=-1)  # [T, I]
    t_it_ok, t_cap_ti, t_cap = _it_cap(
        statics, statics.tmpl_it & within_limits, cls, tmpl_merged, t_zone, t_ct,
        statics.tmpl_daemon,
    )
    t_viable = cls.tol & tmpl_key_ok & t_zone.any(dim=-1) & t_ct.any(dim=-1) & (t_cap > 0)
    t_star = _argmax_first(t_viable)
    t_ok = _take(t_viable, t_star)

    per_node = torch.minimum(_take(t_cap, t_star), fresh_host_cap)
    if ft.host_ports:
        per_node = torch.minimum(per_node, _i32c(has_ports, 1, UNLIMITED))
    per_node = torch.clamp(per_node, min=1)
    n_new = torch.where(
        t_ok & (rem > 0), -torch.div(-rem, per_node, rounding_mode="floor"), 0
    ).to(I32)
    n_new = torch.minimum(n_new, n_slots - state.n_next)
    # provisioner-limit budget: each opened node pessimistically consumes the
    # largest surviving instance type (scheduler.go:273-290 subtractMax)
    max_cap_star = torch.where(
        _take(t_it_ok, t_star)[:, None], statics.it_capacity, 0.0
    ).amax(dim=0)  # [R]
    rem_star = _take(remaining, t_star)
    budget_per_r = torch.where(
        torch.isfinite(rem_star) & (max_cap_star > 0),
        torch.floor((rem_star + 1e-4) / torch.clamp(max_cap_star, min=1e-9)),
        BIG,
    )
    budget_nodes = to_i32(torch.clamp(budget_per_r.amin(), min=0.0))
    n_new = torch.minimum(n_new, budget_nodes)
    if max_new_nodes is not None:
        # once the class bootstrapped onto an open slot, no fresh node
        n_new = torch.where(
            placed_existing > 0, 0, torch.clamp(n_new, max=max_new_nodes)
        ).to(I32)

    slot_idx = _ar(n_slots, dev)
    is_new = (slot_idx >= state.n_next) & (slot_idx < state.n_next + n_new)
    rank = slot_idx - state.n_next
    a_new = torch.where(
        is_new, torch.minimum(torch.clamp(rem - rank * per_node, min=0), per_node), 0
    )
    placed_new = _isum(a_new)

    seln = is_new[:, None]
    used = torch.where(
        seln,
        _take(statics.tmpl_daemon, t_star)[None, :] + a_new[:, None].to(F32) * cls.requests[None, :],
        used,
    )
    kmask = torch.where(seln[..., None], _take(tmpl_merged.mask, t_star)[None], kmask)
    kdef = torch.where(seln, _take(tmpl_merged.defined, t_star)[None], kdef)
    kneg = torch.where(seln, _take(tmpl_merged.negative, t_star)[None], kneg)
    kgt = torch.where(seln, _take(tmpl_merged.gt, t_star)[None], kgt)
    klt = torch.where(seln, _take(tmpl_merged.lt, t_star)[None], klt)
    new_zone = torch.where(seln, _take(t_zone, t_star)[None, :], new_zone)
    new_ct = torch.where(seln, _take(t_ct, t_star)[None, :], new_ct)
    fresh_viable = _take(t_it_ok, t_star)[None, :] & (_take(t_cap_ti, t_star)[None, :] >= a_new[:, None])
    viable = torch.where(seln, fresh_viable, viable)
    if ft.host_ports:
        ports_plane = torch.where(seln, (a_new > 0)[:, None] & cls.ports[None, :], ports_plane)
    pod_count = torch.where(is_new, a_new, pod_count)
    tmpl_id = torch.where(is_new, t_star.to(I32), state.tmpl_id)
    open_ = state.open_ | is_new
    n_next = state.n_next + n_new

    remaining = remaining.index_add(
        0, t_star.reshape(1), (-n_new.to(F32) * max_cap_star)[None, :]
    )
    new_state = NodeState(used, kmask, kdef, kneg, kgt, klt, new_zone, new_ct, viable,
                          ports_plane, pod_count, tmpl_id, open_, n_next)
    return new_state, assigned + a_new, placed_existing + placed_new, remaining


def _zone_counts(counts: torch.Tensor, zone_i: torch.Tensor) -> torch.Tensor:
    """i32[G1, Z] = einsum("gn,nz->gz") of int32 planes, as an int32
    broadcast-multiply-sum (CUDA has no int32 matmul)."""
    return _isum(counts[:, :, None] * zone_i[None, :, :], dim=1)


def _class_step(statics: Statics, ex_static: ExistingStatic, n_zones: int, carry,
                cls, cls_index: int, features: SnapshotFeatures = ALL_FEATURES, pref=None,
                topo_base=None):
    """One class step: schedule every pod of one class — existing nodes
    first, then new slots, phase by phase — and record topology counts.
    ``features`` prunes phase families the snapshot cannot exercise."""
    ft = features
    k = statics.k
    state, ex, topo, remaining = carry
    dev = state.used.device
    pref_new = pref[0] if pref is not None else None
    pref_ex = pref[1] if pref is not None else None
    m = cls.count
    n_ex = ex.pod_count.shape[0]
    n_new_slots = state.pod_count.shape[0]
    g1 = statics.grp_skew.shape[0]
    g_dummy = g1 - 1

    g_zs, g_hs, g_zaf, g_haf, g_zan, g_han = (cls.groups[i].long() for i in range(6))
    member_row = statics.grp_member[cls_index]  # [G1]
    tol_row = ex_static.tol[cls_index]  # [E]
    vol_add_row = ex_static.cls_vol_add[cls_index]  # [E, D]
    vol_per_pod_row = ex_static.cls_vol_per_pod[cls_index]  # [D]

    def own_onehot(g):
        return (torch.arange(g1, device=dev) == g) & (g < g_dummy)

    has_zs = g_zs < g_dummy
    has_zaf = g_zaf < g_dummy
    has_haf = g_haf < g_dummy
    has_zan = g_zan < g_dummy

    # -- derived per-zone counts: positive groups count pods on zone-committed
    # (singleton-mask) nodes, anti groups every zone a node could still be in
    any_zone_groups = ft.zone_spread or ft.zone_affinity or ft.zone_anti
    if any_zone_groups or ft.inv_zone_anti:
        ex_zone_i = ex.zone.to(I32) * ex.open_.to(I32)[:, None]
        new_zone_i = state.zone.to(I32) * state.open_.to(I32)[:, None]
    zone_fwd = None
    if any_zone_groups:
        ex_sing_zone = torch.where(_isum(ex_zone_i, dim=-1)[:, None] == 1, ex_zone_i, 0)
        new_sing_zone = torch.where(_isum(new_zone_i, dim=-1)[:, None] == 1, new_zone_i, 0)
        zone_fwd_sing = _zone_counts(topo.fwd_ex, ex_sing_zone) + _zone_counts(
            topo.fwd_new, new_sing_zone
        )  # [G1, Z]
        if topo_base is not None:
            zone_fwd_sing = zone_fwd_sing + topo_base[0]
        if ft.zone_anti:
            zone_fwd_full = _zone_counts(topo.fwd_ex, ex_zone_i) + _zone_counts(
                topo.fwd_new, new_zone_i
            )
            if topo_base is not None:
                zone_fwd_full = zone_fwd_full + topo_base[1]
            zone_fwd = torch.where(statics.grp_is_anti[:, None], zone_fwd_full, zone_fwd_sing)
        else:
            zone_fwd = zone_fwd_sing

    # -- inverse anti-affinity blocks (topology.go:44-47)
    if ft.inv_zone_anti:
        zone_inv_full = _zone_counts(topo.inv_ex, ex_zone_i) + _zone_counts(
            topo.inv_new, new_zone_i
        )
        if topo_base is not None:
            zone_inv_full = zone_inv_full + topo_base[2]
        mem_anti_zone = member_row & statics.grp_is_anti & statics.grp_is_zone
        blocked_z = (mem_anti_zone[:, None] & (zone_inv_full > 0)).any(dim=0)  # [Z]
        allowed_zone = cls.zone & ~blocked_z
    else:
        allowed_zone = cls.zone
    if ft.inv_host_anti:
        mem_anti_host = member_row & statics.grp_is_anti & ~statics.grp_is_zone
        ok_ex = ~(mem_anti_host[:, None] & (topo.inv_ex > 0)).any(dim=0)  # [E]
        ok_new = ~(mem_anti_host[:, None] & (topo.inv_new > 0)).any(dim=0)  # [N]
    else:
        ok_ex = None
        ok_new = None

    # -- per-node caps from hostname groups ----------------------------------
    cap_parts_ex, cap_parts_new, fresh_parts = [], [], []
    if ft.host_spread:
        skew_hs = _take(statics.grp_skew, g_hs)
        member_hs = _take(member_row, g_hs)
        hs_fwd_ex = _take(topo.fwd_ex, g_hs)
        hs_fwd_new = _take(topo.fwd_new, g_hs)
        cap_parts_ex.append(torch.where(
            member_hs, torch.clamp(skew_hs - hs_fwd_ex, min=0),
            _i32c(hs_fwd_ex <= skew_hs, UNLIMITED, 0),
        ))
        cap_parts_new.append(torch.where(
            member_hs, torch.clamp(skew_hs - hs_fwd_new, min=0),
            _i32c(hs_fwd_new <= skew_hs, UNLIMITED, 0),
        ))
        fresh_parts.append(torch.where(member_hs, skew_hs, UNLIMITED).to(I32))
    if ft.host_anti:
        han_fwd_ex = _take(topo.fwd_ex, g_han)
        han_fwd_new = _take(topo.fwd_new, g_han)
        member_han = _take(member_row, g_han)
        own_han = g_han < g_dummy
        cap_parts_ex.append(torch.where(
            own_han, torch.where(han_fwd_ex == 0, _i32c(member_han, 1, UNLIMITED), 0),
            UNLIMITED,
        ).to(I32))
        cap_parts_new.append(torch.where(
            own_han, torch.where(han_fwd_new == 0, _i32c(member_han, 1, UNLIMITED), 0),
            UNLIMITED,
        ).to(I32))
        fresh_parts.append(_i32c(own_han & member_han, 1, UNLIMITED))
    if cap_parts_ex:
        host_cap_ex = functools.reduce(torch.minimum, cap_parts_ex).to(I32)
        host_cap_new = functools.reduce(torch.minimum, cap_parts_new).to(I32)
        fresh_host_cap = functools.reduce(torch.minimum, fresh_parts).to(I32)
    else:
        host_cap_ex = torch.full((n_ex,), UNLIMITED, dtype=I32, device=dev)
        host_cap_new = torch.full((n_new_slots,), UNLIMITED, dtype=I32, device=dev)
        fresh_host_cap = torch.full((), UNLIMITED, dtype=I32, device=dev)

    ex_prep = _prep_existing(ex, ex_static, cls, statics, host_cap_ex, tol_row,
                             vol_add_row, vol_per_pod_row, ft)

    zeros_new = torch.zeros(n_new_slots, dtype=I32, device=dev)
    zeros_ex = torch.zeros(n_ex, dtype=I32, device=dev)
    zero = torch.zeros((), dtype=I32, device=dev)
    totals = {"new": zeros_new, "ex": zeros_ex, "placed": zero}

    def accumulate(results):
        nonlocal state, ex, remaining
        state, ex, assigned, assigned_ex, placed, remaining = results
        totals["new"] = totals["new"] + assigned
        totals["ex"] = totals["ex"] + assigned_ex
        totals["placed"] = totals["placed"] + placed

    def run_phase(quota, restrict, targets_ex=None, targets_new=None, single_node=False,
                  max_new_nodes=None):
        """One placement phase; a zero quota skips it (the reference's
        ``lax.cond(quota > 0)``)."""
        if not _sync_positive(quota):
            return state, ex, zeros_new, zeros_ex, zero, remaining
        extra_ex = _and_opt(ok_ex, targets_ex)
        extra_new = _and_opt(ok_new, targets_new)
        ex_o, a_ex, placed_ex = _phase_existing(
            ex, ex_prep, cls, quota, restrict, k, extra_elig=extra_ex,
            single_node=single_node, ft=ft, pref=pref_ex,
        )
        q_new = quota - placed_ex
        if single_node:
            q_new = torch.where(placed_ex > 0, 0, q_new).to(I32)
        state_o, a_new, placed_new, rem_o = _phase(
            state, cls, statics, q_new, restrict, host_cap_new, fresh_host_cap, remaining,
            extra_elig=extra_new, max_new_nodes=max_new_nodes, ft=ft, pref=pref_new,
        )
        return state_o, ex_o, a_new, a_ex, placed_ex + placed_new, rem_o

    def committal_block(quota_z, cap_total):
        """All zone-committal phases of one family (zone spread quotas /
        required zonal anti) in one sweep: the merge/compat prep is shared,
        and shared-slot conflicts resolve by zone order (a slot that takes
        pods in zone z commits to z and leaves every later zone)."""
        if not _sync_positive(_isum(quota_z)):
            return state, ex, zeros_new, zeros_ex, zero, remaining
        state_i, ex_i, rem = state, ex, remaining
        node_t = mask_ops.ReqTensor(state_i.kmask, state_i.kdef, state_i.kneg,
                                    state_i.kgt, state_i.klt)
        merged, key_ok = _merge_compat(node_t, cls, statics)
        ct_ok = state_i.ct & cls.ct[None, :]
        tol_ok = cls.tol[state_i.tmpl_id.long()]
        elig = state_i.open_ & key_ok & tol_ok & ct_ok.any(dim=-1)
        if ok_new is not None:
            elig = elig & ok_new
        has_ports = None
        if ft.host_ports:
            has_ports = cls.ports.any()
            port_conflict = (state_i.ports & cls.ports[None, :]).any(dim=-1)
            elig = elig & ~port_conflict
        zone_has_new = state_i.zone & cls.zone[None, :]  # [N, Z]
        cap_open_z, viable_z, capm_z = [], [], []
        for z in range(n_zones):
            # K1 with the zone restricted to z: it_ok is the reference's
            # ok_z = it_base & (offering in zone z); cap_z its row max
            ok_z, capm, cap_z = _it_cap(
                statics, state_i.viable, cls, merged,
                _onehot_rows(n_new_slots, n_zones, z, dev), ct_ok, state_i.used,
            )
            viable_z.append(ok_z)
            capm_z.append(capm)
            if ft.host_ports:
                cap_z = torch.minimum(cap_z, _i32c(has_ports, 1, UNLIMITED))
            cap_z = torch.where(elig & zone_has_new[:, z], torch.minimum(cap_z, host_cap_new), 0)
            cap_open_z.append(cap_z)
        priority = state_i.pod_count * n_new_slots + _ar(n_new_slots, dev)
        ex_cap = ex_prep.cap if ok_ex is None else torch.where(ok_ex, ex_prep.cap, 0)
        zone_has_ex = ex_i.zone & cls.zone[None, :]  # [E, Z]
        tmpl_merged, tmpl_key_ok = _merge_compat(statics.tmpl, cls, statics)
        t_ct = statics.tmpl_ct & cls.ct[None, :]
        t_ct_any = t_ct.any(dim=-1)
        t_zone_cls = statics.tmpl_zone & cls.zone[None, :]  # [T, Z]
        n_tmpl = statics.tmpl_zone.shape[0]

        taken_ex = torch.zeros(n_ex, dtype=torch.bool, device=dev)
        a_ex_acc = zeros_ex
        zex = zeros_ex
        taken_new = torch.zeros(n_new_slots, dtype=torch.bool, device=dev)
        a_open_acc = zeros_new
        zopen = zeros_new
        fresh_t = torch.full((n_new_slots,), -1, dtype=I32, device=dev)
        fresh_a = zeros_new
        fresh_z = zeros_new
        fresh_viable = torch.zeros_like(state_i.viable)
        n_next = state_i.n_next
        placed = zero
        slot_idx = _ar(n_new_slots, dev)
        for z in range(n_zones):
            quota = quota_z[z].to(I32)
            q = torch.clamp(torch.minimum(quota, cap_total - placed), min=0)
            # existing nodes first, in index order (scheduler.go:176-180)
            cap_e = torch.where(~taken_ex & zone_has_ex[:, z], ex_cap, 0)
            pri_e = torch.where(cap_e > 0, _ar(n_ex, dev), I32_MAX)
            a_ex = _fill_with_pref(k, q, cap_e, pri_e, pref_ex)
            placed_ex = _isum(a_ex)
            took_e = a_ex > 0
            taken_ex = taken_ex | took_e
            a_ex_acc = a_ex_acc + a_ex
            zex = torch.where(took_e, z, zex).to(I32)
            # then open slots, emptiest first
            q2 = q - placed_ex
            cap_n = torch.where(~taken_new, cap_open_z[z], 0)
            pri_n = torch.where(cap_n > 0, priority, I32_MAX)
            a_op = _fill_with_pref(k, q2, cap_n, pri_n, pref_new)
            placed_op = _isum(a_op)
            took_n = a_op > 0
            taken_new = taken_new | took_n
            a_open_acc = a_open_acc + a_op
            zopen = torch.where(took_n, z, zopen).to(I32)
            # then fresh slots from the first viable template for the zone
            rem_pods = q2 - placed_op
            within = (
                statics.it_capacity[None, :, :] <= rem[:, None, :] + 1e-4
            ).all(dim=-1)
            t_it_ok, t_cap_ti, t_cap = _it_cap(
                statics, statics.tmpl_it & within, cls, tmpl_merged,
                _onehot_rows(n_tmpl, n_zones, z, dev), t_ct, statics.tmpl_daemon,
            )
            t_viable = cls.tol & tmpl_key_ok & t_zone_cls[:, z] & t_ct_any & (t_cap > 0)
            t_star = _argmax_first(t_viable)
            t_ok = _take(t_viable, t_star)
            per_node = torch.minimum(_take(t_cap, t_star), fresh_host_cap)
            if ft.host_ports:
                per_node = torch.minimum(per_node, _i32c(has_ports, 1, UNLIMITED))
            per_node = torch.clamp(per_node, min=1)
            n_new = torch.where(
                t_ok & (rem_pods > 0), -torch.div(-rem_pods, per_node, rounding_mode="floor"), 0
            ).to(I32)
            n_new = torch.minimum(n_new, n_new_slots - n_next)
            max_cap_star = torch.where(
                _take(t_it_ok, t_star)[:, None], statics.it_capacity, 0.0
            ).amax(dim=0)
            rem_star = _take(rem, t_star)
            budget_per_r = torch.where(
                torch.isfinite(rem_star) & (max_cap_star > 0),
                torch.floor((rem_star + 1e-4) / torch.clamp(max_cap_star, min=1e-9)),
                BIG,
            )
            budget_nodes = to_i32(torch.clamp(budget_per_r.amin(), min=0.0))
            n_new = torch.minimum(n_new, budget_nodes)
            is_new = (slot_idx >= n_next) & (slot_idx < n_next + n_new)
            a_fr = torch.where(
                is_new,
                torch.minimum(torch.clamp(rem_pods - (slot_idx - n_next) * per_node, min=0), per_node),
                0,
            )
            fresh_t = torch.where(is_new, t_star.to(I32), fresh_t)
            fresh_a = fresh_a + a_fr
            fresh_z = torch.where(is_new, z, fresh_z).to(I32)
            fv_row = _take(t_it_ok, t_star)[None, :] & (_take(t_cap_ti, t_star)[None, :] >= a_fr[:, None])
            fresh_viable = torch.where(is_new[:, None], fv_row, fresh_viable)
            rem = rem.index_add(0, t_star.reshape(1), (-n_new.to(F32) * max_cap_star)[None, :])
            n_next = n_next + n_new
            placed = placed + placed_ex + placed_op + _isum(a_fr)

        # -- one-shot commit (each node took pods in at most one zone) --------
        zar = torch.arange(n_zones, device=dev)
        zhot_e = (zar[None, :] == zex[:, None]) & (a_ex_acc > 0)[:, None]
        ex_o = _commit_existing(ex_i, ex_prep, cls, a_ex_acc, zhot_e, ft)
        took_o = a_open_acc > 0
        is_fresh = fresh_t >= 0
        tmpl_idx = torch.clamp(fresh_t, min=0).long()
        sel_o = took_o[:, None]
        sel_f = is_fresh[:, None]
        zhot_o = (zar[None, :] == zopen[:, None]) & sel_o
        zhot_f = (zar[None, :] == fresh_z[:, None]) & sel_f
        used = state_i.used + a_open_acc[:, None].to(F32) * cls.requests[None, :]
        used = torch.where(
            sel_f, statics.tmpl_daemon[tmpl_idx] + fresh_a[:, None].to(F32) * cls.requests[None, :],
            used,
        )
        kmask = torch.where(sel_o[..., None], merged.mask, state_i.kmask)
        kmask = torch.where(sel_f[..., None], tmpl_merged.mask[tmpl_idx], kmask)
        kdef = torch.where(sel_o, merged.defined, state_i.kdef)
        kdef = torch.where(sel_f, tmpl_merged.defined[tmpl_idx], kdef)
        kneg = torch.where(sel_o, merged.negative, state_i.kneg)
        kneg = torch.where(sel_f, tmpl_merged.negative[tmpl_idx], kneg)
        kgt = torch.where(sel_o, merged.gt, state_i.kgt)
        kgt = torch.where(sel_f, tmpl_merged.gt[tmpl_idx], kgt)
        klt = torch.where(sel_o, merged.lt, state_i.klt)
        klt = torch.where(sel_f, tmpl_merged.lt[tmpl_idx], klt)
        zone = torch.where(sel_o, zhot_o, state_i.zone)
        zone = torch.where(sel_f, zhot_f, zone)
        ct = torch.where(sel_o, ct_ok, state_i.ct)
        ct = torch.where(sel_f, t_ct[tmpl_idx], ct)
        # the reference's v_open & (cap_ni >= a) — the zone's masked capacity
        # equals cap_ni wherever v_open holds
        v_open, c_open = viable_z[0], capm_z[0]
        for z in range(1, n_zones):
            at_z = (zopen == z)[:, None]
            v_open = torch.where(at_z, viable_z[z], v_open)
            c_open = torch.where(at_z, capm_z[z], c_open)
        viable = torch.where(sel_o, v_open & (c_open >= a_open_acc[:, None]), state_i.viable)
        viable = torch.where(sel_f, fresh_viable, viable)
        if ft.host_ports:
            ports_pl = torch.where(sel_o, state_i.ports | cls.ports[None, :], state_i.ports)
            ports_pl = torch.where(sel_f, (fresh_a > 0)[:, None] & cls.ports[None, :], ports_pl)
        else:
            ports_pl = state_i.ports
        pod_count = state_i.pod_count + a_open_acc
        pod_count = torch.where(is_fresh, fresh_a, pod_count)
        tmpl_id = torch.where(is_fresh, tmpl_idx.to(I32), state_i.tmpl_id)
        state_o = NodeState(used, kmask, kdef, kneg, kgt, klt, zone, ct, viable, ports_pl,
                            pod_count, tmpl_id, state_i.open_ | is_fresh, n_next)
        return state_o, ex_o, a_open_acc + fresh_a, a_ex_acc, placed, rem

    # zones some template can serve for this class, or where an eligible
    # existing node with intake left sits
    if ft.zone_spread or ft.zone_affinity:
        offers = (
            statics.tmpl_it[:, :, None, None]
            & (statics.it_avail & cls.it[:, None, None])[None]
            & statics.tmpl_zone[:, None, :, None]
            & (statics.tmpl_ct & cls.ct[None, :])[:, None, None, :]
        )  # [T, I, Z, CT]
        tmpl_offers = offers.any(dim=3).any(dim=1).any(dim=0)  # [Z]
        ex_cap_spread = ex_prep.cap if ok_ex is None else torch.where(ok_ex, ex_prep.cap, 0)
        ex_cap_z = _isum(
            torch.minimum(ex_cap_spread, m)[:, None] * ex_prep.zone_full.to(I32), dim=0
        )  # i32[Z]
        fillable = tmpl_offers | (ex_cap_z > 0)

    # -- zone spread phases ---------------------------------------------------
    spread_suspect = torch.zeros((), dtype=torch.bool, device=dev)
    if ft.zone_spread:
        counts_zs = _take(zone_fwd, g_zs)  # [Z]
        member_zs = _take(member_row, g_zs)
        cap_pods_z = torch.where(tmpl_offers, UNLIMITED, torch.clamp(ex_cap_z, max=UNLIMITED)).to(I32)
        unreachable = allowed_zone & ~fillable
        skew_zs = _take(statics.grp_skew, g_zs)
        bigi = 1 << 30
        finite_cap = cap_pods_z < UNLIMITED
        quotas = torch.zeros(n_zones, dtype=I32, device=dev)
        sat = torch.zeros(n_zones, dtype=torch.bool, device=dev)
        m_rem = m
        for _ in range(n_zones + 1):
            counts_now = counts_zs + quotas
            min_frozen = torch.where(unreachable | sat, counts_now, bigi).amin()
            skew_cap = torch.clamp(min_frozen + skew_zs - counts_now, 0, UNLIMITED)
            active = allowed_zone & fillable & ~sat
            cap_rem = torch.clamp(cap_pods_z - quotas, 0, UNLIMITED)
            lvl_sat = torch.where(active & finite_cap, counts_now + cap_rem, bigi).amin()
            q = _water_fill(counts_now, active, m_rem)
            q = torch.minimum(q, torch.clamp(lvl_sat - counts_now, 0, UNLIMITED))
            q = torch.minimum(q, torch.minimum(skew_cap, cap_rem))
            q = torch.where(active, q, 0)
            quotas = quotas + q
            m_rem = m_rem - _isum(q)
            sat = sat | (active & finite_cap & (quotas >= cap_pods_z))
        quotas = torch.where(member_zs, quotas, 0)
        counts_end = counts_zs + quotas
        min_frozen_end = torch.where(unreachable | sat, counts_end, bigi).amin()
        skew_headroom = (counts_end - min_frozen_end) < skew_zs
        cap_headroom = (cap_pods_z - quotas) > 0
        fill_residual = (m_rem > 0) & (
            allowed_zone & fillable & ~sat & skew_headroom & cap_headroom
        ).any()
        quotas_gated = torch.where(has_zs, quotas, 0)
        results_zs = committal_block(quotas_gated, torch.full((), UNLIMITED, dtype=I32, device=dev))
        placed_zs = results_zs[4]
        accumulate(results_zs)
        quota_shortfall = placed_zs < _isum(quotas)
        spread_suspect = has_zs & member_zs & (fill_residual | quota_shortfall)

        # non-self-selecting zone spread: a static admissible-zone mask
        min_zs = torch.where(cls.zone, counts_zs, 1 << 30).amin()
        admissible_zs = allowed_zone & (counts_zs - min_zs <= _take(statics.grp_skew, g_zs))
        q_nm = torch.where(has_zs & ~member_zs & admissible_zs.any(), m, 0).to(I32)
        accumulate(run_phase(q_nm, admissible_zs))

    # -- owned zone anti-affinity: zero-forward-count zones only --------------
    if ft.zone_anti:
        zero_zones = allowed_zone & (_take(zone_fwd, g_zan) == 0)
        anti_member = _take(member_row, g_zan)
        anti_required = has_zan & anti_member & ~cls.anti_soft[0]
        if ft.required_zone_anti:
            anti_quota_z = (anti_required & zero_zones).to(I32)
            accumulate(committal_block(anti_quota_z, m))
        anti_quota = torch.where(
            has_zan & zero_zones.any(),
            torch.where(anti_member, torch.where(cls.anti_soft[0], torch.clamp(m, max=1), 0), m),
            0,
        ).to(I32)
        accumulate(run_phase(anti_quota, zero_zones))

    # -- zone affinity: nonzero-count zones, else self-members bootstrap one
    if ft.zone_affinity:
        bootstrap_allowed = allowed_zone & fillable
        nonzero_zones = allowed_zone & (_take(zone_fwd, g_zaf) > 0)
        bootstrap_zone = torch.zeros(n_zones, dtype=torch.bool, device=dev).index_put(
            (_argmax_first(bootstrap_allowed).reshape(1),),
            (bootstrap_allowed.any() & _take(member_row, g_zaf)).reshape(1),
        )
        zone_aff_restrict = torch.where(nonzero_zones.any(), nonzero_zones, bootstrap_zone)
        zone_aff_quota = torch.where(
            has_zaf & ~has_haf & zone_aff_restrict.any(), m, 0
        ).to(I32)
        accumulate(run_phase(zone_aff_quota, zone_aff_restrict))

    # -- hostname affinity: fill target nodes; else bootstrap exactly one node
    all_zones = torch.ones(n_zones, dtype=torch.bool, device=dev)
    if ft.host_affinity:
        if ft.zone_affinity:
            host_restrict = torch.where(has_zaf, zone_aff_restrict, all_zones) & allowed_zone
        else:
            host_restrict = all_zones & allowed_zone
        targets_ex = (_take(topo.fwd_ex, g_haf) > 0) & ex.open_
        targets_new = (_take(topo.fwd_new, g_haf) > 0) & state.open_
        targets_exist = targets_ex.any() | targets_new.any()
        host_quota = torch.where(has_haf, m, 0).to(I32)
        q_targets = torch.where(targets_exist, host_quota, 0).to(I32)
        accumulate(run_phase(q_targets, host_restrict, targets_ex=targets_ex,
                             targets_new=targets_new, max_new_nodes=0))
        q_boot = torch.where(targets_exist | ~_take(member_row, g_haf), 0, host_quota).to(I32)
        accumulate(run_phase(q_boot, host_restrict, single_node=True, max_new_nodes=1))

    # -- unconstrained phase for plain classes --------------------------------
    any_quota = torch.where(has_zs | has_zan | has_zaf | has_haf, 0, m).to(I32)
    accumulate(run_phase(any_quota, allowed_zone))

    # -- record (topology.go:120-143): per-node group counts ------------------
    if (ft.zone_spread or ft.host_spread or ft.zone_affinity or ft.host_affinity
            or ft.zone_anti or ft.host_anti or ft.inv_zone_anti or ft.inv_host_anti):
        a_ex_f = totals["ex"]
        a_new_f = totals["new"]
        member_i = member_row.to(I32)
        own_zan_inv = torch.where(cls.anti_soft[0], 0, own_onehot(g_zan).to(I32)).to(I32)
        own_han_inv = torch.where(cls.anti_soft[1], 0, own_onehot(g_han).to(I32)).to(I32)
        own_inv = own_zan_inv + own_han_inv
        topo = TopoCounts(
            fwd_ex=topo.fwd_ex + member_i[:, None] * a_ex_f[None, :],
            inv_ex=topo.inv_ex + own_inv[:, None] * a_ex_f[None, :],
            fwd_new=topo.fwd_new + member_i[:, None] * a_new_f[None, :],
            inv_new=topo.inv_new + own_inv[:, None] * a_new_f[None, :],
        )

    failed = m - totals["placed"]
    return (state, ex, topo, remaining), (totals["new"], totals["ex"], failed, spread_suspect)


def solve_core(
    class_tensors: ClassTensors,
    statics_arrays: StaticArrays,
    n_slots: int,
    key_has_bounds,
    existing_state: Optional[ExistingState] = None,
    existing_static: Optional[ExistingStatic] = None,
    n_passes: int = 1,
    features: Optional[SnapshotFeatures] = None,
    use_kernels: bool = True,
) -> SolveOutputs:
    """The cold solve: scan the classes ``n_passes`` times over empty slots.

    Inputs are tensors on one device (``carry.tensors_from_numpy``), with
    masks in the bool layout the encode produces; they are bit-packed here.
    ``n_passes`` > 1 re-scans still-failed pods (an affinity follower that
    scans before its target, or a preference ladder's next rung), rolling
    failed counts down ``relax_next`` between passes.  ``use_kernels=False``
    runs the kernels' plain torch twins (the oracle on the card)."""
    ft = (ALL_FEATURES if features is None else SnapshotFeatures(*features)).canonical()
    sa = StaticArrays(*statics_arrays)
    width = sa.valid.shape[-1]  # semantic slot count V+1, pre-packing
    sa = sa._replace(
        it=mask_ops.pack_req(sa.it),
        tmpl=mask_ops.pack_req(sa.tmpl),
        valid=mask_ops.pack_mask(sa.valid),
    )
    class_tensors = class_tensors._replace(mask=mask_ops.pack_mask(class_tensors.mask))
    statics = Statics(*sa, key_has_bounds=tuple(key_has_bounds), mask_v=width,
                      k=KERNELS if use_kernels else PLAIN)
    dev = sa.it_alloc.device
    n_zones = statics.tmpl_zone.shape[-1]
    n_res = statics.it_alloc.shape[-1]
    n_keys = sa.it.defined.shape[-1]
    n_it = statics.it_alloc.shape[0]
    n_ct = statics.tmpl_ct.shape[-1]
    n_classes = class_tensors.count.shape[0]
    g1 = statics.grp_skew.shape[0]
    n_ports = class_tensors.ports.shape[-1] if n_classes else 1

    kmask0 = mask_ops.const_words("full", width, dev).expand(
        n_slots, n_keys, mask_ops.words_for(width)
    ).contiguous()
    state = NodeState(
        used=torch.zeros((n_slots, n_res), dtype=F32, device=dev),
        kmask=kmask0,
        kdef=torch.zeros((n_slots, n_keys), dtype=torch.bool, device=dev),
        kneg=torch.zeros((n_slots, n_keys), dtype=torch.bool, device=dev),
        kgt=torch.full((n_slots, n_keys), -np.inf, dtype=F32, device=dev),
        klt=torch.full((n_slots, n_keys), np.inf, dtype=F32, device=dev),
        zone=torch.ones((n_slots, n_zones), dtype=torch.bool, device=dev),
        ct=torch.ones((n_slots, n_ct), dtype=torch.bool, device=dev),
        viable=torch.ones((n_slots, n_it), dtype=torch.bool, device=dev),
        ports=torch.zeros((n_slots, n_ports), dtype=torch.bool, device=dev),
        pod_count=torch.zeros(n_slots, dtype=I32, device=dev),
        tmpl_id=torch.zeros(n_slots, dtype=I32, device=dev),
        open_=torch.zeros(n_slots, dtype=torch.bool, device=dev),
        n_next=torch.zeros((), dtype=I32, device=dev),
    )
    if existing_state is None:
        existing_state = empty_existing_state(n_res, n_keys, width, n_zones, n_ct, n_ports,
                                              device=dev)
        existing_static = empty_existing_static(n_res, n_classes, g1, device=dev)
    if existing_state.kmask.dtype == torch.bool:
        existing_state = existing_state._replace(kmask=mask_ops.pack_mask(existing_state.kmask))

    # seed topology counts from pre-existing pods (topology.go:231-276)
    open_i = existing_state.open_.to(I32)
    topo = TopoCounts(
        fwd_ex=existing_static.grp_node_member * open_i[None, :],
        inv_ex=existing_static.grp_node_owner * open_i[None, :],
        fwd_new=torch.zeros((g1, n_slots), dtype=I32, device=dev),
        inv_new=torch.zeros((g1, n_slots), dtype=I32, device=dev),
    )
    # charge open owned nodes' capacity against their provisioner's budget
    n_tmpl = statics.tmpl_zone.shape[0]
    tmpl_onehot = (
        existing_static.node_tmpl[:, None] == torch.arange(n_tmpl, device=dev)[None, :]
    ) & (existing_static.node_owned & existing_state.open_)[:, None]  # [E, T]
    used_budget = (
        tmpl_onehot.to(F32)[:, :, None] * existing_static.node_capacity[:, None, :]
    ).sum(dim=0)  # [T, R]
    remaining0 = statics.tmpl_limits0 - used_budget

    carry = (state, existing_state, topo, remaining0)
    n_ex = existing_state.pod_count.shape[0]
    assign = torch.zeros((n_classes, n_slots), dtype=I32, device=dev)
    assign_ex = torch.zeros((n_classes, n_ex), dtype=I32, device=dev)
    count_left = class_tensors.count
    failed = count_left
    suspect = torch.zeros(n_classes, dtype=torch.bool, device=dev)
    cls_indices = _ar(n_classes, dev)
    global host_syncs
    for p in range(max(n_passes, 1)):
        # the reference's per-class lax.cond(count > 0): one host read of the
        # pass's counts decides every skip
        host_syncs += 1
        counts_host = count_left.cpu().tolist()
        a_rows, a_ex_rows, failed_rows, suspect_rows = [], [], [], []
        for c in range(n_classes):
            if counts_host[c] > 0:
                cls = ClassTensors(*(t[c] for t in class_tensors))._replace(count=count_left[c])
                carry, (a, a_ex, f, s) = _class_step(
                    statics, existing_static, n_zones, carry, cls, c, features=ft,
                )
            else:
                a = torch.zeros(n_slots, dtype=I32, device=dev)
                a_ex = torch.zeros(n_ex, dtype=I32, device=dev)
                f = torch.zeros((), dtype=I32, device=dev)
                s = torch.zeros((), dtype=torch.bool, device=dev)
            a_rows.append(a)
            a_ex_rows.append(a_ex)
            failed_rows.append(f)
            suspect_rows.append(s)
        if n_classes:
            assign = assign + torch.stack(a_rows)
            assign_ex = assign_ex + torch.stack(a_ex_rows)
            failed = torch.stack(failed_rows).to(I32)
            suspect = suspect | torch.stack(suspect_rows)
        # roll failed counts one step down the preference ladder; classes with
        # no successor retry as themselves (late-affinity re-scan).  Several
        # rows can roll into one: index_add sums duplicates as `.at[].add`
        roll_to = torch.where(class_tensors.relax_next >= 0, class_tensors.relax_next, cls_indices)
        count_left = torch.zeros_like(failed).index_add(0, roll_to.long(), failed)
        if p + 1 < n_passes:
            # shared volume adds are once per (ladder, node): collapse
            # placements to the root row before the add (scatter_reduce amax
            # over duplicate roots, the reference's `.at[root].max`)
            state_c, ex_c, topo_c, rem_c = carry
            placed_any = (assign_ex > 0).to(I32)  # [C, E]
            placed_root = torch.zeros_like(placed_any).scatter_reduce(
                0, class_tensors.root.long()[:, None].expand_as(placed_any), placed_any, "amax",
            )
            is_root = (class_tensors.root == cls_indices)[:, None].to(I32)
            shared = _isum((placed_root * is_root)[:, :, None] * existing_static.cls_vol_add, dim=0)
            per_pod = _isum(assign_ex[:, :, None] * existing_static.cls_vol_per_pod[:, None, :], dim=0)
            ex_c = ex_c._replace(vol_used=existing_state.vol_used + shared + per_pod)
            carry = (state_c, ex_c, topo_c, rem_c)
    final_state, final_ex, final_topo, final_remaining = carry
    return SolveOutputs(
        assign=assign, assign_existing=assign_ex, failed=failed, state=final_state,
        ex_state=final_ex, spread_suspect=suspect, topo=final_topo, remaining=final_remaining,
    )


def empty_existing_state(n_res, n_keys, width, n_zones, n_ct, n_ports: int = 1,
                         n_drivers: int = 1, device="cpu") -> ExistingState:
    """A single closed dummy slot (the reference's E=0 stand-in)."""
    dev = torch.device(device)
    return ExistingState(
        used=torch.zeros((1, n_res), dtype=F32, device=dev),
        kmask=torch.ones((1, n_keys, width), dtype=torch.bool, device=dev),
        kdef=torch.zeros((1, n_keys), dtype=torch.bool, device=dev),
        kneg=torch.zeros((1, n_keys), dtype=torch.bool, device=dev),
        kgt=torch.full((1, n_keys), -np.inf, dtype=F32, device=dev),
        klt=torch.full((1, n_keys), np.inf, dtype=F32, device=dev),
        zone=torch.ones((1, n_zones), dtype=torch.bool, device=dev),
        ct=torch.ones((1, n_ct), dtype=torch.bool, device=dev),
        ports=torch.zeros((1, n_ports), dtype=torch.bool, device=dev),
        vol_used=torch.zeros((1, n_drivers), dtype=I32, device=dev),
        pod_count=torch.zeros(1, dtype=I32, device=dev),
        open_=torch.zeros(1, dtype=torch.bool, device=dev),
    )


def empty_existing_static(n_res, n_classes, n_groups1: int = 1, n_drivers: int = 1,
                          device="cpu") -> ExistingStatic:
    dev = torch.device(device)
    return ExistingStatic(
        alloc=torch.zeros((1, n_res), dtype=F32, device=dev),
        init=torch.zeros(1, dtype=torch.bool, device=dev),
        tol=torch.zeros((n_classes, 1), dtype=torch.bool, device=dev),
        grp_node_member=torch.zeros((n_groups1, 1), dtype=I32, device=dev),
        grp_node_owner=torch.zeros((n_groups1, 1), dtype=I32, device=dev),
        node_capacity=torch.zeros((1, n_res), dtype=F32, device=dev),
        node_tmpl=torch.zeros(1, dtype=I32, device=dev),
        node_owned=torch.zeros(1, dtype=torch.bool, device=dev),
        vol_limit=torch.full((1, n_drivers), UNLIMITED, dtype=I32, device=dev),
        cls_vol_add=torch.zeros((n_classes, 1, n_drivers), dtype=I32, device=dev),
        cls_vol_per_pod=torch.zeros((n_classes, n_drivers), dtype=I32, device=dev),
    )


# -- host-side helpers (numpy; copies of the reference's) ---------------------


def snapshot_features(snapshot) -> SnapshotFeatures:
    """The snapshot's static phase plan, normalized (all-on when absent)."""
    f = getattr(snapshot, "features", None)
    if f is None:
        return ALL_FEATURES._replace(
            required_zone_anti=bool(getattr(snapshot, "has_required_zonal_anti", True))
        ).canonical()
    return SnapshotFeatures(*f).canonical()


class HostReq(NamedTuple):
    """A numpy ReqTensor (the encode's bool mask layout)."""

    mask: np.ndarray
    defined: np.ndarray
    negative: np.ndarray
    gt: np.ndarray
    lt: np.ndarray


def prepare_host(snapshot: EncodedSnapshot):
    """Kernel inputs still on host (numpy): (class_tensors, statics_arrays,
    key_has_bounds)."""
    cls = ClassTensors(
        mask=snapshot.cls_mask, defined=snapshot.cls_defined, negative=snapshot.cls_negative,
        gt=snapshot.cls_gt, lt=snapshot.cls_lt, zone=snapshot.cls_zone, ct=snapshot.cls_ct,
        it=snapshot.cls_it, requests=snapshot.cls_requests, count=snapshot.cls_count,
        tol=snapshot.cls_tol, ports=snapshot.cls_ports, groups=snapshot.cls_groups,
        relax_next=snapshot.cls_relax_next, anti_soft=snapshot.cls_anti_soft,
        root=snapshot.cls_root,
    )
    statics_arrays = StaticArrays(
        it=HostReq(snapshot.it_mask, snapshot.it_defined, snapshot.it_negative,
                   snapshot.it_gt, snapshot.it_lt),
        it_alloc=snapshot.it_alloc,
        it_avail=snapshot.it_avail,
        tmpl=HostReq(snapshot.tmpl_mask, snapshot.tmpl_defined, snapshot.tmpl_negative,
                     snapshot.tmpl_gt, snapshot.tmpl_lt),
        tmpl_zone=snapshot.tmpl_zone,
        tmpl_ct=snapshot.tmpl_ct,
        tmpl_it=snapshot.tmpl_it,
        tmpl_daemon=snapshot.tmpl_daemon,
        tmpl_limits0=snapshot.tmpl_limits,
        it_capacity=snapshot.it_capacity,
        valid=snapshot.valid,
        is_custom=snapshot.is_custom,
        vocab_ints=snapshot.vocab_ints,
        grp_skew=snapshot.grp_skew,
        grp_is_zone=snapshot.grp_is_zone,
        grp_is_anti=snapshot.grp_is_anti,
        grp_member=snapshot.grp_member,
    )
    key_has_bounds = tuple(
        bool(np.isfinite(snapshot.cls_gt[:, k]).any() or np.isfinite(snapshot.cls_lt[:, k]).any()
             or np.isfinite(snapshot.it_gt[:, k]).any() or np.isfinite(snapshot.it_lt[:, k]).any()
             or np.isfinite(snapshot.tmpl_gt[:, k]).any() or np.isfinite(snapshot.tmpl_lt[:, k]).any())
        for k in range(snapshot.valid.shape[0])
    )
    return cls, statics_arrays, key_has_bounds


def estimate_slots(snapshot: EncodedSnapshot) -> int:
    """Optimistic node-count estimate: per class, best pods-per-node over the
    catalog, plus slack for zone phases; rounded up to a power of two.  (The
    reference also snaps it to a previously compiled size; the port compiles
    nothing per shape, so the estimate stands as it is.)"""
    total = 16 + bucket(len(snapshot.classes)) * snapshot.cls_zone.shape[1]
    alloc = snapshot.it_alloc  # [I, R]
    for c, cls in enumerate(snapshot.classes):
        size = snapshot.cls_requests[c]  # [R]
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.floor(np.where(size > 0, alloc / np.maximum(size, 1e-9), np.inf))
        per_it = np.min(np.where(np.isfinite(per), per, np.inf), axis=-1)
        best = np.max(per_it) if per_it.size else 0
        host_cap = float(UNLIMITED)
        if cls.host_spread is not None:
            host_cap = float(cls.host_spread.skew)
        if cls.host_anti is not None:
            host_cap = 1.0
        best = max(1.0, min(best, host_cap))
        total += int(np.ceil(float(snapshot.cls_count[c]) / best))
    return int(2 ** np.ceil(np.log2(max(total, 16))))


# -- shape-bucket padding (semantically invisible; see the reference) ---------


def bucket(n: int, floor: int = 8) -> int:
    """Smallest grid value >= max(n, floor); the grid is the powers of two
    and 1.5x powers of two starting at 2 (2, 3, 4, 6, 8, 12, ...)."""
    target = max(int(n), int(floor), 2)
    b = 2
    while b < target:
        b = b * 3 // 2 if (b & (b - 1)) == 0 else (b // 3) * 4
    return b


def _pad_axis(a: np.ndarray, axis: int, target: int, value) -> np.ndarray:
    cur = a.shape[axis]
    if cur >= target:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, target - cur)
    return np.pad(a, widths, constant_values=value)


def _widen_mask(mask: np.ndarray, v_new: int) -> np.ndarray:
    """Insert always-False value slots before the trailing "unseen" slot."""
    v = mask.shape[-1] - 1
    if v >= v_new:
        return mask
    block = np.zeros(mask.shape[:-1] + (v_new - v,), dtype=mask.dtype)
    return np.concatenate([mask[..., :v], block, mask[..., v:]], axis=-1)


def _pad_req(t, k_new: int, v_new: int) -> HostReq:
    """Pad a host ReqTensor's K axis (undefined keys, mask=ones) and
    vocabulary width (False slots before "unseen")."""
    mask = _widen_mask(np.asarray(t.mask), v_new)
    mask = _pad_axis(mask, -2, k_new, True)
    return HostReq(
        mask=mask,
        defined=_pad_axis(np.asarray(t.defined), -1, k_new, False),
        negative=_pad_axis(np.asarray(t.negative), -1, k_new, False),
        gt=_pad_axis(np.asarray(t.gt), -1, k_new, -np.inf),
        lt=_pad_axis(np.asarray(t.lt), -1, k_new, np.inf),
    )


def pad_planes(cls, statics_arrays, key_has_bounds):
    """Bucket-pad host kernel inputs (prepare_host output) so nearby problem
    sizes share shapes: padded classes have count 0, padded keys are
    undefined everywhere, padded value slots are False, padded groups clone
    the dummy "none" row.  Returns (cls, statics_arrays, key_has_bounds)."""
    sa = StaticArrays(*statics_arrays)
    c_old = cls.count.shape[0]
    k_old = sa.valid.shape[0]
    v_old = sa.valid.shape[1] - 1
    g1_old = sa.grp_skew.shape[0]
    p_old = cls.ports.shape[-1]
    c_new = bucket(c_old)
    k_new = bucket(k_old)
    v_new = bucket(v_old)
    g1_new = bucket(g1_old - 1, floor=4) + 1
    p_new = bucket(p_old, floor=4)

    groups = np.asarray(cls.groups)
    groups = np.where(groups >= g1_old - 1, g1_new - 1, groups)
    cls_t = _pad_req(HostReq(cls.mask, cls.defined, cls.negative, cls.gt, cls.lt), k_new, v_new)
    cls = ClassTensors(
        mask=_pad_axis(cls_t.mask, 0, c_new, True),
        defined=_pad_axis(cls_t.defined, 0, c_new, False),
        negative=_pad_axis(cls_t.negative, 0, c_new, False),
        gt=_pad_axis(cls_t.gt, 0, c_new, -np.inf),
        lt=_pad_axis(cls_t.lt, 0, c_new, np.inf),
        zone=_pad_axis(np.asarray(cls.zone), 0, c_new, True),
        ct=_pad_axis(np.asarray(cls.ct), 0, c_new, True),
        it=_pad_axis(np.asarray(cls.it), 0, c_new, True),
        requests=_pad_axis(np.asarray(cls.requests), 0, c_new, 0),
        count=_pad_axis(np.asarray(cls.count), 0, c_new, 0),
        tol=_pad_axis(np.asarray(cls.tol), 0, c_new, False),
        ports=_pad_axis(_pad_axis(np.asarray(cls.ports), -1, p_new, False), 0, c_new, False),
        groups=_pad_axis(groups, 0, c_new, g1_new - 1),
        relax_next=_pad_axis(np.asarray(cls.relax_next), 0, c_new, -1),
        anti_soft=_pad_axis(np.asarray(cls.anti_soft), 0, c_new, False),
        root=_pad_axis(np.asarray(cls.root), 0, c_new, 0),
    )
    statics_arrays = sa._replace(
        it=_pad_req(sa.it, k_new, v_new),
        tmpl=_pad_req(sa.tmpl, k_new, v_new),
        valid=_pad_axis(_widen_mask(np.asarray(sa.valid), v_new), 0, k_new, False),
        is_custom=_pad_axis(np.asarray(sa.is_custom), 0, k_new, False),
        vocab_ints=_pad_axis(
            _pad_axis(np.asarray(sa.vocab_ints), -1, v_new, np.inf), 0, k_new, np.inf
        ),
        grp_skew=_pad_axis(np.asarray(sa.grp_skew), 0, g1_new, UNLIMITED),
        grp_is_zone=_pad_axis(np.asarray(sa.grp_is_zone), 0, g1_new, False),
        grp_is_anti=_pad_axis(np.asarray(sa.grp_is_anti), 0, g1_new, False),
        grp_member=_pad_axis(
            _pad_axis(np.asarray(sa.grp_member), -1, g1_new, False), 0, c_new, False
        ),
    )
    key_has_bounds = tuple(key_has_bounds) + (False,) * (k_new - k_old)
    return cls, statics_arrays, key_has_bounds
