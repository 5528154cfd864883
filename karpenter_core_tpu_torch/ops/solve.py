"""The bin-packing solve, in torch.

The port of ``karpenter_core_tpu/ops/solve.py``: pods grouped into
equivalence classes are scanned class by class;
each class step tries the existing nodes first, then new node slots, through
the zone-spread committal block (its quotas from the water-fill rounds), the
affinity / anti-affinity phases and the unconstrained phase — dense work
over E existing nodes and N node slots x I instance types — then records
topology counts.  Without existing nodes the existing-node planes are one
closed dummy row.

Device work goes through eight hand-written CUDA kernels (``kernels/``):

  K1 ``it_capacity``      viability + per-type capacity + row max
  K2 ``fill``             priority fill (stable sort + exclusive scan)
  K3 ``merge_compat`` / ``req_compat``
                          requirement merge + compatibility (or compatibility
                          alone: the existing rows, merged by K6's commit)
  K4 ``pack_bool``        the decode fetch's bit-packing
  K5 ``existing_intake``  each existing node's intake of one class
  K6 ``existing_mask_fill`` / ``existing_mask`` / ``existing_commit``
                          an existing-node fill (mask, fill and sum in one
                          launch; or the caps and priorities alone, for a
                          fill with hole preferences), and the state commit
  K7 ``spread_quota``     the zone-spread quota rounds (water-fill)
  K23 ``slot_commit``     the new-node slot state after a phase's or a
                          committal block's pods land (open and fresh slots
                          in one launch)

A warm-start repair (``solver.incremental``) resumes the scan from a
previous solve's final carry (``WarmCarry``) with only the delta pods
counted (``solve_core(warm_carry=, repair_plan=)``); three more kernels
reshape the carry around it:

  K10 ``repair_free``     evicted pods' capacity and counts back to the carry
  K11 ``gather_window``   the repair window's rows, and its out-of-window bases
  K12 ``scatter_window``  the window written back over the full-width carry

``solve_core(..., use_kernels=False)`` runs their plain torch twins instead:
the oracle a card run holds the kernels against.  On CPU tensors the
wrappers run the twins anyway.

Where the reference runs ``lax.scan`` over classes and ``lax.cond`` around
each class and phase, this runs a Python loop with explicit skips; each skip
decision is one host read (``host_syncs`` counts them).

Every plane carries a leading tenant axis B: ``solve_core_batched`` is the
reference's ``jax.vmap`` of the solve body (the coalesced multi-tenant
solve, ``utils/compilecache.batched_solve_callable``), and ``solve_core`` is
its B = 1 case.  A skip reads the [B] predicates at once: the class or
phase runs when some tenant needs it, for all of them, and the others keep
their carry (``_select``, vmap's select of a batched ``lax.cond``).  Each
kernel launch covers every tenant, so launches and host reads do not grow
with B.

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
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from karpenter_core_tpu_torch.kernels import batch
from karpenter_core_tpu_torch.kernels import capacity as k1
from karpenter_core_tpu_torch.kernels import classfinish as k15
from karpenter_core_tpu_torch.kernels import commit as k23
from karpenter_core_tpu_torch.kernels import existing as k56
from karpenter_core_tpu_torch.kernels import fill as k2
from karpenter_core_tpu_torch.kernels import packbits as k4
from karpenter_core_tpu_torch.kernels import repair as k1012
from karpenter_core_tpu_torch.kernels import reqmerge as k3
from karpenter_core_tpu_torch.kernels import spread as k7
from karpenter_core_tpu_torch.kernels.capacity import BIG, INT32_MAX, UNLIMITED
from karpenter_core_tpu_torch.kernels.existing import ExistingState
from karpenter_core_tpu_torch.models.snapshot import EncodedSnapshot
from karpenter_core_tpu_torch.ops import masks as mask_ops

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

    def covers(self, other: "SnapshotFeatures") -> bool:
        """True when a scan planned with ``self`` is sound for a snapshot
        requesting ``other`` (``self`` is a flag superset)."""
        return all(a or not b for a, b in zip(self, other))

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


class WarmCarry(NamedTuple):
    """The previous solve's final scan carry, the initial state of a
    warm-start repair solve (see the reference's docstring): every placement
    it committed (``state``, ``ex_state``), the topology-group counts and the
    provisioner-limit budget.  Masks are packed."""

    state: NodeState
    ex_state: ExistingState
    topo: TopoCounts
    remaining: torch.Tensor  # f32[T, R]


class RepairPlan(NamedTuple):
    """The dirty-region plan of a repair solve: the per-class freed-hole
    planes every fill refills first (capped at the freed count), and the
    [G1, Z] topology counts of the new-node slots outside a bounded repair
    window, which the zone derivations add as constants (all zeros when the
    repair runs unwindowed)."""

    pref_new: torch.Tensor  # i32[C, N]
    pref_ex: torch.Tensor  # i32[C, E]
    base_fwd_sing: torch.Tensor  # i32[G1, Z]
    base_fwd_full: torch.Tensor  # i32[G1, Z]
    base_inv_full: torch.Tensor  # i32[G1, Z]


class Kernels(NamedTuple):
    """The device kernels the solve calls: the CUDA wrappers, or their plain
    torch twins (``use_kernels=False``)."""

    it_capacity: object
    fill: object
    merge_compat: object
    pack_bool: object
    existing_intake: object
    existing_mask: object
    existing_commit: object
    spread_quota: object
    repair_free: object
    gather_window: object
    scatter_window: object
    existing_mask_fill: object
    req_compat: object
    slot_commit: object


KERNELS = Kernels(k1.it_capacity, k2.fill_by_priority, k3.merge_compat, k4.pack_bool,
                  k56.existing_intake, k56.existing_mask, k56.existing_commit,
                  k7.spread_quota, k1012.repair_free, k1012.gather_window,
                  k1012.scatter_window, k56.existing_mask_fill, k3.req_compat,
                  k23.slot_commit)
# the twins of the scan's kernels take the tenant axis as their wrappers do
PLAIN = Kernels(k1.it_capacity_twin, k2.fill_by_priority_twin,
                k3.merge_compat_twin, k4.pack_bool_plain, k56.existing_intake_twin,
                k56.existing_mask_twin, k56.existing_commit_twin, k7.spread_quota_twin,
                k1012.repair_free_plain, k1012.gather_window_plain,
                k1012.scatter_window_plain, k56.existing_mask_fill_twin, k3.req_compat_twin,
                k23.slot_commit_twin)


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
    # the class row and vocabulary K6's commit merges the rows it selects
    # with (the reference keeps the merged planes of every row here)
    merge: k3.ClassMerge
    zone_full: torch.Tensor  # bool[E, Z]
    ct_ok: torch.Tensor  # bool[E, CT]
    vol_add: torch.Tensor  # i32[E, D]
    vol_per_pod: torch.Tensor  # i32[D]


# -- small helpers ------------------------------------------------------------
# Every plane of the scan carries a leading tenant axis B (a solo solve is
# B = 1): a per-tenant scalar is a [B] vector, a per-node plane [B, N, ...].


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


def _col(x: torch.Tensor) -> torch.Tensor:
    """A per-tenant [B] vector as a [B, 1] column, broadcast along a row."""
    return x[:, None]


def _argmax_first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none) —
    ``jnp.argmax`` of a bool."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` for every tenant b: one gather on the device.  (Plain
    indexing with a 0-dim integer tensor reads the index on the host, a
    hidden synchronisation per use.)"""
    at = idx.long().view((-1, 1) + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, at.expand((-1, 1) + tuple(x.shape[2:]))).squeeze(1)


def _add_row(x: torch.Tensor, idx: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]] += delta[b]`` for every tenant (the reference's
    ``.at[t].add``): one add per tenant, every other row untouched."""
    at = idx.long()[:, None, None].expand(-1, 1, x.shape[-1])
    return x.scatter_add(1, at, delta[:, None, :])


def _sync_positive(x: torch.Tensor):
    """Host read of ``x > 0`` for every tenant (one read of a [B] vector):
    the port's ``lax.cond`` predicate, batched as vmap batches it.  Returns
    (any tenant, every tenant, the device mask)."""
    global host_syncs
    host_syncs += 1
    on = x > 0
    on_host = on.cpu().numpy()
    return bool(on_host.any()), bool(on_host.all()), on


def _select(on: torch.Tensor, new, old):
    """Per tenant, ``new`` where ``on[b]`` else ``old``, leaf for leaf over
    nested tuples: vmap's select for a ``lax.cond`` whose predicate differs
    between tenants (no kernel writes a tensor it was given, so ``old`` is
    intact)."""
    if isinstance(new, torch.Tensor):
        return torch.where(on.view((-1,) + (1,) * (new.dim() - 1)), new, old)
    parts = [_select(on, a, b) for a, b in zip(new, old)]
    return type(new)(*parts) if hasattr(new, "_fields") else tuple(parts)


def _select_committed(on: torch.Tensor, out: tuple, old: tuple) -> tuple:
    """``_select`` of a phase's or committal block's outputs whose slot state
    K23 already kept for the tenants that skip it (``k23.keep_skipped``;
    ``n_next`` too): only the rest is selected here."""
    return (out[0],) + _select(on, tuple(out[1:]), tuple(old[1:]))


def _cls_req(cls) -> mask_ops.ReqTensor:
    return mask_ops.ReqTensor(
        cls.mask[:, None], cls.defined[:, None], cls.negative[:, None], cls.gt[:, None],
        cls.lt[:, None],
    )


def _merge_compat(rows: mask_ops.ReqTensor, cls, statics: Statics):
    """(merged, compat) of every row against one class (K3)."""
    return statics.k.merge_compat(
        rows, _cls_req(cls), statics.valid, statics.vocab_ints, statics.is_custom,
        statics.mask_v, statics.key_has_bounds,
    )


def _class_merge(cls, statics: Statics) -> k3.ClassMerge:
    return k3.ClassMerge(_cls_req(cls), statics.valid, statics.vocab_ints, statics.mask_v,
                         statics.key_has_bounds)


def _it_cap(statics: Statics, viable, cls, merged, zone_ok, ct_ok, used):
    """(it_ok, cap_ni, cap_n) of one class over rows (K1)."""
    return statics.k.it_capacity(
        viable, cls.it, merged, statics.it, statics.vocab_ints, statics.mask_v,
        statics.key_has_bounds, zone_ok, ct_ok, statics.it_avail, used,
        cls.requests, statics.it_alloc,
    )


def _onehot_rows(n_b: int, n: int, n_zones: int, z: int, device) -> torch.Tensor:
    """bool[B, n, Z] with only column z set: a single-zone restriction."""
    out = torch.zeros((n_b, n, n_zones), dtype=torch.bool, device=device)
    out[..., z] = True
    return out


def _fill_with_pref(k: Kernels, quota, cap, priority, pref):
    """Priority fill (K2); with ``pref`` (warm repair holes) the holes take
    the quota first, capped at their freed counts."""
    if pref is None:
        return k.fill(quota, cap, priority)
    idx = _ar(cap.shape[-1], cap.device)
    hole_cap = torch.minimum(cap, pref)
    a0 = k.fill(quota, hole_cap, torch.where(hole_cap > 0, idx, INT32_MAX))
    cap_rest = cap - a0
    a1 = k.fill(quota - _isum(a0, dim=-1), cap_rest,
                torch.where(cap_rest > 0, priority, INT32_MAX))
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
    """Intake of the class on each existing node (0 = ineligible)
    (existingnode.go:77-130 at class granularity): the key compatibility is
    K3's compat entry point, the intake K5.  No merged planes: K6's commit
    merges the rows it selects (the merge is idempotent, and within a class
    step a row changes only through this class's commits)."""
    node_t = mask_ops.ReqTensor(ex.kmask, ex.kdef, ex.kneg, ex.kgt, ex.klt)
    key_ok = statics.k.req_compat(
        node_t, _cls_req(cls), statics.valid, statics.vocab_ints, statics.is_custom,
        statics.mask_v, statics.key_has_bounds,
    )
    cap, zone_full, ct_ok = statics.k.existing_intake(
        ex_static.alloc, ex.used, ex.open_, key_ok, tol_row, ex.zone, cls.zone, ex.ct, cls.ct,
        ex.ports, cls.ports, ex_static.vol_limit, ex.vol_used, vol_add_row, vol_per_pod_row,
        cls.requests, host_cap_vec, ft.host_ports, ft.volume_limits,
    )
    return ExClassPrep(cap=cap, merge=_class_merge(cls, statics), zone_full=zone_full,
                       ct_ok=ct_ok, vol_add=vol_add_row, vol_per_pod=vol_per_pod_row)


def _fill_existing(k: Kernels, prep_cap, zone, cls_zone, zone_restrict, extra_elig,
                   single_node, quota, pref):
    """(assigned, placed, zone_ok) of one existing-node fill: K6's fused
    mask and fill, or with ``pref`` K6's caps and ``_fill_with_pref``."""
    if pref is None:
        return k.existing_mask_fill(prep_cap, zone, cls_zone, zone_restrict, extra_elig,
                                    single_node, quota)
    cap, priority, zone_ok = k.existing_mask(prep_cap, zone, cls_zone, zone_restrict,
                                             extra_elig, single_node)
    assigned = _fill_with_pref(k, quota, cap, priority, pref)
    return assigned, _isum(assigned, dim=-1), zone_ok


def _commit_existing(k: Kernels, ex, prep, cls, assigned, zone_new, ft):
    """The existing-node state after ``assigned`` pods of the class land (K6)."""
    return k.existing_commit(
        ex, prep.merge, zone_new, prep.ct_ok, cls.ports, prep.vol_add, prep.vol_per_pod,
        cls.requests, assigned, ft.host_ports, ft.volume_limits,
    )


def _phase_existing(ex, prep, cls, quota, zone_restrict, k: Kernels, extra_elig=None,
                    single_node=False, ft=ALL_FEATURES, pref=None):
    """Place up to ``quota`` pods of the class onto existing nodes in index
    order (scheduler.go:176-180): K6's fused mask and fill (with hole
    preferences, K6's caps and K2's fills), then K6's commit.  Zone
    eligibility reads the LIVE zone mask."""
    assigned, placed, zone_ok = _fill_existing(k, prep.cap, ex.zone, cls.zone, zone_restrict,
                                               extra_elig, single_node, quota, pref)
    return _commit_existing(k, ex, prep, cls, assigned, zone_ok, ft), assigned, placed


def _phase(state: NodeState, cls, statics: Statics, quota, zone_restrict, host_cap_vec,
           fresh_host_cap, remaining, extra_elig=None, max_new_nodes=None,
           ft=ALL_FEATURES, pref=None, on=None):
    """Place up to ``quota`` pods of the class on slots whose zone mask meets
    ``zone_restrict`` — open slots first (emptiest first), then fresh slots
    from the first viable template — and commit both in one K23 launch.
    ``on`` [B] (None: every tenant) names the tenants the phase runs for:
    the others keep their slot state and ``n_next``.  Returns (state,
    assigned[B, N], placed, remaining)."""
    k = statics.k
    n_slots = state.used.shape[1]
    dev = state.used.device

    node_t = mask_ops.ReqTensor(state.kmask, state.kdef, state.kneg, state.kgt, state.klt)
    merged, key_ok = _merge_compat(node_t, cls, statics)
    zone_ok = state.zone & zone_restrict[:, None, :] & cls.zone[:, None, :]  # [B, N, Z]
    ct_ok = state.ct & cls.ct[:, None, :]  # [B, N, CT]
    tol_ok = torch.gather(cls.tol, 1, state.tmpl_id.long())  # [B, N]

    it_ok, cap_ni, cap_n = _it_cap(statics, state.viable, cls, merged, zone_ok, ct_ok, state.used)

    elig = state.open_ & key_ok & tol_ok & zone_ok.any(dim=-1) & ct_ok.any(dim=-1)
    if extra_elig is not None:
        elig = elig & extra_elig
    has_ports = None
    if ft.host_ports:
        has_ports = cls.ports.any(dim=-1)
        port_conflict = (state.ports & cls.ports[:, None, :]).any(dim=-1)
        elig = elig & ~port_conflict
        cap_n = torch.minimum(cap_n, _col(_i32c(has_ports, 1, UNLIMITED)))
    cap_n = torch.where(elig, torch.minimum(cap_n, host_cap_vec), 0)
    if max_new_nodes is not None and max_new_nodes == 1:
        first = _argmax_first(cap_n > 0)
        cap_n = torch.where(_ar(n_slots, dev)[None, :] == _col(first), cap_n, 0)

    # emptiest first (pod count, then slot index), packed into int32 exactly
    # as the reference packs it — the product wraps the same way if it ever
    # overflowed
    priority = state.pod_count * n_slots + _ar(n_slots, dev)
    priority = torch.where(cap_n > 0, priority, INT32_MAX)
    assigned = _fill_with_pref(k, quota, cap_n, priority, pref)
    placed_existing = _isum(assigned, dim=-1)

    # -- open fresh nodes (scheduler.go:192-217) ------------------------------
    rem = quota - placed_existing
    tmpl_merged, tmpl_key_ok = _merge_compat(statics.tmpl, cls, statics)
    t_zone = statics.tmpl_zone & zone_restrict[:, None, :] & cls.zone[:, None, :]  # [B, T, Z]
    t_ct = statics.tmpl_ct & cls.ct[:, None, :]
    # provisioner limits: drop types whose launch would breach the remaining
    # budget (scheduler.go:292-309)
    within_limits = (
        statics.it_capacity[:, None, :, :] <= remaining[:, :, None, :] + 1e-4
    ).all(dim=-1)  # [B, T, I]
    t_it_ok, t_cap_ti, t_cap = _it_cap(
        statics, statics.tmpl_it & within_limits, cls, tmpl_merged, t_zone, t_ct,
        statics.tmpl_daemon,
    )
    t_viable = cls.tol & tmpl_key_ok & t_zone.any(dim=-1) & t_ct.any(dim=-1) & (t_cap > 0)
    t_star = _argmax_first(t_viable)  # [B]
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
        _take(t_it_ok, t_star)[..., None], statics.it_capacity, 0.0
    ).amax(dim=1)  # [B, R]
    rem_star = _take(remaining, t_star)
    budget_per_r = torch.where(
        torch.isfinite(rem_star) & (max_cap_star > 0),
        torch.floor((rem_star + 1e-4) / torch.clamp(max_cap_star, min=1e-9)),
        BIG,
    )
    budget_nodes = to_i32(torch.clamp(budget_per_r.amin(dim=-1), min=0.0))
    n_new = torch.minimum(n_new, budget_nodes)
    if max_new_nodes is not None:
        # once the class bootstrapped onto an open slot, no fresh node
        n_new = torch.where(
            placed_existing > 0, 0, torch.clamp(n_new, max=max_new_nodes)
        ).to(I32)

    slot_idx = _ar(n_slots, dev)[None, :]
    n_next0 = _col(state.n_next)
    is_new = (slot_idx >= n_next0) & (slot_idx < n_next0 + _col(n_new))
    rank = slot_idx - n_next0
    a_new = torch.where(
        is_new,
        torch.minimum(torch.clamp(_col(rem) - rank * _col(per_node), min=0), _col(per_node)), 0,
    )
    placed_new = _isum(a_new, dim=-1)

    # -- the commit (K23): the open slots that took pods and the fresh slots
    # (disjoint: fresh slots lie at or past n_next, where no slot is open)
    a_all = assigned + a_new
    src = k23.SlotSource(
        a_all, torch.where(is_new, _col(t_star.to(I32)), -1), None, merged, tmpl_merged,
        zone_ok, t_zone, ct_ok, t_ct, (it_ok,), (cap_ni,), (t_it_ok,), (t_cap_ti,))
    planes = k.slot_commit(state, k23.keep_skipped(src, on), cls.ports, cls.requests,
                           statics.tmpl_daemon, ft.host_ports)
    n_next = state.n_next + n_new
    if on is not None:
        n_next = torch.where(on, n_next, state.n_next)

    remaining = _add_row(remaining, t_star, _col(-n_new.to(F32)) * max_cap_star)
    return NodeState(*planes, n_next), a_all, placed_existing + placed_new, remaining


def _zone_counts(counts: torch.Tensor, zone_i: torch.Tensor) -> torch.Tensor:
    """i32[B, G1, Z] = einsum("bgn,bnz->bgz") of int32 planes, as an int32
    broadcast-multiply-sum (CUDA has no int32 matmul)."""
    return _isum(counts[..., None] * zone_i[:, None, :, :], dim=2)


def _class_step(statics: Statics, ex_static: ExistingStatic, n_zones: int, carry,
                cls, cls_index: int, features: SnapshotFeatures = ALL_FEATURES, pref=None,
                topo_base=None):
    """One class step for every tenant: schedule every pod of one class —
    existing nodes first, then new slots, phase by phase — and record
    topology counts.  ``features`` prunes phase families the snapshot cannot
    exercise.  A phase runs when some tenant has a quota for it; tenants
    without one keep their carry (``_select``)."""
    ft = features
    k = statics.k
    state, ex, topo, remaining = carry
    dev = state.used.device
    pref_new = pref[0] if pref is not None else None
    pref_ex = pref[1] if pref is not None else None
    m = cls.count  # [B]
    n_b, n_ex = ex.pod_count.shape
    n_new_slots = state.pod_count.shape[1]
    g1 = statics.grp_skew.shape[-1]
    g_dummy = g1 - 1

    g_zs, g_hs, g_zaf, g_haf, g_zan, g_han = (cls.groups[:, i].long() for i in range(6))
    member_row = statics.grp_member[:, cls_index]  # [B, G1]
    tol_row = ex_static.tol[:, cls_index].contiguous()  # [B, E]
    vol_add_row = ex_static.cls_vol_add[:, cls_index].contiguous()  # [B, E, D]
    vol_per_pod_row = ex_static.cls_vol_per_pod[:, cls_index].contiguous()  # [B, D]

    def own_onehot(g):
        return (torch.arange(g1, device=dev)[None, :] == _col(g)) & _col(g < g_dummy)

    has_zs = g_zs < g_dummy
    has_zaf = g_zaf < g_dummy
    has_haf = g_haf < g_dummy
    has_zan = g_zan < g_dummy

    # -- derived per-zone counts: positive groups count pods on zone-committed
    # (singleton-mask) nodes, anti groups every zone a node could still be in
    any_zone_groups = ft.zone_spread or ft.zone_affinity or ft.zone_anti
    if any_zone_groups or ft.inv_zone_anti:
        ex_zone_i = ex.zone.to(I32) * ex.open_.to(I32)[..., None]
        new_zone_i = state.zone.to(I32) * state.open_.to(I32)[..., None]
    zone_fwd = None
    if any_zone_groups:
        ex_sing_zone = torch.where(_isum(ex_zone_i, dim=-1)[..., None] == 1, ex_zone_i, 0)
        new_sing_zone = torch.where(_isum(new_zone_i, dim=-1)[..., None] == 1, new_zone_i, 0)
        zone_fwd_sing = _zone_counts(topo.fwd_ex, ex_sing_zone) + _zone_counts(
            topo.fwd_new, new_sing_zone
        )  # [B, G1, Z]
        if topo_base is not None:
            zone_fwd_sing = zone_fwd_sing + topo_base[0]
        if ft.zone_anti:
            zone_fwd_full = _zone_counts(topo.fwd_ex, ex_zone_i) + _zone_counts(
                topo.fwd_new, new_zone_i
            )
            if topo_base is not None:
                zone_fwd_full = zone_fwd_full + topo_base[1]
            zone_fwd = torch.where(statics.grp_is_anti[..., None], zone_fwd_full, zone_fwd_sing)
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
        blocked_z = (mem_anti_zone[..., None] & (zone_inv_full > 0)).any(dim=1)  # [B, Z]
        allowed_zone = cls.zone & ~blocked_z
    else:
        allowed_zone = cls.zone
    if ft.inv_host_anti:
        mem_anti_host = member_row & statics.grp_is_anti & ~statics.grp_is_zone
        ok_ex = ~(mem_anti_host[..., None] & (topo.inv_ex > 0)).any(dim=1)  # [B, E]
        ok_new = ~(mem_anti_host[..., None] & (topo.inv_new > 0)).any(dim=1)  # [B, N]
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
            _col(member_hs), torch.clamp(_col(skew_hs) - hs_fwd_ex, min=0),
            _i32c(hs_fwd_ex <= _col(skew_hs), UNLIMITED, 0),
        ))
        cap_parts_new.append(torch.where(
            _col(member_hs), torch.clamp(_col(skew_hs) - hs_fwd_new, min=0),
            _i32c(hs_fwd_new <= _col(skew_hs), UNLIMITED, 0),
        ))
        fresh_parts.append(torch.where(member_hs, skew_hs, UNLIMITED).to(I32))
    if ft.host_anti:
        han_fwd_ex = _take(topo.fwd_ex, g_han)
        han_fwd_new = _take(topo.fwd_new, g_han)
        member_han = _take(member_row, g_han)
        own_han = g_han < g_dummy
        member_cap = _col(_i32c(member_han, 1, UNLIMITED))
        cap_parts_ex.append(torch.where(
            _col(own_han), torch.where(han_fwd_ex == 0, member_cap, 0), UNLIMITED,
        ).to(I32))
        cap_parts_new.append(torch.where(
            _col(own_han), torch.where(han_fwd_new == 0, member_cap, 0), UNLIMITED,
        ).to(I32))
        fresh_parts.append(_i32c(own_han & member_han, 1, UNLIMITED))
    if cap_parts_ex:
        host_cap_ex = functools.reduce(torch.minimum, cap_parts_ex).to(I32)
        host_cap_new = functools.reduce(torch.minimum, cap_parts_new).to(I32)
        fresh_host_cap = functools.reduce(torch.minimum, fresh_parts).to(I32)
    else:
        host_cap_ex = torch.full((n_b, n_ex), UNLIMITED, dtype=I32, device=dev)
        host_cap_new = torch.full((n_b, n_new_slots), UNLIMITED, dtype=I32, device=dev)
        fresh_host_cap = torch.full((n_b,), UNLIMITED, dtype=I32, device=dev)

    ex_prep = _prep_existing(ex, ex_static, cls, statics, host_cap_ex, tol_row,
                             vol_add_row, vol_per_pod_row, ft)

    zeros_new = torch.zeros((n_b, n_new_slots), dtype=I32, device=dev)
    zeros_ex = torch.zeros((n_b, n_ex), dtype=I32, device=dev)
    zero = torch.zeros(n_b, dtype=I32, device=dev)
    totals = {"new": zeros_new, "ex": zeros_ex, "placed": zero}

    def accumulate(results):
        nonlocal state, ex, remaining
        state, ex, assigned, assigned_ex, placed, remaining = results
        totals["new"] = totals["new"] + assigned
        totals["ex"] = totals["ex"] + assigned_ex
        totals["placed"] = totals["placed"] + placed

    def skipped():
        return state, ex, zeros_new, zeros_ex, zero, remaining

    def run_phase(quota, restrict, targets_ex=None, targets_new=None, single_node=False,
                  max_new_nodes=None):
        """One placement phase; it runs when some tenant's quota is positive
        (the reference's ``lax.cond(quota > 0)``) and the others keep their
        carry."""
        any_on, all_on, on = _sync_positive(quota)
        if not any_on:
            return skipped()
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
            on=None if all_on else on,
        )
        out = (state_o, ex_o, a_new, a_ex, placed_ex + placed_new, rem_o)
        return out if all_on else _select_committed(on, out, skipped())

    def committal_block(quota_z, cap_total):
        """All zone-committal phases of one family (zone spread quotas /
        required zonal anti) in one sweep: the merge/compat prep is shared,
        and shared-slot conflicts resolve by zone order (a slot that takes
        pods in zone z commits to z and leaves every later zone)."""
        any_on, all_on, on = _sync_positive(_isum(quota_z, dim=-1))
        if not any_on:
            return skipped()
        state_i, ex_i, rem = state, ex, remaining
        node_t = mask_ops.ReqTensor(state_i.kmask, state_i.kdef, state_i.kneg,
                                    state_i.kgt, state_i.klt)
        merged, key_ok = _merge_compat(node_t, cls, statics)
        ct_ok = state_i.ct & cls.ct[:, None, :]
        tol_ok = torch.gather(cls.tol, 1, state_i.tmpl_id.long())
        elig = state_i.open_ & key_ok & tol_ok & ct_ok.any(dim=-1)
        if ok_new is not None:
            elig = elig & ok_new
        has_ports = None
        if ft.host_ports:
            has_ports = cls.ports.any(dim=-1)
            port_conflict = (state_i.ports & cls.ports[:, None, :]).any(dim=-1)
            elig = elig & ~port_conflict
        zone_has_new = state_i.zone & cls.zone[:, None, :]  # [B, N, Z]
        cap_open_z, viable_z, capm_z = [], [], []
        for z in range(n_zones):
            # K1 with the zone restricted to z: it_ok is the reference's
            # ok_z = it_base & (offering in zone z); cap_z its row max
            ok_z, capm, cap_z = _it_cap(
                statics, state_i.viable, cls, merged,
                _onehot_rows(n_b, n_new_slots, n_zones, z, dev), ct_ok, state_i.used,
            )
            viable_z.append(ok_z)
            capm_z.append(capm)
            if ft.host_ports:
                cap_z = torch.minimum(cap_z, _col(_i32c(has_ports, 1, UNLIMITED)))
            cap_z = torch.where(elig & zone_has_new[..., z], torch.minimum(cap_z, host_cap_new), 0)
            cap_open_z.append(cap_z)
        priority = state_i.pod_count * n_new_slots + _ar(n_new_slots, dev)
        tmpl_merged, tmpl_key_ok = _merge_compat(statics.tmpl, cls, statics)
        t_ct = statics.tmpl_ct & cls.ct[:, None, :]
        t_ct_any = t_ct.any(dim=-1)
        t_zone_cls = statics.tmpl_zone & cls.zone[:, None, :]  # [B, T, Z]
        n_tmpl = statics.tmpl_zone.shape[1]

        taken_ex = torch.zeros((n_b, n_ex), dtype=torch.bool, device=dev)
        zone_onehot = torch.eye(n_zones, dtype=torch.bool, device=dev)
        a_ex_acc = zeros_ex
        zex = zeros_ex
        taken_new = torch.zeros((n_b, n_new_slots), dtype=torch.bool, device=dev)
        a_open_acc = zeros_new
        # the zone each slot took pods in, open or fresh (a slot takes pods
        # in one zone at most; fresh slots were not open at the start)
        zrow = zeros_new
        fresh_t = torch.full((n_b, n_new_slots), -1, dtype=I32, device=dev)
        fresh_a = zeros_new
        t_ok_z, t_cap_z = [], []
        n_next = state_i.n_next
        placed = zero
        slot_idx = _ar(n_new_slots, dev)[None, :]
        for z in range(n_zones):
            quota = quota_z[:, z].to(I32)
            q = torch.clamp(torch.minimum(quota, cap_total - placed), min=0)
            # existing nodes first, in index order (scheduler.go:176-180);
            # rows that took pods in an earlier zone are out
            a_ex, placed_ex, _ = _fill_existing(
                k, ex_prep.cap, ex_i.zone, cls.zone,
                zone_onehot[z].expand(n_b, n_zones).contiguous(),
                ~taken_ex if ok_ex is None else ~taken_ex & ok_ex, False, q, pref_ex,
            )
            took_e = a_ex > 0
            taken_ex = taken_ex | took_e
            a_ex_acc = a_ex_acc + a_ex
            zex = torch.where(took_e, z, zex).to(I32)
            # then open slots, emptiest first
            q2 = q - placed_ex
            cap_n = torch.where(~taken_new, cap_open_z[z], 0)
            pri_n = torch.where(cap_n > 0, priority, INT32_MAX)
            a_op = _fill_with_pref(k, q2, cap_n, pri_n, pref_new)
            placed_op = _isum(a_op, dim=-1)
            took_n = a_op > 0
            taken_new = taken_new | took_n
            a_open_acc = a_open_acc + a_op
            zrow = torch.where(took_n, z, zrow).to(I32)
            # then fresh slots from the first viable template for the zone
            rem_pods = q2 - placed_op
            within = (
                statics.it_capacity[:, None, :, :] <= rem[:, :, None, :] + 1e-4
            ).all(dim=-1)
            t_it_ok, t_cap_ti, t_cap = _it_cap(
                statics, statics.tmpl_it & within, cls, tmpl_merged,
                _onehot_rows(n_b, n_tmpl, n_zones, z, dev), t_ct, statics.tmpl_daemon,
            )
            t_ok_z.append(t_it_ok)
            t_cap_z.append(t_cap_ti)
            t_viable = cls.tol & tmpl_key_ok & t_zone_cls[..., z] & t_ct_any & (t_cap > 0)
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
                _take(t_it_ok, t_star)[..., None], statics.it_capacity, 0.0
            ).amax(dim=1)
            rem_star = _take(rem, t_star)
            budget_per_r = torch.where(
                torch.isfinite(rem_star) & (max_cap_star > 0),
                torch.floor((rem_star + 1e-4) / torch.clamp(max_cap_star, min=1e-9)),
                BIG,
            )
            budget_nodes = to_i32(torch.clamp(budget_per_r.amin(dim=-1), min=0.0))
            n_new = torch.minimum(n_new, budget_nodes)
            is_new = (slot_idx >= _col(n_next)) & (slot_idx < _col(n_next + n_new))
            a_fr = torch.where(
                is_new,
                torch.minimum(
                    torch.clamp(_col(rem_pods) - (slot_idx - _col(n_next)) * _col(per_node),
                                min=0),
                    _col(per_node)),
                0,
            )
            fresh_t = torch.where(is_new, _col(t_star.to(I32)), fresh_t)
            fresh_a = fresh_a + a_fr
            zrow = torch.where(is_new, z, zrow).to(I32)
            rem = _add_row(rem, t_star, _col(-n_new.to(F32)) * max_cap_star)
            n_next = n_next + n_new
            placed = placed + placed_ex + placed_op + _isum(a_fr, dim=-1)

        # -- one-shot commit (each node took pods in at most one zone) --------
        zar = torch.arange(n_zones, device=dev)
        zhot_e = (zar == zex[..., None]) & (a_ex_acc > 0)[..., None]
        ex_o = _commit_existing(k, ex_i, ex_prep, cls, a_ex_acc, zhot_e, ft)
        # the slots (K23): the open ones that took pods and the fresh ones,
        # each row's zone picking its K1 planes and its one-hot zone mask
        src = k23.SlotSource(
            a_open_acc + fresh_a, fresh_t, zrow, merged, tmpl_merged, None, None, ct_ok, t_ct,
            tuple(viable_z), tuple(capm_z), tuple(t_ok_z), tuple(t_cap_z))
        planes = k.slot_commit(state_i, k23.keep_skipped(src, None if all_on else on),
                               cls.ports, cls.requests, statics.tmpl_daemon, ft.host_ports)
        if not all_on:
            n_next = torch.where(on, n_next, state_i.n_next)
        state_o = NodeState(*planes, n_next)
        out = (state_o, ex_o, a_open_acc + fresh_a, a_ex_acc, placed, rem)
        return out if all_on else _select_committed(on, out, skipped())

    # zones some template can serve for this class, or where an eligible
    # existing node with intake left sits
    if ft.zone_spread or ft.zone_affinity:
        offers = (
            statics.tmpl_it[:, :, :, None, None]
            & (statics.it_avail & cls.it[:, :, None, None])[:, None]
            & statics.tmpl_zone[:, :, None, :, None]
            & (statics.tmpl_ct & cls.ct[:, None, :])[:, :, None, None, :]
        )  # [B, T, I, Z, CT]
        tmpl_offers = offers.any(dim=4).any(dim=2).any(dim=1)  # [B, Z]
        ex_cap_spread = ex_prep.cap if ok_ex is None else torch.where(ok_ex, ex_prep.cap, 0)
        ex_cap_z = _isum(
            torch.minimum(ex_cap_spread, _col(m))[..., None] * ex_prep.zone_full.to(I32), dim=1
        )  # i32[B, Z]
        fillable = tmpl_offers | (ex_cap_z > 0)

    # -- zone spread phases ---------------------------------------------------
    spread_suspect = torch.zeros(n_b, dtype=torch.bool, device=dev)
    if ft.zone_spread:
        counts_zs = _take(zone_fwd, g_zs)  # [B, Z]
        member_zs = _take(member_row, g_zs)
        cap_pods_z = torch.where(tmpl_offers, UNLIMITED,
                                 torch.clamp(ex_cap_z, max=UNLIMITED)).to(I32)
        skew_zs = _take(statics.grp_skew, g_zs)
        # K7: the capped water-fill rounds, the member gate and the
        # under-placement flag (the reference's :1440-1475)
        quotas, _, _, fill_residual = k.spread_quota(
            counts_zs, allowed_zone, fillable, cap_pods_z, skew_zs, m, member_zs,
        )
        quotas_gated = torch.where(_col(has_zs), quotas, 0)
        results_zs = committal_block(quotas_gated,
                                     torch.full((n_b,), UNLIMITED, dtype=I32, device=dev))
        placed_zs = results_zs[4]
        accumulate(results_zs)
        quota_shortfall = placed_zs < _isum(quotas, dim=-1)
        spread_suspect = has_zs & member_zs & (fill_residual | quota_shortfall)

        # non-self-selecting zone spread: a static admissible-zone mask
        min_zs = torch.where(cls.zone, counts_zs, 1 << 30).amin(dim=-1)
        admissible_zs = allowed_zone & (counts_zs - _col(min_zs) <= _col(skew_zs))
        q_nm = torch.where(has_zs & ~member_zs & admissible_zs.any(dim=-1), m, 0).to(I32)
        accumulate(run_phase(q_nm, admissible_zs))

    # -- owned zone anti-affinity: zero-forward-count zones only --------------
    if ft.zone_anti:
        zero_zones = allowed_zone & (_take(zone_fwd, g_zan) == 0)
        anti_member = _take(member_row, g_zan)
        anti_required = has_zan & anti_member & ~cls.anti_soft[:, 0]
        if ft.required_zone_anti:
            anti_quota_z = (_col(anti_required) & zero_zones).to(I32)
            accumulate(committal_block(anti_quota_z, m))
        anti_quota = torch.where(
            has_zan & zero_zones.any(dim=-1),
            torch.where(anti_member, torch.where(cls.anti_soft[:, 0], torch.clamp(m, max=1), 0),
                        m),
            0,
        ).to(I32)
        accumulate(run_phase(anti_quota, zero_zones))

    # -- zone affinity: nonzero-count zones, else self-members bootstrap one
    if ft.zone_affinity:
        bootstrap_allowed = allowed_zone & fillable
        nonzero_zones = allowed_zone & (_take(zone_fwd, g_zaf) > 0)
        bootstrap_zone = (
            torch.arange(n_zones, device=dev)[None, :] == _col(_argmax_first(bootstrap_allowed))
        ) & _col(bootstrap_allowed.any(dim=-1) & _take(member_row, g_zaf))
        zone_aff_restrict = torch.where(_col(nonzero_zones.any(dim=-1)), nonzero_zones,
                                        bootstrap_zone)
        zone_aff_quota = torch.where(
            has_zaf & ~has_haf & zone_aff_restrict.any(dim=-1), m, 0
        ).to(I32)
        accumulate(run_phase(zone_aff_quota, zone_aff_restrict))

    # -- hostname affinity: fill target nodes; else bootstrap exactly one node
    all_zones = torch.ones((n_b, n_zones), dtype=torch.bool, device=dev)
    if ft.host_affinity:
        if ft.zone_affinity:
            host_restrict = torch.where(_col(has_zaf), zone_aff_restrict, all_zones) & allowed_zone
        else:
            host_restrict = all_zones & allowed_zone
        targets_ex = (_take(topo.fwd_ex, g_haf) > 0) & ex.open_
        targets_new = (_take(topo.fwd_new, g_haf) > 0) & state.open_
        targets_exist = targets_ex.any(dim=-1) | targets_new.any(dim=-1)
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
        own_zan_inv = torch.where(_col(cls.anti_soft[:, 0]), 0, own_onehot(g_zan).to(I32)).to(I32)
        own_han_inv = torch.where(_col(cls.anti_soft[:, 1]), 0, own_onehot(g_han).to(I32)).to(I32)
        own_inv = own_zan_inv + own_han_inv
        topo = TopoCounts(
            fwd_ex=topo.fwd_ex + member_i[..., None] * a_ex_f[:, None, :],
            inv_ex=topo.inv_ex + own_inv[..., None] * a_ex_f[:, None, :],
            fwd_new=topo.fwd_new + member_i[..., None] * a_new_f[:, None, :],
            inv_new=topo.inv_new + own_inv[..., None] * a_new_f[:, None, :],
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
    warm_carry: Optional[WarmCarry] = None,
    repair_plan: Optional[RepairPlan] = None,
) -> SolveOutputs:
    """Scan the classes ``n_passes`` times: over empty slots (the cold
    solve), or resumed from a previous solve's final carry.

    Inputs are tensors on one device (``carry.tensors_from_numpy``), with
    masks in the bool layout the encode produces; they are bit-packed here.
    ``n_passes`` > 1 re-scans still-failed pods (an affinity follower that
    scans before its target, or a preference ladder's next rung), rolling
    failed counts down ``relax_next`` between passes.  ``use_kernels=False``
    runs the kernels' plain torch twins (the oracle on the card).

    ``warm_carry`` makes the call a warm-start REPAIR: ``state``,
    ``ex_state``, topology counts and the limit budget resume from the carry
    (its masks already packed), ``n_slots`` and ``existing_state`` are taken
    from it, all seeding is skipped, and ``class_tensors.count`` holds only
    the delta pods.  ``existing_static`` defaults to the empty planes.
    ``repair_plan`` (warm path only) threads the freed-hole preferences into
    every fill and the out-of-window bases into the zone derivations.
    Nothing given is written into.

    This is ``solve_core_batched`` at one tenant: every leaf gains a leading
    axis of 1 on the way in and loses it on the way out."""
    out = solve_core_batched(
        batch.add_axis(class_tensors), batch.add_axis(statics_arrays), n_slots, key_has_bounds,
        batch.add_axis(existing_state), batch.add_axis(existing_static), n_passes=n_passes,
        features=features, use_kernels=use_kernels, warm_carry=batch.add_axis(warm_carry),
        repair_plan=batch.add_axis(repair_plan),
    )
    return batch.drop_axis(out)


def solve_core_batched(
    class_tensors: ClassTensors,
    statics_arrays: StaticArrays,
    n_slots: int,
    key_has_bounds,
    existing_state: Optional[ExistingState] = None,
    existing_static: Optional[ExistingStatic] = None,
    n_passes: int = 1,
    features: Optional[SnapshotFeatures] = None,
    use_kernels: bool = True,
    warm_carry: Optional[WarmCarry] = None,
    repair_plan: Optional[RepairPlan] = None,
) -> SolveOutputs:
    """``solve_core`` over B tenants at once: every leaf of every argument
    (and of the outputs) carries a leading tenant axis B, the reference's
    ``jax.vmap`` of the solve body (``utils/compilecache.py:638
    batched_solve_callable``).  The tenants share one shape bucket (shapes,
    ``n_slots``, ``key_has_bounds``, ``n_passes``, ``features``), never
    values: each reads its own catalog, templates and vocabulary.

    Every kernel launch covers all B tenants.  Where the reference skips a
    class or a phase with ``lax.cond``, which vmap turns into a select, one
    host read of the [B] predicates decides: the step is skipped when no
    tenant needs it, else it runs for all and a tenant that did not need it
    keeps its carry.  Launches and host reads are a solo solve's, whatever
    B is, and each tenant's outputs equal its solo solve."""
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
    n_b, n_classes = class_tensors.count.shape
    n_ports = class_tensors.ports.shape[-1] if n_classes else 1

    if warm_carry is not None:
        wc = WarmCarry(*warm_carry)
        state = NodeState(*wc.state)
        existing_state = wc.ex_state
        if existing_static is None:
            existing_static = batch.repeat(empty_existing_static(
                statics.it_alloc.shape[-1], n_classes, statics.grp_skew.shape[-1],
                device=sa.it_alloc.device), n_b)
        topo = TopoCounts(*wc.topo)
        remaining0 = wc.remaining
    else:
        state, existing_state, existing_static, topo, remaining0 = _cold_carry(
            statics, n_b, n_slots, width, n_ports, existing_state, existing_static, n_classes)
    return _scan(class_tensors, statics, existing_static, ft, n_passes,
                 (state, existing_state, topo, remaining0), repair_plan)


def _cold_carry(statics: Statics, n_b: int, n_slots: int, width: int, n_ports: int,
                existing_state, existing_static, n_classes: int):
    """The cold solve's initial carry: empty slots, the existing nodes'
    topology seeding (topology.go:231-276) and the budget charge of open
    owned nodes."""
    dev = statics.it_alloc.device
    n_zones = statics.tmpl_zone.shape[-1]
    n_res = statics.it_alloc.shape[-1]
    n_keys = statics.it.defined.shape[-1]
    n_it = statics.it_alloc.shape[1]
    n_ct = statics.tmpl_ct.shape[-1]
    g1 = statics.grp_skew.shape[-1]
    kmask0 = mask_ops.const_words("full", width, dev).expand(
        n_b, n_slots, n_keys, mask_ops.words_for(width)
    ).contiguous()
    state = NodeState(
        used=torch.zeros((n_b, n_slots, n_res), dtype=F32, device=dev),
        kmask=kmask0,
        kdef=torch.zeros((n_b, n_slots, n_keys), dtype=torch.bool, device=dev),
        kneg=torch.zeros((n_b, n_slots, n_keys), dtype=torch.bool, device=dev),
        kgt=torch.full((n_b, n_slots, n_keys), -np.inf, dtype=F32, device=dev),
        klt=torch.full((n_b, n_slots, n_keys), np.inf, dtype=F32, device=dev),
        zone=torch.ones((n_b, n_slots, n_zones), dtype=torch.bool, device=dev),
        ct=torch.ones((n_b, n_slots, n_ct), dtype=torch.bool, device=dev),
        viable=torch.ones((n_b, n_slots, n_it), dtype=torch.bool, device=dev),
        ports=torch.zeros((n_b, n_slots, n_ports), dtype=torch.bool, device=dev),
        pod_count=torch.zeros((n_b, n_slots), dtype=I32, device=dev),
        tmpl_id=torch.zeros((n_b, n_slots), dtype=I32, device=dev),
        open_=torch.zeros((n_b, n_slots), dtype=torch.bool, device=dev),
        n_next=torch.zeros(n_b, dtype=I32, device=dev),
    )
    if existing_state is None:
        existing_state = batch.repeat(
            empty_existing_state(n_res, n_keys, width, n_zones, n_ct, n_ports, device=dev), n_b)
        existing_static = batch.repeat(empty_existing_static(n_res, n_classes, g1, device=dev), n_b)
    if existing_state.kmask.dtype == torch.bool:
        existing_state = existing_state._replace(kmask=mask_ops.pack_mask(existing_state.kmask))

    # seed topology counts from pre-existing pods (topology.go:231-276)
    open_i = existing_state.open_.to(I32)
    topo = TopoCounts(
        fwd_ex=existing_static.grp_node_member * open_i[:, None, :],
        inv_ex=existing_static.grp_node_owner * open_i[:, None, :],
        fwd_new=torch.zeros((n_b, g1, n_slots), dtype=I32, device=dev),
        inv_new=torch.zeros((n_b, g1, n_slots), dtype=I32, device=dev),
    )
    # charge open owned nodes' capacity against their provisioner's budget
    n_tmpl = statics.tmpl_zone.shape[1]
    tmpl_onehot = (
        existing_static.node_tmpl[..., None] == torch.arange(n_tmpl, device=dev)
    ) & (existing_static.node_owned & existing_state.open_)[..., None]  # [B, E, T]
    used_budget = (
        tmpl_onehot.to(F32)[..., None] * existing_static.node_capacity[:, :, None, :]
    ).sum(dim=1)  # [B, T, R]
    remaining0 = statics.tmpl_limits0 - used_budget
    return state, existing_state, existing_static, topo, remaining0


def _scan(class_tensors: ClassTensors, statics: Statics, existing_static, ft, n_passes: int,
          carry, repair_plan: Optional[RepairPlan]) -> SolveOutputs:
    """The class loop over a carry, ``n_passes`` times (the reference's
    ``lax.scan`` with ``lax.cond(count > 0)`` around each step): a class
    runs when some tenant holds pods of it, and the tenants that hold none
    keep their carry."""
    state, existing_state = carry[0], carry[1]
    dev = state.used.device
    n_zones = statics.tmpl_zone.shape[-1]
    n_b, n_classes = class_tensors.count.shape
    n_slots = state.pod_count.shape[1]
    base = pref_new = pref_ex = None
    if repair_plan is not None:
        base = (repair_plan.base_fwd_sing, repair_plan.base_fwd_full,
                repair_plan.base_inv_full)
        pref_new, pref_ex = repair_plan.pref_new, repair_plan.pref_ex
    n_ex = existing_state.pod_count.shape[1]
    assign = torch.zeros((n_b, n_classes, n_slots), dtype=I32, device=dev)
    assign_ex = torch.zeros((n_b, n_classes, n_ex), dtype=I32, device=dev)
    count_left = class_tensors.count
    failed = count_left
    suspect = torch.zeros((n_b, n_classes), dtype=torch.bool, device=dev)
    cls_indices = _ar(n_classes, dev)
    global host_syncs
    for p in range(max(n_passes, 1)):
        # the reference's per-class lax.cond(count > 0): one host read of the
        # pass's [B, C] counts decides every skip
        host_syncs += 1
        live_host = count_left.cpu().numpy() > 0
        a_rows, a_ex_rows, failed_rows, suspect_rows = [], [], [], []
        for c in range(n_classes):
            if bool(live_host[:, c].any()):
                cls = ClassTensors(*(t[:, c].contiguous() for t in class_tensors))._replace(
                    count=count_left[:, c].contiguous())
                stepped, (a, a_ex, f, s) = _class_step(
                    statics, existing_static, n_zones, carry, cls, c, features=ft,
                    pref=None if repair_plan is None else (pref_new[:, c].contiguous(),
                                                           pref_ex[:, c].contiguous()),
                    topo_base=base,
                )
                if bool(live_host[:, c].all()):
                    carry = stepped
                else:
                    on = count_left[:, c] > 0
                    carry = _select(on, stepped, carry)
                    a, a_ex, f = (torch.where(on.view((-1,) + (1,) * (x.dim() - 1)), x, 0)
                                  for x in (a, a_ex, f))
                    s = s & on
            else:
                a = torch.zeros((n_b, n_slots), dtype=I32, device=dev)
                a_ex = torch.zeros((n_b, n_ex), dtype=I32, device=dev)
                f = torch.zeros(n_b, dtype=I32, device=dev)
                s = torch.zeros(n_b, dtype=torch.bool, device=dev)
            a_rows.append(a)
            a_ex_rows.append(a_ex)
            failed_rows.append(f)
            suspect_rows.append(s)
        if n_classes:
            assign = assign + torch.stack(a_rows, dim=1)
            assign_ex = assign_ex + torch.stack(a_ex_rows, dim=1)
            failed = torch.stack(failed_rows, dim=1).to(I32)
            suspect = suspect | torch.stack(suspect_rows, dim=1)
        # roll failed counts one step down the preference ladder; classes with
        # no successor retry as themselves (late-affinity re-scan).  Several
        # rows can roll into one: scatter_add sums duplicates as `.at[].add`
        roll_to = torch.where(class_tensors.relax_next >= 0, class_tensors.relax_next,
                              cls_indices)
        count_left = torch.zeros_like(failed).scatter_add(1, roll_to.long(), failed)
        if p + 1 < n_passes:
            # shared volume adds are once per (ladder, node): collapse
            # placements to the root row before the add (scatter_reduce amax
            # over duplicate roots, the reference's `.at[root].max`)
            state_c, ex_c, topo_c, rem_c = carry
            placed_any = (assign_ex > 0).to(I32)  # [B, C, E]
            placed_root = torch.zeros_like(placed_any).scatter_reduce(
                1, class_tensors.root.long()[..., None].expand_as(placed_any), placed_any,
                "amax",
            )
            is_root = (class_tensors.root == cls_indices)[..., None].to(I32)
            shared = _isum((placed_root * is_root)[..., None] * existing_static.cls_vol_add,
                           dim=1)
            per_pod = _isum(
                assign_ex[..., None] * existing_static.cls_vol_per_pod[:, :, None, :], dim=1)
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


# -- the warm repair's carry programs (K10-K12) --------------------------------


def warm_carry_of(outputs: SolveOutputs) -> Optional[WarmCarry]:
    """A solve's final carry, for a later repair solve (None when the
    outputs lack the carry fields)."""
    if outputs.topo is None or outputs.remaining is None:
        return None
    return WarmCarry(state=outputs.state, ex_state=outputs.ex_state, topo=outputs.topo,
                     remaining=outputs.remaining)


def _kernels(use_kernels: bool) -> Kernels:
    return KERNELS if use_kernels else PLAIN


def _rows(state: NodeState) -> tuple:
    return tuple(getattr(state, f) for f in k1012.ROW_PLANES)


def repair_free(warm_carry: WarmCarry, free_new, free_ex, cls_requests, member, own_inv,
                use_kernels: bool = True, inplace: bool = False) -> WarmCarry:
    """Return evicted pods' capacity and topology counts to a warm carry
    (K10; the reference's ``_repair_free_impl`` :1960).  ``free_new``
    i32[C, N] / ``free_ex`` i32[C, E] count the pods of class c evicted from
    each slot since the carry was produced; ``cls_requests`` f32[C, R] is the
    per-pod request vector, ``member`` / ``own_inv`` i32[C, G1] the class's
    topology membership and inverse-ownership rows.  One-way: requirement
    masks, zone/ct commitments, ports and volume counters stay.
    ``inplace=True`` is ``repair_free_donated``."""
    wc = WarmCarry(*warm_carry)
    st, ex, topo = NodeState(*wc.state), wc.ex_state, TopoCounts(*wc.topo)
    args = (st.used, st.pod_count, topo.fwd_new, topo.inv_new, ex.used, ex.pod_count,
            topo.fwd_ex, topo.inv_ex, free_new, free_ex, cls_requests, member, own_inv)
    if inplace:
        out = (k1012.repair_free(*args, inplace=True) if use_kernels
               else k1012.repair_free_inplace_plain(*args))
    else:
        out = _kernels(use_kernels).repair_free(*args)
    used, pod_count, fwd_new, inv_new, used_ex, pod_count_ex, fwd_ex, inv_ex = out
    return WarmCarry(
        state=st._replace(used=used, pod_count=pod_count),
        ex_state=ex._replace(used=used_ex, pod_count=pod_count_ex),
        topo=TopoCounts(fwd_ex=fwd_ex, inv_ex=inv_ex, fwd_new=fwd_new, inv_new=inv_new),
        remaining=wc.remaining,
    )


def gather_repair_window(warm_carry: WarmCarry, idx: torch.Tensor, n_open_w: int,
                         use_kernels: bool = True):
    """The repair's dirty slot window out of a full-width carry (K11; the
    reference's :2016): ``idx`` i32[S] names the window's global slots (the
    freed holes ascending, any open filler, then the fresh tail from the
    carry's ``n_next``), ``n_open_w`` how many of them are open.  Returns the
    windowed WarmCarry (existing planes and budget passed through whole) and
    the ``(fwd_sing, fwd_full, inv_full)`` [G1, Z] counts of every open slot
    outside the window."""
    wc = WarmCarry(*warm_carry)
    st, topo = NodeState(*wc.state), TopoCounts(*wc.topo)
    w_rows, n_next, fwd_w, inv_w, bases = _kernels(use_kernels).gather_window(
        _rows(st), topo.fwd_new, topo.inv_new, idx, int(n_open_w))
    w_state = NodeState(*w_rows, n_next=n_next)
    w_topo = TopoCounts(fwd_ex=topo.fwd_ex, inv_ex=topo.inv_ex, fwd_new=fwd_w, inv_new=inv_w)
    return WarmCarry(state=w_state, ex_state=wc.ex_state, topo=w_topo,
                     remaining=wc.remaining), bases


def scatter_repair_window(warm_carry: WarmCarry, window_carry: WarmCarry, idx: torch.Tensor,
                          n_open_w: int, use_kernels: bool = True,
                          inplace: bool = False) -> WarmCarry:
    """A windowed repair's final carry written back over a copy of the
    full-width carry (K12; the reference's :2070): per-slot planes to their
    global slots, the existing-node state and the budget replaced whole, and
    ``n_next`` advanced by the fresh slots the repair opened.
    ``inplace=True`` is ``scatter_repair_window_donated`` (K22): the window
    is written into the full-width carry's own planes, and the existing-node
    state and budget are the window carry's tensors, swapped in, not
    copied."""
    wc, ww = WarmCarry(*warm_carry), WarmCarry(*window_carry)
    gs, ws = NodeState(*wc.state), NodeState(*ww.state)
    gt, wt = TopoCounts(*wc.topo), TopoCounts(*ww.topo)
    args = (_rows(gs), gt.fwd_new, gt.inv_new, gs.n_next, _rows(ws), wt.fwd_new, wt.inv_new,
            ws.n_next, idx, int(n_open_w))
    if inplace:
        rows, fwd_new, inv_new, n_next = (
            k1012.scatter_window(*args, inplace=True) if use_kernels
            else k1012.scatter_window_inplace_plain(*args))
    else:
        rows, fwd_new, inv_new, n_next = _kernels(use_kernels).scatter_window(*args)
    return WarmCarry(
        state=NodeState(*rows, n_next=n_next), ex_state=ww.ex_state,
        topo=TopoCounts(fwd_ex=wt.fwd_ex, inv_ex=wt.inv_ex, fwd_new=fwd_new, inv_new=inv_new),
        remaining=ww.remaining,
    )


def repair_free_donated(warm_carry: WarmCarry, free_new, free_ex, cls_requests, member,
                        own_inv, use_kernels: bool = True) -> WarmCarry:
    """``repair_free`` in place on the carry (K21; the reference's :2012):
    the carry's used, pod-count and topology planes are freed where they lie
    and the returned carry holds the same tensors.  The caller must not read
    the carry as it was."""
    return repair_free(warm_carry, free_new, free_ex, cls_requests, member, own_inv,
                       use_kernels=use_kernels, inplace=True)


def scatter_repair_window_donated(warm_carry: WarmCarry, window_carry: WarmCarry,
                                  idx: torch.Tensor, n_open_w: int,
                                  use_kernels: bool = True) -> WarmCarry:
    """``scatter_repair_window`` into the full-width carry's own planes (K22;
    the reference's :2115): only the window's rows, columns and ``n_next``
    are written.  The full-width carry (the first argument) is consumed; the
    window carry is not (its planes are the repair's outputs a pending decode
    reads)."""
    return scatter_repair_window(warm_carry, window_carry, idx, n_open_w,
                                 use_kernels=use_kernels, inplace=True)


# -- host-side helpers (numpy; copies of the reference's) ---------------------


def snapshot_features(snapshot) -> SnapshotFeatures:
    """The snapshot's static phase plan, normalized (all-on when absent)."""
    f = getattr(snapshot, "features", None)
    if f is None:
        return ALL_FEATURES._replace(
            required_zone_anti=bool(getattr(snapshot, "has_required_zonal_anti", True))
        ).canonical()
    return SnapshotFeatures(*f).canonical()


def features_with_existing(snapshot, ex_static) -> SnapshotFeatures:
    """snapshot_features refined by the existing-node planes: the
    volume-limit family only binds when some node carries a finite CSI
    attach limit, which the encode cannot see."""
    f = snapshot_features(snapshot)
    if ex_static is not None and bool(np.any(np.asarray(ex_static.vol_limit) < UNLIMITED)):
        f = f._replace(volume_limits=True)
    return f


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
    catalog, plus slack for zone phases; rounded up to a power of two and
    snapped to a slot count used before in the process
    (``utils.compilecache.snap_slots``), as the reference's is."""
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
    from karpenter_core_tpu_torch.utils import compilecache

    return compilecache.snap_slots(int(2 ** np.ceil(np.log2(max(total, 16)))))


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


def encode_device_finish_enabled() -> bool:
    """``KC_ENCODE_DEVICE_FINISH=1`` opts the prepare path into device-side
    class-plane finishing (K15); off by default, as in the reference."""
    return os.environ.get("KC_ENCODE_DEVICE_FINISH", "0") == "1"


def pad_planes(cls, statics_arrays, key_has_bounds, ex_state=None, ex_static=None,
               device_finish=False, device=None, use_kernels=True):
    """Bucket-pad host kernel inputs (prepare_host output, and the numpy
    existing-node planes of ``CudaSolver.encode_existing``) so nearby problem
    sizes share shapes: padded classes have count 0, padded keys are
    undefined everywhere, padded value slots are False, padded groups clone
    the dummy "none" row, padded existing nodes are closed.  Returns (cls,
    statics_arrays, key_has_bounds, ex_state, ex_static).

    ``device_finish`` pads the class planes on ``device`` instead (K15,
    ``kernels/classfinish.py``, or its twin with ``use_kernels=False``): the
    compact class rows are uploaded and the returned ``cls`` holds tensors
    there, cell for cell equal to the host padding."""
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

    if device_finish:
        from karpenter_core_tpu_torch import carry

        compact = ClassTensors(*(carry.to_tensor(a, device) for a in cls))
        finish = k15.finish_class_planes if use_kernels else k15.finish_class_planes_plain
        cls = ClassTensors(*finish(compact, k15.Extents(c_new, k_new, v_new, g1_old, g1_new,
                                                         p_new)))
    else:
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

    if ex_state is not None:
        e_old = ex_state.pod_count.shape[0]
        d_old = ex_state.vol_used.shape[-1]
        # floor 8: node churn below eight existing nodes must not change the
        # plane shape (the bucket grid's 4->6->8 steps are too fine there)
        e_new = bucket(e_old, floor=8)
        d_new = bucket(d_old, floor=2)
        ex_req = _pad_req(
            HostReq(ex_state.kmask, ex_state.kdef, ex_state.kneg, ex_state.kgt, ex_state.klt),
            k_new, v_new,
        )
        ex_state = ExistingState(
            used=_pad_axis(np.asarray(ex_state.used), 0, e_new, 0),
            kmask=_pad_axis(ex_req.mask, 0, e_new, True),
            kdef=_pad_axis(ex_req.defined, 0, e_new, False),
            kneg=_pad_axis(ex_req.negative, 0, e_new, False),
            kgt=_pad_axis(ex_req.gt, 0, e_new, -np.inf),
            klt=_pad_axis(ex_req.lt, 0, e_new, np.inf),
            zone=_pad_axis(np.asarray(ex_state.zone), 0, e_new, True),
            ct=_pad_axis(np.asarray(ex_state.ct), 0, e_new, True),
            ports=_pad_axis(_pad_axis(np.asarray(ex_state.ports), -1, p_new, False), 0, e_new,
                            False),
            vol_used=_pad_axis(_pad_axis(np.asarray(ex_state.vol_used), -1, d_new, 0), 0, e_new, 0),
            pod_count=_pad_axis(np.asarray(ex_state.pod_count), 0, e_new, 0),
            open_=_pad_axis(np.asarray(ex_state.open_), 0, e_new, False),
        )
        ex_static = ExistingStatic(
            alloc=_pad_axis(np.asarray(ex_static.alloc), 0, e_new, 0),
            init=_pad_axis(np.asarray(ex_static.init), 0, e_new, False),
            tol=_pad_axis(_pad_axis(np.asarray(ex_static.tol), -1, e_new, False), 0, c_new, False),
            grp_node_member=_pad_axis(
                _pad_axis(np.asarray(ex_static.grp_node_member), -1, e_new, 0), 0, g1_new, 0
            ),
            grp_node_owner=_pad_axis(
                _pad_axis(np.asarray(ex_static.grp_node_owner), -1, e_new, 0), 0, g1_new, 0
            ),
            node_capacity=_pad_axis(np.asarray(ex_static.node_capacity), 0, e_new, 0),
            node_tmpl=_pad_axis(np.asarray(ex_static.node_tmpl), 0, e_new, 0),
            node_owned=_pad_axis(np.asarray(ex_static.node_owned), 0, e_new, False),
            vol_limit=_pad_axis(
                _pad_axis(np.asarray(ex_static.vol_limit), -1, d_new, UNLIMITED), 0, e_new,
                UNLIMITED,
            ),
            cls_vol_add=_pad_axis(
                _pad_axis(
                    _pad_axis(np.asarray(ex_static.cls_vol_add), -1, d_new, 0), -2, e_new, 0
                ),
                0, c_new, 0,
            ),
            cls_vol_per_pod=_pad_axis(
                _pad_axis(np.asarray(ex_static.cls_vol_per_pod), -1, d_new, 0), 0, c_new, 0
            ),
        )
    return cls, statics_arrays, key_has_bounds, ex_state, ex_static
