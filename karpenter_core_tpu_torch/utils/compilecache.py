"""The solve's cache keys: slot and feature hysteresis, the batch-occupancy
ledger, and the coalesced multi-tenant program.

The port of the parts of ``karpenter_core_tpu/utils/compilecache.py`` that
change a result or a record:

  ``snap_slots`` (:161)      reuses the smallest slot count seen before that
      covers an estimate within ``max_waste`` x; ``ops.solve.estimate_slots``
      ends in it, so every caller (the provisioning solve, the mesh studies)
      sizes its slot planes as the reference does in the same process.
  ``snap_features`` (:140)   widens a requested ``SnapshotFeatures`` to the
      smallest flag superset seen before (sound: an enabled family that no
      class needs is a runtime no-op), past ``MAX_FEATURE_VARIANTS`` sets to
      all-on.  The solver's dispatch, the sweep, the mesh studies and the
      tenant coalescer snap as the reference does.
  ``record_batch_occupancy`` (:77)  real against padded class rows of each
      coalesced dispatch, per (bucket, mesh); ``occupancy_stats`` reads it.
  ``batched_solve_callable`` (:638)  the callable that runs the solve body
      over a leading tenant axis (``ops.solve.solve_core_batched``, the port
      of ``jax.jit(jax.vmap(base))``) in one of the reference's three
      variants — cold ``(cls, statics)``, existing-node ``(cls, statics,
      ex_state, ex_static)`` and fused repair ``(cls, statics, ex_static,
      warm_carry, repair_plan)``.

The slot and feature histories are process-wide, under one lock, as in the
reference; ``reset_memo`` clears them (a fresh process).

The port compiles nothing per shape: the kernels build once from ``csrc/``
and the scan runs eagerly.  So the executable memo, its ``stats`` and the
export cache are not ported: there is no executable to reuse, and the
hysteresis is kept for the slot counts and phase plans it picks, which
change the outputs' shapes and the phases that run.  Also left out: the
occupancy gauges (``karpenter_batch_occupancy_ratio``,
``karpenter_padded_flops_total``; the metrics registry is ROADMAP 1.5), the
relax memo (``relax.prng`` memoizes its permutations), the mesh variants
(``mesh_axes`` must be None: the mesh needs more than one card) and
``kernel_flags`` (the port has only
the production layout: packed masks, fused zones).
"""

from __future__ import annotations

import threading
from typing import Dict

from karpenter_core_tpu_torch.ops import solve as solve_ops

_lock = threading.Lock()

# -- batch-occupancy / padding ledger ----------------------------------------

_occupancy: Dict[tuple, dict] = {}


def record_batch_occupancy(real_rows, padded_rows, n_slots, n_passes=1,
                           mesh_axes=None, tenants=1) -> None:
    """Record one dispatch's real-vs-padded class rows (one call per device
    dispatch).  ``real_rows`` is per batch element (a float mean for
    coalesced batches); ``tenants`` scales the cumulative row and padded-work
    ledger (wasted rows x slots x passes x tenants, a relative yardstick)."""
    real_rows = float(real_rows)
    padded_rows = max(int(padded_rows), 1)
    tenants = max(int(tenants), 1)
    bucket = str(padded_rows)
    mesh = repr(tuple(mesh_axes)) if mesh_axes else "none"
    wasted = max(padded_rows - real_rows, 0.0) * int(n_slots) * max(int(n_passes), 1) * tenants
    with _lock:
        entry = _occupancy.setdefault(
            (bucket, mesh),
            {"dispatches": 0, "real_rows": 0.0, "padded_rows": 0,
             "padded_flops": 0.0, "tenant_rows": 0},
        )
        entry["dispatches"] += 1
        entry["real_rows"] += real_rows * tenants
        entry["padded_rows"] += padded_rows * tenants
        entry["tenant_rows"] += tenants
        entry["padded_flops"] += float(wasted)


def occupancy_stats() -> Dict[str, dict]:
    """Cumulative per-(bucket, mesh) occupancy: ``{"<bucket>|<mesh>":
    {dispatches, real_rows, padded_rows, tenant_rows, padded_flops,
    occupancy_ratio}}``."""
    with _lock:
        snapshot = {k: dict(v) for k, v in _occupancy.items()}
    out: Dict[str, dict] = {}
    for (bucket, mesh), entry in snapshot.items():
        entry["occupancy_ratio"] = (
            entry["real_rows"] / entry["padded_rows"] if entry["padded_rows"] else 0.0
        )
        out[f"{bucket}|{mesh}"] = entry
    return out


def reset_occupancy() -> None:
    with _lock:
        _occupancy.clear()


# -- slot-count and feature-set hysteresis -----------------------------------

_slots_seen: set = set()
_features_seen: set = set()
MAX_FEATURE_VARIANTS = 8


def snap_features(features):
    """Stabilize the solve's feature set across nearby batches: the set
    itself once seen, else the covering set seen before with the fewest
    flags, else all-on once ``MAX_FEATURE_VARIANTS`` sets were seen."""
    if features is None:
        return solve_ops.ALL_FEATURES
    f = solve_ops.SnapshotFeatures(*features).canonical()
    with _lock:
        if f in _features_seen:
            return f
        covering = [g for g in _features_seen if g.covers(f)]
        if covering:
            return min(covering, key=lambda g: (sum(g), tuple(g)))
        if len(_features_seen) >= MAX_FEATURE_VARIANTS:
            _features_seen.add(solve_ops.ALL_FEATURES)
            return solve_ops.ALL_FEATURES
        _features_seen.add(f)
        return f


def snap_slots(estimate: int, max_waste: int = 4) -> int:
    """Stabilize the solve's slot count across nearby batches: the smallest
    count seen before within [estimate, max_waste x estimate], else the
    estimate (which is then seen)."""
    with _lock:
        covering = [s for s in _slots_seen if estimate <= s <= max_waste * estimate]
        if covering:
            return min(covering)
        _slots_seen.add(estimate)
        return estimate


def reset_memo() -> None:
    """A process restart, for tests and for a run pinned to a fresh
    process's answer: clear the slot-count and feature-set histories."""
    with _lock:
        _slots_seen.clear()
        _features_seen.clear()


# -- the coalesced multi-tenant program --------------------------------------


def batched_solve_callable(
    n_tenants: int,
    cls,
    statics_arrays,
    n_slots: int,
    key_has_bounds,
    ex_state=None,
    ex_static=None,
    n_passes: int = 1,
    features=None,
    mesh_axes=None,
    warm_carry=None,
    repair_plan=None,
):
    """The coalesced multi-tenant program over stacked planes, in the
    variant the arguments name: ``warm_carry`` selects the fused REPAIR
    signature ``(cls, statics, ex_static, warm_carry, repair_plan)`` with
    ``n_slots`` the shared repair-window width, ``ex_state`` the
    existing-node one ``(cls, statics, ex_state, ex_static)``, neither the
    cold ``(cls, statics)``.  ``n_tenants``, ``cls``, ``statics_arrays`` and
    the other planes are the reference's signature; only which are given
    matters here.  ``features`` is snapped (``snap_features``) as the
    reference's is.  Per tenant, the outputs equal that tenant's solo
    solve."""
    if mesh_axes is not None:
        raise NotImplementedError(
            "the tenant mesh axis (tenant_solve_callable) is not ported: ROADMAP 1.8")
    kw = {"n_passes": n_passes, "features": snap_features(features)}
    if warm_carry is not None:
        return lambda c, s, exst, w, rp: solve_ops.solve_core_batched(
            c, s, n_slots, key_has_bounds, None, exst, warm_carry=w, repair_plan=rp, **kw)
    if ex_state is not None:
        return lambda c, s, exs, exst: solve_ops.solve_core_batched(
            c, s, n_slots, key_has_bounds, exs, exst, **kw)
    return lambda c, s: solve_ops.solve_core_batched(c, s, n_slots, key_has_bounds, **kw)
