"""The coalesced multi-tenant solve program.

The port of ``karpenter_core_tpu/utils/compilecache.py``'s
``batched_solve_callable`` (:638): the callable that runs the solve body
over a leading tenant axis (``ops.solve.solve_core_batched``, the port of
``jax.jit(jax.vmap(base))``) in one of the reference's three variants —
cold ``(cls, statics)``, existing-node ``(cls, statics, ex_state,
ex_static)`` and fused repair ``(cls, statics, ex_static, warm_carry,
repair_plan)``.  The port compiles nothing per shape (the kernels build
once from ``csrc/``), so there is no memo: the callable only fixes the
variant's arguments.  The tenant plane calls ``solve_core_batched``
directly.

Not ported: the solo ``solve_callable`` and its export cache (the port
calls ``solve_core`` directly), ``snap_features`` / ``snap_slots`` and the
batch-occupancy ledger (ROADMAP 1.2), the relax memo (``relax.prng``
memoizes its permutations) and the mesh variants (1.8): ``mesh_axes`` must
be None.  ``kernel_flags`` is not ported: the port has only the production
layout (packed masks, fused zones).
"""

from __future__ import annotations

from karpenter_core_tpu_torch.ops import solve as solve_ops


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
    matters here.  Per tenant, the outputs equal that tenant's solo solve."""
    if mesh_axes is not None:
        raise NotImplementedError(
            "the tenant mesh axis (tenant_solve_callable) is not ported: ROADMAP 1.8")
    kw = {"n_passes": n_passes, "features": features}
    if warm_carry is not None:
        return lambda c, s, exst, w, rp: solve_ops.solve_core_batched(
            c, s, n_slots, key_has_bounds, None, exst, warm_carry=w, repair_plan=rp, **kw)
    if ex_state is not None:
        return lambda c, s, exs, exst: solve_ops.solve_core_batched(
            c, s, n_slots, key_has_bounds, exs, exst, **kw)
    return lambda c, s: solve_ops.solve_core_batched(c, s, n_slots, key_has_bounds, **kw)
