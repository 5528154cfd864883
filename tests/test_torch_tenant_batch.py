"""The coalesced multi-tenant solve (the port's ``solve_core_batched`` behind
``utils/compilecache.batched_solve_callable``) held against the JAX
package's ``compilecache.batched_solve_callable`` — ``jax.vmap`` of the
solve body — on the same stacked inputs.

Every tenant is a randomized batch encoded by the JAX package
(``tests/test_torch_solve.py::_encoded_batch``), bucket-padded by
``pad_planes``; the tenants of one test share one shape bucket (the seeds in
``BUCKET`` do), not values: their class counts differ (some classes carry
pods in one tenant and none in another, which is the select path), and one
tenant's catalog values are changed.  The per-key bounds flags are the
union over the tenants, for both packages.  This file runs the cold
variant (tests/test_torch_tenant_batch_fleets.py the existing-node and
fused-repair ones).  Tolerance: none — ints and bools exact, f32
bit for bit; each tenant's slice also equals the port's solo solve.

Hazard 1 of the reference: a coalesced tenant runs the scan even when
``KC_SOLVER_MODE=relax`` would route its solo solve through the relax
family (its ``_run_batched`` calls the batched program directly).  Both
packages are held to it.
"""

import jax
import numpy as np
import pytest
import torch
import torch_history

from karpenter_core_tpu.ops import solve as jsolve
from karpenter_core_tpu.service import tenant as jtenant
from karpenter_core_tpu.utils import compilecache as jcc
from karpenter_core_tpu_torch import carry
from karpenter_core_tpu_torch.kernels import batch
from karpenter_core_tpu_torch.ops import solve as tsolve
from karpenter_core_tpu_torch.service import tenant as ttenant
from karpenter_core_tpu_torch.utils import compilecache as tcc
from test_torch_solve import _assert_same, _encoded_batch, _leaves

# both packages' slot and feature histories start empty for this module and
# are put back after it (tests/torch_history.py)
isolated_history = torch_history.isolated_history


# seeds of _encoded_batch whose padded planes share one bucket (8 classes,
# 8 keys, bounds on key 0, 64 slots)
BUCKET = (1, 3, 5, 7, 10, 11, 12, 13)
N_SLOTS = 64


def _tenant(seed: int, alter_catalog: bool = False, drop_class: bool = False):
    """One tenant's padded host planes (cls, statics_arrays, khb)."""
    snap = _encoded_batch(seed)
    cls, sa, khb = jsolve.prepare_host(snap)
    cls, sa, khb, _, _ = jsolve.pad_planes(cls, sa, khb)
    if drop_class:
        count = np.array(cls.count)
        count[1] = 0
        cls = cls._replace(count=count)
    if alter_catalog:
        # different catalog values in the same shapes: halve the first types'
        # allocatable and drop some offerings
        alloc = np.array(sa.it_alloc)
        alloc[:4] = alloc[:4] * np.float32(0.5)
        avail = np.array(sa.it_avail)
        avail[5:8, 0] = False
        sa = sa._replace(it_alloc=alloc, it_avail=avail)
    return cls, sa, tuple(khb)


def _stack(trees):
    return jax.tree_util.tree_map(lambda *ls: np.stack([np.asarray(x) for x in ls]), *trees)


def _tenants(n: int):
    picked = [_tenant(s, alter_catalog=(i == 1), drop_class=(i == 2))
              for i, s in enumerate(BUCKET[:n])]
    khb = tuple(bool(any(t[2][k] for t in picked)) for k in range(len(picked[0][2])))
    for c, s, _ in picked:
        assert jcc._leaf_sig(c) == jcc._leaf_sig(picked[0][0])
        assert jcc._leaf_sig(s) == jcc._leaf_sig(picked[0][1])
    return [c for c, _, _ in picked], [s for _, s, _ in picked], khb


def _port(cls, sa, khb):
    return carry.tensors_from_numpy(cls, sa, khb, device="cpu")


def _slice_np(outs, i):
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[i], outs)


def _check(ref, got, solos, label):
    for i, solo in enumerate(solos):
        _assert_same(_slice_np(ref, i), batch.tree_map(lambda a, i=i: a[i], got),
                     f"{label}: tenant {i} against the reference's batch")
        _assert_same(solo, batch.tree_map(lambda a, i=i: a[i], got),
                     f"{label}: tenant {i} against its solo solve")


@pytest.mark.parametrize("n_tenants,n_passes", [(1, 1), (2, 2), (3, 1), (5, 2)])
def test_cold_batch_matches_reference(n_tenants, n_passes):
    clss, sas, khb = _tenants(n_tenants)
    cls_b, sa_b = _stack(clss), _stack(sas)
    jfn = jcc.batched_solve_callable(n_tenants, clss[0], sas[0], N_SLOTS, khb,
                                     n_passes=n_passes)
    ref = jax.device_get(jfn(cls_b, sa_b))
    tc, ts, tk = _port(cls_b, sa_b, khb)
    fn = tcc.batched_solve_callable(n_tenants, *_port(clss[0], sas[0], khb)[:2], N_SLOTS, tk,
                                    n_passes=n_passes)
    got = fn(tc, ts)
    solos = [tsolve.solve_core(*_port(c, s, khb)[:2], N_SLOTS, khb, n_passes=n_passes)
             for c, s in zip(clss, sas)]
    _check(ref, got, solos, f"cold B={n_tenants}")
    # the twins' path (use_kernels=False, the oracle on the card) takes the
    # same tenant axis
    plain = tsolve.solve_core_batched(tc, ts, N_SLOTS, tk, n_passes=n_passes, use_kernels=False)
    _assert_same(got, plain, f"cold B={n_tenants}, twins")


def test_mesh_axes_is_not_ported():
    clss, sas, khb = _tenants(1)
    tc, ts, tk = _port(clss[0], sas[0], khb)
    with pytest.raises(NotImplementedError, match="1.8"):
        tcc.batched_solve_callable(1, tc, ts, N_SLOTS, tk, mesh_axes=(("tenants", 1),))


def test_bucket_key_matches_the_tenants_that_stack():
    """Equal port bucket keys for the bucket's tenants, a different key
    for another slot count, and the repair extension keyed on the window."""
    clss, sas, khb = _tenants(2)

    class Prep:
        def __init__(self, c, s, n_slots=N_SLOTS):
            self.cls, self.statics_arrays = _port(c, s, khb)[:2]
            self.ex_state = self.ex_static = None
            self.n_slots, self.key_has_bounds, self.n_passes = n_slots, khb, 1
            self.features = None

    a, b = Prep(clss[0], sas[0]), Prep(clss[1], sas[1])
    assert ttenant.bucket_key(a) == ttenant.bucket_key(b)
    assert ttenant.bucket_key(a) != ttenant.bucket_key(Prep(clss[0], sas[0], 128))
    kw = {"warm_carry": (torch.zeros(3),), "repair_plan": (torch.zeros(2),), "n_slots": 16}
    assert ttenant.bucket_key(a, kw)[-3] == 16
    assert ttenant.bucket_key(a, kw) != ttenant.bucket_key(a, dict(kw, n_slots=32))


# -- hazard 1: a coalesced tenant runs the scan under KC_SOLVER_MODE=relax --------


def _relax_preps(monkeypatch, pkg):
    """Two tenants' preps of one bucket on a solver of either package that
    routes cold solves through the relax family (``KC_SOLVER_MODE=relax``,
    the policy off: tests/test_torch_relax_solve.py's fixture)."""
    from test_torch_existing import _to_jax
    from test_torch_relax_solve import _solvers
    from karpenter_core_tpu_torch.testing.factories import make_pod

    monkeypatch.setenv("KC_SOLVER_MODE", "relax")
    ts, js = _solvers(policy=False)
    pods = [[make_pod(requests={"cpu": "500m"}) for _ in range(n)] for n in (120, 112)]
    if pkg == "jax":
        return js, [js.prepare_encoded(js.encode([_to_jax(p) for p in ps]), n_slots=64)
                    for ps in pods]
    return ts, [ts.prepare_encoded(ts.encode(ps), n_slots=64) for ps in pods]


@pytest.fixture(scope="module")
def _warm_reference_relax():
    """The reference compiles its relax and scan programs for the hazard's
    shapes once, outside the per-test retrace budget (as
    tests/test_torch_relax_solve.py's module fixture does)."""
    mp = pytest.MonkeyPatch()
    try:
        solver, preps = _relax_preps(mp, "jax")
        jtenant.BatchCoalescer._run_batched(preps)
        for prep in preps:
            jax.device_get(solver.run_prepared(prep))
            cls, sa = jax.device_get((prep.cls, prep.statics_arrays))
            jax.device_get(jsolve._solve_jit(cls, sa, prep.n_slots, tuple(prep.key_has_bounds),
                                             n_passes=prep.n_passes, features=prep.features))
    finally:
        mp.undo()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_coalesced_tenant_runs_the_scan_under_relax_mode(pkg, monkeypatch,
                                                          _warm_reference_relax):
    solver, preps = _relax_preps(monkeypatch, pkg)
    assert preps[0].n_slots == preps[1].n_slots
    coalescer = jtenant.BatchCoalescer if pkg == "jax" else ttenant.BatchCoalescer
    batched = coalescer._run_batched(preps)
    for prep, out in zip(preps, batched):
        solo = solver.run_prepared(prep)
        assert solver.last_solve_mode == "relax"
        if pkg == "jax":
            cls, sa = jax.device_get((prep.cls, prep.statics_arrays))
            scan = jax.device_get(jsolve._solve_jit(
                cls, sa, prep.n_slots, tuple(prep.key_has_bounds), n_passes=prep.n_passes,
                features=prep.features))
            out, solo = jax.device_get(out), jax.device_get(solo)
        else:
            scan = tsolve.solve_core(prep.cls, prep.statics_arrays, prep.n_slots,
                                     prep.key_has_bounds, n_passes=prep.n_passes,
                                     features=prep.features)
        _assert_same(scan, out, f"{pkg}: the coalesced tenant ran the scan")
        # the solo solve took the relax family's answer, which differs
        solo_l, out_l = _leaves(solo), _leaves(out)
        assert any(not np.array_equal(solo_l[k], out_l[k]) for k in solo_l)
