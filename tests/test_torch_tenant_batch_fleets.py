"""The coalesced multi-tenant solve with fleets: the existing-node and the
fused-repair variants of the port's ``batched_solve_callable`` held against
the JAX package's on the same stacked inputs (tests/test_torch_tenant_batch.py
holds the cold variant; the two files split the reference's compiles), and
both packages held to chip_smoke.py phase 8 (c)'s pins.  Tolerance: none —
ints and bools exact, f32 bit for bit; each tenant's slice also equals the
port's solo solve.
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
from karpenter_core_tpu_torch.ops import solve as tsolve
from karpenter_core_tpu_torch.service import tenant as ttenant
from karpenter_core_tpu_torch.utils import compilecache as tcc
from test_torch_solve import _existing_planes
from test_torch_tenant_batch import N_SLOTS, _check, _port, _stack, _tenants

# both packages' slot and feature histories start empty for this module and
# are put back after it (tests/torch_history.py)
isolated_history = torch_history.isolated_history


@pytest.mark.parametrize("n_tenants", [2, 3])
def test_existing_node_batch_matches_reference(n_tenants):
    clss, sas, khb = _tenants(n_tenants)
    exs = [_existing_planes(c, s) for c, s in zip(clss, sas)]
    # the fleets differ between tenants (values, not shapes)
    exs = [(st._replace(open_=np.array([True, i % 2 == 0, False])), sc)
           for i, (st, sc) in enumerate(exs)]
    cls_b, sa_b = _stack(clss), _stack(sas)
    ex_b, exs_b = _stack([e[0] for e in exs]), _stack([e[1] for e in exs])
    jfn = jcc.batched_solve_callable(n_tenants, clss[0], sas[0], N_SLOTS, khb, exs[0][0],
                                     exs[0][1], n_passes=2)
    ref = jax.device_get(jfn(cls_b, sa_b, ex_b, exs_b))
    tc, ts, tk = _port(cls_b, sa_b, khb)
    te, tes = carry.existing_from_numpy(ex_b, exs_b, device="cpu")
    te0, tes0 = carry.existing_from_numpy(*exs[0], device="cpu")
    fn = tcc.batched_solve_callable(n_tenants, *_port(clss[0], sas[0], khb)[:2], N_SLOTS, tk,
                                    te0, tes0, n_passes=2)
    got = fn(tc, ts, te, tes)
    solos = []
    for c, s, (st, sc) in zip(clss, sas, exs):
        solos.append(tsolve.solve_core(*_port(c, s, khb)[:2], N_SLOTS, khb,
                                       *carry.existing_from_numpy(st, sc, device="cpu"),
                                       n_passes=2))
    _check(ref, got, solos, f"existing B={n_tenants}")
    assert int(np.asarray(ref.assign_existing).sum()) > 0


def _warm_inputs(cls, sa, khb, tick: int):
    """A repair's inputs from the reference's own cold solve: its final carry,
    a delta count vector (a few more pods of some classes) and an unwindowed
    repair plan."""
    out = jax.device_get(jsolve._solve_jit(cls, sa, N_SLOTS, khb, n_passes=1, features=None))
    wc = jsolve.warm_carry_of(out)
    count = np.zeros_like(np.asarray(cls.count))
    live = np.flatnonzero(np.asarray(cls.count))
    count[live[tick % len(live)]] = 2 + tick
    g1, n_zones = sa.grp_skew.shape[0], sa.tmpl_zone.shape[-1]
    zeros_gz = np.zeros((g1, n_zones), np.int32)
    plan = jsolve.RepairPlan(
        pref_new=np.zeros((count.shape[0], N_SLOTS), np.int32),
        pref_ex=np.zeros((count.shape[0], 1), np.int32),
        base_fwd_sing=zeros_gz, base_fwd_full=zeros_gz, base_inv_full=zeros_gz,
    )
    ex_static = jsolve.empty_existing_static(cls.requests.shape[-1], count.shape[0], g1)
    return cls._replace(count=count), ex_static, wc, plan


@pytest.mark.parametrize("n_tenants", [2, 3])
def test_fused_repair_batch_matches_reference(n_tenants):
    clss, sas, khb = _tenants(n_tenants)
    warm = [_warm_inputs(c, s, khb, i) for i, (c, s) in enumerate(zip(clss, sas))]
    clss = [w[0] for w in warm]
    cls_b, sa_b = _stack(clss), _stack(sas)
    exs_b, wc_b, rp_b = (_stack([w[k] for w in warm]) for k in (1, 2, 3))
    jfn = jcc.batched_solve_callable(n_tenants, clss[0], sas[0], N_SLOTS, khb,
                                     ex_static=warm[0][1], warm_carry=warm[0][2],
                                     repair_plan=warm[0][3])
    ref = jax.device_get(jfn(cls_b, sa_b, exs_b, wc_b, rp_b))

    def port_warm(ex_static, wc, plan):
        return (carry.existing_from_numpy(
                    jsolve.empty_existing_state(1, 1, 1, 1, 1), ex_static, device="cpu")[1],
                carry.warm_carry_from_numpy(wc, device="cpu"),
                tsolve.RepairPlan(*(torch.as_tensor(np.asarray(a)) for a in plan)))

    tc, ts, tk = _port(cls_b, sa_b, khb)
    texs, twc, trp = port_warm(exs_b, wc_b, rp_b)
    texs0, twc0, trp0 = port_warm(*warm[0][1:])
    fn = tcc.batched_solve_callable(n_tenants, *_port(clss[0], sas[0], khb)[:2], N_SLOTS, tk,
                                    ex_static=texs0, warm_carry=twc0, repair_plan=trp0)
    got = fn(tc, ts, texs, twc, trp)
    solos = []
    for c, s, w in zip(clss, sas, warm):
        e, wc, rp = port_warm(*w[1:])
        solos.append(tsolve.solve_core(*_port(c, s, khb)[:2], N_SLOTS, khb, None, e,
                                       warm_carry=wc, repair_plan=rp))
    _check(ref, got, solos, f"repair B={n_tenants}")


# -- chip_smoke.py phase 8 (c)'s pins -----------------------------------------------


def test_existing_tenants_match_chip_smoke_pins():
    """Tenants 0 and 1 of chip_smoke.py's existing-node coalescing (5,000
    headline pods x 100 types into build_cluster fleets of 260 and 300
    nodes): the JAX package's solo solves and its own B = 2 batch, and the
    port's B = 2 batch, give the counts chip_smoke.py pins on the card."""
    from test_torch_existing import _chip_smoke, _reference_inputs
    from karpenter_core_tpu_torch.testing import workloads

    smoke = _chip_smoke()
    tenants = []
    for n_nodes, seed in smoke.EX_TENANT_FLEETS[:2]:
        nodes, bound = workloads.build_cluster(n_nodes, smoke.MID_TYPES, 5, smoke.FILL, seed)
        solver, pods = workloads.build_inputs(smoke.EX_TENANT_PODS, smoke.MID_TYPES, 5,
                                              device="cpu")
        js, jnodes, jbound, jpods = _reference_inputs(nodes, bound, pods, smoke.MID_TYPES)
        jsnap = js.encode(jpods, jnodes, jbound)
        tsnap = solver.encode(pods, nodes, bound)
        tenants.append(dict(js=js, jsnap=jsnap, jnodes=jnodes,
                            jprep=js.prepare_encoded(jsnap, jnodes, jbound), solver=solver,
                            tsnap=tsnap, nodes=nodes,
                            tprep=solver.prepare_encoded(tsnap, nodes, bound)))
    assert jtenant.bucket_key(tenants[0]["jprep"]) == jtenant.bucket_key(tenants[1]["jprep"])
    assert ttenant.bucket_key(tenants[0]["tprep"]) == ttenant.bucket_key(tenants[1]["tprep"])
    jouts = jtenant.BatchCoalescer._run_batched([t["jprep"] for t in tenants])
    touts = ttenant.BatchCoalescer._run_batched([t["tprep"] for t in tenants])
    for i, t in enumerate(tenants):
        pin = smoke.EX_TENANT_PINS[i]
        solo = t["js"].decode(t["jsnap"], jax.device_get(t["js"].run_prepared(t["jprep"])),
                              t["jnodes"])
        assert smoke.path_counts(solo) == pin
        batched = t["js"].decode(t["jsnap"], jax.device_get(jouts[i]), t["jnodes"])
        assert smoke.path_counts(batched) == pin
        port = t["solver"].decode(t["tsnap"], touts[i], t["nodes"])
        assert smoke.path_counts(port) == pin
