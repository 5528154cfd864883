"""The port's solve (karpenter_core_tpu_torch/ops/solve.py) held against the
JAX package's on the same encoded inputs.

Each batch is encoded once by the JAX package (``TPUSolver.encode`` →
``prepare_host``); the numpy planes go through the JAX ``_solve_jit`` and,
via ``carry.tensors_from_numpy``, through the port's ``solve_core`` on the
CPU, which runs the kernels' plain torch twins.  Tolerance: none — every
``SolveOutputs`` leaf must be equal, ints and bools exactly and f32 bit for
bit (compared as arrays with identical dtypes; the reference's uint32 mask
words as int32 bit patterns).  Module-level checks cover the pieces with
known hazards: the saturating float-to-int32 cast in ``_capacity``, stable
ties in ``_water_fill`` and ``_fill_by_priority``, and ``pack_bool``.
"""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_core_tpu.apis import labels as labels_api
from karpenter_core_tpu.apis.objects import (
    OP_GT,
    OP_IN,
    LabelSelector,
    NodeSelectorRequirement,
    PodAffinityTerm,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
)
from karpenter_core_tpu.cloudprovider import fake as fake_cp
from karpenter_core_tpu.models.snapshot import KernelUnsupported, affinity_scan_passes
from karpenter_core_tpu.ops import solve as jsolve
from karpenter_core_tpu.solver.tpu import TPUSolver
from karpenter_core_tpu.testing import make_pod, make_provisioner
from karpenter_core_tpu_torch import carry
from karpenter_core_tpu_torch.kernels import capacity as k1
from karpenter_core_tpu_torch.kernels import fill as k2
from karpenter_core_tpu_torch.ops import solve as tsolve

ZONE = labels_api.LABEL_TOPOLOGY_ZONE
HOSTNAME = labels_api.LABEL_HOSTNAME
SIZES = (
    {"cpu": "100m"},
    {"cpu": "500m"},
    {"cpu": 1, "memory": "1Gi"},
    {"cpu": "250m", "memory": "512Mi"},
    {},  # no requests: only the implicit one-pod slot
)


# -- whole-solve parity -------------------------------------------------------


def _pod_kwargs(rng: random.Random, i: int, n_classes: int):
    labels = {"app": f"c{i}"}
    kw = dict(labels=labels, requests=rng.choice(SIZES))
    sel = LabelSelector(match_labels=dict(labels))
    shape = rng.random()
    if shape < 0.25:
        kw["topology_spread"] = [TopologySpreadConstraint(
            max_skew=rng.choice((1, 2)), topology_key=rng.choice((ZONE, HOSTNAME)),
            label_selector=sel,
        )]
    elif shape < 0.42:
        kw["pod_anti_affinity"] = [PodAffinityTerm(
            topology_key=rng.choice((ZONE, HOSTNAME)), label_selector=sel)]
    elif shape < 0.55:
        kw["pod_affinity"] = [PodAffinityTerm(
            topology_key=rng.choice((ZONE, HOSTNAME)), label_selector=sel)]
    elif shape < 0.65 and i + 1 < n_classes:
        # cross-group affinity to a class that scans later: a second pass
        kw["pod_affinity"] = [PodAffinityTerm(
            topology_key=ZONE,
            label_selector=LabelSelector(match_labels={"app": f"c{i + 1}"}))]
    elif shape < 0.75:
        # a preference ladder: failed pods roll to the relaxed variant
        kw["pod_affinity_preferred"] = [WeightedPodAffinityTerm(
            weight=1, pod_affinity_term=PodAffinityTerm(
                topology_key=HOSTNAME,
                label_selector=LabelSelector(match_labels={"app": "nowhere"})))]
    if rng.random() < 0.25:
        # integer bounds on the catalog's "integer" label: key_has_bounds
        kw["node_requirements"] = [NodeSelectorRequirement(
            fake_cp.INTEGER_INSTANCE_LABEL_KEY, OP_GT, [str(rng.randint(1, 8))])]
    elif rng.random() < 0.2:
        kw["node_requirements"] = [NodeSelectorRequirement(
            ZONE, OP_IN, rng.sample(["test-zone-1", "test-zone-2", "test-zone-3"], 2))]
    return kw


def _encoded_batch(seed: int, with_ports: bool = False):
    """A randomized kernel-supported batch, encoded by the JAX package."""
    rng = random.Random(5000 + seed)
    provider = fake_cp.FakeCloudProvider(fake_cp.instance_types(16))
    solver = TPUSolver(provider, [make_provisioner()])
    while True:
        n_classes = rng.randint(3, 6)
        pods = []
        for i in range(n_classes):
            kw = _pod_kwargs(rng, i, n_classes)
            if with_ports and i == 0:
                kw["host_ports"] = [8080]
            pods.extend(make_pod(**kw) for _ in range(rng.randint(2, 12)))
        try:
            return solver.encode(pods)
        except KernelUnsupported:
            continue  # a combination the kernel routes to the host: redraw


def _leaves(out):
    d = {
        "assign": out.assign, "assign_existing": out.assign_existing, "failed": out.failed,
        "spread_suspect": out.spread_suspect, "remaining": out.remaining,
    }
    for group, tup in (("state", out.state), ("ex", out.ex_state), ("topo", out.topo)):
        for f in tup._fields:
            d[f"{group}.{f}"] = getattr(tup, f)
    out_np = {}
    for k, v in d.items():
        a = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        out_np[k] = a.view(np.int32) if a.dtype == np.uint32 else a
    return out_np


def _assert_same(ref, got, label):
    a, b = _leaves(ref), _leaves(got)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, f"{label}: {k} dtype {a[k].dtype} vs {b[k].dtype}"
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{label}: {k}")


def _both(cls, sa, khb, n_slots, n_passes, features):
    ref = jax.device_get(jsolve._solve_jit(
        cls, sa, n_slots, khb, n_passes=n_passes, features=features))
    tc, ts, tk = carry.tensors_from_numpy(cls, sa, khb, device="cpu")
    got = tsolve.solve_core(tc, ts, n_slots, tk, n_passes=n_passes,
                            features=tuple(features) if features is not None else None)
    return ref, got


SEEDS = range(8)


@pytest.mark.parametrize("seed", SEEDS)
def test_solve_core_matches_reference(seed):
    snap = _encoded_batch(seed, with_ports=(seed == 1))
    cls, sa, khb = jsolve.prepare_host(snap)
    n_slots = jsolve.estimate_slots(snap)
    ft = jsolve.snapshot_features(snap)
    ref, got = _both(cls, sa, khb, n_slots, snap.scan_passes, ft)
    _assert_same(ref, got, f"seed {seed}")


def test_parity_batches_cover_every_feature_family():
    """Across the parity seeds every SnapshotFeatures family the encode can
    switch on is on at least once, as are bounds, a preference ladder and an
    affinity follower (both need extra scan passes).
    ``volume_limits`` needs existing nodes with CSI limits, which a cold
    encode never has; the all-features case below runs its phases."""
    seen = jsolve.SnapshotFeatures(*([False] * len(jsolve.SnapshotFeatures._fields)))
    bounds = ladder = follower = False
    for seed in SEEDS:
        snap = _encoded_batch(seed, with_ports=(seed == 1))
        seen = seen.union(jsolve.snapshot_features(snap))
        bounds |= any(jsolve.prepare_host(snap)[2])
        ladder |= any(c.is_ladder_variant for c in snap.classes)
        # an affinity follower that scans before its target needs a 2nd pass
        follower |= affinity_scan_passes(snap.classes) > 1
    missing = [f for f, on in zip(seen._fields, seen) if not on and f != "volume_limits"]
    assert not missing, missing
    assert bounds and ladder and follower


def test_solve_core_all_features_and_zero_request_class():
    """Every phase family traced (the all-on plan, volume limits included),
    and one class whose requests are all zero: its capacity is BIG, which
    must saturate to INT32_MAX as XLA's convert does, not wrap negative."""
    snap = _encoded_batch(3)
    cls, sa, khb = jsolve.prepare_host(snap)
    requests = np.array(cls.requests)
    requests[0] = 0.0
    cls = cls._replace(requests=requests)
    ref, got = _both(cls, sa, khb, jsolve.estimate_slots(snap), snap.scan_passes, None)
    _assert_same(ref, got, "all features, zero-request class")
    assert int(np.asarray(ref.assign)[0].sum()) > 0


def _existing_planes(cls, sa):
    """Three hand-built existing nodes (two open, one owned by the template;
    zone 0, zone 1, any zone) in the reference's numpy ExistingState /
    ExistingStatic layout, bool masks unpacked."""
    n_ex, n_res = 3, sa.it_alloc.shape[-1]
    k, width = sa.valid.shape
    n_zones, n_ct = sa.tmpl_zone.shape[-1], sa.tmpl_ct.shape[-1]
    n_classes, g1 = cls.count.shape[0], sa.grp_skew.shape[0]
    zone = np.zeros((n_ex, n_zones), bool)
    zone[0, 0] = zone[1, 1 % n_zones] = True
    zone[2] = True
    alloc = np.tile(np.array([4.0, 8 * 2.0**30, 20.0] + [0.0] * (n_res - 3), np.float32), (n_ex, 1))
    ex_state = jsolve.ExistingState(
        used=np.zeros((n_ex, n_res), np.float32), kmask=np.ones((n_ex, k, width), bool),
        kdef=np.zeros((n_ex, k), bool), kneg=np.zeros((n_ex, k), bool),
        kgt=np.full((n_ex, k), -np.inf, np.float32), klt=np.full((n_ex, k), np.inf, np.float32),
        zone=zone, ct=np.ones((n_ex, n_ct), bool),
        ports=np.zeros((n_ex, cls.ports.shape[-1]), bool), vol_used=np.zeros((n_ex, 1), np.int32),
        pod_count=np.zeros(n_ex, np.int32), open_=np.array([True, True, False]),
    )
    ex_static = jsolve.ExistingStatic(
        alloc=alloc, init=np.ones(n_ex, bool), tol=np.ones((n_classes, n_ex), bool),
        grp_node_member=np.zeros((g1, n_ex), np.int32), grp_node_owner=np.zeros((g1, n_ex), np.int32),
        node_capacity=alloc.copy(), node_tmpl=np.zeros(n_ex, np.int32),
        node_owned=np.array([True, False, False]),
        vol_limit=np.full((n_ex, 1), 1 << 30, np.int32),
        cls_vol_add=np.zeros((n_classes, n_ex, 1), np.int32),
        cls_vol_per_pod=np.zeros((n_classes, 1), np.int32),
    )
    return ex_state, ex_static


@pytest.mark.parametrize("seed", (2, 5))
def test_solve_core_with_existing_nodes_matches_reference(seed):
    """Open existing nodes take pods first (the intake and fill the main
    path runs on its closed dummy slot), carried over by
    ``carry.existing_from_numpy``."""
    snap = _encoded_batch(seed)
    cls, sa, khb = jsolve.prepare_host(snap)
    ex_state, ex_static = _existing_planes(cls, sa)
    n_slots = jsolve.estimate_slots(snap)
    ref = jax.device_get(jsolve._solve_jit(
        cls, sa, n_slots, khb, ex_state, ex_static, n_passes=snap.scan_passes, features=None))
    tc, ts, tk = carry.tensors_from_numpy(cls, sa, khb, device="cpu")
    te, tes = carry.existing_from_numpy(ex_state, ex_static, device="cpu")
    got = tsolve.solve_core(tc, ts, n_slots, tk, te, tes, n_passes=snap.scan_passes)
    _assert_same(ref, got, f"existing nodes, seed {seed}")
    assert int(np.asarray(ref.assign_existing).sum()) > 0


# -- pieces with known hazards ------------------------------------------------


def test_capacity_saturates_zero_request_rows():
    rng = np.random.default_rng(0)
    used = (rng.integers(0, 40, (6, 3)) * 0.25).astype(np.float32)
    alloc = (rng.integers(0, 80, (9, 3)) * 0.25).astype(np.float32)
    for size in ([0.25, 0.5, 1.0], [0.0, 0.0, 0.0], [0.0, 0.75, 0.0]):
        size = np.asarray(size, np.float32)
        ref = np.asarray(_jax_capacity(used, size, alloc))
        got = k1.capacity(torch.as_tensor(used), torch.as_tensor(size), torch.as_tensor(alloc))
        np.testing.assert_array_equal(ref, got.numpy())
    zero = k1.capacity(torch.as_tensor(used), torch.zeros(3), torch.as_tensor(alloc))
    assert bool((zero == 2**31 - 1).all())


@jax.jit
def _jax_capacity(used, size, alloc):
    class _S:
        it_alloc = alloc

    return jsolve._capacity(used, size, _S)


def test_to_i32_saturates_like_xla():
    x = np.array([0.0, 3.7, 2147483520.0, 2147483648.0, 1e30, -5.0], np.float32)
    ref = np.asarray(jnp.asarray(x).astype(jnp.int32))
    np.testing.assert_array_equal(ref, tsolve.to_i32(torch.as_tensor(x)).numpy())


@functools.partial(jax.jit, static_argnames=())
def _jax_water_fill(count0, allowed, m):
    return jsolve._water_fill(count0, allowed, m)


@pytest.mark.parametrize("counts,allowed,m", [
    ([0, 0, 0], [True, True, True], 7),
    ([2, 2, 0], [True, True, True], 5),
    ([1, 1, 1], [True, False, True], 4),
    ([3, 0, 3], [True, True, True], 2),
    ([0, 0, 0], [False, False, False], 3),
    ([5, 5, 5], [True, True, True], 0),
])
def test_water_fill_ties_match_reference(counts, allowed, m):
    c = np.asarray(counts, np.int32)
    a = np.asarray(allowed)
    ref = np.asarray(_jax_water_fill(c, a, np.int32(m)))
    got = tsolve._water_fill(torch.as_tensor(c), torch.as_tensor(a), torch.tensor(m, dtype=torch.int32))
    np.testing.assert_array_equal(ref, got.numpy())


@jax.jit
def _jax_fill(quota, cap, priority):
    return jsolve._fill_by_priority(quota, cap, priority)


@jax.jit
def _jax_fill_pref(quota, cap, priority, pref):
    return jsolve._fill_with_pref(quota, cap, priority, pref)


@pytest.mark.parametrize("seed", range(4))
def test_fill_by_priority_ties_match_reference(seed):
    rng = np.random.default_rng(seed)
    n = 64
    cap = rng.integers(0, 4, n).astype(np.int32)
    priority = np.where(cap > 0, rng.integers(0, 3, n), 2**31 - 1).astype(np.int32)
    pref = rng.integers(0, 3, n).astype(np.int32)
    for quota in (0, 5, 40, 500):
        q = np.int32(quota)
        t = torch.as_tensor
        got = k2.fill_by_priority(t(q), t(cap), t(priority))
        np.testing.assert_array_equal(np.asarray(_jax_fill(q, cap, priority)), got.numpy())
        got = tsolve._fill_with_pref(tsolve.PLAIN, t(q), t(cap), t(priority), t(pref))
        np.testing.assert_array_equal(
            np.asarray(_jax_fill_pref(q, cap, priority, pref)), got.numpy())


def test_fill_cumsum_wraps_as_int32():
    cap = np.array([2**30, 2**30, 2**30, 5], np.int32)
    priority = np.arange(4, dtype=np.int32)
    q = np.int32(2**31 - 1)
    got = k2.fill_by_priority(torch.as_tensor(q), torch.as_tensor(cap), torch.as_tensor(priority))
    np.testing.assert_array_equal(np.asarray(_jax_fill(q, cap, priority)), got.numpy())
