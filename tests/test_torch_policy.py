"""The port's policy objective held against the JAX package's, on the CPU.

Every case feeds the same inputs to both packages (numpy planes, or the
same API objects rebuilt with ``_to_jax``):

- ``PolicyConfig``: ``from_env``, ``merged``, ``resolve`` and ``digest``;
  ``build_planes`` and ``policy_input_digest`` on a catalog with moved
  prices, interruption rates and capacity errors;
- ``select_offerings`` (K13's twin) on seeded full-mantissa planes with
  non-zero knobs and edge rows (nothing allowed, a NaN score, a -inf score,
  -0.0 against +0.0), and on tests/test_policy.py's tie, spot, risk and
  throughput fixtures;
- ``CudaSolver(policy=...)`` against ``TPUSolver(policy=...)`` on
  ``bench.policy_line``'s fleet (2,000 pods x 24 types, zone-2 spot at 0.6x);
- the cost-delta scoring of tests/test_policy.py ``TestConsolidationCostDelta``
  in both directions, and the mid-size consolidation that chip_smoke.py pins
  under the policy (``MID_POLICY_CONSOLIDATION``);
- the escalations of ``TestPolicyDigestEscalation``, session against session.

XLA's CPU code for the reference's ``select_offerings`` computes the score
in three fusions, and its vectorised minimum does not contract
``1 + risk_aversion * risk`` into an FMA where its scalar code does, so on
full-mantissa risks a row's minimum can miss that row's own tie set; the
reference then returns cell 0 (ROADMAP.md queue 3).  The port scores every
cell once, with the arithmetic of the reference's ``cell_scores`` (held
bit for bit below).  The fuzz requires equality on every other row and
shows each such row to be one of these.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_consolidation import workload_problem
from test_torch_existing import _chip_smoke, _to_jax
import torch_history

import karpenter_core_tpu.cloudprovider.fake as jfake
import karpenter_core_tpu.testing as jtesting
from karpenter_core_tpu.cloudprovider.types import Offering as JOffering
from karpenter_core_tpu.controllers import deprovisioning as jdep
from karpenter_core_tpu.models.columnar import PodIngest as JIngest
from karpenter_core_tpu.ops import consolidate as jcons
from karpenter_core_tpu.ops import objective as jobjective
from karpenter_core_tpu.policy import PolicyConfig as JPolicy
from karpenter_core_tpu.policy import build_planes as jbuild_planes
from karpenter_core_tpu.policy import policy_input_digest as jpolicy_digest
from karpenter_core_tpu.solver import consolidation as jconsolidation
from karpenter_core_tpu.solver import incremental as jinc
from karpenter_core_tpu.solver.tpu import TPUSolver
from karpenter_core_tpu_torch import carry as tcarry
from karpenter_core_tpu_torch import testing as ttesting
from karpenter_core_tpu_torch.cloudprovider import fake as tfake
from karpenter_core_tpu_torch.cloudprovider.types import Offering as TOffering
from karpenter_core_tpu_torch.controllers import deprovisioning as tdep
from karpenter_core_tpu_torch.kernels import objective as k13
from karpenter_core_tpu_torch.models.columnar import PodIngest
from karpenter_core_tpu_torch.ops import consolidate as tcons
from karpenter_core_tpu_torch.ops import objective as tobjective
from karpenter_core_tpu_torch.policy import (
    ObjectivePlanes,
    PolicyConfig,
    build_planes,
    policy_input_digest,
)
from karpenter_core_tpu_torch.solver import consolidation as tconsolidation
from karpenter_core_tpu_torch.solver import incremental as tinc
from karpenter_core_tpu_torch.solver.cuda import CudaSolver
from karpenter_core_tpu_torch.testing import make_pod, make_provisioner, workloads

# both packages' slot and feature histories start empty for this module and
# are put back after it (tests/torch_history.py)
isolated_history = torch_history.isolated_history


CPU = torch.device("cpu")
ENV_KEYS = ("KC_POLICY", "KC_POLICY_ENABLED", "KC_POLICY_COST_WEIGHT",
            "KC_POLICY_THROUGHPUT_WEIGHT", "KC_POLICY_RISK_AVERSION",
            "KC_POLICY_SPOT_PREFERENCE", "KC_POLICY_COUNTER_PROPOSALS",
            "KC_POLICY_MAX_RESIZE_FRACTION", "KC_SOLVER_MODE")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)


# -- PolicyConfig and the planes -----------------------------------------------


@pytest.mark.parametrize("env", [
    {},
    {"KC_POLICY_ENABLED": "1", "KC_POLICY_COST_WEIGHT": "0.7",
     "KC_POLICY_THROUGHPUT_WEIGHT": "0.25", "KC_POLICY_RISK_AVERSION": "0.5",
     "KC_POLICY_SPOT_PREFERENCE": "0", "KC_POLICY_COUNTER_PROPOSALS": "true"},
    {"KC_POLICY_ENABLED": "1", "KC_POLICY": "0"},
    {"KC_POLICY_ENABLED": "false", "KC_POLICY_COST_WEIGHT": "junk", "KC_SOLVER_MODE": "relax"},
])
def test_policy_config_from_env_matches_reference(env, monkeypatch):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    got, ref = PolicyConfig.from_env(), JPolicy.from_env()
    assert dataclasses.astuple(got) == dataclasses.astuple(ref)
    assert got.digest() == ref.digest()


SPECS = [
    None, {},
    {"enabled": True, "costWeight": "2", "riskAversion": "x", "junk": 1,
     "throughput": {"fake-it-1": 0.5, "fake-it-0": 2}},
    {"enabled": True, "spotPreference": False, "solverMode": "scan", "throughputWeight": 0.3},
    {"enabled": "yes", "maxResizeFraction": None, "throughput": ["not", "a", "map"]},
]


@pytest.mark.parametrize("kill", (False, True))
@pytest.mark.parametrize("spec", range(len(SPECS)))
def test_policy_config_merged_and_resolve_match_reference(spec, kill, monkeypatch):
    if kill:
        monkeypatch.setenv("KC_POLICY", "0")
    spec = SPECS[spec]
    base, jbase = PolicyConfig(cost_weight=0.5), JPolicy(cost_weight=0.5)
    got, ref = base.merged(spec), jbase.merged(spec)
    assert dataclasses.astuple(got) == dataclasses.astuple(ref)
    assert got.digest() == ref.digest()
    assert [got.throughput_of(n) for n in ("fake-it-0", "fake-it-1", "x")] == [
        ref.throughput_of(n) for n in ("fake-it-0", "fake-it-1", "x")]
    # resolve: the highest-weight provisioner that declares a policy wins
    resolved = []
    for factory in (make_provisioner, jtesting.make_provisioner):
        provs = [factory(name="low", weight=1), factory(name="high", weight=9),
                 factory(name="none", weight=20)]
        provs[0].spec.policy = {"enabled": True, "costWeight": 3}
        provs[1].spec.policy = spec
        resolved.append(dataclasses.astuple(
            (PolicyConfig if factory is make_provisioner else JPolicy).resolve(provs)))
    assert resolved[0] == resolved[1]


def _providers(n_types=6):
    """The same fake catalog in both packages, with a moved spot market,
    interruption rates and a type failing creates."""
    out = []
    for fake in (tfake, jfake):
        provider = fake.FakeCloudProvider(fake.instance_types(n_types))
        workloads.move_spot_market(provider)
        provider.set_interruption_rate("fake-it-1", 0.4)
        provider.set_interruption_rate("fake-it-3", 0.123456789, capacity_type="on-demand")
        provider.capacity_errors["fake-it-2"] = 3
        provider.capacity_errors["fake-it-4"] = 0
        out.append(provider)
    return out


def test_build_planes_and_input_digest_match_reference():
    tprov, jprov = _providers()
    config = PolicyConfig(enabled=True, throughput=(("fake-it-0", 2.5), ("fake-it-5", 0.1)))
    jconfig = JPolicy(enabled=True, throughput=config.throughput)
    axes = (["test-zone-1", "test-zone-2", "test-zone-3"], ["on-demand", "spot"])
    names = [it.name for it in tprov.get_instance_types(None)] + ["missing"]
    got = build_planes(names, *axes, {it.name: it for it in tprov.get_instance_types(None)},
                       config=config, provider=tprov)
    ref = jbuild_planes(names, *axes, {it.name: it for it in jprov.get_instance_types(None)},
                        config=jconfig, provider=jprov)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert (got.risk > 0).any() and np.isinf(got.price).any()

    def digests():
        t = policy_input_digest({"p": tprov.get_instance_types(None)}, config, provider=tprov)
        j = jpolicy_digest({"p": jprov.get_instance_types(None)}, jconfig, provider=jprov)
        return t, j

    seen = set()
    for change in (None, ("set_price", "fake-it-0", 77.0), ("set_interruption_rate", "fake-it-0", 0.6),
                   ("ice", "fake-it-0", 2), ("ice", "fake-it-0", 1), ("ice", "fake-it-0", 0)):
        if change is not None:
            kind, name, value = change
            for provider in (tprov, jprov):
                if kind == "ice":
                    provider.capacity_errors[name] = value
                else:
                    getattr(provider, kind)(name, value)
        t, j = digests()
        assert t == j
        seen.add(t)
    # 2 -> 1 pending creates is no change of the binary state the planes
    # read, and clearing them returns to the digest before they began
    assert len(seen) == 4
    assert policy_input_digest([]) == jpolicy_digest([])


# -- K13's twin against the reference's select_offerings ---------------------------


def _reference_select(case, config):
    sel = jobjective.select_offerings(
        *(jnp.asarray(case[k]) for k in ("viable", "zone", "ct", "open_", "pod_count", "price",
                                         "risk", "throughput", "is_spot")),
        jobjective.weights_of(config))
    return [np.asarray(x) for x in jax.device_get(tuple(sel))]


def _port_select(case, config):
    planes = tcarry.objective_planes_from_numpy(
        ObjectivePlanes(case["price"], case["risk"], case["throughput"]), CPU)
    t = {k: torch.as_tensor(case[k]) for k in ("viable", "zone", "ct", "open_", "pod_count",
                                               "is_spot")}
    sel = tobjective.select_offerings(t["viable"], t["zone"], t["ct"], t["open_"], t["pod_count"],
                                      *planes, t["is_spot"], tcarry.weights_from_config(config))
    return [x.numpy() for x in sel]


def _unfused_scores(case, config):
    """The score plane with ``1 + risk_aversion * risk`` rounded in two
    steps (the reference's vectorised minimum; see the module doc)."""
    ra, cw, tw = (np.float32(v) for v in (config.risk_aversion, config.cost_weight,
                                          config.throughput_weight))
    with np.errstate(invalid="ignore", over="ignore"):
        one = (np.float32(1) + ra * case["risk"]).astype(np.float32)
        expected = (case["price"] * one).astype(np.float32)
        penalty = (tw * case["throughput"][:, None, None]).astype(np.float32)
        return (cw.astype(np.float64) * expected - penalty).astype(np.float32)


LEAVES = ("sel_it", "sel_zone", "sel_ct", "price", "expected", "active")


def _check_selection(case, config):
    """Leaf-for-leaf parity, rows the reference contradicts its own score
    plane on excepted and shown to be such rows; returns how many."""
    ref, got = _reference_select(case, config), _port_select(case, config)
    # the score plane: the port's equals the reference's cell_scores, jitted alone
    jw = jobjective.weights_of(config)
    jexp, jscore = (np.asarray(a) for a in jax.jit(jobjective.cell_scores)(
        case["price"], case["risk"], case["throughput"], jw))
    texp, tscore = tobjective.cell_scores(*(torch.as_tensor(case[k]) for k in
                                            ("price", "risk", "throughput")),
                                          tcarry.weights_from_config(config))
    np.testing.assert_array_equal(texp.numpy(), jexp)
    np.testing.assert_array_equal(tscore.numpy(), jscore)

    n = case["viable"].shape[0]
    n_zct = case["zone"].shape[1] * case["ct"].shape[1]
    differ = np.zeros(n, dtype=bool)
    for a, b in zip(ref[:6], got[:6]):
        differ |= ~((a == b) | (np.isnan(a) & np.isnan(b)) if a.dtype.kind == "f" else a == b)
    allowed = (case["viable"][:, :, None, None] & case["zone"][:, None, :, None]
               & case["ct"][:, None, None, :] & np.isfinite(case["price"])[None]).reshape(n, -1)
    scored = np.where(allowed, jscore.reshape(-1)[None], np.inf)
    unfused = _unfused_scores(case, config).reshape(-1)
    for r in np.nonzero(differ)[0]:
        ref_cell = (ref[0][r] * n_zct + ref[1][r] * case["ct"].shape[1] + ref[2][r])
        got_cell = (got[0][r] * n_zct + got[1][r] * case["ct"].shape[1] + got[2][r])
        best = scored[r].min()
        assert scored[r, got_cell] == best  # the port: the plane's own argmin
        assert scored[r, ref_cell] != best  # the reference: not a tie of its own plane
        assert unfused[got_cell] != jscore.reshape(-1)[got_cell]  # contraction-sensitive
    if not differ[np.asarray(ref[5]) | np.asarray(got[5])].any():
        assert ref[6] == got[6] and ref[7] == got[7]
    # the fleet sums take XLA's order: the twin's tree sum of the reference's
    # own leaves gives the reference's sums bit for bit
    for leaf, total in ((ref[3], ref[6]), (ref[4], ref[7])):
        masked = np.where(ref[5], leaf, np.float32(0))
        assert k13.tree_sum_plain(torch.as_tensor(masked)).numpy() == total
    return int(differ.sum())


FUZZ = [  # (n, types, zones, capacity types, knobs)
    (300, 40, 3, 2, dict(cost_weight=0.7310001, throughput_weight=0.3330001,
                         risk_aversion=0.6170001)),
    (86, 38, 3, 1, dict(cost_weight=0.2023, throughput_weight=0.9241, risk_aversion=0.8531)),
    (1000, 57, 2, 2, dict(cost_weight=1.0, throughput_weight=0.0, risk_aversion=0.25,
                          spot_preference=False)),
    (64, 9, 3, 2, dict(cost_weight=0.0, throughput_weight=0.5, risk_aversion=0.0)),
    (250, 24, 1, 2, dict(throughput_weight=0.0)),  # a NaN score from 0 * inf
    (1100, 12, 3, 2, dict(cost_weight=3.0, throughput_weight=1.5, risk_aversion=1.0)),
]


@pytest.mark.parametrize("seed", range(len(FUZZ)))
def test_select_offerings_fuzz_matches_reference(seed):
    n, n_it, n_z, n_ct, knobs = FUZZ[seed]
    case = workloads.objective_case(np.random.default_rng(seed), n, n_it, n_z, n_ct)
    config = JPolicy(enabled=True, **knobs)
    differ = _check_selection(case, config)
    ref, got = _reference_select(case, config), _port_select(case, config)
    for r in range(4):  # the edge rows: exact
        assert all(np.array_equal(a[r], b[r], equal_nan=True) for a, b in zip(ref[:6], got[:6]))
    assert not got[5][0] and not got[5][1]  # nothing allowed; a NaN score
    assert differ <= n // 20


def _draw_case(rng):
    """One draw of the first fuzz written for this port (shapes, knobs and
    planes from one generator)."""
    n_it, n_z, n_ct, n = (int(rng.integers(1, 60)), int(rng.integers(1, 4)),
                          int(rng.integers(1, 3)), int(rng.integers(1, 300)))
    price = (rng.random((n_it, n_z, n_ct)) * 5).astype(np.float32)
    price[rng.random((n_it, n_z, n_ct)) < 0.2] = np.inf
    case = dict(price=price, risk=rng.random((n_it, n_z, n_ct)).astype(np.float32),
                throughput=rng.random(n_it).astype(np.float32))
    knobs = dict(cost_weight=float(rng.random()), throughput_weight=float(rng.random()),
                 risk_aversion=float(rng.random()), spot_preference=bool(rng.random() < 0.5))
    case.update(viable=rng.random((n, n_it)) < 0.5, zone=rng.random((n, n_z)) < 0.7,
                ct=rng.random((n, n_ct)) < 0.8, open_=rng.random(n) < 0.8,
                pod_count=rng.integers(0, 3, n).astype(np.int32),
                is_spot=np.arange(n_ct) == n_ct - 1)
    return case, knobs


def test_select_offerings_reference_fusion_fault():
    """The queue-3 entry's input (ROADMAP.md): ``default_rng(1)``'s second
    draw (86 slots, 38 types, 3 zones, 1 capacity type).  In one row the
    reference's vectorised minimum misses its own tie set and the reference
    returns cell 0; the port takes the score plane's argmin there and equals
    the reference on every other row and leaf."""
    rng = np.random.default_rng(1)
    _draw_case(rng)
    case, knobs = _draw_case(rng)
    assert _check_selection(case, JPolicy(enabled=True, **knobs)) == 1


def _fixture(name):
    """tests/test_policy.py's fixtures (:209-275) as selection cases."""
    one = lambda *s: np.ones(s, dtype=bool)  # noqa: E731
    if name == "tie":
        price = np.full((3, 2, 2), 1.0, dtype=np.float32)
        return dict(viable=one(2, 3), zone=one(2, 2), ct=one(2, 2), price=price,
                    risk=np.zeros_like(price), throughput=np.zeros(3, np.float32),
                    is_spot=np.array([False, True])), dict(spot_preference=False)
    if name == "spot":
        price = np.full((1, 1, 2), 2.5, dtype=np.float32)
        return dict(viable=one(1, 1), zone=one(1, 1), ct=one(1, 2), price=price,
                    risk=np.zeros_like(price), throughput=np.zeros(1, np.float32),
                    is_spot=np.array([False, True])), dict(spot_preference=True)
    if name == "risk":
        return dict(viable=one(1, 1), zone=one(1, 1), ct=one(1, 2),
                    price=np.array([[[1.5, 1.0]]], dtype=np.float32),
                    risk=np.array([[[0.0, 0.8]]], dtype=np.float32),
                    throughput=np.zeros(1, np.float32),
                    is_spot=np.array([False, True])), dict(risk_aversion=1.0)
    price = np.array([[[1.0]], [[1.2]]], dtype=np.float32)
    return dict(viable=one(1, 2), zone=one(1, 1), ct=one(1, 1), price=price,
                risk=np.zeros_like(price), throughput=np.array([0.0, 0.5], np.float32),
                is_spot=np.array([False])), dict(throughput_weight=1.0)


@pytest.mark.parametrize("name,want", [("tie", (0, 0, 0)), ("spot", (0, 0, 1)),
                                       ("risk", (0, 0, 0)), ("throughput", (1, 0, 0))])
def test_select_offerings_fixtures_match_reference(name, want):
    case, knobs = _fixture(name)
    n = case["viable"].shape[0]
    case.update(open_=np.ones(n, bool), pod_count=np.ones(n, np.int32))
    config = JPolicy(enabled=True, **knobs)
    ref, got = _reference_select(case, config), _port_select(case, config)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    assert (int(got[0][0]), int(got[1][0]), int(got[2][0])) == want


# -- the solver, consolidation and the session --------------------------------------


def _policy_line(n_pods=2000, n_types=24, **knobs):
    """bench.policy_line's fleet in both packages: (port results, port
    solver, reference results)."""
    sizes = [{"cpu": "500m", "memory": "512Mi"}, {"cpu": 1, "memory": "2Gi"},
             {"cpu": "250m", "memory": "256Mi"}]
    pods = [make_pod(requests=sizes[i % len(sizes)]) for i in range(n_pods)]
    tprov = tfake.FakeCloudProvider(tfake.instance_types(n_types))
    workloads.move_spot_market(tprov)
    jprov = jfake.FakeCloudProvider(jfake.instance_types(n_types))
    workloads.move_spot_market(jprov)
    solver = CudaSolver(tprov, [make_provisioner(name="default")], device="cpu",
                        policy=PolicyConfig(enabled=True, **knobs))
    jsolver = TPUSolver(jprov, [jtesting.make_provisioner(name="default")],
                        policy=JPolicy(enabled=True, **knobs))
    ingest, jingest = PodIngest(), JIngest()
    ingest.add_all(pods)
    jingest.add_all([_to_jax(p) for p in pods])
    return solver.solve(ingest), solver, jsolver.solve(jingest)


@pytest.mark.parametrize("knobs", [{}, {"spot_preference": False}])
def test_policy_solver_matches_reference_on_policy_line(knobs):
    got, solver, ref = _policy_line(**knobs)
    assert len(got.new_nodes) == len(ref.new_nodes) > 0
    for a, b in zip(got.new_nodes, ref.new_nodes):
        assert sorted(p.name for p in a.pods) == sorted(p.name for p in b.pods)
        assert a.selected == b.selected
        assert a.instance_type_names == b.instance_type_names
        assert (a.zones, a.capacity_types) == (b.zones, b.capacity_types)
    assert got.fleet_cost == ref.fleet_cost and got.fleet_expected_cost == ref.fleet_expected_cost
    assert "objective_s" in solver.stages
    if not knobs:  # zone-2 spot is the strict argmin everywhere
        assert all(d.zones == ["test-zone-2"] and d.capacity_types == ["spot"]
                   for d in got.new_nodes)
    launch = solver.to_launchable(got.new_nodes[0])
    assert launch.instance_type_options[0].name == got.new_nodes[0].selected["instance_type"]


def test_disabled_policy_stamps_nothing():
    solver = CudaSolver(tfake.FakeCloudProvider(tfake.instance_types(5)),
                        [make_provisioner(name="default")], device="cpu")
    results = solver.solve([make_pod(requests={"cpu": "500m"}) for _ in range(6)])
    assert results.fleet_cost is None and results.fleet_expected_cost is None
    assert all(d.selected is None for d in results.new_nodes)


def _cost_delta_fixture(pkg, policy):
    """TestConsolidationCostDelta's search and candidates in one package."""
    fake, testing, dep, offering, search_cls = pkg
    catalog = [
        fake.new_instance_type("big", resources={"cpu": 8.0},
                               offerings=[offering("on-demand", "test-zone-1", 10.0)]),
        fake.new_instance_type("small", resources={"cpu": 2.0},
                               offerings=[offering("on-demand", "test-zone-1", 1.0)]),
        fake.new_instance_type("mid", resources={"cpu": 6.0},
                               offerings=[offering("on-demand", "test-zone-1", 9.5)]),
    ]
    prov = testing.make_provisioner(name="default")
    kwargs = {"device": "cpu"} if search_cls is tconsolidation.CudaConsolidationSearch else {}
    search = search_cls(fake.FakeCloudProvider(catalog), [prov], policy=policy, **kwargs)
    snapshot = search.solver.encode([testing.make_pod(requests={"cpu": "100m"})])
    by_name = {it.name: it for it in catalog}
    candidates = [dep.CandidateNode(
        node=testing.make_node(name=name), state_node=None, instance_type=by_name[it],
        capacity_type="on-demand", zone="test-zone-1", provisioner=prov, disruption_cost=0.0,
    ) for name, it in (("n-big", "big"), ("n-small", "small"))]
    return search, snapshot, candidates


def _fake_sweep(snapshot, new_cost, outputs_cls, array):
    n_i, n_z, n_ct = len(snapshot.it_names), len(snapshot.zones), len(snapshot.capacity_types)
    viable = np.zeros((2, 1, n_i), dtype=bool)
    viable[1, 0, snapshot.it_names.index("mid")] = True
    zone = np.zeros((2, 1, n_z), dtype=bool)
    zone[1, 0, snapshot.zones.index("test-zone-1")] = True
    ct = np.zeros((2, 1, n_ct), dtype=bool)
    ct[1, 0, snapshot.capacity_types.index("on-demand")] = True
    used = np.zeros((2, 1, len(snapshot.resources)), dtype=np.float32)
    used[1, 0, snapshot.resources.index("cpu")] = 4.0
    return outputs_cls(*(array(a) for a in (
        np.array([0, 1], np.int32), np.zeros(2, np.int32), np.zeros(2, bool), viable, zone, ct,
        used, np.zeros((2, 1), np.int32), np.array([0.0, new_cost], np.float32))))


@pytest.mark.parametrize("enabled,new_cost,want", [
    (False, 9.5, (2, "replace")),   # node count: the largest prefix
    (True, 9.5, (1, "delete")),     # cost delta: deleting n-big saves 10 > 11 - 9.5
    (True, 0.5, (2, "replace")),    # a nearly free replacement saves 10.5
])
def test_cost_delta_scoring_matches_reference(enabled, new_cost, want, monkeypatch):
    sizes = np.array([1, 2], dtype=np.int32)
    tsearch, tsnap, tcands = _cost_delta_fixture(
        (tfake, ttesting, tdep, TOffering, tconsolidation.CudaConsolidationSearch),
        PolicyConfig(enabled=True) if enabled else None)
    monkeypatch.setattr(tconsolidation.consolidate_ops, "sweep", lambda *a, **k: _fake_sweep(
        tsnap, new_cost, tcons.SweepOutputs, torch.as_tensor))
    tsearch.stages = {"sweep_s": [], "decode_s": 0.0}
    got, got_k = tsearch._evaluate_sweep(tsnap, None, sizes, tcands)
    jsearch, jsnap, jcands = _cost_delta_fixture(
        (jfake, jtesting, jdep, JOffering, jconsolidation.TPUConsolidationSearch),
        JPolicy(enabled=True) if enabled else None)
    monkeypatch.setattr(jconsolidation.consolidate_ops, "run_sweep", lambda *a, **k: _fake_sweep(
        jsnap, new_cost, jcons.SweepOutputs, np.asarray))
    ref, ref_k = jsearch._evaluate_sweep(jsnap, None, None, None, None, sizes, jcands)
    assert (got_k, got.action.value) == (ref_k, ref.action.value) == want
    assert [n.name for n in got.nodes_to_remove] == [n.name for n in ref.nodes_to_remove]


def test_search_without_refine_stops_after_the_coarse_pass():
    calls = []

    def evaluate(sizes):
        calls.append(sizes)
        return "cmd", int(sizes[len(sizes) // 2])

    for mod in (tconsolidation, jconsolidation):
        calls.clear()
        assert mod.search_largest_prefix(1000, evaluate, refine=False) == "cmd"
        assert len(calls) == 1
        calls.clear()
        mod.search_largest_prefix(1000, evaluate)
        assert len(calls) > 1


def test_mid_size_policy_command_matches_chip_smoke_pin():
    """The mid-size consolidation under the policy objective that
    chip_smoke.py runs on the card (build_cluster(1000, 100, 5, 0.6, 2024),
    every node a candidate): both packages give the command it pins."""
    smoke = _chip_smoke()
    problem = workload_problem(smoke.MID_NODES, smoke.MID_TYPES, smoke.CLUSTER_SEED)
    _, tnodes, tbound, tcands = problem.t
    jsearch, jnodes, jbound, jcands = problem.j
    tsearch = tconsolidation.CudaConsolidationSearch(
        *workloads.build_provider(smoke.MID_TYPES, 5), device="cpu",
        policy=PolicyConfig(enabled=True))
    jsearch = jconsolidation.TPUConsolidationSearch(
        jsearch.solver.cloud_provider, jsearch.solver.provisioners,
        policy=JPolicy(enabled=True))
    got = tsearch.compute_command(tcands, [], tnodes, tbound)
    ref = jsearch.compute_command(jcands, [], jnodes, jbound)
    assert smoke.command_summary(got) == smoke.command_summary(ref)
    assert smoke.command_summary(got) == smoke.MID_POLICY_CONSOLIDATION
    assert len(tsearch.passes) == 1  # no refinement under cost-delta scoring


def _sessions():
    tprov = tfake.FakeCloudProvider(tfake.instance_types(4))
    jprov = jfake.FakeCloudProvider(jfake.instance_types(4))
    policy = dict(enabled=True, audit_interval=0, max_delta_fraction=0.9)
    tsession = tinc.IncrementalSolveSession(
        CudaSolver(tprov, [make_provisioner(name="p")], device="cpu"),
        tinc.FallbackPolicy(**policy))
    jsession = jinc.IncrementalSolveSession(
        TPUSolver(jprov, [jtesting.make_provisioner(name="p")]), jinc.FallbackPolicy(**policy))
    return (tprov, jprov), (tsession, jsession), (PodIngest(), JIngest())


def _tick(sessions, ingests, n=1):
    pods = [make_pod(requests={"cpu": "500m"}) for _ in range(n)]
    ingests[0].add_all(pods)
    ingests[1].add_all([_to_jax(p) for p in pods])
    for session, ingest in zip(sessions, ingests):
        session.solve(ingest)
    (t, j) = sessions
    assert (t.last_mode, t.last_reason) == (j.last_mode, j.last_reason)
    return t.last_mode, t.last_reason


@pytest.mark.parametrize("change", ["price", "interruption_rate", "capacity_errors"])
def test_policy_digest_escalation_matches_reference(change, monkeypatch):
    monkeypatch.setenv("KC_WATCHDOG", "0")
    providers, sessions, ingests = _sessions()
    assert _tick(sessions, ingests, 10) == ("full", "first")
    assert _tick(sessions, ingests)[0] == "delta"
    for provider in providers:
        if change == "price":
            provider.set_price("fake-it-0", 77.0)
        elif change == "interruption_rate":
            provider.set_interruption_rate("fake-it-1", 0.6)
        else:
            provider.capacity_errors["fake-it-0"] = 3
    mode, reason = _tick(sessions, ingests)
    assert mode == "full" and reason == _chip_smoke().POLICY_ESCALATION_REASON
    assert _tick(sessions, ingests)[0] == "delta"
    if change == "capacity_errors":
        for provider in providers:
            provider.capacity_errors["fake-it-0"] = 2  # still pending: no escalation
        assert _tick(sessions, ingests)[0] == "delta"
        for provider in providers:
            provider.capacity_errors["fake-it-0"] = 0
        assert _tick(sessions, ingests)[0] == "full"
