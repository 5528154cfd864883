"""The port's relax family through ``CudaSolver`` held against ``TPUSolver``,
on the CPU.

Each case solves the same pods (``_to_jax`` rebuilds the port's objects,
uids kept) in both packages and requires ``last_solve_mode``,
``last_relax_stats``, every ``SolveOutputs`` leaf, the decoded nodes and
the fleet cost to be equal:

- the routing (tests/test_relax.py ``TestModeRouting``): spec over env,
  ``auto`` at ``KC_RELAX_MIN_PODS``, unknown modes to the scan, and the
  scan-mode and relax-mode solves of one fleet;
- every fallback reason: no-planes, existing-nodes, template-limits,
  no-eligible-classes, non-convergence, no-placements;
- both repair branches: the bounded window (2,500 pods of the headline's
  four sizes over 24 types: K11 and K12), its retry at full width when the
  window is reported exhausted, and the full width (``relax_line``'s fleet,
  and 2,000 pods of the four sizes, whose leftover does not fit a window);
- ``bench.py:854 relax_line``'s fleet, 4,000 pods x 24 types, both legs,
  and the pins chip_smoke.py holds the card to (``RELAX_LINE``,
  ``RELAX_WINDOW``);
- ``TestModeChangedEscalation``: ``decide``'s reason order and a session
  that re-anchors with ``mode-changed`` on the same tick as the reference.
"""

import jax
import pytest
import torch
from test_torch_existing import _assert_leaves_equal, _chip_smoke, _to_jax
import torch_history

import karpenter_core_tpu.cloudprovider.fake as jfake
import karpenter_core_tpu.state.cluster as jcluster
import karpenter_core_tpu.testing as jtesting
from karpenter_core_tpu.models.columnar import PodIngest as JIngest
from karpenter_core_tpu.models.store import SnapshotDelta as JDelta
from karpenter_core_tpu.policy import PolicyConfig as JPolicy
from karpenter_core_tpu.relax import solve as jrs
from karpenter_core_tpu.solver import incremental as jinc
from karpenter_core_tpu.solver import modes as jmodes
from karpenter_core_tpu.solver.tpu import TPUSolver
from karpenter_core_tpu_torch.apis import labels as labels_api
from karpenter_core_tpu_torch.apis.objects import LabelSelector, TopologySpreadConstraint
from karpenter_core_tpu_torch.cloudprovider import fake as tfake
from karpenter_core_tpu_torch.models.columnar import PodIngest
from karpenter_core_tpu_torch.models.store import SnapshotDelta
from karpenter_core_tpu_torch.ops import solve as tsolve
from karpenter_core_tpu_torch.policy import PolicyConfig
from karpenter_core_tpu_torch.relax import solve as trs
from karpenter_core_tpu_torch.solver import incremental as tinc
from karpenter_core_tpu_torch.solver import modes
from karpenter_core_tpu_torch.solver.cuda import CudaSolver
from karpenter_core_tpu_torch.state.cluster import StateNode
from karpenter_core_tpu_torch.testing import make_node, make_pod, make_provisioner, workloads

# both packages' slot and feature histories start empty for this module and
# are put back after it (tests/torch_history.py)
isolated_history = torch_history.isolated_history


ONE_SIZE = ({"cpu": "500m", "memory": "512Mi"},)


@pytest.fixture(scope="module", autouse=True)
def _module_environment(tmp_path_factory):
    """The reference memoizes a compiled solve only once its export cache
    could write it: a directory of its own lets each shape compile once.
    Its dispatch watchdog is off (``KC_WATCHDOG=0``): a first compile on a
    loaded CPU may outlast its deadline.  One torch intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KC_TPU_COMPILE_CACHE", str(tmp_path_factory.mktemp("kc_compile_cache")))
        mp.setenv("KC_WATCHDOG", "0")
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _reference_compiled(_module_environment):
    """The reference's relax path compiled once for the module, on the two
    catalogs its cases use (the skewed 8-type fleet; the 24-type window
    fleet at 256 slots): its first relax solve in a process builds some
    forty programs (the relax program, the resumed scan, the window
    gather and scatter, the decode's), which no single case should pay.
    The warm-up's slot counts leave no trace in the reference's history:
    both packages' cases start from the same (empty) one."""
    with torch_history.fresh_history():
        for n_types, n_pods, sizes, n_slots in ((8, 64, ONE_SIZE, 0),
                                                (24, 2500, workloads.HEADLINE_SIZES, 256)):
            _, js = _solvers(n_types)
            jpods = [_to_jax(make_pod(requests=dict(sizes[i % len(sizes)])))
                     for i in range(n_pods)]
            jax.device_get(js.run_prepared(js.prepare_encoded(js.encode(jpods),
                                                              n_slots=n_slots)))


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for key in ("KC_SOLVER_MODE", "KC_RELAX_MAX_ITERS", "KC_RELAX_MIN_PODS"):
        monkeypatch.delenv(key, raising=False)


def _solvers(n_types=8, mode="relax", policy=True, **prov):
    """(CudaSolver, TPUSolver) over the same skewed fake catalog."""
    tprov = tfake.FakeCloudProvider(tfake.instance_types(n_types))
    jprov = jfake.FakeCloudProvider(jfake.instance_types(n_types))
    for p in (tprov, jprov):
        workloads.move_spot_market(p)
    tpol = PolicyConfig(enabled=True, solver_mode=mode) if policy else None
    jpol = JPolicy(enabled=True, solver_mode=mode) if policy else None
    return (CudaSolver(tprov, [make_provisioner(name="default", **prov)], device="cpu",
                       policy=tpol),
            TPUSolver(jprov, [jtesting.make_provisioner(name="default", **prov)], policy=jpol))


def _nodes(results):
    return ([(sorted(p.uid for p in n.pods), list(n.instance_type_names), list(n.zones),
              n.selected) for n in results.new_nodes],
            sorted(p.uid for p in results.failed_pods), results.fleet_cost)


def _solve_both(ts, js, pods, state_nodes=None, jstate_nodes=None, n_slots=0):
    """Encode, prepare, route and decode in both packages; every output held
    equal.  Returns the port's (results, outputs).  Both packages snap
    their slot estimates to counts used before (``compilecache.snap_slots``)
    over the same history, or both take ``n_slots``."""
    jpods = [_to_jax(p) for p in pods]
    jsnap = js.encode(jpods, jstate_nodes)
    jprep = js.prepare_encoded(jsnap, jstate_nodes, n_slots=n_slots)
    jout = jax.device_get(js.run_prepared(jprep))
    jres = js.decode(jsnap, jout, jstate_nodes or [])
    tsnap = ts.encode(pods, state_nodes)
    tprep = ts.prepare_encoded(tsnap, state_nodes, n_slots=n_slots)
    assert tprep.n_slots == jprep.n_slots
    tout = ts.run_prepared(tprep)
    tres = ts.decode(tsnap, tout, state_nodes)
    assert ts.last_solve_mode == js.last_solve_mode
    assert ts.last_relax_stats == getattr(js, "last_relax_stats", None)
    _assert_leaves_equal(jout, tout, ts.last_solve_mode)
    assert _nodes(tres) == _nodes(jres)
    return tres, tout


# -- routing ---------------------------------------------------------------------


@pytest.mark.parametrize("env,spec", [
    (None, None), ("relax", None), ("auto", None), ("relax", "scan"), ("scan", "relax"),
    ("scan", ""), ("simplex", None), (None, "lp"), ("auto", "auto"),
])
def test_resolve_mode_matches_reference(env, spec, monkeypatch):
    if env is not None:
        monkeypatch.setenv("KC_SOLVER_MODE", env)
    tpol = PolicyConfig(solver_mode=spec) if spec is not None else None
    jpol = JPolicy(solver_mode=spec) if spec is not None else None
    assert modes.resolve_mode(tpol) == jmodes.resolve_mode(jpol)
    assert modes.resolve_mode(tpol) in (modes.MODE_SCAN, modes.MODE_RELAX, modes.MODE_AUTO)


def test_spec_wins_and_unknown_modes_degrade(monkeypatch):
    monkeypatch.setenv("KC_SOLVER_MODE", "relax")
    assert modes.resolve_mode(PolicyConfig(solver_mode="scan")) == modes.MODE_SCAN
    monkeypatch.setenv("KC_SOLVER_MODE", "simplex")
    assert modes.resolve_mode(None) == modes.MODE_SCAN
    assert modes.resolve_mode(PolicyConfig(solver_mode="lp")) == modes.MODE_SCAN


@pytest.mark.parametrize("min_pods,n_pods", [("100", 99), ("100", 100), ("bogus", 4095),
                                             ("bogus", 4096), (None, 10**9)])
def test_auto_threshold_and_iteration_cap_match_reference(min_pods, n_pods, monkeypatch):
    if min_pods is not None:
        monkeypatch.setenv("KC_RELAX_MIN_PODS", min_pods)
    for mode in (modes.MODE_AUTO, modes.MODE_RELAX, modes.MODE_SCAN):
        assert modes.relax_selected(mode, n_pods) == jmodes.relax_selected(mode, n_pods)
    assert modes.relax_min_pods() == jmodes.relax_min_pods()
    for cap in ("7", "bogus"):
        monkeypatch.setenv("KC_RELAX_MAX_ITERS", cap)
        assert modes.relax_max_iters() == jmodes.relax_max_iters()


@pytest.mark.parametrize("mode", ["scan", "relax"])
def test_routed_solve_matches_reference(mode):
    """tests/test_relax.py's skewed 64-pod fleet: the scan-mode solve never
    dispatches relax; the relax-mode one lands every pod on zone-2 spot."""
    ts, js = _solvers(mode=mode)
    res, _ = _solve_both(ts, js, [make_pod(requests={"cpu": "500m"}) for _ in range(64)])
    assert ts.last_solve_mode == mode
    assert not res.failed_pods and sum(len(n.pods) for n in res.new_nodes) == 64
    if mode == "relax":
        assert ts.last_relax_stats["converged"]
        assert all(n.selected["zone"] == "test-zone-2" for n in res.new_nodes)


def test_auto_mode_routes_at_the_threshold(monkeypatch):
    monkeypatch.setenv("KC_RELAX_MIN_PODS", "50")
    ts, js = _solvers(mode="auto")
    _solve_both(ts, js, [make_pod(requests={"cpu": "500m"}) for _ in range(49)])
    assert ts.last_solve_mode == "scan"
    _solve_both(ts, js, [make_pod(requests={"cpu": "500m"}) for _ in range(50)])
    assert ts.last_solve_mode == "relax"


def test_env_routes_with_the_policy_off(monkeypatch):
    """``policy=None`` and ``KC_SOLVER_MODE=relax``: the raw price sheet
    (weights 1, 0, 0)."""
    monkeypatch.setenv("KC_SOLVER_MODE", "relax")
    ts, js = _solvers(policy=False)
    _solve_both(ts, js, [make_pod(requests={"cpu": "500m"}) for _ in range(120)])
    assert ts.last_solve_mode == "relax"


# -- the fallbacks ---------------------------------------------------------------


def test_no_planes_falls_back():
    ts, js = _solvers()
    pods = [make_pod(requests={"cpu": "500m"}) for _ in range(16)]
    tprep = ts.prepare_encoded(ts.encode(pods))._replace(pol=None)
    jprep = js.prepare_encoded(js.encode([_to_jax(p) for p in pods]))._replace(pol=None)
    for run, prep, fallback in ((trs.run_relax, tprep, trs.RelaxFallback),
                                (jrs.run_relax, jprep, jrs.RelaxFallback)):
        with pytest.raises(fallback, match="no-planes"):
            run(ts if run is trs.run_relax else js, prep)


def test_existing_nodes_fall_back():
    ts, js = _solvers()
    it = ts.instance_types["default"][0]
    node = make_node(labels={labels_api.PROVISIONER_NAME_LABEL_KEY: "default",
                             labels_api.LABEL_INSTANCE_TYPE_STABLE: it.name},
                     allocatable=it.allocatable(), capacity=dict(it.capacity))
    res, _ = _solve_both(ts, js, [make_pod(requests={"cpu": "500m"}) for _ in range(16)],
                         [StateNode(node)], [jcluster.StateNode(_to_jax(node))])
    assert ts.last_solve_mode == "relax-fallback:existing-nodes"
    assert not res.failed_pods


def test_template_limits_fall_back():
    ts, js = _solvers(limits={"cpu": "1000"})
    _solve_both(ts, js, [make_pod(requests={"cpu": "500m"}) for _ in range(16)])
    assert ts.last_solve_mode == "relax-fallback:template-limits"


def test_no_eligible_classes_fall_back():
    spread = [TopologySpreadConstraint(
        max_skew=1, topology_key=labels_api.LABEL_TOPOLOGY_ZONE,
        label_selector=LabelSelector(match_labels={"app": "s"}))]
    ts, js = _solvers()
    _solve_both(ts, js, [make_pod(labels={"app": "s"}, requests={"cpu": "500m"},
                                  topology_spread=spread) for _ in range(12)])
    assert ts.last_solve_mode == "relax-fallback:no-eligible-classes"


def test_non_convergence_falls_back(monkeypatch):
    monkeypatch.setenv("KC_RELAX_MAX_ITERS", "1")
    ts, js = _solvers()
    res, _ = _solve_both(ts, js, [make_pod(requests={"cpu": "500m"}) for _ in range(64)])
    assert ts.last_solve_mode == "relax-fallback:non-convergence"
    assert ts.last_relax_stats["iters"] == 1 and not res.failed_pods


def test_no_placements_fall_back():
    """One pod: its cell's node takes more than one, so no whole node
    materializes."""
    ts, js = _solvers()
    _solve_both(ts, js, [make_pod(requests={"cpu": "500m"})])
    assert ts.last_solve_mode == "relax-fallback:no-placements"
    assert ts.last_relax_stats["placed"] == 0


# -- the repair branches ------------------------------------------------------------


def _window_spy(monkeypatch, pkg):
    calls = []
    gather = pkg.gather_repair_window

    def spy(carry, idx, n_open_w, *args, **kwargs):
        calls.append((int(idx.shape[0]), int(n_open_w)))
        return gather(carry, idx, n_open_w, *args, **kwargs)

    monkeypatch.setattr(pkg, "gather_repair_window", spy)
    return calls


def _fleet(n_pods, sizes, n_types=24):
    ts, js = _solvers(n_types)
    return ts, js, [make_pod(requests=dict(sizes[i % len(sizes)])) for i in range(n_pods)]


def test_window_branch_matches_reference(monkeypatch):
    """2,500 pods of the headline's four sizes: the leftover fits a window
    of 192 of the 256 slots (K11 gathers it, K12 scatters it back)."""
    import karpenter_core_tpu.ops.solve as jsolve

    tcalls, jcalls = _window_spy(monkeypatch, tsolve), _window_spy(monkeypatch, jsolve)
    ts, js, pods = _fleet(2500, workloads.HEADLINE_SIZES)
    res, out = _solve_both(ts, js, pods, n_slots=256)
    assert tcalls == jcalls == [(192, 102)]
    assert out.assign.shape[1] == 256 and not res.failed_pods


def test_window_exhaustion_retries_full_width(monkeypatch):
    """A window reported exhausted re-runs the repair over every slot."""
    ts, js, pods = _fleet(2500, workloads.HEADLINE_SIZES)
    for solver in (ts, js):
        seen = []
        real = solver.fetch_exhausted

        def exhausted(fetched, slots, real=real, seen=seen):
            seen.append(int(slots))
            return int(slots) == 192 or real(fetched, slots)

        monkeypatch.setattr(solver, "fetch_exhausted", exhausted)
    res, out = _solve_both(ts, js, pods, n_slots=256)
    assert ts.last_solve_mode == "relax" and not res.failed_pods


@pytest.mark.parametrize("fleet", ["four-sizes-2000", "relax_line"])
def test_full_width_branch_matches_reference(fleet, monkeypatch):
    import karpenter_core_tpu.ops.solve as jsolve

    tcalls, jcalls = _window_spy(monkeypatch, tsolve), _window_spy(monkeypatch, jsolve)
    if fleet == "relax_line":
        ts, js, pods = _fleet(4000, ONE_SIZE)
    else:
        ts, js, pods = _fleet(2000, workloads.HEADLINE_SIZES)
    res, _ = _solve_both(ts, js, pods, n_slots=128)  # each fleet's own estimate
    assert ts.last_solve_mode == "relax" and ts.last_relax_stats["leftover"] > 0
    assert tcalls == jcalls == []
    assert not res.failed_pods


def _fleet_summary(solver, results) -> dict:
    stats = getattr(solver, "last_relax_stats", None) or {}
    return {"mode": solver.last_solve_mode, "iters": stats.get("iters"),
            "leftover": stats.get("leftover"), "placed": stats.get("placed"),
            "nodes": len(results.new_nodes), "fleet_cost": results.fleet_cost,
            "failed": len(results.failed_pods)}


def test_relax_line_matches_reference_and_chip_smoke_pin():
    """bench.py:854 relax_line's two legs (4,000 pods of one size x 24
    types) in both packages at the port's slot estimate; chip_smoke.py's
    ``RELAX_LINE`` holds the card to the same numbers."""
    legs = {}
    for mode in ("scan", "relax"):
        ts, js = _solvers(24, mode=mode)
        ts_alone, pods = workloads.relax_fleet(4000, 24, ONE_SIZE, mode=mode, device="cpu")
        res, out = _solve_both(ts, js, pods, n_slots=128)
        legs[mode] = _fleet_summary(ts, res)
        ingest = PodIngest()
        ingest.add_all(pods)
        alone = ts_alone.solve(ingest)  # the solve chip_smoke.py runs
        assert _fleet_summary(ts_alone, alone) == legs[mode]
        assert ts_alone.last_outputs.assign.shape[1] == out.assign.shape[1] == 128
    got = {"fleet_cost_delta": legs["scan"]["fleet_cost"] - legs["relax"]["fleet_cost"],
           "relax_iters": legs["relax"]["iters"], "relax_leftover": legs["relax"]["leftover"],
           "scan_nodes": legs["scan"]["nodes"], "relax_nodes": legs["relax"]["nodes"],
           "fleet_cost": legs["relax"]["fleet_cost"]}
    assert got == _chip_smoke().RELAX_LINE


def test_window_fleet_matches_chip_smoke_pin():
    ts, pods = workloads.relax_fleet(2500, 24, workloads.HEADLINE_SIZES, device="cpu")
    ingest = PodIngest()
    ingest.add_all(pods)
    res = ts.solve(ingest)
    want = _chip_smoke().RELAX_WINDOW
    got = {**_fleet_summary(ts, res), "slots": int(ts.last_outputs.assign.shape[1])}
    assert {k: got[k] for k in want if k != "window"} == {k: v for k, v in want.items()
                                                          if k != "window"}


# -- the session ----------------------------------------------------------------------


def test_decide_reason_order_matches_reference():
    tdelta = SnapshotDelta(from_version=1, to_version=2, pods_before=10, pods_after=10,
                           added={("k",): ("u1",)})
    jdelta = JDelta(from_version=1, to_version=2, pods_before=10, pods_after=10,
                    added={("k",): ("u1",)})
    tpol = tinc.FallbackPolicy(enabled=True, audit_interval=0)
    jpol = jinc.FallbackPolicy(enabled=True, audit_interval=0)
    for changed in (True, False):
        assert tpol.decide(tdelta, 0, 0, mode_changed=changed) == jpol.decide(
            jdelta, 0, 0, mode_changed=changed)
    assert tpol.decide(tdelta, 0, 0, mode_changed=True) == ("full", "mode-changed")
    assert tpol.decide(None, 0, 0, mode_changed=True) == ("full", "first")
    assert tinc.FallbackPolicy(enabled=False).decide(tdelta, 0, 0, mode_changed=True) == (
        "full", "disabled")


def test_session_escalates_on_a_mode_flip_like_the_reference():
    """TestModeChangedEscalation's session, tick for tick in both packages:
    anchored under the scan, the policy flipped to relax, one pod added."""
    tprov = tfake.FakeCloudProvider(tfake.instance_types(8))
    jprov = jfake.FakeCloudProvider(jfake.instance_types(8))
    tsolver = CudaSolver(tprov, [make_provisioner(name="default")], device="cpu",
                         policy=PolicyConfig(enabled=True, solver_mode="scan"))
    jsolver = TPUSolver(jprov, [jtesting.make_provisioner(name="default")],
                        policy=JPolicy(enabled=True, solver_mode="scan"))
    sessions = (tinc.IncrementalSolveSession(tsolver), jinc.IncrementalSolveSession(jsolver))
    ingests = (PodIngest(), JIngest())
    trail = []
    for tick, flip in enumerate((False, False, True, False)):
        if flip:
            tsolver.policy = PolicyConfig(enabled=True, solver_mode="relax")
            jsolver.policy = JPolicy(enabled=True, solver_mode="relax")
        pods = [make_pod(requests={"cpu": "500m"}) for _ in range(24 if tick == 0 else 1)]
        ingests[0].add_all(pods)
        ingests[1].add_all([_to_jax(p) for p in pods])
        got = []
        for session, ingest in zip(sessions, ingests):
            results = session.solve(ingest)
            got.append((session.last_mode, session.last_reason, session._warm.solve_mode,
                        sum(len(n.pods) for n in results.new_nodes)))
        assert got[0] == got[1]
        trail.append(got[0][:3])
    assert trail[0] == ("full", "first", "scan")
    assert trail[1][0] == "delta"
    assert trail[2] == ("full", "mode-changed", "relax")
    assert trail[3][:1] == ("delta",) and trail[3][2] == "relax"
    assert tsolver.last_solve_mode == jsolver.last_solve_mode
