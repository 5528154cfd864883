"""The port's multi-node consolidation held against the JAX package's, on the CPU.

- ``search_largest_prefix`` on the cases of tests/test_tpu_consolidation.py,
  against the JAX function: the same answer from the same passes;
- the plain twins of K8 (lane set-up) and K9 (lane finish, ``node_prices``)
  against the reference's expressions on seeded numpy planes;
- ``ops.consolidate.sweep``, every ``SweepOutputs`` leaf of every lane,
  against the JAX package's ``run_sweep`` on the same consolidation problem
  (``build_cluster`` clusters and the fixtures of
  tests/test_tpu_consolidation.py, one of them with an uninitialized node a
  lane falls back on): exact, except ``new_cost``, an f32 sum the reference
  itself lets vary with reduction order (tests/test_mesh_dispatch.py:302-310),
  at rtol 1e-6;
- lane independence: a lane of a sweep equals a one-lane sweep of its size;
- ``CudaConsolidationSearch.compute_command`` against
  ``TPUConsolidationSearch.compute_command`` on a 200-node cluster, and the
  mid-size command that chip_smoke.py pins on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_existing import _chip_smoke, _reference_inputs
from test_tpu_consolidation import build_cluster as harness_cluster
from test_tpu_consolidation import get_candidates
import torch_history

import karpenter_core_tpu.apis.labels as jlabels
import karpenter_core_tpu.apis.objects as jobj
import karpenter_core_tpu.cloudprovider.fake as jfake
import karpenter_core_tpu.controllers.deprovisioning as jdep
import karpenter_core_tpu.scheduling as jsched
import karpenter_core_tpu.state.cluster as jcluster
import karpenter_core_tpu.testing as jtesting
import karpenter_core_tpu_torch.apis.objects as tobj
import karpenter_core_tpu_torch.apis.v1alpha5 as tv1
import karpenter_core_tpu_torch.cloudprovider.fake as tfake
import karpenter_core_tpu_torch.scheduling as tsched
import karpenter_core_tpu_torch.state.cluster as tcluster
import karpenter_core_tpu_torch.testing as ttesting
from karpenter_core_tpu.ops import consolidate as jcons
from karpenter_core_tpu.ops import solve as jsolve
from karpenter_core_tpu.solver import consolidation as jconsolidation
from karpenter_core_tpu_torch.controllers import deprovisioning as tdep
from karpenter_core_tpu_torch.kernels import consolidate as k89
from karpenter_core_tpu_torch.ops import consolidate as tcons
from karpenter_core_tpu_torch.ops import solve as tsolve
from karpenter_core_tpu_torch.solver import consolidation as tconsolidation
from karpenter_core_tpu_torch.testing import workloads

# both packages' slot and feature histories start empty for this module and
# are put back after it (tests/torch_history.py)
isolated_history = torch_history.isolated_history


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The planes here are small: one intra-op thread runs them faster than
    many, and leaves the other cores to the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- objects of one package rebuilt in the other -------------------------------


def _to_port(x):
    """A JAX-package API object rebuilt from the port's classes of the same
    names (the inverse of test_torch_existing._to_jax)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = getattr(tobj, type(x).__name__, None) or getattr(tv1, type(x).__name__)
        return cls(**{f.name: _to_port(getattr(x, f.name))
                      for f in dataclasses.fields(x) if f.init})
    if isinstance(x, list):
        return [_to_port(v) for v in x]
    if isinstance(x, dict):
        return {k: _to_port(v) for k, v in x.items()}
    return x


def _state_nodes(cluster_mod, nodes, bound):
    """StateNodes of one package, each filled by update_for_pod."""
    by_node = {}
    for p in bound:
        by_node.setdefault(p.spec.node_name, []).append(p)
    out = []
    for node in nodes:
        sn = cluster_mod.StateNode(node)
        for p in by_node.get(node.metadata.name, []):
            sn.update_for_pod(p)
        out.append(sn)
    return out


def _candidates(dep, cands, nodes, bound, catalogs, provisioners):
    """One package's CandidateNodes for another package's list, in its order:
    the same node names, types, offerings, costs and pods (by uid)."""
    by_name = {sn.node.metadata.name: sn for sn in nodes}
    pods = {p.uid: p for p in bound}
    return [dep.CandidateNode(
        node=by_name[c.node.metadata.name].node, state_node=by_name[c.node.metadata.name],
        instance_type=catalogs[c.provisioner.name][c.instance_type.name],
        capacity_type=c.capacity_type, zone=c.zone, provisioner=provisioners[c.provisioner.name],
        disruption_cost=c.disruption_cost, pods=[pods[p.uid] for p in c.pods],
    ) for c in cands]


class Problem:
    """One consolidation problem built identically in both packages: the
    port's search, state nodes, bound pods and candidates, and the JAX
    package's."""

    def __init__(self, jsearch, jnodes, jbound, jcands, tsearch, tnodes, tbound, tcands):
        self.j = (jsearch, jnodes, jbound, jcands)
        self.t = (tsearch, tnodes, tbound, tcands)


def _catalogs(solver):
    return {p.name: {it.name: it for it in solver.instance_types[p.name]}
            for p in solver.provisioners}


def workload_problem(n_nodes, n_types, seed) -> Problem:
    """``workloads.build_cluster`` with every node a candidate."""
    tnodes, tbound = workloads.build_cluster(n_nodes, n_types, 5, 0.6, seed)
    tcands = workloads.consolidation_candidates(tnodes, tbound, n_types, 5)
    tsearch = tconsolidation.CudaConsolidationSearch(*workloads.build_provider(n_types, 5),
                                                     device="cpu")
    _, jnodes, jbound, _ = _reference_inputs(tnodes, tbound, [], n_types)
    provs = [jtesting.make_provisioner(name=f"prov-{i}", weight=5 - i) for i in range(5)]
    jsearch = jconsolidation.TPUConsolidationSearch(
        jfake.FakeCloudProvider(jfake.instance_types(n_types)), provs)
    jcands = _candidates(jdep, tcands, jnodes, jbound, _catalogs(jsearch.solver),
                         {p.name: p for p in jsearch.solver.provisioners})
    return Problem(jsearch, jnodes, jbound, jcands, tsearch, tnodes, tbound, tcands)


# the sweep's fixtures; "empty" (no pod anywhere) never reaches a sweep in
# either package (test_empty_problem_needs_no_sweep)
FIXTURES = ("replace", "full", "uninitialized")


def fixture_problem(name) -> Problem:
    """The clusters of tests/test_tpu_consolidation.py (``empty``: every pod
    deleted; ``replace``: two oversized nodes with one small pod each;
    ``full``: one node of the one-type catalog), provisioned by the JAX
    package's controllers and rebuilt as port objects.  ``uninitialized``
    is the ``replace`` cluster plus an owned, roomy node that has not
    initialized: no candidate, but the lane closing both candidates can only
    place their pods there."""
    n_types = 1 if name == "full" else 5
    if name == "empty":
        env = harness_cluster(n_nodes=2, pods_per_node=1, pod_cpu="600m")
        for pod in env.kube.list_pods():
            env.kube.delete(pod, force=True)
    elif name == "full":
        env = harness_cluster(n_nodes=1, pods_per_node=4, pod_cpu="900m", instance_types=1)
    else:
        env = harness_cluster(n_nodes=2, pods_per_node=1, pod_cpu="500m", oversize=True)
    jcands = get_candidates(env)
    jbound = env.kube.list_pods()
    jnodes = env.cluster.snapshot_nodes()
    nodes = [sn.node for sn in jnodes]
    if name == "uninitialized":
        labels = {k: v for k, v in nodes[0].metadata.labels.items()
                  if k not in (jlabels.LABEL_NODE_INITIALIZED, jlabels.LABEL_HOSTNAME)}
        labels[jlabels.LABEL_HOSTNAME] = "warming-up"
        node = jtesting.make_node(name="warming-up", labels=labels,
                                  allocatable=dict(nodes[0].status.allocatable))
        jnodes = jnodes + _state_nodes(jcluster, [node], [])
        nodes.append(node)
    jsearch = jconsolidation.TPUConsolidationSearch(env.provider, env.kube.list_provisioners())
    tbound = [_to_port(p) for p in jbound]
    tnodes = _state_nodes(tcluster, [_to_port(n) for n in nodes], tbound)
    tprovs = [_to_port(p) for p in env.kube.list_provisioners()]
    tsearch = tconsolidation.CudaConsolidationSearch(
        tfake.FakeCloudProvider(tfake.instance_types(n_types)), tprovs, device="cpu")
    tcands = _candidates(tdep, jcands, tnodes, tbound, _catalogs(tsearch.solver),
                         {p.name: p for p in tsearch.solver.provisioners})
    return Problem(jsearch, jnodes, jbound, jcands, tsearch, tnodes, tbound, tcands)


# -- the JAX package's sweep on one problem ------------------------------------


def sweep_inputs(problem: Problem):
    """``TPUConsolidationSearch.compute_command``'s set-up
    (karpenter_core_tpu/solver/consolidation.py:126-163): (snapshot, ex_state,
    ex_static, rank, ex_cls_count), the snapshot's counts the base ones."""
    jsearch, state_nodes, bound_pods, candidates = problem.j
    all_pods = [p for c in candidates for p in c.pods]
    snapshot = jsearch.solver.encode(all_pods, state_nodes, bound_pods)
    ex_state, ex_static = jsearch.solver.encode_existing(snapshot, state_nodes, bound_pods)
    node_index = {n.node.name: e for e, n in enumerate(state_nodes)}
    candidate_names = {c.node.name for c in candidates}
    E = max(len(state_nodes), 1)
    C = len(snapshot.classes)
    ex_cls_count = np.zeros((C, E), dtype=np.int32)
    base_counts = np.zeros(C, dtype=np.int32)
    for c, cls in enumerate(snapshot.classes):
        if cls.is_ladder_variant:
            continue
        for pod in cls.pods:
            if pod.spec.node_name and pod.spec.node_name in candidate_names:
                ex_cls_count[c, node_index[pod.spec.node_name]] += 1
            else:
                base_counts[c] += 1
    snapshot.cls_count = base_counts
    rank = np.full(E, 1 << 30, dtype=np.int32)
    for i, candidate in enumerate(candidates):
        rank[node_index[candidate.node.name]] = i
    return snapshot, ex_state, ex_static, rank, ex_cls_count


def _jax_sweep(problem: Problem, sizes):
    """``sweep_inputs``, then ``run_sweep`` over ``sizes`` on the
    single-device program."""
    out = jcons.run_sweep(*sweep_inputs(problem), np.asarray(sizes, dtype=np.int32),
                          mesh_axes=None)
    return jax.device_get(out)


def _port_sweep(problem: Problem, sizes):
    tsearch, state_nodes, bound_pods, candidates = problem.t
    _, prep = tsearch.prepare(candidates, [], state_nodes, bound_pods)
    return tcons.SweepOutputs(*tconsolidation.fetch_planes(tcons.sweep(prep, sizes)))


def _assert_sweeps_equal(ref, got, label):
    assert tuple(ref._fields) == tuple(got._fields)
    for name in ref._fields:
        a, b = np.asarray(getattr(ref, name)), np.asarray(getattr(got, name))
        assert a.dtype == b.dtype and a.shape == b.shape, f"{label}: {name} {a.dtype}{a.shape}"
        if name == "new_cost":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=f"{label}: {name}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{label}: {name}")


def _summary(cmd):
    """A command in package-neutral terms, replacements in full."""
    zone_key, ct_key = jlabels.LABEL_TOPOLOGY_ZONE, jlabels.LABEL_CAPACITY_TYPE
    return (
        cmd.action.value,
        [n.metadata.name for n in cmd.nodes_to_remove],
        [(r.provisioner_name, [it.name for it in r.instance_type_options],
          sorted(r.requirements.get(zone_key).values), sorted(r.requirements.get(ct_key).values),
          dict(r.requests), sorted(p.uid for p in r.pods)) for r in cmd.replacement_nodes],
    )


# -- the search over prefix sizes -----------------------------------------


@pytest.mark.parametrize("n,boundary", [(40, 17), (500, 123), (300_000, 123_456),
                                        (100_000, 0), (100_000, 100_000)])
def test_search_largest_prefix_matches_reference(n, boundary):
    """tests/test_tpu_consolidation.py:140-185's cases: the same answer from
    the same passes over the same prefix sizes."""
    def run(search):
        passes = []

        def evaluate(sizes):
            passes.append(np.asarray(sizes).tolist())
            valid = [int(k) for k in sizes if k <= boundary]
            return (("cmd", max(valid)), max(valid)) if valid else (None, 0)

        return search(n, evaluate), passes

    got, ref = run(tconsolidation.search_largest_prefix), run(jconsolidation.search_largest_prefix)
    assert got == ref
    assert all(len(p) <= tconsolidation.MAX_LANES for p in got[1])
    assert got[0] == (("cmd", boundary) if boundary else None)


# -- node_prices and the lane finish ---------------------------------------


def _price_planes(rng, lanes, n_slots=16, n_it=40):
    viable = rng.random((lanes, n_slots, n_it)) < 0.2
    viable[:, 1::4] = False  # no viable type: +inf
    zone = rng.random((lanes, n_slots, 3)) < 0.6
    ct = rng.random((lanes, n_slots, 2)) < 0.6
    ct[:, 2::5] = False  # no allowed capacity type: +inf
    open_ = rng.random((lanes, n_slots)) < 0.8  # closed slots: 0
    pod_count = rng.integers(0, 3, (lanes, n_slots)).astype(np.int32)  # empty slots: 0
    price = (rng.integers(1, 5000, (n_it, 3, 2)) * 1e-3).astype(np.float32)
    price[rng.random(price.shape) < 0.3] = np.inf  # unavailable offerings
    return viable, zone, ct, open_, pod_count, price


class _State:
    def __init__(self, viable, zone, ct, open_, pod_count):
        self.viable, self.zone, self.ct, self.open_, self.pod_count = (
            viable, zone, ct, open_, pod_count)


@pytest.mark.parametrize("seed", range(4))
def test_node_prices_matches_reference(seed):
    viable, zone, ct, open_, pod_count, price = _price_planes(np.random.default_rng(seed), 1)
    planes = [a[0] for a in (viable, zone, ct, open_, pod_count)]
    ref = np.asarray(jsolve.node_prices(_State(*map(jnp.asarray, planes)), jnp.asarray(price)))
    got = k89.slot_prices_plain(*map(torch.as_tensor, planes), torch.as_tensor(price))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.isinf(ref).any() and (ref == 0).any() and (np.isfinite(ref) & (ref > 0)).any()


@pytest.mark.parametrize("seed", range(4))
def test_lane_finish_twin_matches_reference(seed):
    """K9's twin against ``one_prefix``'s finish (consolidate.py:83-100)
    under vmap: prices and failures exact, the cost to rtol 1e-6."""
    rng = np.random.default_rng(100 + seed)
    lanes, n_cls, n_ex = 6, 5, 37
    viable, zone, ct, open_, pod_count, price = _price_planes(rng, lanes)
    failed = rng.integers(0, 4, (lanes, n_cls)).astype(np.int32)
    assign = np.where(rng.random((lanes, n_cls, n_ex)) < 0.15,
                      rng.integers(1, 3, (lanes, n_cls, n_ex)), 0).astype(np.int32)
    init = rng.random(n_ex) < 0.9
    assign[::2][:, :, ~init] = 0  # even lanes use no uninitialized node

    def finish(v, z, c, o, pc, f, a):
        prices = jsolve.node_prices(_State(v, z, c, o, pc), jnp.asarray(price))
        cost = jnp.sum(jnp.where(jnp.isfinite(prices), prices, 0.0))
        return prices, cost, jnp.sum(f), jnp.any((a > 0) & ~jnp.asarray(init)[None, :])

    ref = jax.device_get(jax.vmap(finish)(
        *map(jnp.asarray, (viable, zone, ct, open_, pod_count, failed, assign))))
    got = k89.lane_finish(*map(torch.as_tensor, (viable, zone, ct, open_, pod_count, failed,
                                                  assign, init, price)))
    np.testing.assert_array_equal(got[0].numpy(), ref[0])
    np.testing.assert_allclose(got[1].numpy(), ref[1], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[2].numpy(), ref[2])
    np.testing.assert_array_equal(got[3].numpy(), ref[3])
    assert got[2].dtype == torch.int32 and not got[3][::2].any() and got[3].any()


# -- the lane set-up -------------------------------------------------------


@pytest.mark.parametrize("padded", (False, True))
@pytest.mark.parametrize("seed", range(3))
def test_sweep_lanes_twin_matches_reference(seed, padded):
    """K8's twin against ``one_prefix``'s set-up (consolidate.py:69-78)
    under vmap; with ``padded``, the port's planes carry the padding of
    ``prepare_sweep`` (rank 1 << 30, zero counts, closed rows) beyond E."""
    rng = np.random.default_rng(seed)
    n_ex, n_cls, lanes = 45, 7, 9
    n_cand = 30
    rank = np.full(n_ex, 1 << 30, np.int32)
    rank[rng.permutation(n_ex)[:n_cand]] = np.arange(n_cand, dtype=np.int32)
    open_ = rng.random(n_ex) < 0.9
    base = rng.integers(0, 50, n_cls).astype(np.int32)
    counts = rng.integers(0, 6, (n_cls, n_ex)).astype(np.int32)
    sizes = np.unique(rng.integers(1, n_cand + 1, lanes)).astype(np.int32)

    def one(k):
        subset = jnp.asarray(rank) < k
        lane_open = jnp.asarray(open_) & ~subset
        displaced = jnp.sum(jnp.asarray(counts) * subset[None, :].astype(jnp.int32), axis=-1)
        return lane_open, jnp.asarray(base) + displaced

    ref_open, ref_count = jax.device_get(jax.vmap(one)(jnp.asarray(sizes)))
    e_pad = tsolve.bucket(n_ex, floor=8) if padded else n_ex
    pad = e_pad - n_ex
    args = (np.concatenate([rank, np.full(pad, tcons.NOT_CANDIDATE, np.int32)]),
            np.concatenate([open_, np.zeros(pad, bool)]), base,
            np.concatenate([counts, np.zeros((n_cls, pad), np.int32)], axis=1), sizes)
    got_open, got_count = k89.sweep_lanes(*map(torch.as_tensor, args))
    assert got_count.dtype == torch.int32 and got_open.shape == (len(sizes), e_pad)
    np.testing.assert_array_equal(got_open.numpy()[:, :n_ex], ref_open)
    assert not got_open.numpy()[:, n_ex:].any()
    np.testing.assert_array_equal(got_count.numpy(), ref_count)


# -- the sweep, leaf for leaf ------------------------------------------------


@pytest.mark.parametrize("seed", (3, 11))
def test_sweep_matches_reference_on_build_cluster(seed):
    """build_cluster(60, 50, 5, 0.6): every prefix size, one lane each."""
    problem = workload_problem(60, 50, seed)
    sizes = np.arange(1, 61, dtype=np.int32)
    ref, got = _jax_sweep(problem, sizes), _port_sweep(problem, sizes)
    _assert_sweeps_equal(ref, got, f"build_cluster seed {seed}")
    # the lanes span both outcomes: prefixes that fit and prefixes that fail
    assert (got.failed == 0).any() and (got.failed > 0).any()


@pytest.mark.parametrize("name", FIXTURES)
def test_sweep_matches_reference_on_fixtures(name):
    problem = fixture_problem(name)
    n = len(problem.t[3])
    sizes = np.arange(1, n + 1, dtype=np.int32)
    ref, got = _jax_sweep(problem, sizes), _port_sweep(problem, sizes)
    _assert_sweeps_equal(ref, got, name)
    if name == "replace":
        assert got.n_new[-1] == 1 and got.new_cost[-1] > 0
    if name == "uninitialized":
        assert got.used_uninitialized.any() and not got.used_uninitialized.all()
    # and the commands the two searches derive from them
    tsearch, tnodes, tbound, tcands = problem.t
    jsearch, jnodes, jbound, jcands = problem.j
    assert _summary(tsearch.compute_command(tcands, [], tnodes, tbound)) == _summary(
        jsearch.compute_command(jcands, [], jnodes, jbound))


# -- lane independence -------------------------------------------------------


def test_lanes_are_independent():
    """Lane s of a sweep equals a one-lane sweep of size k[s], whatever the
    order of the lanes: no lane's solve writes into the shared planes."""
    problem = workload_problem(60, 50, 3)
    tsearch, tnodes, tbound, tcands = problem.t
    _, prep = tsearch.prepare(tcands, [], tnodes, tbound)
    sizes = np.array([60, 1, 17, 33, 5], dtype=np.int32)
    lanes = [tcons.SweepOutputs(*tconsolidation.fetch_planes(tcons.sweep(prep, order)))
             for order in (sizes, sizes[::-1].copy())]
    for s, k in enumerate(sizes.tolist()):
        alone = tcons.SweepOutputs(*tconsolidation.fetch_planes(tcons.sweep(prep, [k])))
        for name in tcons.SweepOutputs._fields:
            want = getattr(alone, name)[0]
            np.testing.assert_array_equal(getattr(lanes[0], name)[s], want, err_msg=name)
            np.testing.assert_array_equal(getattr(lanes[1], name)[len(sizes) - 1 - s], want,
                                          err_msg=name)


# -- the whole search -----------------------------------------------------


def test_compute_command_matches_reference():
    """build_cluster(200, 100, 5, 0.6, 2024), every node a candidate: the
    same action, removed nodes in order and replacements."""
    problem = workload_problem(200, 100, 2024)
    tsearch, tnodes, tbound, tcands = problem.t
    jsearch, jnodes, jbound, jcands = problem.j
    got = tsearch.compute_command(tcands, [], tnodes, tbound)
    ref = jsearch.compute_command(jcands, [], jnodes, jbound)
    assert _summary(got) == _summary(ref)
    assert got.action == tdep.Action.DELETE and len(got.nodes_to_remove) == 56
    assert [len(sizes) for sizes, _ in tsearch.passes] == [64, 2]
    np.testing.assert_array_equal(tsearch._candidate_price_cumsum(tcands),
                                  jsearch._candidate_price_cumsum(jcands))


def test_mid_size_command_matches_chip_smoke_pin():
    """The mid-size consolidation that chip_smoke.py runs on the card
    (build_cluster(1000, 100, 5, 0.6, 2024), every node a candidate): both
    packages give the command it pins."""
    smoke = _chip_smoke()
    problem = workload_problem(smoke.MID_NODES, smoke.MID_TYPES, smoke.CLUSTER_SEED)
    tsearch, tnodes, tbound, tcands = problem.t
    jsearch, jnodes, jbound, jcands = problem.j
    got = tsearch.compute_command(tcands, [], tnodes, tbound)
    ref = jsearch.compute_command(jcands, [], jnodes, jbound)
    assert smoke.command_summary(got) == smoke.MID_CONSOLIDATION
    assert smoke.command_summary(ref) == smoke.MID_CONSOLIDATION
    assert _summary(got) == _summary(ref)


# -- the price and cost rules -----------------------------------------------------


class _Clock:
    def __init__(self, now):
        self._now = now

    def now(self):
        return self._now


@pytest.mark.parametrize("seed", range(3))
def test_deprovisioning_rules_match_reference(seed):
    """Eviction and disruption costs, the lifetime share, the worst launch
    price and both price filters, on the same seeded objects in each
    package."""
    rng = np.random.default_rng(seed)
    pods = [dict(annotations=({"controller.kubernetes.io/pod-deletion-cost": str(v)}
                              if v is not None else None),
                 priority=p)
            for v, p in zip(rng.choice([None, -2**30, 5, 2**31, 1e12], 6).tolist(),
                            rng.choice([None, -10**9, 0, 7, 10**9], 6).tolist())]
    pods.append(dict(annotations={"controller.kubernetes.io/pod-deletion-cost": "not-a-number"}))
    tpods = [ttesting.make_pod(**kw) for kw in pods]
    jpods = [jtesting.make_pod(**kw) for kw in pods]
    assert [tdep.get_pod_eviction_cost(p) for p in tpods] == [
        jdep.get_pod_eviction_cost(p) for p in jpods]
    assert tdep.disruption_cost(tpods) == jdep.disruption_cost(jpods)

    ttl = int(rng.integers(50, 500))
    created = float(rng.integers(0, 400))
    for ttl_s in (None, ttl):
        tprov = ttesting.make_provisioner(ttl_seconds_until_expired=ttl_s)
        jprov = jtesting.make_provisioner(ttl_seconds_until_expired=ttl_s)
        tnode = ttesting.make_node(creation_timestamp=created)
        jnode = jtesting.make_node(creation_timestamp=created)
        assert tdep.lifetime_remaining(tnode, tprov, _Clock(450.0)) == (
            jdep.lifetime_remaining(jnode, jprov, _Clock(450.0)))

    types_t, types_j = tfake.instance_types(12), jfake.instance_types(12)
    zones = ["test-zone-1", "test-zone-2", "test-zone-3"]
    for _ in range(4):
        picked_z = sorted(rng.choice(zones, int(rng.integers(1, 4)), replace=False).tolist())
        picked_ct = sorted(rng.choice(["spot", "on-demand"], int(rng.integers(1, 3)),
                                      replace=False).tolist())
        reqs = []
        for sched, obj in ((tsched, tobj), (jsched, jobj)):
            reqs.append(sched.Requirements(
                sched.Requirement(jlabels.LABEL_TOPOLOGY_ZONE, obj.OP_IN, picked_z),
                sched.Requirement(jlabels.LABEL_CAPACITY_TYPE, obj.OP_IN, picked_ct)))
        price = float(rng.uniform(0.05, 2.0))
        assert [tdep.worst_launch_price(it.offerings.available(), reqs[0]) for it in types_t] == [
            jdep.worst_launch_price(it.offerings.available(), reqs[1]) for it in types_j]
        assert [it.name for it in tdep.filter_by_price(types_t, reqs[0], price)] == [
            it.name for it in jdep.filter_by_price(types_j, reqs[1], price)]


# -- the port's own rules ----------------------------------------------------------


def test_workload_candidates_follow_candidate_nodes():
    """consolidation_candidates: every eligible node, sorted by disruption
    cost with ties in node order; a node that is not initialized, or whose
    provisioner or type is unknown, is no candidate."""
    nodes, bound = workloads.build_cluster(30, 50, 5, 0.6, 7)
    cands = workloads.consolidation_candidates(nodes, bound, 50, 5)
    assert [c.node.name for c in cands] == [
        n.node.name for n in sorted(
            nodes, key=lambda n: sum(p.spec.node_name == n.node.name for p in bound))]
    assert sum(len(c.pods) for c in cands) == len(bound)
    del nodes[0].node.metadata.labels[jlabels.LABEL_NODE_INITIALIZED]
    nodes[1].node.metadata.labels[jlabels.PROVISIONER_NAME_LABEL_KEY] = "retired"
    nodes[2].node.metadata.labels[jlabels.LABEL_INSTANCE_TYPE_STABLE] = "no-such-type"
    left = {c.node.name for c in workloads.consolidation_candidates(nodes, bound, 50, 5)}
    assert left == {n.node.name for n in nodes[3:]}


def test_search_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    provider, provisioners = workloads.build_provider(4, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconsolidation.CudaConsolidationSearch(provider, provisioners)


def test_wrappers_count_no_launch_for_cpu_tensors():
    before = (k89.lanes_launches, k89.finish_launches)
    rank = torch.tensor([0, 1, 1 << 30], dtype=torch.int32)
    lane_open, count = k89.sweep_lanes(rank, torch.ones(3, dtype=torch.bool),
                                       torch.zeros(1, dtype=torch.int32),
                                       torch.ones((1, 3), dtype=torch.int32),
                                       torch.tensor([1, 2], dtype=torch.int32))
    assert lane_open.tolist() == [[False, True, True], [False, False, True]]
    assert count.tolist() == [[1], [2]]
    assert (k89.lanes_launches, k89.finish_launches) == before


def test_empty_problem_needs_no_sweep():
    """No pods anywhere: every candidate goes, without a simulation, as in
    the JAX package (whose encode takes no empty pod list)."""
    problem = fixture_problem("empty")
    tsearch, tnodes, tbound, tcands = problem.t
    jsearch, jnodes, jbound, jcands = problem.j
    cmd = tsearch.compute_command(tcands, [], tnodes, tbound)
    assert _summary(cmd) == _summary(jsearch.compute_command(jcands, [], jnodes, jbound))
    assert cmd.action == tdep.Action.DELETE and len(cmd.nodes_to_remove) == 2
    assert tsearch.passes == [] and tsearch.compute_command([], [], tnodes, tbound).action == (
        tdep.Action.DO_NOTHING)
