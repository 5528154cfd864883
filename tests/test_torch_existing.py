"""The port's existing-node path held against the JAX package's, on the CPU.

Three levels, each with no tolerance (ints and bools exact, f32 bit for bit):

- the host half: ``CudaSolver.encode_existing`` plus ``ops.solve.pad_planes``
  against ``TPUSolver.encode_existing`` plus the reference's ``pad_planes``,
  plane for plane, and the solve on those planes leaf for leaf, on small
  clusters built identically in each package (each package's ``StateNode``
  filled by ``update_for_pod``): CSI attach limits through a duck-typed PVC
  lookup, host ports, taints and a tolerating class, bound pods owning zonal
  and hostname anti-affinity terms, a zone-less node, an uninitialized node,
  a node of a provisioner that no longer exists;
- the whole path: ``CudaSolver(device="cpu").solve(pods, state_nodes,
  bound_pods)`` against ``TPUSolver.solve`` on ``testing.workloads.
  build_cluster`` with 700 pending pods of the headline mix, the counts of
  the mid-size solve that chip_smoke.py pins on the card, and the three
  spread-residual cases of tests/test_spread_residual.py, which drive the
  finite-capacity rounds of the zone-spread quota (K7's loop);
- K7's twin, the quota rounds, against a transcription of the reference's
  loop (karpenter_core_tpu/ops/solve.py:1440-1475) under hypothesis, with
  finite zone caps;
- K6's fused entry point (``kernels.existing.existing_mask_fill``: the mask,
  the priority fill and its sum) and the commit after it, through the
  port's ``_phase_existing``, against the reference's ``_phase_existing``
  (:624) on random planes, tenant by tenant: assigned, placed and every
  leaf of the committed state.
"""

import dataclasses
import importlib.util
import pathlib
import random
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
import torch_history

import karpenter_core_tpu.apis.labels as jlabels
import karpenter_core_tpu.apis.objects as jobj
import karpenter_core_tpu.cloudprovider.fake as jfake
import karpenter_core_tpu.state.cluster as jcluster
import karpenter_core_tpu.testing as jtesting
import karpenter_core_tpu_torch.apis.labels as tlabels
import karpenter_core_tpu_torch.apis.objects as tobj
import karpenter_core_tpu_torch.cloudprovider.fake as tfake
import karpenter_core_tpu_torch.state.cluster as tcluster
import karpenter_core_tpu_torch.testing as ttesting
from karpenter_core_tpu.ops import solve as jsolve
from karpenter_core_tpu.solver.tpu import TPUSolver
from karpenter_core_tpu.ops import masks as jmasks
from karpenter_core_tpu_torch.kernels import commit as k23
from karpenter_core_tpu_torch.kernels import existing as k56
from karpenter_core_tpu_torch.kernels import reqmerge as k3
from karpenter_core_tpu_torch.kernels import spread as k7
from karpenter_core_tpu_torch.ops import masks as tmasks
from karpenter_core_tpu_torch.ops import solve as tsolve
from karpenter_core_tpu_torch.solver.cuda import CudaSolver
from karpenter_core_tpu_torch.testing import workloads

# both packages' slot and feature histories start empty for this module and
# are put back after it (tests/torch_history.py)
isolated_history = torch_history.isolated_history


JAX_PKG = dict(obj=jobj, labels=jlabels, fake=jfake, testing=jtesting, cluster=jcluster)
PORT_PKG = dict(obj=tobj, labels=tlabels, fake=tfake, testing=ttesting, cluster=tcluster)
ZONES = ("test-zone-1", "test-zone-2", "test-zone-3")
CSI_DRIVER = "ebs.csi.example.com"


# -- one seeded cluster description, built in either package ------------------


class _Kube:
    """A duck-typed volume lookup: claims named ``pv-*`` are bound to a
    persistent volume, the rest name a storage class; every one resolves to
    the same CSI driver."""

    def __init__(self, obj):
        self.obj = obj

    def get_persistent_volume_claim(self, namespace, name):
        spec = (self.obj.PersistentVolumeClaimSpec(volume_name=f"vol-{name}")
                if name.startswith("pv-")
                else self.obj.PersistentVolumeClaimSpec(storage_class_name="csi-fast"))
        return self.obj.PersistentVolumeClaim(spec=spec)

    def get_persistent_volume(self, name):
        return self.obj.PersistentVolume(spec=self.obj.PersistentVolumeSpec(csi_driver=CSI_DRIVER))

    def get_storage_class(self, name):
        return self.obj.StorageClass(provisioner=CSI_DRIVER)


CASES = ("volumes", "host_ports", "taints", "anti_affinity", "zoneless", "uninitialized",
         "unknown_provisioner")


def _scenario(pkg, case, seed):
    """(state_nodes, bound_pods, pending_pods, kube, provisioners) of one
    case, drawn identically in either package."""
    obj, lab, t = pkg["obj"], pkg["labels"], pkg["testing"]
    rng = random.Random(1000 * seed + CASES.index(case))
    kube = _Kube(obj)
    zone_key, host_key = lab.LABEL_TOPOLOGY_ZONE, lab.LABEL_HOSTNAME
    dedicated = obj.Taint(key="dedicated", value="gpu", effect="NoSchedule")
    state_nodes, bound = [], []
    for i in range(6):
        cpu = rng.choice((4, 8, 16))
        labels = {
            lab.PROVISIONER_NAME_LABEL_KEY: rng.choice(("default", "spare")),
            lab.LABEL_INSTANCE_TYPE_STABLE: f"fake-it-{cpu - 1}",
            zone_key: ZONES[i % 3],
            lab.LABEL_CAPACITY_TYPE: rng.choice(("spot", "on-demand")),
            lab.LABEL_NODE_INITIALIZED: "true",
        }
        taints = []
        if case == "zoneless" and i in (0, 4):
            del labels[zone_key]
            if i == 4:
                del labels[lab.LABEL_CAPACITY_TYPE]
        if case == "uninitialized" and i == 1:
            del labels[lab.LABEL_NODE_INITIALIZED]
        if case == "unknown_provisioner" and i == 2:
            labels[lab.PROVISIONER_NAME_LABEL_KEY] = "retired"
        if case == "taints" and i % 2 == 0:
            taints = [dedicated]
        node = t.make_node(name=f"node-{i}", labels=labels, taints=taints,
                           allocatable={"cpu": cpu, "memory": f"{2 * cpu}Gi", "pods": 110})
        sn = pkg["cluster"].StateNode(node, kube if case == "volumes" else None)
        if case == "uninitialized" and i == 1:
            sn.inflight_allocatable = {"cpu": 2.0}
        if case == "volumes":
            sn.volume_limits()[CSI_DRIVER] = rng.randint(1, 4)
        for j in range(rng.randint(0, 4)):
            kw = dict(name=f"bound-{i}-{j}", node_name=node.name,
                      labels={"app": rng.choice(("web", "db", "cache"))},
                      requests={"cpu": rng.choice(("250m", "500m", "1"))})
            if case == "anti_affinity" and rng.random() < 0.5:
                kw["pod_anti_affinity"] = [obj.PodAffinityTerm(
                    topology_key=rng.choice((zone_key, host_key)),
                    label_selector=obj.LabelSelector(match_labels={"app": "web"}))]
            if case == "host_ports" and rng.random() < 0.5:
                kw["host_ports"] = [rng.choice((8080, 9090))]
            if case == "volumes" and rng.random() < 0.6:
                kw["pvcs"] = [f"{rng.choice(('pv', 'sc'))}-bound-{i}-{j}"]
            pod = t.make_pod(**kw)
            sn.update_for_pod(pod)
            bound.append(pod)
        state_nodes.append(sn)

    def spread(app, key):
        return [obj.TopologySpreadConstraint(
            max_skew=1, topology_key=key,
            label_selector=obj.LabelSelector(match_labels={"app": app}))]

    groups = [
        dict(labels={"app": "plain"}, requests={"cpu": "500m"}),
        dict(labels={"app": "web"}, requests={"cpu": "250m"},
             topology_spread=spread("web", zone_key)),
        dict(labels={"app": "hs"}, requests={"cpu": "250m"},
             topology_spread=spread("hs", host_key)),
        dict(labels={"app": "db"}, requests={"cpu": "1"}, pod_affinity=[obj.PodAffinityTerm(
            topology_key=zone_key, label_selector=obj.LabelSelector(match_labels={"app": "db"}))]),
    ]
    if case == "taints":
        groups.append(dict(labels={"app": "gpu"}, requests={"cpu": "500m"}, tolerations=[
            obj.Toleration(key="dedicated", value="gpu", effect="NoSchedule")]))
    if case == "host_ports":
        groups.append(dict(labels={"app": "ports"}, requests={"cpu": "250m"}, host_ports=[8080]))
    if case == "anti_affinity":
        groups.append(dict(labels={"app": "web"}, requests={"cpu": "500m"}))
    pending = []
    for g, kw in enumerate(groups):
        for j in range(rng.randint(2, 9)):
            pending.append(t.make_pod(name=f"pending-{g}-{j}", **kw))
    if case == "volumes":
        # a class sharing one claim set, and a class of one claim per pod
        for j in range(rng.randint(2, 6)):
            pending.append(t.make_pod(name=f"shared-{j}", labels={"app": "shared"},
                                      requests={"cpu": "250m"}, pvcs=["sc-shared"]))
        for j in range(rng.randint(2, 6)):
            pending.append(t.make_pod(name=f"perpod-{j}", labels={"app": "perpod"},
                                      requests={"cpu": "250m"}, pvcs=[f"pv-perpod-{j}"]))
    provisioners = [t.make_provisioner(name="default", weight=2),
                    t.make_provisioner(name="spare", weight=1)]
    return state_nodes, bound, pending, (kube if case == "volumes" else None), provisioners


def _solvers(case, seed):
    jsn, jbound, jpods, jkube, jprovs = _scenario(JAX_PKG, case, seed)
    tsn, tbound, tpods, tkube, tprovs = _scenario(PORT_PKG, case, seed)
    js = TPUSolver(jfake.FakeCloudProvider(jfake.instance_types(16)), jprovs, kube_client=jkube)
    ts = CudaSolver(tfake.FakeCloudProvider(tfake.instance_types(16)), tprovs,
                    kube_client=tkube, device="cpu")
    return (js, jsn, jbound, jpods), (ts, tsn, tbound, tpods)


def _np(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _assert_tuple_equal(ref, got, label):
    assert ref._fields == got._fields, label
    for f in ref._fields:
        a, b = getattr(ref, f), getattr(got, f)
        if hasattr(a, "_fields"):
            _assert_tuple_equal(a, b, f"{label}.{f}")
            continue
        a, b = _np(a), _np(b)
        assert a.dtype == b.dtype, f"{label}.{f}: dtype {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{label}.{f}")


def _leaves(out):
    d = {"assign": out.assign, "assign_existing": out.assign_existing, "failed": out.failed,
         "spread_suspect": out.spread_suspect, "remaining": out.remaining}
    for group, tup in (("state", out.state), ("ex", out.ex_state), ("topo", out.topo)):
        for f in tup._fields:
            d[f"{group}.{f}"] = getattr(tup, f)
    return {k: _np(v) for k, v in d.items()}


def _assert_leaves_equal(ref, got, label):
    a, b = _leaves(ref), _leaves(got)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, f"{label}: {k} dtype {a[k].dtype} vs {b[k].dtype}"
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{label}: {k}")


def _by_name(results):
    """A decode result in package-neutral terms: pod names per node."""
    return dict(
        existing={k: sorted(p.name for p in v) for k, v in results.existing_assignments.items()},
        zones=dict(results.existing_committed_zones),
        new=[(n.provisioner_name, sorted(p.name for p in n.pods), list(n.instance_type_names),
              list(n.zones), list(n.capacity_types)) for n in results.new_nodes],
        failed=sorted(p.name for p in results.failed_pods),
        residual=sorted(p.name for p in results.spread_residual_pods),
    )


# -- the host half ------------------------------------------------------------


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("case", CASES)
def test_encode_existing_and_padding_match_reference(case, seed):
    (js, jsn, jbound, jpods), (ts, tsn, tbound, tpods) = _solvers(case, seed)
    jsnap = js.encode(jpods, jsn, jbound)
    tsnap = ts.encode(tpods, tsn, tbound)
    assert tsnap.class_volumes == jsnap.class_volumes
    jex = js.encode_existing(jsnap, jsn, jbound)
    tex = ts.encode_existing(tsnap, tsn, tbound)
    for ref, got, label in zip(jex, tex, ("ExistingState", "ExistingStatic")):
        _assert_tuple_equal(ref, got, label)
    assert tuple(tsolve.features_with_existing(tsnap, tex[1])) == tuple(
        jsolve.features_with_existing(jsnap, jex[1]))
    jpad = jsolve.pad_planes(*jsolve.prepare_host(jsnap), *jex)
    tpad = tsolve.pad_planes(*tsolve.prepare_host(tsnap), *tex)
    for ref, got, label in zip(jpad, tpad, ("cls", "statics", "key_has_bounds",
                                             "ExistingState", "ExistingStatic")):
        if label == "key_has_bounds":
            assert tuple(ref) == tuple(got)
        else:
            _assert_tuple_equal(ref, got, f"padded {label}")
    # the padded nodes are closed, with an all-zone mask: the intake gives 0
    e_old = len(jsn)
    assert not np.asarray(tpad[3].open_)[e_old:].any()
    assert np.asarray(tpad[3].zone)[e_old:].all()
    if case == "volumes":
        assert (np.asarray(tex[1].vol_limit) < (1 << 30)).any()
        assert tsolve.features_with_existing(tsnap, tex[1]).volume_limits
    if case == "anti_affinity":
        assert np.asarray(tex[1].grp_node_owner).sum() > 0
    if case == "host_ports":
        assert np.asarray(tex[0].ports).any()
    if case == "taints":
        assert not np.asarray(tex[1].tol).all()


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("case", CASES)
def test_existing_solve_matches_reference(case, seed):
    """The solve on those planes: every SolveOutputs leaf, then the decode."""
    (js, jsn, jbound, jpods), (ts, tsn, tbound, tpods) = _solvers(case, seed)
    jsnap = js.encode(jpods, jsn, jbound)
    tsnap = ts.encode(tpods, tsn, tbound)
    jout = jax.device_get(js.run_prepared(js.prepare_encoded(jsnap, jsn, jbound)))
    tout = ts.run_prepared(ts.prepare_encoded(tsnap, tsn, tbound))
    _assert_leaves_equal(jout, tout, case)
    assert int(np.asarray(jout.state.n_next)) < np.asarray(jout.assign).shape[1]
    assert _by_name(ts.decode(tsnap, tout, tsn)) == _by_name(js.decode(jsnap, jout, jsn))


# -- the whole path -----------------------------------------------------------


def _to_jax(x):
    """A port API object rebuilt from the JAX package's classes of the same
    names (the two ``apis/objects.py`` share their dataclass layouts)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return getattr(jobj, type(x).__name__)(**{
            f.name: _to_jax(getattr(x, f.name)) for f in dataclasses.fields(x) if f.init})
    if isinstance(x, list):
        return [_to_jax(v) for v in x]
    if isinstance(x, dict):
        return {k: _to_jax(v) for k, v in x.items()}
    return x


def _reference_inputs(nodes, bound, pods, n_types):
    """The JAX package's solver, state nodes, bound pods and pending pods for
    a cluster and backlog built by ``testing.workloads``: the same objects
    (``_to_jax``), uids included, its StateNodes filled by update_for_pod."""
    jbound = [_to_jax(p) for p in bound]
    by_node = {}
    for p in jbound:
        by_node.setdefault(p.spec.node_name, []).append(p)
    jnodes = []
    for n in nodes:
        sn = jcluster.StateNode(_to_jax(n.node))
        for p in by_node.get(n.node.name, []):
            sn.update_for_pod(p)
        jnodes.append(sn)
    provs = [jtesting.make_provisioner(name=f"prov-{i}", weight=5 - i) for i in range(5)]
    js = TPUSolver(jfake.FakeCloudProvider(jfake.instance_types(n_types)), provs)
    return js, jnodes, jbound, [_to_jax(p) for p in pods]


@pytest.mark.parametrize("seed", (3, 11))
def test_solve_into_existing_cluster_matches_reference(seed):
    """build_cluster(60, 50, 5, 0.6) and 700 pending pods of the headline
    mix: ``CudaSolver.solve(pods, state_nodes, bound_pods)`` on the CPU
    against ``TPUSolver.solve``."""
    nodes, bound = workloads.build_cluster(60, 50, 5, 0.6, seed)
    solver, pods = workloads.build_inputs(700, 50, 5, device="cpu")
    res = solver.solve(pods, nodes, bound)

    js, jnodes, jbound, jpods = _reference_inputs(nodes, bound, pods, 50)
    jres = js.solve(jpods, jnodes, jbound)

    def by_uid(r):
        return (
            {k: sorted(p.uid for p in v) for k, v in r.existing_assignments.items()},
            dict(r.existing_committed_zones),
            [(n.provisioner_name, sorted(p.uid for p in n.pods), list(n.instance_type_names),
              list(n.zones)) for n in r.new_nodes],
            sorted(p.uid for p in r.failed_pods),
            sorted(p.uid for p in r.spread_residual_pods),
        )

    assert by_uid(res) == by_uid(jres)
    on_existing = sum(len(v) for v in res.existing_assignments.values())
    on_new = sum(len(n.pods) for n in res.new_nodes)
    assert on_existing > 0 and on_new > 0
    assert on_existing + on_new + len(res.failed_pods) + len(res.spread_residual_pods) == 700
    tainted = {n.node.name for n in nodes if n.node.spec.taints}
    assert tainted and not tainted & set(res.existing_assignments)
    # the f32 leaves too: the final existing-node usage, bit for bit
    jprep = js.prepare_encoded(js.encode(jpods, jnodes, jbound), jnodes, jbound)
    jout = jax.device_get(js.run_prepared(jprep))
    np.testing.assert_array_equal(np.asarray(jout.ex_state.used),
                                  solver.last_outputs.ex_state.used.numpy())
    alloc = np.asarray(jprep.ex_static.alloc)
    assert (solver.last_outputs.ex_state.used.numpy() <= alloc + 1e-4).all()



@pytest.mark.parametrize("seed", (3, 11))
def test_torch_existing_solve_non_binary_requests_match_reference(seed, monkeypatch):
    """The same prepared planes through both whole solves, with cpu and
    memory requests and the existing nodes' usage off binary fractions
    (requests x 1.1, usage + tenths): every leaf bit for bit.  The reference's
    jitted scan contracts the existing-node commit ``used + a * req`` into an
    FMA, so the port's K6 commit takes one too; a commit that rounds twice
    differs on these inputs."""
    nodes, bound = workloads.build_cluster(60, 50, 5, 0.6, seed)
    solver, pods = workloads.build_inputs(700, 50, 5, device="cpu")
    js, jnodes, jbound, jpods = _reference_inputs(nodes, bound, pods, 50)
    jprep = js.prepare_encoded(js.encode(jpods, jnodes, jbound), jnodes, jbound)
    tprep = solver.prepare_encoded(solver.encode(pods, nodes, bound), nodes, bound)
    rng = np.random.default_rng(seed)
    # the third column is the pod count: its request stays 1, as every class's
    requests = (np.asarray(jprep.cls.requests) * np.array([1.1, 1.1, 1.0], np.float32)
                ).astype(np.float32)
    used = np.asarray(jprep.ex_state.used)
    used = np.where(used > 0, used + rng.integers(0, 10, used.shape) * np.float32(0.1),
                    used).astype(np.float32)
    jprep = jprep._replace(cls=jprep.cls._replace(requests=jnp.asarray(requests)),
                           ex_state=jprep.ex_state._replace(used=jnp.asarray(used)))
    tprep = tprep._replace(cls=tprep.cls._replace(requests=torch.as_tensor(requests)),
                           ex_state=tprep.ex_state._replace(used=torch.as_tensor(used)))
    jout = jax.device_get(js.run_prepared(jprep))
    _assert_leaves_equal(jout, solver.run_prepared(tprep), f"seed {seed}")

    def rounded_twice(ex, *args):
        out = k56.existing_commit_plain(ex, *args)
        a, req = args[7], args[6]
        return out._replace(used=ex.used + a[:, None].to(torch.float32) * req[None, :])

    monkeypatch.setattr(k56, "existing_commit_twin", k56.batch.tenantwise(
        rounded_twice, lambda ex, *_: ex.used.dim() == 2))
    twice = solver.run_prepared(tprep).ex_state.used.numpy()
    assert (twice != np.asarray(jout.ex_state.used)).any()

@pytest.mark.parametrize("cpu,memory,seed", [(1.1, 1.1, 0), (0.9, 1.17, 3)])
def test_torch_slot_commit_non_binary_requests_match_reference(cpu, memory, seed, monkeypatch):
    """A cold solve of the headline mix with cpu and memory requests scaled
    off binary fractions and template daemon overheads in tenths, through
    both whole solves: every leaf bit for bit.  Pods of two classes share
    new slots, so a slot's usage is ``used + a * req`` over a usage that is
    not 0.  The reference's jitted scan contracts each slot commit into one
    FMA, and the port's slot commit (K23's twin, ``kernels.commit``) takes one
    too; on these inputs a commit that rounds twice gives other floats.  The first case tells the
    phases' open and fresh slots and the committal block's fresh slots
    apart from two roundings, the second the committal block's open slots."""
    solver, pods = workloads.build_inputs(700, 50, 5, device="cpu")
    js, jnodes, jbound, jpods = _reference_inputs([], [], pods, 50)
    jprep = js.prepare_encoded(js.encode(jpods, jnodes, jbound), jnodes, jbound)
    tprep = solver.prepare_encoded(solver.encode(pods, [], []), [], [])
    rng = np.random.default_rng(seed)
    # the third column is the pod count: its request stays 1, as every class's
    requests = (np.asarray(jprep.cls.requests) * np.array([cpu, memory, 1.0], np.float32)
                ).astype(np.float32)
    daemon = np.asarray(jprep.statics_arrays.tmpl_daemon).copy()
    daemon[:, :2] = rng.integers(1, 20, daemon[:, :2].shape) * np.float32(0.1)
    daemon[:, 1] *= np.float32(2**20)
    jprep = jprep._replace(
        cls=jprep.cls._replace(requests=jnp.asarray(requests)),
        statics_arrays=jprep.statics_arrays._replace(tmpl_daemon=jnp.asarray(daemon)))
    tprep = tprep._replace(
        cls=tprep.cls._replace(requests=torch.as_tensor(requests)),
        statics_arrays=tprep.statics_arrays._replace(tmpl_daemon=torch.as_tensor(daemon)))
    jout = jax.device_get(js.run_prepared(jprep))
    assert ((np.asarray(jout.assign) > 0).sum(axis=0) >= 2).any()  # shared slots
    _assert_leaves_equal(jout, solver.run_prepared(tprep), "slot commit")

    def rounded_twice(a, b, c):
        return a * b + c  # float32: the product rounded, then the sum

    monkeypatch.setattr(k23, "fma_f32", rounded_twice)
    twice = solver.run_prepared(tprep).state.used.numpy()
    assert (twice != np.asarray(jout.state.used)).any()


def _chip_smoke():
    """chip_smoke.py's module (its constants; nothing runs on import)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_mid_size_counts_match_chip_smoke_pin():
    """The mid-size existing-node solve that chip_smoke.py runs on the card
    (10,000 pods x 100 types into a 1,000-node cluster): both packages give
    the counts it pins, so the card's answer is held to the JAX package's."""
    smoke = _chip_smoke()
    nodes, bound = workloads.build_cluster(smoke.MID_NODES, smoke.MID_TYPES, 5, smoke.FILL,
                                           smoke.CLUSTER_SEED)
    solver, pods = workloads.build_inputs(smoke.MID_PODS, smoke.MID_TYPES, 5, device="cpu")
    assert smoke.path_counts(solver.solve(pods, nodes, bound)) == smoke.MID_EXPECTED
    js, jnodes, jbound, jpods = _reference_inputs(nodes, bound, pods, smoke.MID_TYPES)
    assert smoke.path_counts(js.solve(jpods, jnodes, jbound)) == smoke.MID_EXPECTED


# -- the spread-residual cases (tests/test_spread_residual.py :92, :118, :134) --


def _zoneless_node(pkg, name, cpu):
    """An owned, initialized node with NO zone label: its zone mask is
    all-ones, the shape whose intake the water-fill double-counts."""
    lab = pkg["labels"]
    its = pkg["fake"].FakeCloudProvider().get_instance_types(None)
    it = next(t for t in its if t.capacity.get("cpu", 0) >= cpu)
    return pkg["testing"].make_node(
        name=name,
        labels={
            lab.PROVISIONER_NAME_LABEL_KEY: "default",
            lab.LABEL_INSTANCE_TYPE_STABLE: it.name,
            lab.LABEL_CAPACITY_TYPE: lab.CAPACITY_TYPE_ON_DEMAND,
            lab.LABEL_NODE_INITIALIZED: "true",
        },
        allocatable={"cpu": cpu, "memory": "16Gi", "pods": 110},
    )


def _residual_solve(pkg, n_pods, with_node):
    obj, lab, t = pkg["obj"], pkg["labels"], pkg["testing"]
    prov = t.make_provisioner(name="default", requirements=[obj.NodeSelectorRequirement(
        lab.LABEL_TOPOLOGY_ZONE, obj.OP_IN, ["test-zone-1"])])
    pods = [t.make_pod(
        name=f"residual-{i}", labels={"app": "residual"}, requests={"cpu": "500m"},
        topology_spread=[obj.TopologySpreadConstraint(
            max_skew=1, topology_key=lab.LABEL_TOPOLOGY_ZONE,
            label_selector=obj.LabelSelector(match_labels={"app": "residual"}))],
    ) for i in range(n_pods)]
    nodes = [pkg["cluster"].StateNode(_zoneless_node(pkg, "fuzzy", 4.0))] if with_node else []
    provider = pkg["fake"].FakeCloudProvider()
    if pkg is PORT_PKG:
        solver = CudaSolver(provider, [prov], device="cpu")
    else:
        solver = TPUSolver(provider, [prov])
    return solver.solve(pods, nodes, [])


@pytest.mark.parametrize("case", ("unknown_zone_shortfall_flags_residual",
                                  "skew_bound_failure_is_not_residual",
                                  "committed_zone_reported_for_zoneless_node"))
def test_spread_residual_cases_match_reference(case):
    """Quota granted against a zone-ambiguous node's double-counted intake
    cannot all be realized once the node commits to one zone: the leftover
    is residual, not failed.  A genuine maxSkew bound (zones 2 and 3 serve
    nothing and hold nothing) fails pods instead.  And a zone-less node that
    took zone-restricted pods reports the zone it committed to."""
    n_pods, with_node = (5, False) if case == "skew_bound_failure_is_not_residual" else (12, True)
    got = _residual_solve(PORT_PKG, n_pods, with_node)
    assert _by_name(got) == _by_name(_residual_solve(JAX_PKG, n_pods, with_node))
    placed = sum(len(p) for p in got.existing_assignments.values()) + sum(
        len(n.pods) for n in got.new_nodes)
    if case == "unknown_zone_shortfall_flags_residual":
        assert placed + len(got.failed_pods) + len(got.spread_residual_pods) == n_pods
        assert got.spread_residual_pods and not got.failed_pods
    elif case == "skew_bound_failure_is_not_residual":
        assert placed == 1 and len(got.failed_pods) == 4
        assert not got.spread_residual_pods
    else:
        if got.existing_assignments.get("fuzzy"):
            assert got.existing_committed_zones.get("fuzzy") in ZONES


# -- K7's twin against the reference's quota rounds ----------------------------


UNLIMITED = 1 << 30


@jax.jit
def _jax_quota_rounds(counts_zs, allowed_zone, fillable, cap_pods_z, skew_zs, m, member_zs):
    """The reference's capped quota rounds, transcribed from
    karpenter_core_tpu/ops/solve.py:1440-1475 (inline in ``_class_step``
    there), around its own ``_water_fill``."""
    n_zones = counts_zs.shape[0]
    unreachable = allowed_zone & ~fillable
    bigi = jnp.int32(1 << 30)
    finite_cap = cap_pods_z < UNLIMITED
    quotas = jnp.zeros(n_zones, dtype=jnp.int32)
    sat = jnp.zeros(n_zones, dtype=bool)
    m_rem = m
    for _ in range(n_zones + 1):
        counts_now = counts_zs + quotas
        min_frozen = jnp.min(jnp.where(unreachable | sat, counts_now, bigi))
        skew_cap = jnp.clip(min_frozen + skew_zs - counts_now, 0, UNLIMITED)
        active = allowed_zone & fillable & ~sat
        cap_rem = jnp.clip(cap_pods_z - quotas, 0, UNLIMITED)
        lvl_sat = jnp.min(jnp.where(active & finite_cap, counts_now + cap_rem, bigi))
        q = jsolve._water_fill(counts_now, active, m_rem)
        q = jnp.minimum(q, jnp.clip(lvl_sat - counts_now, 0, UNLIMITED))
        q = jnp.minimum(q, jnp.minimum(skew_cap, cap_rem))
        q = jnp.where(active, q, 0)
        quotas = quotas + q
        m_rem = m_rem - jnp.sum(q)
        sat = sat | (active & finite_cap & (quotas >= cap_pods_z))
    quotas = jnp.where(member_zs, quotas, 0)
    counts_end = counts_zs + quotas
    min_frozen_end = jnp.min(jnp.where(unreachable | sat, counts_end, bigi))
    skew_headroom = (counts_end - min_frozen_end) < skew_zs
    cap_headroom = (cap_pods_z - quotas) > 0
    fill_residual = (m_rem > 0) & jnp.any(
        allowed_zone & fillable & ~sat & skew_headroom & cap_headroom)
    return quotas, sat, m_rem, fill_residual


def _zone_lists(n_zones, elements):
    return st.lists(elements, min_size=n_zones, max_size=n_zones)


# counts: small, or near 2^24, where the water-fill's float sums round (the
# reference sums in f32, in order, and contracts `idx * s - prefix` and
# `rem - floor * k` into FMAs)
_COUNT = st.one_of(st.integers(0, 40), st.integers(2**24 - 8, 2**24 + 8))


@pytest.mark.parametrize("n_zones", (1, 2, 3, 4, 8))
@settings(max_examples=80, deadline=None)
@given(data=st.data(), skew=st.one_of(st.integers(1, 5), st.just(UNLIMITED)),
       m=st.one_of(st.integers(0, 200), st.integers(2**24, 2**31 - 1)), member=st.booleans())
def test_spread_quota_rounds_match_reference(n_zones, data, skew, m, member):
    counts = data.draw(_zone_lists(n_zones, _COUNT))
    allowed = data.draw(_zone_lists(n_zones, st.booleans()))
    fillable = data.draw(_zone_lists(n_zones, st.booleans()))
    caps = data.draw(_zone_lists(n_zones, st.one_of(st.integers(0, 60), st.just(UNLIMITED))))
    args = (np.asarray(counts, np.int32), np.asarray(allowed), np.asarray(fillable),
            np.asarray(caps, np.int32), np.int32(skew), np.int32(m), np.bool_(member))
    ref = jax.device_get(_jax_quota_rounds(*args))
    got = k7.spread_quota(*(torch.as_tensor(np.asarray(a)) for a in args))
    for name, a, b in zip(("quotas", "sat", "m_rem", "fill_residual"), ref, got):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


@pytest.mark.parametrize("n_zones", (1, 2, 3, 4, 8, 16, 20, 32))
def test_spread_quota_large_counts_match_reference(n_zones):
    """Seeded rounds at counts near 2^24 (the water-fill's f32 sums round:
    the reference's order and FMAs decide them) and near 2^31 (the int32
    sums wrap), with finite and UNLIMITED caps, up to 32 zones (past 16 the
    reference's cumsum goes in blocks of 16)."""
    rng = np.random.default_rng(1000 + n_zones)
    for case in range(90):
        lo = (0, 2**24 - 8, 2**31 - 60)[case % 3]
        counts = rng.integers(lo, lo + (40 if lo == 0 else 16), n_zones)
        args = (counts.astype(np.int32), rng.random(n_zones) < 0.8, rng.random(n_zones) < 0.85,
                np.where(rng.random(n_zones) < 0.5, UNLIMITED,
                         rng.integers(0, 40, n_zones)).astype(np.int32),
                np.int32(rng.choice([1, 2, 5, UNLIMITED])),
                np.int32(rng.choice([0, 3, 17, 100, 2**24 + 3, 2**31 - 1])),
                np.bool_(rng.random() < 0.8))
        ref = jax.device_get(_jax_quota_rounds(*args))
        got = k7.spread_quota(*(torch.as_tensor(np.asarray(a)) for a in args))
        for name, a, b in zip(("quotas", "sat", "m_rem", "fill_residual"), ref, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f"{case} {name}")


# -- K6's fused mask and fill, with the commit, against _phase_existing ---------


V_PHASE = 40  # the phase planes' slots a key: two words, the "other" slot bit 7 of word 1
KHB_PHASE = (True, False, True, True)  # the keys that carry Gt/Lt bounds


def _phase_planes(rng, n, n_zones=3, k=4, words=2, n_res=3, n_ct=2, n_ports=4, n_csi=2,
                  negative_cap=False):
    """One tenant's random existing-node planes, class row and vectors and
    vocabulary for a phase, as numpy arrays."""
    assert tmasks.words_for(V_PHASE) == words

    def b(shape, p):
        return rng.random(shape) < p

    def i(shape, lo, hi):
        return rng.integers(lo, hi, shape).astype(np.int32)

    def f(shape):
        # tenths: `used + a * req` is inexact in f32, so an FMA and two
        # roundings differ on some elements; XLA's CPU code contracts it
        return (rng.integers(0, 64, shape) * np.float32(0.1)).astype(np.float32)

    def req(rows):
        # random words (the "other" slot on either side or both), bounds in
        # tenths on some keys
        shape = (rows, k)
        gt = np.where(b(shape, 0.5), -np.inf, f(shape)).astype(np.float32)
        lt = np.where(b(shape, 0.5), np.inf, f(shape) + np.float32(3.0)).astype(np.float32)
        return (i((rows, k, words), -2**31, 2**31 - 1), b(shape, 0.6), b(shape, 0.3), gt, lt)

    # cpu and memory in tenths; the third column is the pod count, whose
    # request is always 1 (at R = 3 XLA's CPU code rounds that column twice,
    # the others once: an FMA)
    requests = (f(n_res) + np.float32(0.1)).astype(np.float32)
    requests[2] = 1.0
    cap = np.where(b(n, 0.4), i(n, 1, 9), 0).astype(np.int32)
    if negative_cap:
        cap[rng.integers(0, n, 2)] = -3
    full = tmasks.full_words(V_PHASE)
    return dict(
        ex=(f((n, n_res)), *req(n), b((n, n_zones), 0.6), b((n, n_ct), 0.6), b((n, n_ports), 0.2),
            i((n, n_csi), 0, 5), i(n, 0, 50), b(n, 0.8)),
        cls=req(1), valid=(i((k, words), -2**31, 2**31 - 1) & full).astype(np.int32),
        vocab_ints=np.where(b((k, V_PHASE - 1), 0.7), f((k, V_PHASE - 1)),
                            np.inf).astype(np.float32),
        cap=cap, ct_ok=b((n, n_ct), 0.5), vol_add=i((n, n_csi), 0, 3),
        vol_per_pod=i(n_csi, 0, 3), cls_zone=b(n_zones, 0.8), requests=requests,
        cls_ports=b(n_ports, 0.4), restrict=b(n_zones, 0.8), extra=b(n, 0.7),
        quota=np.int32(rng.integers(0, 3 * n + 2)))


class _PhaseCls(NamedTuple):
    """The class vectors ``_phase_existing`` reads."""

    zone: object
    requests: object
    ports: object


_jax_phase_existing = jax.jit(jsolve._phase_existing, static_argnames=("single_node",))
_jax_add = jax.jit(jmasks.add, static_argnames=("v", "key_has_bounds"))


def _u32(a):
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _jax_ex(t):
    """The tenant's existing-node state, mask words as the reference's uint32."""
    return jsolve.ExistingState(*(jnp.asarray(_u32(a)) if j == 1 else jnp.asarray(a)
                                  for j, a in enumerate(t["ex"])))


def _jax_prep(t):
    """The reference's ExClassPrep of the tenant: the merged planes of every
    row, merged with the class row at the class's start."""
    ex = _jax_ex(t)
    cls = jmasks.ReqTensor(jnp.asarray(_u32(t["cls"][0])), *(jnp.asarray(a) for a in t["cls"][1:]))
    merged = _jax_add(jmasks.ReqTensor(ex.kmask, ex.kdef, ex.kneg, ex.kgt, ex.klt), cls,
                      jnp.asarray(_u32(t["valid"])), jnp.asarray(t["vocab_ints"]), v=V_PHASE,
                      key_has_bounds=KHB_PHASE)
    return jsolve.ExClassPrep(
        cap=jnp.asarray(t["cap"]), merged=merged, zone_full=None,
        ct_ok=jnp.asarray(t["ct_ok"]), vol_add=jnp.asarray(t["vol_add"]),
        vol_per_pod=jnp.asarray(t["vol_per_pod"]))


def _jax_phase(t, extra, single_node, ex=None, prep=None, quota=None, restrict=None):
    cls = _PhaseCls(jnp.asarray(t["cls_zone"]), jnp.asarray(t["requests"]),
                    jnp.asarray(t["cls_ports"]))
    out = _jax_phase_existing(
        _jax_ex(t) if ex is None else ex, _jax_prep(t) if prep is None else prep, cls,
        jnp.asarray(t["quota"] if quota is None else quota),
        jnp.asarray(t["restrict"] if restrict is None else restrict),
        extra_elig=jnp.asarray(t["extra"]) if extra else None, single_node=single_node)
    return jax.device_get(out)


def _port_phase_inputs(tenants):
    """The tenants' port state, ExClassPrep (the class row to merge with) and
    class vectors, stacked on the tenant axis."""
    def stacked(key, i=None):
        return torch.as_tensor(np.stack([t[key] if i is None else t[key][i] for t in tenants]))

    ex = tsolve.ExistingState(*(stacked("ex", i) for i in range(12)))
    prep = tsolve.ExClassPrep(
        cap=stacked("cap"),
        merge=k3.ClassMerge(tmasks.ReqTensor(*(stacked("cls", i) for i in range(5))),
                            stacked("valid"), stacked("vocab_ints"), V_PHASE, KHB_PHASE),
        zone_full=None, ct_ok=stacked("ct_ok"), vol_add=stacked("vol_add"),
        vol_per_pod=stacked("vol_per_pod"))
    cls = _PhaseCls(stacked("cls_zone"), stacked("requests"), stacked("cls_ports"))
    return ex, prep, cls, stacked


def _assert_ex_equal(got_ex, b_, want_ex):
    for name in jsolve.ExistingState._fields:
        a, w = _np(getattr(got_ex, name)[b_]), _np(getattr(want_ex, name))
        assert a.dtype == w.dtype, name
        np.testing.assert_array_equal(a, w, err_msg=name)


@pytest.mark.parametrize("use_kernels", (True, False))
@pytest.mark.parametrize("extra,single_node,negative_cap", [
    (False, False, False), (True, False, False), (False, True, False), (True, True, False),
    (True, False, True), (False, True, True)])
@pytest.mark.parametrize("n,n_b", [(1, 1), (37, 3), (300, 2)])
def test_torch_phase_existing_mask_fill_matches_reference(n, n_b, extra, single_node,
                                                          negative_cap, use_kernels):
    rng = np.random.default_rng(n * 31 + n_b + 7 * extra + 3 * single_node + negative_cap)
    tenants = [_phase_planes(rng, n, negative_cap=negative_cap) for _ in range(n_b)]
    if single_node and n > 1:
        tenants[0]["cap"][:] = 0  # no eligible row: the pin falls on row 0
    if n > 1:
        tenants[-1]["quota"] = np.int32(2**31 - 1)  # past every cap: the sums near the wrap

    ex, prep, cls, stacked = _port_phase_inputs(tenants)
    k = tsolve.KERNELS if use_kernels else tsolve.PLAIN
    got_ex, got_a, got_placed = tsolve._phase_existing(
        ex, prep, cls, stacked("quota"), stacked("restrict"), k,
        extra_elig=stacked("extra") if extra else None, single_node=single_node)
    for b_, t in enumerate(tenants):
        want_ex, want_a, want_placed = _jax_phase(t, extra, single_node)
        np.testing.assert_array_equal(got_a[b_].numpy(), np.asarray(want_a))
        assert got_placed.dtype == torch.int32
        assert int(got_placed[b_]) == int(want_placed)
        _assert_ex_equal(got_ex, b_, want_ex)


@pytest.mark.parametrize("n,n_b", [(37, 3), (300, 2)])
def test_torch_commit_merges_overlapping_phases_as_reference(n, n_b):
    """Two phases of one class whose selections overlap: the reference
    commits the planes it merged at the class's start (``prep.merged``), the
    port's commit merges each selected row as it stands (``prep.merge``,
    ``existing_commit_plain``), so a row taken twice is merged twice.  The
    merge is idempotent, so every leaf agrees after both phases, with
    bounds on three keys and the "other" slot on either side."""
    rng = np.random.default_rng(500 + n)
    tenants = [_phase_planes(rng, n) for _ in range(n_b)]
    q1 = [np.int32(max(1, int(t["cap"].clip(0).sum()) // 3)) for t in tenants]
    q2 = [np.int32(int(t["cap"].clip(0).sum())) for t in tenants]
    all_zones = np.ones(3, bool)
    ex, prep, cls, stacked = _port_phase_inputs(tenants)
    ex1, a1, _ = tsolve._phase_existing(ex, prep, cls, torch.as_tensor(np.stack(q1)),
                                        torch.as_tensor(np.stack([all_zones] * n_b)), tsolve.PLAIN)
    ex2, a2, _ = tsolve._phase_existing(ex1, prep, cls, torch.as_tensor(np.stack(q2)),
                                        torch.as_tensor(np.stack([all_zones] * n_b)), tsolve.PLAIN)
    assert ((a1 > 0) & (a2 > 0)).any()  # rows taken in both phases
    for b_, t in enumerate(tenants):
        finite = np.isfinite(t["cls"][3][0]) | np.isfinite(t["cls"][4][0])
        assert (finite & np.asarray(KHB_PHASE)).any()  # the bounds pass runs
        jprep = _jax_prep(t)
        want1, want_a1, _ = _jax_phase(t, False, False, prep=jprep, quota=q1[b_],
                                       restrict=all_zones)
        _assert_ex_equal(ex1, b_, want1)
        want2, want_a2, _ = _jax_phase(t, False, False, ex=want1, prep=jprep, quota=q2[b_],
                                       restrict=all_zones)
        np.testing.assert_array_equal(a2[b_].numpy(), np.asarray(want_a2))
        _assert_ex_equal(ex2, b_, want2)


@pytest.mark.parametrize("seed", range(4))
def test_torch_existing_mask_fill_twin_is_mask_fill_and_sum(seed):
    """The fused entry's solo call (a 0-dim quota and placed, no tenant
    axis) equals K6's caps, K2's fill and the int32 sum."""
    rng = np.random.default_rng(100 + seed)
    t = _phase_planes(rng, 64, negative_cap=seed % 2 == 1)
    args = (torch.as_tensor(t["cap"]), torch.as_tensor(t["ex"][6]), torch.as_tensor(t["cls_zone"]),
            torch.as_tensor(t["restrict"]), torch.as_tensor(t["extra"]) if seed < 2 else None,
            seed == 3)
    quota = torch.as_tensor(t["quota"])
    assigned, placed, zone_ok = k56.existing_mask_fill(*args, quota)
    cap, priority, want_zone_ok = k56.existing_mask_plain(*args)
    want = tsolve.PLAIN.fill(quota, cap, priority)
    assert torch.equal(assigned, want) and torch.equal(zone_ok, want_zone_ok)
    assert placed.dtype == torch.int32 and int(placed) == int(want.sum(dtype=torch.int32))
