"""The port's solver facade (karpenter_core_tpu_torch/solver/cuda.py) held
against the JAX package's ``TPUSolver`` end to end, on the CPU.

The same pods are built twice, each package with its own factories and API
types.  ``encode`` must give equal arrays (exactly: the port's encode is a
copy), and ``solve``'s decode must give the same new nodes in the same
order — provisioner, instance-type options, zones, capacity types, pod
count and request vector per node — and the same failures.
"""

import random

import numpy as np
import pytest

import karpenter_core_tpu.apis.labels as jlabels
import karpenter_core_tpu.apis.objects as jobj
import karpenter_core_tpu.cloudprovider.fake as jfake
import karpenter_core_tpu.testing as jtesting
import karpenter_core_tpu_torch.apis.labels as tlabels
import karpenter_core_tpu_torch.apis.objects as tobj
import karpenter_core_tpu_torch.cloudprovider.fake as tfake
import karpenter_core_tpu_torch.testing as ttesting
from karpenter_core_tpu.solver.tpu import TPUSolver
from karpenter_core_tpu_torch.models.columnar import PodIngest
from karpenter_core_tpu_torch.solver.cuda import CudaSolver
from karpenter_core_tpu_torch.testing import workloads

# one namespace per package: the builders below take either
JAX_PKG = dict(obj=jobj, labels=jlabels, fake=jfake, testing=jtesting)
PORT_PKG = dict(obj=tobj, labels=tlabels, fake=tfake, testing=ttesting)


def _diverse_pods(pkg, n_pods):
    """The headline makeDiversePods mix, built from one package's types."""
    if pkg is PORT_PKG:
        return workloads.build_pods(n_pods)
    obj, labels, make_pod = pkg["obj"], pkg["labels"], pkg["testing"].make_pod
    n_spread = n_host = n_pods // 7
    n_aff = 2 * n_pods // 7
    sizes = [{"cpu": "500m", "memory": "512Mi"}, {"cpu": 1, "memory": "2Gi"},
             {"cpu": 2, "memory": "4Gi"}, {"cpu": "250m", "memory": "256Mi"}]
    pods = [make_pod(requests=sizes[i % 4]) for i in range(n_pods - n_spread - n_host - n_aff)]
    for key, app, count in ((labels.LABEL_TOPOLOGY_ZONE, "spread", n_spread),
                            (labels.LABEL_HOSTNAME, "hspread", n_host)):
        pods += [make_pod(
            labels={"app": app}, requests={"cpu": "250m", "memory": "256Mi"},
            topology_spread=[obj.TopologySpreadConstraint(
                max_skew=1, topology_key=key,
                label_selector=obj.LabelSelector(match_labels={"app": app}))],
        ) for _ in range(count)]
    for i in range(n_aff):
        group = f"g{i % 7}"
        pods.append(make_pod(
            labels={"aff-group": group}, requests={"cpu": "250m", "memory": "256Mi"},
            pod_affinity=[obj.PodAffinityTerm(
                topology_key=labels.LABEL_TOPOLOGY_ZONE,
                label_selector=obj.LabelSelector(match_labels={"aff-group": group}))],
        ))
    return pods


def _random_pods(pkg, seed):
    """A random mix of constraint families, drawn identically per package."""
    obj, labels, make_pod = pkg["obj"], pkg["labels"], pkg["testing"].make_pod
    rng = random.Random(seed)
    zone, host = labels.LABEL_TOPOLOGY_ZONE, labels.LABEL_HOSTNAME
    pods = []
    for i in range(rng.randint(3, 6)):
        lab = {"app": f"c{i}"}
        sel = obj.LabelSelector(match_labels=dict(lab))
        kw = dict(labels=lab, requests=rng.choice(
            ({"cpu": "100m"}, {"cpu": "500m"}, {"cpu": 1, "memory": "1Gi"})))
        shape = rng.random()
        if shape < 0.3:
            kw["topology_spread"] = [obj.TopologySpreadConstraint(
                max_skew=rng.choice((1, 2)), topology_key=rng.choice((zone, host)),
                label_selector=sel)]
        elif shape < 0.5:
            kw["pod_anti_affinity"] = [obj.PodAffinityTerm(
                topology_key=rng.choice((zone, host)), label_selector=sel)]
        elif shape < 0.65:
            kw["pod_affinity"] = [obj.PodAffinityTerm(
                topology_key=rng.choice((zone, host)), label_selector=sel)]
        if rng.random() < 0.3:
            kw["node_requirements"] = [obj.NodeSelectorRequirement(
                pkg["fake"].INTEGER_INSTANCE_LABEL_KEY, obj.OP_GT, [str(rng.randint(1, 6))])]
        pods.extend(make_pod(**kw) for _ in range(rng.randint(2, 12)))
    return pods


def _solvers(n_types, n_provisioners):
    def provs(pkg):
        return [pkg["testing"].make_provisioner(name=f"prov-{i}", weight=n_provisioners - i)
                for i in range(n_provisioners)]

    ref = TPUSolver(jfake.FakeCloudProvider(jfake.instance_types(n_types)), provs(JAX_PKG))
    port = CudaSolver(tfake.FakeCloudProvider(tfake.instance_types(n_types)), provs(PORT_PKG),
                      device="cpu")
    return ref, port


ARRAY_FIELDS = (
    "it_mask", "it_defined", "it_negative", "it_gt", "it_lt", "it_alloc", "it_avail",
    "it_price", "it_capacity", "tmpl_mask", "tmpl_defined", "tmpl_negative", "tmpl_gt",
    "tmpl_lt", "tmpl_zone", "tmpl_ct", "tmpl_it", "tmpl_daemon", "tmpl_limits",
    "cls_mask", "cls_defined", "cls_negative", "cls_gt", "cls_lt", "cls_zone", "cls_ct",
    "cls_it", "cls_requests", "cls_count", "cls_relax_next", "cls_anti_soft", "cls_root",
    "cls_tol", "cls_ports", "grp_skew", "grp_is_zone", "grp_is_anti", "grp_member",
    "cls_groups", "valid", "is_custom", "vocab_ints",
)
VALUE_FIELDS = ("resources", "zones", "capacity_types", "it_names", "scan_passes",
                "has_required_zonal_anti", "ports")


CASES = [("diverse", 350, 40, 5), ("random-1", 1, 16, 1), ("random-2", 2, 16, 2),
         ("random-3", 3, 24, 1)]


def _pods(case, pkg):
    name, size = case[0], case[1]
    return _diverse_pods(pkg, size) if name == "diverse" else _random_pods(pkg, 900 + size)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_encode_matches_reference(case):
    ref_solver, port_solver = _solvers(case[2], case[3])
    ref = ref_solver.encode(_pods(case, JAX_PKG))
    ingest = PodIngest()
    ingest.add_all(_pods(case, PORT_PKG))
    got = port_solver.encode(ingest)
    for f in ARRAY_FIELDS:
        a, b = np.asarray(getattr(ref, f)), np.asarray(getattr(got, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in VALUE_FIELDS:
        assert getattr(ref, f) == getattr(got, f), f
    assert tuple(ref.features) == tuple(got.features)
    assert [c.count for c in ref.classes] == [c.count for c in got.classes]


def test_fake_catalog_matches_reference():
    """``fake.instance_types(n)`` gives the reference's catalog field for
    field: names, capacity, overhead, offerings and requirements."""
    for ref, got in zip(jfake.instance_types(1000), tfake.instance_types(1000), strict=True):
        assert (ref.name, ref.capacity, ref.overhead) == (got.name, got.capacity, got.overhead)
        assert [(o.capacity_type, o.zone, o.price, o.available) for o in ref.offerings] == [
            (o.capacity_type, o.zone, o.price, o.available) for o in got.offerings]
        assert repr(ref.requirements).replace("karpenter_core_tpu.", "") == repr(
            got.requirements).replace("karpenter_core_tpu_torch.", "")


def _node_view(node):
    return (node.provisioner_name, node.instance_type_names, node.zones,
            node.capacity_types, len(node.pods), node.requests)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_decode_matches_reference(case):
    ref_solver, port_solver = _solvers(case[2], case[3])
    ref = ref_solver.solve(_pods(case, JAX_PKG))
    got = port_solver.solve(_pods(case, PORT_PKG))
    assert [_node_view(n) for n in ref.new_nodes] == [_node_view(n) for n in got.new_nodes]
    assert len(ref.failed_pods) == len(got.failed_pods)
    assert len(ref.spread_residual_pods) == len(got.spread_residual_pods)
    assert sum(len(n.pods) for n in got.new_nodes) + len(got.failed_pods) + len(
        got.spread_residual_pods) == len(_pods(case, PORT_PKG))
    # the launch path: zones and capacity types pinned, the same options
    ref_l = ref_solver.to_launchable(ref.new_nodes[0])
    got_l = port_solver.to_launchable(got.new_nodes[0])
    assert [it.name for it in ref_l.instance_type_options] == [
        it.name for it in got_l.instance_type_options]
    assert ref_l.requests == got_l.requests


@pytest.mark.slow
def test_full_size_solve_places_every_pod_on_7162_nodes():
    """The main path at full size: 50,000 pods x 1,000 types x 5
    provisioners.  The JAX package places every pod on 7,162 new nodes; the
    port must give the same node list."""
    case = ("diverse", 50_000, 1000, 5)
    ref_solver, port_solver = _solvers(case[2], case[3])
    ref = ref_solver.solve(_pods(case, JAX_PKG))
    ingest = PodIngest()
    ingest.add_all(_pods(case, PORT_PKG))
    got = port_solver.solve(ingest)
    assert len(ref.new_nodes) == len(got.new_nodes) == 7162
    assert not ref.failed_pods and not got.failed_pods
    assert [_node_view(n)[:5] for n in ref.new_nodes] == [_node_view(n)[:5] for n in got.new_nodes]
