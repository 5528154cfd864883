"""The headline provisioning workload, built with the port's own factories.

``build_inputs`` is the port's copy of the reference's bench input builder
(bench.py ``build_inputs``): N pending pods against a fake catalog of I
instance types and P weighted provisioners.  The pod mix is the reference
benchmark's makeDiversePods (scheduling_benchmark_test.go:185-197): 3/7
generic pods in four sizes, 1/7 zonal topology spread, 1/7 hostname spread,
and 2/7 zone self-affinity over 7 label groups.  The main path runs it at
50,000 pods x 1,000 types x 5 provisioners.

``build_cluster`` is the live cluster those pods meet on the existing-node
path: N initialized nodes of the same catalog and provisioners, filled with
bound pods of the same mix to a given share of their cpu.
``consolidation_candidates`` lists that cluster's nodes as multi-node
consolidation candidates, the input of ``CudaConsolidationSearch``.
``churn_tick`` is one tick of steady churn on a ``PodIngest``, the input of
the warm repair (``solver.incremental``).
"""

from __future__ import annotations

import copy
from typing import List, Tuple

import numpy as np

from karpenter_core_tpu_torch.apis import labels as labels_api
from karpenter_core_tpu_torch.apis.objects import (
    LabelSelector,
    Pod,
    PodAffinityTerm,
    Taint,
    TopologySpreadConstraint,
    new_uid,
)
from karpenter_core_tpu_torch.cloudprovider import fake as fake_cp
from karpenter_core_tpu_torch.testing.factories import make_node, make_pod, make_provisioner
from karpenter_core_tpu_torch.utils import resources as resources_util

# the taint of the dedicated pool: every tenth node carries it, and no pod of
# the mix tolerates it
DEDICATED_TAINT = Taint(key="dedicated", value="batch", effect="NoSchedule")


# the makeDiversePods mix's four generic request sizes
HEADLINE_SIZES = (
    {"cpu": "500m", "memory": "512Mi"},
    {"cpu": 1, "memory": "2Gi"},
    {"cpu": 2, "memory": "4Gi"},
    {"cpu": "250m", "memory": "256Mi"},
)


def build_pods(n_pods: int) -> List[Pod]:
    """The makeDiversePods mix of ``n_pods`` pending pods."""
    pods = []
    n_spread = n_pods // 7
    n_host_spread = n_pods // 7
    n_affinity = 2 * n_pods // 7
    n_generic = n_pods - n_spread - n_host_spread - n_affinity
    for i in range(n_generic):
        pods.append(make_pod(requests=dict(HEADLINE_SIZES[i % len(HEADLINE_SIZES)])))
    for key, app, count in (
        (labels_api.LABEL_TOPOLOGY_ZONE, "spread", n_spread),
        (labels_api.LABEL_HOSTNAME, "hspread", n_host_spread),
    ):
        for _ in range(count):
            pods.append(make_pod(
                labels={"app": app},
                requests={"cpu": "250m", "memory": "256Mi"},
                topology_spread=[TopologySpreadConstraint(
                    max_skew=1, topology_key=key,
                    label_selector=LabelSelector(match_labels={"app": app}),
                )],
            ))
    # zone self-affinity groups over a 7-value label pool
    # (scheduling_benchmark_test.go:263-278)
    for i in range(n_affinity):
        group = f"g{i % 7}"
        pods.append(make_pod(
            labels={"aff-group": group},
            requests={"cpu": "250m", "memory": "256Mi"},
            pod_affinity=[PodAffinityTerm(
                topology_key=labels_api.LABEL_TOPOLOGY_ZONE,
                label_selector=LabelSelector(match_labels={"aff-group": group}),
            )],
        ))
    return pods


def build_provider(n_instance_types: int, n_provisioners: int):
    """(FakeCloudProvider, provisioners) of the headline workload: the fake
    catalog of ``n_instance_types`` types and provisioners ``prov-{i}`` of
    weight ``n_provisioners - i``."""
    provider = fake_cp.FakeCloudProvider(fake_cp.instance_types(n_instance_types))
    provisioners = [
        make_provisioner(name=f"prov-{i}", weight=n_provisioners - i)
        for i in range(n_provisioners)
    ]
    return provider, provisioners


def build_inputs(n_pods: int, n_instance_types: int, n_provisioners: int,
                 device=None, use_kernels: bool = True, policy=None) -> Tuple[object, List[Pod]]:
    """(CudaSolver, pods) for the headline workload (``device=None``: CUDA;
    ``policy``: a ``policy.PolicyConfig``)."""
    from karpenter_core_tpu_torch.solver.cuda import CudaSolver

    provider, provisioners = build_provider(n_instance_types, n_provisioners)
    solver = CudaSolver(provider, provisioners, device=device, use_kernels=use_kernels,
                        policy=policy)
    return solver, build_pods(n_pods)


def move_spot_market(provider, factor: float = 0.6, zone: str = "test-zone-2") -> None:
    """The reference's policy benchmark's price move (bench.py
    ``policy_line``): every type's spot offering in ``zone`` drops to
    ``factor`` times the type's first offering's price, through
    ``set_price``."""
    for it in provider.get_instance_types(None):
        provider.set_price(it.name, it.offerings[0].price * factor,
                           capacity_type=labels_api.CAPACITY_TYPE_SPOT, zone=zone)


def relax_fleet(n_pods: int, n_instance_types: int, sizes, mode: str = "relax", device=None,
                use_kernels: bool = True) -> Tuple[object, List[Pod]]:
    """(CudaSolver, pods) of the relax family's small fleets: one
    ``default`` provisioner over the fake catalog of ``n_instance_types``
    types after ``move_spot_market``, the policy on with ``solver_mode=mode``,
    and ``n_pods`` pods cycling through ``sizes``.  With one size of
    500m / 512Mi at 4,000 pods x 24 types this is a leg of the reference's
    ``bench.py:854 relax_line``; with ``HEADLINE_SIZES`` at 2,000 pods its
    leftover takes the repair window."""
    from karpenter_core_tpu_torch.policy import PolicyConfig
    from karpenter_core_tpu_torch.solver.cuda import CudaSolver

    provider = fake_cp.FakeCloudProvider(fake_cp.instance_types(n_instance_types))
    move_spot_market(provider)
    solver = CudaSolver(provider, [make_provisioner(name="default")], device=device,
                        use_kernels=use_kernels,
                        policy=PolicyConfig(enabled=True, solver_mode=mode))
    return solver, [make_pod(requests=dict(sizes[i % len(sizes)])) for i in range(n_pods)]


def relax_case(rng, n_c: int, n_t: int, n_it: int, n_z: int, n_ct: int, n_keys: int = 4,
               n_words: int = 2, n_res: int = 3) -> dict:
    """Seeded inputs of the relax kernels (K14, K17, K18), as numpy arrays:
    the per-(class, template) planes (``kernels.relax.RelaxPlanes`` fields),
    full-mantissa prices (a fifth without an offering), risks and
    throughputs, class counts (some zero, one at 3,000,000), the merged
    requirement rows and the resource vectors."""
    b = lambda p, *shape: rng.random(shape) < p  # noqa: E731
    price = (rng.random((n_it, n_z, n_ct)) * 5).astype(np.float32)
    price[rng.random((n_it, n_z, n_ct)) < 0.2] = np.inf
    counts = rng.integers(0, 400, n_c).astype(np.int32)
    counts[rng.random(n_c) < 0.25] = 0
    counts[0] = 3_000_000
    return dict(
        it_int=b(0.8, n_c, n_t, n_it),
        per_pod=rng.integers(0, 60, (n_c, n_t, n_it)).astype(np.int32),
        key_ok=b(0.9, n_c, n_t), tmpl_it=b(0.9, n_t, n_it), cls_it=b(0.9, n_c, n_it),
        tmpl_zone=b(0.8, n_t, n_z), cls_zone=b(0.8, n_c, n_z), tmpl_ct=b(0.8, n_t, n_ct),
        cls_ct=b(0.8, n_c, n_ct), it_avail=b(0.8, n_it, n_z, n_ct), price=price,
        risk=rng.random((n_it, n_z, n_ct)).astype(np.float32),
        throughput=rng.random(n_it).astype(np.float32), counts=counts,
        mask=rng.integers(-2**31, 2**31, (n_c, n_t, n_keys, n_words), dtype=np.int64).astype(
            np.int32),
        defined=b(0.5, n_c, n_t, n_keys), negative=b(0.3, n_c, n_t, n_keys),
        gt=np.where(b(0.5, n_c, n_t, n_keys), -np.inf, rng.integers(-3, 5, (n_c, n_t, n_keys))
                    ).astype(np.float32),
        lt=np.where(b(0.5, n_c, n_t, n_keys), np.inf, rng.integers(0, 12, (n_c, n_t, n_keys))
                    ).astype(np.float32),
        daemon=(rng.random((n_t, n_res)) * 0.5).astype(np.float32),
        requests=(rng.random((n_c, n_res)) * 2).astype(np.float32),
    )


def objective_case(rng, n: int, n_it: int, n_z: int, n_ct: int) -> dict:
    """Seeded inputs of the offering selection (K13), as numpy arrays:
    full-mantissa prices (a fifth of the cells without an offering), risks
    and throughputs, random slot masks, and edge rows first — row 0 allows
    nothing; row 1 only type 0, whose throughput is NaN (a NaN score);
    row 2 only type 1, whose throughput is +inf (a -inf score, or NaN at a
    zero throughput weight); row 3 only type 2, whose offerings cost -0.0
    and +0.0 (tied scores).  The last capacity type is spot."""
    price = (rng.random((n_it, n_z, n_ct)) * 5).astype(np.float32)
    price[rng.random((n_it, n_z, n_ct)) < 0.2] = np.inf
    risk = rng.random((n_it, n_z, n_ct)).astype(np.float32)
    throughput = rng.random(n_it).astype(np.float32)
    viable = rng.random((n, n_it)) < 0.5
    zone = rng.random((n, n_z)) < 0.7
    ct = rng.random((n, n_ct)) < 0.8
    edge = min(n, 4) if n_it >= 3 else 0
    if edge:
        viable[:edge] = False
        zone[:edge] = True
        ct[:edge] = True
        for row in range(1, edge):
            viable[row, row - 1] = True
        throughput[0], throughput[1] = np.nan, np.inf
        price[:3] = np.where(np.isfinite(price[:3]), price[:3], np.float32(1.5))
        price[2] = np.float32(0.0)
        price[2].reshape(-1)[::2] = np.float32(-0.0)
    return dict(
        viable=viable, zone=zone, ct=ct, open_=rng.random(n) < 0.8,
        pod_count=rng.integers(0, 3, n).astype(np.int32), price=price, risk=risk,
        throughput=throughput, is_spot=np.arange(n_ct) == n_ct - 1,
    )


def build_cluster(n_nodes: int, n_instance_types: int, n_provisioners: int, fill: float,
                  seed: int) -> Tuple[list, List[Pod]]:
    """(state_nodes, bound_pods): a live cluster of ``n_nodes`` nodes for the
    existing-node path, deterministic from ``seed`` (a numpy Generator).

    - node i belongs to ``prov-{i % n_provisioners}``;
    - its instance type is drawn uniformly from the fake catalog's
      (``instance_types(n_instance_types)``) types with at least 4 vcpu and
      an available offering, and one of that type's available offerings is
      drawn for its zone and capacity-type labels;
    - it is initialized, with the type's allocatable and capacity;
    - every tenth node (i % 10 == 9) carries ``DEDICATED_TAINT``;
    - bound pods are a fresh makeDiversePods batch (``build_pods``), shuffled,
      and bound first-fit in node order while a node's cpu requests stay
      within ``fill`` of its allocatable cpu, until no node can take the
      smallest pod.  So the pending mix's spread, hostname-spread and
      affinity groups already have members on existing nodes.

    The catalog gives a type of i vcpu 10·i pods, so no node meets its pods
    limit before its cpu share.
    """
    from karpenter_core_tpu_torch.state.cluster import StateNode

    rng = np.random.default_rng(seed)
    catalog = fake_cp.instance_types(n_instance_types)
    choices = [
        it for it in catalog
        if resources_util.parse_quantity(it.capacity.get(resources_util.CPU, 0)) >= 4.0
        and any(o.available for o in it.offerings)
    ]
    nodes, targets = [], []
    for i in range(n_nodes):
        it = choices[int(rng.integers(len(choices)))]
        offers = [o for o in it.offerings if o.available]
        offer = offers[int(rng.integers(len(offers)))]
        name = f"node-{i:05d}"
        node = make_node(
            name=name,
            labels={
                labels_api.PROVISIONER_NAME_LABEL_KEY: f"prov-{i % n_provisioners}",
                labels_api.LABEL_INSTANCE_TYPE_STABLE: it.name,
                labels_api.LABEL_TOPOLOGY_ZONE: offer.zone,
                labels_api.LABEL_CAPACITY_TYPE: offer.capacity_type,
                labels_api.LABEL_NODE_INITIALIZED: "true",
            },
            taints=[DEDICATED_TAINT] if i % 10 == 9 else None,
            allocatable=it.allocatable(),
            capacity=dict(it.capacity),
            provider_id=f"fake://{name}",
        )
        nodes.append(StateNode(node))
        targets.append(fill * node.status.allocatable.get(resources_util.CPU, 0.0))

    # batches of the mix (it averages 0.54 cpu a pod), each in a seeded
    # order, bound first-fit in node order: one cursor per pod size, each at
    # the first node that might still take a pod of that size (room only
    # shrinks), until no node can take the smallest pod
    room = list(targets)
    cursor: dict = {}
    bound: List[Pod] = []
    while n_nodes:
        pods = build_pods(max(7, int(sum(room) / 0.5) // 7 * 7))
        cpu = [resources_util.requests_for_pods(p).get(resources_util.CPU, 0.0) for p in pods]
        for size in cpu:
            cursor.setdefault(size, 0)
        for j in rng.permutation(len(pods)):
            size = cpu[j]
            e = cursor[size]
            while e < n_nodes and room[e] + 1e-9 < size:
                e += 1
            cursor[size] = e
            if e < n_nodes:
                pod = pods[j]
                pod.spec.node_name = nodes[e].node.name
                nodes[e].update_for_pod(pod)
                room[e] -= size
                bound.append(pod)
        if cursor[min(cursor)] >= n_nodes:
            break
    return nodes, bound


def consolidation_candidates(state_nodes: list, bound_pods: List[Pod], n_instance_types: int,
                             n_provisioners: int) -> list:
    """The ``CandidateNode``s of a ``build_cluster`` cluster, sorted by
    disruption cost (a stable sort, so ties keep node order).

    Eligibility follows the reference's ``candidate_nodes``
    (karpenter_core_tpu/controllers/deprovisioning.py:224, helpers.go:171-249):
    a node is a candidate when it is not marked for deletion, its provisioner
    exists, its instance type is in that provisioner's catalog, it has zone
    and capacity-type labels and it is initialized.  No node of
    ``build_cluster`` is nominated, and its provisioners set no expiry, so
    each node's cost is the disruption cost of its pods."""
    from karpenter_core_tpu_torch.controllers.deprovisioning import (
        CandidateNode,
        disruption_cost,
    )

    provider, provisioners = build_provider(n_instance_types, n_provisioners)
    by_name = {p.name: p for p in provisioners}
    catalogs = {
        p.name: {it.name: it for it in provider.get_instance_types(p)} for p in provisioners
    }
    pods_on: dict = {}
    for pod in bound_pods:
        pods_on.setdefault(pod.spec.node_name, []).append(pod)
    out = []
    for state_node in state_nodes:
        labels = state_node.node.metadata.labels
        provisioner = by_name.get(labels.get(labels_api.PROVISIONER_NAME_LABEL_KEY, ""))
        if state_node.marked() or provisioner is None:
            continue
        it = catalogs[provisioner.name].get(labels.get(labels_api.LABEL_INSTANCE_TYPE_STABLE, ""))
        ct = labels.get(labels_api.LABEL_CAPACITY_TYPE)
        zone = labels.get(labels_api.LABEL_TOPOLOGY_ZONE)
        if it is None or not ct or not zone or not state_node.initialized():
            continue
        pods = pods_on.get(state_node.node.name, [])
        out.append(CandidateNode(
            node=state_node.node, state_node=state_node, instance_type=it, capacity_type=ct,
            zone=zone, provisioner=provisioner, disruption_cost=disruption_cost(pods),
            pods=pods,
        ))
    return sorted(out, key=lambda c: c.disruption_cost)


def churn_tick(ingest, tick: int, reps: dict, churn_fraction: float = 0.02,
               class_fraction: float = 0.25) -> Tuple[List[str], List[Pod]]:
    """One tick of steady churn on a ``PodIngest`` — the reference
    benchmark's churn loop (bench.py ``churn_line``): the population stays
    the same size while ``churn_fraction`` of it is replaced, concentrated
    in a rotating window of ``class_fraction`` of the classes (the classes
    in ``repr`` order of their signatures, the window starting at
    ``tick * window``).  Each class of the window gives up its oldest
    members, its share of the target rounded (at least one, at most all);
    each eviction is replaced by a copy of the class's representative — its
    first member when the class first churned, kept in ``reps`` by
    signature — with a fresh uid, the name ``churn-{tick}-{i}`` and no
    node.  Returns (evicted uids in order, added pods)."""
    members = ingest.class_members()
    sigs = sorted(members, key=repr)
    window = max(int(len(sigs) * class_fraction), 1)
    start = (tick * window) % max(len(sigs), 1)
    dirty = [sigs[(start + i) % len(sigs)] for i in range(window)]
    target = max(int(len(ingest) * churn_fraction), 1)
    pool = sum(len(members[s]) for s in dirty)
    evictions: List[str] = []
    replacements: List[Pod] = []
    for sig in dirty:
        uids = members[sig]
        take = min(max(round(target * len(uids) / max(pool, 1)), 1), len(uids))
        if sig not in reps:
            reps[sig] = copy.deepcopy(ingest.get(uids[0]))
        evictions.extend(uids[:take])
        for _ in range(take):
            pod = copy.deepcopy(reps[sig])
            pod.metadata.name = f"churn-{tick}-{len(replacements)}"
            pod.metadata.uid = new_uid()
            pod.spec.node_name = ""
            replacements.append(pod)
    for uid in evictions:
        ingest.remove(uid)
    for pod in replacements:
        ingest.add(pod)
    return evictions, replacements
