"""The headline provisioning workload, built with the port's own factories.

``build_inputs`` is the port's copy of the reference's bench input builder
(bench.py ``build_inputs``): N pending pods against a fake catalog of I
instance types and P weighted provisioners.  The pod mix is the reference
benchmark's makeDiversePods (scheduling_benchmark_test.go:185-197): 3/7
generic pods in four sizes, 1/7 zonal topology spread, 1/7 hostname spread,
and 2/7 zone self-affinity over 7 label groups.  The main path runs it at
50,000 pods x 1,000 types x 5 provisioners.
"""

from __future__ import annotations

from typing import List, Tuple

from karpenter_core_tpu_torch.apis import labels as labels_api
from karpenter_core_tpu_torch.apis.objects import (
    LabelSelector,
    Pod,
    PodAffinityTerm,
    TopologySpreadConstraint,
)
from karpenter_core_tpu_torch.cloudprovider import fake as fake_cp
from karpenter_core_tpu_torch.testing.factories import make_pod, make_provisioner


def build_pods(n_pods: int) -> List[Pod]:
    """The makeDiversePods mix of ``n_pods`` pending pods."""
    pods = []
    n_spread = n_pods // 7
    n_host_spread = n_pods // 7
    n_affinity = 2 * n_pods // 7
    n_generic = n_pods - n_spread - n_host_spread - n_affinity
    sizes = [
        {"cpu": "500m", "memory": "512Mi"},
        {"cpu": 1, "memory": "2Gi"},
        {"cpu": 2, "memory": "4Gi"},
        {"cpu": "250m", "memory": "256Mi"},
    ]
    for i in range(n_generic):
        pods.append(make_pod(requests=sizes[i % len(sizes)]))
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


def build_inputs(n_pods: int, n_instance_types: int, n_provisioners: int,
                 device=None, use_kernels: bool = True) -> Tuple[object, List[Pod]]:
    """(CudaSolver, pods) for the headline workload (``device=None``: CUDA)."""
    from karpenter_core_tpu_torch.solver.cuda import CudaSolver

    provider = fake_cp.FakeCloudProvider(fake_cp.instance_types(n_instance_types))
    provisioners = [
        make_provisioner(name=f"prov-{i}", weight=n_provisioners - i)
        for i in range(n_provisioners)
    ]
    solver = CudaSolver(provider, provisioners, device=device, use_kernels=use_kernels)
    return solver, build_pods(n_pods)
