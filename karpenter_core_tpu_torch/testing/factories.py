"""Test object factories with option merging.

Mirrors the role of karpenter-core pkg/test/{pods.go,nodes.go,provisioner.go}:
compact constructors for pods/nodes/provisioners used across the suite and the
benchmarks.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

from karpenter_core_tpu_torch.apis import labels as labels_api
from karpenter_core_tpu_torch.apis.objects import (
    Affinity,
    Container,
    ContainerPort,
    NodeAffinity,
    NodeSelector,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    Node,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    PodCondition,
    PodSpec,
    PodStatus,
    PreferredSchedulingTerm,
    ResourceRequirements,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
)
from karpenter_core_tpu_torch.apis.v1alpha5 import (
    Consolidation,
    Limits,
    Provisioner,
    ProvisionerSpec,
)
from karpenter_core_tpu_torch.utils import resources as resources_util

_names = itertools.count(1)


def _name(prefix: str) -> str:
    return f"{prefix}-{next(_names):05d}"


def make_pod(
    name: Optional[str] = None,
    namespace: str = "default",
    labels: Optional[Dict[str, str]] = None,
    annotations: Optional[Dict[str, str]] = None,
    requests: Optional[Dict[str, "str | float"]] = None,
    limits: Optional[Dict[str, "str | float"]] = None,
    node_selector: Optional[Dict[str, str]] = None,
    node_name: str = "",
    node_requirements: Optional[List[NodeSelectorRequirement]] = None,
    node_preferences: Optional[List[NodeSelectorRequirement]] = None,
    tolerations: Optional[List[Toleration]] = None,
    topology_spread: Optional[List[TopologySpreadConstraint]] = None,
    pod_affinity: Optional[List[PodAffinityTerm]] = None,
    pod_anti_affinity: Optional[List[PodAffinityTerm]] = None,
    pod_affinity_preferred: Optional[List[WeightedPodAffinityTerm]] = None,
    pod_anti_affinity_preferred: Optional[List[WeightedPodAffinityTerm]] = None,
    host_ports: Optional[List[int]] = None,
    pvcs: Optional[List[str]] = None,
    owner_kind: str = "",
    priority: Optional[int] = None,
    phase: str = "Pending",
    unschedulable: bool = True,
    creation_timestamp: float = 0.0,
    deletion_cost: Optional[float] = None,
) -> Pod:
    """A pending, unschedulable-marked pod by default."""
    meta = ObjectMeta(
        name=name or _name("pod"),
        namespace=namespace,
        labels=dict(labels or {}),
        annotations=dict(annotations or {}),
        creation_timestamp=creation_timestamp,
    )
    if deletion_cost is not None:
        meta.annotations["controller.kubernetes.io/pod-deletion-cost"] = str(deletion_cost)
    if owner_kind:
        meta.owner_references.append(OwnerReference(kind=owner_kind, name=f"owner-{meta.name}"))

    container = Container(
        resources=ResourceRequirements(
            requests=resources_util.parse_resource_list(requests or {}),
            limits=resources_util.parse_resource_list(limits or {}),
        ),
        ports=[ContainerPort(host_port=p) for p in (host_ports or [])],
    )

    affinity = None
    node_affinity = None
    if node_requirements or node_preferences:
        node_affinity = NodeAffinity(
            required=(
                NodeSelector(
                    node_selector_terms=[NodeSelectorTerm(match_expressions=list(node_requirements))]
                )
                if node_requirements
                else None
            ),
            preferred=(
                [
                    PreferredSchedulingTerm(
                        weight=1, preference=NodeSelectorTerm(match_expressions=list(node_preferences))
                    )
                ]
                if node_preferences
                else []
            ),
        )
    if node_affinity or pod_affinity or pod_anti_affinity or pod_affinity_preferred or pod_anti_affinity_preferred:
        affinity = Affinity(
            node_affinity=node_affinity,
            pod_affinity=(
                PodAffinity(
                    required=list(pod_affinity or []),
                    preferred=list(pod_affinity_preferred or []),
                )
                if pod_affinity or pod_affinity_preferred
                else None
            ),
            pod_anti_affinity=(
                PodAntiAffinity(
                    required=list(pod_anti_affinity or []),
                    preferred=list(pod_anti_affinity_preferred or []),
                )
                if pod_anti_affinity or pod_anti_affinity_preferred
                else None
            ),
        )

    status = PodStatus(phase=phase)
    if unschedulable and not node_name:
        status.conditions.append(
            PodCondition(type="PodScheduled", status="False", reason="Unschedulable")
        )

    from karpenter_core_tpu_torch.apis.objects import (
        PersistentVolumeClaimVolumeSource,
        Volume,
    )

    return Pod(
        metadata=meta,
        spec=PodSpec(
            node_selector=dict(node_selector or {}),
            node_name=node_name,
            affinity=affinity,
            tolerations=list(tolerations or []),
            containers=[container],
            topology_spread_constraints=list(topology_spread or []),
            priority=priority,
            volumes=[
                Volume(
                    name=f"vol-{claim}",
                    persistent_volume_claim=PersistentVolumeClaimVolumeSource(claim_name=claim),
                )
                for claim in (pvcs or [])
            ],
        ),
        status=status,
    )


def make_pods(count: int, **kwargs) -> List[Pod]:
    return [make_pod(**kwargs) for _ in range(count)]


def make_daemonset_pod(**kwargs) -> Pod:
    kwargs.setdefault("owner_kind", "DaemonSet")
    return make_pod(**kwargs)


def make_node(
    name: Optional[str] = None,
    labels: Optional[Dict[str, str]] = None,
    annotations: Optional[Dict[str, str]] = None,
    taints: Optional[List[Taint]] = None,
    allocatable: Optional[Dict[str, "str | float"]] = None,
    capacity: Optional[Dict[str, "str | float"]] = None,
    provider_id: str = "",
    ready: bool = True,
    unschedulable: bool = False,
    finalizers: Optional[List[str]] = None,
    creation_timestamp: float = 0.0,
) -> Node:
    node_name = name or _name("node")
    labels = dict(labels or {})
    labels.setdefault(labels_api.LABEL_HOSTNAME, node_name)
    from karpenter_core_tpu_torch.apis.objects import NodeCondition

    return Node(
        metadata=ObjectMeta(
            name=node_name,
            labels=labels,
            annotations=dict(annotations or {}),
            finalizers=list(finalizers or []),
            creation_timestamp=creation_timestamp,
        ),
        spec=NodeSpec(
            taints=list(taints or []),
            unschedulable=unschedulable,
            provider_id=provider_id or f"fake://{node_name}",
        ),
        status=NodeStatus(
            capacity=resources_util.parse_resource_list(
                capacity or allocatable or {"cpu": 16, "memory": "128Gi", "pods": 110}
            ),
            allocatable=resources_util.parse_resource_list(
                allocatable or capacity or {"cpu": 16, "memory": "128Gi", "pods": 110}
            ),
            conditions=[NodeCondition(type="Ready", status="True" if ready else "False")],
        ),
    )


def make_provisioner(
    name: str = "default",
    requirements: Optional[List[NodeSelectorRequirement]] = None,
    labels: Optional[Dict[str, str]] = None,
    taints: Optional[List[Taint]] = None,
    startup_taints: Optional[List[Taint]] = None,
    limits: Optional[Dict[str, "str | float"]] = None,
    weight: Optional[int] = None,
    ttl_seconds_after_empty: Optional[int] = None,
    ttl_seconds_until_expired: Optional[int] = None,
    consolidation_enabled: Optional[bool] = None,
    policy: Optional[Dict] = None,
) -> Provisioner:
    return Provisioner(
        metadata=ObjectMeta(name=name, namespace=""),
        spec=ProvisionerSpec(
            requirements=list(requirements or []),
            labels=dict(labels or {}),
            taints=list(taints or []),
            startup_taints=list(startup_taints or []),
            limits=Limits(resources=resources_util.parse_resource_list(limits)) if limits else None,
            weight=weight,
            ttl_seconds_after_empty=ttl_seconds_after_empty,
            ttl_seconds_until_expired=ttl_seconds_until_expired,
            consolidation=(
                Consolidation(enabled=consolidation_enabled)
                if consolidation_enabled is not None
                else None
            ),
            policy=dict(policy) if policy else None,
        ),
    )
