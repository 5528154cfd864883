"""Kubernetes-shaped object model (pods, nodes, selectors, affinity).

The framework is standalone — there is no apiserver — so we carry a lightweight
but faithful object model covering everything the scheduler and controllers
consume.  Field names follow k8s conventions in snake_case.  Semantics of
matching/toleration helpers mirror k8s.io/api/core/v1 as exercised by the
reference (taints.go:28, topology.go:366-402).
"""

from __future__ import annotations

import itertools
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_core_tpu_torch.utils import resources as resources_util

# --- metadata ---------------------------------------------------------------

_uid_counter = itertools.count(1)


def new_uid() -> str:
    return f"{next(_uid_counter):08x}-{uuid.uuid4().hex[:12]}"


@dataclass
class OwnerReference:
    api_version: str = ""
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: bool = False


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = field(default_factory=new_uid)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None
    finalizers: List[str] = field(default_factory=list)
    owner_references: List[OwnerReference] = field(default_factory=list)
    resource_version: int = 0
    generation: int = 0


# --- selectors --------------------------------------------------------------


@dataclass
class LabelSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist
    values: List[str] = field(default_factory=list)


@dataclass
class LabelSelector:
    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[LabelSelectorRequirement] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        for key, value in self.match_labels.items():
            if labels.get(key) != value:
                return False
        for expr in self.match_expressions:
            present = expr.key in labels
            if expr.operator == "In":
                if not present or labels[expr.key] not in expr.values:
                    return False
            elif expr.operator == "NotIn":
                if present and labels[expr.key] in expr.values:
                    return False
            elif expr.operator == "Exists":
                if not present:
                    return False
            elif expr.operator == "DoesNotExist":
                if present:
                    return False
            else:
                return False
        return True


# --- node selection / affinity ----------------------------------------------

# NodeSelectorOperator values
OP_IN = "In"
OP_NOT_IN = "NotIn"
OP_EXISTS = "Exists"
OP_DOES_NOT_EXIST = "DoesNotExist"
OP_GT = "Gt"
OP_LT = "Lt"


@dataclass
class NodeSelectorRequirement:
    key: str
    operator: str
    values: List[str] = field(default_factory=list)


@dataclass
class NodeSelectorTerm:
    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)


@dataclass
class NodeSelector:
    node_selector_terms: List[NodeSelectorTerm] = field(default_factory=list)


@dataclass
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm


@dataclass
class NodeAffinity:
    required: Optional[NodeSelector] = None
    preferred: List[PreferredSchedulingTerm] = field(default_factory=list)


@dataclass
class PodAffinityTerm:
    topology_key: str
    label_selector: Optional[LabelSelector] = None
    namespaces: List[str] = field(default_factory=list)
    namespace_selector: Optional[LabelSelector] = None


@dataclass
class WeightedPodAffinityTerm:
    weight: int
    pod_affinity_term: PodAffinityTerm


@dataclass
class PodAffinity:
    required: List[PodAffinityTerm] = field(default_factory=list)
    preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class PodAntiAffinity:
    required: List[PodAffinityTerm] = field(default_factory=list)
    preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


# --- taints / tolerations ---------------------------------------------------

TAINT_EFFECT_NO_SCHEDULE = "NoSchedule"
TAINT_EFFECT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
TAINT_EFFECT_NO_EXECUTE = "NoExecute"


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = TAINT_EFFECT_NO_SCHEDULE


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty matches all effects

    def tolerates_taint(self, taint: Taint) -> bool:
        """Mirror of v1.Toleration.ToleratesTaint."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        # Equal (default): empty key requires Exists to match all
        if not self.key and self.operator != "Exists":
            return False
        return self.value == taint.value


# --- topology spread --------------------------------------------------------

DO_NOT_SCHEDULE = "DoNotSchedule"
SCHEDULE_ANYWAY = "ScheduleAnyway"


@dataclass
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str = DO_NOT_SCHEDULE
    label_selector: Optional[LabelSelector] = None


# --- containers / pods ------------------------------------------------------


@dataclass
class ContainerPort:
    container_port: int = 0
    host_port: int = 0
    protocol: str = "TCP"
    host_ip: str = ""


@dataclass
class ResourceRequirements:
    requests: resources_util.ResourceList = field(default_factory=dict)
    limits: resources_util.ResourceList = field(default_factory=dict)


@dataclass
class Container:
    name: str = "app"
    image: str = ""
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    ports: List[ContainerPort] = field(default_factory=list)


@dataclass
class PersistentVolumeClaimVolumeSource:
    claim_name: str = ""


@dataclass
class Volume:
    name: str = ""
    persistent_volume_claim: Optional[PersistentVolumeClaimVolumeSource] = None


@dataclass
class PodSpec:
    node_selector: Dict[str, str] = field(default_factory=dict)
    node_name: str = ""
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = field(default_factory=list)
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    topology_spread_constraints: List[TopologySpreadConstraint] = field(default_factory=list)
    priority: Optional[int] = None
    priority_class_name: str = ""
    volumes: List[Volume] = field(default_factory=list)
    scheduler_name: str = "default-scheduler"
    termination_grace_period_seconds: Optional[int] = None


POD_PENDING = "Pending"
POD_RUNNING = "Running"
POD_SUCCEEDED = "Succeeded"
POD_FAILED = "Failed"


@dataclass
class PodCondition:
    type: str = ""
    status: str = ""
    reason: str = ""


@dataclass
class PodStatus:
    phase: str = POD_PENDING
    conditions: List[PodCondition] = field(default_factory=list)
    start_time: Optional[float] = None
    nominated_node_name: str = ""


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    @property
    def uid(self) -> str:
        return self.metadata.uid

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


# --- nodes ------------------------------------------------------------------


@dataclass
class NodeCondition:
    type: str = ""
    status: str = ""


NODE_READY = "Ready"


@dataclass
class NodeSpec:
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False
    provider_id: str = ""


@dataclass
class NodeStatus:
    capacity: resources_util.ResourceList = field(default_factory=dict)
    allocatable: resources_util.ResourceList = field(default_factory=dict)
    conditions: List[NodeCondition] = field(default_factory=list)
    phase: str = ""


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    @property
    def name(self) -> str:
        return self.metadata.name


# --- storage (the fields scheduling.volumeusage reads) ------------------------


@dataclass
class PersistentVolumeClaimSpec:
    storage_class_name: Optional[str] = None
    volume_name: str = ""


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeClaimSpec = field(default_factory=PersistentVolumeClaimSpec)


@dataclass
class PersistentVolumeSpec:
    csi_driver: str = ""


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeSpec = field(default_factory=PersistentVolumeSpec)


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = ""


__all__ = [name for name in dir() if not name.startswith("_")]
