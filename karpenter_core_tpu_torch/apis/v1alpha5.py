"""Provisioner and Machine API types.

Mirrors karpenter-core pkg/apis/v1alpha5/{provisioner.go:32-140, machine.go:23-117,
limits.go}.  These are declarative configuration objects: a Provisioner describes
the shape of capacity the framework may launch; a Machine is a launch request
handed to the cloud provider.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from karpenter_core_tpu_torch.apis.objects import (
    NodeSelectorRequirement,
    ObjectMeta,
    Taint,
)
from karpenter_core_tpu_torch.utils import resources as resources_util


@dataclass
class KubeletConfiguration:
    cluster_dns: List[str] = field(default_factory=list)
    max_pods: Optional[int] = None
    pods_per_core: Optional[int] = None
    system_reserved: resources_util.ResourceList = field(default_factory=dict)
    kube_reserved: resources_util.ResourceList = field(default_factory=dict)
    eviction_hard: Dict[str, str] = field(default_factory=dict)
    eviction_soft: Dict[str, str] = field(default_factory=dict)
    container_runtime: Optional[str] = None


@dataclass
class Consolidation:
    enabled: bool = False


@dataclass
class Limits:
    """Provisioner-wide resource ceilings (limits.go)."""

    resources: resources_util.ResourceList = field(default_factory=dict)

    def exceeded_by(self, usage: resources_util.ResourceList) -> Optional[str]:
        """Error string if usage >= limit for any used resource; iterates usage
        keys so a limit on an absent resource does not trip (limits.go:29-40)."""
        for name, used in usage.items():
            if name in self.resources and resources_util.cmp(used, self.resources[name]) >= 0:
                return (
                    f"{name} resource usage of {resources_util.format_quantity(used)} exceeds "
                    f"limit of {resources_util.format_quantity(self.resources[name])}"
                )
        return None


@dataclass
class ProviderRef:
    api_version: str = ""
    kind: str = ""
    name: str = ""


@dataclass
class ProvisionerSpec:
    # Constraints applied to all nodes launched by this provisioner
    annotations: Dict[str, str] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    startup_taints: List[Taint] = field(default_factory=list)
    requirements: List[NodeSelectorRequirement] = field(default_factory=list)
    kubelet_configuration: Optional[KubeletConfiguration] = None
    provider: Optional[Dict[str, Any]] = None
    provider_ref: Optional[ProviderRef] = None
    # Deprovisioning behavior
    ttl_seconds_after_empty: Optional[int] = None
    ttl_seconds_until_expired: Optional[int] = None
    consolidation: Optional[Consolidation] = None
    # Scheduling priority across provisioners (higher wins; provisioner.go:132)
    weight: Optional[int] = None
    limits: Optional[Limits] = None
    # Policy-objective block (docs/POLICY.md): wire-cased knobs consumed by
    # policy.PolicyConfig.merged — enabled / costWeight / throughputWeight /
    # riskAversion / spotPreference / counterProposals / maxResizeFraction /
    # throughput.  None = objective off, today's behavior exactly.
    policy: Optional[Dict[str, Any]] = None


@dataclass
class ProvisionerStatus:
    resources: resources_util.ResourceList = field(default_factory=dict)
    last_scale_time: Optional[float] = None


@dataclass
class Provisioner:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ProvisionerSpec = field(default_factory=ProvisionerSpec)
    status: ProvisionerStatus = field(default_factory=ProvisionerStatus)

    @property
    def name(self) -> str:
        return self.metadata.name


def order_by_weight(provisioners: List[Provisioner]) -> List[Provisioner]:
    """Highest weight first (provisioner.go:132 OrderByWeight)."""
    return sorted(provisioners, key=lambda p: p.spec.weight or 0, reverse=True)


@dataclass
class MachineSpec:
    taints: List[Taint] = field(default_factory=list)
    startup_taints: List[Taint] = field(default_factory=list)
    requirements: List[NodeSelectorRequirement] = field(default_factory=list)
    kubelet: Optional[KubeletConfiguration] = None
    resources_requests: resources_util.ResourceList = field(default_factory=dict)
    machine_template_ref: Optional[ProviderRef] = None


@dataclass
class MachineStatus:
    provider_id: str = ""
    capacity: resources_util.ResourceList = field(default_factory=dict)
    allocatable: resources_util.ResourceList = field(default_factory=dict)


@dataclass
class Machine:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: MachineSpec = field(default_factory=MachineSpec)
    status: MachineStatus = field(default_factory=MachineStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

