"""MachineTemplate: the launchable shape derived from a Provisioner.

Mirror of karpenter-core pkg/controllers/provisioning/scheduling/machinetemplate.go:46-100.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from karpenter_core_tpu_torch.apis import labels as labels_api
from karpenter_core_tpu_torch.apis.objects import (
    OP_IN,
    Node,
    NodeSpec,
    ObjectMeta,
    OwnerReference,
)
from karpenter_core_tpu_torch.apis.v1alpha5 import (
    KubeletConfiguration,
    Machine,
    MachineSpec,
    Provisioner,
    ProviderRef,
)
from karpenter_core_tpu_torch.scheduling import Requirement, Requirements, Taints
from karpenter_core_tpu_torch.utils import resources as resources_util


@dataclass
class MachineTemplate:
    provisioner_name: str = ""
    instance_type_options: list = field(default_factory=list)  # List[InstanceType]
    provider: Optional[Dict[str, Any]] = None
    provider_ref: Optional[ProviderRef] = None
    annotations: Dict[str, str] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    taints: Taints = field(default_factory=Taints)
    startup_taints: Taints = field(default_factory=Taints)
    requirements: Requirements = field(default_factory=Requirements)
    requests: resources_util.ResourceList = field(default_factory=dict)
    kubelet: Optional[KubeletConfiguration] = None

    @classmethod
    def from_provisioner(cls, provisioner: Provisioner) -> "MachineTemplate":
        labels = dict(provisioner.spec.labels)
        labels[labels_api.PROVISIONER_NAME_LABEL_KEY] = provisioner.name
        requirements = Requirements()
        requirements.add(
            *Requirements.from_node_selector_requirements(
                *provisioner.spec.requirements
            ).values()
        )
        requirements.add(*Requirements.from_labels(labels).values())
        return cls(
            provisioner_name=provisioner.name,
            provider=provisioner.spec.provider,
            provider_ref=provisioner.spec.provider_ref,
            kubelet=provisioner.spec.kubelet_configuration,
            annotations=dict(provisioner.spec.annotations),
            labels=labels,
            taints=Taints.of(provisioner.spec.taints),
            startup_taints=Taints.of(provisioner.spec.startup_taints),
            requirements=requirements,
        )

    def to_node(self) -> Node:
        labels = dict(self.labels)
        labels.update(self.requirements.labels())
        return Node(
            metadata=ObjectMeta(
                labels=labels,
                annotations=dict(self.annotations),
                finalizers=[labels_api.TERMINATION_FINALIZER],
            ),
            spec=NodeSpec(taints=list(self.taints) + list(self.startup_taints)),
        )

    def to_machine(self, owner: Provisioner) -> Machine:
        self.requirements.add(
            Requirement(
                labels_api.LABEL_INSTANCE_TYPE_STABLE,
                OP_IN,
                [it.name for it in self.instance_type_options],
            )
        )
        from karpenter_core_tpu_torch.apis.objects import new_uid

        return Machine(
            metadata=ObjectMeta(
                name=f"{self.provisioner_name}-{new_uid()[:8]}",
                annotations=dict(self.annotations),
                labels=dict(self.labels),
                owner_references=[
                    OwnerReference(
                        api_version="karpenter.sh/v1alpha5",
                        kind="Provisioner",
                        name=owner.name,
                        uid=owner.metadata.uid,
                    )
                ],
            ),
            spec=MachineSpec(
                taints=list(self.taints),
                startup_taints=list(self.startup_taints),
                requirements=self.requirements.node_selector_requirements(),
                kubelet=self.kubelet,
                resources_requests=dict(self.requests),
                machine_template_ref=self.provider_ref,
            ),
        )
