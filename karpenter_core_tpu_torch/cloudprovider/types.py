"""Cloud-provider SPI: the vendor interface and its data model.

Mirror of karpenter-core pkg/cloudprovider/types.go:50-175.  An InstanceType
is a launchable shape (requirements + capacity + per-zone/capacity-type priced
offerings); a CloudProvider can create/delete machines and enumerate the
instance-type catalog per provisioner.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import List, Optional

from karpenter_core_tpu_torch.apis import labels as labels_api
from karpenter_core_tpu_torch.apis.objects import OP_IN
from karpenter_core_tpu_torch.apis.v1alpha5 import Machine, Provisioner
from karpenter_core_tpu_torch.scheduling import Requirements
from karpenter_core_tpu_torch.utils import resources as resources_util


class MachineNotFoundError(Exception):
    """Raised by CloudProvider.get/delete when the machine does not exist
    (types.go:148)."""


class InsufficientCapacityError(Exception):
    """Raised by CloudProvider.create when the offering has no capacity for
    the selected instance type (the real clouds' ICE).  Deterministic for the
    caller: retrying the same instance type won't help until capacity
    returns, so launch retries should redraw from the remaining options."""

    def __init__(self, instance_type: str, message: str = "") -> None:
        super().__init__(
            message or f"insufficient capacity for instance type {instance_type!r}"
        )
        self.instance_type = instance_type


class TransientCloudError(Exception):
    """Raised by CloudProvider.create/delete for retryable API faults
    (throttling, 5xx): the same call may succeed moments later."""


@dataclass(frozen=True)
class Offering:
    """A (capacity type, zone) purchase option for an instance type
    (types.go:106).

    ``interruption_rate`` is the cloud's reclaim-probability signal for the
    offering (spot interruption frequency, [0, 1]); it seeds the policy
    subsystem's risk priors (policy.planes) and defaults to 0 so offerings
    built before the policy layer behave exactly as before."""

    capacity_type: str
    zone: str
    price: float
    available: bool = True
    interruption_rate: float = 0.0


class Offerings(List[Offering]):
    """Decorated offering list with the reference's filter helpers
    (types.go:119-145)."""

    def get(self, capacity_type: str, zone: str) -> Optional[Offering]:
        for o in self:
            if o.capacity_type == capacity_type and o.zone == zone:
                return o
        return None

    def available(self) -> "Offerings":
        return Offerings(o for o in self if o.available)

    def requirements(self, requirements: Requirements) -> "Offerings":
        return Offerings(
            o
            for o in self
            if (
                not requirements.has(labels_api.LABEL_TOPOLOGY_ZONE)
                or requirements.get(labels_api.LABEL_TOPOLOGY_ZONE).has(o.zone)
            )
            and (
                not requirements.has(labels_api.LABEL_CAPACITY_TYPE)
                or requirements.get(labels_api.LABEL_CAPACITY_TYPE).has(o.capacity_type)
            )
        )

    def cheapest(self) -> Optional[Offering]:
        return min(self, key=lambda o: o.price, default=None)


@dataclass
class InstanceType:
    name: str
    requirements: Requirements = field(default_factory=Requirements)
    offerings: Offerings = field(default_factory=Offerings)
    capacity: resources_util.ResourceList = field(default_factory=dict)
    overhead: resources_util.ResourceList = field(default_factory=dict)

    def allocatable(self) -> resources_util.ResourceList:
        """Capacity minus system overhead (types.go:87)."""
        return resources_util.subtract(self.capacity, self.overhead)

    def __post_init__(self) -> None:
        # instance types always carry their own name requirement so catalogs can
        # be filtered by node.kubernetes.io/instance-type
        if not self.requirements.has(labels_api.LABEL_INSTANCE_TYPE_STABLE):
            from karpenter_core_tpu_torch.scheduling import Requirement

            self.requirements.add(
                Requirement(labels_api.LABEL_INSTANCE_TYPE_STABLE, OP_IN, [self.name])
            )


class CloudProvider(abc.ABC):
    """Vendor SPI (types.go:50-68)."""

    @abc.abstractmethod
    def create(self, machine: Machine) -> Machine:
        """Launch a machine; returns the resolved machine with provider id,
        capacity, and concrete labels."""

    @abc.abstractmethod
    def delete(self, machine: Machine) -> None:
        """Terminate the backing instance; raises MachineNotFoundError if gone."""

    @abc.abstractmethod
    def get_instance_types(self, provisioner: Optional[Provisioner]) -> List[InstanceType]:
        """The catalog available to the provisioner."""

    def is_machine_drifted(self, machine: Machine) -> bool:
        return False

    def name(self) -> str:
        return type(self).__name__.lower()
