"""Fake cloud provider + deterministic instance-type catalogs for tests/benches.

Mirror of karpenter-core pkg/cloudprovider/fake/{cloudprovider.go:39-175,
instancetype.go:30-164}: records create calls, supports failure injection via
``allowed_create_calls``, selects the cheapest compatible offering on create,
and ships the incremental ``instance_types(n)`` and 1,344-type cartesian
``instance_types_assorted()`` catalogs.
"""

from __future__ import annotations

import itertools
import os
import threading
import uuid
from typing import List, Optional

from karpenter_core_tpu_torch.apis import labels as labels_api
from karpenter_core_tpu_torch.apis.objects import (
    OP_DOES_NOT_EXIST,
    OP_IN,
    Node,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
)
from karpenter_core_tpu_torch.apis.v1alpha5 import Machine, Provisioner
from karpenter_core_tpu_torch.cloudprovider.types import (
    CloudProvider,
    InstanceType,
    InsufficientCapacityError,
    MachineNotFoundError,
    Offering,
    Offerings,
    TransientCloudError,
)
from karpenter_core_tpu_torch.scheduling import Requirement, Requirements
from karpenter_core_tpu_torch.utils import resources as resources_util

LABEL_INSTANCE_SIZE = "size"
EXOTIC_INSTANCE_LABEL_KEY = "special"
INTEGER_INSTANCE_LABEL_KEY = "integer"
RESOURCE_GPU_VENDOR_A = "fake.com/vendor-a"
RESOURCE_GPU_VENDOR_B = "fake.com/vendor-b"

labels_api.register_well_known_labels(
    LABEL_INSTANCE_SIZE, EXOTIC_INSTANCE_LABEL_KEY, INTEGER_INSTANCE_LABEL_KEY
)

GI = float(2**30)
MI = float(2**20)


def price_from_resources(resources: resources_util.ResourceList) -> float:
    """Deterministic synthetic pricing (instancetype.go priceFromResources)."""
    price = 0.0
    for name, quantity in resources.items():
        if name == resources_util.CPU:
            price += 0.025 * quantity
        elif name == resources_util.MEMORY:
            price += 0.001 * (quantity / GI)
        elif name in (RESOURCE_GPU_VENDOR_A, RESOURCE_GPU_VENDOR_B):
            price += 1.0 * quantity
    return price


def new_instance_type(
    name: str,
    resources: Optional[resources_util.ResourceList] = None,
    offerings: Optional[List[Offering]] = None,
    architecture: str = "",
    operating_systems: Optional[List[str]] = None,
) -> InstanceType:
    resources = dict(resources or {})
    resources.setdefault(resources_util.CPU, 4.0)
    resources.setdefault(resources_util.MEMORY, 4 * GI)
    resources.setdefault(resources_util.PODS, 5.0)
    if not offerings:
        price = price_from_resources(resources)
        offerings = [
            Offering("spot", "test-zone-1", price),
            Offering("spot", "test-zone-2", price),
            Offering("on-demand", "test-zone-1", price),
            Offering("on-demand", "test-zone-2", price),
            Offering("on-demand", "test-zone-3", price),
        ]
    architecture = architecture or labels_api.ARCHITECTURE_AMD64
    operating_systems = operating_systems or ["linux", "windows", "darwin"]
    available = Offerings(offerings).available()
    requirements = Requirements(
        Requirement(labels_api.LABEL_INSTANCE_TYPE_STABLE, OP_IN, [name]),
        Requirement(labels_api.LABEL_ARCH_STABLE, OP_IN, [architecture]),
        Requirement(labels_api.LABEL_OS_STABLE, OP_IN, operating_systems),
        Requirement(labels_api.LABEL_TOPOLOGY_ZONE, OP_IN, [o.zone for o in available]),
        Requirement(labels_api.LABEL_CAPACITY_TYPE, OP_IN, [o.capacity_type for o in available]),
        Requirement(
            INTEGER_INSTANCE_LABEL_KEY, OP_IN, [str(int(resources[resources_util.CPU]))]
        ),
    )
    # DoesNotExist + insert == In semantics (complement stays False); "large"
    # instance types additionally carry the exotic label
    size = Requirement(LABEL_INSTANCE_SIZE, OP_DOES_NOT_EXIST)
    exotic = Requirement(EXOTIC_INSTANCE_LABEL_KEY, OP_DOES_NOT_EXIST)
    if resources[resources_util.CPU] > 4 and resources[resources_util.MEMORY] > 8 * GI:
        size.insert("large")
        exotic.insert("optional")
    else:
        size.insert("small")
    requirements.add(size, exotic)
    return InstanceType(
        name=name,
        requirements=requirements,
        offerings=Offerings(offerings),
        capacity=resources,
        overhead={resources_util.CPU: 0.1, resources_util.MEMORY: 10 * MI},
    )


def instance_types(total: int) -> List[InstanceType]:
    """Incrementing catalog: i vcpu / 2i Gi / 10i pods (instancetype.go:151-164)."""
    return [
        new_instance_type(
            f"fake-it-{i}",
            resources={
                resources_util.CPU: float(i + 1),
                resources_util.MEMORY: (i + 1) * 2 * GI,
                resources_util.PODS: float((i + 1) * 10),
            },
        )
        for i in range(total)
    ]


def instance_types_assorted() -> List[InstanceType]:
    """1,344-type cartesian catalog over cpu×mem×zone×capacity-type×os×arch
    (instancetype.go:109-143)."""
    out = []
    for cpu, mem, zone, ct, os_, arch in itertools.product(
        [1, 2, 4, 8, 16, 32, 64],
        [1, 2, 4, 8, 16, 32, 64, 128],
        ["test-zone-1", "test-zone-2", "test-zone-3"],
        [labels_api.CAPACITY_TYPE_SPOT, labels_api.CAPACITY_TYPE_ON_DEMAND],
        ["linux", "windows"],
        [labels_api.ARCHITECTURE_AMD64, labels_api.ARCHITECTURE_ARM64],
    ):
        resources = {
            resources_util.CPU: float(cpu),
            resources_util.MEMORY: mem * GI,
        }
        price = price_from_resources(
            {**resources, resources_util.PODS: 5.0}
        )
        out.append(
            new_instance_type(
                f"{cpu}-cpu-{mem}-mem-{arch}-{os_}-{zone}-{ct}",
                resources=resources,
                offerings=[Offering(ct, zone, price)],
                architecture=arch,
                operating_systems=[os_],
            )
        )
    return out


_node_names = itertools.count(1)
# real clouds mint globally-unique instance ids; with the durable apiserver
# backend node objects outlive the process, so a restarted operator's fresh
# counter must not re-mint a previous life's name+provider-id (the launch
# pre-create would silently adopt the stale node).  The per-process tag keeps
# within-process names deterministic and ordered while making identities
# unique across operator lifetimes.  KC_FAKE_NODE_TAG pins it (tests that
# deliberately simulate a same-identity relaunch).
_run_tag = os.environ.get("KC_FAKE_NODE_TAG") or uuid.uuid4().hex[:6]


class FakeCloudProvider(CloudProvider):
    def __init__(self, instance_types: Optional[List[InstanceType]] = None) -> None:
        self.instance_types_list = instance_types
        self.create_calls: List[Machine] = []
        self.delete_calls: List[Machine] = []
        self.allowed_create_calls = 1 << 62
        self.drifted = False
        self.next_create_error: Optional[Exception] = None
        # first-class failure modes (settable directly by tests):
        #   capacity_errors:  instance-type name -> remaining ICE creates
        #   transient_create_failures: next N creates raise TransientCloudError
        #   stillborn_creates: next N creates succeed but the node never
        #                      registers (provider ids land in stillborn_ids;
        #                      the harness's kubelet emulation skips them)
        self.capacity_errors: dict = {}
        self.transient_create_failures = 0
        self.stillborn_creates = 0
        self.stillborn_ids: set = set()
        self._mu = threading.Lock()
        self._created: dict = {}

    def reset(self) -> None:
        with self._mu:
            self.create_calls = []
            self.delete_calls = []
            self.allowed_create_calls = 1 << 62
            self.next_create_error = None
            self.capacity_errors = {}
            self.transient_create_failures = 0
            self.stillborn_creates = 0
            self.stillborn_ids = set()

    def created_machines(self) -> List[Machine]:
        """Machines alive at the provider (every entry must map to a live node
        object or be deleted)."""
        with self._mu:
            return list(self._created.values())

    def _check_create_faults(self, instance_type: InstanceType) -> bool:
        """Apply the first-class failure modes for this create; returns True when the create should be stillborn."""
        stillborn = False
        with self._mu:
            remaining = self.capacity_errors.get(instance_type.name, 0)
            if remaining > 0:
                self.capacity_errors[instance_type.name] = remaining - 1
                raise InsufficientCapacityError(instance_type.name)
            if self.transient_create_failures > 0:
                self.transient_create_failures -= 1
                raise TransientCloudError("injected transient cloud API error")
            if self.stillborn_creates > 0:
                self.stillborn_creates -= 1
                stillborn = True
        return stillborn

    # -- offering realism knobs (policy subsystem, docs/POLICY.md) -------------

    def _pinned_catalog(self) -> List[InstanceType]:
        """The catalog as a mutable, pinned list.  ``get_instance_types``
        builds the default catalog FRESH per call when no list was supplied,
        so dynamic-offering knobs must first pin one instance of it."""
        if self.instance_types_list is None:
            self.instance_types_list = default_instance_types()
        return self.instance_types_list

    def _update_offerings(self, instance_type, capacity_type, zone, **changes) -> int:
        """Replace matching offerings (frozen dataclasses) with updated
        copies; returns how many offerings changed.  ``capacity_type`` /
        ``zone`` of None match everything."""
        import dataclasses

        updated = 0
        with self._mu:
            for it in self._pinned_catalog():
                if it.name != instance_type:
                    continue
                fresh = []
                for off in it.offerings:
                    if (capacity_type is None or off.capacity_type == capacity_type) and (
                        zone is None or off.zone == zone
                    ):
                        off = dataclasses.replace(off, **changes)
                        updated += 1
                    fresh.append(off)
                it.offerings = Offerings(fresh)
        return updated

    def set_price(
        self,
        instance_type: str,
        price: float,
        capacity_type: Optional[str] = None,
        zone: Optional[str] = None,
    ) -> int:
        """Dynamic per-offering price update (the spot market moving).  The
        policy input digest covers prices, so a set_price between reconciles
        invalidates the incremental warm-start lineage exactly like any other
        supply change (tests/test_policy.py pins the escalation)."""
        return self._update_offerings(
            instance_type, capacity_type, zone, price=float(price)
        )

    def set_interruption_rate(
        self,
        instance_type: str,
        rate: float,
        capacity_type: Optional[str] = "spot",
        zone: Optional[str] = None,
    ) -> int:
        """Stamp an interruption-risk prior on matching offerings (spot by
        default).  Feeds the policy risk planes (policy.planes) and the
        ``interrupt_spot`` sampler below."""
        return self._update_offerings(
            instance_type, capacity_type, zone,
            interruption_rate=min(max(float(rate), 0.0), 1.0),
        )

    def interrupt_spot(self, rng, creates: int = 1) -> List[str]:
        """Sample one round of spot interruptions from the per-offering
        ``interruption_rate`` priors: each spot offering with a positive rate
        is reclaimed with that probability (``rng`` is a seeded
        utils.retry.DeterministicRNG so soak runs replay), and every
        interrupted instance type feeds the first-class ``capacity_errors``
        failure path — its next ``creates`` launches raise
        InsufficientCapacityError.  Returns the interrupted type names."""
        interrupted: List[str] = []
        with self._mu:
            for it in self._pinned_catalog():
                for off in it.offerings:
                    rate = float(getattr(off, "interruption_rate", 0.0) or 0.0)
                    if off.capacity_type != "spot" or rate <= 0.0:
                        continue
                    if rng.random() < rate:
                        self.capacity_errors[it.name] = (
                            self.capacity_errors.get(it.name, 0) + creates
                        )
                        interrupted.append(it.name)
                        break  # one ICE grant per type per round
        return interrupted

    def create(self, machine: Machine) -> Machine:
        with self._mu:
            self.create_calls.append(machine)
            if len(self.create_calls) > self.allowed_create_calls:
                raise RuntimeError("erroring as number of AllowedCreateCalls has been exceeded")
            if self.next_create_error is not None:
                err, self.next_create_error = self.next_create_error, None
                raise err

        requirements = Requirements.from_node_selector_requirements(*machine.spec.requirements)
        candidates = [
            it
            for it in self.get_instance_types(None)
            if requirements.get(labels_api.LABEL_INSTANCE_TYPE_STABLE).has(it.name)
        ]
        if not candidates:
            raise RuntimeError("no compatible instance types")

        def cheapest_price(it: InstanceType) -> float:
            offers = it.offerings.available().requirements(requirements)
            cheapest = offers.cheapest()
            return cheapest.price if cheapest else float("inf")

        candidates.sort(key=cheapest_price)
        instance_type = candidates[0]
        stillborn = self._check_create_faults(instance_type)
        labels = {}
        for key in instance_type.requirements.keys():
            requirement = instance_type.requirements.get(key)
            if requirement.operator() == OP_IN:
                labels[key] = requirement.values_list()[0]
        for offering in instance_type.offerings.available():
            compat = requirements.compatible(
                Requirements(
                    Requirement(labels_api.LABEL_TOPOLOGY_ZONE, OP_IN, [offering.zone]),
                    Requirement(labels_api.LABEL_CAPACITY_TYPE, OP_IN, [offering.capacity_type]),
                )
            )
            if compat is None:
                labels[labels_api.LABEL_TOPOLOGY_ZONE] = offering.zone
                labels[labels_api.LABEL_CAPACITY_TYPE] = offering.capacity_type
                break
        labels.update(machine.metadata.labels)
        name = f"fake-node-{_run_tag}-{next(_node_names):05d}"
        machine.status.provider_id = f"fake://{name}"
        machine.status.capacity = dict(instance_type.capacity)
        machine.status.allocatable = instance_type.allocatable()
        resolved = Machine(
            metadata=ObjectMeta(name=name, labels=labels),
            spec=machine.spec,
            status=machine.status,
        )
        with self._mu:
            self._created[machine.status.provider_id] = resolved
            if stillborn:
                self.stillborn_ids.add(machine.status.provider_id)
        return resolved

    def to_node(self, machine: Machine) -> Node:
        """Render the launched machine as the Node the kubelet would register."""
        return Node(
            metadata=ObjectMeta(name=machine.name, labels=dict(machine.metadata.labels)),
            spec=NodeSpec(provider_id=machine.status.provider_id, taints=list(machine.spec.taints)),
            status=NodeStatus(
                capacity=dict(machine.status.capacity),
                allocatable=dict(machine.status.allocatable),
            ),
        )

    def delete(self, machine: Machine) -> None:
        with self._mu:
            self.delete_calls.append(machine)
            if machine.status.provider_id not in self._created:
                raise MachineNotFoundError(machine.status.provider_id)
            del self._created[machine.status.provider_id]
            self.stillborn_ids.discard(machine.status.provider_id)

    def get_instance_types(self, provisioner: Optional[Provisioner]) -> List[InstanceType]:
        if self.instance_types_list is not None:
            return self.instance_types_list
        return default_instance_types()

    def is_machine_drifted(self, machine: Machine) -> bool:
        return self.drifted

    def name(self) -> str:
        return "fake"


def default_instance_types() -> List[InstanceType]:
    """The reference fake's six-type default catalog (cloudprovider.go:118-155)."""
    return [
        new_instance_type("default-instance-type"),
        new_instance_type(
            "small-instance-type",
            resources={resources_util.CPU: 2.0, resources_util.MEMORY: 2 * GI},
        ),
        new_instance_type(
            "gpu-vendor-instance-type", resources={RESOURCE_GPU_VENDOR_A: 2.0}
        ),
        new_instance_type(
            "gpu-vendor-b-instance-type", resources={RESOURCE_GPU_VENDOR_B: 2.0}
        ),
        new_instance_type(
            "arm-instance-type",
            architecture=labels_api.ARCHITECTURE_ARM64,
            operating_systems=["ios", "linux", "windows", "darwin"],
            resources={resources_util.CPU: 16.0, resources_util.MEMORY: 128 * GI},
        ),
        new_instance_type("single-pod-instance-type", resources={resources_util.PODS: 1.0}),
    ]
