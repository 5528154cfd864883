"""The data model and price rules of multi-node consolidation.

A trimmed copy of ``karpenter_core_tpu/controllers/deprovisioning.py``
(karpenter-core's pkg/controllers/deprovisioning/): what
``solver.consolidation.CudaConsolidationSearch`` reads and returns — the
candidate node, the command, the disruption cost that orders candidates, and
the price filters that a replacement must pass.  The controllers, the
disruption budgets and the validation loop are not ported yet.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from enum import Enum
from typing import List

from karpenter_core_tpu_torch.apis import labels as labels_api
from karpenter_core_tpu_torch.apis.objects import Node, Pod
from karpenter_core_tpu_torch.apis.v1alpha5 import Provisioner
from karpenter_core_tpu_torch.cloudprovider import InstanceType
from karpenter_core_tpu_torch.scheduling import Requirements
from karpenter_core_tpu_torch.state.cluster import StateNode

log = logging.getLogger(__name__)


class Action(Enum):
    FAILED = "failed"
    DELETE = "delete"
    REPLACE = "replace"
    RETRY = "retry"
    DO_NOTHING = "do nothing"


@dataclass
class CandidateNode:
    """A node considered for deprovisioning (controller.go:130-139)."""

    node: Node
    state_node: StateNode
    instance_type: InstanceType
    capacity_type: str
    zone: str
    provisioner: Provisioner
    disruption_cost: float
    pods: List[Pod] = field(default_factory=list)


@dataclass
class Command:
    action: Action = Action.DO_NOTHING
    nodes_to_remove: List[Node] = field(default_factory=list)
    replacement_nodes: list = field(default_factory=list)

    def __str__(self) -> str:
        names = ", ".join(n.name for n in self.nodes_to_remove)
        return f"{self.action.value}, terminating {len(self.nodes_to_remove)} nodes {names}"


def get_pod_eviction_cost(pod: Pod) -> float:
    """Pod-deletion-cost and priority scaled into [-10, 10] (helpers.go:125-146)."""
    cost = 1.0
    deletion_cost = pod.metadata.annotations.get("controller.kubernetes.io/pod-deletion-cost")
    if deletion_cost is not None:
        try:
            cost += float(deletion_cost) / (2.0**27)
        except ValueError:
            log.error("parsing pod-deletion-cost %r", deletion_cost)
    if pod.spec.priority is not None:
        cost += float(pod.spec.priority) / (2.0**25)
    return max(-10.0, min(cost, 10.0))


def disruption_cost(pods: List[Pod]) -> float:
    return sum(get_pod_eviction_cost(p) for p in pods)


def lifetime_remaining(candidate_node: Node, provisioner: Provisioner, clock) -> float:
    """Fraction of node lifetime remaining; expiring nodes cost less to disrupt
    (helpers.go:276-287).  ``clock`` has ``now()`` in seconds."""
    if provisioner.spec.ttl_seconds_until_expired is None:
        return 1.0
    age = clock.now() - candidate_node.metadata.creation_timestamp
    total = float(provisioner.spec.ttl_seconds_until_expired)
    return max(0.0, min((total - age) / total, 1.0))


def worst_launch_price(offerings, requirements: Requirements) -> float:
    """Spot-preferred worst-case launch price (helpers.go:292-315)."""
    ct = requirements.get(labels_api.LABEL_CAPACITY_TYPE)
    zone = requirements.get(labels_api.LABEL_TOPOLOGY_ZONE)
    if ct.has(labels_api.CAPACITY_TYPE_SPOT):
        spot = [
            o
            for o in offerings
            if o.capacity_type == labels_api.CAPACITY_TYPE_SPOT and zone.has(o.zone)
        ]
        if spot:
            return max(o.price for o in spot)
    if ct.has(labels_api.CAPACITY_TYPE_ON_DEMAND):
        od = [
            o
            for o in offerings
            if o.capacity_type == labels_api.CAPACITY_TYPE_ON_DEMAND and zone.has(o.zone)
        ]
        if od:
            return max(o.price for o in od)
    return float("inf")


def filter_by_price(
    options: List[InstanceType], requirements: Requirements, price: float
) -> List[InstanceType]:
    return [
        it
        for it in options
        if worst_launch_price(it.offerings.available(), requirements) < price
    ]


def filter_out_same_type(new_node, consolidate: List[CandidateNode]) -> List[InstanceType]:
    """Price-sanity filter: a replacement of the same type as a deleted node
    must be cheaper than that node (multinodeconsolidation.go:132-165).
    ``new_node`` has ``instance_type_options`` and ``requirements``."""
    existing_types = set()
    prices_by_type = {}
    for c in consolidate:
        existing_types.add(c.instance_type.name)
        offering = c.instance_type.offerings.get(c.capacity_type, c.zone)
        if offering is None:
            continue
        prices_by_type[c.instance_type.name] = min(
            prices_by_type.get(c.instance_type.name, float("inf")), offering.price
        )
    max_price = float("inf")
    for it in new_node.instance_type_options:
        if it.name in existing_types:
            max_price = min(max_price, prices_by_type.get(it.name, float("inf")))
    return filter_by_price(new_node.instance_type_options, new_node.requirements, max_price)
