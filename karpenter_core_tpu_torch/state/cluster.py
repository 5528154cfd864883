"""A node of the live cluster, with the usage of the pods bound to it.

The port's copy of ``StateNode`` from the JAX package's ``state/cluster.py``
(karpenter-core's pkg/controllers/state/node.go:38-190): what the solve reads
of an existing node — its allocatable and capacity (inflight values while it
initializes), its taints minus the ephemeral ones, the requests of its bound
pods and daemonset pods, and its host-port and CSI-volume usage.  The
``Cluster`` that owns these nodes, and the informers that feed it, belong to
the controllers and are not ported yet.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple

from karpenter_core_tpu_torch.apis import labels as labels_api
from karpenter_core_tpu_torch.apis.objects import Node, Pod, Taint
from karpenter_core_tpu_torch.scheduling import HostPortUsage, VolumeCount, VolumeUsage
from karpenter_core_tpu_torch.utils import pod as pod_util
from karpenter_core_tpu_torch.utils import resources as resources_util

TAINT_NODE_NOT_READY = "node.kubernetes.io/not-ready"
TAINT_NODE_UNREACHABLE = "node.kubernetes.io/unreachable"


class StateNode:
    """state.Node: a node with cached pod usage and inflight capacity."""

    def __init__(self, node: Node, kube_client=None) -> None:
        self.node = node
        self.inflight_allocatable: resources_util.ResourceList = {}
        self.inflight_capacity: resources_util.ResourceList = {}
        self.startup_taints: List[Taint] = []
        self.daemonset_requests: Dict[Tuple[str, str], resources_util.ResourceList] = {}
        self.daemonset_limits: Dict[Tuple[str, str], resources_util.ResourceList] = {}
        self.pod_requests: Dict[Tuple[str, str], resources_util.ResourceList] = {}
        self.pod_limits: Dict[Tuple[str, str], resources_util.ResourceList] = {}
        self._host_port_usage = HostPortUsage()
        self._volume_usage = VolumeUsage(kube_client)
        self._volume_limits = VolumeCount()
        self.marked_for_deletion = False
        self.nominated_until = 0.0

    # -- predicates ------------------------------------------------------------

    def initialized(self) -> bool:
        return self.node.metadata.labels.get(labels_api.LABEL_NODE_INITIALIZED) == "true"

    def owned(self) -> bool:
        return bool(self.node.metadata.labels.get(labels_api.PROVISIONER_NAME_LABEL_KEY))

    def marked(self) -> bool:
        return self.marked_for_deletion or self.node.metadata.deletion_timestamp is not None

    # -- resources (node.go:80-145) ---------------------------------------------

    def taints(self) -> List[Taint]:
        """Node taints minus ephemeral/startup taints (node.go:61-78)."""
        ephemeral = [
            Taint(key=TAINT_NODE_NOT_READY, effect="NoSchedule"),
            Taint(key=TAINT_NODE_UNREACHABLE, effect="NoSchedule"),
        ]
        if not self.initialized() and self.owned():
            ephemeral.extend(self.startup_taints)
        return [
            t
            for t in self.node.spec.taints
            if not any(
                e.key == t.key and e.value == t.value and e.effect == t.effect
                for e in ephemeral
            )
        ]

    def capacity(self) -> resources_util.ResourceList:
        if not self.initialized() and self.owned():
            out = dict(self.node.status.capacity)
            for name, qty in self.inflight_capacity.items():
                if resources_util.is_zero(out.get(name, 0.0)):
                    out[name] = qty
            return out
        return dict(self.node.status.capacity)

    def allocatable(self) -> resources_util.ResourceList:
        if not self.initialized() and self.owned():
            out = dict(self.node.status.allocatable)
            for name, qty in self.inflight_allocatable.items():
                if resources_util.is_zero(out.get(name, 0.0)):
                    out[name] = qty
            return out
        return dict(self.node.status.allocatable)

    def available(self) -> resources_util.ResourceList:
        return resources_util.subtract(self.allocatable(), self.pod_requests_total())

    def pod_requests_total(self) -> resources_util.ResourceList:
        return resources_util.merge(*self.pod_requests.values())

    def pod_limits_total(self) -> resources_util.ResourceList:
        return resources_util.merge(*self.pod_limits.values())

    def daemon_set_requests(self) -> resources_util.ResourceList:
        return resources_util.merge(*self.daemonset_requests.values())

    def daemon_set_limits(self) -> resources_util.ResourceList:
        return resources_util.merge(*self.daemonset_limits.values())

    def host_port_usage(self) -> HostPortUsage:
        return self._host_port_usage

    def volume_usage(self) -> VolumeUsage:
        return self._volume_usage

    def volume_limits(self) -> VolumeCount:
        return self._volume_limits

    def pod_count(self) -> int:
        return len(self.pod_requests)

    # -- pod tracking (node.go:161-180) ------------------------------------------

    def update_for_pod(self, pod: Pod) -> None:
        key = (pod.namespace, pod.name)
        self.pod_requests[key] = resources_util.requests_for_pods(pod)
        self.pod_limits[key] = resources_util.limits_for_pods(pod)
        if pod_util.is_owned_by_daemon_set(pod):
            self.daemonset_requests[key] = resources_util.requests_for_pods(pod)
            self.daemonset_limits[key] = resources_util.limits_for_pods(pod)
        self._host_port_usage.add(pod)
        self._volume_usage.add(pod)

    def cleanup_for_pod(self, key: Tuple[str, str]) -> None:
        self._host_port_usage.delete_pod(key)
        self._volume_usage.delete_pod(key)
        self.pod_requests.pop(key, None)
        self.pod_limits.pop(key, None)
        self.daemonset_requests.pop(key, None)
        self.daemonset_limits.pop(key, None)

    def deep_copy(self) -> "StateNode":
        out = StateNode(copy.deepcopy(self.node), self._volume_usage.kube_client)
        out.inflight_allocatable = dict(self.inflight_allocatable)
        out.inflight_capacity = dict(self.inflight_capacity)
        out.startup_taints = list(self.startup_taints)
        out.daemonset_requests = copy.deepcopy(self.daemonset_requests)
        out.daemonset_limits = copy.deepcopy(self.daemonset_limits)
        out.pod_requests = copy.deepcopy(self.pod_requests)
        out.pod_limits = copy.deepcopy(self.pod_limits)
        out._host_port_usage = self._host_port_usage.deep_copy()
        out._volume_usage = self._volume_usage.deep_copy()
        out._volume_limits = VolumeCount(self._volume_limits)
        out.marked_for_deletion = self.marked_for_deletion
        out.nominated_until = self.nominated_until
        return out
