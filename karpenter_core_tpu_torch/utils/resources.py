"""Resource arithmetic over k8s-style quantity strings.

Mirrors the behavior of the reference's resource helpers
(karpenter-core pkg/utils/resources/resources.go:25-165) with a float-based
representation: a ResourceList is ``dict[str, float]``.  Floats are the natural
unit here because the tensor solver consumes resource vectors as float32 arrays;
milli-CPU precision (1e-3) is far above float64 rounding error for realistic
cluster quantities.
"""

from __future__ import annotations

import math
import re
from typing import TYPE_CHECKING, Dict, Mapping

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, typing only
    from karpenter_core_tpu_torch.apis.objects import Container, Pod

ResourceList = Dict[str, float]

# Canonical resource names
CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
EPHEMERAL_STORAGE = "ephemeral-storage"

_DECIMAL_SUFFIXES = {
    "n": 1e-9,
    "u": 1e-6,
    "m": 1e-3,
    "": 1.0,
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
}
_BINARY_SUFFIXES = {
    "Ki": 2**10,
    "Mi": 2**20,
    "Gi": 2**30,
    "Ti": 2**40,
    "Pi": 2**50,
    "Ei": 2**60,
}
_QUANTITY_RE = re.compile(r"^([+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)([a-zA-Z]*)$")


def parse_quantity(value: "str | int | float") -> float:
    """Parse a k8s quantity ('100m', '1Gi', '2', 1.5) into a float."""
    if isinstance(value, (int, float)):
        return float(value)
    m = _QUANTITY_RE.match(value.strip())
    if not m:
        raise ValueError(f"invalid quantity {value!r}")
    number, suffix = m.groups()
    if suffix in _BINARY_SUFFIXES:
        return float(number) * _BINARY_SUFFIXES[suffix]
    if suffix in _DECIMAL_SUFFIXES:
        return float(number) * _DECIMAL_SUFFIXES[suffix]
    raise ValueError(f"invalid quantity suffix {suffix!r} in {value!r}")


def format_quantity(value: float) -> str:
    """Render a float back into a compact quantity string."""
    if value == 0:
        return "0"
    if abs(value) >= 1 and float(value).is_integer():
        return str(int(value))
    milli = value * 1000
    if milli.is_integer():
        return f"{int(milli)}m"
    return repr(value)


def parse_resource_list(resources: Mapping[str, "str | int | float"]) -> ResourceList:
    return {k: parse_quantity(v) for k, v in resources.items()}


def merge(*resource_lists: Mapping[str, float]) -> ResourceList:
    """Sum resource lists element-wise (resources.go:47 Merge)."""
    result: ResourceList = {}
    for rl in resource_lists:
        for name, qty in rl.items():
            result[name] = result.get(name, 0.0) + qty
    return result


def subtract(lhs: Mapping[str, float], rhs: Mapping[str, float]) -> ResourceList:
    """lhs - rhs over lhs's keys (resources.go:63 Subtract)."""
    return {name: qty - rhs.get(name, 0.0) for name, qty in lhs.items()}


def max_resources(*resource_lists: Mapping[str, float]) -> ResourceList:
    """Element-wise max (resources.go:96 MaxResources)."""
    result: ResourceList = {}
    for rl in resource_lists:
        for name, qty in rl.items():
            if name not in result or qty > result[name]:
                result[name] = qty
    return result


def cmp(lhs: float, rhs: float) -> int:
    """Three-way compare with a relative tolerance absorbing float noise."""
    if math.isclose(lhs, rhs, rel_tol=1e-9, abs_tol=1e-9):
        return 0
    return -1 if lhs < rhs else 1


def _container_requests(container: "Container") -> ResourceList:
    """Limits are merged into requests when no request exists
    (resources.go:119 MergeResourceLimitsIntoRequests)."""
    requests = dict(container.resources.requests)
    for name, qty in container.resources.limits.items():
        requests.setdefault(name, qty)
    return requests


def ceiling(pod: "Pod") -> ResourceList:
    """Max(sum of containers, max of initContainers) (resources.go:81 Ceiling)."""
    requests: ResourceList = {}
    for container in pod.spec.containers:
        requests = merge(requests, _container_requests(container))
    for container in pod.spec.init_containers:
        requests = max_resources(requests, _container_requests(container))
    return requests


def requests_for_pods(*pods: "Pod") -> ResourceList:
    """Total requests of the pods, plus a 'pods' count resource
    (resources.go:26 RequestsForPods)."""
    merged = merge(*(ceiling(p) for p in pods)) if pods else {}
    merged[PODS] = float(len(pods))
    return merged



def limits_for_pods(*pods: "Pod") -> ResourceList:
    limits: ResourceList = {}
    for pod in pods:
        pod_limits: ResourceList = {}
        for container in pod.spec.containers:
            pod_limits = merge(pod_limits, container.resources.limits)
        for container in pod.spec.init_containers:
            pod_limits = max_resources(pod_limits, container.resources.limits)
        limits = merge(limits, pod_limits)
    limits[PODS] = float(len(pods))
    return limits


def is_zero(value: float) -> bool:
    return cmp(value, 0.0) == 0
