"""Per-node <hostIP, hostPort, protocol> conflict tracking.

Mirror of karpenter-core's pkg/scheduling/hostportusage.go:31-144.  Each
<hostIP, port, protocol> triple used by pods bound to a node must be unique;
an unspecified IP (0.0.0.0 / ::) conflicts with every IP on the same
port/protocol.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from karpenter_core_tpu_torch.apis.objects import Pod

_UNSPECIFIED = {"0.0.0.0", "::", ""}


@dataclass(frozen=True)
class _Entry:
    ip: str
    port: int
    protocol: str

    def matches(self, rhs: "_Entry") -> bool:
        if self.protocol != rhs.protocol or self.port != rhs.port:
            return False
        if self.ip != rhs.ip and self.ip not in _UNSPECIFIED and rhs.ip not in _UNSPECIFIED:
            return False
        return True

    def __str__(self) -> str:
        return f"IP={self.ip} Port={self.port} Proto={self.protocol}"


def _host_ports(pod: Pod) -> List[_Entry]:
    usage = []
    for container in pod.spec.containers:
        for port in container.ports:
            if port.host_port == 0:
                continue
            # K8s defaults hostIP to 0.0.0.0 and protocol to TCP.
            usage.append(_Entry(port.host_ip or "0.0.0.0", port.host_port, port.protocol or "TCP"))
    return usage


class HostPortUsage:
    def __init__(self) -> None:
        self.reserved: Dict[Tuple[str, str], List[_Entry]] = {}

    def validate(self, pod: Pod) -> Optional[str]:
        """Error string on host-port conflict, else None."""
        _, err = self._validate(pod)
        return err

    def add(self, pod: Pod) -> None:
        new_usage, _ = self._validate(pod)
        self.reserved[(pod.namespace, pod.name)] = new_usage

    def delete_pod(self, key: Tuple[str, str]) -> None:
        self.reserved.pop(key, None)

    def _validate(self, pod: Pod) -> Tuple[List[_Entry], Optional[str]]:
        new_usage = _host_ports(pod)
        pod_key = (pod.namespace, pod.name)
        for new_entry in new_usage:
            for key, entries in self.reserved.items():
                if key == pod_key:
                    continue
                for existing in entries:
                    if new_entry.matches(existing):
                        return [], (
                            f"{new_entry} conflicts with existing HostPort configuration {existing}"
                        )
        return new_usage, None

    def deep_copy(self) -> "HostPortUsage":
        out = HostPortUsage()
        out.reserved = copy.deepcopy(self.reserved)
        return out
