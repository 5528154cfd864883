"""CSI-driver-keyed volume attach-limit counting.

Mirror of karpenter-core's pkg/scheduling/volumeusage.go:33-236: tracks, per
node, the set of PVC ids mounted per CSI driver; ``VolumeCount.exceeds``
compares against per-driver attach limits from CSINode (absent driver limits
are unlimited).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Set, Tuple

from karpenter_core_tpu_torch.apis.objects import Pod


class VolumeCount(Dict[str, int]):
    def exceeds(self, limits: "VolumeCount") -> bool:
        for driver, count in self.items():
            if driver in limits and count > limits[driver]:
                return True
        return False

    def fits(self, rhs: "VolumeCount") -> bool:
        for driver, count in rhs.items():
            if driver in self and count > self[driver]:
                return False
        return True


_Volumes = Dict[str, Set[str]]  # driver -> pvc ids


def _union(a: _Volumes, b: _Volumes) -> _Volumes:
    out: _Volumes = {k: set(v) for k, v in a.items()}
    for k, v in b.items():
        out.setdefault(k, set()).update(v)
    return out


class VolumeUsage:
    """The kube_client is duck-typed: any object with
    get_persistent_volume_claim(namespace, name), get_persistent_volume(name)
    and get_storage_class(name) lookups returning the ``apis.objects``
    storage types (or None when absent)."""

    def __init__(self, kube_client=None) -> None:
        self.kube_client = kube_client
        self.volumes: _Volumes = {}
        self.pod_volumes: Dict[Tuple[str, str], _Volumes] = {}

    def add(self, pod: Pod) -> None:
        pod_volumes, _ = self._validate(pod)
        self.pod_volumes[(pod.namespace, pod.name)] = pod_volumes
        self.volumes = _union(self.volumes, pod_volumes)

    def validate(self, pod: Pod) -> Tuple[Optional[VolumeCount], Optional[str]]:
        pod_volumes, err = self._validate(pod)
        if err is not None:
            return None, err
        result = VolumeCount()
        for driver, ids in _union(self.volumes, pod_volumes).items():
            result[driver] = result.get(driver, 0) + len(ids)
        return result, None

    def _validate(self, pod: Pod) -> Tuple[_Volumes, Optional[str]]:
        pod_pvcs: _Volumes = {}
        if self.kube_client is None:
            return pod_pvcs, None
        for volume in pod.spec.volumes:
            if volume.persistent_volume_claim is None:
                continue
            claim_name = volume.persistent_volume_claim.claim_name
            pvc = self.kube_client.get_persistent_volume_claim(pod.namespace, claim_name)
            if pvc is None:
                return {}, f"pvc {pod.namespace}/{claim_name} not found"
            pvc_id = f"{pod.namespace}/{claim_name}"
            driver_name = ""
            if pvc.spec.volume_name:
                pv = self.kube_client.get_persistent_volume(pvc.spec.volume_name)
                if pv is None:
                    return {}, f"pv {pvc.spec.volume_name} not found"
                driver_name = pv.spec.csi_driver
            elif pvc.spec.storage_class_name:
                sc = self.kube_client.get_storage_class(pvc.spec.storage_class_name)
                if sc is None:
                    return {}, f"storage class {pvc.spec.storage_class_name} not found"
                driver_name = sc.provisioner
            if driver_name:
                pod_pvcs.setdefault(driver_name, set()).add(pvc_id)
        return pod_pvcs, None

    def delete_pod(self, key: Tuple[str, str]) -> None:
        self.pod_volumes.pop(key, None)
        self.volumes = {}
        for vols in self.pod_volumes.values():
            self.volumes = _union(self.volumes, vols)

    def deep_copy(self) -> "VolumeUsage":
        out = VolumeUsage(self.kube_client)
        out.volumes = copy.deepcopy(self.volumes)
        out.pod_volumes = copy.deepcopy(self.pod_volumes)
        return out
