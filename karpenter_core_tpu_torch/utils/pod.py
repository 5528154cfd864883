"""Pod ownership predicates (the part of karpenter-core's
pkg/utils/pod/scheduling.go that ``state.cluster.StateNode`` calls)."""

from __future__ import annotations

from karpenter_core_tpu_torch.apis.objects import Pod


def is_owned_by_daemon_set(pod: Pod) -> bool:
    return _is_owned_by(pod, "DaemonSet")


def _is_owned_by(pod: Pod, kind: str) -> bool:
    return any(ref.kind == kind for ref in pod.metadata.owner_references)
