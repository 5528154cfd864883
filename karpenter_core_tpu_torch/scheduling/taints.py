"""Taint toleration checks (mirror of karpenter-core pkg/scheduling/taints.go:25-47)."""

from __future__ import annotations

from typing import Iterable, List, Optional

from karpenter_core_tpu_torch.apis.objects import Pod, Taint


class Taints(List[Taint]):
    """Decorated list of taints."""

    def tolerates(self, pod: Pod) -> Optional[str]:
        """None if the pod tolerates all taints, else an error string."""
        errs = []
        for taint in self:
            if not any(t.tolerates_taint(taint) for t in pod.spec.tolerations):
                errs.append(f"did not tolerate {taint.key}={taint.value}:{taint.effect}")
        return "; ".join(errs) if errs else None

    @classmethod
    def of(cls, taints: Iterable[Taint]) -> "Taints":
        return cls(taints)
