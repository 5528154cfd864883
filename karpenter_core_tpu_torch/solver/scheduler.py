"""Daemonset overhead per machine template (the one piece of the reference's
host scheduler, karpenter_core_tpu/solver/scheduler.py, the solve needs)."""

from __future__ import annotations

from typing import Dict, List

from karpenter_core_tpu_torch.apis.objects import Pod
from karpenter_core_tpu_torch.scheduling import Requirements
from karpenter_core_tpu_torch.solver.machinetemplate import MachineTemplate
from karpenter_core_tpu_torch.utils import resources as resources_util


def _daemon_overhead(
    templates: List[MachineTemplate], daemonset_pods: List[Pod]
) -> Dict[int, resources_util.ResourceList]:
    """Per-template daemonset resource overhead (scheduler.go:250-267); keyed by
    id(template) since templates are mutable."""
    overhead: Dict[int, resources_util.ResourceList] = {}
    for template in templates:
        daemons = []
        for p in daemonset_pods:
            if template.taints.tolerates(p) is not None:
                continue
            if template.requirements.compatible(Requirements.from_pod(p)) is not None:
                continue
            daemons.append(p)
        overhead[id(template)] = resources_util.requests_for_pods(*daemons)
    return overhead
