"""Ordered preference-relaxation ladder for unschedulable pods.

Mirror of karpenter-core pkg/controllers/provisioning/scheduling/preferences.go:38-46:
when a pod fails to schedule, soft constraints are removed one at a time, in
order: required node-affinity OR-terms (all but the last), preferred pod
affinity, preferred pod anti-affinity, preferred node affinity, ScheduleAnyway
topology spreads, and finally (when a provisioner carries a PreferNoSchedule
taint) a toleration for PreferNoSchedule taints.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional

from karpenter_core_tpu_torch.apis.objects import (
    TAINT_EFFECT_PREFER_NO_SCHEDULE,
    SCHEDULE_ANYWAY,
    Pod,
    Toleration,
)

log = logging.getLogger(__name__)


class Preferences:
    def __init__(self, tolerate_prefer_no_schedule: bool = False) -> None:
        self.tolerate_prefer_no_schedule = tolerate_prefer_no_schedule

    def relax(self, pod: Pod) -> bool:
        relaxations: List[Callable[[Pod], Optional[str]]] = [
            self._remove_required_node_affinity_term,
            self._remove_preferred_pod_affinity_term,
            self._remove_preferred_pod_anti_affinity_term,
            self._remove_preferred_node_affinity_term,
            self._remove_topology_spread_schedule_anyway,
        ]
        if self.tolerate_prefer_no_schedule:
            relaxations.append(self._tolerate_prefer_no_schedule_taints)
        for relax in relaxations:
            reason = relax(pod)
            if reason is not None:
                log.debug(
                    "relaxing soft constraints for pod %s/%s since it previously "
                    "failed to schedule, %s",
                    pod.namespace,
                    pod.name,
                    reason,
                )
                return True
        return False

    def _remove_required_node_affinity_term(self, pod: Pod) -> Optional[str]:
        affinity = pod.spec.affinity
        if (
            affinity is None
            or affinity.node_affinity is None
            or affinity.node_affinity.required is None
            or not affinity.node_affinity.required.node_selector_terms
        ):
            return None
        terms = affinity.node_affinity.required.node_selector_terms
        # terms are OR'd; we can drop all but the last
        if len(terms) > 1:
            removed = terms[0]
            affinity.node_affinity.required.node_selector_terms = terms[1:]
            return f"removing: requiredDuringScheduling nodeAffinity term {removed}"
        return None

    def _remove_preferred_node_affinity_term(self, pod: Pod) -> Optional[str]:
        affinity = pod.spec.affinity
        if affinity is None or affinity.node_affinity is None or not affinity.node_affinity.preferred:
            return None
        terms = sorted(affinity.node_affinity.preferred, key=lambda t: -t.weight)
        removed = terms[0]
        affinity.node_affinity.preferred = terms[1:]
        return f"removing: preferred nodeAffinity term weight={removed.weight}"

    def _remove_preferred_pod_affinity_term(self, pod: Pod) -> Optional[str]:
        affinity = pod.spec.affinity
        if affinity is None or affinity.pod_affinity is None or not affinity.pod_affinity.preferred:
            return None
        terms = sorted(affinity.pod_affinity.preferred, key=lambda t: -t.weight)
        removed = terms[0]
        affinity.pod_affinity.preferred = terms[1:]
        return f"removing: preferred podAffinity term weight={removed.weight}"

    def _remove_preferred_pod_anti_affinity_term(self, pod: Pod) -> Optional[str]:
        affinity = pod.spec.affinity
        if (
            affinity is None
            or affinity.pod_anti_affinity is None
            or not affinity.pod_anti_affinity.preferred
        ):
            return None
        terms = sorted(affinity.pod_anti_affinity.preferred, key=lambda t: -t.weight)
        removed = terms[0]
        affinity.pod_anti_affinity.preferred = terms[1:]
        return f"removing: preferred podAntiAffinity term weight={removed.weight}"

    def _remove_topology_spread_schedule_anyway(self, pod: Pod) -> Optional[str]:
        for i, tsc in enumerate(pod.spec.topology_spread_constraints):
            if tsc.when_unsatisfiable == SCHEDULE_ANYWAY:
                constraints = pod.spec.topology_spread_constraints
                constraints[i] = constraints[-1]
                pod.spec.topology_spread_constraints = constraints[:-1]
                return f"removing: topologySpreadConstraint {tsc.topology_key}"
        return None

    @staticmethod
    def tolerates_prefer_no_schedule(pod: Pod) -> bool:
        return any(
            t.operator == "Exists"
            and t.effect == TAINT_EFFECT_PREFER_NO_SCHEDULE
            and not t.key
            and not t.value
            for t in pod.spec.tolerations
        )

    def _tolerate_prefer_no_schedule_taints(self, pod: Pod) -> Optional[str]:
        if self.tolerates_prefer_no_schedule(pod):
            return None
        pod.spec.tolerations = pod.spec.tolerations + [
            Toleration(operator="Exists", effect=TAINT_EFFECT_PREFER_NO_SCHEDULE)
        ]
        return "adding: toleration for PreferNoSchedule taints"
