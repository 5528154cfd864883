"""Keyed requirement sets with intersection-on-add and compatibility checks.

Mirrors karpenter-core pkg/scheduling/requirements.go:32-223.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

from karpenter_core_tpu_torch.apis import labels as labels_api
from karpenter_core_tpu_torch.apis.objects import (
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_IN,
    OP_NOT_IN,
    NodeSelectorRequirement,
    Pod,
)
from karpenter_core_tpu_torch.scheduling.requirement import Requirement


class Requirements:
    """Map of key -> Requirement; Add() intersects with any existing entry
    (requirements.go:87-94)."""

    __slots__ = ("_items",)

    def __init__(self, *requirements: Requirement) -> None:
        self._items: Dict[str, Requirement] = {}
        self.add(*requirements)

    # -- constructors ---------------------------------------------------------

    @classmethod
    def from_node_selector_requirements(
        cls, *reqs: NodeSelectorRequirement
    ) -> "Requirements":
        return cls(*(Requirement(r.key, r.operator, r.values) for r in reqs))

    @classmethod
    def from_labels(cls, labels: Dict[str, str]) -> "Requirements":
        return cls(*(Requirement(k, OP_IN, [v]) for k, v in labels.items()))

    @classmethod
    def from_pod(cls, pod: Pod) -> "Requirements":
        """Node-selector + heaviest preferred term + first required term
        (requirements.go:61-78)."""
        requirements = cls.from_labels(pod.spec.node_selector)
        affinity = pod.spec.affinity
        if affinity is None or affinity.node_affinity is None:
            return requirements
        node_affinity = affinity.node_affinity
        if node_affinity.preferred:
            heaviest = max(node_affinity.preferred, key=lambda term: term.weight)
            requirements.add(
                *cls.from_node_selector_requirements(
                    *heaviest.preference.match_expressions
                ).values()
            )
        if node_affinity.required is not None and node_affinity.required.node_selector_terms:
            first = node_affinity.required.node_selector_terms[0]
            requirements.add(
                *cls.from_node_selector_requirements(*first.match_expressions).values()
            )
        return requirements

    # -- collection protocol --------------------------------------------------

    def add(self, *requirements: Requirement) -> None:
        for requirement in requirements:
            existing = self._items.get(requirement.key)
            if existing is not None:
                requirement = requirement.intersection(existing)
            self._items[requirement.key] = requirement

    def keys(self) -> set:
        return set(self._items)

    def values(self) -> List[Requirement]:
        return list(self._items.values())

    def has(self, key: str) -> bool:
        return key in self._items

    def get(self, key: str) -> Requirement:
        """Undefined keys behave as Exists (requirements.go:114-120)."""
        if key not in self._items:
            return Requirement(key, OP_EXISTS)
        return self._items[key]

    def delete(self, key: str) -> None:
        self._items.pop(key, None)

    def copy(self) -> "Requirements":
        return Requirements(*self.values())

    def __iter__(self) -> Iterator[str]:
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, key: str) -> bool:
        return key in self._items

    # -- compatibility --------------------------------------------------------

    def compatible(self, requirements: "Requirements") -> Optional[str]:
        """None if the provided requirements can be met, else an error string
        (requirements.go:123-133).  Custom labels must intersect but are denied
        when undefined on the receiver; well-known labels are allowed when
        undefined.
        """
        errs: List[str] = []
        for key in requirements.keys() - labels_api.WELL_KNOWN_LABELS:
            operator = requirements.get(key).operator()
            if self.has(key) or operator in (OP_NOT_IN, OP_DOES_NOT_EXIST):
                continue
            errs.append(f"label {key!r} does not have known values{_label_hint(self, key)}")
        intersect_err = self.intersects(requirements)
        if intersect_err:
            errs.append(intersect_err)
        return "; ".join(errs) if errs else None

    def intersects(self, requirements: "Requirements") -> Optional[str]:
        """Error string when overlapping keys have empty intersections,
        except when both operators are negative (requirements.go:189-206)."""
        errs: List[str] = []
        for key in self.keys() & requirements.keys():
            existing = self.get(key)
            incoming = requirements.get(key)
            if existing.intersection(incoming).len() == 0:
                if incoming.operator() in (OP_NOT_IN, OP_DOES_NOT_EXIST) and existing.operator() in (
                    OP_NOT_IN,
                    OP_DOES_NOT_EXIST,
                ):
                    continue
                errs.append(f"key {key}, {incoming!r} not in {existing!r}")
        return "; ".join(errs) if errs else None

    def labels(self) -> Dict[str, str]:
        """Concrete labels renderable from the requirements (requirements.go:208-218)."""
        out: Dict[str, str] = {}
        for key, requirement in self._items.items():
            if not labels_api.is_restricted_node_label(key):
                value = requirement.any()
                if value:
                    out[key] = value
        return out

    def node_selector_requirements(self) -> List[NodeSelectorRequirement]:
        return [r.node_selector_requirement() for r in self._items.values()]

    def __repr__(self) -> str:
        shown = [
            repr(r)
            for r in self._items.values()
            if r.key not in labels_api.RESTRICTED_LABELS
        ]
        return ", ".join(shown)


def _edit_distance(s: str, t: str) -> int:
    m, n = len(s), len(t)
    if m == 0:
        return n
    if n == 0:
        return m
    prev = list(range(n))
    cur = [0] * n
    for i in range(1, m):
        for j in range(1, n):
            diff = 0 if s[i] == t[j] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + diff)
        prev, cur = cur, prev
    return prev[n - 1]


def _label_hint(r: Requirements, key: str) -> str:
    """Typo suggestions against well-known and defined labels
    (requirements.go:174-186)."""
    for well_known in labels_api.WELL_KNOWN_LABELS:
        if key in well_known or _edit_distance(key, well_known) < len(well_known) // 5:
            return f" (typo of {well_known!r}?)"
    for existing in r.keys():
        if key in existing or _edit_distance(key, existing) < len(existing) // 5:
            return f" (typo of {existing!r}?)"
    return ""
