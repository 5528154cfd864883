"""Set-or-complement representation of a single node-selector requirement.

Semantics mirror the reference's Requirement exactly
(karpenter-core pkg/scheduling/requirement.go:36-243): a requirement is either
a concrete value set (``complement=False``: In / DoesNotExist) or the complement
of one (``complement=True``: NotIn / Exists), with optional integer Gt/Lt bounds
that only survive on complement sets.  This is also the *specification* for the
tensorized mask encoding in ``karpenter_core_tpu_torch.ops.masks`` — the "other"
mask slot there is this class's complement bit.
"""

from __future__ import annotations

from typing import FrozenSet, Iterable, Optional

from karpenter_core_tpu_torch.apis import labels as labels_api
from karpenter_core_tpu_torch.apis.objects import (
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_GT,
    OP_IN,
    OP_LT,
    OP_NOT_IN,
)

# Stand-in for Go's math.MaxInt64 in Len() arithmetic: a complement set is
# "infinite minus the excluded values".
INFINITE = 1 << 63


class Requirement:
    __slots__ = ("key", "complement", "values", "greater_than", "less_than")

    def __init__(
        self,
        key: str,
        operator: str,
        values: Iterable[str] = (),
    ) -> None:
        key = labels_api.NORMALIZED_LABELS.get(key, key)
        self.key = key
        self.complement = operator not in (OP_IN, OP_DOES_NOT_EXIST)
        self.greater_than: Optional[int] = None
        self.less_than: Optional[int] = None
        vals: FrozenSet[str] = frozenset()
        values = list(values)
        if operator in (OP_IN, OP_NOT_IN):
            vals = frozenset(values)
        elif operator == OP_GT:
            self.greater_than = int(values[0])  # prevalidated upstream
        elif operator == OP_LT:
            self.less_than = int(values[0])
        self.values = vals

    # -- construction helpers -------------------------------------------------

    @classmethod
    def _raw(
        cls,
        key: str,
        complement: bool,
        values: FrozenSet[str],
        greater_than: Optional[int] = None,
        less_than: Optional[int] = None,
    ) -> "Requirement":
        r = cls.__new__(cls)
        r.key = key
        r.complement = complement
        r.values = values
        r.greater_than = greater_than
        r.less_than = less_than
        return r

    # -- algebra --------------------------------------------------------------

    def intersection(self, other: "Requirement") -> "Requirement":
        """Exact intersection over all four complement combinations
        (requirement.go:117-150)."""
        complement = self.complement and other.complement

        greater_than = _max_opt(self.greater_than, other.greater_than)
        less_than = _min_opt(self.less_than, other.less_than)
        if greater_than is not None and less_than is not None and greater_than >= less_than:
            return Requirement(self.key, OP_DOES_NOT_EXIST)

        if self.complement and other.complement:
            values = self.values | other.values
        elif self.complement and not other.complement:
            values = other.values - self.values
        elif not self.complement and other.complement:
            values = self.values - other.values
        else:
            values = self.values & other.values
        values = frozenset(v for v in values if _within(v, greater_than, less_than))
        if not complement:
            greater_than, less_than = None, None
        return Requirement._raw(self.key, complement, values, greater_than, less_than)

    def has(self, value: str) -> bool:
        """True if the requirement allows the value (requirement.go:171-176)."""
        if self.complement:
            return value not in self.values and _within(value, self.greater_than, self.less_than)
        return value in self.values and _within(value, self.greater_than, self.less_than)

    def any(self) -> str:
        """An arbitrary allowed value, for label rendering (requirement.go:152-168)."""
        op = self.operator()
        if op == OP_IN:
            return next(iter(self.values))
        if op in (OP_NOT_IN, OP_EXISTS):
            # the smallest in-range value the complement set allows — the
            # reference draws randomly here, but an unseeded draw makes label
            # rendering unreplayable (chaos determinism gate) and can even
            # land on an excluded value; deterministic-and-allowed is
            # strictly better for both callers and tests
            lo = 0 if self.greater_than is None else self.greater_than + 1
            hi = (1 << 63) - 1 if self.less_than is None else self.less_than
            if lo >= hi:
                # empty integer domain (e.g. Gt 4 + Lt 5): surface the
                # contradiction loudly, as the reference's randrange(lo, hi)
                # did, instead of rendering a label the requirement excludes
                raise ValueError(
                    f"requirement {self.key} has no allowed value in [{lo}, {hi})"
                )
            # valid values are [lo, hi): stop at hi-1 so a fully-excluded
            # range returns an in-range (if excluded) value, as the
            # reference's randrange(lo, hi) did, never one past less_than
            candidate = lo
            while str(candidate) in self.values and candidate + 1 < hi:
                candidate += 1
            return str(candidate)
        return ""

    def insert(self, *items: str) -> None:
        self.values = self.values | frozenset(items)

    def operator(self) -> str:
        if self.complement:
            return OP_NOT_IN if self.len() < INFINITE else OP_EXISTS
        return OP_IN if self.len() > 0 else OP_DOES_NOT_EXIST

    def len(self) -> int:
        if self.complement:
            return INFINITE - len(self.values)
        return len(self.values)

    def values_list(self) -> list:
        return sorted(self.values)

    # -- conversion -----------------------------------------------------------

    def node_selector_requirement(self):
        from karpenter_core_tpu_torch.apis.objects import NodeSelectorRequirement

        if self.greater_than is not None:
            return NodeSelectorRequirement(self.key, OP_GT, [str(self.greater_than)])
        if self.less_than is not None:
            return NodeSelectorRequirement(self.key, OP_LT, [str(self.less_than)])
        if self.complement:
            if self.values:
                return NodeSelectorRequirement(self.key, OP_NOT_IN, self.values_list())
            return NodeSelectorRequirement(self.key, OP_EXISTS)
        if self.values:
            return NodeSelectorRequirement(self.key, OP_IN, self.values_list())
        return NodeSelectorRequirement(self.key, OP_DOES_NOT_EXIST)

    def __repr__(self) -> str:
        op = self.operator()
        if op in (OP_EXISTS, OP_DOES_NOT_EXIST):
            s = f"{self.key} {op}"
        else:
            values = self.values_list()
            if len(values) > 5:
                values = values[:5] + [f"and {len(values) - 5} others"]
            s = f"{self.key} {op} {values}"
        if self.greater_than is not None:
            s += f" >{self.greater_than}"
        if self.less_than is not None:
            s += f" <{self.less_than}"
        return s

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Requirement)
            and self.key == other.key
            and self.complement == other.complement
            and self.values == other.values
            and self.greater_than == other.greater_than
            and self.less_than == other.less_than
        )

    def __hash__(self) -> int:
        return hash((self.key, self.complement, self.values, self.greater_than, self.less_than))


def _within(value: str, greater_than: Optional[int], less_than: Optional[int]) -> bool:
    """Bounds check; non-integer values fail when bounds are set
    (requirement.go:227-243)."""
    if greater_than is None and less_than is None:
        return True
    try:
        v = int(value)
    except ValueError:
        return False
    if greater_than is not None and greater_than >= v:
        return False
    if less_than is not None and less_than <= v:
        return False
    return True


def _min_opt(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)


def _max_opt(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)
