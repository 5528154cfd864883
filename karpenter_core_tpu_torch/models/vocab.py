"""Value vocabulary: the finite universe behind the mask encoding.

At snapshot-encode time the universe of values per label key is finite — it is
the union of values carried by instance types, provisioners, existing nodes, and
the pod batch.  Each key gets a dense value index; every Requirements set then
encodes as boolean masks over [K, V+1], the final slot meaning "any value not in
the vocabulary" (see karpenter_core_tpu_torch.ops.masks).

Structural keys (hostname, instance-type, zone, capacity-type) are excluded
from the general mask axes by the snapshot encoder — they are handled
structurally (node identity, viability vectors, zone/capacity axes), which
keeps mask state small at 50k-node scale.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from karpenter_core_tpu_torch.apis import labels as labels_api
from karpenter_core_tpu_torch.scheduling import Requirement, Requirements

STRUCTURAL_KEYS = (
    labels_api.LABEL_HOSTNAME,
    labels_api.LABEL_INSTANCE_TYPE_STABLE,
    labels_api.LABEL_TOPOLOGY_ZONE,
    labels_api.LABEL_CAPACITY_TYPE,
)


@dataclass
class Vocabulary:
    keys: List[str]
    values: Dict[str, List[str]]
    key_index: Dict[str, int] = field(default_factory=dict)
    value_index: Dict[str, Dict[str, int]] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.key_index = {k: i for i, k in enumerate(self.keys)}
        self.value_index = {
            k: {v: i for i, v in enumerate(vals)} for k, vals in self.values.items()
        }

    @property
    def n_keys(self) -> int:
        return len(self.keys)

    @property
    def vmax(self) -> int:
        return max((len(v) for v in self.values.values()), default=0)

    @property
    def width(self) -> int:
        """V+1: mask width including the 'other' slot."""
        return self.vmax + 1

    def valid_mask(self) -> np.ndarray:
        """bool[K, V+1]: which slots are real values per key (other slot on)."""
        out = np.zeros((self.n_keys, self.width), dtype=bool)
        for k, key in enumerate(self.keys):
            out[k, : len(self.values[key])] = True
            out[k, -1] = True
        return out

    def is_custom(self) -> np.ndarray:
        """bool[K]: keys subject to the denied-if-undefined rule
        (requirements.go:125)."""
        return np.array(
            [k not in labels_api.WELL_KNOWN_LABELS for k in self.keys], dtype=bool
        )

    @classmethod
    def build(
        cls,
        requirement_sets: Iterable[Requirements],
        exclude_keys: Tuple[str, ...] = STRUCTURAL_KEYS,
        supply_sets: Iterable[Requirements] = (),
    ) -> "Vocabulary":
        """``requirement_sets`` are demand-side (pods/classes, provisioner
        templates): they define which keys exist.  ``supply_sets`` are
        supply-side (instance-type requirements, existing-node labels): they
        only widen the value lists of keys the demand side already references.

        A key no demand-side set defines can never deny compatibility — the
        reference's denial paths (empty intersection, or the custom-key
        denied-if-undefined rule, requirements.go:115-131) both require the
        pod/template side to carry the key — so admitting supply-only keys
        would spend mask width (and kernel compute, which is quadratic in the
        widest key) on planes whose checks are vacuously true.  The fake
        catalog's per-instance ``integer`` label is the canonical offender:
        1000 instance types otherwise cost a [*, K, 1001] mask encoding."""

        def widen(bucket: Dict[str, None], r: Requirement) -> None:
            for v in r.values:
                bucket.setdefault(v, None)
            # materialize small finite Gt/Lt ranges so bounded-integer
            # requirements stay exact under the mask encoding
            if r.greater_than is not None and r.less_than is not None:
                lo, hi = r.greater_than + 1, r.less_than
                if 0 < hi - lo <= 64:
                    for i in range(lo, hi):
                        bucket.setdefault(str(i), None)

        values: Dict[str, Dict[str, None]] = {}
        for reqs in requirement_sets:
            for key in reqs.keys():
                if key in exclude_keys:
                    continue
                widen(values.setdefault(key, {}), reqs.get(key))
        for reqs in supply_sets:
            for key in reqs.keys():
                if key in values:
                    widen(values[key], reqs.get(key))
        keys = sorted(values)
        return cls(keys=keys, values={k: list(v) for k, v in values.items()})

    # -- encoding -------------------------------------------------------------

    def ints_table(self) -> np.ndarray:
        """f32[K, Vmax]: vocabulary values as numbers, +inf where non-numeric
        or padding — the kernel counts these inside Gt/Lt ranges when deciding
        unseen-value overlap (ops.masks._unseen_overlap)."""
        out = np.full((self.n_keys, self.vmax), np.inf, dtype=np.float32)
        for k, key in enumerate(self.keys):
            for i, v in enumerate(self.values[key]):
                try:
                    out[k, i] = float(int(v))
                except ValueError:
                    pass
        return out

    def _key_numbers(self, key: str) -> np.ndarray:
        """f32[V_k]: numeric values per key (+inf non-numeric), cached."""
        cache = getattr(self, "_num_cache", None)
        if cache is None:
            cache = self._num_cache = {}
        out = cache.get(key)
        if out is None:
            values = self.values[key]
            out = np.full(len(values), np.inf, dtype=np.float64)
            for i, v in enumerate(values):
                try:
                    out[i] = float(int(v))
                except ValueError:
                    pass
            cache[key] = out
        return out

    def encode_requirement(self, r: Requirement) -> Tuple[np.ndarray, bool, float, float]:
        """(mask row bool[V+1], negative, gt, lt) for one requirement of a
        known key.  The other-slot is the complement bit; Gt/Lt bounds are
        returned separately (±inf when absent) for exact range math in-kernel.

        O(|values|) for the common In/NotIn case instead of O(V) — vocabulary
        value counts reach the instance-catalog size (e.g. 1k integer labels).
        """
        key = r.key
        index = self.value_index[key]
        n_values = len(index)
        row = np.zeros(self.width, dtype=bool)
        gt = float(r.greater_than) if r.greater_than is not None else -np.inf
        lt = float(r.less_than) if r.less_than is not None else np.inf
        if r.complement:
            row[:n_values] = True
            for v in r.values:
                idx = index.get(v)
                if idx is not None:
                    row[idx] = False
            row[-1] = True
        else:
            for v in r.values:
                idx = index.get(v)
                if idx is not None:
                    row[idx] = True
        if r.greater_than is not None or r.less_than is not None:
            nums = self._key_numbers(key)
            row[:n_values] &= (nums > gt) & (nums < lt)
        negative = r.operator() in ("NotIn", "DoesNotExist")
        return row, negative, gt, lt

    def encode_requirements(
        self, reqs: Requirements
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(mask[K, V+1], defined[K], negative[K], gt[K], lt[K]) — undefined
        keys read as Exists (all slots allowed), per requirements.go:114-120."""
        mask = self.valid_mask().copy()
        defined = np.zeros(self.n_keys, dtype=bool)
        negative = np.zeros(self.n_keys, dtype=bool)
        gt = np.full(self.n_keys, -np.inf, dtype=np.float32)
        lt = np.full(self.n_keys, np.inf, dtype=np.float32)
        for k, key in enumerate(self.keys):
            if not reqs.has(key):
                continue
            row, neg, g, l = self.encode_requirement(reqs.get(key))
            mask[k] = row
            defined[k] = True
            negative[k] = neg
            gt[k] = g
            lt[k] = l
        return mask, defined, negative, gt, lt


def encode_value_set(requirement: Optional[Requirement], universe: List[str]) -> np.ndarray:
    """bool[len(universe)]: which universe values a requirement allows (None =
    all).  Used for the structural zone/capacity-type/instance-type axes."""
    if requirement is None:
        return np.ones(len(universe), dtype=bool)
    return np.array([requirement.has(v) for v in universe], dtype=bool)


def encode_value_sets(
    requirements: List[Optional[Requirement]], universe: List[str]
) -> np.ndarray:
    """bool[N, len(universe)]: ``encode_value_set`` batched over a requirement
    list through ONE interned universe index.  Plain In requirements (no
    complement, no numeric bounds — the overwhelmingly common case) fill by
    value-index lookup in O(|values|) instead of a ``has`` call per universe
    value, which matters when the universe is the instance-type catalog
    (thousands of names per class row).  Bit-identical to the scalar path
    (tests/test_encode_delta.py fuzzes the equivalence)."""
    n_universe = len(universe)
    out = np.ones((len(requirements), n_universe), dtype=bool)
    index: Optional[Dict[str, int]] = None
    for i, req in enumerate(requirements):
        if req is None:
            continue
        if (
            not req.complement
            and req.greater_than is None
            and req.less_than is None
        ):
            if index is None:
                index = {v: j for j, v in enumerate(universe)}
            row = np.zeros(n_universe, dtype=bool)
            for v in req.values:
                j = index.get(v)
                if j is not None:
                    row[j] = True
            out[i] = row
        else:
            # complement/bounded operators keep the exact scalar semantics
            out[i] = encode_value_set(req, universe)
    return out
