"""Columnar pod-batch ingestion: the steady-state fast path.

At production scale the per-pod work (signature derivation, requirements
construction) must happen once per pod *lifetime* — at watch-event time — not
once per reconcile.  Two front-ends feed the solver without per-pod work on
the solve path:

  - ``PodIngest``: the in-process incremental store.  ``add``/``remove``
    maintain exact signature→class-slot dedup as pods arrive from the
    informer; ``classes()`` assembles solver-ready PodClass lists in O(C).
    This is the analog of the reference maintaining cluster state across
    reconciles (state/cluster.go:152-196) rather than re-reading the world.
  - ``ColumnarPodBatch``: pods as columns (requests matrix + signature rows)
    for callers that arrive over a binary channel; classification reduces to
    grouping identical signature rows (models.native) instead of per-object
    Python hashing.

The per-pod cost of both front-ends is bounded by ``_fast_sig_key``: a cheap
EXACT pre-key over the dominant pod shapes (single plain container, any mix
of labels/selectors/tolerations/spreads/affinity) that lets the full
``models.snapshot._class_signature`` tuple — and its eight ``sorted()``
calls — run once per distinct shape instead of once per pod.  Shapes the
fast key cannot capture exactly (multi-container, resource limits, host
ports, PVC claims) return ``None`` and pay the full derivation; there is no
collision risk anywhere — equal fast keys imply equal signatures by
construction (tests/test_encode_delta.py fuzzes the guarantee).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from karpenter_core_tpu_torch.apis.objects import Pod
from karpenter_core_tpu_torch.models import native
from karpenter_core_tpu_torch.utils import resources as resources_util

# the fast-key cache is pruned when it outgrows the live shape population —
# label churn (e.g. pod-template-hash) mints fresh keys forever, and retired
# entries must not accumulate (same motive as PodIngest slot eviction)
_FAST_CACHE_FLOOR = 1024


def _fast_selector_key(selector):
    """Raw (unsorted) content of a LabelSelector — injective into
    models.snapshot._selector_sig: equal raw tuples sort equal."""
    if selector is None:
        return None
    exprs = selector.match_expressions
    return (
        tuple(selector.match_labels.items()),
        tuple([(e.key, e.operator, tuple(e.values)) for e in exprs])
        if exprs
        else (),
    )


def _fast_term_key(t):
    """Raw content of one pod-(anti-)affinity term (selector + namespace
    scope) — the fields ``_class_signature``'s term/ns_sig tuples sort."""
    ns = t.namespaces
    ns_sel = t.namespace_selector
    return (
        t.topology_key,
        _fast_selector_key(t.label_selector),
        tuple(ns) if ns else (),
        _fast_selector_key(ns_sel) if ns_sel is not None else None,
    )


def _fast_affinity_key(affinity):
    """Raw content of an Affinity block (node + pod + anti terms), covering
    every field ``_class_signature`` folds in, without the sorts."""
    parts = []
    na = affinity.node_affinity
    if na is not None:
        req = (
            tuple([
                tuple([
                    (e.key, e.operator, tuple(e.values))
                    for e in term.match_expressions
                ])
                for term in na.required.node_selector_terms
            ])
            if na.required is not None
            else ()
        )
        pref = tuple([
            (
                p.weight,
                tuple([
                    (e.key, e.operator, tuple(e.values))
                    for e in p.preference.match_expressions
                ]),
            )
            for p in na.preferred
        ])
        parts.append(("node", req, pref))
    pa = affinity.pod_affinity
    if pa is not None:
        parts.append((
            "aff",
            tuple([_fast_term_key(t) for t in pa.required]),
            tuple([(w.weight, _fast_term_key(w.pod_affinity_term)) for w in pa.preferred]),
        ))
    anti = affinity.pod_anti_affinity
    if anti is not None:
        parts.append((
            "anti",
            tuple([_fast_term_key(t) for t in anti.required]),
            tuple([(w.weight, _fast_term_key(w.pod_affinity_term)) for w in anti.preferred]),
        ))
    return tuple(parts)


def _fast_sig_key_py(pod: Pod):
    """A cheap pre-key that EXACTLY determines ``_class_signature``: two pods
    with equal fast keys always have equal signatures (the key carries the
    raw, unsorted content of every field the signature sorts; structural
    branch choices below — one constraint vs many, one affinity term vs a
    full block — are themselves content, so equal-content pods always take
    the same branch and build the same key shape).  Returns None for shapes
    the key cannot capture exactly — multi/init containers, resource limits,
    host ports, PVC claims — which then pay the full signature derivation.
    No sorting, no quantity parsing: the dominant simple shape costs a
    handful of attribute reads and small tuples."""
    spec = pod.spec
    containers = spec.containers
    if len(containers) != 1 or spec.init_containers:
        return None
    c0 = containers[0]
    resources = c0.resources
    if resources.limits:
        return None
    ports = c0.ports
    if ports:
        for p in ports:
            if p.host_port:
                return None
    volumes = spec.volumes
    if volumes:
        for v in volumes:
            if v.persistent_volume_claim is not None:
                return None
    metadata = pod.metadata
    labels = metadata.labels
    node_selector = spec.node_selector
    base = (
        metadata.namespace or "",
        tuple(labels.items()) if labels else (),
        tuple(node_selector.items()) if node_selector else (),
        tuple(resources.requests.items()),
    )
    affinity = spec.affinity
    spreads = spec.topology_spread_constraints
    tolerations = spec.tolerations
    if affinity is None and not spreads and not tolerations:
        return base
    if spreads:
        if len(spreads) == 1:
            # flat key for the dominant one-constraint shape (a 4-tuple, vs
            # the general branch's tuple-of-4-tuples — never equal across
            # branches, and the branch choice is content)
            c = spreads[0]
            sel = c.label_selector
            if sel is None:
                sel_key = None
            else:
                ml = sel.match_labels
                me = sel.match_expressions
                sel_key = (
                    tuple(ml.items()) if ml else (),
                    tuple([(e.key, e.operator, tuple(e.values)) for e in me])
                    if me
                    else (),
                )
            spread_key = (c.topology_key, c.max_skew, c.when_unsatisfiable, sel_key)
        else:
            spread_key = tuple([
                (
                    c.topology_key,
                    c.max_skew,
                    c.when_unsatisfiable,
                    _fast_selector_key(c.label_selector),
                )
                for c in spreads
            ])
    else:
        spread_key = ()
    if affinity is None:
        aff_key = None
    else:
        pa = affinity.pod_affinity
        if (
            pa is not None
            and affinity.node_affinity is None
            and affinity.pod_anti_affinity is None
            and not pa.preferred
            and len(pa.required) == 1
        ):
            # flat key for the dominant single-required-affinity shape (a
            # 5-tuple with a string marker, vs the general branch's
            # tuple-of-parts — never equal across branches)
            term = pa.required[0]
            sel = term.label_selector
            if sel is None:
                sel_key = None
            else:
                ml = sel.match_labels
                me = sel.match_expressions
                sel_key = (
                    tuple(ml.items()) if ml else (),
                    tuple([(e.key, e.operator, tuple(e.values)) for e in me])
                    if me
                    else (),
                )
            ns = term.namespaces
            ns_sel = term.namespace_selector
            aff_key = (
                "aff1",
                term.topology_key,
                sel_key,
                tuple(ns) if ns else (),
                _fast_selector_key(ns_sel) if ns_sel is not None else None,
            )
        else:
            aff_key = _fast_affinity_key(affinity)
    return base + (
        tuple([(t.key, t.operator, t.value, t.effect) for t in tolerations])
        if tolerations
        else (),
        spread_key,
        aff_key,
    )


def _sig_key_impl():
    """The fast-key callable: the pure-Python key (the native signature
    extension of the reference package is not part of this port)."""
    return _fast_sig_key_py


def _fast_sig_key(pod: Pod):
    """Front door of the fast key; see ``_fast_sig_key_py`` for the
    exactness contract."""
    return _fast_sig_key_py(pod)


@dataclass
class ColumnarPodBatch:
    """Pods as columns.  ``signature`` carries one u64 row per pod: stable
    hashes of the pod's constraint content (requirements, tolerations,
    topology, labels) plus its quantized resource vector."""

    n_pods: int
    requests: np.ndarray  # f32[P, R]
    resource_names: List[str]
    signature: np.ndarray  # u64[P, W]
    pods: Optional[List[Pod]] = None  # object backing when converted

    @classmethod
    def from_pods(cls, pods: List[Pod], resource_names: Optional[List[str]] = None) -> "ColumnarPodBatch":
        from karpenter_core_tpu_torch.models.snapshot import _class_signature

        # one signature-hash + resolved-request row per distinct shape via the
        # fast key; the per-pod loop is O(1) dict work, and the requests
        # matrix fills through one vectorized scatter instead of a Python
        # store per (pod, resource) cell
        shape_cache: Dict[tuple, tuple] = {}  # fast key -> (hash64, res items)
        per_pod: List[tuple] = []
        for pod in pods:
            fk = _fast_sig_key(pod)
            hit = shape_cache.get(fk) if fk is not None else None
            if hit is None:
                sig_hash = np.uint64(hash(_class_signature(pod)) & (2**64 - 1))
                res_items = tuple(resources_util.ceiling(pod).items())
                if fk is not None:
                    shape_cache[fk] = hit = (sig_hash, res_items)
                else:
                    hit = (sig_hash, res_items)
            per_pod.append(hit)

        if resource_names is None:
            seen: Dict[str, None] = {}
            for _, res_items in per_pod:
                for name, _ in res_items:
                    seen.setdefault(name)
            resource_names = sorted(seen)
        index = {name: r for r, name in enumerate(resource_names)}
        rows: List[int] = []
        cols: List[int] = []
        vals: List[float] = []
        signature = np.zeros((len(pods), 1), dtype=np.uint64)
        for p, (sig_hash, res_items) in enumerate(per_pod):
            signature[p, 0] = sig_hash
            for name, quantity in res_items:
                col = index.get(name)
                if col is not None:
                    rows.append(p)
                    cols.append(col)
                    vals.append(quantity)
        requests = np.zeros((len(pods), len(resource_names)), dtype=np.float32)
        if rows:
            requests[np.asarray(rows), np.asarray(cols)] = np.asarray(
                vals, dtype=np.float32
            )
        return cls(
            n_pods=len(pods),
            requests=requests,
            resource_names=resource_names,
            signature=signature,
            pods=pods,
        )


@dataclass
class ColumnarClasses:
    class_ids: np.ndarray  # i64[P]
    n_classes: int
    counts: np.ndarray  # i64[C]
    requests: np.ndarray  # f32[C, R] per-pod request vector of each class


class _ClassSlot:
    """One equivalence class tracked incrementally: the derived class state is
    built once (at first sight of the shape) and reused every reconcile."""

    __slots__ = ("sig", "proto", "error", "pods", "live")

    def __init__(self, sig, proto, error) -> None:
        self.sig = sig  # the full class signature this slot deduplicates on
        self.proto = proto  # PodClass with derived state, empty pods list
        self.error = error  # KernelUnsupported captured at build time, if any
        self.pods: Dict[str, Pod] = {}  # uid -> pod (insertion-ordered)
        # registration state in PodIngest._slots, maintained at every mutation
        # point so the bulk path never re-hashes the (large) signature tuple
        # just to check whether the slot is still registered
        self.live = False


class PodIngest:
    """Incremental pod store: per-pod work happens once at add() time.

    The informer feeds pod add/remove events as they happen; ``classes()``
    then assembles the solver's PodClass list in O(distinct shapes) — the
    steady-state reconcile never re-scans the pod set.  Dedup is exact (full
    signature tuples as dict keys; the fast-key layer is a pure interning
    accelerator — equal fast keys imply equal signatures), so unlike
    hash-row grouping there is no collision risk.

    A shape the kernel doesn't model doesn't fail ingestion — the captured
    KernelUnsupported is raised at classes() time, when the solve is routed,
    so callers keep their host-path fallback semantics.
    """

    def __init__(self) -> None:
        self._slots: Dict[tuple, _ClassSlot] = {}
        self._by_uid: Dict[str, _ClassSlot] = {}
        # fast key -> slot: the bulk-path accelerator.  Entries may outlive
        # their slot's _slots registration (an emptied shape re-minting) —
        # _add_one revalidates against the live registry on every hit.
        self._fast: Dict[tuple, _ClassSlot] = {}
        # monotonic mutation counter: every effective add/remove bumps it, so
        # the versioned snapshot store (models.store) can stamp each encode
        # with the exact ingest state it saw and cheap-compare "anything
        # changed?" without walking the pod set
        self._version = 0

    @property
    def version(self) -> int:
        """Monotonic count of effective mutations (adds + removes)."""
        return self._version

    def class_members(self) -> Dict[tuple, tuple]:
        """signature -> (uid, ...) per live class, in insertion order — the
        equivalence-class bookkeeping the snapshot store's diff rides (no
        signature re-derivation, no per-pod hashing on the solve path)."""
        return {
            sig: tuple(slot.pods) for sig, slot in self._slots.items() if slot.pods
        }

    def get(self, uid: str):
        """The live Pod for ``uid`` (None when not tracked)."""
        slot = self._by_uid.get(uid)
        if slot is None:
            return None
        return slot.pods.get(uid)

    def __len__(self) -> int:
        return len(self._by_uid)

    def _drop(self, uid: str) -> None:
        """Unlink one tracked uid (no version bump — callers account it)."""
        slot = self._by_uid.pop(uid)
        slot.pods.pop(uid, None)
        if not slot.pods:
            del self._slots[slot.sig]
            slot.live = False

    def _add_one(self, pod: Pod) -> None:
        """One add with the fast-key accelerator: the full signature (and the
        ladder build) runs once per distinct shape; every subsequent member
        of the shape costs a few dict operations."""
        uid = pod.metadata.uid
        if uid in self._by_uid:
            # re-add replaces: same bookkeeping (and version arithmetic) as
            # a remove followed by an add
            self._drop(uid)
            self._version += 1
        fk = _fast_sig_key(pod)
        slot = None
        if fk is not None:
            slot = self._fast.get(fk)
            if slot is not None and not slot.live:
                slot = self._revive(fk, slot)
        if slot is None:
            slot = self._slot_for(pod, fk)
        slot.pods[uid] = pod
        self._by_uid[uid] = slot
        self._version += 1

    def _revive(self, fk, slot: _ClassSlot) -> _ClassSlot:
        """A fast-key hit on a slot no longer registered: either the emptied
        shape is returning (re-register it) or the shape was re-minted
        through the full-signature path while this entry idled (converge on
        the live slot).  Rare — only here does the signature get re-hashed."""
        live = self._slots.get(slot.sig)
        if live is None:
            self._slots[slot.sig] = slot
            slot.live = True
            return slot
        self._fast[fk] = live
        return live

    def _slot_for(self, pod: Pod, fk) -> _ClassSlot:
        from karpenter_core_tpu_torch.models.snapshot import (
            KernelUnsupported,
            _class_signature,
            build_pod_ladder,
        )

        sig = _class_signature(pod)
        slot = self._slots.get(sig)
        if slot is None:
            proto, error = None, None
            try:
                proto = build_pod_ladder(pod)
            except KernelUnsupported as e:
                error = e
            slot = _ClassSlot(sig, proto, error)
            self._slots[sig] = slot
            slot.live = True
        if fk is not None:
            if len(self._fast) > max(_FAST_CACHE_FLOOR, 4 * len(self._slots)):
                # retired shapes must not accumulate (label churn mints fresh
                # fast keys forever); keep only entries backing live pods.
                # Pruned IN PLACE: add_all holds a bound `self._fast.get`
                # across the batch, so the dict object must stay the same.
                live = {k: s for k, s in self._fast.items() if s.pods}
                self._fast.clear()
                self._fast.update(live)
            self._fast[fk] = slot
        return slot

    def add(self, pod: Pod) -> None:
        self._add_one(pod)

    def add_all(self, pods: List[Pod]) -> None:
        """Bulk add — the trace/watch-stream ingest path.  Same final state
        (slots, members, version) as ``add`` in a loop; one version
        settlement, and the per-pod body is inlined dict work (everything
        O(pods) about it is O(1) per pod)."""
        by_uid = self._by_uid
        fast_get = self._fast.get
        fast_key = _sig_key_impl()
        mutations = 0
        for pod in pods:
            uid = pod.metadata.uid
            if uid in by_uid:
                self._drop(uid)
                mutations += 1
            fk = fast_key(pod)
            slot = fast_get(fk) if fk is not None else None
            if slot is None:
                slot = self._slot_for(pod, fk)
            elif not slot.live:
                slot = self._revive(fk, slot)
            slot.pods[uid] = pod
            by_uid[uid] = slot
            mutations += 1
        self._version += mutations

    def remove(self, uid: str) -> bool:
        if uid not in self._by_uid:
            return False
        # _drop also evicts emptied shapes from the registry: label churn
        # (e.g. pod-template-hash) mints fresh signatures forever, so retired
        # slots must not accumulate
        self._drop(uid)
        self._version += 1
        return True

    def pods(self) -> List[Pod]:
        return [p for slot in self._slots.values() for p in slot.pods.values()]

    def classes(self):
        """Solver-ready PodClass list (fresh list each call; derived state
        shared with the slot prototypes).  Raises the first captured
        KernelUnsupported so callers route the batch to the host path."""
        from dataclasses import replace

        from karpenter_core_tpu_torch.models.snapshot import finalize_classes

        classes = []
        for slot in self._slots.values():
            if not slot.pods:
                continue
            if slot.error is not None:
                raise slot.error
            classes.append(replace(
                slot.proto, pods=list(slot.pods.values()),
                # the slot's signature rides along so the encode's reuse key
                # never re-derives it (models.snapshot._class_plane_key)
                interned_sig=slot.sig,
            ))
        return finalize_classes(classes)


def classify_columnar(batch: ColumnarPodBatch) -> ColumnarClasses:
    """Group the batch into equivalence classes through the native runtime
    (numpy fallback is batch ops too — no per-pod Python on either path)."""
    class_ids, n_classes = native.group_rows(batch.signature)
    totals, counts = native.class_totals(batch.requests, class_ids, n_classes)
    # per-pod request vector = class total / count (identical pods by definition)
    requests = totals / np.maximum(counts[:, None], 1)
    return ColumnarClasses(
        class_ids=class_ids, n_classes=n_classes, counts=counts, requests=requests
    )
