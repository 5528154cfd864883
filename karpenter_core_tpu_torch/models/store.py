"""Versioned, diffable snapshot store: the host bookkeeping of the warm repair.

A trimmed copy of ``karpenter_core_tpu/models/store.py``.  Each full solve's
encode is stamped with a monotonic version and the per-class membership rows
(``VersionedSnapshot``); a delta reconcile diffs the previous membership
against the current one without encoding anything (``diff_members``), and
the fallback policy (``solver.incremental``) reads the ``SnapshotDelta``.
Supply-side change detection (``supply_digest`` / ``catalog_digest``)
hashes the solve's INPUTS — state nodes, bound pods, provisioners, catalog —
so a steady tick never encodes.

Left out until the tenant-service slice, whose checkpoint, journal and
tenant code are their only readers: the per-plane content digests
(``snapshot_digests``, ``PLANE_FIELDS``), ``diff_snapshots``,
``stable_digest``, ``content_digest`` and ``SnapshotStore.seed_version``.
So ``VersionedSnapshot.digests`` stays an empty dict.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from karpenter_core_tpu_torch.models.snapshot import EncodedSnapshot, _class_signature


def class_key(cls) -> tuple:
    """Version-stable identity of one class row: the equivalence-class
    signature of its representative pod (``PodClass.interned_sig`` when the
    producer stamped it, which equals the derivation)."""
    sig = getattr(cls, "interned_sig", None)
    if sig is not None:
        return sig
    return _class_signature(cls.pods[0])


@dataclass(frozen=True)
class ClassRow:
    """One class's membership at one version (roots carry the pod uids;
    ladder variants own no pods)."""

    key: tuple
    count: int
    uids: Tuple[str, ...] = ()


@dataclass
class VersionedSnapshot:
    """One encode output plus the version metadata the diff operates on."""

    version: int
    snapshot: EncodedSnapshot
    digests: Dict[str, str]
    rows: Tuple[ClassRow, ...]
    supply: str = ""  # supply_digest at encode time ("" = not tracked)

    def index_of(self) -> Dict[tuple, int]:
        return {row.key: i for i, row in enumerate(self.rows)}

    def summary(self) -> Dict[tuple, Tuple[str, ...]]:
        """class key -> member uids (the diff/apply state space)."""
        return {row.key: row.uids for row in self.rows}


@dataclass
class SnapshotDelta:
    """Structured difference between two membership versions."""

    from_version: int
    to_version: int
    added: Dict[tuple, Tuple[str, ...]] = field(default_factory=dict)
    evicted: Dict[tuple, Tuple[str, ...]] = field(default_factory=dict)
    new_classes: Tuple[tuple, ...] = ()
    removed_classes: Tuple[tuple, ...] = ()
    # supply-side inputs that changed ("supply" when the digest moved)
    changed_planes: Tuple[str, ...] = ()
    unchanged_extents: Tuple[Tuple[int, int], ...] = ()
    touched_classes: Tuple[int, ...] = ()
    touched_mask_words: int = 0
    pods_before: int = 0
    pods_after: int = 0

    @property
    def added_count(self) -> int:
        return sum(len(u) for u in self.added.values())

    @property
    def evicted_count(self) -> int:
        return sum(len(u) for u in self.evicted.values())

    @property
    def delta_fraction(self) -> float:
        """(added + evicted) over the larger population — the fallback
        policy's primary threshold."""
        base = max(self.pods_before, self.pods_after, 1)
        return (self.added_count + self.evicted_count) / base

    @property
    def node_side_changed(self) -> bool:
        return bool(self.changed_planes)

    @property
    def class_shape_changed(self) -> bool:
        """True when the class AXIS itself moved (new/removed classes)."""
        return bool(self.new_classes or self.removed_classes)

    def apply(self, prev_summary: Dict[tuple, Tuple[str, ...]]) -> Dict[tuple, Tuple[str, ...]]:
        """Replay this delta onto the older membership summary; a diff then
        its apply reproduces the newer summary exactly."""
        out = {key: list(uids) for key, uids in prev_summary.items()}
        for key in self.removed_classes:
            out.pop(key, None)
        for key in self.new_classes:
            out.setdefault(key, [])
        for key, uids in self.evicted.items():
            if key in out:
                gone = set(uids)
                out[key] = [u for u in out[key] if u not in gone]
        for key, uids in self.added.items():
            out.setdefault(key, []).extend(uids)
        return {
            key: tuple(uids) for key, uids in out.items()
            if uids or key in self.new_classes or key not in self.evicted
        }


def diff_members(
    prev_members: Dict[tuple, Tuple[str, ...]],
    cur_members: Dict[tuple, Tuple[str, ...]],
    from_version: int = 0,
    to_version: int = 0,
    supply_changed: Tuple[str, ...] = (),
) -> SnapshotDelta:
    """A SnapshotDelta from two membership maps alone — the no-encode diff a
    delta reconcile uses (class key -> member uids)."""
    added: Dict[tuple, Tuple[str, ...]] = {}
    evicted: Dict[tuple, Tuple[str, ...]] = {}
    new_classes = tuple(k for k in cur_members if k not in prev_members)
    removed_classes = tuple(k for k in prev_members if k not in cur_members)
    for key, uids in cur_members.items():
        before = set(prev_members.get(key, ()))
        now = set(uids)
        plus = tuple(u for u in uids if u not in before)
        minus = tuple(u for u in prev_members.get(key, ()) if u not in now)
        if plus:
            added[key] = plus
        if minus:
            evicted[key] = minus
    for key in removed_classes:
        if prev_members[key]:
            evicted[key] = prev_members[key]
    return SnapshotDelta(
        from_version=from_version,
        to_version=to_version or from_version + 1,
        added=added,
        evicted=evicted,
        new_classes=new_classes,
        removed_classes=removed_classes,
        changed_planes=tuple(supply_changed),
        pods_before=sum(len(u) for u in prev_members.values()),
        pods_after=sum(len(u) for u in cur_members.values()),
    )


def rows_from_snapshot(snapshot: EncodedSnapshot) -> Tuple[ClassRow, ...]:
    """Membership rows in class order.  Root classes carry their pod uids;
    ladder variants own no pods."""
    rows: List[ClassRow] = []
    for cls in snapshot.classes:
        uids = () if cls.is_ladder_variant else tuple(p.uid for p in cls.pods)
        rows.append(ClassRow(key=class_key(cls), count=len(uids), uids=uids))
    return tuple(rows)


class SnapshotStore:
    """Holds the current snapshot version and mints successors."""

    def __init__(self) -> None:
        self._version = 0
        self.current: Optional[VersionedSnapshot] = None

    def commit(self, snapshot: EncodedSnapshot, supply: str = "") -> VersionedSnapshot:
        """Stamp one encode output as the next version and make it current."""
        self._version += 1
        versioned = VersionedSnapshot(
            version=self._version,
            snapshot=snapshot,
            digests={},
            rows=rows_from_snapshot(snapshot),
            supply=supply,
        )
        self.current = versioned
        return versioned


def supply_digest(state_nodes, bound_pods) -> str:
    """Content digest of the solve's supply-side inputs: state nodes
    (labels, available capacity, taints, volume limits and usage) and the
    bound pods whose membership seeds topology counts.  Encodes nothing."""
    h = hashlib.sha256()
    for sn in state_nodes or []:
        node = sn.node
        h.update(node.name.encode())
        h.update(repr(sorted(node.metadata.labels.items())).encode())
        h.update(repr(sorted(sn.available().items())).encode())
        h.update(repr(sorted(
            (t.key, t.value, t.effect) for t in sn.taints()
        )).encode())
        h.update(b"1" if sn.initialized() else b"0")
        h.update(repr(sorted(sn.volume_limits().items())).encode())
        h.update(repr(sorted(
            (d, tuple(sorted(ids))) for d, ids in sn.volume_usage().volumes.items()
        )).encode())
        h.update(b"\x1e")
    for pod in bound_pods or []:
        h.update((pod.uid or "").encode())
        h.update((pod.spec.node_name or "").encode())
        h.update((pod.namespace or "").encode())
        h.update(repr(sorted(pod.metadata.labels.items())).encode())
        h.update(b"\x1e")
    return h.hexdigest()


def catalog_digest(provisioners, instance_types) -> str:
    """Content digest of the provisioner and catalog inputs: provisioner
    specs through resourceVersion / generation and the weight order, the
    catalog through names, capacity and offerings (prices included)."""
    h = hashlib.sha256()
    for p in provisioners or []:
        h.update(p.name.encode())
        h.update(str(p.metadata.resource_version or "").encode())
        h.update(str(getattr(p.metadata, "generation", "") or "").encode())
        h.update(str(getattr(p.spec, "weight", 0) or 0).encode())
        h.update(b"\x1e")
    for name in sorted(instance_types or {}):
        h.update(name.encode())
        for it in instance_types[name]:
            h.update(it.name.encode())
            h.update(repr(sorted(it.capacity.items())).encode())
            h.update(repr(sorted(
                (o.zone, o.capacity_type, o.available, o.price)
                for o in it.offerings
            )).encode())
        h.update(b"\x1e")
    return h.hexdigest()
