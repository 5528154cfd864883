"""CUDA solver facade: encode → prepare → solve_core → decode.

The port of ``karpenter_core_tpu/solver/tpu.py`` ``TPUSolver`` for the cold
provisioning solve: pending pods against the provisioners' instance-type
catalogs, no existing node (the existing-node planes are the one closed
dummy slot).  The encode half is the reference's, copied; the device half
runs ``ops.solve.solve_core`` on the card through the hand-written kernels.

    solver = CudaSolver(provider, provisioners)          # device=None: CUDA
    results = solver.solve(ingest)                        # PodIngest or pods
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from karpenter_core_tpu_torch import carry
from karpenter_core_tpu_torch import device as device_mod
from karpenter_core_tpu_torch.apis import labels as labels_api
from karpenter_core_tpu_torch.apis.objects import Pod
from karpenter_core_tpu_torch.apis.v1alpha5 import Provisioner, order_by_weight
from karpenter_core_tpu_torch.cloudprovider import CloudProvider, InstanceType
from karpenter_core_tpu_torch.models.snapshot import (
    EncodedSnapshot,
    KernelUnsupported,
    encode_snapshot,
)
from karpenter_core_tpu_torch.ops import solve as solve_ops
from karpenter_core_tpu_torch.scheduling import Requirement, Requirements
from karpenter_core_tpu_torch.solver.machinetemplate import MachineTemplate
from karpenter_core_tpu_torch.solver.scheduler import _daemon_overhead
from karpenter_core_tpu_torch.utils import resources as resources_util


class _LazyPlanes:
    """Per-solve node planes (viable/zone/ct/used), fetched device→host once
    on first access.  The bool planes are bit-packed on the device (K4) at
    construction, so the copy moves 8x fewer bytes."""

    __slots__ = ("_viable_p", "_zone_p", "_ct_p", "_used_d", "_n_it",
                 "_n_zones", "_n_ct", "_viable", "_zone", "_ct", "_used")

    def __init__(self, state, pack_bool) -> None:
        self._n_it = state.viable.shape[-1]
        self._n_zones = state.zone.shape[-1]
        self._n_ct = state.ct.shape[-1]
        self._viable_p = pack_bool(state.viable)
        self._zone_p = pack_bool(state.zone)
        self._ct_p = pack_bool(state.ct)
        self._used_d = state.used
        self._viable = self._zone = self._ct = self._used = None

    def _fetch(self) -> None:
        if self._viable is None:
            self._viable = solve_ops.unpack_bool(self._viable_p.cpu().numpy(), self._n_it)
            self._zone = solve_ops.unpack_bool(self._zone_p.cpu().numpy(), self._n_zones)
            self._ct = solve_ops.unpack_bool(self._ct_p.cpu().numpy(), self._n_ct)
            self._used = self._used_d.cpu().numpy()
            # release the device buffers: decisions can outlive the solve
            self._viable_p = self._zone_p = self._ct_p = self._used_d = None

    @property
    def viable(self) -> np.ndarray:
        self._fetch()
        return self._viable

    @property
    def zone(self) -> np.ndarray:
        self._fetch()
        return self._zone

    @property
    def ct(self) -> np.ndarray:
        self._fetch()
        return self._ct

    @property
    def used(self) -> np.ndarray:
        self._fetch()
        return self._used


class CudaNodeDecision:
    """One node the solve decided to create.  Instance-type/zone name lists
    and the request vector materialize lazily from the fetched planes."""

    __slots__ = ("provisioner_name", "pods", "_snapshot", "_planes", "_slot")

    def __init__(self, provisioner_name, snapshot, planes, slot):
        self.provisioner_name = provisioner_name
        self.pods: List[Pod] = []
        self._snapshot = snapshot
        self._planes = planes
        self._slot = slot

    @property
    def instance_type_names(self) -> List[str]:
        row = self._planes.viable[self._slot]
        return [self._snapshot.it_names[i] for i in np.nonzero(row)[0]]

    @property
    def zones(self) -> List[str]:
        row = self._planes.zone[self._slot]
        return [self._snapshot.zones[z] for z in np.nonzero(row)[0]]

    @property
    def capacity_types(self) -> List[str]:
        row = self._planes.ct[self._slot]
        return [self._snapshot.capacity_types[c] for c in np.nonzero(row)[0]]

    @property
    def requests(self) -> resources_util.ResourceList:
        row = self._planes.used[self._slot]
        return {
            name: float(row[r])
            for r, name in enumerate(self._snapshot.resources)
            if row[r] > 0
        }


class SolvePrep(NamedTuple):
    """One snapshot's kernel inputs, bucket-padded and on the device."""

    cls: solve_ops.ClassTensors
    statics_arrays: solve_ops.StaticArrays
    key_has_bounds: tuple
    n_slots: int
    n_passes: int
    features: solve_ops.SnapshotFeatures


@dataclass
class CudaSolveResults:
    new_nodes: List[CudaNodeDecision] = field(default_factory=list)
    failed_pods: List[Pod] = field(default_factory=list)
    # pods of classes the solve flagged spread_suspect: the zone-spread
    # water-fill could not prove host-oracle parity, so the host might still
    # place them — callers route them to the host path or treat them as failed
    spread_residual_pods: List[Pod] = field(default_factory=list)
    n_slots_used: int = 0


@dataclass
class LaunchableNode:
    """Launch-path adapter: template + instance types + requests + pods."""

    template: object
    instance_type_options: List[InstanceType]
    requests: dict
    pods: List[Pod] = field(default_factory=list)

    @property
    def provisioner_name(self) -> str:
        return self.template.provisioner_name

    @property
    def requirements(self):
        return self.template.requirements


class _Fetch:
    """The decode fetch of one solve: the small planes copied to the host at
    once — (assign, failed, spread_suspect, pod_count, tmpl_id, open_,
    n_next) — and the big ones lazily (``planes``)."""

    def __init__(self, outputs: solve_ops.SolveOutputs, pack_bool) -> None:
        state = outputs.state
        self.small = tuple(t.cpu().numpy() for t in (
            outputs.assign, outputs.failed, outputs.spread_suspect,
            state.pod_count, state.tmpl_id, state.open_, state.n_next,
        ))
        self.planes = _LazyPlanes(state, pack_bool)


class CudaSolver:
    """Solves pending pods against the provisioners' catalogs on one device
    (``device=None``: the CUDA card; raises when there is none).
    ``use_kernels=False`` runs the kernels' plain torch twins instead — the
    oracle a card run holds the kernels against."""

    # positions in _Fetch.small read by the slot-exhaustion check
    FETCH_FAILED = 1
    FETCH_N_NEXT = 6

    def __init__(
        self,
        cloud_provider: CloudProvider,
        provisioners: List[Provisioner],
        daemonset_pods: Optional[List[Pod]] = None,
        device=None,
        use_kernels: bool = True,
    ) -> None:
        self.device = device_mod.resolve(device)
        self.use_kernels = use_kernels
        self.cloud_provider = cloud_provider
        self.provisioners = order_by_weight(
            [p for p in provisioners if p.metadata.deletion_timestamp is None]
        )
        self.templates = [MachineTemplate.from_provisioner(p) for p in self.provisioners]
        self.instance_types: Dict[str, List[InstanceType]] = {
            p.name: cloud_provider.get_instance_types(p) for p in self.provisioners
        }
        overhead = _daemon_overhead(self.templates, daemonset_pods or [])
        for template in self.templates:
            template.requests = overhead[id(template)]
        self._it_by_name = {
            it.name: it for its in self.instance_types.values() for it in its
        }
        # wall seconds of the last solve() by stage (encode / solve / decode),
        # and the last solve's raw device outputs
        self.stages: Dict[str, float] = {}
        self.last_outputs: Optional[solve_ops.SolveOutputs] = None

    # -- encode (host, numpy) -------------------------------------------------

    def encode(self, pods) -> EncodedSnapshot:
        """Raises models.snapshot.KernelUnsupported when the batch needs the
        host path.  ``pods`` is a pod list or a models.columnar.PodIngest
        (whose classification already ran at add time)."""
        from karpenter_core_tpu_torch.models.columnar import PodIngest

        classes = None
        if isinstance(pods, PodIngest):
            classes = pods.classes()
            pods = [cls.pods[0] for cls in classes]
        return self._encode_with_classes(pods, classes)

    def encode_classes(self, classes: list) -> EncodedSnapshot:
        """Encode from prebuilt PodClass objects (ordered and validated in
        place by models.snapshot.finalize_classes)."""
        from karpenter_core_tpu_torch.models.snapshot import finalize_classes

        classes = finalize_classes(list(classes))
        return self._encode_with_classes([cls.pods[0] for cls in classes], classes)

    def _encode_with_classes(self, pods: List[Pod], classes: Optional[list]) -> EncodedSnapshot:
        snapshot = encode_snapshot(
            pods, self.provisioners, self.templates, self.instance_types,
            cache_host=self, classes=classes,
        )
        # no state node carries CSI attach limits in a cold solve, so every
        # class's volume profile is empty (the reference's resolution with
        # no limited driver)
        snapshot.class_volumes = [{"shared": {}, "per_pod": {}} for _ in snapshot.classes]
        return snapshot

    # -- device half ----------------------------------------------------------

    def prepare_encoded(self, snapshot: EncodedSnapshot, n_slots: int = 0) -> SolvePrep:
        """Kernel inputs for one encoded snapshot, bucket-padded and on the
        solver's device."""
        if n_slots <= 0:
            n_slots = solve_ops.estimate_slots(snapshot)
        cls, statics_arrays, key_has_bounds = solve_ops.prepare_host(snapshot)
        cls, statics_arrays, key_has_bounds = solve_ops.pad_planes(cls, statics_arrays, key_has_bounds)
        cls_t, sa_t, khb = carry.tensors_from_numpy(cls, statics_arrays, key_has_bounds, self.device)
        return SolvePrep(cls=cls_t, statics_arrays=sa_t, key_has_bounds=khb, n_slots=n_slots,
                         n_passes=snapshot.scan_passes,
                         features=solve_ops.snapshot_features(snapshot))

    def run_prepared(self, prep: SolvePrep, n_slots: int = 0) -> solve_ops.SolveOutputs:
        """Run the solve on a SolvePrep; returns device-resident outputs."""
        return solve_ops.solve_core(
            prep.cls, prep.statics_arrays, n_slots or prep.n_slots, prep.key_has_bounds,
            n_passes=prep.n_passes, features=prep.features, use_kernels=self.use_kernels,
        )

    @classmethod
    def fetch_exhausted(cls, fetched, slots) -> bool:
        """Slot exhaustion: pods failed AND the scan used every slot."""
        return (
            int(np.sum(fetched[cls.FETCH_FAILED])) > 0
            and int(fetched[cls.FETCH_N_NEXT]) >= int(slots)
        )

    def _pack_bool(self):
        return solve_ops.KERNELS.pack_bool if self.use_kernels else solve_ops.PLAIN.pack_bool

    def begin_fetch(self, outputs: solve_ops.SolveOutputs) -> _Fetch:
        """Copy the small planes decode consumes to the host; the big planes
        are packed on the device and fetched on first use."""
        return _Fetch(outputs, self._pack_bool())

    def solve(self, pods, n_slots: int = 0) -> CudaSolveResults:
        """The entry point: encode, prepare, solve, decode.  Stage wall times
        land in ``self.stages``."""
        t0 = time.perf_counter()
        snapshot = self.encode(pods)
        t1 = time.perf_counter()
        results = self.solve_encoded(snapshot, n_slots, t_start=t1)
        self.stages["encode_s"] = t1 - t0
        return results

    def solve_encoded(self, snapshot: EncodedSnapshot, n_slots: int = 0,
                      t_start: Optional[float] = None) -> CudaSolveResults:
        t1 = time.perf_counter() if t_start is None else t_start
        prep = self.prepare_encoded(snapshot, n_slots)
        outputs = self.run_prepared(prep)
        fetched = self.begin_fetch(outputs)  # the solve's one barrier
        slots = outputs.assign.shape[1]
        if self.fetch_exhausted(fetched.small, slots):
            # slot exhaustion: retry once with double capacity
            outputs = self.run_prepared(prep, n_slots=slots * 2)
            fetched = self.begin_fetch(outputs)
        t2 = time.perf_counter()
        results = self.decode(snapshot, outputs, fetched=fetched)
        self.stages["solve_s"] = t2 - t1
        self.stages["decode_s"] = time.perf_counter() - t2
        self.last_outputs = outputs
        return results

    def decode(self, snapshot: EncodedSnapshot, outputs: solve_ops.SolveOutputs,
               fetched: Optional[_Fetch] = None) -> CudaSolveResults:
        fetched = fetched if fetched is not None else self.begin_fetch(outputs)
        planes = fetched.planes
        # per-pod failure comes from the leftover walk below, not the counts
        assign, _, suspect, pod_count, tmpl_id, open_, n_next = fetched.small
        results = CudaSolveResults(n_slots_used=int(n_next))
        nodes: Dict[int, CudaNodeDecision] = {}
        provisioner_names = [t.provisioner_name for t in self.templates]
        for n in np.nonzero(open_ & (pod_count > 0))[0]:
            n = int(n)
            nodes[n] = CudaNodeDecision(provisioner_names[int(tmpl_id[n])], snapshot, planes, n)

        # preference-ladder variants schedule pods from their ROOT's list: all
        # rows of one ladder share a cursor into the root's (identical) pods
        n_classes = len(snapshot.classes)
        if snapshot.cls_root is not None:
            root_of = [int(r) for r in snapshot.cls_root]
        else:
            root_of = list(range(n_classes))
        cursors = [0] * n_classes  # keyed by root index
        for c in range(n_classes):
            r = root_of[c]
            pods, cursor = snapshot.classes[r].pods, cursors[r]
            node_idx = np.nonzero(assign[c] > 0)[0]
            for n, take in zip(node_idx.tolist(), assign[c][node_idx].tolist()):
                nodes[n].pods.extend(pods[cursor: cursor + take])
                cursor += take
            cursors[r] = cursor
        # leftovers: spread_suspect classes hand their pods to the host
        # re-route instead of failing them outright
        suspect_root = [False] * n_classes
        for c in range(n_classes):
            if bool(suspect[c]):
                suspect_root[root_of[c]] = True
        for c, cls in enumerate(snapshot.classes):
            if root_of[c] != c:
                continue
            leftover = cls.pods[cursors[c]:]
            if not leftover:
                continue
            scope = cls.selectors.get(cls.zone_spread) if cls.zone_spread else None
            is_member = scope is not None and scope.matches_pod(cls.pods[0])
            if suspect_root[c] and is_member:
                results.spread_residual_pods.extend(leftover)
            else:
                results.failed_pods.extend(leftover)
        results.new_nodes = [nodes[n] for n in sorted(nodes)]
        return results

    def to_launchable(self, decision: CudaNodeDecision) -> LaunchableNode:
        """A node decision as a launch-path object: the provisioner's template
        with zone/capacity-type pinned to the decision's surviving domains and
        the viable instance-type list attached."""
        from dataclasses import replace as dc_replace

        from karpenter_core_tpu_torch.apis.objects import OP_IN

        template = next(
            t for t in self.templates if t.provisioner_name == decision.provisioner_name
        )
        requirements = Requirements(*template.requirements.values())
        zones = decision.zones
        if zones:
            requirements.add(Requirement(labels_api.LABEL_TOPOLOGY_ZONE, OP_IN, list(zones)))
        capacity_types = decision.capacity_types
        if capacity_types:
            requirements.add(
                Requirement(labels_api.LABEL_CAPACITY_TYPE, OP_IN, list(capacity_types))
            )
        options = [
            self._it_by_name[name]
            for name in decision.instance_type_names
            if name in self._it_by_name
        ]
        return LaunchableNode(
            template=dc_replace(template, requirements=requirements),
            instance_type_options=options,
            requests=dict(decision.requests),
            pods=list(decision.pods),
        )


__all__ = ["CudaSolver", "CudaSolveResults", "CudaNodeDecision", "KernelUnsupported",
           "LaunchableNode"]
