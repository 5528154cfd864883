"""CUDA solver facade: encode → prepare → solve_core → decode.

The port of ``karpenter_core_tpu/solver/tpu.py`` ``TPUSolver`` for the full
provisioning solve: pending pods against the provisioners' instance-type
catalogs and, when given, the nodes that already exist with the pods bound
to them (without them the existing-node planes are one closed dummy row).
The encode half is the reference's, copied; the device half runs
``ops.solve.solve_core`` on the card through the hand-written kernels.

    solver = CudaSolver(provider, provisioners)          # device=None: CUDA
    results = solver.solve(ingest)                        # PodIngest or pods
    results = solver.solve(ingest, state_nodes, bound_pods)   # a live cluster

``state_nodes`` are ``state.cluster.StateNode``s; ``bound_pods`` the pods
already bound to them (their topology groups, anti-affinity terms and host
ports count against the pending pods).

With a ``policy.PolicyConfig`` that enables the objective
(``CudaSolver(provider, provisioners, policy=PolicyConfig(enabled=True))``),
decode also picks each new node's offering (K13, ``ops.objective``):
``decision.selected`` names the (instance type, zone, capacity type) the
launch lands on, and ``results.fleet_cost`` / ``fleet_expected_cost`` sum
their prices.

Cold solves route by solver family (``solver.modes.resolve_mode``: the
policy's ``solver_mode`` over ``KC_SOLVER_MODE``): ``relax`` (or ``auto`` at
``KC_RELAX_MIN_PODS`` pods) runs the relax family (``relax.solve.run_relax``,
K14 and K16-K18, then the exact repair through the scan) and falls back to
the scan when it declines; ``last_solve_mode`` says which ran.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from karpenter_core_tpu_torch import carry
from karpenter_core_tpu_torch import device as device_mod
from karpenter_core_tpu_torch.apis import labels as labels_api
from karpenter_core_tpu_torch.apis.objects import Pod
from karpenter_core_tpu_torch.apis.v1alpha5 import Provisioner, order_by_weight
from karpenter_core_tpu_torch.cloudprovider import CloudProvider, InstanceType
from karpenter_core_tpu_torch.models.snapshot import (
    GRP_ANTI,
    UNLIMITED,
    EncodedSnapshot,
    KernelUnsupported,
    _group_spec,
    encode_snapshot,
    pod_port_keys,
    term_namespaces,
)
from karpenter_core_tpu_torch.ops import objective as objective_ops
from karpenter_core_tpu_torch.ops import solve as solve_ops
from karpenter_core_tpu_torch.policy import planes as policy_planes
from karpenter_core_tpu_torch.scheduling import Requirement, Requirements, Taints, VolumeUsage
from karpenter_core_tpu_torch.solver import modes as modes_mod
from karpenter_core_tpu_torch.solver.machinetemplate import MachineTemplate
from karpenter_core_tpu_torch.solver.scheduler import _daemon_overhead
from karpenter_core_tpu_torch.utils import compilecache
from karpenter_core_tpu_torch.utils import pipeline as pipeline_mod
from karpenter_core_tpu_torch.utils import resources as resources_util


class _LazyPlanes:
    """Per-solve node planes (viable/zone/ct/used).  The bool planes are
    bit-packed on the device (K4) at construction, and their copies to the
    host follow the fetch ticket's small planes on the copy stream
    (``FetchTicket.follow``, the reference's ``prefetch``); first access
    waits on the ticket's barrier, which has usually run already, and
    unpacks.  Nothing here reads the device after the barrier."""

    __slots__ = ("_ticket", "_bufs", "_n_it", "_n_zones", "_n_ct", "_viable", "_zone", "_ct",
                 "_used")

    def __init__(self, state, pack_bool, ticket) -> None:
        self._n_it = state.viable.shape[-1]
        self._n_zones = state.zone.shape[-1]
        self._n_ct = state.ct.shape[-1]
        self._ticket = ticket
        self._bufs = ticket.follow((pack_bool(state.viable), pack_bool(state.zone),
                                    pack_bool(state.ct), state.used))
        self._viable = self._zone = self._ct = self._used = None

    def _fetch(self) -> None:
        if self._viable is None:
            self._ticket.wait()
            viable_p, zone_p, ct_p, used = (b.numpy() for b in self._bufs)
            self._viable = solve_ops.unpack_bool(viable_p, self._n_it)
            self._zone = solve_ops.unpack_bool(zone_p, self._n_zones)
            self._ct = solve_ops.unpack_bool(ct_p, self._n_ct)
            self._used = used.copy()
            # release the pinned buffers: decisions can outlive the solve
            self._ticket = self._bufs = None

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
    and the request vector materialize lazily from the fetched planes.

    ``selected`` is the policy objective's offering for this node (a dict of
    instance_type, zone, capacity_type, price and expected; set by decode
    when the policy is on): the zone and capacity type are then pinned to it
    and the selected type comes first.  None keeps the feasibility-only
    lists."""

    __slots__ = ("provisioner_name", "pods", "selected", "_snapshot", "_planes", "_slot")

    def __init__(self, provisioner_name, snapshot, planes, slot):
        self.provisioner_name = provisioner_name
        self.pods: List[Pod] = []
        self.selected: Optional[dict] = None
        self._snapshot = snapshot
        self._planes = planes
        self._slot = slot

    @property
    def instance_type_names(self) -> List[str]:
        row = self._planes.viable[self._slot]
        names = [self._snapshot.it_names[i] for i in np.nonzero(row)[0]]
        if self.selected is not None:
            chosen = self.selected["instance_type"]
            if chosen in names:
                names = [chosen] + [n for n in names if n != chosen]
        return names

    @property
    def zones(self) -> List[str]:
        if self.selected is not None:
            return [self.selected["zone"]]
        row = self._planes.zone[self._slot]
        return [self._snapshot.zones[z] for z in np.nonzero(row)[0]]

    @property
    def capacity_types(self) -> List[str]:
        if self.selected is not None:
            return [self.selected["capacity_type"]]
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


def _attach_pol(snapshot, statics_arrays, device) -> Optional[policy_planes.ObjectivePlanes]:
    """The snapshot's policy objective planes as tensors on the prep's
    device, padded to its instance-type extent (the reference's
    ``solver/tpu.py:177``; pad +inf price, 0 risk, 0 throughput: an
    unpriced type is never selected).  The planes share the snapshot's I
    axis, so the pad is a no-op on the solver's own path."""
    pol = policy_planes.planes_of(snapshot)
    if pol is None:
        return None
    n_it = int(statics_arrays.it_alloc.shape[0])
    price, risk, thr = (np.asarray(a, dtype=np.float32) for a in pol)
    if price.shape[0] != n_it:
        price = solve_ops._pad_axis(price, 0, n_it, np.inf)
        risk = solve_ops._pad_axis(risk, 0, n_it, 0.0)
        thr = solve_ops._pad_axis(thr, 0, n_it, 0.0)
    return policy_planes.ObjectivePlanes(*(
        torch.as_tensor(np.ascontiguousarray(a), device=device) for a in (price, risk, thr)))


class SolvePrep(NamedTuple):
    """One snapshot's kernel inputs, bucket-padded and on the device."""

    cls: solve_ops.ClassTensors
    statics_arrays: solve_ops.StaticArrays
    key_has_bounds: tuple
    ex_state: Optional[solve_ops.ExistingState]  # None: no existing node
    ex_static: Optional[solve_ops.ExistingStatic]
    n_slots: int
    n_passes: int
    features: solve_ops.SnapshotFeatures
    # the objective planes (price, risk, throughput) on the device: the
    # relax family's cost
    pol: Optional[policy_planes.ObjectivePlanes] = None
    # class rows that carry pods (non-zero counts), counted on the host
    # before the upload: the tenant plane's occupancy ledger reads it
    real_rows: int = 0


def prep_classes(prep: SolvePrep, count=None) -> solve_ops.ClassTensors:
    """The prep's class planes, with ``count`` (a repair's delta pods; the
    padded class axis) as the count vector: an int32 tensor on the planes'
    device.  ``run_prepared`` and the tenant plane's batched dispatch read a
    prep through it."""
    cls = prep.cls
    if count is None:
        return cls
    return cls._replace(count=torch.as_tensor(
        np.asarray(count, dtype=np.int32), device=cls.count.device))


@dataclass
class CudaSolveResults:
    new_nodes: List[CudaNodeDecision] = field(default_factory=list)
    # existing-node placements: node name -> pods nominated onto it
    existing_assignments: Dict[str, List[Pod]] = field(default_factory=dict)
    failed_pods: List[Pod] = field(default_factory=list)
    # pods of classes the solve flagged spread_suspect: the zone-spread
    # water-fill could not prove host-oracle parity, so the host might still
    # place them — callers route them to the host path or treat them as failed
    spread_residual_pods: List[Pod] = field(default_factory=list)
    # zone the solve committed each assignment-carrying existing node to
    # (singleton post-solve zone masks only): a zone-less node that took
    # zone-restricted pods is pinned there
    existing_committed_zones: Dict[str, str] = field(default_factory=dict)
    n_slots_used: int = 0
    # the policy objective's sums of the selected offerings' prices over the
    # new nodes, raw and risk-weighted; None when the policy is off
    fleet_cost: Optional[float] = None
    fleet_expected_cost: Optional[float] = None


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


class CudaSolver:
    """Solves pending pods against the provisioners' catalogs on one device
    (``device=None``: the CUDA card; raises when there is none).
    ``use_kernels=False`` runs the kernels' plain torch twins instead — the
    oracle a card run holds the kernels against.  ``policy`` is a
    ``policy.PolicyConfig``: None or disabled decodes feasibility only."""

    # positions in the fetch ticket's small planes (``begin_fetch``) read by
    # the slot-exhaustion check and the incremental session's bookkeeping
    FETCH_ASSIGN = 0
    FETCH_ASSIGN_EX = 1
    FETCH_FAILED = 2
    FETCH_N_NEXT = 8

    def __init__(
        self,
        cloud_provider: CloudProvider,
        provisioners: List[Provisioner],
        daemonset_pods: Optional[List[Pod]] = None,
        kube_client=None,
        device=None,
        use_kernels: bool = True,
        policy=None,
    ) -> None:
        self.device = device_mod.resolve(device)
        self.policy = policy
        # resolves PVC -> CSI driver for the volume attach-limit planes
        # (volumeusage.go:65-90); duck-typed (scheduling.volumeusage).  None
        # treats every volume as unconstrained, as the host path does
        self.kube_client = kube_client
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
        # wall seconds of the last solve() by stage (encode, encode_existing,
        # solve, decode), and the last solve's raw device outputs
        self.stages: Dict[str, float] = {}
        self.last_outputs: Optional[solve_ops.SolveOutputs] = None
        # the last policy decode's ops.objective.ObjectiveSelection (numpy)
        self.last_selection: Optional[objective_ops.ObjectiveSelection] = None
        # the family the last cold solve ran under ("scan", "relax" or
        # "relax-fallback:<reason>") and the last relax run's verdict (host
        # data: iters, converged, rounded_violations, placed, leftover)
        self.last_solve_mode: Optional[str] = None
        self.last_relax_stats: Optional[dict] = None

    # -- encode (host, numpy) -------------------------------------------------

    def encode(self, pods, state_nodes: Optional[list] = None,
               bound_pods: Optional[List[Pod]] = None) -> EncodedSnapshot:
        """Raises models.snapshot.KernelUnsupported when the batch needs the
        host path.  ``pods`` is a pod list or a models.columnar.PodIngest
        (whose classification already ran at add time)."""
        from karpenter_core_tpu_torch.models.columnar import PodIngest

        classes = None
        if isinstance(pods, PodIngest):
            classes = pods.classes()
            # class representatives cover every distinct label set, which is
            # all the anti-affinity relevance check below needs
            pods = [cls.pods[0] for cls in classes]
        return self._encode_with_classes(pods, classes, state_nodes, bound_pods)

    def encode_classes(self, classes: list, state_nodes: Optional[list] = None,
                       bound_pods: Optional[List[Pod]] = None) -> EncodedSnapshot:
        """Encode from prebuilt PodClass objects (ordered and validated in
        place by models.snapshot.finalize_classes)."""
        from karpenter_core_tpu_torch.models.snapshot import finalize_classes

        classes = finalize_classes(list(classes))
        return self._encode_with_classes([cls.pods[0] for cls in classes], classes,
                                         state_nodes, bound_pods)

    def _encode_with_classes(self, pods: List[Pod], classes: Optional[list],
                             state_nodes: Optional[list],
                             bound_pods: Optional[List[Pod]]) -> EncodedSnapshot:
        """The reference's ``_encode_with_classes_impl``: the existing nodes'
        label sets widen the vocabulary, the bound pods' required
        anti-affinity terms become groups and their host ports join the
        port universe, and the objective planes ride the snapshot (the price
        sheet, risk priors and throughput weights; attached whether or not
        the policy is on).  No mesh catalog padding."""
        extra = [Requirements.from_labels(n.node.metadata.labels) for n in (state_nodes or [])]
        extra_anti = []
        for pod in bound_pods or []:
            affinity = pod.spec.affinity
            if affinity is None or affinity.pod_anti_affinity is None:
                continue
            for term in affinity.pod_anti_affinity.required:
                try:
                    spec = _group_spec(
                        GRP_ANTI, term.topology_key, term.label_selector, UNLIMITED,
                        term_namespaces(pod, term),
                    )
                except KernelUnsupported:
                    # an unrepresentable anti key/scope only matters if it can
                    # gate a scheduling pod: selector match within the term's
                    # static scope (or any pod when the scope is dynamic)
                    if term.namespace_selector is not None:
                        scoped = list(pods)
                    else:
                        scope_ns = term_namespaces(pod, term)
                        scoped = [p for p in pods if (p.namespace or "") in scope_ns]
                    if term.label_selector is not None and any(
                        term.label_selector.matches(p.metadata.labels) for p in scoped
                    ):
                        raise
                    continue
                extra_anti.append((spec, term.label_selector))
        extra_ports = [key for pod in bound_pods or [] for key in pod_port_keys(pod)]
        snapshot = encode_snapshot(
            pods, self.provisioners, self.templates, self.instance_types,
            extra_requirement_sets=extra,
            extra_anti_groups=extra_anti,
            cache_host=self,
            extra_host_ports=extra_ports,
            classes=classes,
        )
        snapshot.class_volumes = self._resolve_class_volumes(snapshot.classes, state_nodes)
        policy_planes.attach_planes(snapshot, self._it_by_name, config=self.policy,
                                    provider=self.cloud_provider)
        return snapshot

    def _resolve_class_volumes(self, classes, state_nodes) -> list:
        """Per-class volume profile for the attach-limit planes
        (volumeusage.go:65-90 resolution).  Each entry:

          {"shared": {driver: {pvc ids}}, "per_pod": {driver: count}}

        Only drivers with a finite limit on some state node can ever bind
        (new nodes have no CSINode), so claims on unlimited drivers are
        dropped up front.  For the rest a class must be either SHARED (every
        member mounts the same claim set: the per-node contribution is
        count-independent) or PERPOD (members mount pairwise-disjoint sets
        with equal per-driver counts, nothing overlapping other classes or
        already-mounted sets: the contribution is count-dependent).
        Anything else, and any unresolvable reference, raises
        KernelUnsupported: the host path takes the batch."""
        empty = [{"shared": {}, "per_pod": {}} for _ in classes]
        if self.kube_client is None:
            return empty
        limited = {
            driver
            for state_node in state_nodes or []
            for driver in state_node.volume_limits()
        }
        has_claims = any(
            v.persistent_volume_claim is not None
            for cls in classes
            for v in cls.pods[0].spec.volumes
        )
        if not limited or not has_claims:
            return empty

        mounted_ids = {
            pvc_id
            for state_node in state_nodes or []
            for driver, ids in state_node.volume_usage().volumes.items()
            if driver in limited
            for pvc_id in ids
        }
        usage = VolumeUsage(self.kube_client)
        resolve_cache: Dict[tuple, dict] = {}  # claim names -> limited-driver sets

        def resolve(pod) -> dict:
            key = (
                pod.namespace or "",
                tuple(sorted(
                    v.persistent_volume_claim.claim_name
                    for v in pod.spec.volumes
                    if v.persistent_volume_claim is not None
                )),
            )
            hit = resolve_cache.get(key)
            if hit is None:
                volumes, err = usage._validate(pod)
                if err is not None:
                    raise KernelUnsupported(f"volume resolution: {err}")
                hit = {d: ids for d, ids in volumes.items() if d in limited}
                resolve_cache[key] = hit
            return hit

        class_volumes = []
        seen: Dict[str, int] = {}  # pvc id -> class index
        for c, cls in enumerate(classes):
            if cls.is_ladder_variant:
                # ladder variants schedule the ROOT's pods, so they carry the
                # root's volume profile (backfilled below)
                class_volumes.append(None)
                continue
            member_sets = [resolve(pod) for pod in cls.pods]
            first = member_sets[0]
            for ids in first.values():
                for pvc_id in ids:
                    if seen.setdefault(pvc_id, c) != c:
                        raise KernelUnsupported(
                            f"pvc {pvc_id} shared across pod classes not kernel-supported"
                        )
            if all(m == first for m in member_sets):
                class_volumes.append({"shared": first, "per_pod": {}})
                continue
            counts = {d: len(ids) for d, ids in first.items()}
            all_ids: set = set()
            for m in member_sets:
                if {d: len(ids) for d, ids in m.items()} != counts:
                    raise KernelUnsupported(
                        "mixed volume shapes within a pod class not kernel-supported"
                    )
                for ids in m.values():
                    for pvc_id in ids:
                        if pvc_id in all_ids or pvc_id in mounted_ids:
                            raise KernelUnsupported(
                                f"pvc {pvc_id} shared across pods not kernel-supported"
                            )
                        if seen.setdefault(pvc_id, c) != c:
                            raise KernelUnsupported(
                                f"pvc {pvc_id} shared across pod classes not kernel-supported"
                            )
                        all_ids.add(pvc_id)
            class_volumes.append({"shared": {}, "per_pod": counts})
        # backfill variants with their root's profile (chain order: the root
        # always precedes its variants in the finalized class list)
        index_of = {id(cls): c for c, cls in enumerate(classes)}
        for c, cls in enumerate(classes):
            if cls.relax_to is not None:
                class_volumes[index_of[id(cls.relax_to)]] = class_volumes[c]
        return class_volumes

    def encode_existing(self, snapshot: EncodedSnapshot, state_nodes: list,
                        bound_pods: Optional[List[Pod]] = None):
        """(ExistingState, ExistingStatic) numpy planes of the existing
        nodes; the per-group member/owner node counts seed the solve's
        topology counts.

        Mirrors ExistingNode construction (existingnode.go:43-75): available
        capacity, remaining daemonset overhead, label requirements, taints
        without the ephemeral ones; and topology countDomains
        (topology.go:231-276) for the bound pods."""
        vocab = snapshot.vocab
        E = max(len(state_nodes), 1)
        C = len(snapshot.classes)
        R = len(snapshot.resources)
        Z = len(snapshot.zones)
        CT = len(snapshot.capacity_types)
        K, W = vocab.n_keys, vocab.width

        G1 = len(snapshot.groups) + 1
        used = np.zeros((E, R), dtype=np.float32)
        alloc = np.zeros((E, R), dtype=np.float32)
        kmask = np.ones((E, K, W), dtype=bool)
        kdef = np.zeros((E, K), dtype=bool)
        kneg = np.zeros((E, K), dtype=bool)
        kgt = np.full((E, K), -np.inf, dtype=np.float32)
        klt = np.full((E, K), np.inf, dtype=np.float32)
        zone = np.zeros((E, Z), dtype=bool)
        ct = np.zeros((E, CT), dtype=bool)
        pod_count = np.zeros(E, dtype=np.int32)
        open_ = np.zeros(E, dtype=bool)
        init = np.zeros(E, dtype=bool)
        tol = np.zeros((C, E), dtype=bool)
        P = len(snapshot.ports)
        ports = np.zeros((E, P), dtype=bool)
        grp_node_member = np.zeros((G1, E), dtype=np.int32)
        grp_node_owner = np.zeros((G1, E), dtype=np.int32)
        node_capacity = np.zeros((E, R), dtype=np.float32)
        node_tmpl = np.zeros(E, dtype=np.int32)
        node_owned = np.zeros(E, dtype=bool)
        port_idx = {key: i for i, key in enumerate(snapshot.ports)}
        tmpl_index = {t.provisioner_name: i for i, t in enumerate(self.templates)}
        tmpl_by_name = {t.provisioner_name: t for t in self.templates}
        zone_idx = {z: i for i, z in enumerate(snapshot.zones)}
        ct_idx = {c: i for i, c in enumerate(snapshot.capacity_types)}

        for e, state_node in enumerate(state_nodes):
            node = state_node.node
            available = state_node.available()
            for r, name in enumerate(snapshot.resources):
                alloc[e, r] = available.get(name, 0.0)
            template = tmpl_by_name.get(
                node.metadata.labels.get(labels_api.PROVISIONER_NAME_LABEL_KEY, "")
            )
            if template is not None and template.requests:
                remaining = resources_util.subtract(
                    template.requests, state_node.daemon_set_requests()
                )
                for r, name in enumerate(snapshot.resources):
                    used[e, r] = max(remaining.get(name, 0.0), 0.0)
            reqs = Requirements.from_labels(node.metadata.labels)
            kmask[e], kdef[e], kneg[e], kgt[e], klt[e] = vocab.encode_requirements(reqs)
            z = node.metadata.labels.get(labels_api.LABEL_TOPOLOGY_ZONE)
            if z is None:
                zone[e, :] = True  # unknown zone: any
            elif z in zone_idx:
                zone[e, zone_idx[z]] = True
            c_label = node.metadata.labels.get(labels_api.LABEL_CAPACITY_TYPE)
            if c_label is None:
                ct[e, :] = True
            elif c_label in ct_idx:
                ct[e, ct_idx[c_label]] = True
            open_[e] = True
            init[e] = state_node.initialized()
            capacity = state_node.capacity()
            for r, name in enumerate(snapshot.resources):
                node_capacity[e, r] = capacity.get(name, 0.0)
            t_idx = tmpl_index.get(
                node.metadata.labels.get(labels_api.PROVISIONER_NAME_LABEL_KEY, "")
            )
            if t_idx is not None:
                node_tmpl[e] = t_idx
                node_owned[e] = True
            taints = Taints.of(state_node.taints())
            for c, cls in enumerate(snapshot.classes):
                tol[c, e] = taints.tolerates(cls.pods[0]) is None

        # pre-existing pod counts per topology group (countDomains semantics,
        # topology.go:231-276): members (forward) and anti-term owners
        # (inverse); pods being scheduled this solve are excluded
        node_index = {n.node.name: e for e, n in enumerate(state_nodes)}
        group_of = {spec: g for g, spec in enumerate(snapshot.groups)}
        scheduling_uids = {p.uid for cls in snapshot.classes for p in cls.pods}
        for pod in bound_pods or []:
            e = node_index.get(pod.spec.node_name)
            if e is None or pod.uid in scheduling_uids:
                continue
            for key in pod_port_keys(pod):
                i = port_idx.get(key)
                if i is not None:
                    ports[e, i] = True
            for g, scope in enumerate(snapshot.group_selectors):
                if scope is not None and scope.matches_pod(pod):
                    grp_node_member[g, e] += 1
            affinity = pod.spec.affinity
            if affinity is not None and affinity.pod_anti_affinity is not None:
                for term in affinity.pod_anti_affinity.required:
                    try:
                        spec = _group_spec(
                            GRP_ANTI, term.topology_key, term.label_selector,
                            UNLIMITED, term_namespaces(pod, term),
                        )
                    except Exception:  # noqa: BLE001 - unsupported keys don't track
                        continue
                    g = group_of.get(spec)
                    if g is not None:
                        grp_node_owner[g, e] += 1

        # volume attach-limit planes (volumeusage.go:33-236 as per-driver
        # counters; existingnode.go:77-130 enforcement).  Only existing nodes
        # carry limits (CSINode); the axis covers drivers mounted by a
        # scheduling class plus drivers already over their limit (which
        # block every add, volume-less pods included)
        class_volumes = snapshot.class_volumes or [
            {"shared": {}, "per_pod": {}} for _ in snapshot.classes
        ]
        drivers = sorted(
            {d for vols in class_volumes for d in vols["shared"]}
            | {d for vols in class_volumes for d in vols["per_pod"]}
        )
        for state_node in state_nodes:
            limits = state_node.volume_limits()
            mounted = state_node.volume_usage().volumes
            for d, lim in limits.items():
                if d not in drivers and len(mounted.get(d, ())) > lim:
                    drivers.append(d)
        D = max(len(drivers), 1)
        vol_used = np.zeros((E, D), dtype=np.int32)
        vol_limit = np.full((E, D), UNLIMITED, dtype=np.int32)
        cls_vol_add = np.zeros((C, E, D), dtype=np.int32)
        cls_vol_per_pod = np.zeros((C, D), dtype=np.int32)
        for i, d in enumerate(drivers):
            for c, vols in enumerate(class_volumes):
                cls_vol_per_pod[c, i] = vols["per_pod"].get(d, 0)
        for e, state_node in enumerate(state_nodes):
            mounted = state_node.volume_usage().volumes
            limits = state_node.volume_limits()
            for i, d in enumerate(drivers):
                have = mounted.get(d, set())
                vol_used[e, i] = len(have)
                if d in limits:
                    vol_limit[e, i] = limits[d]
                for c, vols in enumerate(class_volumes):
                    new = vols["shared"].get(d)
                    if new:
                        cls_vol_add[c, e, i] = len(new - have)

        ex_state = solve_ops.ExistingState(
            used=used, kmask=kmask, kdef=kdef, kneg=kneg, kgt=kgt, klt=klt, zone=zone, ct=ct,
            ports=ports, vol_used=vol_used, pod_count=pod_count, open_=open_,
        )
        ex_static = solve_ops.ExistingStatic(
            alloc=alloc, init=init, tol=tol, grp_node_member=grp_node_member,
            grp_node_owner=grp_node_owner, node_capacity=node_capacity, node_tmpl=node_tmpl,
            node_owned=node_owned, vol_limit=vol_limit, cls_vol_add=cls_vol_add,
            cls_vol_per_pod=cls_vol_per_pod,
        )
        return ex_state, ex_static

    # -- device half ----------------------------------------------------------

    def prepare_encoded(self, snapshot: EncodedSnapshot, state_nodes: Optional[list] = None,
                        bound_pods: Optional[List[Pod]] = None, n_slots: int = 0) -> SolvePrep:
        """Kernel inputs for one encoded snapshot, the existing-node planes
        included, bucket-padded and on the solver's device.  The wall time of
        ``encode_existing`` lands in ``stages["encode_existing_s"]``."""
        ex_state = ex_static = None
        t0 = time.perf_counter()
        if state_nodes:
            ex_state, ex_static = self.encode_existing(snapshot, state_nodes, bound_pods)
        self.stages["encode_existing_s"] = time.perf_counter() - t0
        if n_slots <= 0:
            n_slots = solve_ops.estimate_slots(snapshot)
        features = solve_ops.features_with_existing(snapshot, ex_static)
        cls, statics_arrays, key_has_bounds = solve_ops.prepare_host(snapshot)
        real_rows = int(np.count_nonzero(cls.count))
        cls, statics_arrays, key_has_bounds, ex_state, ex_static = solve_ops.pad_planes(
            cls, statics_arrays, key_has_bounds, ex_state, ex_static,
            device_finish=solve_ops.encode_device_finish_enabled(), device=self.device,
            use_kernels=self.use_kernels,
        )
        cls_t, sa_t, khb = carry.tensors_from_numpy(cls, statics_arrays, key_has_bounds, self.device)
        if ex_state is not None:
            ex_state, ex_static = carry.existing_from_numpy(ex_state, ex_static, self.device)
        return SolvePrep(cls=cls_t, statics_arrays=sa_t, key_has_bounds=khb, ex_state=ex_state,
                         ex_static=ex_static, n_slots=n_slots, n_passes=snapshot.scan_passes,
                         features=features, pol=_attach_pol(snapshot, sa_t, self.device),
                         real_rows=real_rows)

    def run_prepared(self, prep: SolvePrep, count=None, warm_carry=None, repair_plan=None,
                     n_slots: int = 0, donate_carry=None) -> solve_ops.SolveOutputs:
        """Run the solve on a SolvePrep; returns device-resident outputs.
        ``count`` overrides the class-count vector (a repair passes only the
        delta pods; uploaded as int32 on the prep's device); ``warm_carry``
        resumes from a previous solve's final carry (``ops.solve.WarmCarry``,
        whose existing-node state replaces the prep's) and ``repair_plan``
        carries the freed-hole preferences and out-of-window bases
        (``ops.solve.RepairPlan``).

        A cold call (neither ``warm_carry`` nor ``repair_plan``) first routes
        by solver family (``solver.modes``, the reference's :1013-1040): the
        relax family runs the batch unless it declines, and the scan runs it
        then as if relax never existed.  A repair never routes, which also
        keeps the relax family's own repair from re-entering it.  ``n_slots``
        overrides the prep's slot count of a cold call; a repair takes the
        carry's (its window width), whatever ``n_slots`` says.

        A warm dispatch donates its carry when ``donate_carry`` says so (None:
        ``utils.pipeline.donation_enabled()``); an enabled policy forces
        donation off, since its decode reads the final state planes on the
        card after the dispatch.  The decision is the ledger's
        (``pipeline.record_donation``) and ``solve_core``'s: the scan
        commits into a donated carry's slot planes in place (K23), and
        clones a carry that is not donated once at entry.  The carry is
        consumed in place around the scan too, by K21 before the dispatch
        and K22 after it (``solver.incremental``).  The caller of a donating
        dispatch must not read ``warm_carry`` again."""
        cls = prep_classes(prep, count)
        donate = False
        if warm_carry is not None:
            donate = pipeline_mod.donation_enabled() if donate_carry is None else donate_carry
            if self.policy is not None and getattr(self.policy, "enabled", False):
                donate = False
            pipeline_mod.record_donation(bool(donate))
        if warm_carry is None and repair_plan is None:
            self.stages.pop("relax_s", None)
            self.stages.pop("relax_repair_s", None)
            self.last_solve_mode = "scan"
            mode = modes_mod.resolve_mode(self.policy)
            if mode != modes_mod.MODE_SCAN:
                n_pods = int(cls.count.sum())
                if modes_mod.relax_selected(mode, n_pods):
                    from karpenter_core_tpu_torch.relax import solve as relax_solve

                    try:
                        out = relax_solve.run_relax(self, prep, cls=cls, n_slots=n_slots)
                    except relax_solve.RelaxFallback as fb:
                        self.last_solve_mode = f"relax-fallback:{fb.reason}"
                    else:
                        self.last_solve_mode = "relax"
                        return out
        return solve_ops.solve_core(
            cls, prep.statics_arrays, n_slots or prep.n_slots, prep.key_has_bounds,
            None if warm_carry is not None else prep.ex_state, prep.ex_static,
            n_passes=prep.n_passes, features=compilecache.snap_features(prep.features),
            use_kernels=self.use_kernels, warm_carry=warm_carry, repair_plan=repair_plan,
            donate_carry=bool(donate),
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

    def begin_fetch(self, outputs: solve_ops.SolveOutputs,
                    ring: Optional[pipeline_mod.HostStagingRing] = None
                    ) -> pipeline_mod.FetchTicket:
        """Split decode's fetch from its dispatch: a ``utils.pipeline.
        FetchTicket`` over the small planes decode consumes — (assign,
        assign_existing, failed, spread_suspect, ex_state.zone, pod_count,
        tmpl_id, open_, n_next), staged through ``ring`` when given — with
        the K4-packed big planes following on the copy stream
        (``ticket.planes``).  ``ticket.wait()`` is the barrier;
        ``decode(..., fetched=ticket)`` then reads the host only."""
        state = outputs.state
        small = (outputs.assign, outputs.assign_existing, outputs.failed, outputs.spread_suspect,
                 outputs.ex_state.zone, state.pod_count, state.tmpl_id, state.open_,
                 state.n_next)
        ticket = pipeline_mod.FetchTicket(small, ring=ring, label="decode")
        ticket.planes = _LazyPlanes(state, self._pack_bool(), ticket)
        return ticket

    def solve(self, pods, state_nodes: Optional[list] = None,
              bound_pods: Optional[List[Pod]] = None, n_slots: int = 0) -> CudaSolveResults:
        """The entry point: encode, prepare, solve, decode.  Stage wall times
        land in ``self.stages``: ``encode_s``, ``encode_existing_s`` (the
        existing-node planes), ``solve_s`` (prepare and the device solve, the
        existing-node planes excluded) and ``decode_s``."""
        t0 = time.perf_counter()
        snapshot = self.encode(pods, state_nodes, bound_pods)
        t1 = time.perf_counter()
        results = self.solve_encoded(snapshot, state_nodes, bound_pods, n_slots, t_start=t1)
        self.stages["encode_s"] = t1 - t0
        return results

    def solve_encoded(self, snapshot: EncodedSnapshot, state_nodes: Optional[list] = None,
                      bound_pods: Optional[List[Pod]] = None, n_slots: int = 0,
                      t_start: Optional[float] = None) -> CudaSolveResults:
        t1 = time.perf_counter() if t_start is None else t_start
        prep = self.prepare_encoded(snapshot, state_nodes, bound_pods, n_slots)
        outputs = self.run_prepared(prep)
        fetched = self.begin_fetch(outputs)
        slots = outputs.assign.shape[1]
        if self.fetch_exhausted(fetched.wait(), slots):  # the solve's one barrier
            # slot exhaustion: retry once with double capacity
            outputs = self.run_prepared(prep, n_slots=slots * 2)
            fetched = self.begin_fetch(outputs)
        t2 = time.perf_counter()
        results = self.decode(snapshot, outputs, state_nodes, fetched=fetched)
        self.stages["solve_s"] = t2 - t1 - self.stages["encode_existing_s"]
        self.stages["decode_s"] = time.perf_counter() - t2
        self.last_outputs = outputs
        return results

    def decode(self, snapshot: EncodedSnapshot, outputs: solve_ops.SolveOutputs,
               state_nodes: Optional[list] = None,
               fetched: Optional[pipeline_mod.FetchTicket] = None) -> CudaSolveResults:
        """The solve's results from its fetch ticket (``begin_fetch``; one is
        started when none is given): after the ticket's barrier nothing is
        read from the card, the policy objective's selection apart."""
        fetched = fetched if fetched is not None else self.begin_fetch(outputs)
        # per-pod failure comes from the leftover walk below, not the counts
        (assign, assign_ex, _, suspect, ex_zone, pod_count, tmpl_id, open_,
         n_next) = fetched.wait()
        planes = fetched.planes
        results = CudaSolveResults(n_slots_used=int(n_next))
        nodes: Dict[int, CudaNodeDecision] = {}
        provisioner_names = [t.provisioner_name for t in self.templates]
        for n in np.nonzero(open_ & (pod_count > 0))[0]:
            n = int(n)
            nodes[n] = CudaNodeDecision(provisioner_names[int(tmpl_id[n])], snapshot, planes, n)

        state_nodes = state_nodes or []
        # preference-ladder variants schedule pods from their ROOT's list: all
        # rows of one ladder share a cursor into the root's (identical) pods
        n_classes = len(snapshot.classes)
        if snapshot.cls_root is not None:
            root_of = [int(r) for r in snapshot.cls_root]
        else:
            root_of = list(range(n_classes))
        cursors = [0] * n_classes  # keyed by root index
        assigned_ex_idx: set = set()
        for c in range(n_classes):
            r = root_of[c]
            pods, cursor = snapshot.classes[r].pods, cursors[r]
            # existing-node placements first (the solve tried them first)
            ex_idx = np.nonzero(assign_ex[c] > 0)[0]
            for e, take in zip(ex_idx.tolist(), assign_ex[c][ex_idx].tolist()):
                if e < len(state_nodes):
                    name = state_nodes[e].node.name
                    results.existing_assignments.setdefault(name, []).extend(
                        pods[cursor: cursor + take]
                    )
                    assigned_ex_idx.add(e)
                cursor += take
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
        # zone commitments on existing nodes (singleton post-solve masks)
        for e in sorted(assigned_ex_idx):
            mask = ex_zone[e]
            if int(mask.sum()) == 1:
                z = int(np.argmax(mask))
                if z < len(snapshot.zones):
                    results.existing_committed_zones[state_nodes[e].node.name] = (
                        snapshot.zones[z]
                    )
        results.new_nodes = [nodes[n] for n in sorted(nodes)]
        self._apply_policy_selection(snapshot, outputs, results)
        return results

    def _apply_policy_selection(self, snapshot: EncodedSnapshot,
                                outputs: solve_ops.SolveOutputs,
                                results: CudaSolveResults) -> None:
        """The policy objective folded into decode (the reference's
        ``decode.objective`` stage): one K13 launch over every slot's
        feasible offering cells, stamped onto the new nodes so the launch
        lands on the selected offering.  Nothing runs unless the policy is
        on; its wall seconds land in ``stages["objective_s"]``."""
        config = self.policy
        if config is None or not getattr(config, "enabled", False):
            return
        planes = policy_planes.planes_of(snapshot)
        if planes is None:
            return
        t0 = time.perf_counter()
        selection = objective_ops.select_for_state(
            outputs.state, planes, config, snapshot.capacity_types, use_kernels=self.use_kernels)
        for decision in results.new_nodes:
            n = decision._slot
            if not bool(selection.active[n]):
                continue
            decision.selected = {
                "instance_type": snapshot.it_names[int(selection.sel_it[n])],
                "zone": snapshot.zones[int(selection.sel_zone[n])],
                "capacity_type": snapshot.capacity_types[int(selection.sel_ct[n])],
                "price": float(selection.price[n]),
                "expected": float(selection.expected[n]),
            }
        results.fleet_cost = float(selection.fleet_cost)
        results.fleet_expected_cost = float(selection.fleet_expected)
        self.last_selection = selection
        self.stages["objective_s"] = time.perf_counter() - t0

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
