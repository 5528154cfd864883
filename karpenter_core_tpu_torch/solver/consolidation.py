"""Multi-node consolidation search on the card.

The port of ``karpenter_core_tpu/solver/consolidation.py``: the prefix sweep
(``ops.consolidate``) simulates closing the first k disruption-sorted
candidates for up to ``MAX_LANES`` values of k per pass; the host applies the
reference's validity rules (consolidation.go:190-290) to each lane — price
filtering, the spot-to-spot prohibition, the same-type price sanity filter —
and keeps the largest valid prefix, refining the bracket around it until the
boundary is exact.

    search = CudaConsolidationSearch(provider, provisioners)   # device=None: CUDA
    command = search.compute_command(candidates, pending_pods, state_nodes, bound_pods)

``candidates`` are ``controllers.deprovisioning.CandidateNode``s sorted by
disruption cost; ``state_nodes`` the cluster's ``state.cluster.StateNode``s
and ``bound_pods`` the pods bound to them.  With a ``policy.PolicyConfig``
that enables the objective (``CudaConsolidationSearch(..., policy=...)``)
lanes are scored by fleet-cost saving instead: the removed nodes' current
price less the lane's replacement cost (K9's ``new_cost``), the largest
saving winning, the larger prefix on a tie.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from dataclasses import replace as dc_replace
from typing import Dict, List, Optional

import numpy as np
import torch

from karpenter_core_tpu_torch.apis import labels as labels_api
from karpenter_core_tpu_torch.apis.objects import OP_IN, Pod
from karpenter_core_tpu_torch.cloudprovider import InstanceType
from karpenter_core_tpu_torch.controllers.deprovisioning import (
    Action,
    CandidateNode,
    Command,
    filter_by_price,
    filter_out_same_type,
)
from karpenter_core_tpu_torch.ops import consolidate as consolidate_ops
from karpenter_core_tpu_torch.scheduling import Requirement, Requirements
from karpenter_core_tpu_torch.solver.cuda import CudaSolver

MAX_LANES = 64


def search_largest_prefix(n, evaluate, refine: bool = True):
    """Largest valid consolidation prefix via batched lane sweeps.

    ``evaluate(sizes) -> (best_command_or_None, best_k)`` runs one sweep
    over the given prefix sizes and reports the largest valid one.  Up to
    MAX_LANES sizes cover [1, n] per pass; when the coarse grid leaves a gap
    between the best lane and the next, further passes re-grid the bracket,
    shrinking it ~MAX_LANES x each time — the boundary pins exactly in
    ceil(log64(n)) passes (2 up to 4096 candidates, 3 to 256k) against the
    reference's ~log2(n) sequential simulations
    (multinodeconsolidation.go:86-113).

    ``refine=False`` stops after the coarse pass: cost-delta scoring picks
    its optimum within a pass, and the refinement's larger-k-wins bracket
    would let a larger prefix with a smaller saving displace it."""
    if n <= MAX_LANES:
        sizes = np.arange(1, n + 1, dtype=np.int32)
    else:
        sizes = np.unique(np.round(np.linspace(1, n, MAX_LANES)).astype(np.int32))
    best, best_k = evaluate(sizes)
    if n <= MAX_LANES or best is None or not refine:
        return best

    lo = best_k
    hi = int(sizes[np.searchsorted(sizes, best_k) + 1]) if best_k < int(sizes[-1]) else None
    while hi is not None and hi - lo > 1:
        span = np.arange(lo + 1, hi, dtype=np.int32)
        if len(span) > MAX_LANES:
            span = np.unique(
                np.round(np.linspace(lo + 1, hi - 1, MAX_LANES)).astype(np.int32)
            )
        refined, refined_k = evaluate(span)
        if refined is not None and refined_k > lo:
            best, best_k = refined, refined_k
            lo = refined_k
            if refined_k < int(span[-1]):
                hi = int(span[np.searchsorted(span, refined_k) + 1])
            # else: the bracket (refined_k, hi) is already one grid interval
        else:
            hi = int(span[0])
    return best


@dataclass
class CudaReplacement:
    """A launchable replacement: template, instance-type options, requests
    and the pods it takes (duck-typed like ``solver.cuda.LaunchableNode``)."""

    template: object
    instance_type_options: List[InstanceType]
    requests: dict
    pods: List[Pod] = field(default_factory=list)

    @property
    def provisioner_name(self) -> str:
        return self.template.provisioner_name

    @property
    def requirements(self) -> Requirements:
        return self.template.requirements


class CudaConsolidationSearch:
    """The sweep on one device (``device=None``: the CUDA card; raises when
    there is none).  ``use_kernels=False`` runs every kernel's plain twin.

    After ``compute_command``: ``stages`` holds its wall seconds by stage
    (``encode_s``, ``encode_existing_s``, ``prepare_s``, ``decode_s`` and
    ``sweep_s``, a list with one entry per pass); ``passes`` each pass's
    prefix sizes and the host copy of its ``SweepOutputs``; ``prepared`` the
    (snapshot, ``SweepPrep``) the passes ran on."""

    def __init__(self, cloud_provider, provisioners, device=None,
                 use_kernels: bool = True, policy=None) -> None:
        # policy (policy.PolicyConfig): enabled, lanes are scored by fleet-cost
        # saving; None or disabled keeps the largest valid prefix
        self.policy = policy
        self.solver = CudaSolver(cloud_provider, provisioners, device=device,
                                 use_kernels=use_kernels, policy=policy)
        self.it_by_name = {
            it.name: it
            for p in self.solver.provisioners
            for it in self.solver.instance_types.get(p.name, [])
        }
        self.stages: Dict[str, object] = {}
        self.passes: List[tuple] = []
        self.prepared: Optional[tuple] = None

    def sweep_inputs(self, candidates: List[CandidateNode], pending_pods: List[Pod],
                     state_nodes: list, bound_pods: Optional[List[Pod]] = None) -> tuple:
        """(snapshot, ex_state, ex_static, rank, ex_cls_count) of one
        consolidation problem, on the host: ``ops.consolidate.run_sweep``'s
        inputs.  Every pod of the candidates joins the pending pods; the
        class counts split into the pending base (``snapshot.cls_count``)
        and the per-node candidate pods.  Raises
        models.snapshot.KernelUnsupported when the pods need the host
        path."""
        candidate_pods = [p for c in candidates for p in c.pods]
        all_pods = list(pending_pods) + candidate_pods
        t0 = time.perf_counter()
        snapshot = self.solver.encode(all_pods, state_nodes, bound_pods)
        t1 = time.perf_counter()
        ex_state, ex_static = self.solver.encode_existing(snapshot, state_nodes, bound_pods)
        self.stages.update(encode_s=t1 - t0, encode_existing_s=time.perf_counter() - t1)

        node_index = {n.node.name: e for e, n in enumerate(state_nodes)}
        candidate_names = {c.node.name for c in candidates}
        n_ex = max(len(state_nodes), 1)
        n_cls = len(snapshot.classes)
        ex_cls_count = np.zeros((n_cls, n_ex), dtype=np.int32)
        base_counts = np.zeros(n_cls, dtype=np.int32)
        for c, cls in enumerate(snapshot.classes):
            if cls.is_ladder_variant:
                continue  # variants hold one representative copy, not real pods
            for pod in cls.pods:
                if pod.spec.node_name and pod.spec.node_name in candidate_names:
                    ex_cls_count[c, node_index[pod.spec.node_name]] += 1
                else:
                    base_counts[c] += 1
        snapshot.cls_count = base_counts

        rank = np.full(n_ex, consolidate_ops.NOT_CANDIDATE, dtype=np.int32)
        for i, candidate in enumerate(candidates):
            rank[node_index[candidate.node.name]] = i
        return snapshot, ex_state, ex_static, rank, ex_cls_count

    def prepare(self, candidates: List[CandidateNode], pending_pods: List[Pod],
                state_nodes: list, bound_pods: Optional[List[Pod]] = None):
        """(snapshot, SweepPrep) of one consolidation problem
        (``sweep_inputs``, then ``ops.consolidate.prepare_sweep`` on the
        solver's device)."""
        t0 = time.perf_counter()
        inputs = self.sweep_inputs(candidates, pending_pods, state_nodes, bound_pods)
        prep = consolidate_ops.prepare_sweep(*inputs, self.solver.device)
        self.stages["prepare_s"] = (time.perf_counter() - t0 - self.stages["encode_s"]
                                    - self.stages["encode_existing_s"])
        return inputs[0], prep

    def compute_command(
        self,
        candidates: List[CandidateNode],
        pending_pods: List[Pod],
        state_nodes: list,
        bound_pods: Optional[List[Pod]] = None,
    ) -> Command:
        """candidates must be disruption-cost sorted.  Raises
        KernelUnsupported when the pod shapes need the host path."""
        self.stages = {"sweep_s": [], "decode_s": 0.0}
        self.passes = []
        self.prepared = None
        if not candidates:
            return Command(Action.DO_NOTHING)
        if not pending_pods and not any(c.pods for c in candidates):
            # no pods anywhere: every candidate is empty, deleting all is
            # trivially valid (the simulation would open zero new nodes)
            return Command(Action.DELETE, [c.node for c in candidates])
        snapshot, prep = self.prepare(candidates, pending_pods, state_nodes, bound_pods)
        self.prepared = (snapshot, prep)
        best = search_largest_prefix(
            len(candidates),
            lambda sizes: self._evaluate_sweep(snapshot, prep, sizes, candidates),
            refine=not self._cost_scoring(),
        )
        return best if best is not None else Command(Action.DO_NOTHING)

    def _candidate_price_cumsum(self, candidates) -> np.ndarray:
        """Cumulative current-offering price of the first-k candidates
        (nan-poisoned past any candidate whose offering is unknown): what a
        prefix's nodes cost now, against a lane's ``new_cost``."""
        prices = np.full(len(candidates), np.nan, dtype=np.float64)
        for i, c in enumerate(candidates):
            offering = c.instance_type.offerings.get(c.capacity_type, c.zone)
            if offering is not None:
                prices[i] = offering.price
        return np.cumsum(prices)

    def _cost_scoring(self) -> bool:
        return self.policy is not None and getattr(self.policy, "enabled", False)

    def _evaluate_sweep(self, snapshot, prep, sizes, candidates):
        """(best command, its prefix size) across the given lane sizes.  By
        default the LARGEST valid prefix wins.  With the policy objective on,
        the largest fleet-cost saving wins — the first k candidates' current
        price less the lane's replacement cost (0 for a DELETE), NaN (an
        unpriced candidate) counting as -inf — and the larger k a tie.  The
        pass's nine planes come to the host in one copy."""
        t0 = time.perf_counter()
        out = consolidate_ops.SweepOutputs(*fetch_planes(
            consolidate_ops.sweep(prep, sizes, use_kernels=self.solver.use_kernels)))
        self.stages["sweep_s"].append(time.perf_counter() - t0)
        self.passes.append((np.asarray(sizes), out))
        t0 = time.perf_counter()
        cost_scoring = self._cost_scoring()
        old_cum = self._candidate_price_cumsum(candidates) if cost_scoring else None
        best: Optional[Command] = None
        best_k = 0
        best_saving = -np.inf
        for lane, k in enumerate(sizes.tolist()):
            cmd = self.lane_command(snapshot, out, lane, candidates[:k])
            if cmd is None:
                continue
            if not cost_scoring:
                best, best_k = cmd, k
                continue
            lane_cost = 0.0 if cmd.action == Action.DELETE else float(out.new_cost[lane])
            saving = float(old_cum[k - 1]) - lane_cost if k >= 1 else 0.0
            if np.isnan(saving):
                saving = -np.inf  # an unpriceable subset is never preferred
            if saving > best_saving or (saving == best_saving and k > best_k):
                best, best_k, best_saving = cmd, k, saving
        self.stages["decode_s"] += time.perf_counter() - t0
        return best, best_k

    def lane_command(self, snapshot, out, lane: int, subset) -> Optional[Command]:
        """The command that closing ``subset`` (a prefix of the candidates)
        gives, from lane ``lane`` of a pass's host ``SweepOutputs``; None when
        the lane is not valid: pods failed, an uninitialized node was used,
        more than one new node opened, or the replacement fails the price
        rules."""
        if out.failed[lane] > 0 or out.used_uninitialized[lane]:
            return None
        if int(out.n_new[lane]) == 0:
            return Command(Action.DELETE, [c.node for c in subset])
        if int(out.n_new[lane]) > 1:
            return None
        replacement = self._decode_replacement(
            snapshot, out.new_viable[lane, 0], out.new_zone[lane, 0], out.new_ct[lane, 0],
            out.new_used[lane, 0], int(out.new_tmpl[lane, 0]), subset,
        )
        if replacement is None:
            return None
        return Command(Action.REPLACE, [c.node for c in subset], [replacement])

    def _decode_replacement(
        self, snapshot, viable_row, zone_row, ct_row, used_row, tmpl_idx, subset
    ) -> Optional[CudaReplacement]:
        options = [
            self.it_by_name[snapshot.it_names[i]]
            for i in np.nonzero(viable_row)[0]
            if snapshot.it_names[i] in self.it_by_name
        ]
        zones = [snapshot.zones[z] for z in np.nonzero(zone_row)[0]]
        cts = [snapshot.capacity_types[c] for c in np.nonzero(ct_row)[0]]
        template = self.solver.templates[tmpl_idx]

        requirements = Requirements(*template.requirements.values())
        if zones:
            requirements.add(Requirement(labels_api.LABEL_TOPOLOGY_ZONE, OP_IN, zones))
        if cts:
            requirements.add(Requirement(labels_api.LABEL_CAPACITY_TYPE, OP_IN, cts))

        # price rules (consolidation.go:227-267)
        old_price = 0.0
        for c in subset:
            offering = c.instance_type.offerings.get(c.capacity_type, c.zone)
            if offering is None:
                return None
            old_price += offering.price
        options = filter_by_price(options, requirements, old_price)
        if not options:
            return None
        all_spot = all(c.capacity_type == labels_api.CAPACITY_TYPE_SPOT for c in subset)
        ct_req = requirements.get(labels_api.LABEL_CAPACITY_TYPE)
        if all_spot and ct_req.has(labels_api.CAPACITY_TYPE_SPOT):
            return None
        if ct_req.has(labels_api.CAPACITY_TYPE_SPOT) and ct_req.has(
            labels_api.CAPACITY_TYPE_ON_DEMAND
        ):
            requirements.add(
                Requirement(labels_api.LABEL_CAPACITY_TYPE, OP_IN, [labels_api.CAPACITY_TYPE_SPOT])
            )
        # same-type price sanity for multi-node (multinodeconsolidation.go:132-165)
        replacement = CudaReplacement(
            template=dc_replace(template, requirements=requirements),
            instance_type_options=options,
            requests={
                name: float(used_row[r])
                for r, name in enumerate(snapshot.resources)
                if used_row[r] > 0
            },
            pods=[p for c in subset for p in c.pods],
        )
        if len(subset) >= 2:
            replacement.instance_type_options = filter_out_same_type(replacement, subset)
            if not replacement.instance_type_options:
                return None
        return replacement


def fetch_planes(out) -> List[np.ndarray]:
    """Every plane of a device-resident NamedTuple on the host, in one
    device-to-host copy: the planes are packed into one byte buffer on the
    device, copied once, and cut apart again."""
    planes = list(out)
    if planes[0].device.type == "cpu":
        return [t.numpy() for t in planes]
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in planes])
    host = flat.cpu().numpy()
    result, offset = [], 0
    for t in planes:
        n = t.numel() * t.element_size()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        result.append(host[offset: offset + n].view(dtype).reshape(tuple(t.shape)).copy())
        offset += n
    return result


__all__ = ["CudaConsolidationSearch", "CudaReplacement", "MAX_LANES", "search_largest_prefix"]
