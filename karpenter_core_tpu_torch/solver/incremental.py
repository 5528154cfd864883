"""Incremental warm-start solving: the warm repair's delta tick, serial or
pipelined.

A trimmed copy of ``karpenter_core_tpu/solver/incremental.py``.  An
``IncrementalSolveSession`` keeps the previous full solve's padded tensors
(``solver.cuda.SolvePrep``, uploaded once by ``prepare_encoded``; a repair
uploads only its count vector, free planes and window, so the reference's
``upload_prep`` has nothing left to do here), its final scan carry
(``ops.solve.WarmCarry``, on the card) and host-side placement bookkeeping;
each reconcile a ``FallbackPolicy`` decides **full** vs **delta**:

  full    encode → commit to the SnapshotStore → solve from scratch → adopt
          the carry.  On the first solve, on any supply-side change (nodes,
          bound pods, provisioners, catalog), on an unseen class, when the
          delta fraction exceeds ``max_delta_fraction``, as the periodic
          ``audit_interval`` audit, and when a repair ran out of room.
  delta   no encode: the evicted pods' capacity and counts go back to the
          carry (K10), a bounded window of dirty slots is gathered (K11),
          the class scan resumes from the carry with counts for only the new
          (and still-failed) pods through K1-K7, and the window is scattered
          back (K12).

    session = IncrementalSolveSession(solver, FallbackPolicy(...))
    results = session.solve(ingest)                  # a models.columnar.PodIngest
    results = session.solve(ingest, state_nodes, bound_pods)
    handle = session.solve(ingest, deferred=True)    # PendingResults; .result()

A delta tick returns only that tick's placements.  ``window_min`` is the
repair window's smallest size (the reference's ``KC_DELTA_WINDOW``): None
means ``min(256, n_slots // 4)``, 0 turns windowing off.

``deferred=True`` runs the tick through the double-buffered pipeline
(``utils/pipeline.py``): the repair dispatches, its fetch ticket starts the
copies home on the copy stream, and the call returns a ``PendingResults``;
the barrier (bounded by the watchdog), the bookkeeping and the decode settle
at the NEXT solve's entry or at ``result()``, so the next tick's planning
overlaps this tick's copies.  A barrier that times out re-anchors the
lineage from the population captured at dispatch (reason
``watchdog-timeout``); a window that ran out re-anchors the same way
(``slots-exhausted``).  With the pipeline on (``KC_PIPELINE``, default on),
repairs also donate the carry: K21 frees the evictions in the carry's own
planes and K22 writes the window back into them, where K10 and K12 write
fresh full-width planes.  The anchor's carry is copied once at adoption so
that it owns its planes.  Hooked dispatches and an enabled policy never
donate.  ``KC_PIPELINE=0`` settles every handle inline, K10 and K12: the
serial loop.

A full solve routes by solver family like any cold solve
(``CudaSolver.run_prepared``); the anchor records the family it was
configured for (``solver.modes.resolve_mode`` at adopt time), and a later
flip of that configuration re-anchors with reason ``mode-changed``: repairs
always run the scan.

``run_prepared=`` is the dispatch hook a host (the tenant plane,
``service/tenant.py``) routes the device work through: every full solve,
its slot-exhaustion retry and every repair dispatch call
``run_prepared(prep, **kw)`` in place of ``solver.run_prepared``.

Left out, each for a later slice: prebuilt PodClass lists as the caller's
population (the port takes a PodIngest; a deferred tick's re-anchor encodes
the class list it captured); the fleet checkpoint's ``lineage_state``,
``export_lineage`` and ``adopt_restored``; ``decide``'s ``mesh_changed``
(the mesh); the ``SOLVE_MODE`` counter, the tracing span, the
``SOLVER_DISPATCH`` chaos hook and ``from_env`` / ``incremental_enabled``.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from dataclasses import replace as dc_replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from karpenter_core_tpu_torch.models import store as store_mod
from karpenter_core_tpu_torch.models.store import SnapshotStore, VersionedSnapshot, diff_members
from karpenter_core_tpu_torch.ops import solve as solve_ops
from karpenter_core_tpu_torch.policy import planes as policy_planes
from karpenter_core_tpu_torch.solver import modes as modes_mod
from karpenter_core_tpu_torch.utils import pipeline as pipeline_mod
from karpenter_core_tpu_torch.utils.watchdog import SolveTimeout

MODE_FULL = "full"
MODE_DELTA = "delta"


def _resolve_solve_mode(solver) -> str:
    """The solver family this session's anchors are configured to route
    through (``solver.modes.resolve_mode`` over the solver's policy)."""
    return modes_mod.resolve_mode(getattr(solver, "policy", None))


@dataclass
class FallbackPolicy:
    """Per-reconcile full-vs-delta decision (module docstring)."""

    enabled: bool = True
    # delta fraction (added + evicted over population) above which a full
    # solve is both faster and drift-free
    max_delta_fraction: float = 0.25
    # delta reconciles between full-solve audits (0 = never audit)
    audit_interval: int = 16
    # sessions whose decisions become real nodes repair only while the
    # previous solve opened no new slot
    materialized: bool = False

    def decide(self, delta, delta_ticks: int, prev_slots_used: int,
               known_classes=None, mode_changed: bool = False) -> Tuple[str, str]:
        """(mode, reason).  ``delta`` is a models.store.SnapshotDelta (None on
        the first solve); ``delta_ticks`` counts repairs since the last full
        solve; ``prev_slots_used`` the slots the lineage has opened;
        ``known_classes`` the class keys the previous padded tensors can
        express (an unseen key means the class axis moved).
        ``mode_changed``: the configured solver family no longer matches the
        one the anchor solved under; a relax anchor is a valid lineage
        anchor, but repairs always run the scan, so a flip re-anchors."""
        if not self.enabled:
            return MODE_FULL, "disabled"
        if delta is None:
            return MODE_FULL, "first"
        if mode_changed:
            return MODE_FULL, "mode-changed"
        if delta.node_side_changed:
            return MODE_FULL, "supply-changed:" + ",".join(delta.changed_planes)
        unknown = tuple(
            k for k in delta.new_classes
            if known_classes is None or k not in known_classes
        )
        if unknown:
            return MODE_FULL, "class-shape"
        if self.materialized and prev_slots_used > 0:
            return MODE_FULL, "materialized-slots"
        if self.audit_interval and delta_ticks >= self.audit_interval:
            return MODE_FULL, "audit"
        if delta.delta_fraction > self.max_delta_fraction:
            return MODE_FULL, f"delta-fraction:{delta.delta_fraction:.3f}"
        return MODE_DELTA, "delta"


@dataclass
class _WarmState:
    """Everything one delta reconcile needs, carried from the last full solve
    and updated by every repair."""

    versioned: VersionedSnapshot
    prep: object  # solver.cuda.SolvePrep (padded tensors on the card; reused)
    carry: object  # ops.solve.WarmCarry (on the card)
    assign: np.ndarray  # i32[C_pad, N] cumulative new-slot placements
    assign_ex: np.ndarray  # i32[C_pad, E_pad] cumulative existing placements
    n_next: int  # slots the scan has opened so far
    members: Dict[tuple, Tuple[str, ...]]  # class key -> live member uids
    class_index: Dict[tuple, int]  # class key -> class row
    pod_loc: Dict[str, Tuple[int, str, int]]  # uid -> (row, "new"|"ex", idx)
    row_key: Dict[int, tuple]  # class row -> class key
    failed_pods: Dict[str, Tuple[int, object]]  # uid -> (row, Pod), unplaced
    member_rows: torch.Tensor  # i32[C_pad, G1] topology membership (card)
    own_inv_rows: torch.Tensor  # i32[C_pad, G1] inverse ownership (card)
    supply: str
    state_nodes: list = field(default_factory=list)
    delta_ticks: int = 0
    # the solver family the anchor was configured to run under (the routing
    # intent, not a relax-fallback outcome): a later flip escalates with
    # reason "mode-changed"
    solve_mode: str = modes_mod.MODE_SCAN
    # lineage-placed pods that have since bound (IncrementalSolveSession.
    # _absorb_bound)
    materialized: set = field(default_factory=set)


@dataclass
class _PendingTick:
    """One dispatched-but-unsettled deferred tick (the pipeline's in-flight
    slot).  ``kind`` is "delta" (``data`` holds the dispatch record, the
    post-tick membership and the population captured at dispatch, which a
    settle-time exhaustion or timeout re-anchors from) or "full" (``data``
    holds the committed snapshot, the prep, the outputs and the fetch ticket
    whose copies are in flight)."""

    kind: str  # "delta" | "full"
    box: "PendingResults"
    data: dict


class PendingResults:
    """A deferred tick's results (``solve(deferred=True)``).  ``result()``
    settles the session's pending tick if it still is pending (the
    barrier), then decodes; by the time the double-buffered loop calls it,
    the barrier ran at the next solve's entry and only the host decode is
    left.  Safe to call any number of times; raises whatever the tick's
    settle or decode raised."""

    __slots__ = ("_session", "_results", "_error", "_decode", "_settled")

    def __init__(self, session, results=None, error=None) -> None:
        self._session = session
        self._results = results
        self._error = error
        self._decode = None  # set at settle
        self._settled = results is not None or error is not None

    def _settle_with(self, results=None, error=None, decode=None) -> None:
        self._results = results
        self._error = error
        self._decode = decode
        self._settled = True

    def done(self) -> bool:
        return self._settled

    def result(self):
        if not self._settled:
            self._session.settle()
        if self._error is not None:
            raise self._error
        if self._results is None and self._decode is not None:
            decode, self._decode = self._decode, None
            try:
                self._results = decode()
            except BaseException as e:  # noqa: BLE001 - cached, then raised
                self._error = e
                raise
        return self._results


class IncrementalSolveSession:
    """One warm-start solve lineage: full solves adopt state, delta solves
    repair it (module docstring).  ``stages`` holds the wall seconds of the
    last solve by stage: a delta tick's ``plan_s`` (diff, decision, eviction
    planes), ``dispatch_s`` (uploads, K10 or K21, K11), ``repair_s`` (the
    resumed scan, the fetch ticket and, on a serial tick, its barrier) and
    ``decode_s`` (decode and bookkeeping, K12 or K22 included); a full
    solve's ``full_s``; ``settle_s``, the previous deferred tick's settle
    run at this solve's entry."""

    def __init__(self, solver, policy: Optional[FallbackPolicy] = None,
                 window_min: Optional[int] = None, run_prepared=None) -> None:
        self.solver = solver
        self.policy = policy or FallbackPolicy()
        self.window_min = window_min
        self.store = SnapshotStore()
        self._warm: Optional[_WarmState] = None
        self.last_mode: Optional[str] = None
        self.last_reason: Optional[str] = None
        self.last_audit_drift_nodes: Optional[int] = None
        self.last_window: Optional[Tuple[np.ndarray, int]] = None
        self.last_evicted: Dict[str, int] = {}
        self.mode_counts: Dict[str, int] = {MODE_FULL: 0, MODE_DELTA: 0}
        self.stages: Dict[str, float] = {}
        self._forced_reason: Optional[str] = None
        # the dispatch hook (module docstring); None runs solver.run_prepared
        self._run_prepared = run_prepared
        # the pipelined loop's state: the in-flight deferred tick, the ring of
        # host staging buffers its fetches land in, and the last settled but
        # undecoded handle (decoded before its staging slot is rewritten)
        self._pending: Optional[_PendingTick] = None
        self._staging: Optional[pipeline_mod.HostStagingRing] = None
        self._undecoded: Optional[PendingResults] = None

    def rebind(self, solver) -> None:
        """Bind the solver the next solves run through."""
        self.solver = solver

    def _run(self):
        return self._run_prepared or self.solver.run_prepared

    def _donates(self) -> bool:
        """Whether repairs consume the carry in place: the pipeline is on,
        the dispatch is not hooked (the tenant plane's coalescer stacks
        member carries) and the policy is off (its decode reads the final
        planes on the card)."""
        policy = self.solver.policy
        return (pipeline_mod.donation_enabled() and self._run_prepared is None
                and not (policy is not None and getattr(policy, "enabled", False)))

    def reset(self) -> None:
        """Drop the warm lineage (the next solve is full).  A pending
        deferred tick settles first, so its handle stays consumable."""
        self.settle()
        self._warm = None

    def force_full(self, reason: str) -> None:
        """Make the NEXT solve a full re-anchor with this reason."""
        self._forced_reason = reason

    # -- the solve entry -------------------------------------------------------

    def solve(self, ingest, state_nodes: Optional[list] = None,
              bound_pods: Optional[list] = None, deferred: bool = False):
        """``solver.cuda.CudaSolveResults`` for the current population of
        ``ingest`` (a ``models.columnar.PodIngest``): a full solve's every
        decision, or a delta tick's own placements (new pods onto new or
        existing capacity).  Raises models.snapshot.KernelUnsupported as
        ``CudaSolver.solve`` does.

        ``deferred=True`` returns a ``PendingResults`` instead: a delta tick
        dispatches and settles at the NEXT solve's entry (or at
        ``result()``); a full solve's device work is in flight and settles
        the same way.  With KC_PIPELINE=0 the handle is settled inline: the
        serial loop."""
        self.stages = {}
        # settle the in-flight deferred tick first: this tick's membership
        # diff and eviction plan read the bookkeeping that tick rewrites
        self.settle()
        t0 = time.perf_counter()
        pipelined = deferred and pipeline_mod.pipeline_enabled()
        self.last_window = None
        self.last_evicted = {}
        members, by_uid = ingest.class_members(), ingest.get
        if self._warm is not None:
            self._absorb_bound({p.uid for p in (bound_pods or [])})
        # the policy side of the supply: offering prices, interruption
        # priors, the objective's knobs and the provider's pending-ICE set.
        # A change of any escalates the next tick to a full solve
        catalog = store_mod.catalog_digest(
            self.solver.provisioners, self.solver.instance_types
        ) + policy_planes.policy_input_digest(
            self.solver.instance_types, self.solver.policy, provider=self.solver.cloud_provider)
        # the comparison digest excludes bound pods this lineage placed itself
        # (their binding is its own work materializing); the anchor a full
        # solve stores is unfiltered
        known = self._warm.materialized if self._warm is not None else ()
        supply = store_mod.supply_digest(
            state_nodes,
            [p for p in (bound_pods or []) if p.uid not in known] if known else bound_pods,
        ) + catalog
        supply_anchor = supply if not known else (
            store_mod.supply_digest(state_nodes, bound_pods) + catalog
        )
        w = self._warm
        delta = None
        if w is not None:
            delta = diff_members(
                w.members, members, from_version=w.versioned.version,
                supply_changed=() if supply == w.supply else ("supply",),
            )
        mode, reason = self.policy.decide(
            delta,
            w.delta_ticks if w is not None else 0,
            w.n_next if w is not None else 0,
            known_classes=w.class_index if w is not None else None,
            mode_changed=w is not None and _resolve_solve_mode(self.solver) != w.solve_mode,
        )
        forced = self._forced_reason
        if forced is not None:
            mode, reason = MODE_FULL, forced
            self._forced_reason = None
        try:
            if mode == MODE_DELTA and pipelined:
                handle = self._delta_dispatch_deferred(
                    delta, by_uid, ingest, members, state_nodes, bound_pods, supply_anchor, t0)
                if handle is not None:
                    return handle  # mode accounting waits for the settle
                mode, reason = MODE_FULL, "slots-exhausted"
            elif mode == MODE_DELTA:
                results = self._delta_solve(delta, by_uid, t0)
                if results is None:  # the repair ran out of room: escalate
                    mode, reason = MODE_FULL, "slots-exhausted"
            if mode == MODE_FULL:
                t1 = time.perf_counter()
                results = self._full_solve(ingest, members, state_nodes, bound_pods,
                                           supply_anchor, reason, deferred=pipelined)
                self.stages["full_s"] = time.perf_counter() - t1
                if isinstance(results, PendingResults):
                    return results  # mode accounting waits for the settle
        except Exception:
            if forced is not None:
                self._forced_reason = forced  # the re-anchor is still owed
            raise
        self._count_mode(mode, reason)
        if deferred:
            return PendingResults(self, results=results)
        return results

    def _count_mode(self, mode: str, reason: str) -> None:
        self.last_mode, self.last_reason = mode, reason
        self.mode_counts[mode] = self.mode_counts.get(mode, 0) + 1

    def _absorb_bound(self, bound_uids) -> None:
        """Lineage-placed pods that have since BOUND leave the pending
        population as the lineage's own work materializing, not as
        evictions: their capacity stays committed in the carry, they leave
        the membership view, and the supply comparison excludes them."""
        w = self._warm
        moved = [uid for uid in w.pod_loc if uid in bound_uids]
        if not moved:
            return
        trimmed: Dict[tuple, List[str]] = {}
        for uid in moved:
            row, _kind, _idx = w.pod_loc.pop(uid)
            key = w.row_key.get(row)
            if key is not None:
                trimmed.setdefault(key, []).append(uid)
            w.materialized.add(uid)
        for key, uids in trimmed.items():
            gone = set(uids)
            left = tuple(u for u in w.members.get(key, ()) if u not in gone)
            if left:
                w.members[key] = left
            else:
                w.members.pop(key, None)

    # -- full path -------------------------------------------------------------

    def _full_solve(self, population, members, state_nodes, bound_pods, supply, reason,
                    deferred: bool = False):
        """A full solve of ``population`` (a PodIngest, or the class list a
        deferred tick captured).  Deferred, the device work stays in flight
        and ``_settle_full`` retires it."""
        solver = self.solver
        prev_nodes = self.node_count() if self._warm is not None else None
        try:
            if isinstance(population, list):
                snapshot = solver.encode_classes(population, state_nodes, bound_pods)
            else:
                snapshot = solver.encode(population, state_nodes, bound_pods)
            versioned = self.store.commit(snapshot, supply=supply)
            prep = solver.prepare_encoded(snapshot, state_nodes, bound_pods)
            run = self._run()
            outputs = run(prep)
            if deferred:
                if self._staging is None:
                    self._staging = pipeline_mod.HostStagingRing()
                ticket = solver.begin_fetch(outputs, ring=self._staging)
                box = PendingResults(self)
                self._pending = _PendingTick(kind="full", box=box, data=dict(
                    snapshot=snapshot, versioned=versioned, prep=prep, run=run,
                    outputs=outputs, ticket=ticket, members=dict(members), supply=supply,
                    state_nodes=list(state_nodes or ()), prev_nodes=prev_nodes, reason=reason,
                    solver=solver,
                ))
                return box
            fetched = solver.begin_fetch(outputs)
            slots = outputs.assign.shape[1]
            if solver.fetch_exhausted(fetched.wait(), slots):
                # slot exhaustion: retry once with double capacity
                outputs = run(prep, n_slots=slots * 2)
                fetched = solver.begin_fetch(outputs)
            results = solver.decode(snapshot, outputs, state_nodes or [], fetched=fetched)
        except Exception:
            self._warm = None  # a half-built lineage must not seed repairs
            raise
        self._adopt(versioned, prep, outputs, fetched, members, supply, state_nodes,
                    prev_nodes, reason)
        return results

    def _settle_full(self, pending: _PendingTick) -> None:
        """Retire a deferred full solve: barrier, the slot-exhaustion retry
        (synchronous, rare), adoption; the decode waits for the handle."""
        f = pending.data
        solver = f["solver"]
        slots = f["outputs"].assign.shape[1]
        if solver.fetch_exhausted(f["ticket"].wait(), slots):
            outputs = f["run"](f["prep"], n_slots=slots * 2)
            ticket = solver.begin_fetch(outputs, ring=self._staging)
            # adopt the retry's ticket before its barrier, so a failed wait
            # leaves it reachable for the settle's invalidate
            f["outputs"], f["ticket"] = outputs, ticket
            ticket.wait()
        self._adopt(f["versioned"], f["prep"], f["outputs"], f["ticket"], f["members"],
                    f["supply"], f["state_nodes"], f["prev_nodes"], f["reason"])
        pending.box._settle_with(decode=lambda: solver.decode(
            f["snapshot"], f["outputs"], f["state_nodes"], fetched=f["ticket"]))
        self._undecoded = pending.box

    def _adopt(self, versioned, prep, outputs, fetched, members, supply, state_nodes,
               prev_nodes, reason):
        solver = self.solver
        carry = solve_ops.warm_carry_of(outputs)
        if carry is not None and self._donates():
            # a solve may pass planes of its inputs (the prep's) through
            # untouched; a carry that repairs write in place owns its planes
            carry = _cloned(carry)
        small = fetched.wait()
        assign = np.asarray(small[solver.FETCH_ASSIGN], dtype=np.int32).copy()
        assign_ex = np.asarray(small[solver.FETCH_ASSIGN_EX], dtype=np.int32).copy()
        n_next = int(small[solver.FETCH_N_NEXT])
        snapshot = versioned.snapshot
        pod_loc, unplaced = _locate_pods(snapshot, assign, assign_ex)
        all_pods = {p.uid: p for cls in snapshot.classes for p in cls.pods}
        failed_pods = {uid: (row, all_pods[uid]) for uid, row in unplaced}
        member_rows, own_inv_rows = _topology_rows(prep)
        dev = solver.device
        self.last_audit_drift_nodes = None
        if prev_nodes is not None and reason.startswith("audit"):
            fresh = int(np.sum(np.sum(assign, axis=0) > 0))
            self.last_audit_drift_nodes = prev_nodes - fresh
        self._warm = _WarmState(
            versioned=versioned,
            prep=prep,
            carry=carry,
            assign=assign,
            assign_ex=assign_ex,
            n_next=n_next,
            members=dict(members),
            class_index=versioned.index_of(),
            pod_loc=pod_loc,
            row_key={i: row.key for i, row in enumerate(versioned.rows)},
            failed_pods=failed_pods,
            member_rows=torch.as_tensor(member_rows, device=dev),
            own_inv_rows=torch.as_tensor(own_inv_rows, device=dev),
            supply=supply,
            state_nodes=list(state_nodes or []),
            solve_mode=_resolve_solve_mode(solver),
        )

    # -- delta path ------------------------------------------------------------
    #
    # One delta tick is four stages: plan (host), dispatch (K10 or K21, K11,
    # the resumed scan, the fetch ticket), settle (the barrier, the
    # exhaustion check, bookkeeping with K12 or K22) and decode.  The serial
    # tick (_delta_solve) runs them back to back; the deferred tick
    # (_delta_dispatch_deferred) stops after the dispatch and settles at the
    # next solve's entry.

    def _delta_plan(self, delta, by_uid):
        """The host-side tick plan: eviction free planes, the delta count
        vector, and the post-tick membership.  None when an unseen class key
        means the padded tensors cannot express the delta."""
        w = self._warm
        c_pad = w.prep.cls.count.shape[0]
        n_slots = w.assign.shape[1]
        e_pad = w.assign_ex.shape[1]

        # evictions: return departed pods' capacity and counts to the carry
        free_new = np.zeros((c_pad, n_slots), dtype=np.int32)
        free_ex = np.zeros((c_pad, e_pad), dtype=np.int32)
        evicted_locs: List[Tuple[str, Tuple[int, str, int]]] = []
        for key, uids in delta.evicted.items():
            for uid in uids:
                loc = w.pod_loc.get(uid)
                if loc is None:
                    continue  # was failed/unplaced: nothing to free
                row, kind, idx = loc
                (free_new if kind == "new" else free_ex)[row, idx] += 1
                evicted_locs.append((uid, loc))

        # additions (+ retry of previously-failed pods): a count vector with
        # only the delta, scanned over the SAME padded tensors
        evicted_set = {u for us in delta.evicted.values() for u in us}
        pods_by_root: Dict[int, List[object]] = {}
        for key, uids in delta.added.items():
            row = w.class_index.get(key)
            if row is None:
                return None  # unseen class key: tensors can't express it
            pods_by_root.setdefault(row, []).extend(by_uid(uid) for uid in uids)
        # still-pending failures retry every repair tick under their own row
        for uid, (row, pod) in w.failed_pods.items():
            if uid not in evicted_set:
                pods_by_root.setdefault(row, []).append(pod)
        counts = np.zeros(c_pad, dtype=np.int32)
        for row, pods in pods_by_root.items():
            counts[row] = len(pods)

        # membership after this tick lands: previous minus evicted plus added
        members = {k: list(v) for k, v in w.members.items()}
        for key, uids in delta.evicted.items():
            gone = set(uids)
            if key in members:
                members[key] = [u for u in members[key] if u not in gone]
        for key, uids in delta.added.items():
            members.setdefault(key, []).extend(uids)
        members_after = {k: tuple(v) for k, v in members.items() if v}
        locs = [loc for _, loc in evicted_locs]
        self.last_evicted = {
            "evicted": delta.evicted_count,
            "new": sum(1 for loc in locs if loc[1] == "new"),
            "existing": sum(1 for loc in locs if loc[1] == "ex"),
            "hole_slots": len({loc[2] for loc in locs if loc[1] == "new"}),
        }
        return {
            "delta": delta, "free_new": free_new, "free_ex": free_ex,
            "evicted_locs": evicted_locs, "pods_by_root": pods_by_root,
            "counts": counts, "members_after": members_after,
        }

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=self.solver.device)

    def _delta_dispatch(self, plan):
        """The repair on the card, up to its fetch ticket: K10 (K21 when
        donating) frees the evictions, K11 gathers the bounded window (freed
        holes plus a fresh tail, whose hole planes are also the fills'
        preference), the scan resumes from the carry, and the ticket starts
        the copies home.

        Unhooked dispatches donate the carry while the pipeline is on and
        the policy off: K21 frees it in place, and the settle's K22 writes
        the window back into it, so the carry as it was is dead after this
        call.  Hooked dispatches (the tenant plane's coalescer stacks member
        carries) and an enabled policy (its decode reads the final planes on
        the card) never donate.  Any exception here drops the lineage."""
        w = self._warm
        solver = self.solver
        use_kernels = solver.use_kernels
        free_new, free_ex = plan["free_new"], plan["free_ex"]
        evicted_locs, counts = plan["evicted_locs"], plan["counts"]
        n_slots = w.assign.shape[1]
        donate = self._donates()
        t0 = time.perf_counter()
        g1 = w.member_rows.shape[1]
        n_zones = w.prep.statics_arrays.tmpl_zone.shape[1]
        hole_slots = sorted({loc[2] for _, loc in evicted_locs if loc[1] == "new"})
        window = _window_indices(hole_slots, w.n_next, n_slots, self.window_min)
        self.last_window = window
        try:
            carry = w.carry
            free_ex_t = self._upload(free_ex)
            if evicted_locs:
                carry = solve_ops.repair_free(
                    carry, self._upload(free_new), free_ex_t, w.prep.cls.requests,
                    w.member_rows, w.own_inv_rows, use_kernels=use_kernels, inplace=donate,
                )
            idx_t = None
            if window is not None:
                idx, n_open_w = window
                idx_t = self._upload(idx)
                run_carry, base = solve_ops.gather_repair_window(carry, idx_t, n_open_w,
                                                                 use_kernels=use_kernels)
                repair_plan = solve_ops.RepairPlan(
                    pref_new=self._upload(free_new[:, idx]), pref_ex=free_ex_t,
                    base_fwd_sing=base[0], base_fwd_full=base[1], base_inv_full=base[2],
                )
                keep_carry = carry
            else:
                zeros_gz = torch.zeros((g1, n_zones), dtype=torch.int32, device=solver.device)
                repair_plan = solve_ops.RepairPlan(
                    pref_new=self._upload(free_new), pref_ex=free_ex_t,
                    base_fwd_sing=zeros_gz, base_fwd_full=zeros_gz, base_inv_full=zeros_gz,
                )
                run_carry, keep_carry = carry, None
            t1 = time.perf_counter()
            # a windowed repair names its window width, which is the repair's
            # bucket identity when a host coalesces repairs (service/tenant.py)
            width = {} if window is None else {"n_slots": len(window[0])}
            outputs = self._run()(w.prep, count=counts, warm_carry=run_carry,
                                  repair_plan=repair_plan, donate_carry=donate, **width)
            if self._staging is None and pipeline_mod.pipeline_enabled():
                self._staging = pipeline_mod.HostStagingRing()
            ticket = solver.begin_fetch(outputs, ring=self._staging)
        except BaseException:
            self._warm = None  # the next solve re-anchors from scratch
            raise
        self.stages["dispatch_s"] = t1 - t0
        self.stages["repair_s"] = time.perf_counter() - t1
        # decode consumes a delta VIEW of the snapshot: same planes, classes
        # carry only this tick's pods (built while the card works)
        delta_view = _delta_view(w.versioned.snapshot, plan["pods_by_root"])
        return {
            "plan": plan, "outputs": outputs, "ticket": ticket, "window": window,
            "idx": idx_t, "keep_carry": keep_carry, "donated": donate,
            "delta_view": delta_view, "state_nodes": w.state_nodes, "solver": solver,
        }

    @staticmethod
    def _delta_exhausted(disp, fetched) -> bool:
        """Out of slots or window: the repair could not place everything it
        was given room for; the tick escalates to a full solve."""
        w_slots = (
            len(disp["window"][0]) if disp["window"] is not None
            else disp["outputs"].assign.shape[1]
        )
        return disp["solver"].fetch_exhausted(fetched, w_slots)

    @staticmethod
    def _delta_results(disp):
        """Decode over the delta view from the ticket's host arrays, dropping
        node decisions the repair placed nothing on (previously-decided
        nodes are not re-launched)."""
        results = disp["solver"].decode(disp["delta_view"], disp["outputs"],
                                        disp["state_nodes"], fetched=disp["ticket"])
        results.new_nodes = [d for d in results.new_nodes if d.pods]
        return results

    def _delta_adopt(self, disp, fetched) -> None:
        """Fold the repair's placements into the lineage (after the
        barrier)."""
        w = self._warm
        solver = disp["solver"]
        plan = disp["plan"]
        window = disp["window"]
        outputs = disp["outputs"]
        c_pad = w.prep.cls.count.shape[0]
        n_slots = w.assign.shape[1]
        assign_d = np.asarray(fetched[solver.FETCH_ASSIGN], dtype=np.int32)
        assign_ex_d = np.asarray(fetched[solver.FETCH_ASSIGN_EX], dtype=np.int32)
        n_next_h = int(fetched[solver.FETCH_N_NEXT])
        loc_d, unplaced = _locate_pods(disp["delta_view"], assign_d, assign_ex_d)
        if window is not None:
            # scatter the windowed repair back to the full-width lineage:
            # assignment columns, pod locations and the carry (K12; K22 into
            # the full-width carry's own planes when the tick donated)
            idx, n_open_w = window
            new_carry = solve_ops.scatter_repair_window(
                disp["keep_carry"], solve_ops.warm_carry_of(outputs), disp["idx"], n_open_w,
                use_kernels=solver.use_kernels, inplace=disp["donated"],
            )
            assign_g = np.zeros((c_pad, n_slots), dtype=np.int32)
            assign_g[:, idx] = assign_d
            assign_d = assign_g
            loc_d = {
                uid: (row, kind, int(idx[i]) if kind == "new" else i)
                for uid, (row, kind, i) in loc_d.items()
            }
            n_next_h = w.n_next + (n_next_h - n_open_w)
        else:
            new_carry = solve_ops.warm_carry_of(outputs)
        for uid, loc in plan["evicted_locs"]:
            row, kind, slot = loc
            (w.assign if kind == "new" else w.assign_ex)[row, slot] -= 1
            del w.pod_loc[uid]
        w.assign += assign_d
        w.assign_ex += assign_ex_d
        w.pod_loc.update(loc_d)
        # every non-evicted failure was retried this tick, so the repair's
        # unplaced tail IS the new failure set
        delta_pods = {p.uid: p for pods in plan["pods_by_root"].values() for p in pods}
        w.failed_pods = {uid: (row, delta_pods[uid]) for uid, row in unplaced}
        w.carry = new_carry
        w.n_next = n_next_h
        w.members = plan["members_after"]
        w.delta_ticks += 1

    def _delta_solve(self, delta, by_uid, t_start: float):
        """The serial delta tick: plan → dispatch → barrier → exhaustion
        check → decode → adopt.  None escalates to a full solve."""
        plan = self._delta_plan(delta, by_uid)
        if plan is None:
            return None
        self.stages["plan_s"] = time.perf_counter() - t_start
        disp = self._delta_dispatch(plan)
        t0 = time.perf_counter()
        try:
            fetched = disp["ticket"].wait()
        except BaseException:
            # any failed barrier (SolveTimeout or a fault) cancels the tick:
            # nothing is half-applied, the next solve re-anchors
            self._cancel_tick(disp)
            raise
        self.stages["repair_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            if self._delta_exhausted(disp, fetched):
                return None
            results = self._delta_results(disp)
            self._delta_adopt(disp, fetched)
        except BaseException:
            if disp["donated"]:
                # the carry was consumed in place: a kept lineage would
                # repair from a half-written carry
                self._warm = None
            raise
        self.stages["decode_s"] = time.perf_counter() - t0
        return results

    def _cancel_tick(self, disp) -> None:
        """Invalidate a failed tick's in-flight state: the ticket retires
        from the open ledger, a donated dispatch's ledger entry is balanced,
        and the warm lineage drops (its carry is consumed or aliased by the
        abandoned copy)."""
        disp["ticket"].invalidate()
        if disp["donated"]:
            pipeline_mod.record_donation_canceled()
        self._warm = None

    def _delta_dispatch_deferred(self, delta, by_uid, ingest, members, state_nodes,
                                 bound_pods, supply_anchor, t_start: float):
        """The pipelined tick: plan and dispatch now, settle at the next
        solve's entry.  None when the plan cannot be expressed (the caller
        escalates inline).  The population's classes are captured after the
        dispatch (the snapshot build overlaps the card's work), so a
        settle-time exhaustion or timeout re-anchors from THIS tick's
        population though the caller's ingest has moved on."""
        plan = self._delta_plan(delta, by_uid)
        if plan is None:
            return None
        self.stages["plan_s"] = time.perf_counter() - t_start
        disp = self._delta_dispatch(plan)
        try:
            captured = ingest.classes()
        except BaseException:
            if disp["donated"]:
                self._warm = None
            raise
        box = PendingResults(self)
        self._pending = _PendingTick(kind="delta", box=box, data=dict(
            disp=disp, captured_classes=captured, members_at=dict(members),
            state_nodes=list(state_nodes or ()), bound_pods=list(bound_pods or ()),
            supply_anchor=supply_anchor,
        ))
        return box

    def _reanchor(self, data, reason: str):
        """A deferred delta tick's full re-anchor from its captured
        population (serial)."""
        return self._full_solve(data["captured_classes"], data["members_at"],
                                data["state_nodes"], data["bound_pods"], data["supply_anchor"],
                                reason)

    def settle(self) -> None:
        """Retire the in-flight deferred tick: the barrier, the window
        exhaustion check (a delta escalates to a full re-anchor of the
        captured population; a full solve retries with doubled slots), the
        bookkeeping, and the mode accounting.  A barrier that times out
        (``SolveTimeout``) cancels the tick and re-anchors with reason
        ``watchdog-timeout``.  The decode waits for the handle's
        ``result()``; a handle still undecoded at the NEXT settle decodes
        here first (its staging slot is about to be rewritten).  Never
        raises: a failure lands in the handle, with its ticket invalidated,
        and drops the lineage."""
        # flush the last settled-but-undecoded handle first, even with nothing
        # pending: its staged arrays live in the shared ring, which any later
        # tick (a serial one too) rewrites.  Failures are cached in the box
        if self._undecoded is not None:
            try:
                self._undecoded.result()
            except Exception:  # noqa: BLE001 - recorded in the box
                pass
            self._undecoded = None
        pending = self._pending
        if pending is None:
            return
        self._pending = None
        t0 = time.perf_counter()
        if pending.kind == "full":
            mode, reason = MODE_FULL, pending.data["reason"]
        else:
            mode, reason = MODE_DELTA, "delta"
        try:
            if pending.kind == "full":
                self._settle_full(pending)
            else:
                disp = pending.data["disp"]
                try:
                    fetched = disp["ticket"].wait()
                except SolveTimeout:
                    # the barrier was abandoned: cancel the tick and rebuild
                    # the lineage from the dispatch-time population.  The
                    # re-anchor's own barrier is bounded too; its timeout
                    # lands in the handle
                    self._cancel_tick(disp)
                    mode, reason = MODE_FULL, "watchdog-timeout"
                    pending.box._settle_with(results=self._reanchor(pending.data, reason))
                except BaseException:
                    # another barrier fault: the same cancellation, no
                    # re-anchor; the error goes to the handle
                    self._cancel_tick(disp)
                    raise
                else:
                    if self._delta_exhausted(disp, fetched):
                        mode, reason = MODE_FULL, "slots-exhausted"
                        pending.box._settle_with(
                            results=self._reanchor(pending.data, reason))
                    else:
                        self._delta_adopt(disp, fetched)
                        pending.box._settle_with(decode=lambda: self._delta_results(disp))
                        self._undecoded = pending.box
        except BaseException as e:  # noqa: BLE001 - routed to the handle
            if pending.kind == "full" or pending.data["disp"]["donated"]:
                self._warm = None  # a failed anchor, or a consumed carry
            ticket = (pending.data.get("ticket") if pending.kind == "full"
                      else pending.data["disp"]["ticket"])
            if ticket is not None and not ticket.done():
                ticket.invalidate()
            pending.box._settle_with(error=e)
            self._count_mode(mode, f"{reason}:failed")
            return
        finally:
            self.stages["settle_s"] = time.perf_counter() - t0
        self._count_mode(mode, reason)

    # -- aggregate views -------------------------------------------------------
    # Each settles the in-flight deferred tick first: the view reflects every
    # dispatched solve.

    def node_count(self) -> int:
        self.settle()
        w = self._warm
        if w is None:
            return 0
        return int(np.sum(np.sum(w.assign, axis=0) > 0))

    def aggregates(self) -> Dict[str, int]:
        """The session lineage's current placement totals."""
        self.settle()
        w = self._warm
        if w is None:
            return {"scheduled": 0, "failed": 0, "nodes": 0}
        return {
            "scheduled": int(w.assign.sum() + w.assign_ex.sum()),
            "failed": len(w.failed_pods),
            "nodes": self.node_count(),
        }

    def node_signature(self):
        """Canonical multiset of per-node class loads, labeled by stable
        class identity (order- and row-index-independent)."""
        self.settle()
        w = self._warm
        if w is None:
            return ()
        keys = [w.row_key.get(i, i) for i in range(w.assign.shape[0])]
        return node_signature_of(w.assign, keys) + node_signature_of(w.assign_ex, keys)


_WINDOW_MIN = 256
_WINDOW_FRESH = 64


def _window_indices(hole_slots, n_next: int, n_slots: int, window_min: Optional[int] = None):
    """The bounded repair window's global slot indices: every freed-hole slot
    (ascending), open filler below ``n_next`` if the power-of-two bucket
    needs it, then the fresh tail.  Returns (idx i32[S], open_count), or
    None when windowing is off (``window_min`` 0), the bucket would not
    shrink the solve, or the geometry doesn't fit: the repair then runs at
    full width, which is always correct.  ``window_min`` None means
    ``min(256, n_slots // 4)``."""
    if window_min == 0:
        return None
    min_s = max(int(window_min), 1) if window_min is not None else min(_WINDOW_MIN, n_slots // 4)
    # fresh headroom scales down with tiny fleets so small solves window too
    fresh_headroom = min(_WINDOW_FRESH, max(8, n_slots // 16))
    want = max(min_s, len(hole_slots) + fresh_headroom)
    s = 1
    while s < want:
        s <<= 1
    if s >= n_slots:
        return None
    fresh = list(range(n_next, min(n_next + (s - len(hole_slots)), n_slots)))
    filler_needed = s - len(hole_slots) - len(fresh)
    open_w = list(hole_slots)
    if filler_needed > 0:
        holes = set(hole_slots)
        filler = []
        slot = n_next - 1
        while slot >= 0 and len(filler) < filler_needed:
            if slot not in holes:
                filler.append(slot)
            slot -= 1
        if len(filler) < filler_needed:
            return None
        open_w = sorted(open_w + filler)
    idx = np.asarray(open_w + fresh, dtype=np.int32)
    return idx, len(open_w)


def node_signature_of(assign: np.ndarray, keys=None):
    """Sorted tuple of per-node (class, count) loads, empty slots dropped.
    ``keys`` maps class row -> a stable class identity (the raw row index
    without it)."""
    sig = []
    arr = np.asarray(assign)
    # class keys may hold unorderable members: canonicalize by repr
    for col in range(arr.shape[1]):
        loads = tuple(sorted(
            (
                ((keys[int(c)] if keys is not None else int(c)), int(arr[c, col]))
                for c in np.nonzero(arr[:, col])[0]
            ),
            key=repr,
        ))
        if loads:
            sig.append(loads)
    return tuple(sorted(sig, key=repr))


def _locate_pods(snapshot, assign, assign_ex):
    """uid -> (class row, "new"|"ex", index) plus the unplaced tail as
    (uid, root row) pairs, in the cursor order ``CudaSolver.decode``
    consumes pods (ladder rows share their root's cursor)."""
    n_classes = len(snapshot.classes)
    if snapshot.cls_root is not None:
        root_of = [int(r) for r in snapshot.cls_root]
    else:
        root_of = list(range(n_classes))
    cursors = [0] * n_classes
    loc: Dict[str, Tuple[int, str, int]] = {}
    unplaced: List[Tuple[str, int]] = []
    for c in range(n_classes):
        r = root_of[c]
        pods = snapshot.classes[r].pods
        cursor = cursors[r]
        ex_idx = np.nonzero(assign_ex[c] > 0)[0]
        for e, take in zip(ex_idx.tolist(), assign_ex[c][ex_idx].tolist()):
            for pod in pods[cursor:cursor + take]:
                loc[pod.uid] = (c, "ex", int(e))
            cursor += take
        node_idx = np.nonzero(assign[c] > 0)[0]
        for n, take in zip(node_idx.tolist(), assign[c][node_idx].tolist()):
            for pod in pods[cursor:cursor + take]:
                loc[pod.uid] = (c, "new", int(n))
            cursor += take
        cursors[r] = cursor
    for c in range(n_classes):
        if root_of[c] != c:
            continue
        unplaced.extend((p.uid, c) for p in snapshot.classes[c].pods[cursors[c]:])
    return loc, unplaced


def _topology_rows(prep) -> Tuple[np.ndarray, np.ndarray]:
    """(member, own_inv) i32[C_pad, G1] rows for ``ops.solve.repair_free``:
    which group counts each class's placements incremented — membership
    from the padded grp_member plane, inverse ownership from the owned anti
    slots (preferred terms register no inverse counts)."""
    member = prep.statics_arrays.grp_member.cpu().numpy().astype(np.int32)
    c_pad, g1 = member.shape
    own_inv = np.zeros((c_pad, g1), dtype=np.int32)
    groups = prep.cls.groups.cpu().numpy()
    anti_soft = prep.cls.anti_soft.cpu().numpy()
    g_dummy = g1 - 1
    for c in range(c_pad):
        g_zan, g_han = int(groups[c, 4]), int(groups[c, 5])
        if g_zan < g_dummy and not bool(anti_soft[c, 0]):
            own_inv[c, g_zan] += 1
        if g_han < g_dummy and not bool(anti_soft[c, 1]):
            own_inv[c, g_han] += 1
    return member, own_inv


def _cloned(tree):
    """A copy of a tuple tree of tensors, every tensor with storage of its
    own."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if tree is None:
        return None
    return type(tree)(*(_cloned(x) for x in tree))


def _delta_view(snapshot, pods_by_root: Dict[int, List[object]]):
    """A shallow snapshot view whose root classes carry only this tick's pods
    (additions and retried failures); every plane is shared."""
    view = copy.copy(snapshot)
    classes = []
    for c, cls in enumerate(snapshot.classes):
        if cls.is_ladder_variant:
            classes.append(cls)
            continue
        classes.append(dc_replace(cls, pods=list(pods_by_root.get(c, ()))))
    view.classes = classes
    return view
