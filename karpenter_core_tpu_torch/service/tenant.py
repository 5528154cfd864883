"""The multi-tenant solver plane: admission, coalescing, sessions, isolation.

The port of ``karpenter_core_tpu/service/tenant.py``: tens of thousands of
clusters sharing one solver fleet, with one tenant's poison snapshot, slow
client or burst kept from taking down the others.

  admission     a per-tenant token bucket (``utils/retry.RetryBudget``) and
                a bounded global in-flight cap; past either the request is
                SHED with a retry-after hint (the bucket's exact refill
                time, escalated by a per-tenant ``Backoff`` while the tenant
                keeps hammering).
  coalescing    tenants whose prepared planes share a shape bucket
                (``bucket_key``) stack on a leading tenant axis and run ONE
                batched solve (``ops.solve.solve_core_batched``): every
                kernel launch covers all of them.  A batch-program fault
                re-runs every member solo, so each co-batched tenant's
                outputs equal its solo solve; the coalescer counts it
                (``batch_faults``) and logs it.
  sessions      a per-tenant ``IncrementalSolveSession`` under LRU + TTL
                eviction, its dispatches routed through the coalescer
                (``TenantPlane._dispatch``): full solves and warm repairs
                alike.
  isolation     a per-tenant ``CircuitBreaker``.

All timing policy goes through the injected ``utils/clock.Clock``.

The in-process ``TenantPlane`` is the entry point: ``checkout`` → ``admit``
→ ``entry.session.solve`` (whose ``run_prepared`` hook is ``_dispatch``) →
``BatchCoalescer.run`` → ``_run_batched``.  A coalesced batch runs the scan
whatever ``KC_SOLVER_MODE`` says, as the reference's does: only a solo or
singleton dispatch routes by solver family (``CudaSolver.run_prepared``).

Left out, each with its ROADMAP item: the ``REGISTRY`` histograms and
counters and ``SloTracker`` / ``observe_latencies`` (1.5, the metrics);
``fleet_scaled`` (the fleet); ``TenantConfig.max_request_bytes`` and
``rate_pinned``, which only the wire's handler and ``fleet_scaled`` read;
``restore_entry``, the replay bypass (``bypass_coalescer``)
and the journal and checkpoint fields of ``TenantEntry`` (the service's
wire and durability, with ``TenantEntry.supply_digest``, which only the
wire's handler reads); ``tenant_mesh_axes`` (1.8, always None here); the
tracing span.  The gRPC channel (``service/snapshot_channel.py``) is not
ported.
"""

from __future__ import annotations

import logging
import os
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from karpenter_core_tpu_torch.kernels import batch
from karpenter_core_tpu_torch.ops import solve as solve_ops
from karpenter_core_tpu_torch.utils import compilecache, retry
from karpenter_core_tpu_torch.utils.clock import Clock

log = logging.getLogger(__name__)

# the shed/isolated detail string clients parse the hint out of
RETRY_AFTER_PREFIX = "retry-after-s="


def parse_retry_after(details: str) -> Optional[float]:
    """The retry-after hint out of a shed/isolated response's detail string,
    or None when absent/unparseable."""
    for token in (details or "").replace(";", " ").split():
        if token.startswith(RETRY_AFTER_PREFIX):
            try:
                return float(token[len(RETRY_AFTER_PREFIX):])
            except ValueError:
                return None
    return None


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_i(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


# weighted fair-share bounds: a weight outside this band is clamped
WEIGHT_MIN = 0.01
WEIGHT_MAX = 100.0


def parse_weights(spec: str) -> Dict[str, float]:
    """KC_TENANT_WEIGHTS: ``tenant-a=2.0,tenant-b=0.5`` — unparseable parts
    are skipped (a typo must not take admission down)."""
    out: Dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        key, _, value = part.partition("=")
        try:
            out[key.strip()] = min(max(float(value), WEIGHT_MIN), WEIGHT_MAX)
        except ValueError:
            continue
    return out


@dataclass
class TenantConfig:
    """Knobs for the tenant plane; all env-overridable."""

    # admission: per-tenant token bucket (sustained rate + burst) and the
    # bounded global solve queue
    rate_per_s: float = 10.0
    burst: int = 20
    max_inflight: int = 16
    # weighted fair share: per-tenant multipliers on rate AND burst
    # (KC_TENANT_WEIGHTS; env wins over the tenant's own claim)
    weights: Dict[str, float] = field(default_factory=dict)
    # sessions: LRU capacity + idle TTL
    max_sessions: int = 256
    session_ttl_s: float = 900.0
    # isolation: per-tenant breaker
    breaker_threshold: int = 3
    breaker_reset_s: float = 30.0
    # coalescing: rendezvous window + cap (window 0 disables batching)
    batch_window_s: float = 0.01
    max_batch: int = 8
    # repair dispatches join the coalescer's rendezvous too;
    # KC_COALESCE_WINDOW=0 keeps repairs solo (anchors keep coalescing)
    coalesce_repairs: bool = True

    @classmethod
    def from_env(cls) -> "TenantConfig":
        return cls(
            rate_per_s=max(_env_f("KC_TENANT_RATE", 10.0), 0.001),
            burst=max(_env_i("KC_TENANT_BURST", 20), 1),
            max_inflight=max(_env_i("KC_TENANT_QUEUE", 16), 1),
            max_sessions=max(_env_i("KC_TENANT_SESSIONS", 256), 1),
            session_ttl_s=_env_f("KC_TENANT_SESSION_TTL_S", 900.0),
            breaker_threshold=max(_env_i("KC_TENANT_BREAKER_THRESHOLD", 3), 1),
            breaker_reset_s=_env_f("KC_TENANT_BREAKER_RESET_S", 30.0),
            batch_window_s=_env_f("KC_TENANT_BATCH_WINDOW_S", 0.01),
            max_batch=max(_env_i("KC_TENANT_BATCH_MAX", 8), 1),
            coalesce_repairs=os.environ.get("KC_COALESCE_WINDOW", "1") != "0",
            weights=parse_weights(os.environ.get("KC_TENANT_WEIGHTS", "")),
        )

    def resolve_weight(self, tenant_id: str, wire_weight=None) -> float:
        """The tenant's fair-share weight: operator env pin wins, then the
        tenant's claim, then 1.0 — always clamped."""
        weight = self.weights.get(tenant_id)
        if weight is None:
            try:
                weight = float(wire_weight) if wire_weight is not None else 1.0
            except (TypeError, ValueError):
                weight = 1.0
        return min(max(weight, WEIGHT_MIN), WEIGHT_MAX)

    def bucket_shape(self, weight: float) -> Tuple[int, float]:
        """(budget, window_s) for a weighted tenant bucket: burst scales with
        the weight, and the window is derived from the SCALED budget so the
        refill rate is exactly ``rate_per_s * weight`` even after the burst
        rounds to an int — shed hints stay exact."""
        budget = max(int(round(self.burst * weight)), 1)
        return budget, budget / (self.rate_per_s * weight)


@dataclass
class AdmissionDecision:
    admitted: bool
    reason: str = ""  # rate / queue / isolated / draining when not admitted
    retry_after_s: float = 0.0
    # the tenant's entry, and whether THIS admission latched the breaker's
    # half-open trial
    entry: Optional["TenantEntry"] = None
    trial: bool = False

    def detail(self) -> str:
        """The shed detail string (machine-parseable hint included)."""
        return (
            f"tenant-shed reason={self.reason} "
            f"{RETRY_AFTER_PREFIX}{self.retry_after_s:.3f}"
        )


# -- batch coalescing ---------------------------------------------------------


def _leaf_sig(tree) -> tuple:
    """(dtype, shape) of every tensor leaf, in field order."""
    out = []
    batch.tree_map(lambda leaf: out.append((str(leaf.dtype), tuple(leaf.shape))), tree)
    return tuple(out)


def bucket_key(prep, kw=None) -> tuple:
    """The shape-bucket identity of a ``solver.cuda.SolvePrep``: two preps
    with equal keys run the same batched program, so they can stack on a
    tenant axis.  ``kw`` (a repair dispatch's kwargs) extends the key with
    the repair-window identity: the window width (``n_slots``) and the warm
    carry's and repair plan's leaf signatures.  The per-tick ``count`` is
    values only, so it never splits a bucket."""
    key = (
        _leaf_sig(prep.cls),
        _leaf_sig(prep.statics_arrays),
        _leaf_sig(prep.ex_state) if prep.ex_state is not None else None,
        _leaf_sig(prep.ex_static) if prep.ex_static is not None else None,
        int(prep.n_slots),
        tuple(prep.key_has_bounds),
        int(prep.n_passes),
        tuple(prep.features) if prep.features is not None else None,
    )
    if kw and kw.get("warm_carry") is not None:
        key += (
            "repair",
            int(kw.get("n_slots") or 0) or int(prep.n_slots),
            _leaf_sig(kw["warm_carry"]),
            _leaf_sig(kw["repair_plan"]) if kw.get("repair_plan") is not None else None,
        )
    return key


class _Member:
    __slots__ = ("prep", "solo", "tenant", "kw", "done", "outputs", "error", "batch_n")

    def __init__(self, prep, solo: Callable[[], object],
                 tenant: Optional[str] = None, kw=None) -> None:
        self.prep = prep
        self.solo = solo
        self.tenant = tenant
        self.kw = kw
        self.done = threading.Event()
        self.outputs = None
        self.error: Optional[BaseException] = None
        self.batch_n = 1


class _Group:
    __slots__ = ("members", "full", "closed")

    def __init__(self) -> None:
        self.members: List[_Member] = []
        self.full = threading.Event()
        self.closed = False


class BatchCoalescer:
    """Rendezvous concurrent compatible-bucket solves into one batched
    dispatch.  ``run(prep, solo)`` blocks until this request's outputs exist
    and returns ``(outputs, batch_size)``; ``solo`` is the caller's
    unbatched dispatch (used for singleton groups and as the per-tenant
    fallback when a batch program faults).  ``batch_faults`` counts the
    batched dispatches that faulted and fell back to solo."""

    def __init__(self, window_s: float = 0.01, max_batch: int = 8) -> None:
        self.window_s = window_s
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self._groups: Dict[tuple, _Group] = {}
        self.batch_faults = 0

    def run(self, prep, solo: Callable[[], object],
            tenant: Optional[str] = None, kw=None) -> Tuple[object, int]:
        if self.window_s <= 0 or self.max_batch <= 1:
            return solo(), 1
        key = bucket_key(prep, kw)
        member = _Member(prep, solo, tenant, kw)
        with self._lock:
            group = self._groups.get(key)
            # a full group is as good as closed: late arrivals start the
            # next group instead of growing this one past max_batch
            leader = (
                group is None or group.closed
                or len(group.members) >= self.max_batch
            )
            if leader:
                group = _Group()
                group.members.append(member)
                self._groups[key] = group
            else:
                group.members.append(member)
                if len(group.members) >= self.max_batch:
                    group.full.set()
        if not leader:
            # the leader always resolves every member in its finally block
            member.done.wait()
            if member.error is not None:
                raise member.error
            return member.outputs, member.batch_n
        # leader: hold the window open for co-batchers, then dispatch
        group.full.wait(self.window_s)
        with self._lock:
            group.closed = True
            if self._groups.get(key) is group:
                del self._groups[key]
            members = list(group.members)
        try:
            self._execute(members)
        finally:
            for m in members:
                m.done.set()
        if member.error is not None:
            raise member.error
        return member.outputs, member.batch_n

    def _execute(self, members: List[_Member]) -> None:
        if len(members) == 1:
            m = members[0]
            try:
                m.outputs = m.solo()
            except BaseException as e:  # noqa: BLE001 - routed to the caller
                m.error = e
            return
        try:
            outs = self._run_batched(
                [m.prep for m in members],
                tenants=[m.tenant for m in members if m.tenant is not None],
                kws=[m.kw for m in members],
            )
        except Exception as e:  # noqa: BLE001 - batch fault: contain per tenant
            # the batch PROGRAM faulted: re-run each member solo, so healthy
            # tenants still get their exact answers and a faulty one surfaces
            # its own error
            with self._lock:
                self.batch_faults += 1
            log.warning("batched solve of %d tenants faulted (%s: %s); re-running each solo",
                        len(members), type(e).__name__, e)
            for m in members:
                try:
                    m.outputs = m.solo()
                    m.batch_n = 1
                except BaseException as e:  # noqa: BLE001 - per-tenant verdict
                    m.error = e
            return
        for m, out in zip(members, outs):
            m.outputs = out
            m.batch_n = len(members)

    @staticmethod
    def _run_batched(preps, tenants=None, kws=None) -> List[object]:
        """One batched dispatch over the stacked preps; returns per-tenant
        output slices (equal to solo solves).  ``kws`` (per-member dispatch
        kwargs, aligned with ``preps``) carries repair dispatches: members
        with a ``warm_carry`` stack their per-tick count vectors, the
        ex-static planes (synthesized empty for preps that never had a
        fleet), warm carries and repair plans, and run the batched REPAIR
        program; the rendezvous key guarantees every member of one group
        agrees on the variant and the window width.  ``tenants`` names the
        members (the reference's span attribute; unused here)."""
        from karpenter_core_tpu_torch.solver import cuda as cuda_solver

        p0 = preps[0]
        kws = kws if kws is not None else [None] * len(preps)

        def kw_of(i):
            return kws[i] or {}

        kw0 = kw_of(0)
        has_warm = kw0.get("warm_carry") is not None
        has_ex = p0.ex_state is not None and not has_warm
        n_slots = int(kw0.get("n_slots") or 0) or int(p0.n_slots)

        def stack(trees):
            return batch.stack(list(trees))

        cls = stack(cuda_solver.prep_classes(p, kw_of(i).get("count"))
                    for i, p in enumerate(preps))
        # one ledger entry for the stacked dispatch, its rows counted on the
        # host: padded rows never carry pods, and a repair's count holds only
        # its tick's delta pods
        real_rows = sum(
            p.real_rows if kw_of(i).get("count") is None
            else int(np.count_nonzero(np.asarray(kw_of(i)["count"])))
            for i, p in enumerate(preps)) / len(preps)
        compilecache.record_batch_occupancy(real_rows, cls.count.shape[1], n_slots,
                                            n_passes=p0.n_passes, tenants=len(preps))
        statics = stack(p.statics_arrays for p in preps)
        ex_state = ex_static = warm_carry = repair_plan = None
        if has_warm:
            ex_static = stack(
                p.ex_static if p.ex_static is not None else solve_ops.empty_existing_static(
                    p.cls.requests.shape[-1], p.cls.count.shape[0],
                    p.statics_arrays.grp_skew.shape[0], device=p.cls.count.device)
                for p in preps
            )
            warm_carry = stack(kw_of(i)["warm_carry"] for i in range(len(preps)))
            repair_plan = stack(kw_of(i)["repair_plan"] for i in range(len(preps)))
        elif has_ex:
            ex_state = stack(p.ex_state for p in preps)
            ex_static = stack(p.ex_static for p in preps)
        # the stacked carry is the batch's own copy: the scan commits into it
        outs = solve_ops.solve_core_batched(
            cls, statics, n_slots, p0.key_has_bounds, ex_state, ex_static,
            n_passes=p0.n_passes, features=compilecache.snap_features(p0.features),
            warm_carry=warm_carry, repair_plan=repair_plan, donate_carry=True)
        # per-tenant slices of the stacked device outputs (each a contiguous
        # view; decode fetches through K4 tenant by tenant)
        return [batch.tree_map(lambda a, i=i: a[i], outs) for i in range(len(preps))]


# -- per-tenant state ---------------------------------------------------------


@dataclass
class TenantEntry:
    """Everything the plane keeps per tenant."""

    tenant_id: str
    session: object  # solver.incremental.IncrementalSolveSession
    breaker: retry.CircuitBreaker
    bucket: retry.RetryBudget
    shed_backoff: retry.Backoff
    # re-entrant: a caller may hold it across the whole solve, and the
    # dispatch hook re-takes it for its own field access
    lock: threading.RLock = field(default_factory=threading.RLock)
    last_seen: float = 0.0
    # the size of the batch this tenant's last dispatch ran in (1 = solo)
    last_batched: int = 1
    # the resolved weight this entry's bucket was shaped for
    weight: float = 1.0


def _delta_window_env() -> Optional[int]:
    """``KC_DELTA_WINDOW`` as the session's ``window_min`` (None when unset:
    the session's own default; 0 turns windowing off)."""
    raw = os.environ.get("KC_DELTA_WINDOW", "")
    try:
        return int(raw) if raw else None
    except ValueError:
        return None


class TenantPlane:
    """Admission + sessions + breakers + the coalescer, as one unit.
    Thread-safe; ``clock`` drives every timing POLICY (TTL, breaker reset,
    bucket refill) so FakeClock suites are deterministic.  A session is
    created without a solver: the caller binds one (``session.rebind``)
    before its first solve."""

    def __init__(self, clock: Optional[Clock] = None,
                 config: Optional[TenantConfig] = None) -> None:
        self.clock = clock or Clock()
        self.config = config or TenantConfig.from_env()
        self.coalescer = BatchCoalescer(
            self.config.batch_window_s, self.config.max_batch
        )
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, TenantEntry]" = OrderedDict()
        self._inflight = 0
        self._last_sweep = self.clock.now()
        # graceful drain: set, every admission sheds with a retry-after hint
        # while in-flight solves finish
        self._draining = False
        self._drain_hint_s = 5.0
        # session-drop hook (the reference's journal records evictions here)
        self.on_drop: Optional[Callable[[str], None]] = None

    # -- session lifecycle -----------------------------------------------------

    def _new_entry(self, tenant_id: str, weight: float = 1.0) -> TenantEntry:
        from karpenter_core_tpu_torch.solver.incremental import (
            FallbackPolicy,
            IncrementalSolveSession,
        )

        cfg = self.config
        budget, window_s = cfg.bucket_shape(weight)
        entry = TenantEntry(
            tenant_id=tenant_id,
            session=None,
            breaker=retry.CircuitBreaker(
                self.clock,
                failure_threshold=cfg.breaker_threshold,
                reset_timeout_s=cfg.breaker_reset_s,
                name=f"tenant:{tenant_id}",
            ),
            bucket=retry.RetryBudget(
                self.clock, budget=budget, window_s=window_s, name=f"tenant:{tenant_id}",
            ),
            shed_backoff=retry.Backoff(0.25, 30.0),
            last_seen=self.clock.now(),
            weight=weight,
        )
        entry.session = IncrementalSolveSession(
            None, FallbackPolicy(), window_min=_delta_window_env(),
            run_prepared=lambda prep, **kw: self._dispatch(entry, prep, **kw),
        )
        return entry

    def _dispatch(self, entry: TenantEntry, prep, **kw):
        """The session's dispatch hook: plain full solves AND repair
        dispatches (``warm_carry`` + ``repair_plan`` kwargs) are coalescing
        candidates.  Anything else parameterized (the slot-exhaustion retry)
        dispatches solo."""
        solver = entry.session.solver
        is_repair = (
            kw.get("warm_carry") is not None
            and kw.get("repair_plan") is not None
        )
        fusable = not kw or (is_repair and self.config.coalesce_repairs)
        if not fusable:
            with entry.lock:
                entry.last_batched = 1
            return solver.run_prepared(prep, **kw)
        outputs, batched = self.coalescer.run(
            prep, lambda: solver.run_prepared(prep, **kw),
            tenant=entry.tenant_id, kw=kw or None,
        )
        with entry.lock:
            entry.last_batched = batched
        return outputs

    def checkout(self, tenant_id: str, weight: Optional[float] = None) -> TenantEntry:
        """The tenant's entry (created on first sight), LRU-touched; expired
        and over-capacity sessions are evicted on the way.  A changed
        ``weight`` reshapes the entry's bucket in place."""
        now = self.clock.now()
        with self._lock:
            self._sweep_locked(now)
            entry = self._entries.get(tenant_id)
            if entry is None:
                entry = self._new_entry(
                    tenant_id, weight if weight is not None else 1.0
                )
                self._entries[tenant_id] = entry
                while len(self._entries) > self.config.max_sessions:
                    _evicted_id, evicted = self._entries.popitem(last=False)
                    self._drop_entry(evicted, "lru")
            else:
                self._entries.move_to_end(tenant_id)
                if weight is not None and abs(weight - entry.weight) > 1e-9:
                    budget, window_s = self.config.bucket_shape(weight)
                    entry.bucket.reconfigure(budget, window_s)
                    entry.weight = weight
            entry.last_seen = now
            return entry

    def entries_snapshot(self) -> Dict[str, TenantEntry]:
        """A point-in-time copy of the resident tenant map."""
        with self._lock:
            return dict(self._entries)

    def discard_entry(self, tenant_id: str) -> None:
        """Remove a tenant: its next request re-anchors."""
        with self._lock:
            self._entries.pop(tenant_id, None)

    def _sweep_locked(self, now: float) -> None:
        ttl = self.config.session_ttl_s
        if ttl <= 0:
            return
        # cadence-bound: expiry only needs catching within a fraction of
        # the TTL, not on every access
        if now - self._last_sweep < max(ttl / 8.0, 1.0):
            return
        self._last_sweep = now
        expired = [
            tid for tid, e in self._entries.items() if now - e.last_seen > ttl
        ]
        for tid in expired:
            self._drop_entry(self._entries.pop(tid), "ttl")

    def _drop_entry(self, entry: TenantEntry, reason: str) -> None:
        if self.on_drop is not None:
            self.on_drop(entry.tenant_id)

    def sessions(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    # -- admission -------------------------------------------------------------

    def start_draining(self, retry_after_s: float = 5.0) -> None:
        """Graceful drain: every subsequent admission sheds with this
        retry-after hint; in-flight solves finish normally."""
        self._drain_hint_s = max(retry_after_s, 0.1)
        self._draining = True

    def admit(self, tenant_id: str, weight=None) -> AdmissionDecision:
        """Admission gate; an admitted request MUST be paired with
        ``release()``.  Order: draining → isolation (breaker) → global
        in-flight bound → per-tenant rate.  The queue check runs before the
        token bucket so global pressure from OTHER tenants never burns this
        tenant's tokens."""
        if self._draining:
            # no checkout: a draining plane must not mint fresh sessions
            return AdmissionDecision(False, "draining", self._drain_hint_s)
        entry = self.checkout(
            tenant_id, weight=self.config.resolve_weight(tenant_id, weight)
        )
        if not entry.breaker.allow():
            hint = max(entry.breaker.reset_timeout_s, 1.0)
            return AdmissionDecision(False, "isolated", hint, entry=entry)
        granted_trial = entry.breaker.state == retry.HALF_OPEN
        with self._lock:
            queued = self._inflight >= self.config.max_inflight
            if not queued:
                self._inflight += 1
        if queued:
            if granted_trial:
                entry.breaker.release_trial()  # shed is not a backend verdict
            hint = max(entry.shed_backoff.next(), 0.25)
            return AdmissionDecision(False, "queue", hint, entry=entry)
        if not entry.bucket.allow():
            with self._lock:
                self._inflight = max(0, self._inflight - 1)
            if granted_trial:
                entry.breaker.release_trial()
            hint = max(entry.bucket.next_token_s(), 0.05)
            # repeated sheds escalate the hint (reset on the next admit)
            hint = max(hint, entry.shed_backoff.next())
            return AdmissionDecision(False, "rate", hint, entry=entry)
        entry.shed_backoff.reset()
        return AdmissionDecision(True, entry=entry, trial=granted_trial)

    def release(self, tenant_id: str) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    # -- fault accounting ------------------------------------------------------

    def record_bad_request(self, entry: TenantEntry, reason: str) -> None:
        """Malformed / oversized snapshot: counts toward isolation."""
        entry.breaker.record_failure()

    def record_fault(self, entry: TenantEntry) -> None:
        """This tenant's solve faulted (ejected from its batch)."""
        entry.breaker.record_failure()

    def record_timeout(self, entry: TenantEntry) -> None:
        """This tenant's solve overran its deadline: counts like a fault."""
        entry.breaker.record_failure()

    def record_ok(self, entry: TenantEntry) -> None:
        entry.breaker.record_success()

