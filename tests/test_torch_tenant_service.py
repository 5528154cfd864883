"""The port's tenant plane (karpenter_core_tpu_torch/service/tenant.py)
driven in process, on a ``FakeClock``, against the JAX package's.

The admission, fair-share, draining, isolation and eviction contracts of
tests/test_tenant_service.py run as call scripts that go through both
packages' ``TenantPlane`` on the same clock steps: every admission decision
(admitted, reason, retry-after hint, trial), bucket shape, breaker state and
resident-session list must agree exactly.  The coalescer's ``max_batch`` cap
and its batch-fault solo fallback, and the three contracts of
tests/test_solve_fusion.py (divergent fleets under steady churn, ex-plane
coalescing, ``KC_COALESCE_WINDOW=0``), run on the port's plane over
threads, without gRPC: each tenant's coalesced ticks must equal the same
tenant's run with coalescing off (``batch_window_s=0``), every dispatch of
a round in one batch.
"""

import copy
import dataclasses
import logging
import threading

import numpy as np
import pytest
import torch_history

from karpenter_core_tpu.service import tenant as jtenant
from karpenter_core_tpu.utils import retry as jretry
from karpenter_core_tpu.utils.clock import FakeClock as JFakeClock
from karpenter_core_tpu_torch.models.columnar import PodIngest
from karpenter_core_tpu_torch.service import tenant as ttenant
from karpenter_core_tpu_torch.testing.workloads import build_cluster, build_inputs, churn_tick
from karpenter_core_tpu_torch.utils import retry as tretry
from karpenter_core_tpu_torch.utils.clock import FakeClock as TFakeClock

# both packages' slot and feature histories start empty for this module and
# are put back after it (tests/torch_history.py)
isolated_history = torch_history.isolated_history


def _loose(**kw) -> dict:
    """A config that never sheds or batches unless the test asks for it."""
    base = dict(rate_per_s=1000.0, burst=1000, max_inflight=64, batch_window_s=0.0,
                max_batch=8, breaker_threshold=3, breaker_reset_s=30.0)
    base.update(kw)
    return base


def _decision(d):
    return (d.admitted, d.reason, d.retry_after_s, d.trial,
            d.entry.tenant_id if d.entry is not None else None)


def _apply(plane, clock, script):
    log = []
    for op, *args in script:
        if op == "admit":
            log.append(_decision(plane.admit(*args)))
        elif op == "release":
            plane.release(args[0])
        elif op == "step":
            clock.step(args[0])
        elif op == "checkout":
            e = plane.checkout(*args)
            log.append((e.tenant_id, e.weight, e.bucket.budget, e.bucket.refill_per_s,
                        e.bucket.remaining()))
        elif op == "allow":
            log.append(plane.checkout(args[0]).bucket.allow())
        elif op == "bad":
            plane.record_bad_request(plane.checkout(args[0]), "malformed")
        elif op == "fault":
            plane.record_fault(plane.checkout(args[0]))
        elif op == "timeout":
            plane.record_timeout(plane.checkout(args[0]))
        elif op == "ok":
            plane.record_ok(plane.checkout(args[0]))
        elif op == "breaker":
            log.append(plane.checkout(args[0]).breaker.state)
        elif op == "sessions":
            log.append(plane.sessions())
        elif op == "drain":
            plane.start_draining(*args)
        elif op == "inflight":
            log.append(plane.inflight())
        else:
            raise ValueError(op)
    return log


def _both(script, **config):
    """The script's log on the JAX plane and on the port's; they must agree."""
    jclock, tclock = JFakeClock(), TFakeClock()
    jlog = _apply(jtenant.TenantPlane(clock=jclock, config=jtenant.TenantConfig(**config)),
                  jclock, script)
    tlog = _apply(ttenant.TenantPlane(clock=tclock, config=ttenant.TenantConfig(**config)),
                  tclock, script)
    assert tlog == jlog
    return tlog


# -- admission ---------------------------------------------------------------------


def test_rate_shed_carries_the_exact_retry_after():
    log = _both([("admit", "a"), ("release", "a"), ("admit", "a"), ("step", 4.0),
                 ("admit", "a"), ("step", 6.0), ("admit", "a")],
                **_loose(rate_per_s=0.1, burst=1))
    assert log[0][0] and not log[1][0] and log[1][1] == "rate"
    assert log[1][2] == pytest.approx(10.0)  # one token at 0.1 / s
    assert log[2][2] == pytest.approx(6.0)
    assert log[3][0]
    detail = ttenant.AdmissionDecision(False, "rate", 6.0).detail()
    assert ttenant.parse_retry_after(detail) == jtenant.parse_retry_after(detail) == 6.0


def test_one_tenants_burst_does_not_shed_another():
    log = _both([("admit", "noisy"), ("admit", "noisy"), ("admit", "quiet")],
                **_loose(rate_per_s=0.1, burst=1))
    assert log[0][0] and not log[1][0] and log[2][0]


def test_queue_bound_sheds_with_hint():
    log = _both([("admit", "a"), ("admit", "b"), ("release", "a"), ("admit", "b"),
                 ("inflight",)], **_loose(max_inflight=1))
    assert not log[1][0] and log[1][1] == "queue" and log[1][2] > 0
    assert log[2][0] and log[3] == 1


def test_shed_hints_escalate_while_hammering():
    log = _both([("admit", "a"), ("release", "a")] + [("admit", "a")] * 4,
                **_loose(rate_per_s=1000.0, burst=1))
    hints = [d[2] for d in log[1:]]
    assert hints[0] < hints[1] < hints[2] < hints[3]


def test_queue_shed_does_not_burn_rate_tokens():
    log = _both([("admit", "hog")] + [("admit", "victim")] * 5
                + [("release", "hog"), ("admit", "victim")],
                **_loose(max_inflight=1, rate_per_s=0.001, burst=1))
    assert all(d[1] == "queue" for d in log[1:6]) and log[6][0]


def test_retry_budget_next_token_hint():
    hints = []
    for mod, clock in ((jretry, JFakeClock()), (tretry, TFakeClock())):
        bucket = mod.RetryBudget(clock, budget=2, window_s=20.0, name="t")
        seq = [bucket.next_token_s(), bucket.allow(), bucket.allow(), bucket.allow()]
        hint = bucket.next_token_s()
        clock.step(hint)
        hints.append(seq + [hint, bucket.allow()])
    assert hints[0] == hints[1] == [0.0, True, True, False, 10.0, True]


# -- weighted fair share -----------------------------------------------------------


def test_env_weights_scale_burst_and_rate(monkeypatch):
    monkeypatch.setenv("KC_TENANT_WEIGHTS", "heavy=4.0, light=0.5, bad=x")
    jc, tc = jtenant.TenantConfig.from_env(), ttenant.TenantConfig.from_env()
    for name in (f.name for f in dataclasses.fields(tc)):
        assert getattr(tc, name) == getattr(jc, name), name
    for tid in ("heavy", "light", "unlisted"):
        assert tc.resolve_weight(tid) == jc.resolve_weight(tid)
    log = _both([("checkout", "heavy", 4.0), ("checkout", "light", 0.5)],
                **_loose(rate_per_s=1.0, burst=4, weights={"heavy": 4.0, "light": 0.5}))
    assert log[0][2:4] == (16.0, pytest.approx(4.0)) and log[1][2:4] == (2.0, 0.5)


def test_weighted_tenant_sheds_after_its_weighted_burst():
    script = ([("admit", "heavy", 3.0), ("release", "heavy")] * 6 + [("admit", "heavy", 3.0)]
              + [("admit", "plain"), ("release", "plain")] * 2 + [("admit", "plain")])
    log = _both(script, **_loose(rate_per_s=0.1, burst=2, weights={"heavy": 3.0}))
    assert all(d[0] for d in log[:6]) and log[6][1] == "rate"
    assert log[7][0] and log[8][0] and log[9][1] == "rate" and log[9][2] >= 0.05


def test_wire_weight_claims_are_honored_but_env_wins():
    log = _both([("admit", "claimer", 5.0), ("checkout", "claimer"), ("admit", "pinned", 50.0),
                 ("checkout", "pinned")],
                **_loose(rate_per_s=1.0, burst=4, weights={"pinned": 2.0}))
    assert log[1][2] == 20.0 and log[3][2] == 8.0


def test_weight_change_reshapes_bucket_proportionally():
    log = _both([("checkout", "a", 1.0), ("allow", "a"), ("allow", "a"), ("checkout", "a"),
                 ("checkout", "a", 2.0)], **_loose(rate_per_s=1.0, burst=4))
    assert log[3][4] == pytest.approx(2.0)
    assert log[4][1:3] == (2.0, 8.0) and log[4][4] == pytest.approx(4.0)


def test_weight_clamps():
    for mod in (jtenant, ttenant):
        config = mod.TenantConfig(**_loose(weights={"evil": 1e9}))
        assert config.resolve_weight("evil") == 100.0
        assert config.resolve_weight("x", wire_weight=-5) == 0.01
        assert config.resolve_weight("x", wire_weight="bogus") == 1.0
        assert mod.parse_weights(" a=2 , b=oops, c=1e-9,=3") == {"a": 2.0, "c": 0.01, "": 3.0}


# -- draining, isolation, eviction -------------------------------------------------


def test_draining_sheds_without_minting_sessions():
    log = _both([("drain", 7.0), ("admit", "newcomer"), ("sessions",)], **_loose())
    assert log[0][:3] == (False, "draining", 7.0) and log[1] == []


def test_breaker_isolates_one_tenant_and_half_opens():
    script = [("bad", "bad"), ("bad", "bad"), ("admit", "bad"), ("admit", "good"),
              ("breaker", "bad"), ("step", 31.0), ("admit", "bad"), ("admit", "bad"),
              ("ok", "bad"), ("breaker", "bad"), ("fault", "good"), ("timeout", "good"),
              ("breaker", "good")]
    log = _both(script, **_loose(breaker_threshold=2))
    assert log[0][1] == "isolated" and log[0][2] == 30.0 and log[1][0]
    assert log[2] == jretry.OPEN == tretry.OPEN
    assert log[3][0] and log[3][3]  # the half-open trial
    assert log[4][1] == "isolated"
    assert log[5] == "closed" and log[6] == "open"


def test_ttl_eviction_on_fake_clock():
    log = _both([("checkout", "a"), ("step", 61.0), ("checkout", "b"), ("sessions",)],
                **_loose(session_ttl_s=60.0))
    assert log[-1] == ["b"]


def test_lru_eviction_caps_resident_sessions():
    dropped = []
    plane = ttenant.TenantPlane(clock=TFakeClock(), config=ttenant.TenantConfig(
        **_loose(max_sessions=2)))
    plane.on_drop = dropped.append
    for tid in ("a", "b", "c"):
        plane.checkout(tid)
    assert dropped == ["a"]
    log = _both([("checkout", "a"), ("checkout", "b"), ("checkout", "c"), ("sessions",),
                 ("checkout", "b"), ("checkout", "d"), ("sessions",)],
                **_loose(max_sessions=2))
    assert log[3] == ["b", "c"] and log[6] == ["b", "d"]


# -- the coalescer -----------------------------------------------------------------


class _FakePrep:
    def __init__(self):
        import torch

        self.cls = (torch.zeros(2, dtype=torch.int32),)
        self.statics_arrays = (torch.ones(2, dtype=torch.int32),)
        self.ex_state = self.ex_static = None
        self.n_slots, self.key_has_bounds, self.n_passes, self.features = 4, (False,), 1, None


def test_coalescer_never_exceeds_max_batch(monkeypatch):
    sizes = []

    def fake_batched(preps, tenants=None, kws=None):
        sizes.append(len(preps))
        return [("out", i) for i in range(len(preps))]

    monkeypatch.setattr(ttenant.BatchCoalescer, "_run_batched", staticmethod(fake_batched))
    coalescer = ttenant.BatchCoalescer(window_s=0.3, max_batch=2)
    results = []
    threads = [threading.Thread(
        target=lambda: results.append(coalescer.run(_FakePrep(), lambda: ("solo", 0))))
        for _ in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == 5 and all(out is not None for out, _ in results)
    assert sizes and all(size <= 2 for size in sizes), sizes
    assert all(n <= 2 for _, n in results)


def test_window_zero_runs_solo():
    coalescer = ttenant.BatchCoalescer(window_s=0.0, max_batch=8)
    assert coalescer.run(_FakePrep(), lambda: "solo") == ("solo", 1)


# -- solves through the plane (the fusion contracts) -------------------------------

N_TYPES = 20


def _tenant_world(n_pods: int, n_nodes: int, seed: int):
    """(solver, ingest, state_nodes, bound_pods) of one tenant: the headline
    mix of ``n_pods`` pending pods, on a fleet of ``n_nodes``."""
    solver, pods = build_inputs(n_pods, N_TYPES, 2, device="cpu")
    nodes, bound = build_cluster(n_nodes, N_TYPES, 2, 0.6, seed) if n_nodes else ([], [])
    ingest = PodIngest()
    ingest.add_all(pods)
    return solver, ingest, nodes, bound


def _summary(results):
    return (
        sorted((sorted(p.uid for p in n.pods), list(n.instance_type_names), list(n.zones))
               for n in results.new_nodes),
        sorted(p.uid for p in results.failed_pods),
        {k: sorted(p.uid for p in v) for k, v in results.existing_assignments.items()},
    )


def _rounds(worlds, ticks: int):
    """Each tenant's population for the anchor and ``ticks`` rounds of 2 %
    churn, drawn once so that every run sees the same pods."""
    rounds = []
    reps = {t: {} for t in worlds}
    for tick in range(ticks + 1):
        snap = {}
        for t, (_solver, ingest, _n, _b) in worlds.items():
            if tick:
                churn_tick(ingest, tick, reps[t])
            snap[t] = copy.deepcopy(ingest)
        rounds.append(snap)
    return rounds


def _drive(plane, worlds, rounds, concurrent: bool):
    """Every round's solves through the plane's sessions, concurrent
    (threads) or one after another.  Returns per tenant the (summary, mode,
    batch size) of every solve, and the final warm state."""
    out = {t: [] for t in worlds}
    for t, (solver, *_rest) in worlds.items():
        plane.checkout(t).session.rebind(solver)

    def one(t, ingest):
        _solver, _ingest, nodes, bound = worlds[t]
        entry = plane.checkout(t)
        res = entry.session.solve(ingest, nodes, bound)
        out[t].append((_summary(res), entry.session.last_mode, entry.last_batched))

    for snap in rounds:
        ingests = {t: copy.deepcopy(i) for t, i in snap.items()}
        if concurrent:
            errors = []

            def wrap(t):
                try:
                    one(t, ingests[t])
                except Exception as e:  # noqa: BLE001 - surfaced below
                    errors.append(e)

            threads = [threading.Thread(target=wrap, args=(t,)) for t in worlds]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            if errors:
                raise errors[0]
        else:
            for t in sorted(worlds):
                one(t, ingests[t])
    warm = {}
    for t in worlds:
        w = plane.checkout(t).session._warm
        warm[t] = (w.assign.copy(), w.assign_ex.copy(), w.n_next, dict(w.pod_loc))
    return out, warm


def _worlds(sizes, fleets=None):
    fleets = fleets or [0] * len(sizes)
    return {f"t{i}": _tenant_world(n, f, 7 + i) for i, (n, f) in enumerate(zip(sizes, fleets))}


def _plane(window_s: float, k: int, **kw):
    return ttenant.TenantPlane(clock=TFakeClock(), config=ttenant.TenantConfig(
        **_loose(batch_window_s=window_s, max_batch=k, **kw)))


def test_divergent_tenants_steady_churn_equal_their_solo_runs(monkeypatch):
    """Three tenants of different sizes and fleets: anchors and every repair
    of three churn ticks fuse in one batch, and each tenant's answers and
    final warm state equal its own run with coalescing off."""
    monkeypatch.setenv("KC_DELTA_WINDOW", "0")
    worlds = _worlds((300, 290, 280), fleets=(6, 7, 8))
    rounds = _rounds(worlds, 3)
    fused, fused_warm = _drive(_plane(30.0, 3), worlds, rounds, concurrent=True)
    solo, solo_warm = _drive(_plane(0.0, 3), worlds, rounds, concurrent=False)
    for t in worlds:
        assert [m for _, m, _ in fused[t]] == ["full", "delta", "delta", "delta"]
        assert [n for _, _, n in fused[t]] == [3, 3, 3, 3], t
        assert [s for s, _, _ in fused[t]] == [s for s, _, _ in solo[t]], t
        f, s = fused_warm[t], solo_warm[t]
        np.testing.assert_array_equal(f[0], s[0])
        np.testing.assert_array_equal(f[1], s[1])
        assert f[2:] == s[2:]


def test_divergent_fleets_anchor_coalesce_equal_to_solo():
    """Fleets of different sizes whose padded existing-node planes share a
    bucket fuse their anchor solves, each equal to its solo solve."""
    worlds = _worlds((240, 240, 240, 240), fleets=(5, 6, 7, 8))
    rounds = _rounds(worlds, 0)
    fused, _ = _drive(_plane(30.0, 4), worlds, rounds, concurrent=True)
    solo, _ = _drive(_plane(0.0, 4), worlds, rounds, concurrent=False)
    for t in worlds:
        assert fused[t][0][2] == 4 and fused[t][0][0] == solo[t][0][0]
        assert fused[t][0][0][2], "the fleet took pods"


def test_coalesce_window_zero_keeps_repairs_solo_but_anchors_fuse(monkeypatch):
    monkeypatch.setenv("KC_DELTA_WINDOW", "0")
    monkeypatch.setenv("KC_COALESCE_WINDOW", "0")
    config = ttenant.TenantConfig.from_env()
    assert not config.coalesce_repairs and not jtenant.TenantConfig.from_env().coalesce_repairs
    worlds = _worlds((300, 290))
    rounds = _rounds(worlds, 1)
    fused, _ = _drive(_plane(30.0, 2, coalesce_repairs=False), worlds, rounds, concurrent=True)
    solo, _ = _drive(_plane(0.0, 2), worlds, rounds, concurrent=False)
    for t in worlds:
        assert [n for _, _, n in fused[t]] == [2, 1]
        assert [m for _, m, _ in fused[t]] == ["full", "delta"]
        assert [s for s, _, _ in fused[t]] == [s for s, _, _ in solo[t]]


def test_batch_program_fault_falls_back_to_solo(monkeypatch, caplog):
    """A fault of the batched program re-runs every member solo: the
    answers still land, equal to solo solves, each in a batch of one."""
    def boom(preps, tenants=None, kws=None):
        raise RuntimeError("batched program died")

    worlds = _worlds((300, 290))
    rounds = _rounds(worlds, 0)
    solo, _ = _drive(_plane(0.0, 2), worlds, rounds, concurrent=False)
    monkeypatch.setattr(ttenant.BatchCoalescer, "_run_batched", staticmethod(boom))
    plane = _plane(30.0, 2)
    with caplog.at_level(logging.WARNING, logger=ttenant.__name__):
        fused, _ = _drive(plane, worlds, rounds, concurrent=True)
    for t in worlds:
        assert fused[t][0][2] == 1 and fused[t][0][0] == solo[t][0][0]
    # the fault is counted and logged, not only contained
    assert plane.coalescer.batch_faults == 1
    assert any("batched program died" in r.getMessage() for r in caplog.records)
