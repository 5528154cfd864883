"""The port's warm repair path held against the JAX package's, on the CPU.

Every case feeds the same seeded inputs to both packages; ints and bools
must be exact and f32 bit for bit.

- the host bookkeeping: ``_window_indices`` over a grid of holes,
  ``n_next``, ``n_slots`` and window minimum (the reference reads the
  minimum from ``KC_DELTA_WINDOW``); ``diff_members`` and ``apply``;
  ``class_key``, ``supply_digest`` and ``catalog_digest`` on the same
  objects (port objects rebuilt as JAX ones by ``_to_jax``);
  ``FallbackPolicy.decide`` for every reason;
- K10-K12's twins (``repair_free``, ``gather_repair_window``,
  ``scatter_repair_window``) on carries of real JAX solves of
  ``build_inputs(700, 50, 5)``, into an empty cluster and into
  ``build_cluster(60, 50, 5, 0.6, 3)``, with a slot freed by two classes;
  the input carry stays unchanged;
- the warm ``solve_core``, windowed and unwindowed, with a non-zero hole
  preference, leaf for leaf;
- whole sessions, tick for tick (mode, reason, ``node_signature``,
  ``aggregates``), on the reference tests' ``_population`` / ``_churn``
  sequences, each tick's signature also equal to the port's own full
  re-solve: windowed, with existing nodes, a re-minted class, an unseen
  class, a provisioner change, the audit, a window exhaustion;
- the mid-size live-cluster churn that chip_smoke.py pins (``MID_CHURN``);
- ``workloads.churn_tick`` against ``bench.churn_line``'s loop.
"""

import copy
import dataclasses
import math
import random
from fractions import Fraction
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from test_torch_existing import _assert_leaves_equal, _chip_smoke, _np, _reference_inputs, _to_jax
import torch_history

import karpenter_core_tpu.cloudprovider.fake as jfake
import karpenter_core_tpu.models.columnar as jcolumnar
import karpenter_core_tpu.testing as jtesting
from karpenter_core_tpu.models import store as jstore
from karpenter_core_tpu.ops import solve as jsolve
from karpenter_core_tpu.solver import incremental as jinc
from karpenter_core_tpu.solver.tpu import TPUSolver
from karpenter_core_tpu_torch import carry as tcarry
from karpenter_core_tpu_torch.apis.objects import new_uid
from karpenter_core_tpu_torch.cloudprovider import fake as tfake
from karpenter_core_tpu_torch.models import store as tstore
from karpenter_core_tpu_torch.models.columnar import PodIngest
from karpenter_core_tpu_torch.ops import solve as tsolve
from karpenter_core_tpu_torch.solver import incremental as tinc
from karpenter_core_tpu_torch.solver.cuda import CudaSolver
from karpenter_core_tpu_torch.testing import make_pods, make_provisioner, workloads

# both packages' slot and feature histories start empty for this module and
# are put back after it (tests/torch_history.py)
isolated_history = torch_history.isolated_history


CPU = torch.device("cpu")
POLICY = dict(enabled=True, audit_interval=0, max_delta_fraction=0.9)


@pytest.fixture(scope="module", autouse=True)
def _module_environment(tmp_path_factory):
    """The reference memoizes a compiled solve only once its export cache
    could write it: a directory of its own lets each shape compile once.
    Its dispatch watchdog (a production deadline, 10 s at the least) would
    abandon a first compile that a loaded CPU stretches past it; off, the
    reference runs the same program inline (``KC_WATCHDOG=0``).  The planes
    are small: one torch intra-op thread runs them as fast and leaves the
    other cores to the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KC_TPU_COMPILE_CACHE", str(tmp_path_factory.mktemp("kc_compile_cache")))
        mp.setenv("KC_WATCHDOG", "0")
        yield
    torch.set_num_threads(threads)


def _t(a) -> torch.Tensor:
    return tcarry.to_tensor(np.asarray(a), CPU)


def _carry_leaves(wc) -> dict:
    """Every leaf of a WarmCarry (either package's) as numpy."""
    out = {"remaining": _np(wc.remaining)}
    for group in ("state", "ex_state", "topo"):
        tup = getattr(wc, group)
        for f in tup._fields:
            out[f"{group}.{f}"] = _np(getattr(tup, f))
    return out


def _assert_carry_equal(ref, got, label):
    a, b = (x if isinstance(x, dict) else _carry_leaves(x) for x in (ref, got))
    assert a.keys() == b.keys(), label
    for k in a:
        assert a[k].dtype == b[k].dtype, f"{label}: {k} dtype {a[k].dtype} vs {b[k].dtype}"
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{label}: {k}")


def _snapshot(wc) -> dict:
    return {k: v.copy() for k, v in _carry_leaves(wc).items()}


# -- host bookkeeping -----------------------------------------------------------


@pytest.mark.parametrize("window_min", (None, 0, 1, 16, 64))
def test_window_indices_match_reference(window_min, monkeypatch):
    if window_min is None:
        monkeypatch.delenv("KC_DELTA_WINDOW", raising=False)
    else:
        monkeypatch.setenv("KC_DELTA_WINDOW", str(window_min))
    rng = random.Random(window_min or 0)
    checked = 0
    for n_slots in (16, 64, 256, 1000, 8192):
        for n_next in sorted({0, 1, n_slots // 3, n_slots - 9, n_slots - 1, n_slots}):
            for n_holes in (0, 1, 3, 40, 437):
                if n_holes > n_next:
                    continue
                holes = sorted(rng.sample(range(n_next), n_holes))
                ref = jinc._window_indices(holes, n_next, n_slots)
                got = tinc._window_indices(holes, n_next, n_slots, window_min)
                if ref is None:
                    assert got is None, (holes, n_next, n_slots)
                    continue
                np.testing.assert_array_equal(ref[0], got[0])
                assert ref[0].dtype == got[0].dtype and ref[1] == got[1]
                checked += 1
    assert checked > 10 or window_min == 0


def test_diff_members_matches_reference():
    rng = random.Random(1729)
    for trial in range(60):
        keys = [(("k", i),) for i in range(rng.randint(1, 6))]
        prev = {k: tuple(f"u{trial}-{i}-{j}" for j in range(rng.randint(0, 5)))
                for i, k in enumerate(keys) if rng.random() < 0.8}
        cur = {}
        for i, k in enumerate(keys):
            if rng.random() < 0.8:
                kept = tuple(u for u in prev.get(k, ()) if rng.random() < 0.7)
                added = tuple(f"n{trial}-{i}-{j}" for j in range(rng.randint(0, 3)))
                if kept + added:
                    cur[k] = kept + added
        supply = ("supply",) if trial % 5 == 0 else ()
        ref = jstore.diff_members(prev, cur, from_version=7, supply_changed=supply)
        got = tstore.diff_members(prev, cur, from_version=7, supply_changed=supply)
        for f in ("from_version", "to_version", "added", "evicted", "new_classes",
                  "removed_classes", "changed_planes", "pods_before", "pods_after",
                  "added_count", "evicted_count", "delta_fraction", "node_side_changed",
                  "class_shape_changed"):
            assert getattr(got, f) == getattr(ref, f), (trial, f)
        assert got.apply(prev) == cur == ref.apply(prev)


def test_keys_and_digests_match_reference():
    nodes, bound = workloads.build_cluster(60, 50, 5, 0.6, 3)
    solver, pods = workloads.build_inputs(300, 50, 5, device="cpu")
    js, jnodes, jbound, jpods = _reference_inputs(nodes, bound, pods, 50)
    ingest, jingest = PodIngest(), jcolumnar.PodIngest()
    ingest.add_all(pods)
    jingest.add_all(jpods)
    assert ingest.class_members() == jingest.class_members()
    keys = [tstore.class_key(c) for c in ingest.classes()]
    assert keys == [jstore.class_key(c) for c in jingest.classes()]
    # derived without the interned signature too
    assert [tstore.class_key(dataclasses.replace(c, interned_sig=None))
            for c in ingest.classes()] == keys
    assert tstore.supply_digest(nodes, bound) == jstore.supply_digest(jnodes, jbound)
    assert tstore.supply_digest(nodes, bound[1:]) != tstore.supply_digest(nodes, bound)
    assert tstore.supply_digest([], []) == jstore.supply_digest([], [])
    catalog = tstore.catalog_digest(solver.provisioners, solver.instance_types)
    assert catalog == jstore.catalog_digest(js.provisioners, js.instance_types)
    solver.provisioners[0].metadata.resource_version = 999
    js.provisioners[0].metadata.resource_version = 999
    bumped = tstore.catalog_digest(solver.provisioners, solver.instance_types)
    assert bumped != catalog
    assert bumped == jstore.catalog_digest(js.provisioners, js.instance_types)
    snapshot = solver.encode(ingest)
    rows = tstore.SnapshotStore().commit(snapshot).rows
    jrows = jstore.rows_from_snapshot(js.encode(jingest))
    assert [(r.key, r.count, r.uids) for r in rows] == [(r.key, r.count, r.uids) for r in jrows]


def _delta(pkg, **kw):
    base = dict(from_version=1, to_version=2, pods_before=100, pods_after=100)
    base.update(kw)
    return pkg.SnapshotDelta(**base)


# (delta fields, delta_ticks, prev_slots_used, known_classes, policy overrides)
DECISIONS = {
    "first": (None, 0, 0, None, {}),
    "supply-changed": (dict(changed_planes=("supply",)), 0, 0, None, {}),
    "class-shape": (dict(new_classes=(("unseen",),)), 0, 0, None, {}),
    "known-class repair": (dict(new_classes=(("unseen",),)), 0, 0, {("unseen",): 3}, {}),
    "removed-class repair": (dict(removed_classes=(("gone",),)), 0, 0, None, {}),
    "delta-fraction": (dict(added={("k",): tuple(f"u{i}" for i in range(30))}), 0, 0, None, {}),
    "audit": (dict(added={("k",): ("u1",)}), 4, 0, None, {}),
    "materialized-slots": (dict(added={("k",): ("u1",)}), 0, 1, None, {"materialized": True}),
    "delta": (dict(added={("k",): ("u1",)}), 3, 0, None, {}),
    "disabled": (None, 0, 0, None, {"enabled": False}),
}


@pytest.mark.parametrize("case", sorted(DECISIONS))
def test_fallback_policy_matches_reference(case):
    fields, ticks, slots, known, over = DECISIONS[case]
    kw = {**dict(enabled=True, max_delta_fraction=0.25, audit_interval=4), **over}
    ref = jinc.FallbackPolicy(**kw).decide(
        None if fields is None else _delta(jstore, **fields), ticks, slots, known_classes=known)
    got = tinc.FallbackPolicy(**kw).decide(
        None if fields is None else _delta(tstore, **fields), ticks, slots, known_classes=known)
    assert got == ref
    assert got[1].split(":")[0] == case.split(" ")[0] or got == ("delta", "delta")


# -- K10-K12's twins and the warm solve_core on real carries --------------------


@pytest.fixture(scope="module", params=("cold", "cluster"))
def anchor(request):
    """A real JAX solve of build_inputs(700, 50, 5) (into build_cluster(60,
    50, 5, 0.6, 3) for "cluster"), its carry, the port's prep of the same
    input, and an eviction plan: about a fifth of the placements of every
    class, on new slots and existing nodes, with one new slot (and one
    existing node) freed by two classes."""
    nodes, bound = ([], []) if request.param == "cold" else workloads.build_cluster(
        60, 50, 5, 0.6, 3)
    solver, pods = workloads.build_inputs(700, 50, 5, device="cpu")
    js, jnodes, jbound, jpods = _reference_inputs(nodes, bound, pods, 50)
    jprep = js.prepare_encoded(js.encode(jpods, jnodes, jbound), jnodes, jbound)
    jout = jax.device_get(js.run_prepared(jprep))
    prep = solver.prepare_encoded(solver.encode(pods, nodes, bound), nodes, bound)
    assign, assign_ex = np.asarray(jout.assign), np.asarray(jout.assign_existing)
    rng = np.random.default_rng(4)
    free_new = np.where(rng.random(assign.shape) < 0.2, np.minimum(assign, 2), 0).astype(np.int32)
    free_ex = np.where(rng.random(assign_ex.shape) < 0.2, np.minimum(assign_ex, 2),
                       0).astype(np.int32)
    for plane, free in ((assign, free_new), (assign_ex, free_ex)):
        multi = np.nonzero((plane > 0).sum(axis=0) >= 2)[0]
        if len(multi):
            col = multi[0]
            free[:, col] = np.minimum(plane[:, col], 1)
    # the cold solve packs classes together on new slots; into the cluster,
    # each new slot holds one class but existing nodes take several
    two = free_ex if request.param == "cluster" else free_new
    assert ((two > 0).sum(axis=0) >= 2).any(), "no column freed by two classes"
    member, own_inv = jinc._topology_rows(jprep)
    return SimpleNamespace(
        js=js, jprep=jprep, jcarry=jsolve.warm_carry_of(jout), solver=solver, prep=prep,
        free_new=free_new, free_ex=free_ex, member=member, own_inv=own_inv,
        counts=(free_new.sum(axis=1) + free_ex.sum(axis=1)).astype(np.int32),
        cluster=request.param == "cluster",
    )


def _repair_plan(pkg, pref_new, pref_ex, bases, convert):
    return pkg.RepairPlan(convert(pref_new), convert(pref_ex), *(convert(b) for b in bases))


def _freed(a):
    """Both packages' carries after K10's free (the port's from the JAX
    carry, converted)."""
    req = np.asarray(a.jprep.cls.requests, np.float32)
    jfreed = jax.device_get(jsolve.repair_free(a.jcarry, a.free_new, a.free_ex, req, a.member,
                                               a.own_inv))
    carry = tcarry.warm_carry_from_numpy(a.jcarry, CPU)
    before = _snapshot(carry)
    tfreed = tsolve.repair_free(carry, _t(a.free_new), _t(a.free_ex), a.prep.cls.requests,
                                _t(a.member), _t(a.own_inv))
    _assert_carry_equal(before, carry, "repair_free's input carry")
    return jfreed, tfreed


def _window(a, monkeypatch):
    n_slots = a.free_new.shape[1]
    holes = sorted(np.nonzero(a.free_new.sum(axis=0))[0].tolist())
    n_next = int(a.jcarry.state.n_next)
    monkeypatch.setenv("KC_DELTA_WINDOW", "16")
    ref = jinc._window_indices(holes, n_next, n_slots)
    idx, n_open = tinc._window_indices(holes, n_next, n_slots, 16)
    np.testing.assert_array_equal(ref[0], idx)
    assert ref[1] == n_open and n_open > len(holes) - 1
    return idx, n_open


def test_repair_programs_match_reference(anchor, monkeypatch):
    """K10, K11 and K12's twins against the reference's three programs,
    around a windowed repair of the freed carry."""
    a = anchor
    jfreed, tfreed = _freed(a)
    _assert_carry_equal(jfreed, tfreed, "repair_free")
    assert (np.asarray(jfreed.state.pod_count) < np.asarray(a.jcarry.state.pod_count)).any()
    if a.cluster:
        assert (np.asarray(jfreed.ex_state.pod_count)
                < np.asarray(a.jcarry.ex_state.pod_count)).any()
        assert (np.asarray(jfreed.topo.fwd_ex) < np.asarray(a.jcarry.topo.fwd_ex)).any()

    idx, n_open = _window(a, monkeypatch)
    jwin, jbase = jax.device_get(jsolve.gather_repair_window(jfreed, idx, np.int32(n_open)))
    before = _snapshot(tfreed)
    twin, tbase = tsolve.gather_repair_window(tfreed, _t(idx), n_open)
    _assert_carry_equal(jwin, twin, "gather_repair_window")
    for ref, got, name in zip(jbase, tbase, ("fwd_sing", "fwd_full", "inv_full")):
        np.testing.assert_array_equal(np.asarray(ref), got.numpy(), err_msg=name)
    assert any(np.asarray(b).sum() > 0 for b in jbase)

    jplan = _repair_plan(jsolve, a.free_new[:, idx], a.free_ex, jbase, np.asarray)
    jout = jax.device_get(a.js.run_prepared(a.jprep, count=a.counts, warm_carry=jwin,
                                            repair_plan=jplan, n_slots=len(idx),
                                            donate_carry=False))
    tplan = _repair_plan(tsolve, a.free_new[:, idx], a.free_ex, tbase, _t)
    tout = a.solver.run_prepared(a.prep, count=a.counts, warm_carry=twin, repair_plan=tplan)
    jsc = jax.device_get(jsolve.scatter_repair_window(jfreed, jsolve.warm_carry_of(jout), idx,
                                                      np.int32(n_open)))
    tsc = tsolve.scatter_repair_window(tfreed, tsolve.warm_carry_of(tout), _t(idx), n_open)
    _assert_carry_equal(jsc, tsc, "scatter_repair_window")
    _assert_carry_equal(before, tfreed, "the full-width carry after gather and scatter")
    assert int(tsc.state.n_next) == int(a.jcarry.state.n_next) + (int(tout.state.n_next) - n_open)


def _round_f32(x: Fraction) -> np.float32:
    """An exact rational rounded once to float32, ties to even."""
    if x == 0:
        return np.float32(0.0)
    mag = abs(x)
    e = mag.numerator.bit_length() - mag.denominator.bit_length()
    while Fraction(2) ** e > mag:
        e -= 1
    while Fraction(2) ** (e + 1) <= mag:
        e += 1
    scale = Fraction(2) ** (e - 23)
    return np.float32(math.copysign(float(round(mag / scale) * scale), x))


def _class_sum(free, req, fused):
    """sum_c free[c, n] * req[c] in f32, classes ascending: each product and
    sum rounded on its own, or one fused multiply-add a class (computed
    exactly in rationals, then rounded once: a correctly rounded FMA)."""
    acc = np.zeros((free.shape[1], req.shape[1]), np.float32)
    for c in range(free.shape[0]):
        f = free[c].astype(np.float32)[:, None]
        if fused:
            acc = np.array([[_round_f32(Fraction(float(a)) + Fraction(float(fn)) * Fraction(float(r)))
                             for a, r in zip(row, req[c])] for row, fn in zip(acc, f[:, 0])],
                           np.float32).reshape(acc.shape)
        else:
            acc = (acc + (f * req[c][None, :]).astype(np.float32)).astype(np.float32)
    return acc


def _check_repair_free_sum(anchor, req, free_new, free_ex):
    """Both packages' ``used`` after freeing, from zero usage (so each side
    is exactly minus its class sum), against the correctly rounded fused
    class sum, everywhere."""
    a = anchor
    carry = a.jcarry._replace(
        state=a.jcarry.state._replace(used=np.zeros_like(a.jcarry.state.used)),
        ex_state=a.jcarry.ex_state._replace(used=np.zeros_like(a.jcarry.ex_state.used)))
    jfreed = jax.device_get(jsolve.repair_free(carry, free_new, free_ex, req, a.member,
                                               a.own_inv))
    tfreed = tsolve.repair_free(tcarry.warm_carry_from_numpy(carry, CPU), _t(free_new),
                                _t(free_ex), _t(req), _t(a.member), _t(a.own_inv))
    fused_new, rounded_new = (_class_sum(free_new, req, fused=f) for f in (True, False))
    assert (fused_new != rounded_new).any()  # the two orders do differ on this input
    for side, free in (("state", free_new), ("ex_state", free_ex)):
        want = -_class_sum(free, req, fused=True)
        np.testing.assert_array_equal(np.asarray(getattr(jfreed, side).used), want)
        np.testing.assert_array_equal(getattr(tfreed, side).used.numpy(), want)


def test_repair_free_sum_order_against_xla(anchor):
    """K10's f32 sum on requests that are not short binary fractions (a
    cpu request of 0.1 is not exact in f32), with dense evictions (most
    columns freed by several classes): XLA's CPU dot behind the reference's
    einsum fuses one multiply-add a class, classes ascending, and the port
    (its twin with ``fma_f32``, its CUDA kernel with ``__fmaf_rn``) does
    the same, so both equal that sum bit for bit in every column."""
    rng = np.random.default_rng(0)
    req = (rng.random((anchor.free_new.shape[0], 3)) * 4).astype(np.float32)  # full mantissas
    free_new = rng.integers(0, 8, anchor.free_new.shape).astype(np.int32)
    free_ex = rng.integers(0, 8, anchor.free_ex.shape).astype(np.int32)
    _check_repair_free_sum(anchor, req, free_new, free_ex)


def test_repair_free_sum_order_wide_exponents(anchor):
    """The same on requests whose exponents span 2^-20 .. 2^20: a class sum
    and the next product can lie so far apart that ``f * req + sum`` needs
    more than float64's 53 bits, where rounding to float64 and then to
    float32 could land on a float32 midpoint (the twin's round-to-odd step
    keeps it correctly rounded)."""
    rng = np.random.default_rng(1)
    shape = (anchor.free_new.shape[0], 3)
    req = (rng.random(shape) * np.exp2(rng.integers(-20, 21, shape))).astype(np.float32)
    free_new = rng.integers(0, 8, anchor.free_new.shape).astype(np.int32)
    free_ex = rng.integers(0, 8, anchor.free_ex.shape).astype(np.int32)
    _check_repair_free_sum(anchor, req, free_new, free_ex)


@pytest.mark.parametrize("windowed", (True, False))
def test_warm_solve_core_matches_reference(anchor, windowed, monkeypatch):
    """The resumed scan with the freed-hole preference, every SolveOutputs
    leaf; the re-added pods land (mostly in the holes)."""
    a = anchor
    jfreed, tfreed = _freed(a)
    if windowed:
        idx, n_open = _window(a, monkeypatch)
        jrun, jbase = jax.device_get(jsolve.gather_repair_window(jfreed, idx, np.int32(n_open)))
        trun, tbase = tsolve.gather_repair_window(tfreed, _t(idx), n_open)
        pref_new, slots = a.free_new[:, idx], len(idx)
    else:
        g1, n_zones = a.member.shape[1], np.asarray(a.jprep.statics_arrays.tmpl_zone).shape[1]
        jbase = (np.zeros((g1, n_zones), np.int32),) * 3
        tbase = tuple(_t(b) for b in jbase)
        jrun, trun, pref_new, slots = jfreed, tfreed, a.free_new, 0
    assert pref_new.sum() > 0
    jplan = _repair_plan(jsolve, pref_new, a.free_ex, jbase, np.asarray)
    tplan = _repair_plan(tsolve, pref_new, a.free_ex, tbase, _t)
    jout = jax.device_get(a.js.run_prepared(a.jprep, count=a.counts, warm_carry=jrun,
                                            repair_plan=jplan, n_slots=slots,
                                            donate_carry=False))
    before = _snapshot(trun)
    tout = a.solver.run_prepared(a.prep, count=a.counts, warm_carry=trun, repair_plan=tplan)
    _assert_leaves_equal(jout, tout, f"warm solve_core (windowed={windowed})")
    _assert_carry_equal(before, trun, "the warm solve's input carry")
    placed = int(tout.assign.sum() + tout.assign_existing.sum())
    assert placed == int(a.counts.sum()) and int(tout.failed.sum()) == 0
    if not windowed:
        refilled = torch.minimum(tout.assign, _t(a.free_new)).sum()
        assert int(refilled) > 0


# -- whole sessions, tick for tick ----------------------------------------------


def _population(n: int):
    """The reference tests' small mixed population: two generic shapes and a
    labelled shape."""
    pods = make_pods(n // 2, requests={"cpu": "500m"})
    pods += make_pods(n // 4, requests={"cpu": 1})
    pods += make_pods(n - len(pods), requests={"cpu": "250m"}, labels={"app": "spread"})
    return pods


class _Pair:
    """One population held in both packages' ingests, with a session each."""

    def __init__(self, solver, jsolver, pods, policy, window_min=None, nodes=(), bound=()):
        self.solver, self.jsolver = solver, jsolver
        self.ingest, self.jingest = PodIngest(), jcolumnar.PodIngest()
        self.ingest.add_all(pods)
        self.jingest.add_all([_to_jax(p) for p in pods])
        self.session = tinc.IncrementalSolveSession(solver, tinc.FallbackPolicy(**policy),
                                                    window_min=window_min)
        self.jsession = jinc.IncrementalSolveSession(jsolver, jinc.FallbackPolicy(**policy))
        self.nodes, self.bound = list(nodes), list(bound)
        if nodes:
            _, self.jnodes, self.jbound, _ = _reference_inputs(self.nodes, self.bound, [], 1)
        else:
            self.jnodes, self.jbound = [], []
        self.ticks = []

    def remove(self, uid):
        self.ingest.remove(uid)
        self.jingest.remove(uid)

    def add(self, pod):
        self.ingest.add(pod)
        self.jingest.add(_to_jax(pod))

    def churn(self, rng, fraction):
        """The reference tests' ``_churn``: replace ``fraction`` of the
        population with same-shaped fresh pods.  Returns the (removed uid,
        added pod) pairs, in order."""
        members = self.ingest.class_members()
        uids = [(sig, u) for sig, us in members.items() for u in us]
        ops = []
        for i, (_sig, uid) in enumerate(rng.sample(uids, max(int(len(uids) * fraction), 1))):
            rep = copy.deepcopy(self.ingest.get(uid))
            self.remove(uid)
            rep.metadata.name = f"churn-{rng.randint(0, 1 << 30)}-{i}"
            rep.metadata.uid = new_uid()
            rep.spec.node_name = ""
            ops.append((uid, copy.deepcopy(rep)))
            self.add(rep)
        return ops

    def solve(self, check_full=True):
        """One tick in both sessions: the same mode, reason, signature and
        aggregates; the port's signature equal to its own full re-solve."""
        res = self.session.solve(self.ingest, self.nodes or None, self.bound or None)
        self.jsession.solve(self.jingest, self.jnodes or None, self.jbound or None)
        tick = (self.session.last_mode, self.session.last_reason)
        assert tick == (self.jsession.last_mode, self.jsession.last_reason)
        assert self.session.aggregates() == self.jsession.aggregates()
        sig = self.session.node_signature()
        assert sig == self.jsession.node_signature(), f"tick {len(self.ticks)} {tick}"
        if check_full:
            full = tinc.IncrementalSolveSession(self.solver, tinc.FallbackPolicy(enabled=False))
            full.solve(self.ingest, self.nodes or None, self.bound or None)
            assert sig == full.node_signature(), f"tick {len(self.ticks)} {tick} vs full"
        self.ticks.append(tick)
        return res


def _solvers():
    """The reference tests' solver: one provisioner, the default fake catalog."""
    solver = CudaSolver(tfake.FakeCloudProvider(), [make_provisioner(name="prov-0")],
                        device="cpu")
    jsolver = TPUSolver(jfake.FakeCloudProvider(), [jtesting.make_provisioner(name="prov-0")])
    return solver, jsolver


def _pair(policy=POLICY, window_min=None):
    """Both packages' sessions over the reference tests' solver and a
    40-pod ``_population``: every session variant below starts from the
    same shapes, so the reference compiles its programs once."""
    return _Pair(*_solvers(), _population(40), policy, window_min=window_min)


@pytest.fixture(scope="module")
def windowed_reference():
    """The JAX session's half of the windowed session below, run once (its
    windowed repair programs compile past a test's retrace budget when the
    file runs alone): the 40 pods, each tick's churn as (removed uid, added
    pod) pairs, and each tick's (mode, reason), aggregates and signature."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KC_DELTA_WINDOW", "16")
        rng = random.Random(11)
        pods = _population(40)
        pair = _Pair(*_solvers(), copy.deepcopy(pods), POLICY, window_min=16)
        script, ticks = [[]], []
        for t in range(4):
            if t:
                script.append(pair.churn(rng, 0.08))
            pair.jsession.solve(pair.jingest)
            js = pair.jsession
            ticks.append(((js.last_mode, js.last_reason), js.aggregates(), js.node_signature()))
    return {"pods": pods, "script": script, "ticks": ticks}


def test_session_windowed_matches_reference(windowed_reference, monkeypatch):
    """Three ticks of 8 % churn under a 16-slot window: every tick's mode,
    reason, aggregates and signature equal the JAX session's, and the
    signature the port's own full re-solve."""
    monkeypatch.setenv("KC_DELTA_WINDOW", "16")
    solver, _ = _solvers()
    ingest = PodIngest()
    ingest.add_all(copy.deepcopy(windowed_reference["pods"]))
    session = tinc.IncrementalSolveSession(solver, tinc.FallbackPolicy(**POLICY), window_min=16)
    ticks = []
    for t, (ops, want) in enumerate(zip(windowed_reference["script"],
                                        windowed_reference["ticks"])):
        for uid, pod in ops:
            ingest.remove(uid)
            ingest.add(copy.deepcopy(pod))
        session.solve(ingest)
        tick = (session.last_mode, session.last_reason)
        assert tick == want[0]
        assert session.aggregates() == want[1]
        sig = session.node_signature()
        assert sig == want[2], f"tick {t} {tick}"
        full = tinc.IncrementalSolveSession(solver, tinc.FallbackPolicy(enabled=False))
        full.solve(ingest)
        assert sig == full.node_signature(), f"tick {t} {tick} vs full"
        if t:
            assert session.last_window is not None
        ticks.append(tick)
    assert ticks == [("full", "first")] + [("delta", "delta")] * 3
    assert session.aggregates() == {"scheduled": 40, "failed": 0, "nodes": session.node_count()}


def test_session_with_existing_nodes_matches_reference(monkeypatch):
    """build_inputs(700, 50, 5) into build_cluster(60, 50, 5, 0.6, 3), the
    anchor fixture's solve, then three ticks of ``churn_tick``."""
    monkeypatch.delenv("KC_DELTA_WINDOW", raising=False)
    nodes, bound = workloads.build_cluster(60, 50, 5, 0.6, 3)
    solver, pods = workloads.build_inputs(700, 50, 5, device="cpu")
    js, _, _, _ = _reference_inputs([], [], [], 50)
    pair = _Pair(solver, js, pods, POLICY, nodes=nodes, bound=bound)
    pair.solve()
    reps, on_existing = {}, 0
    for tick in range(3):
        evicted, added = workloads.churn_tick(pair.ingest, tick, reps, churn_fraction=0.05)
        for uid in evicted:
            pair.jingest.remove(uid)
        for pod in added:
            pair.jingest.add(_to_jax(pod))
        pair.solve()
        assert pair.session.last_evicted["evicted"] == len(evicted)
        on_existing += pair.session.last_evicted["existing"]
    assert pair.ticks[1:] == [("delta", "delta")] * 3
    assert on_existing > 0  # the existing-node side of the free ran


def test_session_reminted_class_matches_reference(monkeypatch):
    """Every member of a class leaves and same-shape pods re-mint it at the
    end of the ingest's order: a known key, so still a repair."""
    monkeypatch.delenv("KC_DELTA_WINDOW", raising=False)
    pair = _pair()
    pair.solve()
    spread = next(uids for uids in pair.ingest.class_members().values() if len(uids) == 10)
    rep = copy.deepcopy(pair.ingest.get(spread[0]))
    for uid in spread:
        pair.remove(uid)
    for i in range(len(spread)):
        pod = copy.deepcopy(rep)
        pod.metadata.name = f"remint-{i}"
        pod.metadata.uid = new_uid()
        pair.add(pod)
    pair.solve()
    assert pair.ticks[-1] == ("delta", "delta")


def test_session_unseen_class_matches_reference(monkeypatch):
    monkeypatch.delenv("KC_DELTA_WINDOW", raising=False)
    pair = _pair()
    pair.solve()
    for pod in make_pods(2, requests={"cpu": 3}):
        pair.add(pod)
    pair.solve()
    assert pair.ticks[-1] == ("full", "class-shape")


def test_session_supply_change_matches_reference(monkeypatch):
    monkeypatch.delenv("KC_DELTA_WINDOW", raising=False)
    pair = _pair()
    pair.solve()
    pair.solver.provisioners[0].metadata.resource_version = 7
    pair.jsolver.provisioners[0].metadata.resource_version = 7
    pair.churn(random.Random(5), 0.1)
    pair.solve()
    assert pair.ticks[-1] == ("full", "supply-changed:supply")


def test_session_audit_matches_reference(monkeypatch):
    monkeypatch.delenv("KC_DELTA_WINDOW", raising=False)
    rng = random.Random(3)
    pair = _pair(dict(POLICY, audit_interval=2))
    pair.solve()
    for _ in range(5):
        pair.churn(rng, 0.08)
        pair.solve()
    assert pair.ticks[1:] == [("delta", "delta")] * 2 + [("full", "audit")] + \
        [("delta", "delta")] * 2
    assert pair.session.last_audit_drift_nodes == pair.jsession.last_audit_drift_nodes


def test_session_window_exhaustion_matches_reference(monkeypatch):
    """More new pods than the window's fresh slots can take: the repair runs
    out of room and the tick re-anchors with a full solve."""
    monkeypatch.setenv("KC_DELTA_WINDOW", "16")
    pair = _pair(window_min=16)
    pair.solve()
    for pod in make_pods(100, requests={"cpu": "500m"}):
        pair.add(pod)
    pair.solve()
    assert pair.ticks[-1] == ("full", "slots-exhausted")
    assert pair.session.aggregates()["scheduled"] == 140


# -- chip_smoke.py's mid-size churn pin ------------------------------------------


def test_mid_churn_matches_chip_smoke_pin(monkeypatch):
    """The mid-size live-cluster churn chip_smoke.py runs on the card
    (10,000 pods x 100 types into a 1,000-node cluster, 4 ticks of
    ``churn_tick``): both packages give the evictions and totals it pins,
    every tick a delta."""
    monkeypatch.delenv("KC_DELTA_WINDOW", raising=False)
    smoke = _chip_smoke()
    pin = smoke.MID_CHURN
    nodes, bound = workloads.build_cluster(smoke.MID_NODES, smoke.MID_TYPES, 5, smoke.FILL,
                                           smoke.CLUSTER_SEED)
    solver, pods = workloads.build_inputs(smoke.MID_PODS, smoke.MID_TYPES, 5, device="cpu")
    js, _, _, _ = _reference_inputs([], [], [], smoke.MID_TYPES)
    policy = dict(enabled=True, audit_interval=0, max_delta_fraction=0.5)
    pair = _Pair(solver, js, pods, policy, nodes=nodes, bound=bound)
    pair.solve(check_full=False)
    reps = {}
    evicted_ex, evicted_new = [], []
    for tick in range(pin["ticks"]):
        evicted, added = workloads.churn_tick(pair.ingest, tick, reps)
        for uid in evicted:
            pair.jingest.remove(uid)
        for pod in added:
            pair.jingest.add(_to_jax(pod))
        pair.solve(check_full=False)
        evicted_ex.append(pair.session.last_evicted["existing"])
        evicted_new.append(pair.session.last_evicted["new"])
    assert pair.ticks[1:] == [("delta", "delta")] * pin["ticks"]
    assert evicted_ex == pin["evicted_existing"] and evicted_new == pin["evicted_new"]
    assert pair.session.aggregates() == pin["aggregates"]


# -- churn_tick against the reference benchmark's loop ---------------------------


def test_churn_tick_matches_bench_churn_line(monkeypatch):
    """``churn_tick`` evicts the uids ``bench.churn_line``'s loop evicts, in
    order, tick for tick, at 5,000 pods x 100 types.  The loop runs over
    the JAX package's ingest with the solves stubbed out: only its churn is
    under test."""
    import bench
    from karpenter_core_tpu.ops import solve as jsolve_mod

    monkeypatch.delenv("KC_BENCH_CHURN_CLASSES", raising=False)
    pods = workloads.build_pods(5000)
    ingest, jingest = PodIngest(), jcolumnar.PodIngest()
    ingest.add_all(pods)
    jingest.add_all([_to_jax(p) for p in pods])
    removed = []
    real_remove = jingest.remove

    def remove(uid):
        removed[-1].append(uid)
        return real_remove(uid)

    class StubSession:
        def __init__(self, *_a, **_k):
            self.mode_counts = {}

        def solve(self, _ingest):
            removed.append([])

        def node_signature(self):
            return ()

        def aggregates(self):
            return {"scheduled": 0, "failed": 0, "nodes": 0}

    empty = SimpleNamespace(assign=np.zeros((1, 1), np.int32),
                            assign_existing=np.zeros((1, 1), np.int32))
    stub_solver = SimpleNamespace(encode=lambda _i: SimpleNamespace(classes=[]),
                                  decode=lambda *_a: None)
    monkeypatch.setattr(jinc, "IncrementalSolveSession", StubSession)
    monkeypatch.setattr(jsolve_mod, "solve", lambda _s: empty)
    monkeypatch.setattr(jingest, "remove", remove)
    line = bench.churn_line(stub_solver, jingest, churn_fraction=0.02, ticks=5)
    assert line["pods"] == 5000
    reps = {}
    for tick in range(5):
        evicted, added = workloads.churn_tick(ingest, tick, reps)
        assert evicted == removed[tick], tick
        assert len(added) == len(evicted)
        assert len(ingest) == 5000
