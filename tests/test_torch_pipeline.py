"""The port's pipelined tick held against the JAX package's, on the CPU.

- K21's and K22's twins (``ops.solve.repair_free_donated`` /
  ``scatter_repair_window_donated``) against the reference's donated
  programs on seeded numpy carries (N = 256, windows of 1, 7 and 64 slots),
  and against the out-of-place twins on a clone: ints and bools exact, f32
  bit for bit, the carry's own tensors returned;
- a deferred churn fuzz: the port's ``solve(deferred=True)`` tick for tick
  against its own serial loop and the JAX session's ``deferred=True`` on
  the same uids (every tick's placement record, mode counts, signature);
- the session's contracts: ``KC_PIPELINE=0`` settling inline, a window
  exhaustion escalating as the JAX package does, a deferred tick then
  serial ticks, a decode failure cached on its handle, late consumption,
  a dispatch fault mid-pipeline, a decode fault after donation, the
  ``SolvePipeline`` ring;
- the primitives: the staging ring's reuse and growth, the depth from the
  environment, the donation ledger; ``watchdog.deadline_for`` against the
  JAX watchdog's on one observation sequence, ``watchdog.run``, and a
  ``SolveTimeout`` re-anchor through a stalled barrier.

Small fleets only.
"""

import copy
import random
import time

import jax
import numpy as np
import pytest
import torch
from test_torch_existing import _np, _to_jax
import torch_history

import karpenter_core_tpu.cloudprovider.fake as jfake
import karpenter_core_tpu.models.columnar as jcolumnar
import karpenter_core_tpu.testing as jtesting
from karpenter_core_tpu.ops import solve as jsolve
from karpenter_core_tpu.solver import incremental as jinc
from karpenter_core_tpu.solver.tpu import TPUSolver
from karpenter_core_tpu.utils import pipeline as jpipe
from karpenter_core_tpu.utils import watchdog as jwatchdog
from karpenter_core_tpu_torch import carry as tcarry
from karpenter_core_tpu_torch.cloudprovider import fake as tfake
from karpenter_core_tpu_torch.models.columnar import PodIngest
from karpenter_core_tpu_torch.ops import solve as tsolve
from karpenter_core_tpu_torch.solver import incremental as tinc
from karpenter_core_tpu_torch.solver.cuda import CudaSolver
from karpenter_core_tpu_torch.testing import make_pods, make_provisioner
from karpenter_core_tpu_torch.utils import pipeline as tpipe
from karpenter_core_tpu_torch.utils import watchdog as twatchdog

# both packages' slot and feature histories start empty for this module and
# are put back after it (tests/torch_history.py)
isolated_history = torch_history.isolated_history


CPU = torch.device("cpu")
POLICY = dict(enabled=True, audit_interval=0, max_delta_fraction=0.9)


@pytest.fixture(scope="module", autouse=True)
def _module_environment(tmp_path_factory):
    """The reference memoizes a compiled solve only once its export cache
    could write it, so it gets a directory of its own; its dispatch
    watchdog is off (``KC_WATCHDOG=0``: a loaded CPU can stretch a first
    compile past its production deadline), which turns the port's off too
    until a test turns it on.  One torch thread: the planes are small."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KC_TPU_COMPILE_CACHE", str(tmp_path_factory.mktemp("kc_compile_cache")))
        mp.setenv("KC_WATCHDOG", "0")
        mp.delenv("KC_PIPELINE", raising=False)
        mp.delenv("KC_DELTA_WINDOW", raising=False)
        yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_ledgers():
    tpipe.reset_stats()
    twatchdog.reset_stats()
    yield
    twatchdog.reset_stats()


# -- K21 and K22 against the reference's donated programs --------------------------

N, E, R, K, W, Z, CT, I_, P, D, G1, C, T = 256, 5, 3, 4, 2, 3, 2, 40, 2, 1, 6, 7, 5


def _plane(rng, shape, dtype):
    if dtype == np.float32:
        return (rng.random(shape) * 8).astype(np.float32)
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    if dtype == np.uint32:
        return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    return rng.integers(0, 6, size=shape).astype(np.int32)


_NODE = {"used": ((R,), np.float32), "kmask": ((K, W), np.uint32), "kdef": ((K,), np.bool_),
         "kneg": ((K,), np.bool_), "kgt": ((K,), np.float32), "klt": ((K,), np.float32),
         "zone": ((Z,), np.bool_), "ct": ((CT,), np.bool_), "viable": ((I_,), np.bool_),
         "ports": ((P,), np.bool_), "pod_count": ((), np.int32), "tmpl_id": ((), np.int32),
         "open_": ((), np.bool_), "vol_used": ((D,), np.int32)}


def _numpy_carry(rng, n: int):
    """A reference WarmCarry of seeded numpy planes over ``n`` slots."""
    state = jsolve.NodeState(**{
        f: (np.int32(rng.integers(0, n)) if f == "n_next"
            else _plane(rng, (n,) + _NODE[f][0], _NODE[f][1]))
        for f in jsolve.NodeState._fields})
    ex = jsolve.ExistingState(**{f: _plane(rng, (E,) + _NODE[f][0], _NODE[f][1])
                                 for f in jsolve.ExistingState._fields})
    topo = jsolve.TopoCounts(fwd_ex=_plane(rng, (G1, E), np.int32),
                             inv_ex=_plane(rng, (G1, E), np.int32),
                             fwd_new=_plane(rng, (G1, n), np.int32),
                             inv_new=_plane(rng, (G1, n), np.int32))
    return jsolve.WarmCarry(state=state, ex_state=ex, topo=topo,
                            remaining=_plane(rng, (T, R), np.float32))


def _leaves(wc) -> dict:
    out = {"remaining": _np(wc.remaining)}
    for group in ("state", "ex_state", "topo"):
        tup = getattr(wc, group)
        for f in tup._fields:
            out[f"{group}.{f}"] = np.array(_np(getattr(tup, f)))
    return out


def _assert_same(ref, got, label):
    a, b = (x if isinstance(x, dict) else _leaves(x) for x in (ref, got))
    assert a.keys() == b.keys(), label
    for k in a:
        assert a[k].dtype == b[k].dtype, f"{label}: {k}"
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{label}: {k}")


def _t(a) -> torch.Tensor:
    return tcarry.to_tensor(np.asarray(a), CPU)


def _tensors(wc):
    return [t for group in (wc.state, wc.ex_state, wc.topo) for t in group] + [wc.remaining]


def test_repair_free_donated_matches_reference():
    """K21's twin: the reference's donated free, bit for bit (f32 ``used``
    with full-mantissa requests, pod counts and topology counts clamped at
    0), written into the carry's own tensors, equal to K10's twin on a
    clone."""
    rng = np.random.default_rng(21)
    jcarry = _numpy_carry(rng, N)
    free_new = np.where(rng.random((C, N)) < 0.3, rng.integers(0, 4, (C, N)), 0).astype(np.int32)
    free_ex = rng.integers(0, 3, (C, E)).astype(np.int32)
    req = (rng.random((C, R)) * 3).astype(np.float32)
    member = rng.integers(0, 2, (C, G1)).astype(np.int32)
    own_inv = rng.integers(0, 2, (C, G1)).astype(np.int32)
    # every consumer gets planes of its own: a donated or in-place update
    # writes into whatever memory its input shares with numpy
    ref = _leaves(jax.device_get(jsolve.repair_free_donated(
        jax.device_put(copy.deepcopy(jcarry)), free_new, free_ex, req, member, own_inv)))
    carry = tcarry.warm_carry_from_numpy(copy.deepcopy(jcarry), CPU)
    clone = tinc._cloned(carry)
    args = (_t(free_new), _t(free_ex), _t(req), _t(member), _t(own_inv))
    got = tsolve.repair_free_donated(carry, *args)
    _assert_same(ref, got, "repair_free_donated")
    assert all(a is b for a, b in zip(_tensors(got), _tensors(carry)))
    _assert_same(tsolve.repair_free(clone, *args), got, "against K10's twin on a clone")
    assert (ref["state.pod_count"] == 0).any()  # the clamp ran
    assert (ref["state.used"] != jcarry.state.used).any()


@pytest.mark.parametrize("width", (1, 7, 64))
def test_scatter_repair_window_donated_matches_reference(width):
    """K22's twin: the reference's donated scatter, bit for bit, the window
    written into the full-width carry's own planes (``n_next`` too), its
    existing-node state and budget the window carry's tensors; equal to
    K12's twin on a clone."""
    rng = np.random.default_rng(22 + width)
    jfull, jwin = _numpy_carry(rng, N), _numpy_carry(rng, width)
    idx = np.sort(rng.choice(N, size=width, replace=False)).astype(np.int32)
    rng.shuffle(idx)
    n_open = int(rng.integers(0, width + 1))
    ref = _leaves(jax.device_get(jsolve.scatter_repair_window_donated(
        jax.device_put(copy.deepcopy(jfull)), copy.deepcopy(jwin), idx, np.int32(n_open))))
    full = tcarry.warm_carry_from_numpy(copy.deepcopy(jfull), CPU)
    win = tcarry.warm_carry_from_numpy(copy.deepcopy(jwin), CPU)
    clone = tinc._cloned(full)
    got = tsolve.scatter_repair_window_donated(full, win, _t(idx), n_open)
    _assert_same(ref, got, f"scatter_repair_window_donated S={width}")
    assert all(getattr(got.state, f) is getattr(full.state, f) for f in tsolve.NodeState._fields)
    assert got.topo.fwd_new is full.topo.fwd_new and got.topo.inv_new is full.topo.inv_new
    assert got.ex_state is win.ex_state and got.remaining is win.remaining
    _assert_same(tsolve.scatter_repair_window(clone, win, _t(idx), n_open), got,
                 "against K12's twin on a clone")
    assert (ref["state.viable"] != jfull.state.viable).any()


def test_inplace_wrappers_refuse_shared_planes():
    """An in-place update of two planes that share storage would write one
    twice: the wrappers refuse it."""
    carry = tcarry.warm_carry_from_numpy(_numpy_carry(np.random.default_rng(3), 16), CPU)
    topo = carry.topo._replace(inv_new=carry.topo.fwd_new)
    z = torch.zeros((C, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="shares storage"):
        tsolve.repair_free_donated(carry._replace(topo=topo), z, torch.zeros((C, E),
                                   dtype=torch.int32), torch.zeros((C, R)),
                                   torch.zeros((C, G1), dtype=torch.int32),
                                   torch.zeros((C, G1), dtype=torch.int32))


# -- sessions ----------------------------------------------------------------------


def _population(n: int, prefix: str = "uid-base"):
    """The reference tests' population with deterministic uids."""
    pods = make_pods(n // 2, requests={"cpu": "500m"})
    pods += make_pods(n // 4, requests={"cpu": 1})
    pods += make_pods(n - len(pods), requests={"cpu": "250m"})
    for i, p in enumerate(pods):
        p.metadata.uid = f"{prefix}-{i}"
    return pods


def _solver():
    return CudaSolver(tfake.FakeCloudProvider(), [make_provisioner(name="prov-0")], device="cpu")


def _jsolver():
    return TPUSolver(jfake.FakeCloudProvider(), [jtesting.make_provisioner(name="prov-0")])


def _session(solver=None, policy=POLICY, window_min=None):
    return tinc.IncrementalSolveSession(solver or _solver(), tinc.FallbackPolicy(**policy),
                                        window_min=window_min)


def _ingest(pods):
    ingest = PodIngest()
    ingest.add_all(pods)
    return ingest


def _churn(ingests, rng, tick: int, fraction: float = 0.1):
    """The reference tests' ``_churn`` (deterministic uids) on every ingest
    given: the first ingest's sorted uids pick the victims; the others are
    the same population in either package."""
    uids = sorted(u for us in ingests[0].class_members().values() for u in us)
    picks = {int(rng.random() * len(uids)) for _ in range(max(int(len(uids) * fraction), 1))}
    for i, uid in enumerate(sorted(uids[j] for j in picks)):
        rep = copy.deepcopy(ingests[0].get(uid))
        rep.metadata.name = f"churn-{tick}-{i}"
        rep.metadata.uid = f"uid-churn-{tick}-{i}"
        rep.spec.node_name = ""
        for ingest in ingests:
            ingest.remove(uid)
            ingest.add(_to_jax(rep) if isinstance(ingest, jcolumnar.PodIngest)
                       else copy.deepcopy(rep))


def _record(results) -> tuple:
    """``tests/test_pipeline.py``'s uid-level record of one tick."""
    new = tuple(sorted(tuple(sorted(p.uid for p in d.pods)) for d in results.new_nodes))
    existing = tuple(sorted((name, tuple(sorted(p.uid for p in pods)))
                            for name, pods in results.existing_assignments.items()))
    return new, existing, tuple(sorted(p.uid for p in results.failed_pods))


FUZZ_TICKS = 10


def _fuzz_loop(session, ingest, solve_deferred: bool):
    """The records of a first solve and ``FUZZ_TICKS`` ticks of 10 % churn
    (tick k's handle consumed after tick k+1's dispatch when deferred), as
    ``tests/test_pipeline.py``'s ``_run_loop`` drives them."""
    rng = random.Random(1729)
    handle = session.solve(ingest, deferred=solve_deferred)
    records = [_record(handle.result() if solve_deferred else handle)]
    pending = None
    for tick in range(FUZZ_TICKS):
        _churn([ingest], rng, tick)
        if solve_deferred:
            h = session.solve(ingest, deferred=True)
            if pending is not None:
                records.append(_record(pending.result()))
            pending = h
        else:
            records.append(_record(session.solve(ingest)))
    if pending is not None:
        records.append(_record(pending.result()))
    return records


@pytest.fixture(scope="module")
def reference_runs():
    """The JAX session's deferred churn fuzz and deferred window exhaustion,
    run once: their compiles would pass a test's retrace budget.  They run
    on an empty slot-count and feature-set history, as a fresh process
    does, and leave the module's as it was."""
    with torch_history.fresh_history():
        jingest = jcolumnar.PodIngest()
        jingest.add_all([_to_jax(p) for p in _population(48)])
        jsession = jinc.IncrementalSolveSession(_jsolver(), jinc.FallbackPolicy(**POLICY))
        records = _fuzz_loop(jsession, jingest, True)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("KC_DELTA_WINDOW", "4")
            exhaustion = _exhaustion_leg(True, "jax")
    return {"records": records, "modes": dict(jsession.mode_counts),
            "aggregates": jsession.aggregates(), "exhaustion": exhaustion}


def test_deferred_churn_fuzz_matches_serial_and_reference(reference_runs):
    """Ten ticks of 10 % churn: the port's deferred loop (tick k consumed
    after tick k+1's dispatch) equals its serial loop and the JAX session's
    deferred loop record for record, in modes, signature and aggregates;
    every repair donated, every ticket retired."""
    deferred, serial = _session(), _session()
    got = _fuzz_loop(deferred, _ingest(_population(48)), True)
    want = _fuzz_loop(serial, _ingest(_population(48)), False)
    assert got == want == reference_runs["records"]
    assert deferred.mode_counts == serial.mode_counts == reference_runs["modes"]
    assert deferred.mode_counts[tinc.MODE_DELTA] >= 8
    assert deferred.node_signature() == serial.node_signature()
    assert deferred.aggregates() == serial.aggregates() == reference_runs["aggregates"]
    stats = tpipe.stats()
    assert stats["donated"] == 2 * deferred.mode_counts[tinc.MODE_DELTA]  # both sessions
    assert stats["donation_reallocs"] == 0 and stats["tickets_open"] == 0


def test_kc_pipeline_off_settles_inline(monkeypatch):
    """KC_PIPELINE=0: deferred calls return settled handles, nothing
    stages, repairs keep their carry (K10 and K12)."""
    monkeypatch.setenv("KC_PIPELINE", "0")
    assert not tpipe.pipeline_enabled() and not tpipe.donation_enabled()
    session = _session()
    ingest = _ingest(_population(24))
    handle = session.solve(ingest, deferred=True)
    assert isinstance(handle, tinc.PendingResults) and handle.done()
    assert session._pending is None and session._staging is None
    ingest.add_all(make_pods(2, requests={"cpu": "500m"}))
    carry = session._warm.carry
    handle = session.solve(ingest, deferred=True)
    assert handle.done() and session.last_mode == tinc.MODE_DELTA
    assert session._warm.carry.state.used is not carry.state.used
    assert tpipe.stats()["donation_reallocs"] == 1 and tpipe.stats()["donated"] == 0


def _exhaustion_leg(pipelined: bool, package: str):
    """200 pods, then a burst of 80 known-shape pods far past a window of 4
    slots' fresh tail; a deferred leg's caller churns before consuming."""
    base = _population(200, "uid-b")
    burst = make_pods(80, requests={"cpu": "500m"})
    for i, p in enumerate(burst):
        p.metadata.uid = f"uid-burst-{i}"
    if package == "jax":
        ingest = jcolumnar.PodIngest()
        ingest.add_all([_to_jax(p) for p in base])
        session = jinc.IncrementalSolveSession(_jsolver(), jinc.FallbackPolicy(**POLICY))
        burst = [_to_jax(p) for p in burst]
    else:
        ingest = _ingest(base)
        session = _session(window_min=4)
    session.solve(ingest, deferred=pipelined)
    ingest.add_all(burst)
    h = session.solve(ingest, deferred=pipelined)
    if pipelined:
        _churn([ingest], random.Random(3), tick=99, fraction=0.05)
        record = _record(h.result())
    else:
        record = _record(h)
    return record, session.last_reason, session.aggregates()


def test_exhaustion_escalates_as_the_reference_does(reference_runs):
    """A burst past the bounded window's fresh tail: the deferred tick finds
    the exhaustion at its settle and re-anchors from the population it
    captured, though the caller's ingest moved on; reason and record equal
    the serial escalation's and the JAX package's."""
    serial = _exhaustion_leg(False, "torch")
    assert serial[1] == "slots-exhausted"
    assert _exhaustion_leg(True, "torch") == serial == reference_runs["exhaustion"]


def test_deferred_then_serial_keeps_the_handle_intact():
    """A deferred tick followed by two serial ticks, which stage into the
    shared ring and would rewrite the deferred tick's slot: the handle
    still decodes its own tick."""
    def leg(mixed: bool):
        session = _session()
        ingest = _ingest(_population(32))
        session.solve(ingest)
        rng = random.Random(17)
        _churn([ingest], rng, 0)
        if mixed:
            h = session.solve(ingest, deferred=True)
        else:
            record0 = _record(session.solve(ingest))
        for tick in (1, 2):
            _churn([ingest], rng, tick)
            session.solve(ingest)
        return _record(h.result()) if mixed else record0

    assert leg(True) == leg(False)


def test_decode_failure_is_cached_on_the_handle(monkeypatch):
    session = _session()
    ingest = _ingest(_population(24))
    session.solve(ingest)
    _churn([ingest], random.Random(19), 0)
    h = session.solve(ingest, deferred=True)
    session.settle()  # adopt; the decode waits on the handle
    monkeypatch.setattr(CudaSolver, "decode",
                        lambda self, *a, **k: (_ for _ in ()).throw(ValueError("boom")))
    for _ in range(2):
        with pytest.raises(ValueError):
            h.result()


def test_late_consumption_reads_its_own_tick():
    """Tick k's node decisions read after tick k+1 freed and scattered into
    the carry in place: their requests and types are the serial loop's."""
    def leg(deferred: bool):
        session = _session()
        ingest = _ingest(_population(32))
        session.solve(ingest)
        rng = random.Random(7)
        _churn([ingest], rng, 0)
        h0 = session.solve(ingest, deferred=deferred)
        _churn([ingest], rng, 1)
        h1 = session.solve(ingest, deferred=deferred)
        r0 = h0.result() if deferred else h0
        out = sorted((tuple(sorted(p.uid for p in d.pods)), tuple(sorted(d.requests.items())),
                      tuple(d.instance_type_names)) for d in r0.new_nodes)
        (h1.result() if deferred else h1)
        return out

    late = leg(True)
    assert late and all(reqs and names for _, reqs, names in late)
    assert late == leg(False)


def test_dispatch_fault_mid_pipeline_drains_cleanly(monkeypatch):
    """A dispatch that raises while a deferred tick is in flight: the fault
    surfaces from solve(), the in-flight handle resolves, nothing is
    pending, no ticket leaks, and the next solve re-anchors (the faulted
    dispatch had consumed its carry)."""
    session = _session()
    ingest = _ingest(_population(32))
    session.solve(ingest, deferred=True).result()
    rng = random.Random(11)
    _churn([ingest], rng, 0)
    h0 = session.solve(ingest, deferred=True)
    _churn([ingest], rng, 1)
    real = CudaSolver.run_prepared
    with monkeypatch.context() as mp:
        mp.setattr(CudaSolver, "run_prepared",
                   lambda self, *a, **k: (_ for _ in ()).throw(RuntimeError("device fault")))
        with pytest.raises(RuntimeError, match="device fault"):
            session.solve(ingest, deferred=True)
    assert CudaSolver.run_prepared is real
    assert h0.done() and _record(h0.result())
    assert session._pending is None and session._warm is None
    assert tpipe.stats()["tickets_open"] == 0
    results = session.solve(ingest, deferred=True).result()
    assert (session.last_mode, session.last_reason) == (tinc.MODE_FULL, "first")
    assert results is not None and session.aggregates()["scheduled"] == len(ingest)


def test_decode_fault_after_donation_drops_the_lineage(monkeypatch):
    """A decode that fails on a donated serial tick drops the lineage (its
    carry was freed in place); the next solve re-anchors and repairs work
    again."""
    session = _session()
    ingest = _ingest(_population(32))
    session.solve(ingest)
    rng = random.Random(13)
    _churn([ingest], rng, 0)
    with monkeypatch.context() as mp:
        mp.setattr(CudaSolver, "decode",
                   lambda self, *a, **k: (_ for _ in ()).throw(ValueError("decode exploded")))
        with pytest.raises(ValueError):
            session.solve(ingest)
    assert session._warm is None
    assert session.solve(ingest) is not None
    assert (session.last_mode, session.last_reason) == (tinc.MODE_FULL, "first")
    _churn([ingest], rng, 1)
    session.solve(ingest)
    assert session.last_mode == tinc.MODE_DELTA


def test_solve_pipeline_dispatch_fault_leaves_handles_consumable():
    class _Box:
        def __init__(self, v):
            self.v = v

        def result(self):
            return self.v

    pipe = tpipe.SolvePipeline(depth=2)
    assert pipe.submit(lambda: _Box(1)) is None
    with pytest.raises(ValueError):
        pipe.submit(lambda: (_ for _ in ()).throw(ValueError("boom")))
    assert len(pipe) == 1
    assert pipe.submit(lambda: _Box(2)) == 1
    assert pipe.drain() == [2] and len(pipe) == 0


def test_solve_pipeline_drives_the_session():
    """The tick ring over deferred ticks: its results are the serial
    loop's, in order."""
    def records(driven: bool):
        session = _session()
        ingest = _ingest(_population(24))
        rng = random.Random(23)
        pipe = tpipe.SolvePipeline()
        out = []
        for tick in range(5):
            if tick:
                _churn([ingest], rng, tick)
            if driven:
                r = pipe.submit(lambda: session.solve(ingest, deferred=True))
                if r is not None:
                    out.append(_record(r))
            else:
                out.append(_record(session.solve(ingest)))
        return out + [_record(r) for r in pipe.drain()]

    assert records(True) == records(False)


# -- the primitives ------------------------------------------------------------------


def test_staging_ring_reuses_and_grows():
    ring = tpipe.HostStagingRing(depth=2)
    a = (torch.arange(6, dtype=torch.int32), torch.ones(3), None)
    s1 = ring.take(a)
    bufs1 = [b.data_ptr() for b in s1.bufs[:2]]
    ring.take(a)
    s3 = ring.take((torch.arange(4, dtype=torch.int32), torch.ones((1, 2)), None))
    assert s3 is s1 and s3.bufs[2] is None
    assert [b.data_ptr() for b in s3.bufs[:2]] == bufs1  # smaller: the same bytes
    assert tuple(s3.bufs[1].shape) == (1, 2)
    # two first fills count nothing; the third take changes both shapes in
    # slot 0, as the reference's rebuild counts, though no byte was allocated
    assert tpipe.stats()["staging_reallocs"] == 2
    ring.take(a)  # slot 1 as it was: no drift
    assert tpipe.stats()["staging_reallocs"] == 2
    s5 = ring.take((torch.zeros(40, dtype=torch.int32), torch.ones(3), None))  # grows
    assert s5.bufs[0].data_ptr() != bufs1[0] and s5.bufs[1].data_ptr() == bufs1[1]
    assert tpipe.stats()["staging_reallocs"] == 4
    ticket = tpipe.FetchTicket((torch.tensor([3, 4], dtype=torch.int32), torch.tensor(5)),
                               ring=ring)
    assert ticket.staged and tpipe.stats()["tickets_open"] == 1
    first = ticket.wait()
    assert first is ticket.wait() and ticket.done()
    np.testing.assert_array_equal(first[0], [3, 4])
    assert int(first[1]) == 5 and tpipe.stats()["tickets_open"] == 0
    rec = tpipe.last_overlap()
    assert rec["hidden_s"] >= 0 and rec["exposed_s"] >= 0


def test_staging_ring_counts_as_the_reference():
    """One sequence of numpy-made arrays through both rings: first fills,
    repeated shapes, a window alternating 256 and 512 slots off the ring's
    period, a dtype change, None entries and a shorter tuple.  Both packages
    report the same ``staging_reallocs`` after every step."""
    rng = np.random.default_rng(12)

    def arrays(n, count_dtype=np.int32, drop=()):
        out = (rng.integers(0, 9, n).astype(count_dtype), rng.random((n, 3)).astype(np.float32),
               rng.random(n) < 0.5)
        return tuple(None if i in drop else a for i, a in enumerate(out))

    steps = [arrays(6), arrays(6), arrays(6), arrays(256), arrays(512), arrays(512),
             arrays(256), arrays(256), arrays(512), arrays(256, drop=(1,)),
             arrays(256, np.int64), arrays(256, np.int64), arrays(512, drop=(0, 2)),
             arrays(512)[:2], arrays(6)]
    jpipe.reset_stats()
    jring, tring = jpipe.HostStagingRing(depth=2), tpipe.HostStagingRing(depth=2)
    counts = []
    for step in steps:
        jring.stage(step)
        tring.take(tuple(None if a is None else torch.as_tensor(a) for a in step))
        counts.append(jpipe.stats()["staging_reallocs"])
        assert tpipe.stats()["staging_reallocs"] == counts[-1], counts
    assert counts[:3] == [0, 0, 0] and counts[-1] > 0


def test_pipeline_depth_from_env(monkeypatch):
    monkeypatch.setenv("KC_PIPELINE_DEPTH", "3")
    assert tpipe.pipeline_depth() == 3 and tpipe.HostStagingRing().depth == 3
    monkeypatch.setenv("KC_PIPELINE_DEPTH", "1")
    assert tpipe.pipeline_depth() == 2
    monkeypatch.setenv("KC_PIPELINE_DEPTH", "junk")
    assert tpipe.pipeline_depth() == 2


def test_donation_ledger(monkeypatch):
    """Pipelined repairs donate; an enabled policy and a hooked dispatch
    keep the carry; KC_PIPELINE=0 disarms donation."""
    assert tpipe.backend_supports_donation() and tpipe.donation_enabled()
    session = _session()
    ingest = _ingest(_population(32))
    session.solve(ingest, deferred=True).result()
    rng = random.Random(5)
    pending = None
    for tick in range(4):
        _churn([ingest], rng, tick)
        h = session.solve(ingest, deferred=True)
        if pending is not None:
            pending.result()
        pending = h
    pending.result()
    assert tpipe.stats()["donated"] == 4 == session.mode_counts[tinc.MODE_DELTA]
    hooked = tinc.IncrementalSolveSession(_solver(), tinc.FallbackPolicy(**POLICY),
                                          run_prepared=lambda prep, **kw:
                                          hooked.solver.run_prepared(prep, **kw))
    assert not hooked._donates()
    monkeypatch.setenv("KC_PIPELINE", "0")
    assert not session._donates() and not tpipe.donation_enabled()


def test_deadline_for_matches_reference(monkeypatch):
    """The same observation sequence gives the same deadlines in both
    watchdogs: cold budget, the first completion only marking the key, the
    EWMA, the clamps."""
    monkeypatch.setenv("KC_WATCHDOG_FLOOR_S", "0.5")
    monkeypatch.setenv("KC_WATCHDOG_CEILING_S", "30")
    monkeypatch.setenv("KC_WATCHDOG_MARGIN", "6")
    monkeypatch.setenv("KC_WATCHDOG_COLD_MULT", "4")
    jwatchdog.reset_stats()
    try:
        rng = random.Random(31)
        for step in range(40):
            key = ("decode", "adopt", None)[step % 3]
            assert twatchdog.deadline_for("pipeline.fetch", key) == \
                jwatchdog.deadline_for("pipeline.fetch", key), step
            elapsed = rng.choice((0.001, 0.05, 0.3, 2.0, 9.0))
            deadline = twatchdog.deadline_for("pipeline.fetch", key)
            twatchdog.observe("pipeline.fetch", key, elapsed, deadline)
            jwatchdog._observe("pipeline.fetch", key, elapsed, deadline)
        assert twatchdog.stats() == jwatchdog.stats()
    finally:
        jwatchdog.reset_stats()


def test_watchdog_run(monkeypatch):
    monkeypatch.setenv("KC_WATCHDOG", "1")
    assert twatchdog.run("solve.sync", lambda a, b=0: a + b, 2, b=3) == 5
    with pytest.raises(KeyError):
        twatchdog.run("solve.sync", lambda: {}["x"])
    t0 = time.perf_counter()
    with pytest.raises(twatchdog.SolveTimeout) as err:
        twatchdog.run("solve.sync", time.sleep, 2.0, deadline_s=0.05)
    assert time.perf_counter() - t0 < 1.0 and isinstance(err.value, RuntimeError)
    assert twatchdog.stats()["timeouts"] == {"solve.sync": 1}
    monkeypatch.setenv("KC_WATCHDOG", "0")
    assert twatchdog.run("solve.sync", lambda: 7, deadline_s=1e-9) == 7


def test_stalled_barrier_reanchors_with_watchdog_timeout(monkeypatch):
    """A deferred tick whose copies never land: its settle times out at the
    watchdog floor, cancels the tick (ticket invalidated, donation
    balanced) and re-anchors from the captured population with reason
    ``watchdog-timeout``, to the records of a serial full solve."""
    monkeypatch.setenv("KC_WATCHDOG", "1")
    monkeypatch.setenv("KC_WATCHDOG_FLOOR_S", "0.05")
    monkeypatch.setenv("KC_WATCHDOG_COLD_MULT", "1")
    session = _session()
    ingest = _ingest(_population(32))
    session.solve(ingest, deferred=True).result()
    _churn([ingest], random.Random(29), 0)
    tpipe.reset_stats()
    h = session.solve(ingest, deferred=True)
    stalled = session._pending.data["disp"]["ticket"]
    real = tpipe.FetchTicket._ready
    monkeypatch.setattr(tpipe.FetchTicket, "_ready",
                        lambda self: False if self is stalled else real(self))
    captured = _ingest(copy.deepcopy([ingest.get(u) for us in ingest.class_members().values()
                                      for u in us]))
    _churn([ingest], random.Random(37), 1)  # the caller moves on before the settle
    results = h.result()
    assert (session.last_mode, session.last_reason) == (tinc.MODE_FULL, "watchdog-timeout")
    full = _session(policy=dict(enabled=False))
    assert _record(results) == _record(full.solve(captured))
    assert session.node_signature() == full.node_signature()
    stats = tpipe.stats()
    assert stats["donated"] == stats["donation_canceled"] == 1
    assert stats["tickets_open"] == 0
    assert twatchdog.stats()["timeouts"] == {tpipe.FETCH_SITE: 1}
    with pytest.raises(RuntimeError, match="invalidated"):
        stalled.wait()
