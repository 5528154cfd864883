"""The lane sweep with the lanes as the scan's batch axis, and the relax
family's class planes with the class as K1's and K3's, held against the
loops they replace and against the JAX package, on the CPU.

- ``ops.consolidate.run_lanes`` (K8, ``solve_core_batched`` over chunks of
  lanes, K9's inputs) with the chunk forced to 1, 3 and every lane: every
  ``LaneStack`` leaf of every lane equal to that lane's solo ``solve_core``
  (ints and bools exact, f32 bit for bit), every ``SweepOutputs`` leaf equal
  to the JAX ``run_sweep`` (``new_cost`` at rtol 1e-6), and a chunk's skip
  decisions read from the host once for the whole chunk;
- ``ops.consolidate.run_sweep`` against the reference's;
- ``relax.kernel.class_template_planes`` (one K3 and one K1 call, the class
  their batch axis) against the per-class loop of both kernels and the
  reference's ``jax.vmap(tmpl_planes)``.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from test_torch_consolidation import (
    _assert_sweeps_equal,
    _jax_sweep,
    fixture_problem,
    workload_problem,
)
from test_torch_existing import _to_jax
from test_torch_relax import FIXTURES as RELAX_FIXTURES
from test_torch_relax import _skewed_solver
import torch_history

from karpenter_core_tpu.ops import masks as jmasks
from karpenter_core_tpu.ops import solve as jsolve
from karpenter_core_tpu_torch import carry as tcarry
from karpenter_core_tpu_torch.kernels import consolidate as k89
from karpenter_core_tpu_torch.ops import chunks as tchunks
from karpenter_core_tpu_torch.ops import consolidate as tcons
from karpenter_core_tpu_torch.ops import masks as tmasks
from karpenter_core_tpu_torch.ops import solve as tsolve
from karpenter_core_tpu_torch.relax import kernel as trk
from karpenter_core_tpu_torch.solver import consolidation as tconsolidation

# both packages' slot and feature histories start empty for this module and
# are put back after it (tests/torch_history.py)
isolated_history = torch_history.isolated_history


# (problem, prefix sizes): a build_cluster cluster with every node a
# candidate, and the fixture whose two-candidate lane falls back on an
# uninitialized node
PROBLEMS = {
    "cluster": (functools.partial(workload_problem, 60, 20, 7),
                [1, 2, 3, 5, 8, 13, 21, 34, 55, 60]),
    "uninitialized": (functools.partial(fixture_problem, "uninitialized"), [1, 2]),
}


@pytest.fixture(scope="module")
def problems():
    """Each problem built once in both packages, with the JAX package's
    sweep of its sizes (computed here: its compiles would pass a test's
    retrace budget)."""
    out = {}
    for name, (build, sizes) in PROBLEMS.items():
        problem = build()
        out[name] = (problem, sizes, _jax_sweep(problem, sizes))
    return out


def _prep(problem):
    tsearch, state_nodes, bound_pods, candidates = problem.t
    return tsearch.prepare(candidates, [], state_nodes, bound_pods)[1]


def _solo_lanes(prep, sizes):
    """The per-lane oracle: K8's twin, then each lane's solo ``solve_core``
    through the twins, one lane after another."""
    lane_open, lane_count = k89.sweep_lanes_plain(
        prep.candidate_rank, prep.ex_state.open_, prep.cls.count, prep.ex_cls_count,
        torch.as_tensor(sizes, dtype=torch.int32))
    kept = []
    for s in range(len(sizes)):
        out = tsolve.solve_core(
            prep.cls._replace(count=lane_count[s]), prep.statics_arrays, tcons.SWEEP_SLOTS,
            prep.key_has_bounds, prep.ex_state._replace(open_=lane_open[s]), prep.ex_static,
            n_passes=prep.n_passes, features=prep.features, use_kernels=False)
        kept.append(tcons.lane_planes(out))
    return tcons.LaneStack(*(torch.stack(planes) for planes in zip(*kept)))


def _batched_lanes(prep, sizes, fit, monkeypatch):
    """``run_lanes`` with chunks of ``fit`` lanes: (the stack, the chunks'
    sizes, the host reads it took)."""
    monkeypatch.setattr(tchunks, "chunk_size", lambda n_cells, cell_bytes, device: fit)
    seen = []
    batched = tsolve.solve_core_batched

    def spy(*args, **kwargs):
        out = batched(*args, **kwargs)
        seen.append(int(out.failed.shape[0]))
        return out

    monkeypatch.setattr(tsolve, "solve_core_batched", spy)
    reads = tsolve.host_syncs
    stack = tcons.run_lanes(prep, sizes)
    return stack, seen, tsolve.host_syncs - reads


@pytest.mark.parametrize("chunk", [1, 3, "all"])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_batched_lanes_match_solo_lanes_and_reference(name, chunk, problems, monkeypatch):
    problem, sizes, ref = problems[name]
    prep = _prep(problem)
    reads = tsolve.host_syncs
    solo = _solo_lanes(prep, sizes)
    solo_reads = tsolve.host_syncs - reads
    fit = len(sizes) if chunk == "all" else chunk
    stack, seen, batched_reads = _batched_lanes(prep, sizes, fit, monkeypatch)
    n = len(sizes)
    assert seen == [min(fit, n - lo) for lo in range(0, n, fit)]
    for field in tcons.LaneStack._fields:
        a, b = getattr(solo, field), getattr(stack, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert torch.equal(a, b), f"{name}: LaneStack.{field}, chunks of {fit}"
    got = tcons.SweepOutputs(*tconsolidation.fetch_planes(tcons.finish_lanes(prep, stack)))
    _assert_sweeps_equal(ref, got, f"{name}, chunks of {fit}")
    # one host read a skip decision a chunk: lane by lane at 1, fewer reads
    # than the lanes' own when a chunk holds several
    if fit == 1:
        assert batched_reads == solo_reads
    elif n > 1:
        assert 0 < batched_reads < solo_reads


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_run_sweep_matches_reference(name, problems):
    """The production entry: the search's host inputs, prepared, snapped
    and swept in one call, as the reference's ``run_sweep``."""
    problem, sizes, ref = problems[name]
    tsearch, state_nodes, bound_pods, candidates = problem.t
    inputs = tsearch.sweep_inputs(candidates, [], state_nodes, bound_pods)
    out = tcons.run_sweep(*inputs, np.asarray(sizes, dtype=np.int32), device="cpu")
    got = tcons.SweepOutputs(*tconsolidation.fetch_planes(out))
    _assert_sweeps_equal(ref, got, f"{name}: run_sweep")


# -- the relax family's class planes -------------------------------------------


@functools.partial(jax.jit, static_argnames=("key_has_bounds",))
def _jax_class_planes(cls, statics_arrays, key_has_bounds):
    """The reference's ``relax_core`` planes (karpenter_core_tpu/relax/
    kernel.py:137-178): packed masks, then ``jax.vmap(tmpl_planes)``."""
    sa = jsolve.StaticArrays(*statics_arrays)
    width = sa.valid.shape[-1]
    sa = sa._replace(it=jmasks.pack_req(sa.it), tmpl=jmasks.pack_req(sa.tmpl),
                     valid=jmasks.pack_mask(sa.valid))
    cls = cls._replace(mask=jmasks.pack_mask(cls.mask))
    statics = jsolve.Statics(*sa, key_has_bounds=key_has_bounds, packed=True, mask_v=width,
                             catalog_axis=None)

    def tmpl_planes(mask, defined, negative, gt, lt, requests, tol_row):
        cls_t = jmasks.ReqTensor(mask[None], defined[None], negative[None], gt[None], lt[None])
        key_ok = jmasks.compatible(statics.tmpl, cls_t, statics.is_custom, statics.vocab_ints,
                                   v=statics.mask_v)
        merged = jmasks.add(statics.tmpl, cls_t, statics.valid, statics.vocab_ints,
                            v=statics.mask_v, key_has_bounds=statics.key_has_bounds)
        it_int = jsolve._it_intersects(merged, statics)
        per_pod = jsolve._capacity(statics.tmpl_daemon, requests, statics)
        return key_ok & tol_row, merged, it_int, per_pod

    return jax.vmap(tmpl_planes)(cls.mask, cls.defined, cls.negative, cls.gt, cls.lt,
                                 cls.requests, cls.tol)


def _per_class_planes(cls, statics):
    """The loop the class axis replaces: K3's and K1's twins once a class."""
    n_tmpl, n_zones = statics.tmpl_zone.shape
    n_it = statics.it_alloc.shape[0]
    n_ct = statics.tmpl_ct.shape[-1]
    ones = dict(dtype=torch.bool)
    merged_rows, compat, it_int, per_pod = [], [], [], []
    for c in range(cls.count.shape[0]):
        row = tmasks.ReqTensor(*(t[c:c + 1] for t in (cls.mask, cls.defined, cls.negative,
                                                       cls.gt, cls.lt)))
        merged_c, compat_c = statics.k.merge_compat(
            statics.tmpl, row, statics.valid, statics.vocab_ints, statics.is_custom,
            statics.mask_v, statics.key_has_bounds)
        it_ok, cap_ni, _ = statics.k.it_capacity(
            torch.ones((n_tmpl, n_it), **ones), torch.ones(n_it, **ones), merged_c, statics.it,
            statics.vocab_ints, statics.mask_v, statics.key_has_bounds,
            torch.ones((n_tmpl, n_zones), **ones), torch.ones((n_tmpl, n_ct), **ones),
            torch.ones((n_it, n_zones, n_ct), **ones), statics.tmpl_daemon, cls.requests[c],
            statics.it_alloc)
        merged_rows.append(merged_c)
        compat.append(compat_c)
        it_int.append(it_ok)
        per_pod.append(cap_ni)
    merged = tmasks.ReqTensor(*(torch.stack(f) for f in zip(*merged_rows)))
    return merged, torch.stack(compat) & cls.tol, torch.stack(it_int), torch.stack(per_pod)


def _flat(planes):
    """The planes as numpy, the packed mask words as int32 (the reference
    packs them as uint32: the same bits)."""
    merged, key_ok, it_int, per_pod = planes
    flat = [np.asarray(x) for x in (*merged, key_ok, it_int, per_pod)]
    return [x.view(np.int32) if x.dtype == np.uint32 else x for x in flat]


@pytest.fixture(scope="module")
def relax_planes():
    """Per fixture: the port's inputs and the reference's planes (computed
    here: one compile a shape)."""
    out = {}
    for name in ("mixed-sizes", "fuzz-0", "fuzz-1"):
        js = _skewed_solver()
        prep = js.prepare_encoded(js.encode([_to_jax(p) for p in RELAX_FIXTURES[name]()]))
        cls, sa = jax.device_get((prep.cls, prep.statics_arrays))
        ref = jax.device_get(_jax_class_planes(cls, sa, tuple(prep.key_has_bounds)))
        out[name] = (tcarry.tensors_from_numpy(cls, sa, prep.key_has_bounds, device="cpu"),
                     (ref[1], ref[0], ref[2], ref[3]))
    return out


@pytest.mark.parametrize("name", ["mixed-sizes", "fuzz-0", "fuzz-1"])
def test_class_planes_match_per_class_loop_and_reference(name, relax_planes):
    (cls, sa, khb), ref = relax_planes[name]
    packed = trk.packed_statics(cls, sa, khb, use_kernels=False)
    got = trk.class_template_planes(*packed)
    loop = _per_class_planes(*packed)
    assert len(got[0]) == 5 and got[1].shape == got[2].shape[:2] == (cls.count.shape[0],
                                                                       sa.tmpl_zone.shape[0])
    for label, want in (("the per-class loop", _flat(loop)), ("the reference", _flat(ref))):
        for i, (a, b) in enumerate(zip(_flat(got), want)):
            assert a.dtype == b.dtype and a.shape == b.shape, f"{name}: leaf {i} vs {label}"
            np.testing.assert_array_equal(a, b, err_msg=f"{name}: leaf {i} vs {label}")
