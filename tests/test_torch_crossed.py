"""The port's crossed consolidation study held against the JAX package's, on the CPU.

``crossed_consolidation_study`` (karpenter_core_tpu/parallel/mesh.py:624)
solves every (interruption replica, consolidation prefix) cell.  On the same
numpy inputs (the JAX package's encode of one consolidation problem, as
``TPUConsolidationSearch`` sets it up) the port's study must return the
reference's ``failed`` and ``n_new`` grids and safe prefixes exactly, at
the reference's (4, 2) and (2, 2) meshes, 7 replicas and 5 prefixes (the
reference pads both to mesh multiples; the port does not pad):

- tests/test_parallel.py's cluster with no existing node;
- a ``workloads.build_cluster`` cluster whose nodes are all candidates, at
  interruption rates 0 and 0.3, and the same cluster with its on-demand
  offerings withdrawn (new nodes are spot only, so interruptions strand
  pods) at rates 0.3 and 0.9.

At rate 0 every row equals the port's serial sweep (``ops.consolidate
.sweep``) of the same sizes; ``crossed_sweep`` on the port's own
``CudaConsolidationSearch.prepare`` gives the same grid in chunks of
several sizes.  The reference's answers are computed once per
module (past the per-test retrace budget otherwise).
"""

import copy

import numpy as np
import pytest
import torch
from test_torch_consolidation import sweep_inputs, workload_problem
from test_torch_montecarlo import chunk_spy
import torch_history

import karpenter_core_tpu.cloudprovider.fake as jfake
import karpenter_core_tpu.testing as jtesting
from karpenter_core_tpu.ops import solve as jsolve
from karpenter_core_tpu.parallel import mesh as jmesh
from karpenter_core_tpu.solver.tpu import TPUSolver
from karpenter_core_tpu_torch.ops import chunks as tchunks
from karpenter_core_tpu_torch.ops import consolidate as tcons
from karpenter_core_tpu_torch.parallel import mesh as tmesh
from karpenter_core_tpu_torch.solver import consolidation as tconsolidation

# both packages' slot and feature histories start empty for this module and
# are put back after it (tests/torch_history.py)
isolated_history = torch_history.isolated_history


N_REPLICAS = 7
CLUSTER_SIZES = np.array([5, 10, 20, 30, 40], dtype=np.int32)
SIZES = {"empty": np.arange(1, 6, dtype=np.int32), "cluster": CLUSTER_SIZES,
         "spot": CLUSTER_SIZES}
# (problem, mesh shape, seed, rate)
CASES = {
    "empty-4x2-rate0": ("empty", (4, 2), 0, 0.0),
    "cluster-4x2-rate0.3": ("cluster", (4, 2), 0, 0.3),
    "cluster-2x2-rate0": ("cluster", (2, 2), 3, 0.0),
    "spot-4x2-rate0.3": ("spot", (4, 2), 1, 0.3),
    "spot-2x2-rate0.9-seed7": ("spot", (2, 2), 7, 0.9),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _empty_inputs():
    """tests/test_parallel.py TestCrossedStudy: 24 pods on 6 types and one
    closed dummy existing node."""
    solver = TPUSolver(jfake.FakeCloudProvider(jfake.instance_types(6)),
                       [jtesting.make_provisioner()])
    snapshot = solver.encode(jtesting.make_pods(24, requests={"cpu": "500m"}))
    n_classes = len(snapshot.classes)
    ex_state = jsolve.empty_existing_state(
        len(snapshot.resources), snapshot.vocab.n_keys, snapshot.vocab.width,
        len(snapshot.zones), len(snapshot.capacity_types))
    ex_static = jsolve.empty_existing_static(len(snapshot.resources), n_classes,
                                             len(snapshot.groups) + 1)
    return (snapshot, ex_state, ex_static, np.full(1, 1 << 30, dtype=np.int32),
            np.zeros((n_classes, 1), dtype=np.int32))


@pytest.fixture(scope="module")
def problems():
    problem = workload_problem(40, 20, 7)
    inputs = sweep_inputs(problem)
    spot = copy.copy(inputs[0])
    is_spot = np.array([ct == "spot" for ct in spot.capacity_types])
    spot.it_avail = spot.it_avail & is_spot[None, None, :]
    return {"empty": (_empty_inputs(), None), "cluster": (inputs, problem),
            "spot": ((spot,) + inputs[1:], None)}


@pytest.fixture(scope="module")
def reference(problems):
    out = {}
    for name, (prob, shape, seed, rate) in CASES.items():
        inputs = problems[prob][0]
        out[name] = jmesh.crossed_consolidation_study(
            *inputs, SIZES[prob], N_REPLICAS, mesh=jmesh.default_mesh_2d(shape), seed=seed,
            interruption_rate=rate)
    return out


def _assert_grid_equal(got, want, label):
    assert set(got) == set(want), label
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, f"{label}: {key}"
            np.testing.assert_array_equal(g, w, err_msg=f"{label}: {key}")
        else:
            assert type(g) is type(w) and g == w, f"{label}: {key} {g!r} vs {w!r}"


@pytest.mark.parametrize("case", list(CASES))
def test_crossed_study_matches_jax(case, problems, reference):
    prob, _, seed, rate = CASES[case]
    got = tmesh.crossed_consolidation_study(*problems[prob][0], SIZES[prob], N_REPLICAS,
                                            device="cpu", seed=seed, interruption_rate=rate)
    _assert_grid_equal(got, reference[case], case)
    assert got["failed"].shape == (N_REPLICAS, len(SIZES[prob]))


def test_cluster_cases_see_candidates_and_interruptions(reference):
    """The cluster's prefixes displace pods onto new nodes, and on the
    spot-only catalog the storm fails cells the calm run places and shrinks
    the safe prefix."""
    calm = reference["cluster-2x2-rate0"]
    mild, storm = reference["spot-4x2-rate0.3"], reference["spot-2x2-rate0.9-seed7"]
    assert calm["n_new"].max() > 0
    assert (storm["failed"] >= calm["failed"]).all()
    assert storm["failed"].sum() > mild["failed"].sum() > calm["failed"].sum()
    assert storm["safe_prefix_all"] < calm["safe_prefix_all"]


def test_rate_zero_rows_match_the_serial_sweep(problems, reference):
    """Every row at rate 0 equals the port's serial sweep of the same sizes
    (the reference's test_rate_zero_row_matches_1d_sweep, with candidates)."""
    problem = problems["cluster"][1]
    tsearch, nodes, bound, cands = problem.t
    _, prep = tsearch.prepare(cands, [], nodes, bound)
    sweep = tcons.SweepOutputs(*tconsolidation.fetch_planes(tcons.sweep(prep,
                                                                        SIZES["cluster"])))
    grid = reference["cluster-2x2-rate0"]
    for r in range(N_REPLICAS):
        np.testing.assert_array_equal(grid["failed"][r], sweep.failed)
        np.testing.assert_array_equal(grid["n_new"][r], sweep.n_new)


@pytest.mark.parametrize("fit,chunks", [(4, [4] * 8 + [3]), (16, [12, 12, 11]), (35, [35])])
def test_crossed_sweep_on_the_search_prep(fit, chunks, problems, reference, monkeypatch):
    """``crossed_sweep`` on the port's own ``CudaConsolidationSearch.prepare``
    (the path chip_smoke.py phase 9 takes), in chunks of 4, 12 or all 35
    cells, gives the reference's grid."""
    monkeypatch.setattr(tchunks, "CPU_CHUNK", fit)
    sizes = chunk_spy(monkeypatch)
    problem = problems["cluster"][1]
    tsearch, nodes, bound, cands = problem.t
    snapshot, prep = tsearch.prepare(cands, [], nodes, bound)
    _, _, seed, rate = CASES["cluster-4x2-rate0.3"]
    avail = tmesh.perturb_spot_availability(snapshot, N_REPLICAS, seed, rate, device="cpu")
    failed, n_new = tmesh.crossed_sweep(prep, avail, SIZES["cluster"])
    want = reference["cluster-4x2-rate0.3"]
    np.testing.assert_array_equal(failed.numpy(), want["failed"])
    np.testing.assert_array_equal(n_new.numpy(), want["n_new"])
    assert sizes == chunks
