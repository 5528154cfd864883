"""The port's cache-key hysteresis and batch-occupancy ledger
(``karpenter_core_tpu_torch/utils/compilecache.py``) held against the JAX
package's on the same call sequences, each package from an empty history.

- ``snap_slots`` over sequences of estimates and ``max_waste`` values;
- ``snap_features``: tests/test_compilecache.py's cases (500 seeded random
  sets under the variant cap, a subset after its superset, the implied
  flags, None) answer for answer;
- ``estimate_slots`` snapped over a sequence of encoded snapshots;
- ``record_batch_occupancy`` / ``occupancy_stats``: the cases of
  tests/test_metrics_cardinality.py, and a coalesced dispatch of the tenant
  plane (``BatchCoalescer._run_batched``) in each package;
- ``reset_memo`` clears both histories;
- ``tests/torch_history.py``: a port module leaves the JAX package's sets
  as it found them.
"""

import random

import jax
import pytest
import torch
from test_torch_existing import _to_jax
from test_torch_relax_solve import _solvers
import torch_history
from torch_history import HISTORY, fresh_history

import karpenter_core_tpu.service.tenant as jtenant
from karpenter_core_tpu.ops import solve as jsolve
from karpenter_core_tpu.utils import compilecache as jcc
from karpenter_core_tpu_torch.ops import solve as tsolve
from karpenter_core_tpu_torch.service import tenant as ttenant
from karpenter_core_tpu_torch.testing import make_pod
from karpenter_core_tpu_torch.utils import compilecache as tcc

# both packages' slot and feature histories start empty for this module and
# are put back after it (tests/torch_history.py)
isolated_history = torch_history.isolated_history


PACKAGES = ((jcc, jsolve), (tcc, tsolve))


@pytest.fixture
def empty_history():
    """Both packages' slot and feature histories empty for the test (each
    from an empty history, as in a fresh process)."""
    with fresh_history():
        yield


@pytest.fixture
def empty_ledger(monkeypatch):
    for cc in (jcc, tcc):
        monkeypatch.setattr(cc, "_occupancy", {})


SLOT_SEQUENCES = [
    ([64, 128, 100, 16, 300, 1024, 257, 2048, 600, 512, 4096, 5000, 64, 17], 4),
    ([2048, 512, 1024, 256, 8192, 2049, 16, 32, 48, 8191], 4),
    ([128, 256, 64, 511, 1000, 1024, 100], 2),
    ([16, 16, 16, 15, 65, 64, 1], 1),
]


@pytest.mark.parametrize("estimates,max_waste", SLOT_SEQUENCES)
def test_snap_slots_matches_reference(estimates, max_waste, empty_history):
    got = [tcc.snap_slots(e, max_waste=max_waste) for e in estimates]
    want = [jcc.snap_slots(e, max_waste=max_waste) for e in estimates]
    assert got == want
    assert tcc._slots_seen == jcc._slots_seen


def _both(fn):
    """``fn(compilecache, solve)`` in each package: (reference, port)."""
    return tuple(fn(cc, solve) for cc, solve in PACKAGES)


def test_snap_features_variant_space_matches_reference(empty_history):
    """500 seeded random flag sets: the same snapped set for each, the cap
    and the widening held in both."""
    rng = random.Random(0)
    requests = [[rng.random() < 0.5 for _ in range(len(tsolve.ALL_FEATURES))]
                for _ in range(500)]
    ref, got = _both(lambda cc, solve: [tuple(cc.snap_features(solve.SnapshotFeatures(*bits)))
                                        for bits in requests])
    assert got == ref
    assert len(set(got)) <= tcc.MAX_FEATURE_VARIANTS + 1
    for bits, snapped in zip(requests, got):
        assert tsolve.SnapshotFeatures(*snapped).covers(tsolve.SnapshotFeatures(*bits).canonical())
    assert {tuple(f) for f in tcc._features_seen} == {tuple(f) for f in jcc._features_seen}


def test_snap_features_cases_match_reference(empty_history):
    """A subset after its superset lands on the superset; equivalent
    requests (the implied flags) share one set; None is all-on."""
    def cases(cc, solve):
        out = [cc.snap_features(None), cc.snap_features(solve.ALL_FEATURES)]
        none = solve.SnapshotFeatures(*(False,) * len(solve.ALL_FEATURES))
        out.append(cc.snap_features(none._replace(zone_spread=True)))
        cc.reset_memo()
        f = none._replace(required_zone_anti=True)
        out += [cc.snap_features(f), cc.snap_features(f._replace(zone_anti=True,
                                                                 inv_zone_anti=True))]
        out.append(cc.snap_features(none._replace(host_ports=True)))
        out.append(cc.snap_features(none))
        return [tuple(x) for x in out]

    ref, got = _both(cases)
    assert got == ref
    assert got[2] == tuple(tsolve.ALL_FEATURES) and got[3] == got[4]


def test_reset_memo_clears_both_histories(empty_history):
    tcc.snap_slots(64)
    tcc.snap_features(tsolve.ALL_FEATURES)
    tcc.reset_memo()
    assert tcc._slots_seen == set() and tcc._features_seen == set()
    assert tcc.snap_slots(48) == 48


def test_estimate_slots_snaps_as_the_reference_does(empty_history):
    """The same snapshots in the same order: the same snapped slot counts
    (a 512-slot batch makes the later 100- to 512-slot estimates 512)."""
    ts, js = _solvers(policy=False)
    got, want = [], []
    for n in (40, 700, 90, 200, 1500, 300, 40):
        pods = [make_pod(requests={"cpu": "500m"}) for _ in range(n)]
        got.append(tsolve.estimate_slots(ts.encode(pods)))
        want.append(jsolve.estimate_slots(js.encode([_to_jax(p) for p in pods])))
    assert got == want
    assert tcc._slots_seen == jcc._slots_seen


def test_occupancy_ledger_matches_reference(empty_ledger):
    """tests/test_metrics_cardinality.py's dispatches, in both packages."""
    def ledger(cc, _solve):
        cc.record_batch_occupancy(12, 16, n_slots=4)
        cc.record_batch_occupancy(8, 16, n_slots=4)
        cc.record_batch_occupancy(3, 16, n_slots=4, mesh_axes=("data", 2))
        cc.record_batch_occupancy(10.0, 16, n_slots=2, tenants=3)
        cc.record_batch_occupancy(8, 32, n_slots=1, n_passes=3)
        cc.record_batch_occupancy(40, 32, n_slots=1)
        stats = cc.occupancy_stats()
        cc.reset_occupancy()
        return stats, cc.occupancy_stats()

    ref, got = _both(ledger)
    assert got == ref
    assert set(got[0]) == {"16|none", "16|('data', 2)", "32|none"} and got[1] == {}


def test_coalesced_dispatch_records_occupancy_as_the_reference(empty_ledger, empty_history):
    """One coalesced dispatch of three tenants of one bucket in each
    package's tenant plane: one ledger entry, the same rows."""
    ts, js = _solvers(policy=False)
    pods = [[make_pod(requests={"cpu": "500m"}) for _ in range(n)] for n in (60, 56, 52)]
    jpreps = [js.prepare_encoded(js.encode([_to_jax(p) for p in ps]), n_slots=32) for ps in pods]
    jax.device_get(jtenant.BatchCoalescer._run_batched(jpreps))
    tpreps = [ts.prepare_encoded(ts.encode(ps), n_slots=32) for ps in pods]
    ttenant.BatchCoalescer._run_batched(tpreps)
    got, want = tcc.occupancy_stats(), jcc.occupancy_stats()
    assert got == want
    assert [cell["dispatches"] for cell in got.values()] == [1]


@pytest.mark.parametrize("n_pods", [7, 60])
def test_prep_counts_its_pod_rows_on_the_host(n_pods, empty_history):
    """``SolvePrep.real_rows``, the rows a coalesced dispatch's ledger entry
    averages, is counted on the host before the upload: the prep's class
    rows that carry pods, the padded rows left out."""
    ts, _ = _solvers(policy=False)
    pods = [make_pod(requests={"cpu": f"{100 * (i % 3 + 1)}m"}) for i in range(n_pods)]
    prep = ts.prepare_encoded(ts.encode(pods), n_slots=32)
    assert prep.real_rows == int(torch.count_nonzero(prep.cls.count)) == 3
    assert prep.cls.count.shape[0] > prep.real_rows


def test_port_module_leaves_reference_history_as_it_found_it():
    """What every port module's ``isolated_history`` does: inside, both
    packages start from empty sets and a solve's estimate and features
    land there; afterwards the JAX package's (and the port's) sets are the
    ones from before, unchanged."""
    before = {(cc, name): getattr(cc, name) for cc in (jcc, tcc) for name in HISTORY}
    saved = {key: set(value) for key, value in before.items()}
    jcc._slots_seen.add(333)  # a count an earlier reference module left
    saved[(jcc, "_slots_seen")].add(333)
    with fresh_history():
        assert all(getattr(cc, name) == set() for cc in (jcc, tcc) for name in HISTORY)
        ts, js = _solvers(policy=False)
        pods = [make_pod(requests={"cpu": "500m"}) for _ in range(300)]
        tsnap, jsnap = ts.encode(pods), js.encode([_to_jax(p) for p in pods])
        assert tsolve.estimate_slots(tsnap) == jsolve.estimate_slots(jsnap)
        tcc.snap_features(tsolve.snapshot_features(tsnap))
        jcc.snap_features(jsolve.snapshot_features(jsnap))
        assert tcc._slots_seen == jcc._slots_seen != set()
        assert tcc._features_seen and jcc._features_seen
    for (cc, name), value in before.items():
        assert getattr(cc, name) is value
        assert value == saved[(cc, name)]
    jcc._slots_seen.discard(333)
