"""The port's Monte-Carlo what-if studies held against the JAX package's, on the CPU.

- ``relax.prng.uniform`` against ``jax.random.uniform`` bit for bit (seeds
  0, 7 and 2**32 + 3, odd shapes, the full [1,024, 1,000, 3, 2] once);
- K19's twin (``perturb_spot_availability``, ``perturb_offering_availability``)
  against the reference's at rates 0, 0.3, 0.9 and on a risk plane with
  zeros and ones: every cell equal;
- ``kernels.fp32.tree_sum_plain`` against XLA's f32 sum of a vmapped row,
  and K20's twin against ``_monte_carlo_fn.one_replica``'s finish
  (``node_prices`` and the four sums) under ``jax.vmap``: bit for bit;
- ``monte_carlo_solve`` and ``policy_monte_carlo`` against the reference's
  on tests/test_parallel.py's and tests/test_policy.py's fixtures and on a
  catalog whose spot offerings are cheaper and some of whose pods need
  spot: every returned key equal, ints exactly, f32 ``cost`` bit for bit;
- two chunk sizes, and the port's own encode, give the same studies.

The reference's answers are computed once per module (its mesh programs
compile dozens of XLA executables, past the per-test retrace budget of
tests/conftest.py); both packages get the same ``n_slots``, since the
reference snaps its own estimate to slot counts compiled earlier in the
process.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_history

import karpenter_core_tpu.apis.labels as jlabels
import karpenter_core_tpu.apis.objects as jobj
import karpenter_core_tpu.cloudprovider.fake as jfake
import karpenter_core_tpu.testing as jtesting
import karpenter_core_tpu_torch.apis.labels as tlabels
import karpenter_core_tpu_torch.apis.objects as tobj
import karpenter_core_tpu_torch.cloudprovider.fake as tfake
import karpenter_core_tpu_torch.testing as ttesting
from karpenter_core_tpu.ops import solve as jsolve
from karpenter_core_tpu.parallel import mesh as jmesh
from karpenter_core_tpu.solver.tpu import TPUSolver
from karpenter_core_tpu_torch.kernels import fp32
from karpenter_core_tpu_torch.kernels import montecarlo as k20
from karpenter_core_tpu_torch.ops import chunks as tchunks
from karpenter_core_tpu_torch.ops import solve as tsolve
from karpenter_core_tpu_torch.parallel import mesh as tmesh
from karpenter_core_tpu_torch.relax import prng
from karpenter_core_tpu_torch.solver.cuda import CudaSolver

# both packages' slot and feature histories start empty for this module and
# are put back after it (tests/torch_history.py)
isolated_history = torch_history.isolated_history


SEEDS = (0, 7, 2**32 + 3)
RATES = (0.0, 0.3, 0.9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The planes here are small: one intra-op thread runs them as fast,
    and leaves the other cores to the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the draw ---------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (5,), (3, 7), (2, 5, 3, 2), (7, 13, 3, 2), (4, 1, 1, 3)])
def test_uniform_matches_jax(seed, shape):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    got = prng.uniform(prng.prng_key(seed), shape)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform_full_size_matches_jax():
    """The full study's draw: [1,024, 1,000, 3, 2], 6.1M cells."""
    shape = (1024, 1000, 3, 2)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), shape))
    got = prng.uniform(prng.prng_key(0), shape)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS + (2**33 + 5, 2**32 - 1))
def test_prng_key_matches_jax(seed):
    """With 64-bit types off the reference keeps only a seed's low 32 bits."""
    np.testing.assert_array_equal(np.asarray(jax.random.PRNGKey(seed)), prng.prng_key(seed))


def _avail_snapshot(rng, n_it, capacity_types=("spot", "on-demand")):
    """The two fields the perturbations read, as a snapshot."""
    avail = rng.random((n_it, 3, len(capacity_types))) < 0.8
    return types.SimpleNamespace(it_avail=avail, capacity_types=list(capacity_types))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("rate", RATES + (1.0,))
@pytest.mark.parametrize("n_rep,n_it,cts", [(16, 6, ("spot", "on-demand")),
                                            (7, 13, ("on-demand", "spot", "reserved")),
                                            (3, 1, ("spot",))])
def test_perturb_spot_matches_jax(seed, rate, n_rep, n_it, cts):
    snap = _avail_snapshot(np.random.default_rng(n_it), n_it, cts)
    want = np.asarray(jmesh.perturb_spot_availability(snap, n_rep, seed, rate))
    got = tmesh.perturb_spot_availability(snap, n_rep, seed, rate, device="cpu")
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_perturb_offering_matches_jax(seed):
    """A risk plane with zeros (never dropped), ones (always dropped) and
    draws in between, NaN among them (never dropped)."""
    rng = np.random.default_rng(11)
    snap = _avail_snapshot(rng, 17)
    risk = rng.random(snap.it_avail.shape).astype(np.float32)
    risk[rng.random(risk.shape) < 0.2] = 0.0
    risk[rng.random(risk.shape) < 0.2] = 1.0
    risk[0, 0, 0] = np.nan
    want = np.asarray(jmesh.perturb_offering_availability(snap, risk, 9, seed))
    got = tmesh.perturb_offering_availability(snap, risk, 9, seed, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[:, risk == 1.0].any()
    calm = snap.it_avail[risk == 0.0]
    np.testing.assert_array_equal(got[:, risk == 0.0].numpy(),
                                  np.broadcast_to(calm, (9,) + calm.shape))


def test_perturb_full_size_matches_jax():
    """BASELINE config 5's draw: 1,024 replicas of 1,000 types x 3 zones x 2
    capacity types, both modes."""
    rng = np.random.default_rng(3)
    snap = _avail_snapshot(rng, 1000)
    want = np.asarray(jmesh.perturb_spot_availability(snap, 1024, 0, 0.3))
    np.testing.assert_array_equal(
        tmesh.perturb_spot_availability(snap, 1024, 0, 0.3, device="cpu").numpy(), want)
    risk = (rng.random(snap.it_avail.shape) * 0.5).astype(np.float32)
    want = np.asarray(jmesh.perturb_offering_availability(snap, risk, 1024, 5))
    np.testing.assert_array_equal(
        tmesh.perturb_offering_availability(snap, risk, 1024, 5, device="cpu").numpy(), want)


# -- the replica summary -------------------------------------------------------


@pytest.mark.parametrize("n", [1, 16, 32, 33, 64, 100, 1000, 8192])
def test_tree_sum_matches_xla(n):
    rng = np.random.default_rng(n)
    x = (rng.random((5, n)) * 10.0 ** rng.integers(-3, 4, (5, n))).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.inf
    want = np.asarray(jax.jit(jax.vmap(
        lambda p: jnp.sum(jnp.where(jnp.isfinite(p), p, 0.0))))(x))
    got = fp32.tree_sum_plain(torch.where(torch.isfinite(torch.as_tensor(x)),
                                          torch.as_tensor(x), 0.0))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


class _State:
    def __init__(self, viable, zone, ct, open_, pod_count):
        self.viable, self.zone, self.ct, self.open_, self.pod_count = (
            viable, zone, ct, open_, pod_count)


@pytest.mark.parametrize("n_slots", [64, 200, 8192])
def test_replica_finish_twin_matches_reference(n_slots):
    """K20's twin against ``one_replica``'s finish (mesh.py:480-487) under
    ``jax.vmap``: all four sums bit for bit.  Above 32 slots XLA's tree
    rewrite gives the finish alone the reference program's sum order; at 32
    or fewer, the finish compiled alone fuses its sum into an 8-lane vector
    loop, which the reference program does not (its object code sums the
    slots in a scalar loop): those sizes are held in the studies below."""
    rng = np.random.default_rng(n_slots)
    n_rep, n_cls, n_it = 6, 5, 40
    viable = rng.random((n_rep, n_slots, n_it)) < 0.2
    viable[:, 1::7] = False  # no viable type: +inf, left out of the cost
    zone = rng.random((n_rep, n_slots, 3)) < 0.6
    ct = rng.random((n_rep, n_slots, 2)) < 0.6
    open_ = rng.random((n_rep, n_slots)) < 0.8
    pod_count = rng.integers(0, 3, (n_rep, n_slots)).astype(np.int32)
    price = (rng.integers(1, 5000, (n_it, 3, 2)) * 1.7e-3).astype(np.float32)
    price[rng.random(price.shape) < 0.3] = np.inf
    assign = rng.integers(0, 4, (n_rep, n_cls, n_slots)).astype(np.int32)
    failed = rng.integers(0, 9, (n_rep, n_cls)).astype(np.int32)

    def finish(a, f, v, z, c, o, pc):
        prices = jsolve.node_prices(_State(v, z, c, o, pc), jnp.asarray(price))
        return (jnp.sum(a), jnp.sum(f), jnp.sum((pc > 0).astype(jnp.int32)),
                jnp.sum(jnp.where(jnp.isfinite(prices), prices, 0.0)))

    want = jax.device_get(jax.jit(jax.vmap(finish))(
        *map(jnp.asarray, (assign, failed, viable, zone, ct, open_, pod_count))))
    got = k20.replica_finish(*map(torch.as_tensor, (assign, failed, viable, zone, ct, open_,
                                                     pod_count, price)))
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


# -- the studies -----------------------------------------------------------------


def _spot_catalog(fake_mod, n_types):
    """Spot offerings in zones 1 and 2 at 0.6x and 0.7x the on-demand price,
    on-demand in all three zones."""
    out = []
    for i in range(n_types):
        res = {"cpu": float(i + 1), "memory": (i + 1) * 2 * fake_mod.GI,
               "pods": float((i + 1) * 10)}
        p = fake_mod.price_from_resources(res)
        offerings = [fake_mod.Offering("spot", "test-zone-1", p * 0.6),
                     fake_mod.Offering("spot", "test-zone-2", p * 0.7)]
        offerings += [fake_mod.Offering("on-demand", f"test-zone-{z}", p) for z in (1, 2, 3)]
        out.append(fake_mod.new_instance_type(f"fake-it-{i}", resources=res,
                                              offerings=offerings))
    return out


def _spot_pods(testing_mod, obj_mod, labels_mod):
    spot = obj_mod.NodeSelectorRequirement(labels_mod.LABEL_CAPACITY_TYPE, "In", ["spot"])
    zone2 = obj_mod.NodeSelectorRequirement(labels_mod.LABEL_TOPOLOGY_ZONE, "In",
                                            ["test-zone-2"])
    return (testing_mod.make_pods(30, requests={"cpu": "500m"})
            + testing_mod.make_pods(12, requests={"cpu": "1"}, node_requirements=[spot])
            + testing_mod.make_pods(6, requests={"cpu": "250m", "memory": "512Mi"},
                                    node_requirements=[spot, zone2]))


def _parallel_snapshot():
    """tests/test_parallel.py's ``build()``: 24 pods on 6 types."""
    solver = TPUSolver(jfake.FakeCloudProvider(jfake.instance_types(6)),
                       [jtesting.make_provisioner()])
    return solver.encode(jtesting.make_pods(24, requests={"cpu": "500m"}))


def _spot_snapshot():
    solver = TPUSolver(jfake.FakeCloudProvider(_spot_catalog(jfake, 8)),
                       [jtesting.make_provisioner()])
    return solver.encode(_spot_pods(jtesting, jobj, jlabels))


def _policy_snapshot(rate):
    """tests/test_policy.py:716/:724: 12 pods on 4 types, every type's spot
    offerings at ``rate``."""
    provider = jfake.FakeCloudProvider(jfake.instance_types(4))
    if rate:
        for it in provider.get_instance_types(None):
            provider.set_interruption_rate(it.name, rate)
    solver = TPUSolver(provider, [jtesting.make_provisioner(name="p")])
    return solver.encode(jtesting.make_pods(12, requests={"cpu": "500m"}))


# (snapshot, n_replicas, mesh devices, seed, rate, n_slots (0: the estimate)):
# mesh.py's Monte-Carlo cases
MC_CASES = {
    "parallel-rate0": ("parallel", 16, 8, 0, 0.0, 0),
    "parallel-rate0.9-seed7": ("parallel", 16, 8, 7, 0.9, 0),
    "parallel-rate0.9-N16": ("parallel", 16, 8, 7, 0.9, 16),
    "spot-rate0.3": ("spot", 16, 8, 0, 0.3, 0),
    "spot-rate0.9-seed7": ("spot", 12, 4, 7, 0.9, 0),
    "spot-rate0.3-seed2^32+3": ("spot", 16, 8, 2**32 + 3, 0.3, 0),
    "spot-rate0.3-N32": ("spot", 8, 8, 1, 0.3, 32),
}


def _n_slots(snapshot, n_slots):
    return n_slots or tsolve.estimate_slots(snapshot)
# (risk rate, n_replicas, seed): tests/test_policy.py's two studies and a third
POLICY_CASES = {"zero-risk": (0.0, 8, 3), "risk0.95": (0.95, 8, 5), "risk0.5": (0.5, 16, 1)}


@pytest.fixture(scope="module")
def snapshots():
    return {"parallel": _parallel_snapshot(), "spot": _spot_snapshot()}


@pytest.fixture(scope="module")
def reference(snapshots):
    """The reference's answers to every case, computed once."""
    out = {}
    for name, (snap, n_rep, n_dev, seed, rate, n_slots) in MC_CASES.items():
        snapshot = snapshots[snap]
        out[name] = jmesh.monte_carlo_solve(
            snapshot, n_rep, mesh=jmesh.default_mesh(n_dev), seed=seed,
            interruption_rate=rate, n_slots=_n_slots(snapshot, n_slots))
    for name, (rate, n_rep, seed) in POLICY_CASES.items():
        snapshot = _policy_snapshot(rate)
        out[name] = (snapshot, jmesh.policy_monte_carlo(
            snapshot, n_rep, seed=seed, n_slots=tsolve.estimate_slots(snapshot)))
    return out


def _assert_study_equal(got: dict, want: dict, label: str):
    assert set(got) == set(want), label
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape, (
                f"{label}: {key} {getattr(g, 'dtype', type(g))} vs {w.dtype}")
            np.testing.assert_array_equal(g, w, err_msg=f"{label}: {key}")
            if w.dtype.kind == "f":
                np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                              err_msg=f"{label}: {key} bits")
        else:
            assert type(g) is type(w) and g == w, f"{label}: {key} {g!r} vs {w!r}"


@pytest.mark.parametrize("case", list(MC_CASES))
def test_monte_carlo_matches_jax(case, snapshots, reference):
    snap, n_rep, _, seed, rate, n_slots = MC_CASES[case]
    snapshot = snapshots[snap]
    got = tmesh.monte_carlo_solve(snapshot, n_rep, device="cpu", seed=seed,
                                  interruption_rate=rate, n_slots=_n_slots(snapshot, n_slots))
    _assert_study_equal(got, reference[case], case)
    assert (got["scheduled"] + got["failed"] == int(snapshot.cls_count.sum())).all()
    if snap == "spot" and rate > 0:
        # the study sees the interruptions: replicas differ in cost or failures
        assert len(set(got["cost"].tolist())) > 1 or got["failed"].any()


@pytest.mark.parametrize("case", list(POLICY_CASES))
def test_policy_monte_carlo_matches_jax(case, reference):
    _, n_rep, seed = POLICY_CASES[case]
    snapshot, want = reference[case]
    got = tmesh.policy_monte_carlo(snapshot, n_rep, device="cpu", seed=seed,
                                   n_slots=tsolve.estimate_slots(snapshot))
    _assert_study_equal(got, want, case)
    if case == "zero-risk":
        assert got["feasible_replicas"] == n_rep and np.all(got["cost"] == got["cost"][0])


def chunk_spy(monkeypatch) -> list:
    """The replicas each batched scan takes, call by call."""
    sizes = []
    batched = tsolve.solve_core_batched

    def spy(*args, **kwargs):
        out = batched(*args, **kwargs)
        sizes.append(int(out.failed.shape[0]))
        return out

    monkeypatch.setattr(tsolve, "solve_core_batched", spy)
    return sizes


@pytest.mark.parametrize("fit,chunks", [(1, [1] * 16), (3, [3] * 5 + [1]), (5, [4] * 4),
                                        (16, [16])])
def test_chunk_size_changes_nothing(fit, chunks, snapshots, reference, monkeypatch):
    """Replicas are independent: a study in chunks of 1, 3, 4 or 16
    replicas gives the reference's answer.  ``chunk_size`` spreads the
    replicas evenly over the chunks that the fit needs."""
    monkeypatch.setattr(tchunks, "CPU_CHUNK", fit)
    sizes = chunk_spy(monkeypatch)
    snap, n_rep, _, seed, rate, _ = MC_CASES["spot-rate0.3"]
    snapshot = snapshots[snap]
    got = tmesh.monte_carlo_solve(snapshot, n_rep, device="cpu", seed=seed,
                                  interruption_rate=rate,
                                  n_slots=tsolve.estimate_slots(snapshot))
    assert sizes == chunks
    _assert_study_equal(got, reference["spot-rate0.3"], f"chunks {chunks}")


def test_port_encode_gives_the_same_study(snapshots, reference):
    """The port's own encode of the same pods on the same catalog feeds the
    same study."""
    solver = CudaSolver(tfake.FakeCloudProvider(_spot_catalog(tfake, 8)),
                        [ttesting.make_provisioner()], device="cpu")
    snapshot = solver.encode(_spot_pods(ttesting, tobj, tlabels))
    snap, n_rep, _, seed, rate, _ = MC_CASES["spot-rate0.9-seed7"]
    got = tmesh.monte_carlo_solve(snapshot, n_rep, device="cpu", seed=seed,
                                  interruption_rate=rate,
                                  n_slots=tsolve.estimate_slots(snapshots[snap]))
    _assert_study_equal(got, reference["spot-rate0.9-seed7"], "port encode")


def test_default_device_is_the_card(snapshots):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.monte_carlo_solve(snapshots["parallel"], 2)
