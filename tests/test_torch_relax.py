"""The port's relax family held against the JAX package's, on the CPU: the
pieces below the solver.

Every case feeds the same inputs to both packages (numpy arrays, or one
``prepare_encoded`` output of the reference carried into tensors by
``carry.tensors_from_numpy``), and every int, bool and float32 must be equal
bit for bit (no tolerance):

- ``relax.prng``: ``permutation`` against ``jax.random.permutation``,
  ``split`` and ``random_bits`` against JAX's, in the partitionable mode the
  reference runs under;
- ``kernels.fp32.cumsum_xla_plain`` against ``jax.jit(jnp.cumsum)`` and
  ``kernels.relax.xla_sum_2d_plain`` against a jitted 2-D ``jnp.sum``;
- the simplex projection against the reference's ``_simplex_project``;
- ``relax.kernel.relax_core`` (every kernel's twin) against the reference's
  ``_relax_jit``, every ``RelaxResult`` field and every ``NodeState`` leaf,
  on tests/test_relax.py's fixtures under the policy's weights off and on,
  at ``max_iters=1``, and on the 3,000,000-pod class whose rounding deficit
  shows the seeded order (seeds 0, 1, 7).

tests/test_torch_relax_solve.py holds the solver paths built on them.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_existing import _to_jax
import torch_history

import karpenter_core_tpu.testing as jtesting
from karpenter_core_tpu.cloudprovider import fake as jfake
from karpenter_core_tpu.policy import PolicyConfig as JPolicy
from karpenter_core_tpu.relax import kernel as jrk
from karpenter_core_tpu.relax import solve as jrs
from karpenter_core_tpu.solver.tpu import TPUSolver
from karpenter_core_tpu_torch import carry as tcarry
from karpenter_core_tpu_torch.apis import labels as labels_api
from karpenter_core_tpu_torch.apis.objects import LabelSelector, TopologySpreadConstraint
from karpenter_core_tpu_torch.kernels import relax as krelax
from karpenter_core_tpu_torch.kernels.fp32 import cumsum_xla_plain
from karpenter_core_tpu_torch.relax import kernel as trk
from karpenter_core_tpu_torch.relax import prng
from karpenter_core_tpu_torch.testing import make_pod, workloads

# both packages' slot and feature histories start empty for this module and
# are put back after it (tests/torch_history.py)
isolated_history = torch_history.isolated_history


SEED = 20260807  # tests/test_relax.py's
KNOBS = {"off": (1.0, 0.0, 0.0), "on": (0.7310001, 0.6170001, 0.3330001)}


@pytest.fixture(scope="module", autouse=True)
def _module_environment(tmp_path_factory):
    """The reference memoizes a compiled solve only once its export cache
    could write it: a directory of its own lets each shape compile once.
    Its dispatch watchdog is off (``KC_WATCHDOG=0``): a first compile on a
    loaded CPU may outlast its deadline.  One torch intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KC_TPU_COMPILE_CACHE", str(tmp_path_factory.mktemp("kc_compile_cache")))
        mp.setenv("KC_WATCHDOG", "0")
        yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for key in ("KC_SOLVER_MODE", "KC_RELAX_MAX_ITERS", "KC_RELAX_MIN_PODS"):
        monkeypatch.delenv(key, raising=False)


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype in (np.float32, np.uint32) else a


def _assert_bits(ref, got, label):
    a, b = _bits(ref), _bits(got)
    assert a.dtype == b.dtype and a.shape == b.shape, (
        f"{label}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}")
    np.testing.assert_array_equal(a, b, err_msg=label)


# -- the seeded permutation ------------------------------------------------------


def test_reference_runs_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("n", [1, 2, 16, 72, 1625, 1626, 3000, 6000])
def test_permutation_matches_jax(n):
    for seed in (0, 1, 7, 2**32 - 1):
        want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
        got = prng.permutation(seed, n)
        assert got.dtype == np.int32 and not got.flags.writeable
        np.testing.assert_array_equal(want, got, err_msg=f"n={n} seed={seed}")
    assert prng.shuffle_rounds(n) == (2 if n > 1625 else (1 if n > 1 else 0))


def test_traced_seed_permutation_matches_relax_core():
    """relax_core draws with a traced uint32 seed."""
    draw = jax.jit(lambda s: jax.random.permutation(jax.random.PRNGKey(s.astype(jnp.uint32)),
                                                    3000))
    for seed in (0, 7, 2**32 - 1):
        np.testing.assert_array_equal(np.asarray(draw(jnp.uint32(seed))),
                                      prng.permutation(seed, 3000))


@pytest.mark.parametrize("seed", [0, 5, 123456789, 2**32 - 1])
def test_split_and_bits_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(key), prng.prng_key(seed))
    np.testing.assert_array_equal(np.asarray(jax.random.split(key, 3)),
                                  prng.split(prng.prng_key(seed), 3))
    for n in (1, 37, 4096):
        np.testing.assert_array_equal(np.asarray(jax.random.bits(key, (n,), jnp.uint32)),
                                      prng.random_bits(prng.prng_key(seed), n))
    k0, k1 = prng.threefry2x32(prng.prng_key(seed), np.arange(5, dtype=np.uint32),
                               np.arange(5, 10, dtype=np.uint32))
    from jax._src import prng as jprng
    want = jprng.threefry_2x32(jnp.asarray(prng.prng_key(seed)),
                               jnp.arange(10, dtype=jnp.uint32))
    np.testing.assert_array_equal(np.asarray(want), np.concatenate([k0, k1]))


# -- XLA's float32 orders --------------------------------------------------------


@pytest.mark.parametrize("n", list(range(1, 41)) + [255, 256, 257, 3000, 4097])
def test_cumsum_matches_xla(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((3, n)) * 2.0 ** rng.integers(-20, 21, (3, n))).astype(np.float32)
    want = jax.jit(lambda v: jnp.cumsum(v, axis=-1))(x)
    _assert_bits(want, cumsum_xla_plain(torch.from_numpy(x)), f"n={n}")


@pytest.mark.parametrize("shape", [(8, 24), (16, 24), (16, 33), (16, 3000), (24, 72),
                                   (48, 600), (64, 3000), (8, 9)])
def test_2d_sum_matches_xla(shape):
    rng = np.random.default_rng(shape[0] * 10007 + shape[1])
    c = (rng.random(shape) * 2.0 ** rng.integers(-10, 10, shape)).astype(np.float32)
    x = (rng.random(shape) * 100).astype(np.float32)
    s = rng.random(shape) < 0.5
    want = jax.jit(lambda s, c, x: jnp.sum(jnp.where(s, c * x, 0.0)))(s, c, x)
    v = torch.where(torch.from_numpy(s), torch.from_numpy(c) * torch.from_numpy(x), 0.0)
    _assert_bits(want, krelax.xla_sum_2d_plain(v), str(shape))


def test_simplex_project_matches_reference():
    rng = np.random.default_rng(3)
    n_c, n_s = 16, 3000
    y = (rng.standard_normal((n_c, n_s)) * 2.0 ** rng.integers(-8, 8, (n_c, n_s))).astype(
        np.float32)
    support = rng.random((n_c, n_s)) < rng.random((n_c, 1))
    support[1] = False  # an empty row
    m = rng.integers(1, 5000, n_c).astype(np.float32)
    m[2] = 0.0
    jidx = np.arange(1, n_s + 1, dtype=np.float32)
    want = jax.jit(jrk._simplex_project)(y, support, m, jidx)
    got = trk._simplex_project(*(torch.from_numpy(a) for a in (y, support, m, jidx)))
    _assert_bits(want, got, "projection")
    assert not got[1].any()


# -- relax_core, leaf for leaf -----------------------------------------------------


def _skewed_solver(n_its=8):
    """tests/test_relax.py ``_solver``: the skewed fake catalog, relax
    pinned by the policy spec."""
    provider = jfake.FakeCloudProvider(jfake.instance_types(n_its))
    workloads.move_spot_market(provider)
    return TPUSolver(provider, [jtesting.make_provisioner(name="default")],
                     policy=JPolicy(enabled=True, solver_mode="relax"))


def _fuzz_pods(seed):
    """tests/test_relax.py ``TestFeasibilityFuzz``'s fleet of one seed."""
    rng = random.Random(SEED + seed)
    sizes = ({"cpu": "100m"}, {"cpu": "500m"}, {"cpu": 1}, {"cpu": "250m", "memory": "512Mi"})
    pods = []
    for cls_i in range(rng.randint(2, 4)):
        labels = {"app": f"relax-fuzz-{cls_i}"}
        kwargs = dict(labels=labels, requests=rng.choice(sizes))
        if rng.random() < 0.3:
            kwargs["topology_spread"] = [TopologySpreadConstraint(
                max_skew=1, topology_key=labels_api.LABEL_TOPOLOGY_ZONE,
                label_selector=LabelSelector(match_labels=dict(labels)))]
        pods.extend(make_pod(**kwargs) for _ in range(rng.randint(8, 48)))
    return pods


FIXTURES = {
    "uniform-64": lambda: [make_pod(requests={"cpu": "500m"}) for _ in range(64)],
    "uniform-200": lambda: [make_pod(requests={"cpu": "500m"}) for _ in range(200)],
    "mixed-sizes": lambda: [make_pod(requests=size) for size in (
        {"cpu": "500m"}, {"cpu": 1}, {"cpu": "250m"}) for _ in range(40)],
    "fuzz-0": lambda: _fuzz_pods(0),
    "fuzz-1": lambda: _fuzz_pods(1),
    "fuzz-2": lambda: _fuzz_pods(2),
}


def compare_core(js, pods, weights, max_iters=64, seed=0, count=None, n_slots=None):
    """relax_core (the twins) against the reference's _relax_jit on one
    encoded batch; returns (reference result, port result)."""
    prep = js.prepare_encoded(js.encode([_to_jax(p) for p in pods]))
    cls, sa, pol = jax.device_get((prep.cls, prep.statics_arrays, prep.pol))
    if count is not None:
        cls = cls._replace(count=np.asarray(count, dtype=np.int32))
    n_slots = n_slots or prep.n_slots
    eligible = jrs.eligible_classes(prep, cls)
    weights = np.asarray(weights, dtype=np.float32)
    ref = jax.device_get(jrk._relax_jit(
        cls, sa, pol.price, pol.risk, pol.throughput, jnp.asarray(eligible),
        jnp.asarray(weights), jnp.int32(max_iters), jnp.float32(jrs.RELAX_TOL),
        jnp.uint32(seed), n_slots=n_slots, key_has_bounds=prep.key_has_bounds,
        packed_masks=True))
    tc, ts, khb = tcarry.tensors_from_numpy(cls, sa, prep.key_has_bounds, device="cpu")
    got = trk.relax_core(
        tc, ts, *(torch.as_tensor(np.asarray(a)) for a in pol), torch.as_tensor(eligible),
        torch.as_tensor(weights), max_iters, jrs.RELAX_TOL, seed, n_slots=n_slots,
        key_has_bounds=khb, use_kernels=False)
    assert ref._fields == got._fields
    for f in ref._fields:
        if f == "state":
            for g in ref.state._fields:
                _assert_bits(getattr(ref.state, g), getattr(got.state, g), f"state.{g}")
        else:
            _assert_bits(getattr(ref, f), getattr(got, f), f)
    return ref, got


@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_relax_core_matches_reference(fixture, knobs):
    ref, _ = compare_core(_skewed_solver(), FIXTURES[fixture](), KNOBS[knobs])
    assert bool(ref.converged)


@pytest.mark.parametrize("n_its", [1, 2])
@pytest.mark.parametrize("n_classes", [3, 10, 20])
def test_relaxed_cost_small_catalog_matches_reference(n_its, n_classes):
    """``relaxed_cost`` where the sum over [C, S] has at most 8 columns (S =
    I * Z = 3 and 6) and several rows (C = 8, 16, 24): bit for bit.  Inside
    ``relax_core`` XLA's CPU code for this sum is one scalar accumulator,
    row-major from +0 (``objdump -d`` of the ``select_reduce_fusion`` of
    ``jit_relax_core``), which ``xla_sum_2d_plain`` takes; the row-vectorised
    order belongs to a standalone ``jnp.sum`` of the same expression."""
    rng = np.random.default_rng(1)
    sizes = [{"cpu": f"{int(rng.integers(1, 10)) * 50}m"} for _ in range(n_classes)]
    pods = [make_pod(requests=dict(size)) for size in sizes
            for _ in range(int(rng.integers(3, 12)))]
    ref, got = compare_core(_skewed_solver(n_its), pods, KNOBS["on"])
    assert float(ref.relaxed_cost) > 0.0


def test_relax_core_non_convergence_matches_reference():
    ref, _ = compare_core(_skewed_solver(), FIXTURES["uniform-64"](), KNOBS["off"], max_iters=1)
    assert int(ref.iters) == 1 and not bool(ref.converged)


@pytest.mark.parametrize("seed,placed,zone", [(0, 112, 0), (1, 112, 0), (7, 106, 1)])
def test_relax_core_seeded_rounding_matches_reference(seed, placed, zone):
    """A 3-cpu class of 3,000,000 pods over 24 types in 16 slots: its
    rounding deficit is large enough that the seeded tie order moves the
    placement."""
    provider = jfake.FakeCloudProvider(jfake.instance_types(24))
    js = TPUSolver(provider, [jtesting.make_provisioner(name="default")],
                   policy=JPolicy(enabled=True, solver_mode="relax"))
    pods = [make_pod(requests={"cpu": 3})]
    n_classes = np.asarray(js.prepare_encoded(js.encode([_to_jax(p) for p in pods])).cls.count)
    count = np.zeros(n_classes.shape[0], dtype=np.int32)
    count[0] = 3_000_000
    ref, got = compare_core(js, pods, KNOBS["off"], seed=seed, count=count, n_slots=16)
    assert int(got.placed) == placed
    assert int(np.argmax(got.state.zone[0].numpy())) == zone
