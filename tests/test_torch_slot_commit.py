"""The slot commit (K23's twin, ``kernels.commit``) held against the JAX
package on the CPU, bit for bit.

Two levels, each with no tolerance (ints and bools exact, f32 bit for bit):

- the port's ``_phase`` against the reference's ``_phase``
  (karpenter_core_tpu/ops/solve.py:686), jitted as the whole solve runs it
  (its ``base + a * req`` commits are then XLA's contracted FMAs), on the
  headline mix's prepared planes with cpu and memory requests off binary
  fractions and daemon overheads in tenths, over random open slot states
  (usage in tenths), host ports on and off, with open and fresh slots both
  taking pods: every ``NodeState`` leaf, the assignment, the placed count and
  the limit budget.  Tenants are batched (B = 2), and a phase some tenants
  skip (``on``) keeps their slot state whole;
- the committal block's commit through whole batched solves of a
  zone-spread mix (B = 3, one tenant holding no pod of the spread classes,
  so the committal block and K23 run with that tenant off) against the
  reference's ``batched_solve_callable`` (``jax.vmap`` of the solve body).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_history

from karpenter_core_tpu.ops import masks as jmasks
from karpenter_core_tpu.ops import solve as jsolve
from karpenter_core_tpu.utils import compilecache as jcc
from karpenter_core_tpu_torch import carry
from karpenter_core_tpu_torch.kernels import batch
from karpenter_core_tpu_torch.kernels import commit as k23
from karpenter_core_tpu_torch.ops import masks as tmasks
from karpenter_core_tpu_torch.ops import solve as tsolve
from karpenter_core_tpu_torch.testing import workloads
from test_torch_existing import _reference_inputs
from test_torch_solve import _assert_same

# both packages' slot and feature histories start empty for this module and
# are put back after it (tests/torch_history.py)
isolated_history = torch_history.isolated_history

N_SLOTS = 48


@functools.lru_cache(maxsize=None)
def _prepared(n_pods: int = 700):
    """The headline mix's prepared planes from the JAX package (cls,
    statics arrays, key flags, slots, passes, features), requests x 1.1 on
    cpu and memory (the pod-count column stays 1) and daemon overheads in
    tenths (memory in tenths of a MiB), as numpy."""
    _, pods = workloads.build_inputs(n_pods, 50, 5, device="cpu")
    js, jnodes, jbound, jpods = _reference_inputs([], [], pods, 50)
    jprep = js.prepare_encoded(js.encode(jpods, jnodes, jbound), jnodes, jbound)
    cls = jax.tree_util.tree_map(np.asarray, jprep.cls)
    sa = jax.tree_util.tree_map(np.asarray, jprep.statics_arrays)
    rng = np.random.default_rng(n_pods)
    requests = (cls.requests * np.array([1.1, 1.1, 1.0], np.float32)).astype(np.float32)
    daemon = sa.tmpl_daemon.copy()
    daemon[:, :2] = rng.integers(1, 20, daemon[:, :2].shape) * np.float32(0.1)
    daemon[:, 1] *= np.float32(2**20)  # memory in tenths of a MiB
    return (cls._replace(requests=requests), sa._replace(tmpl_daemon=daemon),
            tuple(jprep.key_has_bounds), jprep.n_slots, jprep.n_passes, jprep.features)


def _open_state(rng, sa, n_ports, n_open):
    """A random slot state [N_SLOTS, ...] (numpy, mask words int32) whose
    first ``n_open`` slots are open: usage in tenths, requirement words
    inside the valid words, some zones, capacity types, types and ports."""
    n_keys, width = sa.valid.shape
    n_words = tmasks.words_for(width)
    valid = np.asarray(tmasks.pack_mask(torch.as_tensor(sa.valid)))
    n_res, n_zones = sa.tmpl_daemon.shape[-1], sa.tmpl_zone.shape[-1]
    n_ct, n_it, n_tmpl = sa.tmpl_ct.shape[-1], sa.it_alloc.shape[0], sa.tmpl_zone.shape[0]
    n = N_SLOTS
    used = (rng.integers(0, 30, (n, n_res)) * np.float32(0.1)).astype(np.float32)
    used[:, 1] *= np.float32(2**27)  # memory: tenths of 128 MiB
    used[:, -1] = rng.integers(0, 5, n)  # the pod-count column
    used[n_open:] = 0.0
    words = rng.integers(-2**31, 2**31, (n, n_keys, n_words), dtype=np.int64).astype(np.int32)
    kmask = np.where(rng.random((n, n_keys, 1)) < 0.7, valid[None], words & valid[None])
    return tsolve.NodeState(
        used, kmask.astype(np.int32), rng.random((n, n_keys)) < 0.3,
        rng.random((n, n_keys)) < 0.1, np.full((n, n_keys), -np.inf, np.float32),
        np.full((n, n_keys), np.inf, np.float32), rng.random((n, n_zones)) < 0.7,
        rng.random((n, n_ct)) < 0.8, rng.random((n, n_it)) < 0.85,
        rng.random((n, n_ports)) < 0.3, rng.integers(0, 8, n).astype(np.int32),
        rng.integers(0, n_tmpl, n).astype(np.int32), np.arange(n) < n_open, np.int32(n_open))


@functools.partial(jax.jit, static_argnames=("khb", "mask_v", "ft"))
def _jax_phase(state, cls, sa, quota, restrict, host_cap, fresh_cap, remaining, khb, mask_v, ft):
    statics = jsolve.Statics(*sa, key_has_bounds=khb, packed=True, mask_v=mask_v)
    return jsolve._phase(state, cls, statics, quota, restrict, host_cap, fresh_cap, remaining,
                         ft=ft)


def _jax_state(st):
    return jsolve.NodeState(*(jnp.asarray(a.view(np.uint32) if j == 1 else a)
                              for j, a in enumerate(st)))


def _packed_sa_jax(sa):
    return sa._replace(it=jmasks.pack_req(sa.it), tmpl=jmasks.pack_req(sa.tmpl),
                       valid=jmasks.pack_mask(sa.valid))


def _phase_case(host_ports: bool, seed: int, n_b: int = 2):
    """(port inputs, per-tenant reference inputs) of one phase: the first
    class of the headline mix that holds pods (its ports set when host ports
    are on) over ``n_b`` random open states, a quota past what they hold."""
    cls, sa, khb, _, _, _ = _prepared()
    rng = np.random.default_rng(seed)
    c = int(np.argmax(cls.count > 0))
    if host_ports:
        ports = cls.ports.copy()
        ports[c, 0] = True
        cls = cls._replace(ports=ports)
    n_ports = cls.ports.shape[-1]
    states = [_open_state(rng, sa, n_ports, int(rng.integers(8, 24))) for _ in range(n_b)]
    width = sa.valid.shape[-1]
    n_zones = sa.tmpl_zone.shape[-1]
    restrict = [np.ones(n_zones, bool) if b == 0 else rng.random(n_zones) < 0.8
                for b in range(n_b)]
    restrict = [r if r.any() else np.ones(n_zones, bool) for r in restrict]
    quota = np.int32(int(cls.count[c]) + 4000)  # past the open slots: fresh slots open too
    return cls, sa, khb, c, states, restrict, quota, width


def _port_phase(case, ft, on=None):
    """The port's ``_phase`` (K23's twin on the CPU) over the case's tenants
    stacked: class c's row (its mask packed) against every tenant's state."""
    cls, sa, khb, c, states, restrict, quota, width = case
    n_b = len(states)
    unlimited = int(jsolve.UNLIMITED)
    tc, ts, tk = carry.tensors_from_numpy(cls, sa, khb, device="cpu")
    ts = ts._replace(it=tmasks.pack_req(ts.it), tmpl=tmasks.pack_req(ts.tmpl),
                     valid=tmasks.pack_mask(ts.valid))
    statics = tsolve.Statics(*batch.repeat(ts, n_b), key_has_bounds=tk, mask_v=width)
    row = batch.repeat(tsolve.ClassTensors(*(t[c] for t in tc))._replace(
        mask=tmasks.pack_mask(tc.mask[c])), n_b)
    state = tsolve.NodeState(*(torch.as_tensor(np.stack([s[j] for s in states]))
                               for j in range(14)))
    out = tsolve._phase(
        state, row, statics, torch.full((n_b,), int(quota), dtype=torch.int32),
        torch.as_tensor(np.stack(restrict)),
        torch.full((n_b, N_SLOTS), unlimited, dtype=torch.int32),
        torch.full((n_b,), unlimited, dtype=torch.int32),
        batch.repeat(torch.as_tensor(sa.tmpl_limits0), n_b), ft=ft, on=on)
    return state, out


def _reference_phase(case, b, ft):
    """The reference's jitted ``_phase`` on tenant b of the case."""
    cls, sa, khb, c, states, restrict, quota, width = case
    unlimited = np.int32(jsolve.UNLIMITED)
    jrow = jsolve.ClassTensors(*(jnp.asarray(t[c]) for t in cls))._replace(
        mask=jmasks.pack_mask(jnp.asarray(cls.mask[c])))
    jsa = _packed_sa_jax(jax.tree_util.tree_map(jnp.asarray, sa))
    return jax.device_get(_jax_phase(
        _jax_state(states[b]), jrow, jsa, quota, restrict[b], np.full(N_SLOTS, unlimited),
        unlimited, sa.tmpl_limits0, khb=khb, mask_v=width, ft=ft))


@pytest.mark.parametrize("host_ports,seed", [(False, 0), (False, 1), (True, 2), (True, 3)])
def test_phase_commit_matches_reference(host_ports, seed):
    case = _phase_case(host_ports, seed)
    ft = jsolve.ALL_FEATURES._replace(host_ports=host_ports)
    _, (got_state, got_a, got_placed, got_rem) = _port_phase(case, ft)
    states = case[4]
    took_open = took_fresh = False
    for b in range(len(states)):
        want_state, want_a, want_placed, want_rem = _reference_phase(case, b, ft)
        for name in jsolve.NodeState._fields:
            w = np.asarray(getattr(want_state, name))
            w = w.view(np.int32) if w.dtype == np.uint32 else w
            g = getattr(got_state, name)[b].numpy()
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=f"tenant {b}: {name}")
        np.testing.assert_array_equal(got_a[b].numpy(), np.asarray(want_a))
        assert int(got_placed[b]) == int(want_placed)
        np.testing.assert_array_equal(got_rem[b].numpy(), np.asarray(want_rem))
        n_open = int(states[b][-1])
        took_open |= bool((np.asarray(want_a)[:n_open] > 0).any())
        took_fresh |= bool((np.asarray(want_a)[n_open:] > 0).any())
    assert took_open and took_fresh  # both kinds of rows committed


def test_phase_commit_rounds_once(monkeypatch):
    """On these inputs a commit that rounds ``base + a * req`` twice (the
    product, then the sum) gives other floats than the reference: the
    FMA is what makes the phase test above exact."""
    case = _phase_case(False, 0)
    ft = jsolve.ALL_FEATURES
    want = np.asarray(_reference_phase(case, 0, ft)[0].used)
    _, (got, *_) = _port_phase(case, ft)
    np.testing.assert_array_equal(got.used[0].numpy(), want)
    monkeypatch.setattr(k23, "fma_f32", lambda a, b, c: a * b + c)
    _, (twice, *_) = _port_phase(case, ft)
    assert (twice.used[0].numpy() != want).any()


@pytest.mark.parametrize("host_ports", (False, True))
def test_phase_commit_keeps_skipped_tenants(host_ports):
    """A phase run for tenant 0 only (``on``): tenant 0 as in a full run,
    tenant 1's slot state and ``n_next`` exactly its input."""
    case = _phase_case(host_ports, 5)
    ft = tsolve.ALL_FEATURES._replace(host_ports=host_ports)
    state, (full, *_) = _port_phase(case, ft)
    _, (part, *_) = _port_phase(case, ft, on=torch.tensor([True, False]))
    for name in tsolve.NodeState._fields:
        assert torch.equal(getattr(part, name)[0], getattr(full, name)[0]), name
        assert torch.equal(getattr(part, name)[1], getattr(state, name)[1]), name
    assert not torch.equal(full.used[1], state.used[1])  # tenant 1 would have taken pods


def _spread_tenants():
    """Three tenants of the zone-spread mix in one bucket: the full backlog,
    half its counts, and the full backlog without its zone-spread classes'
    pods (its committal blocks run with it off)."""
    cls, sa, khb, n_slots, n_passes, ft = _prepared()
    g_dummy = sa.grp_skew.shape[0] - 1
    spread = cls.groups[:, 0] < g_dummy
    assert (spread & (cls.count > 0)).any()
    half = cls._replace(count=(cls.count // 2).astype(np.int32))
    no_spread = cls._replace(count=np.where(spread, 0, cls.count).astype(np.int32))
    return [cls, half, no_spread], sa, khb, n_slots, n_passes, ft


def test_committal_commit_matches_reference_with_a_skipped_tenant(monkeypatch):
    clss, sa, khb, n_slots, n_passes, ft = _spread_tenants()
    n_b = len(clss)
    stack = jax.tree_util.tree_map(lambda *ls: np.stack(ls), *clss)
    sa_b = jax.tree_util.tree_map(lambda a: np.stack([a] * n_b), sa)
    jfn = jcc.batched_solve_callable(n_b, clss[0], sa, n_slots, khb, n_passes=n_passes,
                                     features=ft)
    ref = jax.device_get(jfn(stack, sa_b))

    # the commits the port's scan makes: a committal block's (zone index
    # given) with tenant 2 off is among them
    calls = []
    real = k23.keep_skipped

    def spy(src, on):
        calls.append((src.zone_idx is not None, None if on is None else on.tolist()))
        return real(src, on)

    monkeypatch.setattr(k23, "keep_skipped", spy)
    tc, ts, tk = carry.tensors_from_numpy(stack, sa_b, khb, device="cpu")
    got = tsolve.solve_core_batched(tc, ts, n_slots, tk, n_passes=n_passes, features=tuple(ft))
    _assert_same(ref, got, "zone-spread mix, B = 3")
    assert (True, [True, True, False]) in calls
    assert any(site for site, _ in calls) and any(not site for site, _ in calls)
    # the twins' path takes the same commits
    plain = tsolve.solve_core_batched(tc, ts, n_slots, tk, n_passes=n_passes, features=tuple(ft),
                                      use_kernels=False)
    _assert_same(got, plain, "zone-spread mix, B = 3, twins")
