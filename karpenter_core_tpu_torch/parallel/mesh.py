"""The what-if studies on one card: Monte-Carlo spot interruptions and the
crossed replica x prefix consolidation grid.

The port of the replica programs of ``karpenter_core_tpu/parallel/mesh.py``
(BASELINE.json config 5).  The reference spreads replicas over a device
mesh and vmaps the solve inside each device; here the replica axis (and the
crossed study's (replica, prefix) grid) is the tenant axis of
``ops.solve.solve_core_batched``, on one card:

  K19 (``kernels.perturb``)    every replica's sampled availability,
      bool[R, I, Z, CT], drawn on the card in one launch;
  K8 (``kernels.consolidate.sweep_lanes``)  the crossed grid's open masks
      and class counts, for all R x S cells in one launch;
  ``solve_core_batched``       the replicas' solves, a chunk at a time,
      every kernel launch (K1-K7) covering the chunk;
  K20 (``kernels.montecarlo``)  each replica's scheduled, failed, node and
      cost sums, one launch a chunk.

Every replica shares the classes and the statics; only ``it_avail`` (and,
in the crossed grid, ``ExistingState.open_`` and the class counts) differs.
The kernels take dense operands, so the shared leaves are stacked (repeated
over the chunk).  Chunks are sized to the card's free memory
(``ops.chunks.chunk_size``); replicas are independent, so no output depends
on the chunk.  The replicas, and the crossed grid's cells (the lane sweep
with a replica axis), run through the sweep's chunk loop
(``ops.chunks.solve_cells``).
The solves' features are snapped (``utils.compilecache.snap_features``) as
the reference's are.  All results come to the host in one copy at the end.

Entry points take the reference's names, arguments and return dicts, with
``device=None`` (the card; the CPU only when asked) in the place of
``mesh=``.  The crossed study drops the reference's padding of R and S to
mesh multiples, which changes nothing it returns.
Left out, each with its ROADMAP item: the ``watchdog.run`` barrier (1.5);
``solve_catalog_sharded``, the mesh topology functions and
``tenant_solve_callable`` (1.2: they need more than one card).
"""

from __future__ import annotations

import numpy as np
import torch

from karpenter_core_tpu_torch import carry
from karpenter_core_tpu_torch import device as device_mod
from karpenter_core_tpu_torch.kernels import consolidate as k89
from karpenter_core_tpu_torch.kernels import montecarlo as k20
from karpenter_core_tpu_torch.kernels import perturb as k19
from karpenter_core_tpu_torch.ops import chunks
from karpenter_core_tpu_torch.ops import consolidate as consolidate_ops
from karpenter_core_tpu_torch.ops import solve as solve_ops
from karpenter_core_tpu_torch.utils import compilecache


def _finish(out, it_price, use_kernels: bool):
    fn = k20.replica_finish if use_kernels else k20.replica_finish_plain
    st = out.state
    return fn(out.assign, out.failed, st.viable, st.zone, st.ct, st.open_, st.pod_count,
              it_price)


def replica_summaries(cls, statics_arrays, key_has_bounds, avail_r, it_price, n_slots: int,
                      n_passes: int = 1, features=None):
    """(scheduled i32[R], failed i32[R], nodes i32[R], cost f32[R]) of one
    solve per availability plane of ``avail_r`` (bool[R, I, Z, CT]), on the
    planes' device: ``solve_core_batched`` over chunks of replicas, K20 on
    each chunk's outputs."""
    n_rep = avail_r.shape[0]
    if n_rep == 0:
        dev = avail_r.device
        return (*(torch.zeros(0, dtype=torch.int32, device=dev) for _ in range(3)),
                torch.zeros(0, dtype=torch.float32, device=dev))
    return chunks.solve_cells((cls, statics_arrays, None, None), key_has_bounds, n_rep, n_slots,
                              lambda out: _finish(out, it_price, True),
                              it_avail=lambda lo, hi: avail_r[lo:hi], n_passes=n_passes,
                              features=features)


def _is_spot(snapshot, dev) -> torch.Tensor:
    return torch.as_tensor(np.array([ct == "spot" for ct in snapshot.capacity_types],
                                    dtype=bool)).to(dev)


def perturb_spot_availability(snapshot, n_replicas: int, seed: int = 0,
                              interruption_rate: float = 0.3, device=None) -> torch.Tensor:
    """bool[R, I, Z, CT]: per-replica offering availability with spot
    offerings randomly interrupted (K19) — the scenario axis for the
    what-if sweep."""
    dev = device_mod.resolve(device)
    avail = carry.to_tensor(snapshot.it_avail, dev)
    return k19.perturb_avail(avail, n_replicas, seed, rate=interruption_rate,
                             is_spot=_is_spot(snapshot, dev))


def perturb_offering_availability(snapshot, risk, n_replicas: int, seed: int = 0,
                                  device=None) -> torch.Tensor:
    """bool[R, I, Z, CT]: per-replica offering availability with every
    offering cell interrupted with its own prior probability (K19 on the
    risk plane).  Offerings with zero risk never drop."""
    dev = device_mod.resolve(device)
    avail = carry.to_tensor(snapshot.it_avail, dev)
    risk_t = carry.to_tensor(np.asarray(risk, dtype=np.float32), dev)
    return k19.perturb_avail(avail, n_replicas, seed, risk=risk_t)


def prepared(snapshot, device):
    """(ClassTensors, StaticArrays, key_has_bounds) of a snapshot on
    ``device``, unpadded (the reference's ``prepare``): the planes every
    replica shares."""
    cls, statics_arrays, key_has_bounds = solve_ops.prepare_host(snapshot)
    return carry.tensors_from_numpy(cls, statics_arrays, key_has_bounds, device)


def _replica_run(snapshot, avail_r, it_price, n_slots: int, dev):
    cls, sa, khb = prepared(snapshot, dev)
    outs = replica_summaries(
        cls, sa, khb, avail_r, carry.to_tensor(np.asarray(it_price, dtype=np.float32), dev),
        n_slots, n_passes=snapshot.scan_passes,
        features=compilecache.snap_features(solve_ops.snapshot_features(snapshot)))
    return [t.cpu().numpy() for t in outs]  # the study's one fetch


def monte_carlo_solve(snapshot, n_replicas: int, device=None, seed: int = 0,
                      interruption_rate: float = 0.3, n_slots: int = 0) -> dict:
    """Solve ``n_replicas`` perturbed snapshots on one device.

    Returns summary statistics (per-replica scheduled/failed/node counts and
    total cost, plus mean/min/max cost) — the cost-vs-disruption Pareto
    input."""
    dev = device_mod.resolve(device)
    if n_slots <= 0:
        n_slots = solve_ops.estimate_slots(snapshot)
    avail_r = perturb_spot_availability(snapshot, n_replicas, seed, interruption_rate, dev)
    scheduled, failed, nodes, cost = _replica_run(snapshot, avail_r, snapshot.it_price,
                                                  n_slots, dev)
    return {
        "replicas": n_replicas,
        "scheduled": scheduled,
        "failed": failed,
        "nodes": nodes,
        "cost": cost,
        "cost_mean": float(np.mean(cost)),
        "cost_min": float(np.min(cost)),
        "cost_max": float(np.max(cost)),
        "failed_mean": float(np.mean(failed)),
    }


def policy_monte_carlo(snapshot, n_replicas: int, device=None, seed: int = 0,
                       n_slots: int = 0) -> dict:
    """Risk-weighted policy variants over the Monte-Carlo replica machinery:
    sample one interruption outcome per replica from the snapshot's
    per-offering risk priors (``pol_risk``), solve every outcome, and pick
    the replica minimizing risk-adjusted cost — fleet price plus an
    unschedulable-pod penalty that dominates any price difference
    (docs/POLICY.md "Risk-weighted variants").

    Returns per-replica ``cost``/``failed``/``nodes`` arrays plus
    ``expected_cost`` (the mean risk-adjusted cost) and ``best_replica``."""
    dev = device_mod.resolve(device)
    if n_slots <= 0:
        n_slots = solve_ops.estimate_slots(snapshot)
    risk = getattr(snapshot, "pol_risk", None)
    if risk is None:
        risk = np.zeros_like(np.asarray(snapshot.it_price))
    price = getattr(snapshot, "pol_price", None)
    if price is None:
        price = snapshot.it_price

    avail_r = perturb_offering_availability(snapshot, risk, n_replicas, seed, dev)
    scheduled, failed, nodes, cost = _replica_run(snapshot, avail_r, price, n_slots, dev)
    cost = np.asarray(cost, dtype=np.float64)
    failed = np.asarray(failed, dtype=np.int64)
    # the penalty per unplaced pod dominates any achievable fleet price —
    # every open slot costs at most the max offering price, so max_price ×
    # n_slots bounds any replica's fleet cost and feasibility strictly
    # outranks price in the risk-adjusted ordering
    finite = np.asarray(price)[np.isfinite(price)]
    penalty = float(finite.max() if finite.size else 1.0) * max(n_slots, 1)
    adjusted = cost + failed * (penalty + 1.0)
    best = int(np.argmin(adjusted)) if len(adjusted) else 0
    return {
        "replicas": n_replicas,
        "scheduled": np.asarray(scheduled),
        "failed": failed,
        "nodes": np.asarray(nodes),
        "cost": cost,
        "adjusted_cost": adjusted,
        "expected_cost": float(np.mean(adjusted)) if len(adjusted) else 0.0,
        "cost_mean": float(np.mean(cost)) if len(cost) else 0.0,
        "cost_max": float(np.max(cost)) if len(cost) else 0.0,
        "best_replica": best,
        "best_cost": float(cost[best]) if len(cost) else 0.0,
        "feasible_replicas": int(np.sum(failed == 0)),
    }


def crossed_sweep(prep: consolidate_ops.SweepPrep, avail_r, prefix_sizes,
                  n_slots: int = consolidate_ops.SWEEP_SLOTS, use_kernels: bool = True):
    """(failed i32[R, S], n_new i32[R, S]) on the device: cell (r, s)
    closes the first ``prefix_sizes[s]`` candidates of ``prep`` (K8, every
    cell in one launch) and solves under replica r's availability, through
    the lane sweep's chunk loop (``ops.chunks.solve_cells``); K20 sums
    each cell's failures."""
    dev = prep.it_price.device
    sizes = torch.as_tensor(np.asarray(prefix_sizes, dtype=np.int32)).to(dev)
    n_rep, n_sizes = avail_r.shape[0], sizes.shape[0]
    if n_rep * n_sizes == 0:
        empty = torch.zeros((n_rep, n_sizes), dtype=torch.int32, device=dev)
        return empty, empty.clone()
    lanes = k89.sweep_lanes if use_kernels else k89.sweep_lanes_plain
    # cell r * S + s: the sizes repeat once per replica
    lane_open, lane_count = lanes(prep.candidate_rank, prep.ex_state.open_, prep.cls.count,
                                  prep.ex_cls_count, sizes.repeat(n_rep))
    failed, n_new = chunks.solve_cells(
        prep.shared(), prep.key_has_bounds, n_rep * n_sizes, n_slots,
        lambda out: (_finish(out, prep.it_price, use_kernels)[1], out.state.n_next),
        count=lane_count, open_=lane_open,
        it_avail=lambda lo, hi: avail_r[torch.arange(lo, hi, device=dev) // n_sizes],
        n_passes=prep.n_passes, features=prep.features, use_kernels=use_kernels)
    return failed.reshape(n_rep, n_sizes), n_new.reshape(n_rep, n_sizes)


def crossed_consolidation_study(
    snapshot,
    ex_state,
    ex_static,
    candidate_rank: np.ndarray,  # i32[E] disruption order, big = not candidate
    ex_cls_count: np.ndarray,  # i32[C, E] candidate pods per class per node
    prefix_sizes: np.ndarray,  # i32[S]
    n_replicas: int,
    device=None,
    seed: int = 0,
    interruption_rate: float = 0.3,
    n_slots: int = 16,
) -> dict:
    """Risk-aware consolidation: every (spot-interruption scenario r,
    consolidation prefix k) pair is one simulation — close the first-k
    candidates and apply replica r's perturbed offering availability, then
    re-schedule.

    Returns the failed/new-node grids plus ``safe_prefix``: per replica, the
    largest prefix whose simulation fully re-schedules — min over replicas is
    the consolidation depth that is safe under every sampled interruption
    scenario (the 1D sweep in ops.consolidate answers only the rate-0 row)."""
    dev = device_mod.resolve(device)
    prep = consolidate_ops.prepare_sweep(snapshot, ex_state, ex_static, candidate_rank,
                                         ex_cls_count, dev)
    avail_r = perturb_spot_availability(snapshot, n_replicas, seed, interruption_rate, dev)
    failed, n_new = crossed_sweep(prep, avail_r, prefix_sizes, n_slots)
    failed, n_new = failed.cpu().numpy(), n_new.cpu().numpy()

    feasible = failed == 0  # [R, S]
    sizes_np = np.asarray(prefix_sizes)
    # rows with no feasible prefix reduce to 0 (sizes are >= 1)
    safe_prefix = np.max(np.where(feasible, sizes_np[None, :], 0), axis=1)
    return {
        "failed": failed,
        "n_new": n_new,
        "safe_prefix": safe_prefix,  # per replica
        "safe_prefix_all": int(safe_prefix.min()) if len(safe_prefix) else 0,
    }
