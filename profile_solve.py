"""Where the time of one warm 50k-pod solve goes, on one CUDA card.

    python3 profile_solve.py [--existing | --consolidation | --churn | --pipeline |
                              --policy | --relax | --tenants | --montecarlo] [--trace PATH]

Builds the inputs of the main path (50,000 pods x 1,000 instance types x 5
provisioners, ``testing/workloads.py``) — with ``--existing``, also the live
cluster they are solved into (``build_cluster(5000, 1000, 5, 0.6)``, the
existing-node path of ``chip_smoke.py``) — runs one solve to warm up, then
runs one more under ``torch.profiler`` (CPU and CUDA activities) and prints
one JSON object with:

  - the stage split of the profiled solve (ingest, encode, solve, decode);
  - the device's busy share: the summed device time of every CUDA kernel and
    copy over the wall time of the solve call (kernels overlap nothing here:
    one stream);
  - each port kernel's launches and device time per launch, which exclude
    the host-side wrapper cost that ``chip_smoke.py``'s event timings of
    single calls include;
  - every kind of device copy and memset, with its count (a device-to-host
    copy is a point where the host waited for the device);
  - the ten device operations that took the most device time, by their whole
    kernel names, and, with ``--montecarlo``, the ten torch operators whose
    kernels took the most, each with the input shapes it ran on
    (``record_shapes`` adds host work to every op, so the other profiles,
    whose walls and busy shares it would move, are taken without it).

With ``--consolidation`` the profiled call is instead a warm multi-node
consolidation of that 5,000-node cluster (``CudaConsolidationSearch.
compute_command``, every node a candidate, no pending pods: phase 4 of
``chip_smoke.py``: each pass's 64 lanes the batch axis of one scan),
traced with the CUDA activity only; its stage split replaces the solve's,
and the device's busy share is over the wall time of the call and over
its sweep passes.

With ``--churn`` the profiled call is one warm delta tick of the
incremental session on that backlog (phase 5 (a) of ``chip_smoke.py``,
``KC_PIPELINE=0``):
the session is seeded with a full solve and runs four ticks of
``testing.workloads.churn_tick`` unprofiled, then the fifth (a 512-slot
window) under the profiler.  It reports the tick's stage split (plan,
dispatch, repair, decode), its host reads (device-to-host copies and the
scan's skip decisions), the device's busy share of the tick and each
kernel's device time, K10-K12 included.  ``--pipeline`` profiles the same
fifth tick deferred, with carry donation (phase 10 (b)): its dispatch, the
settle and the decode, K21 and K22 in place of K10 and K12 (K21 is K10's
device function with its outputs on its inputs, so it reports as
``repair_free``).

With ``--policy`` the profiled solve is the main path under
``PolicyConfig(enabled=True)`` after the policy benchmark's price move
(phase 6 (a) of ``chip_smoke.py``), with ``KC_ENCODE_DEVICE_FINISH=1``, so
K13's three launches and K15 run in it; ``objective_s`` is its
``decode.objective`` stage.

With ``--relax`` the profiled solve is that backlog after the same price
move under ``PolicyConfig(enabled=True, solver_mode="relax")`` (phase 7 (a)
of ``chip_smoke.py``): ``relax_core`` (K3 and K1 once each, the class
their batch axis, K14, K16-K18),
one host read of its verdict (``relax_s`` ends there), the scan's repair of
the leftover at full width and the policy decode.

With ``--tenants`` the profiled call is the coalesced multi-tenant solve
(phase 8 (a) of ``chip_smoke.py``): eight tenants of 50,000 to 43,000 pods
of the headline mix, one shape bucket, prepared once and run as ONE batched
dispatch (``service.tenant.BatchCoalescer._run_batched``, the tenant
plane's batched program); beside it, traced the same way, tenant 0's solo
``run_prepared``.  It reports both walls, host reads, device operations,
busy shares, each kernel's device time per launch, and the batched call's
peak device memory.

With ``--montecarlo`` the profiled call is the Monte-Carlo what-if study
(phase 9 (b) of ``chip_smoke.py``): ``parallel.mesh.monte_carlo_solve`` of
that backlog at 1,024 replicas, spot offerings interrupted at rate 0.3
(seed 0), after one unprofiled study.  It reports the wall, the chunking
(replicas a chunk, each chunk's host reads), the peak device memory, the
busy share and each kernel's device time, K19 and K20 included, with K1's
device time a launch and K20's a call (its rank and its study kernel) on
lines of their own.

``--trace`` also writes the Chrome trace.  Needs one card; refuses to run
without one.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

PORT_KERNELS = {
    "it_capacity_kernel": "it_capacity",
    "fill_priority_kernel": "fill_priority",
    "req_merge_kernel": "req_merge",
    "req_compat_kernel": "req_merge (compat)",
    "pack_bool_kernel": "pack_bool",
    "existing_intake_kernel": "existing_intake",
    "existing_mask_kernel": "existing_phase (mask)",
    "existing_mask_fill_kernel": "existing_phase (mask_fill)",
    "existing_commit_kernel": "existing_phase (commit)",
    "spread_quota_kernel": "spread_quota",
    "sweep_lanes_kernel": "sweep_lanes",
    "lane_finish_kernel": "lane_finish",
    "repair_free_kernel": "repair_free",
    "repair_gather_kernel": "repair_gather",
    "repair_scatter_kernel": "repair_scatter",
    "repair_scatter_inplace_kernel": "repair_scatter_inplace",
    "cell_scores_kernel": "select_offerings (scores)",
    "select_kernel": "select_offerings (select)",
    "fleet_sum_kernel": "select_offerings (sums)",
    "class_finish_kernel": "class_finish",
    "relax_cost_kernel": "relax_cost",
    "simplex_pgd_kernel": "simplex_pgd",
    "relax_round_kernel": "relax_round (round)",
    "relax_cost_sum_kernel": "relax_round (relaxed_cost)",
    "materialize_groups_kernel": "relax_materialize (groups)",
    "materialize_slots_kernel": "relax_materialize (slots)",
    "perturb_avail_kernel": "perturb_avail",
    "replica_finish_kernel": "replica_finish",
    "replica_rank_kernel": "replica_finish (rank)",
    "slot_commit_kernel": "slot_commit",
}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, name, None)
        if value is not None:
            return float(value)
    return 0.0


def device_summary(prof) -> dict:
    """The profiled window's device work: busy microseconds, the port's
    kernels, copies and memsets, the ten heaviest operations."""
    # device-side events only (kernels, copies, memsets): the host ops that
    # launched them carry the same device time, which would count it twice
    device_events = [
        e for e in prof.key_averages()
        if str(getattr(e, "device_type", "")).endswith("CUDA") and _device_us(e) > 0
    ]
    kernels = {}
    for evt in device_events:
        for prefix, name in PORT_KERNELS.items():
            if prefix in evt.key:
                rec = kernels.setdefault(name, {"launches": 0, "device_us": 0.0})
                rec["launches"] += evt.count
                rec["device_us"] += _device_us(evt)
    for rec in kernels.values():
        rec["device_us_per_launch"] = rec["device_us"] / max(rec["launches"], 1)
    copies = {}
    for evt in device_events:
        if evt.key.startswith("Memcpy") or evt.key.startswith("Memset"):
            rec = copies.setdefault(evt.key, {"count": 0, "device_us": 0.0})
            rec["count"] += evt.count
            rec["device_us"] += _device_us(evt)
    top = sorted(device_events, key=_device_us, reverse=True)[:10]
    return {
        "device_busy_us": sum(_device_us(e) for e in device_events),
        "device_ops": sum(e.count for e in device_events),
        "port_kernels": kernels,
        "copies": copies,
        "top_device_ops": [
            {"op": e.key, "count": e.count, "device_us": _device_us(e)} for e in top
        ],
        "top_host_ops": top_host_ops(prof),
    }


def top_host_ops(prof) -> list:
    """The ten torch operators (by name and input shapes) whose own kernels
    took the most device time; empty when the profile traced no CPU side or
    recorded no shapes."""
    ops = [
        e for e in prof.key_averages(group_by_input_shape=True)
        if not str(getattr(e, "device_type", "")).endswith("CUDA") and _device_us(e) > 0
        and getattr(e, "input_shapes", None)
    ]
    top = sorted(ops, key=_device_us, reverse=True)[:10]
    return [{"op": e.key, "input_shapes": [list(s) if isinstance(s, (list, tuple)) else s
                                           for s in e.input_shapes],
             "count": e.count, "device_us": _device_us(e)} for e in top]


def profile_consolidation(prof_factory, smi: str) -> tuple:
    """(profiler, report) of a warm multi-node consolidation of the
    5,000-node cluster."""
    from karpenter_core_tpu_torch.ops import solve as solve_ops
    from karpenter_core_tpu_torch.solver.consolidation import CudaConsolidationSearch
    from karpenter_core_tpu_torch.testing.workloads import (
        build_cluster,
        build_provider,
        consolidation_candidates,
    )

    state_nodes, bound_pods = build_cluster(5000, 1000, 5, 0.6, 2024)
    candidates = consolidation_candidates(state_nodes, bound_pods, 1000, 5)
    search = CudaConsolidationSearch(*build_provider(1000, 5))
    search.compute_command(candidates, [], state_nodes, bound_pods)  # warm-up
    torch.cuda.synchronize()
    solve_ops.host_syncs = 0
    with prof_factory() as prof:
        t0 = time.perf_counter()
        cmd = search.compute_command(candidates, [], state_nodes, bound_pods)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = device_summary(prof)
    return prof, {
        "card": smi, "path": "consolidation", "wall_s": wall, **search.stages,
        "passes": [len(sizes) for sizes, _ in search.passes],
        "action": cmd.action.value, "nodes_removed": len(cmd.nodes_to_remove),
        "host_syncs": solve_ops.host_syncs,
        "device_busy_share_of_call": summary["device_busy_us"] / 1e6 / wall,
        "device_busy_share_of_sweep_s": summary["device_busy_us"] / 1e6 / sum(
            search.stages["sweep_s"]),
        **summary,
    }


def profile_churn(prof_factory, smi: str, pipelined: bool = False) -> tuple:
    """(profiler, report) of one warm delta tick of the headline backlog
    under 2 % churn: serial (KC_PIPELINE=0, K10 and K12), or deferred with
    carry donation (K21 and K22), its dispatch, settle and decode."""
    os.environ["KC_PIPELINE"] = "1" if pipelined else "0"
    from karpenter_core_tpu_torch.models.columnar import PodIngest
    from karpenter_core_tpu_torch.ops import solve as solve_ops
    from karpenter_core_tpu_torch.solver.incremental import (
        FallbackPolicy,
        IncrementalSolveSession,
    )
    from karpenter_core_tpu_torch.testing.workloads import build_inputs, churn_tick

    solver, pods = build_inputs(50_000, 1000, 5)
    ingest = PodIngest()
    ingest.add_all(pods)
    session = IncrementalSolveSession(
        solver, FallbackPolicy(enabled=True, audit_interval=0, max_delta_fraction=0.5))
    session.solve(ingest)
    reps = {}
    for tick in range(4):  # warm-up ticks, both window sizes
        churn_tick(ingest, tick, reps)
        session.solve(ingest)
    churn_tick(ingest, 4, reps)
    torch.cuda.synchronize()
    solve_ops.host_syncs = 0
    with prof_factory() as prof:
        t0 = time.perf_counter()
        if pipelined:
            session.solve(ingest, deferred=True).result()
        else:
            session.solve(ingest)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if session.last_mode != "delta":
        print(f"FAIL: the profiled tick was {session.last_mode} ({session.last_reason})",
              file=sys.stderr)
        sys.exit(1)
    summary = device_summary(prof)
    d2h = sum(rec["count"] for key, rec in summary["copies"].items() if "DtoH" in key)
    return prof, {
        "card": smi, "path": "pipeline" if pipelined else "churn", "wall_s": wall,
        **session.stages,
        **session.last_evicted, "window": len(session.last_window[0]),
        "host_syncs": solve_ops.host_syncs, "device_to_host_copies": d2h,
        "device_busy_share_of_tick": summary["device_busy_us"] / 1e6 / wall,
        **summary,
    }


def profile_tenants(prof_factory, smi: str) -> tuple:
    """(profiler, report) of the batched dispatch of eight headline tenants,
    beside tenant 0's solo dispatch."""
    from karpenter_core_tpu_torch.models.columnar import PodIngest
    from karpenter_core_tpu_torch.ops import solve as solve_ops
    from karpenter_core_tpu_torch.service import tenant as tenant_mod
    from karpenter_core_tpu_torch.testing.workloads import build_inputs

    counts = (50_000, 49_000, 48_000, 47_000, 46_000, 45_000, 44_000, 43_000)
    solvers, preps = [], []
    for n in counts:
        solver, pods = build_inputs(n, 1000, 5)
        ingest = PodIngest()
        ingest.add_all(pods)
        solvers.append(solver)
        preps.append(solver.prepare_encoded(solver.encode(ingest)))
    keys = {tenant_mod.bucket_key(p) for p in preps}
    if len(keys) != 1:
        print(f"FAIL: the tenants span {len(keys)} shape buckets", file=sys.stderr)
        sys.exit(1)
    reports = {}
    prof = None
    for label, call in (
        ("solo", lambda: solvers[0].run_prepared(preps[0])),
        ("batched", lambda: tenant_mod.BatchCoalescer._run_batched(preps)),
    ):
        call()  # warm-up
        torch.cuda.synchronize()
        solve_ops.host_syncs = 0
        torch.cuda.reset_peak_memory_stats()
        with prof_factory() as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        summary = device_summary(prof)
        d2h = sum(rec["count"] for key, rec in summary["copies"].items() if "DtoH" in key)
        reports[label] = {
            "wall_s": wall, "host_syncs": solve_ops.host_syncs, "device_to_host_copies": d2h,
            "device_busy_share_of_call": summary["device_busy_us"] / 1e6 / wall,
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(), **summary,
        }
    return prof, {"card": smi, "path": "tenants", "tenants": len(counts), "pods": list(counts),
                  "slots": preps[0].n_slots, **reports}


def profile_montecarlo(prof_factory, smi: str) -> tuple:
    """(profiler, report) of a warm 1,024-replica Monte-Carlo study of the
    headline backlog."""
    from karpenter_core_tpu_torch.models.columnar import PodIngest
    from karpenter_core_tpu_torch.ops import solve as solve_ops
    from karpenter_core_tpu_torch.parallel import mesh
    from karpenter_core_tpu_torch.testing.workloads import build_inputs

    solver, pods = build_inputs(50_000, 1000, 5)
    ingest = PodIngest()
    ingest.add_all(pods)
    snapshot = solver.encode(ingest)
    chunks = []
    batched = solve_ops.solve_core_batched

    def counted(*args, **kwargs):
        before = solve_ops.host_syncs
        out = batched(*args, **kwargs)
        chunks.append((int(out.failed.shape[0]), solve_ops.host_syncs - before))
        return out

    def study():
        return mesh.monte_carlo_solve(snapshot, 1024, seed=0, interruption_rate=0.3)

    study()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    solve_ops.solve_core_batched = counted
    try:
        with prof_factory() as prof:
            t0 = time.perf_counter()
            result = study()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        solve_ops.solve_core_batched = batched
    summary = device_summary(prof)
    d2h = sum(rec["count"] for key, rec in summary["copies"].items() if "DtoH" in key)
    kern = summary["port_kernels"]
    k20 = [kern.get(k, {}) for k in ("replica_finish", "replica_finish (rank)")]
    return prof, {
        "card": smi, "path": "montecarlo", "replicas": 1024, "wall_s": wall,
        # K1's launches span the chunks' sizes (147 and 142 replicas); K20's
        # call is its rank and its study launch
        "it_capacity_device_us_per_launch": kern.get("it_capacity", {}).get(
            "device_us_per_launch"),
        "replica_finish_device_us_per_call": sum(k.get("device_us", 0.0) for k in k20)
        / max(k20[0].get("launches", 0), 1),
        "replicas_per_chunk": [c[0] for c in chunks],
        "host_syncs_per_chunk": [c[1] for c in chunks], "device_to_host_copies": d2h,
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        "device_busy_share_of_call": summary["device_busy_us"] / 1e6 / wall,
        "cost_mean": result["cost_mean"], "failed_mean": result["failed_mean"], **summary,
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trace", default=None, help="write the Chrome trace here")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--existing", action="store_true",
                      help="solve into the live 5,000-node cluster of chip_smoke.py phase 3")
    mode.add_argument("--consolidation", action="store_true",
                      help="consolidate that cluster, as chip_smoke.py phase 4 does")
    mode.add_argument("--churn", action="store_true",
                      help="one warm delta tick under steady churn, as chip_smoke.py phase 5")
    mode.add_argument("--pipeline", action="store_true",
                      help="one deferred, donating delta tick, as chip_smoke.py phase 10 (b)")
    mode.add_argument("--policy", action="store_true",
                      help="the solve under the policy objective, as chip_smoke.py phase 6 (a), "
                           "with the class planes finished on the card")
    mode.add_argument("--relax", action="store_true",
                      help="the solve through the relax family, as chip_smoke.py phase 7 (a)")
    mode.add_argument("--tenants", action="store_true",
                      help="eight headline tenants in one batched dispatch, as chip_smoke.py "
                           "phase 8 (a), beside one solo dispatch")
    mode.add_argument("--montecarlo", action="store_true",
                      help="the 1,024-replica what-if study, as chip_smoke.py phase 9 (b)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from torch.profiler import ProfilerActivity, profile

    from karpenter_core_tpu_torch.kernels import build
    from karpenter_core_tpu_torch.models.columnar import PodIngest
    from karpenter_core_tpu_torch.ops import solve as solve_ops
    from karpenter_core_tpu_torch.policy import PolicyConfig
    from karpenter_core_tpu_torch.testing.workloads import (
        build_cluster,
        build_inputs,
        move_spot_market,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)
    build.build_all()
    if args.consolidation or args.churn or args.pipeline or args.tenants or args.montecarlo:
        if args.consolidation:
            prof, report = profile_consolidation(
                lambda: profile(activities=[ProfilerActivity.CUDA]), smi.stdout.strip())
        elif args.montecarlo:
            prof, report = profile_montecarlo(
                lambda: profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                record_shapes=True),
                smi.stdout.strip())
        elif args.tenants:
            prof, report = profile_tenants(
                lambda: profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]),
                smi.stdout.strip())
        else:
            prof, report = profile_churn(
                lambda: profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]),
                smi.stdout.strip(), pipelined=args.pipeline)
        print(json.dumps(report), flush=True)
        if args.trace:
            prof.export_chrome_trace(args.trace)
        return
    policy = None
    if args.policy or args.relax:
        policy = PolicyConfig(enabled=True, solver_mode="relax" if args.relax else "")
    solver, pods = build_inputs(50_000, 1000, 5, policy=policy)
    if policy is not None:
        move_spot_market(solver.cloud_provider)
    if args.policy:
        os.environ["KC_ENCODE_DEVICE_FINISH"] = "1"
    cluster = build_cluster(5000, 1000, 5, 0.6, 2024) if args.existing else ([], [])
    ingest = PodIngest()
    ingest.add_all(pods)
    solver.solve(ingest, *cluster)  # warm-up: lazy loads, allocator, encode caches
    torch.cuda.synchronize()

    solve_ops.host_syncs = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ingest = PodIngest()
        ingest.add_all(pods)
        t_ingest = time.perf_counter() - t0
        results = solver.solve(ingest, *cluster)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    placed = sum(len(n.pods) for n in results.new_nodes) + sum(
        len(v) for v in results.existing_assignments.values())
    if args.existing:
        ok = placed + len(results.failed_pods) + len(results.spread_residual_pods) == 50_000
    elif args.relax:  # the JAX package's answer (chip_smoke.py RELAX_HEADLINE)
        ok = (solver.last_solve_mode == "relax" and len(results.new_nodes) == 7142
              and not results.failed_pods)
    else:
        ok = len(results.new_nodes) == 7162 and not results.failed_pods
    if not ok:
        print(f"FAIL: {len(results.new_nodes)} nodes, {placed} placed, "
              f"{len(results.failed_pods)} failed", file=sys.stderr)
        sys.exit(1)

    summary = device_summary(prof)
    solve_window = wall - t_ingest
    print(json.dumps({
        "card": smi.stdout.strip(),
        "path": ("existing" if args.existing else "policy" if args.policy
                 else "relax" if args.relax else "cold"),
        "wall_s": wall, "ingest_s": t_ingest, **solver.stages,
        "host_syncs": solve_ops.host_syncs,
        "device_busy_us": summary["device_busy_us"],
        "device_busy_share_of_solve_call": summary["device_busy_us"] / 1e6 / solve_window,
        "device_busy_share_of_solve_s": summary["device_busy_us"] / 1e6 / solver.stages["solve_s"],
        **{k: v for k, v in summary.items() if k != "device_busy_us"},
    }), flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
