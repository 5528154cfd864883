"""Smoke run of the port on one CUDA card: the cold 50k-pod provisioning solve.

    python3 chip_smoke.py

Builds the four hand-written CUDA kernels from ``karpenter_core_tpu_torch/
csrc`` (one nvcc per source, all at once), then:

  1. main path — 50,000 pending pods x 1,000 instance types x 5 provisioners
     (the reference benchmark's makeDiversePods mix) through
     ``CudaSolver.solve``, cold and warm, with the stage split.  Every pod
     must land, on exactly 7,162 new nodes: the JAX package's answer on the
     same inputs, measured on the CPU.  Every ``SolveOutputs`` leaf must equal
     the same solve run with ``use_kernels=False`` (the kernels' plain torch
     twins) on the card, and every kernel must have launched in the cold run
     (launch counters are zeroed just before it and read just after).
  2. kernels — each kernel against its plain twin on the card, on inputs
     taken from the main path's final state (its real shapes), plus a small
     bounded-keys case for K1 and a hole-preference case for K2; equality is
     exact.  Each is timed (median of CUDA-event timings) beside its plain
     twin and its bound: bytes it must move over 3.35 TB/s, or operations
     over 67 T/s, whichever is larger (H100 SXM data-sheet peaks at 700 W).
     No single PyTorch call computes any of the four, so ``library_ms`` is
     null.

Prints the card's name and power limit, the kernel build time, one JSON
line of kernel records, and last ``{"ok": true, "device": {...}}``.  Any
failed check exits non-zero before that line.  Needs one card; refuses to
run without one.
"""

import json
import statistics
import subprocess
import sys
import time

import torch

# the JAX package's answer on the same inputs (50,000 pods x 1,000 types x 5
# provisioners), measured on the CPU: every pod placed on 7,162 new nodes
EXPECTED_NODES = 7162
N_PODS, N_TYPES, N_PROVISIONERS = 50_000, 1000, 5

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12  # H100 SXM non-tensor float32 rate


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of one call, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*tensors) -> int:
    total = 0
    for t in tensors:
        if isinstance(t, tuple):
            total += nbytes(*t)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def flatten(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for e in x for t in flatten(e)]


def max_abs_err(got, want) -> float:
    """Largest |kernel - plain| over every output; inf on a shape/dtype clash."""
    err = 0.0
    for a, b in zip(flatten(got), flatten(want)):
        if a.shape != b.shape or a.dtype != b.dtype:
            return float("inf")
        if not torch.equal(a, b):
            both_nan = torch.isnan(a) & torch.isnan(b) if a.is_floating_point() else None
            diff = (a.double() - b.double()).abs()
            if both_nan is not None:
                diff = torch.where(both_nan, 0.0, diff)
            diff = torch.where(torch.isnan(diff), float("inf"), diff)
            err = max(err, float(diff.max()))
    return err


def leaves(outputs) -> dict:
    out = {}
    for name in ("assign", "assign_existing", "failed", "spread_suspect", "remaining"):
        out[name] = getattr(outputs, name)
    for group in ("state", "ex_state", "topo"):
        tup = getattr(outputs, group)
        for f in tup._fields:
            out[f"{group}.{f}"] = getattr(tup, f)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from karpenter_core_tpu_torch.kernels import build, capacity, fill, packbits, reqmerge
    from karpenter_core_tpu_torch.models.columnar import PodIngest
    from karpenter_core_tpu_torch.ops import masks as mask_ops
    from karpenter_core_tpu_torch.ops import solve as solve_ops
    from karpenter_core_tpu_torch.testing.workloads import build_inputs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    build_s = build.build_all()
    print(f"kernel build: {build_s:.2f} s (4 sources, parallel nvcc)", flush=True)
    for name in build.SOURCES:
        build.load(name)

    # -- 1. main path --------------------------------------------------------
    solver, pods = build_inputs(N_PODS, N_TYPES, N_PROVISIONERS)
    modules = (capacity, fill, reqmerge, packbits)
    for mod in modules:
        mod.launches = 0
    solve_ops.host_syncs = 0
    runs = []
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        ingest = PodIngest()
        ingest.add_all(pods)
        ingest_s = time.perf_counter() - t0
        results = solver.solve(ingest)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        runs.append((label, ingest_s, dict(solver.stages), total_s, results))
        if label == "cold":
            launches = {mod.__name__.rsplit(".", 1)[-1]: mod.launches for mod in modules}
            syncs = solve_ops.host_syncs
    for label, ingest_s, stages, total_s, results in runs:
        scheduled = sum(len(n.pods) for n in results.new_nodes)
        print(json.dumps({
            "run": label, "wall_s": total_s, "ingest_s": ingest_s, **stages,
            "scheduled": scheduled, "failed": len(results.failed_pods),
            "residual": len(results.spread_residual_pods), "nodes": len(results.new_nodes),
            "slots": int(solver.last_outputs.assign.shape[1]),
        }), flush=True)
        if scheduled != N_PODS or results.failed_pods or results.spread_residual_pods:
            fail(f"{label}: scheduled {scheduled} of {N_PODS}, failed {len(results.failed_pods)}")
        if len(results.new_nodes) != EXPECTED_NODES:
            fail(f"{label}: {len(results.new_nodes)} nodes, expected {EXPECTED_NODES}")
    print(json.dumps({"cold_run_launches": launches, "cold_run_host_syncs": syncs}), flush=True)
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} never launched on the main path")
    kernel_out = solver.last_outputs

    plain_solver, _ = build_inputs(N_PODS, N_TYPES, N_PROVISIONERS, use_kernels=False)
    ingest = PodIngest()
    ingest.add_all(pods)
    t0 = time.perf_counter()
    plain_res = plain_solver.solve(ingest)
    torch.cuda.synchronize()
    print(json.dumps({"run": "plain twins (use_kernels=False)",
                      "wall_s": time.perf_counter() - t0, **plain_solver.stages,
                      "nodes": len(plain_res.new_nodes)}), flush=True)
    want = leaves(plain_solver.last_outputs)
    for name, got in leaves(kernel_out).items():
        if got.shape != want[name].shape or got.dtype != want[name].dtype or not torch.equal(
                got, want[name]):
            fail(f"SolveOutputs.{name} differs between the kernels and their plain twins")
    print("main path: every SolveOutputs leaf equals the plain-twin solve", flush=True)

    # -- 2. kernels against their plain twins, at the main path's shapes ------
    state = kernel_out.state
    prep = solver.prepare_encoded(solver.encode(ingest))
    st = solve_ops.StaticArrays(*prep.statics_arrays)
    v = st.valid.shape[-1]
    st = st._replace(it=mask_ops.pack_req(st.it), valid=mask_ops.pack_mask(st.valid))
    cls0 = solve_ops.ClassTensors(*(t[0] for t in prep.cls))
    cls0 = cls0._replace(mask=mask_ops.pack_mask(cls0.mask))
    cls_req = mask_ops.ReqTensor(cls0.mask[None], cls0.defined[None], cls0.negative[None],
                                 cls0.gt[None], cls0.lt[None])
    node_req = mask_ops.ReqTensor(state.kmask, state.kdef, state.kneg, state.kgt, state.klt)
    khb = prep.key_has_bounds
    records = []

    def record(name, source, replaces, launches_n, kernel_fn, plain_fn, moved, ops):
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0.0:
            fail(f"{name}: kernel differs from its plain twin (max_abs_err {err})")
        rec = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches_n, "max_abs_err": err,
            "ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn),
            "bound_ms": max(moved / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S) * 1e3,
            "bound_by": "bytes" if moved / HBM_BYTES_PER_S >= ops / SCALAR_OPS_PER_S
            else "operations",
            "library_ms": None,
        }
        records.append(rec)
        print(f"{name}: ms {rec['ms']:.4f} plain_ms {rec['plain_ms']:.4f} "
              f"bound_ms {rec['bound_ms']:.5f} ({rec['bound_by']}) exact", flush=True)
        return got

    # K3 merge + compat of class 0 into every final slot
    merged, _ = record(
        "req_merge", "karpenter_core_tpu_torch/csrc/req_merge.cu",
        "karpenter_core_tpu/ops/solve.py:312", launches["reqmerge"],
        lambda: reqmerge.merge_compat(node_req, cls_req, st.valid, st.vocab_ints,
                                      st.is_custom, v, khb),
        lambda: reqmerge.merge_compat_plain(node_req, cls_req, st.valid, st.vocab_ints,
                                            st.is_custom, v, khb),
        nbytes(node_req, cls_req, st.valid, st.vocab_ints, st.is_custom) * 2,
        state.kmask.numel() * 8,
    )
    # K1 viability + capacity of class 0 over every final slot x type
    zone_ok = state.zone & cls0.zone[None, :]
    ct_ok = state.ct & cls0.ct[None, :]
    k1_args = (state.viable, cls0.it, merged, st.it, st.vocab_ints, v, khb, zone_ok, ct_ok,
               st.it_avail, state.used, cls0.requests, st.it_alloc)
    n_slots, n_types = state.viable.shape
    _, cap_ni, cap_n = record(
        "it_capacity", "karpenter_core_tpu_torch/csrc/it_capacity.cu",
        "karpenter_core_tpu/ops/solve.py:334", launches["capacity"],
        lambda: capacity.it_capacity(*k1_args), lambda: capacity.it_capacity_plain(*k1_args),
        nbytes(*[a for a in k1_args if isinstance(a, (torch.Tensor, tuple))])
        + n_slots * n_types * 5 + n_slots * 4,
        n_slots * n_types * (st.it.mask.shape[1] * 6 + 12 + 4 * st.it_alloc.shape[1]),
    )
    # K2 priority fill of class 0's count over the K1 caps
    priority = state.pod_count * n_slots + torch.arange(n_slots, dtype=torch.int32, device="cuda")
    priority = torch.where(cap_n > 0, priority, 2**31 - 1)
    quota = torch.tensor(int(cls0.count) if int(cls0.count) > 0 else 1000, dtype=torch.int32,
                         device="cuda")
    record(
        "fill_priority", "karpenter_core_tpu_torch/csrc/fill_priority.cu",
        "karpenter_core_tpu/ops/solve.py:419", launches["fill"],
        lambda: fill.fill_by_priority(quota, cap_n, priority),
        lambda: fill.fill_by_priority_plain(quota, cap_n, priority),
        nbytes(quota, cap_n, priority) + n_slots * 4,
        n_slots * 32 * 4,
    )
    # K4 bit-pack of the final viable plane
    record(
        "pack_bool", "karpenter_core_tpu_torch/csrc/pack_bool.cu",
        "karpenter_core_tpu/ops/solve.py:2121", launches["packbits"],
        lambda: packbits.pack_bool(state.viable), lambda: packbits.pack_bool_plain(state.viable),
        nbytes(state.viable) + n_slots * ((n_types + 7) // 8),
        n_slots * n_types * 2,
    )

    # extra cases: K1 with bounded keys (finite and infinite bounds) and a
    # zero-request class; K2 with warm-repair hole preferences
    gen = torch.Generator(device="cpu").manual_seed(7)

    def rand_req(rows, k, words, bounded):
        mask = torch.randint(-2**31, 2**31 - 1, (rows, k, words), generator=gen, dtype=torch.int64)
        mask = mask.to(torch.int32) & mask_ops.const_words("full", 40, "cpu")
        gt = torch.where(torch.rand((rows, k), generator=gen) < 0.5,
                         torch.randint(-3, 5, (rows, k), generator=gen).float(), float("-inf"))
        lt = torch.where(torch.rand((rows, k), generator=gen) < 0.5,
                         torch.randint(0, 12, (rows, k), generator=gen).float(), float("inf"))
        if not bounded:
            gt, lt = torch.full_like(gt, float("-inf")), torch.full_like(lt, float("inf"))
        return mask_ops.ReqTensor(mask.cuda(), (torch.rand((rows, k), generator=gen) < 0.6).cuda(),
                                  (torch.rand((rows, k), generator=gen) < 0.3).cuda(),
                                  gt.cuda(), lt.cuda())

    for size in ([0.25, 0.0, 1.0], [0.0, 0.0, 0.0]):
        rows, types, k = 64, 40, 3
        vi = torch.where(torch.rand((k, 39), generator=gen) < 0.7,
                         torch.randint(0, 10, (k, 39), generator=gen).float(), float("inf")).cuda()
        args = (
            (torch.rand((rows, types), generator=gen) < 0.9).cuda(),
            (torch.rand(types, generator=gen) < 0.9).cuda(),
            rand_req(rows, k, 2, True), rand_req(types, k, 2, True), vi, 40, (True, False, True),
            (torch.rand((rows, 3), generator=gen) < 0.6).cuda(),
            (torch.rand((rows, 2), generator=gen) < 0.6).cuda(),
            (torch.rand((types, 3, 2), generator=gen) < 0.5).cuda(),
            (torch.randint(0, 20, (rows, 3), generator=gen).float() * 0.25).cuda(),
            torch.tensor(size, device="cuda"),
            (torch.randint(0, 64, (types, 3), generator=gen).float() * 0.5).cuda(),
        )
        err = max_abs_err(capacity.it_capacity(*args), capacity.it_capacity_plain(*args))
        if err != 0.0:
            fail(f"it_capacity (bounded keys, size {size}) differs: {err}")
    pref = torch.randint(0, 3, (n_slots,), generator=gen, dtype=torch.int32).cuda()
    got = solve_ops._fill_with_pref(solve_ops.KERNELS, quota, cap_n, priority, pref)
    want = solve_ops._fill_with_pref(solve_ops.PLAIN, quota, cap_n, priority, pref)
    if not torch.equal(got, want):
        fail("fill_priority with hole preferences differs from its plain twin")
    print("extra cases exact: it_capacity bounded keys + zero-request class; "
          "fill_priority with preferences", flush=True)

    print("library_ms: null for all four — no single PyTorch call computes any of "
          "them", flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
