"""Where the time of one warm 50k-pod solve goes, on one CUDA card.

    python3 profile_solve.py [--trace PATH]

Builds the inputs of the main path (50,000 pods x 1,000 instance types x 5
provisioners, ``testing/workloads.py``), runs one solve to warm up, then
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
  - the ten device operations that took the most device time.

``--trace`` also writes the Chrome trace.  Needs one card; refuses to run
without one.
"""

import argparse
import json
import subprocess
import sys
import time

import torch

PORT_KERNELS = {
    "it_capacity_kernel": "it_capacity",
    "fill_priority_kernel": "fill_priority",
    "req_merge_kernel": "req_merge",
    "pack_bool_kernel": "pack_bool",
}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, name, None)
        if value is not None:
            return float(value)
    return 0.0


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trace", default=None, help="write the Chrome trace here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from torch.profiler import ProfilerActivity, profile

    from karpenter_core_tpu_torch.kernels import build
    from karpenter_core_tpu_torch.models.columnar import PodIngest
    from karpenter_core_tpu_torch.ops import solve as solve_ops
    from karpenter_core_tpu_torch.testing.workloads import build_inputs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)
    build.build_all()
    solver, pods = build_inputs(50_000, 1000, 5)
    ingest = PodIngest()
    ingest.add_all(pods)
    solver.solve(ingest)  # warm-up: lazy loads, allocator, encode caches
    torch.cuda.synchronize()

    solve_ops.host_syncs = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ingest = PodIngest()
        ingest.add_all(pods)
        t_ingest = time.perf_counter() - t0
        results = solver.solve(ingest)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if len(results.new_nodes) != 7162 or results.failed_pods:
        print(f"FAIL: {len(results.new_nodes)} nodes, {len(results.failed_pods)} failed",
              file=sys.stderr)
        sys.exit(1)

    # device-side events only (kernels, copies, memsets): the host ops that
    # launched them carry the same device time, which would count it twice
    device_events = [
        e for e in prof.key_averages()
        if str(getattr(e, "device_type", "")).endswith("CUDA") and _device_us(e) > 0
    ]
    device_us = sum(_device_us(e) for e in device_events)
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
    solve_window = wall - t_ingest
    print(json.dumps({
        "card": smi.stdout.strip(),
        "wall_s": wall, "ingest_s": t_ingest, **solver.stages,
        "host_syncs": solve_ops.host_syncs,
        "device_busy_us": device_us,
        "device_busy_share_of_solve_call": device_us / 1e6 / solve_window,
        "device_ops": sum(e.count for e in device_events),
        "port_kernels": kernels,
        "copies": copies,
        "top_device_ops": [
            {"op": e.key[:80], "count": e.count, "device_us": _device_us(e)} for e in top
        ],
    }), flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
