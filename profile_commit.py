"""K23 (`slot_commit`) alone, on the what-if study's phase commits, on one CUDA card.

    python3 profile_commit.py [--tree DIR] [--variant LABEL OLD NEW] ...

Builds the inputs of ``chip_smoke.py`` phase 9's replica axis: the headline
backlog (50,000 pods x 1,000 instance types x 5 provisioners), the first
147 replicas of its study at spot interruption rate 0.3 (seed 0), and one
batched scan of them with the slot commit spied on
(``chip_smoke.captured_commits``): the phase commit that took the most rows
and the one that took the fewest; and, as ``chip_smoke.py``'s kernel line
does, the commit that took the most rows in a warm solve of that backlog
(the cold path, B = 1).  On each it prints one JSON line with
the commit's row counts, its bound (``chip_smoke.slot_commit_work``) and
K23's ``ms`` and ``device_ms`` (``chip_smoke.time_ms`` / ``device_ms``, the
kernel writing into a clone of the captured state that is restored before
each call), and whether its outputs equal the twin's.  Beside the heaviest
commit it times a ``fill_`` of as many bytes as that commit's bound counts,
a yardstick of the card's write rate that the port never calls.

``--tree DIR`` takes the port's package from another checkout (a parent
commit unpacked with ``git archive``); the helpers stay this checkout's.
Each ``--variant LABEL OLD NEW`` also times a build of that tree's
``csrc/slot_commit.cu`` with the text OLD replaced by NEW (for instance one
kind of block compiled out), loaded in place of the real library; a
variant's outputs need not equal the twin's, and its line says whether
they do.  Needs one card; refuses to run without one.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPLICAS = 147  # chip_smoke.py's largest chunk of the 1,024-replica study
RATE = 0.3


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variant(build, label: str, old: str, new: str) -> str:
    """The tree's K23 source with ``old`` replaced by ``new``, compiled into
    the tree's build directory; returns the library's path."""
    with open(os.path.join(build.CSRC, "slot_commit.cu")) as f:
        text = f.read()
    if old not in text:
        raise SystemExit(f"variant {label}: the source has no {old!r}")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    src = os.path.join(build.BUILD_DIR, f"slot_commit_{label}.cu")
    with open(src, "w") as f:
        f.write(text.replace(old, new))
    out = os.path.join(build.BUILD_DIR, f"slot_commit_{label}.so")
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"variant {label}: nvcc failed\n{proc.stdout}{proc.stderr}")
    return out


def use_library(build, path) -> None:
    """Bind K23's entry point to the library at ``path`` (None: the real one)."""
    build._fns.pop(("slot_commit", "kc_slot_commit"), None)
    build._libs.pop("slot_commit", None)
    if path is not None:
        build._libs["slot_commit"] = ctypes.CDLL(path)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=HERE, help="checkout whose port package is timed")
    parser.add_argument("--variant", nargs=3, action="append", default=[],
                        metavar=("LABEL", "OLD", "NEW"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.abspath(args.tree))
    smoke = load_smoke()
    from karpenter_core_tpu_torch.kernels import batch, build
    from karpenter_core_tpu_torch.models.columnar import PodIngest
    from karpenter_core_tpu_torch.ops import solve as solve_ops
    from karpenter_core_tpu_torch.parallel import mesh
    from karpenter_core_tpu_torch.testing.workloads import build_inputs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"tree": os.path.abspath(args.tree), "torch": torch.__version__}), flush=True)
    build.build_all()
    solver, pods = build_inputs(50_000, 1000, 5)

    def fresh_ingest():
        ingest = PodIngest()
        ingest.add_all(pods)
        return ingest

    solver.solve(fresh_ingest())  # warm-up
    cold = smoke.captured_commits(lambda: solver.solve(fresh_ingest()))["most"]
    snapshot = solver.encode(fresh_ingest())
    cls, sa, khb = mesh.prepared(snapshot, "cuda")
    avail = mesh.perturb_spot_availability(snapshot, REPLICAS, 0, RATE)
    cls_b, sa_b = batch.repeat((cls, sa), REPLICAS)
    sa_b = sa_b._replace(it_avail=avail.contiguous())
    n_slots = solve_ops.estimate_slots(snapshot)
    commits = smoke.captured_commits(lambda: solve_ops.solve_core_batched(
        cls_b, sa_b, n_slots, khb, n_passes=snapshot.scan_passes,
        features=solve_ops.snapshot_features(snapshot)), phase_only=True)
    del cls_b, sa_b
    commits["cold"] = cold
    torch.cuda.synchronize()
    variants = [("kernel", None)] + [(label, build_variant(build, label, old, new))
                                      for label, old, new in args.variant]
    moved, _, _ = smoke.slot_commit_work(*commits["most"])
    buf = torch.empty(moved, dtype=torch.uint8, device="cuda")
    fill = lambda: buf.fill_(1)  # noqa: E731
    wall = smoke.time_ms(fill)
    print(json.dumps({"card": smi, "yardstick": "fill_", "bytes": moved, "ms": wall,
                      "device_ms": smoke.device_ms(fill, wall)[0]}), flush=True)
    del buf
    for label, path in variants:
        use_library(build, path)
        for which, captured in commits.items():
            moved, ops, shapes = smoke.slot_commit_work(*captured)
            kernel, twin, reset = smoke.commit_calls(captured, in_place=False)
            reset()
            exact = smoke.max_abs_err(kernel(), twin()) == 0.0
            wall = smoke.time_ms(kernel, reset=reset)
            dev, queued = smoke.device_ms(kernel, wall, reset=reset)
            print(json.dumps({"card": smi, "variant": label, "commit": which, **shapes,
                              "exact": exact, "ms": wall, "device_ms": dev, "queued": queued,
                              **smoke.bound(moved, ops)}), flush=True)
            del kernel, twin, reset
            torch.cuda.empty_cache()
    use_library(build, None)


if __name__ == "__main__":
    main()
