"""Smoke run of the port on one CUDA card: the provisioning solve, cold
into an empty cluster and into a live 5,000-node cluster, multi-node
consolidation of that cluster, the warm repair under steady churn, the
policy objective, the relax solver family, the coalesced multi-tenant
solve, the what-if studies and the pipelined churn tick.

    python3 chip_smoke.py

Builds the twenty-three hand-written CUDA kernels from the twenty-one sources
in ``karpenter_core_tpu_torch/csrc`` (one nvcc per source, all at once), then:

  1. cold path — 50,000 pending pods x 1,000 instance types x 5 provisioners
     (the reference benchmark's makeDiversePods mix) through
     ``CudaSolver.solve``, cold and warm, with the stage split.  Every pod
     must land, on exactly 7,162 new nodes: the JAX package's answer on the
     same inputs, measured on the CPU.  Every ``SolveOutputs`` leaf must equal
     the same solve run with ``use_kernels=False`` (the kernels' plain torch
     twins) on the card, and every kernel must have launched in the cold run
     (launch counters are zeroed just before it and read just after).  A
     further warm solve with ``KC_ENCODE_DEVICE_FINISH=1`` pads the class
     planes on the card (K15): every leaf must equal the host-padded solve's
     and K15 must have launched.
  2. kernels K1-K4, K15 and K23 — each against its plain twin on the card,
     on inputs taken from the cold path's final state and encode (their real
     shapes; K23 on the arguments of the commit that took the most rows in
     a further warm solve), plus a small bounded-keys case for K1, a hole-preference case
     for K2, K2 on a sorted input (the same caps with index priorities, as
     the existing-node fills give it: ``sorted_input`` in its record) and
     K2's multi-block path at N = 32,768 (the main path's plane four times
     over, and a quota whose int32 prefix sums wrap).
  3. existing-node path — first a mid-size solve (10,000 pods x 100 types
     into a 1,000-node cluster) whose counts must equal the JAX package's
     answer on the same inputs, measured on the CPU; then the same 50,000
     pods into a live cluster,
     ``testing.workloads.build_cluster(5000, 1000, 5, fill=0.6)`` (5,000
     initialized nodes at 60 % cpu requested, every tenth tainted), through
     ``CudaSolver.solve(ingest, state_nodes, bound_pods)``, cold and warm.
     Every leaf must equal the plain twins' scan on the warm solve's
     prepared planes (kept, not encoded again); every existing node's final
     usage must stay within its allocatable; no tainted node may take a pod;
     scheduled + failed + residual must be 50,000; every kernel K1-K7 must
     have launched in the cold run.  The warm outputs are decoded again
     under the policy objective (no re-solve): K13's selection must equal its
     twin's.  Then K5-K7 against their twins at this path's shapes (K6 as
     the fused mask and fill and the commit a phase without hole
     preferences launches; the mask alone, the single-node pin and a
     restricted phase through both mask entry points).

  4. consolidation path — multi-node consolidation with every node a
     candidate and no pending pods, through
     ``CudaConsolidationSearch.compute_command``: first the mid-size
     cluster of phase 3, whose command must equal the JAX package's answer
     on the same inputs, measured on the CPU (``MID_CONSOLIDATION``); then
     phase 3's 5,000-node cluster, whose command must stay DELETE 505
     (``FULL_CONSOLIDATION``).  Each pass runs its lanes as the batch axis
     of the scan, in chunks sized to the free memory; per pass the script
     prints the chunks, lanes, launches, host reads, ``sweep_s`` and peak
     memory.  The removed nodes must be a prefix of the candidate list, and
     the chosen prefix's lane must show no failed pod, no uninitialized node
     and at most one new node; every kernel of the path (K1-K3, K5-K9) must
     have launched in that run.  Every pass runs again with
     ``use_kernels=False``: every ``SweepOutputs`` leaf of every lane must
     equal the kernel run (``new_cost`` to rtol 1e-6, the one leaf whose f32
     sum the reference lets vary with reduction order), and three lanes of
     the coarse pass their solo ``solve_core``.  Then K8 and K9 against
     their twins at this path's shapes, and K3 and K6 on the coarse pass's
     lanes (B = 64 x the 6,144 existing rows, each lane's ``open_`` and
     counts from K8): K3's merge and its compat entry point, the fused mask
     and fill and the commit of that fill (``lane_axis`` in K3's and K6's
     records); and K23 on the slot commit that took the most rows in a
     kernel rerun of the coarse pass (``lane_axis`` in its record).  Each run pinned to a fresh JAX
     process's answer starts from an empty slot-count and feature-set
     history (``utils.compilecache.reset_memo``) and prints the slot counts
     it used.
  5. churn path — the incremental session's serial delta tick
     (``IncrementalSolveSession.solve`` under KC_PIPELINE=0, so repairs
     write fresh planes: K10 and K12), with FallbackPolicy(enabled=True,
     audit_interval=0, max_delta_fraction=0.5):
     (a) the 50,000-pod backlog of phase 1, seeded with a full solve, then
         5 ticks of ``testing.workloads.churn_tick`` (2 % of the pods
         replaced in a rotating quarter of the classes).  Each tick first
         re-solves the whole ingest from scratch (``CudaSolver``), then
         runs the session.  Every tick must be a delta whose
         ``node_signature()`` equals the re-solve's, with the JAX
         package's evictions (999 / 999 / 999 / 999 / 1,001), freed-hole
         slots (437 / 3 / 3 / 19 / 366) and windows (512 / 256 / 256 / 256
         / 512), measured on the CPU; at the end 50,000 scheduled, 0
         failed, 7,162 nodes.  A second session on ``use_kernels=False``
         runs the same ticks: after each, every leaf of its carry and its
         assignment planes must equal the kernel session's.  K10-K12 and
         K1-K7 must have launched in the delta ticks (counts zeroed just
         before each ``session.solve`` and read just after).
     (b) the mid-size live cluster of phase 3 with its 10,000 pods, 4
         ticks, each checked against a session that always solves in full
         (FallbackPolicy(enabled=False)): every tick a delta with the same
         signature, the JAX package's evictions and totals (``MID_CHURN``).
     Then K10-K12 against their twins on (a)'s last tick's inputs, and K10
     on dense evictions with full-mantissa requests.
  6. policy path — (a) the headline backlog through
     ``CudaSolver(..., policy=PolicyConfig(enabled=True))`` after the policy
     benchmark's price move (bench.py ``policy_line``: every type's zone-2
     spot offering at 0.6x its first offering), cold and warm, with the
     ``decode.objective`` stage (``objective_s``).  The selection must equal
     the JAX package's (``POLICY_HEADLINE``: active slots, the histogram of
     selected zone and capacity type, ``fleet_cost`` and ``fleet_expected``)
     and, leaf for leaf, a ``use_kernels=False`` run; every node's launch
     lists must pin its selected offering; K13 and K1-K7 must have launched
     in the cold run.  Then K13 against its twin on that final state, and
     with full-mantissa risks and throughputs under non-zero knobs.
     (b) the mid-size consolidation of phase 4 under the policy: the command
     must equal the JAX package's (``MID_POLICY_CONSOLIDATION``), in one
     pass (cost-delta scoring does not refine).  (c) the mid-size session:
     after an interruption-rate change the next tick must be a full solve
     with the reference's reason (``POLICY_ESCALATION_REASON``), the ticks
     around it deltas.

  7. relax path — (a) the headline backlog after the price move through
     ``CudaSolver(..., policy=PolicyConfig(enabled=True,
     solver_mode="relax"))``, cold and warm, with the stage split
     (``relax_s``: the dispatch to the verdict read; ``relax_repair_s``: the
     repair after it).  It must equal the
     JAX package's answer (``RELAX_HEADLINE``: mode, the relax verdict,
     nodes, scheduled, failed, ``fleet_cost``, ``n_next``) and, leaf for
     leaf, a ``use_kernels=False`` run; K14, K16-K18 must have launched
     inside ``relax_core``, and K1 and K3 once each there (the class
     planes, the class their batch axis), K1-K7 in the repair after it and
     K13 in the policy decode.  (b) Phase 1's backlog with no policy under
     ``KC_SOLVER_MODE=relax`` (weights 1, 0, 0), pinned the same way
     (``RELAX_OFF``).  (c) ``bench.py relax_line``'s fleet, both legs
     (``RELAX_LINE``), and a 2,500-pod fleet of the headline's four sizes
     whose leftover takes the repair window (``RELAX_WINDOW``; K11 and K12
     must launch).  (d) K14 and K16-K18 against their twins at (a)'s
     shapes, K16 stopped at ``max_iters=1``, ``relax_core`` on a class of
     3,000,000 pods with seeds 0, 1 and 7 (kernels against twins, and the
     JAX package's 112 / 112 / 106 placed), K18 given half the slots it
     filled (so it spills), and K3 and K1 over the class axis against their
     twins (``class_axis`` in their kernel records).
  8. tenant path — the coalesced multi-tenant solve.  (a) Eight tenants of
     50,000 … 43,000 headline pods, each on its own provider, prepared
     once: their ``service.tenant.bucket_key``s must be equal.  Eight solo
     ``run_prepared`` calls, then one batched dispatch of the eight
     (``BatchCoalescer._run_batched``): every leaf of every tenant equals
     its solo solve, and the batched scan launches K1-K3 and K5-K7 and
     reads the host exactly as often as tenant 0's solo scan (B = 1).  Then
     the same eight through a ``TenantPlane`` (window long enough,
     ``max_batch`` 8) from eight threads, ``entry.session.solve``: every
     member's batch is 8, every leaf equals its solo solve, the 50,000-pod
     tenant gives the JAX package's 7,162 nodes.  (d) Each batched entry
     point against its twin (the solo twin tenant by tenant) at B = 8 on
     those eight tenants' planes.  (b) Eight sessions on the eight
     backlogs, three ticks of 2 % churn with ``KC_DELTA_WINDOW=0``, repairs
     fused through the plane: every batch is 8, every tick a delta, each
     tick's decode and the final warm state equal to the same sessions run
     with ``batch_window_s=0``.  (c) Four tenants of 5,000 pods into fleets
     of 260-380 nodes (one padded bucket): one batch of 4, each equal to its
     solo solve, tenants 0 and 1 equal to the JAX package's answer
     (``EX_TENANT_PINS``).  Prints the solo and batched walls, launches,
     host reads and peak memory.
  9. what-if path (BASELINE.json config 5) — ``parallel.mesh``'s studies, the
     replica axis the batched scan's tenant axis, in chunks sized to the
     card's free memory.  (c), run right after phase 4 on its 5,000-node
     cluster and its preparation: the crossed grid of 8 replicas at
     interruption rate 0.3 x phase 4's coarse pass of prefix sizes; its
     rate-0 row must equal that pass's ``failed`` and ``n_new``, a 2 x 4
     sub-grid the twins'; K8, K19, K20 and the scan's kernels must launch.
     Then, on phase 1's backlog: (a) ``monte_carlo_solve`` at 1,024
     replicas, rate 0: every replica must equal phase 1's solve (50,000
     scheduled, 0 failed, 7,162 nodes, its cost bit for bit, K20's twin
     over phase 1's outputs); (b) rate 0.3, seed 0: every replica must keep
     its 50,000 pods, replicas 0, 1, 511 and 1,023 must equal ``solve_core``
     run alone on their availability, and a chunk of 8 replicas must equal
     the twins' batch leaf for leaf; K19 (both modes, at [1,024, 1,000, 3,
     2]) and K20 (on the study's last chunk) against their twins, and K1,
     K2, K3 and K7 at the largest chunk's B = 147 replicas
     (``replica_axis``), and K23 on the phase commit that took the most rows
     in one more chunk of 147 replicas (``replica_axis``); (d)
     ``policy_monte_carlo`` at 1,024 replicas, seed 5, after the policy
     benchmark's spot move with every spot offering at interruption rate
     0.3: the same pins, with ``best_replica`` and ``expected_cost``
     printed.  Each study prints its wall, chunk size, each chunk's host
     reads and launches, and its peak memory.
 10. pipelined tick — the incremental session's deferred ticks
     (``solve(deferred=True)``: tick k's results consumed after tick k+1's
     dispatch, the fetch on a copy stream, the barrier under the watchdog)
     on phase 1's backlog: (a) ``bench.py pipeline_line``'s anchor regime
     (FallbackPolicy(materialized=True), 6 ticks of 2 % churn after a
     warm-up tick) serial (KC_PIPELINE=0) and deferred: every tick's record
     equal, tick 0 at 7,162 nodes; per-tick means and the median
     hidden / (hidden + exposed) printed; (b) phase 5's steady repair
     (CHURN_POLICY, 5 ticks of ``churn_tick``) serial and deferred with
     carry donation: records, evictions, holes and windows equal (the last
     three pinned in HEADLINE_CHURN), 5 donated dispatches, no realloc, no
     open ticket, the staging ring's ``staging_reallocs`` equal to the
     shape and dtype changes its slots saw (the reference's count) and no
     staging byte allocated after the first tick, K21 and K22 launched and K10 / K12
     not, peak memory per tick printed for both legs; (c) K21 and K22
     against their twins and against K10 / K12 on a clone, on (b)'s last
     tick's inputs; (d) a deferred tick whose barrier a ~2 s
     ``torch.cuda._sleep`` on the compute stream holds past a 0.2 s
     watchdog floor: it re-anchors with reason ``watchdog-timeout`` to a
     serial full solve's records, its donation canceled, no ticket open.

Kernel checks are exact (no tolerance: the kernels reproduce the twins'
integer, boolean and IEEE float arithmetic).  Each kernel is timed beside
its plain twin and its bound: bytes it must move over 3.35 TB/s, or
operations over 67 T/s, whichever is larger (H100 SXM data-sheet peaks at
700 W).  ``ms`` is the median of CUDA-event timings of one call, wrapper
included: when the wrapper's host work is longer than the kernel, the
events time the host.  ``device_ms`` is the device's time alone: the median
of 20 calls, each between its own events, queued behind a
``torch.cuda._sleep`` that holds the card until the host has enqueued them
all (checked; a record whose host could not get ahead carries
``device_ms_queued: false``).  A library call has both, ``library_ms`` and
``library_device_ms``.  K8's
``library_ms`` times one ``torch.matmul`` of the f32 lane-subset mask with
the f32 count plane, which computes its displaced counts; K10's one
``torch.matmul`` of ``free_new.T.float()`` with the class requests, which
computes its ``used`` term; no single PyTorch call computes any of the
others (K11 and K12 are gathers and scatters of 13 planes with a zone-count
reduction, K13 a masked argmin with the spot tie rule and two ordered sums,
K15 the padding of sixteen planes with a group remap, K14 and K16-K18 the
relax family's masked minima, iterated sorts and scans, seeded rounding and
slot gathers, K19 a counter-based draw and K20 masked minima with ordered
sums), so theirs is null.

Prints the card's name and power limit, the kernel build time, one JSON
line of kernel records (each with its launches on the tenant path,
``tenants``, and on the what-if paths, ``launches_per_path``; K1-K3 and
K5-K7 with their batched entry points' lines at B = 8, ``tenant_axis``;
K1-K3 and K7 at the study's B = 147, ``replica_axis``; K2 on a sorted
input, ``sorted_input``; K3 and K6 on the consolidation lanes,
``lane_axis``, each with the shapes it ran; K19 with
its risk-plane mode, ``risk_mode``), and last ``{"ok": true, "device": {...}}``.  Any
failed check exits non-zero before that line.  Needs one card; refuses to
run without one.
"""

import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import torch

# the JAX package's answer on the same inputs (50,000 pods x 1,000 types x 5
# provisioners), measured on the CPU: every pod placed on 7,162 new nodes
EXPECTED_NODES = 7162
N_PODS, N_TYPES, N_PROVISIONERS = 50_000, 1000, 5
# the live cluster of phase 3 (BASELINE.json config 3: 5k nodes at 60 % util)
N_NODES, FILL, CLUSTER_SEED = 5000, 0.6, 2024
# the JAX package's answer for the existing-node path at a size its CPU run
# takes: MID_PODS pods x MID_TYPES types x 5 provisioners into
# build_cluster(MID_NODES, MID_TYPES, 5, FILL, CLUSTER_SEED);
# tests/test_torch_existing.py holds both packages to it on the CPU
MID_PODS, MID_NODES, MID_TYPES = 10_000, 1000, 100
MID_EXPECTED = {"on_existing_nodes": 8609, "existing_nodes_used": 277, "on_new_nodes": 1391,
                "new_nodes": 1391, "failed": 0, "residual": 0}

# the full-size command of phase 4 (the port's own, unchanged since its
# first card run; the 5,000-node cluster is past the JAX package's CPU runs)
FULL_CONSOLIDATION = {"action": "delete", "nodes_removed": 505, "replacements": []}
# the JAX package's multi-node consolidation command for build_cluster(
# MID_NODES, MID_TYPES, 5, FILL, CLUSTER_SEED) with every node a candidate
# and no pending pods, measured on the CPU; tests/test_torch_consolidation.py
# holds both packages to it
MID_CONSOLIDATION = {
    "action": "replace", "nodes_removed": 261,
    "replacements": [{"options": ["fake-it-0", "fake-it-1", "fake-it-2"],
                      "zones": ["test-zone-1", "test-zone-2", "test-zone-3"],
                      "capacity_types": ["spot"]}],
}
# the JAX package's answer for 4 ticks of workloads.churn_tick on the
# mid-size cluster and backlog above, through an IncrementalSolveSession with
# FallbackPolicy(enabled=True, audit_interval=0, max_delta_fraction=0.5),
# measured on the CPU; tests/test_torch_incremental.py holds both packages
# to it
MID_CHURN = {"ticks": 4, "evicted_existing": [149, 201, 201, 201], "evicted_new": [50, 0, 0, 0],
             "aggregates": {"scheduled": 10_000, "failed": 0, "nodes": 1391}}
# the kernels each path runs (K4 packs the provisioning decode's planes; the
# sweep's fetch has no big plane)
PROVISIONING_KERNELS = ("it_capacity", "fill_priority", "req_merge", "pack_bool",
                        "existing_intake", "existing_phase", "spread_quota", "slot_commit")
CHURN_KERNELS = PROVISIONING_KERNELS + ("repair_free", "repair_gather", "repair_scatter")
POLICY_KERNELS = PROVISIONING_KERNELS + ("select_offerings",)
# the JAX package's answers for phase 5 (a), measured on the CPU: evictions,
# freed-hole slots and window slots per tick, and the totals after the last
HEADLINE_CHURN = {"evicted": [999, 999, 999, 999, 1001], "hole_slots": [437, 3, 3, 19, 366],
                  "window": [512, 256, 256, 256, 512],
                  "aggregates": {"scheduled": N_PODS, "failed": 0, "nodes": EXPECTED_NODES}}
CHURN_POLICY = {"enabled": True, "audit_interval": 0, "max_delta_fraction": 0.5}
# the JAX package's multi-node consolidation command for the mid-size cluster
# under PolicyConfig(enabled=True) (cost-delta scoring, no refinement),
# measured on the CPU; tests/test_torch_policy.py holds both packages to it
MID_POLICY_CONSOLIDATION = {"action": "delete", "nodes_removed": 255, "replacements": []}
# phase 6 (a): the headline backlog under PolicyConfig(enabled=True) after the
# policy benchmark's price move (bench.py policy_line: zone-2 spot at 0.6x the
# type's first offering).  The JAX package's select_offerings, run on the CPU
# over this solve's final state planes and objective planes as a card run
# left them, gives this selection, every leaf equal to the card's; the
# solve's 7,162 nodes are the JAX package's full-size answer (EXPECTED_NODES)
POLICY_HEADLINE = {"active": 7162, "hist": {"test-zone-1/spot": 8, "test-zone-2/spot": 7153,
                                            "test-zone-3/on-demand": 1},
                   "fleet_cost": 580.57568359375, "fleet_expected": 580.57568359375}
# the reason both packages' sessions give a full solve after a policy input
# changed (tests/test_torch_policy.py holds both to it)
POLICY_ESCALATION_REASON = "supply-changed:supply"
# phase 7: the relax family, the JAX package's answers on the same inputs,
# measured on the CPU.  (a) the headline backlog after the price move under
# PolicyConfig(enabled=True, solver_mode="relax"); (b) phase 1's backlog (no
# price move, no policy: weights 1, 0, 0) under KC_SOLVER_MODE=relax.  Both
# repair at full width (the leftover does not fit a window)
RELAX_HEADLINE = {"mode": "relax", "iters": 8, "converged": True, "rounded_violations": 0,
                  "placed": 19813, "leftover": 30187, "nodes": 7142, "scheduled": N_PODS,
                  "failed": 0, "fleet_cost": 579.3824462890625, "n_next": 7142}
RELAX_OFF = {"mode": "relax", "iters": 7, "converged": True, "rounded_violations": 0,
             "placed": 20805, "leftover": 29195, "nodes": 7143, "scheduled": N_PODS, "failed": 0,
             "fleet_cost": None, "n_next": 7143}
# (c)'s fleets: bench.py relax_line (4,000 pods of one size x 24 types after
# the price move, both legs), and 2,500 pods of the headline's four sizes,
# whose leftover takes the repair window (192 of 256 slots, 102 of them
# relax's); tests/test_torch_relax_solve.py holds both packages to them
RELAX_LINE = {"fleet_cost_delta": 0.0, "relax_iters": 11, "relax_leftover": 5, "scan_nodes": 86,
              "relax_nodes": 86, "fleet_cost": 33.096595764160156}
RELAX_WINDOW = {"mode": "relax", "iters": 12, "leftover": 82, "placed": 2418, "nodes": 103,
                "fleet_cost": 39.333587646484375, "failed": 0, "slots": 256, "window": 192}
RELAX_KERNELS = ("relax_cost", "simplex_pgd", "relax_round", "relax_materialize", "it_capacity",
                 "req_merge")
CONSOLIDATION_KERNELS = ("it_capacity", "fill_priority", "req_merge", "existing_intake",
                         "existing_phase", "spread_quota", "sweep_lanes", "lane_finish",
                         "slot_commit")
# phase 8: the coalesced multi-tenant solve.  (a) eight headline-size tenants
# of one shape bucket (8,192 slots each), one batch of the tenant plane; the
# 50,000-pod tenant's solo answer is the JAX package's (EXPECTED_NODES,
# measured on the CPU); every slot opened holds pods, so n_next is the node
# count
TENANT_PODS = (50_000, 49_000, 48_000, 47_000, 46_000, 45_000, 44_000, 43_000)
TENANT_PINS = {0: {"nodes": EXPECTED_NODES, "failed": 0, "n_next": EXPECTED_NODES}}
# the kernels the batched scan launches (K4 packs each tenant's decode)
TENANT_KERNELS = ("it_capacity", "fill_priority", "req_merge", "existing_intake",
                  "existing_phase", "spread_quota", "slot_commit")
# (b) churn ticks of the fused repair
FUSED_TICKS = 3
# (c) existing-node coalescing: EX_TENANT_PODS pods x MID_TYPES types into
# build_cluster(n, MID_TYPES, 5, FILL, seed) fleets of 260-380 nodes (one
# padded bucket of 384 rows).  Tenants 0 and 1: the JAX package's answer,
# solo and in its own B = 2 batch, measured on the CPU;
# tests/test_torch_tenant_batch.py holds both packages to it
EX_TENANT_PODS = 5000
EX_TENANT_FLEETS = ((260, 11), (300, 12), (340, 13), (380, 14))
EX_TENANT_PINS = {
    0: {"on_existing_nodes": 4290, "existing_nodes_used": 121, "on_new_nodes": 710,
        "new_nodes": 710, "failed": 0, "residual": 0},
    1: {"on_existing_nodes": 4292, "existing_nodes_used": 120, "on_new_nodes": 708,
        "new_nodes": 708, "failed": 0, "residual": 0},
}

# phase 9: the what-if studies (BASELINE.json config 5) on the headline
# backlog: 1,024 replicas, spot offerings interrupted at rate 0.3 (seed 0);
# replicas WHATIF_SAMPLED are solved alone as well, and a chunk of
# WHATIF_TWIN_CHUNK through the twins.  The policy study draws from the risk
# priors (every spot offering at 0.3) with seed 5.  The crossed grid: 8
# replicas x phase 4's coarse pass of prefix sizes, seed 0
WHATIF_REPLICAS, WHATIF_RATE, WHATIF_SAMPLED = 1024, 0.3, (0, 1, 511, 1023)
WHATIF_TWIN_CHUNK, POLICY_WHATIF_SEED = 8, 5
CROSSED_REPLICAS, CROSSED_SEED = 8, 0
WHATIF_KERNELS = TENANT_KERNELS + ("perturb_avail", "replica_finish")
CROSSED_KERNELS = WHATIF_KERNELS + ("sweep_lanes",)
# 32-bit integer operations of one threefry draw and its compare (20 rounds
# of add, rotate and xor, 5 key injections, the float and the threshold)
THREEFRY_OPS = 120

# phase 10: the pipelined tick (bench.py pipeline_line's anchor regime,
# ticks after the warm-up tick), and the compute-stream stall that holds the
# barrier past the watchdog floor
ANCHOR_TICKS = 6
STALL_S = 2.0

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


_CYCLES_PER_MS = []


def sleep_cycles_per_ms() -> float:
    """``torch.cuda._sleep`` cycles a millisecond on this card, measured once."""
    if not _CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _CYCLES_PER_MS.append(10_000_000 / start.elapsed_time(end))
    return _CYCLES_PER_MS[0]


def device_ms(fn, wall_ms: float, reps: int = 20):
    """Median device milliseconds of one call, host time excluded: ``reps``
    calls, each between its own pair of CUDA events, queued behind a
    ``torch.cuda._sleep`` long enough (twice the calls' wall time) that the
    host has enqueued them all before the card starts.  That is checked: an
    event recorded right after the sleep must still be pending once the
    last call is queued, else the sleep is lengthened fourfold and the calls
    run again (three tries).  Returns (ms, queued)."""
    fn()
    torch.cuda.synchronize()
    sleep_ms = 2.0 * reps * wall_ms + 1.0
    for _ in range(3):
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(reps)]
        gate = torch.cuda.Event()
        torch.cuda._sleep(int(sleep_ms * sleep_cycles_per_ms()))
        gate.record()
        for start, end in pairs:
            start.record()
            fn()
            end.record()
        queued = not gate.query()
        torch.cuda.synchronize()
        if queued:
            break
        sleep_ms *= 4
    return statistics.median(start.elapsed_time(end) for start, end in pairs), queued


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


def launch_counts() -> dict:
    """Kernel launches so far, by kernel (each wrapper counts its own)."""
    from karpenter_core_tpu_torch.kernels import (
        capacity, classfinish, commit, consolidate, existing, fill, montecarlo, objective,
        packbits, perturb, relax, repair, reqmerge, spread,
    )
    return {
        "it_capacity": capacity.launches, "fill_priority": fill.launches,
        "req_merge": reqmerge.launches, "pack_bool": packbits.launches,
        "existing_intake": existing.intake_launches,
        "existing_phase": existing.phase_launches, "spread_quota": spread.launches,
        "sweep_lanes": consolidate.lanes_launches, "lane_finish": consolidate.finish_launches,
        "repair_free": repair.free_launches, "repair_gather": repair.gather_launches,
        "repair_scatter": repair.scatter_launches,
        "repair_free_inplace": repair.free_inplace_launches,
        "repair_scatter_inplace": repair.scatter_inplace_launches,
        "select_offerings": objective.launches,
        "class_finish": classfinish.launches, "relax_cost": relax.cost_launches,
        "simplex_pgd": relax.pgd_launches, "relax_round": relax.round_launches,
        "relax_materialize": relax.materialize_launches, "perturb_avail": perturb.launches,
        "replica_finish": montecarlo.launches, "slot_commit": commit.launches,
    }


def reset_launches() -> None:
    from karpenter_core_tpu_torch.kernels import (
        capacity, classfinish, commit, consolidate, existing, fill, montecarlo, objective,
        packbits, perturb, relax, repair, reqmerge, spread,
    )
    for mod in (capacity, fill, reqmerge, packbits, spread, objective, classfinish, perturb,
                montecarlo, commit):
        mod.launches = 0
    existing.intake_launches = existing.phase_launches = 0
    consolidate.lanes_launches = consolidate.finish_launches = 0
    repair.free_launches = repair.gather_launches = repair.scatter_launches = 0
    repair.free_inplace_launches = repair.scatter_inplace_launches = 0
    relax.cost_launches = relax.pgd_launches = relax.round_launches = 0
    relax.materialize_launches = 0


def fresh_history() -> None:
    """The port's slot-count and feature-set history emptied, as in a fresh
    process: the run that follows is pinned to a fresh JAX process's
    answer, and both packages snap their slot estimates to counts the
    process used before (``utils.compilecache``)."""
    from karpenter_core_tpu_torch.utils import compilecache

    compilecache.reset_memo()


def slots_used(label: str) -> None:
    """Print the slot counts the run since ``fresh_history`` estimated."""
    from karpenter_core_tpu_torch.utils import compilecache

    print(json.dumps({"history": label, "slots_used": sorted(compilecache._slots_seen)}),
          flush=True)


def check_launched(launches: dict, names, path: str) -> None:
    for name in names:
        if launches[name] <= 0:
            fail(f"kernel {name} never launched on the {path}")


def same_leaves(got_outputs, want_outputs, label: str, want_name="the plain-twin solve") -> None:
    want = leaves(want_outputs)
    for name, got in leaves(got_outputs).items():
        if got.shape != want[name].shape or got.dtype != want[name].dtype or not torch.equal(
                got, want[name]):
            fail(f"{label}: SolveOutputs.{name} differs from {want_name}")
    print(f"{label}: every SolveOutputs leaf equals {want_name}", flush=True)


def leaves(outputs) -> dict:
    out = {}
    for name in ("assign", "assign_existing", "failed", "spread_suspect", "remaining"):
        out[name] = getattr(outputs, name)
    for group in ("state", "ex_state", "topo"):
        tup = getattr(outputs, group)
        for f in tup._fields:
            out[f"{group}.{f}"] = getattr(tup, f)
    return out


def bound(moved, ops) -> dict:
    """The least time the card could take for ``moved`` bytes and ``ops``
    scalar operations, and which of the two sets it."""
    by_bytes, by_ops = moved / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


# (bytes, bytes a batch axis shares, operations) of K1's solo call: its
# replica-axis bound reads them
K1_WORK = {}


def record_kernel(records, name, source, replaces, launches_n, kernel_fn, plain_fn, moved, ops,
                  library_fn=None, plain_reps=20):
    """Hold one kernel against its plain twin (exactly), time both (and the
    one PyTorch call that computes the same function, where there is one),
    and append the kernel's record; returns the kernel's outputs."""
    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0.0:
        fail(f"{name}: kernel differs from its plain twin (max_abs_err {err})")
    wall = time_ms(kernel_fn)
    dev_ms, queued = device_ms(kernel_fn, wall)
    rec = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches_n, "max_abs_err": err,
        "ms": wall, "device_ms": dev_ms, "plain_ms": time_ms(plain_fn, plain_reps),
        **bound(moved, ops), "library_ms": None, "library_device_ms": None,
    }
    if library_fn is not None:
        rec["library_ms"] = time_ms(library_fn)
        rec["library_device_ms"], lib_queued = device_ms(library_fn, rec["library_ms"])
        queued = queued and lib_queued
    if not queued:
        rec["device_ms_queued"] = False  # the host kept up with the card: an upper bound
    records.append(rec)
    library = ("" if library_fn is None else
               f" library_ms {rec['library_ms']:.4f} library_device_ms "
               f"{rec['library_device_ms']:.4f}")
    print(f"{name}: ms {rec['ms']:.4f} device_ms {rec['device_ms']:.4f} plain_ms "
          f"{rec['plain_ms']:.4f} bound_ms {rec['bound_ms']:.5f} ({rec['bound_by']}){library} "
          "exact", flush=True)
    return got


def axis_line(records, name, axis, entry, kernel_fn, plain_fn, moved, ops, plain_reps=3,
              timed=False, **extra):
    """Hold one more call of kernel ``name`` against its twin (exactly), time
    it as the kernel line's calls are (``ms``, ``device_ms``, ``plain_ms``),
    bound it from ``moved`` bytes and ``ops``, and file it under the kernel
    record's ``axis`` (``entry`` names it there, or None for the axis
    itself), with the seconds the line took as ``record_s`` when ``timed``;
    returns the kernel's outputs."""
    t0 = time.perf_counter()
    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0.0:
        fail(f"{name} {axis} {entry or ''}: kernel differs from its twin (max_abs_err {err})")
    wall = time_ms(kernel_fn)
    dev_ms, queued = device_ms(kernel_fn, wall)
    rec = {**extra, "max_abs_err": err, "ms": wall, "device_ms": dev_ms,
           "plain_ms": time_ms(plain_fn, plain_reps), **bound(moved, ops)}
    if not queued:
        rec["device_ms_queued"] = False
    if timed:
        rec["record_s"] = time.perf_counter() - t0
    owner = next(r for r in records if r["name"] == name)
    if entry is None:
        owner[axis] = rec
    else:
        owner.setdefault(axis, {})[entry] = rec
    print(json.dumps({f"{name}_{axis}" + (f"_{entry}" if entry else ""): rec}), flush=True)
    return got


def commit_bytes(ex, merge, zone_new, ct_ok, cls_ports, vol_add, per_pod, requests,
                 assigned, host_ports, volume_limits) -> int:
    """The bytes K6's commit must move: each state plane read once and
    written once (a selected row reads its own requirement planes, which it
    merges with the class, and ``zone_new`` and ``ct_ok`` where an
    unselected row reads its old zone and ct: the same widths), the class
    row and vocabulary it merges with, the requests and ``assigned`` read,
    the class's ports with host ports on, and with volume limits on the
    per-pod vector and ``vol_add`` of the selected rows only."""
    moved = 2 * nbytes(ex[:-1]) + nbytes(merge.cls, merge.valid, merge.vocab_ints, requests,
                                         assigned)
    if host_ports:
        moved += nbytes(cls_ports)
    if volume_limits:
        selected = int((assigned > 0).sum())
        moved += nbytes(per_pod) + selected * (nbytes(vol_add) // assigned.numel())
    return moved


def captured_commit(run, phase_only=False):
    """``run()`` with the scan's slot commit (K23) spied on: returns the
    arguments of the call that committed the most rows (open rows that took
    pods and fresh rows), of a phase's commits only with ``phase_only`` (one
    pair of K1 planes where the committal block holds one a zone).  Counting
    the rows reads the host once a call."""
    from karpenter_core_tpu_torch.ops import solve as solve_ops

    kernels = solve_ops.KERNELS
    best = {"rows": -1, "args": None}

    def spy(state, src, *rest):
        out = kernels.slot_commit(state, src, *rest)
        if not (phase_only and src.zone_idx is not None):
            rows = int(((src.a > 0) | (src.fresh_t >= 0)).sum())
            if rows > best["rows"]:
                best.update(rows=rows, args=(state, src, *rest))
        return out

    solve_ops.KERNELS = kernels._replace(slot_commit=spy)
    try:
        run()
    finally:
        solve_ops.KERNELS = kernels
    if best["args"] is None:
        fail("slot_commit: the spied run made no commit")
    return best["args"]


def slot_commit_work(state, src, cls_ports, requests, tmpl_daemon, host_ports):
    """(bytes, operations, shapes) of one K23 call on these inputs, as its
    rows need them: every output plane written once (``ports`` only with
    host ports on: off, it is handed back) and each row's source read once;
    a kept row reads its old row of each of those planes; an open row that
    took pods its old used, pod count, template and open flag (and ports),
    its merged, ct (and, in a phase, zone) rows and its zone set's K1 bool
    and int32 a type; a fresh row nothing old; the template planes and the
    class vectors are read once.  Operations: a compare and an AND a type
    and an FMA a resource of every row that took pods or opened."""
    planes = [state.used, state.kmask, state.kdef, state.kneg, state.kgt, state.klt, state.zone,
              state.ct, state.viable, state.pod_count, state.tmpl_id, state.open_]
    if host_ports:
        planes.append(state.ports)
    fresh = src.fresh_t >= 0
    took = (src.a > 0) & ~fresh
    n_open, n_fresh = int(took.sum()), int(fresh.sum())
    n_b, n, n_types = state.viable.shape
    n_keep = n_b * n - n_open - n_fresh

    def row(*tensors):  # bytes a row of [B, N, ...] planes
        return nbytes(*tensors) // (n_b * n)

    open_row = (row(state.used, state.pod_count, state.tmpl_id, state.open_, src.merged,
                    src.ct_ok, src.zone_ok) + n_types * 5
                + (row(state.ports) if host_ports else 0))
    moved = (nbytes(*planes) + n_keep * row(*planes) + n_open * open_row
             + nbytes(src.a, src.fresh_t, src.zone_idx, requests, tmpl_daemon, src.tmpl_merged,
                      src.t_zone, src.t_ct, src.t_ok, src.t_cap)
             + (nbytes(cls_ports) if host_ports else 0))
    ops = (n_open + n_fresh) * (2 * n_types + 2 * state.used.shape[2])
    shapes = {"B": n_b, "N": n, "I": n_types, "zone_sets": len(src.ok),
              "site": "phase" if src.zone_idx is None else "committal",
              "open_rows": n_open, "fresh_rows": n_fresh, "kept_rows": n_keep,
              "host_ports": bool(host_ports),
              "tenants_without_rows": int((~(took | fresh).any(dim=1)).sum())}
    return moved, ops, shapes


def slot_commit_line(records, axis, args) -> None:
    """K23 on captured arguments, held exactly to its twin and timed, filed
    under its record's ``axis``."""
    from karpenter_core_tpu_torch.kernels import commit

    moved, ops, shapes = slot_commit_work(*args)
    axis_line(records, "slot_commit", axis, None, lambda: commit.slot_commit(*args),
              lambda: commit.slot_commit_twin(*args), moved, ops, **shapes)


def path_counts(results) -> dict:
    """Where the pods of one existing-node solve went."""
    return {
        "on_existing_nodes": sum(len(v) for v in results.existing_assignments.values()),
        "existing_nodes_used": len(results.existing_assignments),
        "on_new_nodes": sum(len(n.pods) for n in results.new_nodes),
        "new_nodes": len(results.new_nodes),
        "failed": len(results.failed_pods),
        "residual": len(results.spread_residual_pods),
    }


def existing_path(records, cold_launches):
    """Phase 3: the 50,000-pod backlog into a live 5,000-node cluster, then
    K5-K7 against their twins at this path's shapes.  Returns the mid-size
    and the full-size cluster, each (state_nodes, bound_pods), and this
    path's launches."""
    import numpy as np

    from karpenter_core_tpu_torch.kernels import existing, fill, reqmerge, spread
    from karpenter_core_tpu_torch.models.columnar import PodIngest
    from karpenter_core_tpu_torch.ops import masks as mask_ops
    from karpenter_core_tpu_torch.ops import solve as solve_ops
    from karpenter_core_tpu_torch.ops.objective import select_for_state
    from karpenter_core_tpu_torch.policy import PolicyConfig, planes_of
    from karpenter_core_tpu_torch.testing.workloads import build_cluster, build_inputs

    # the mid-size solve whose answer the JAX package gave on the CPU
    mid_nodes, mid_bound = build_cluster(MID_NODES, MID_TYPES, N_PROVISIONERS, FILL,
                                         CLUSTER_SEED)
    mid_solver, mid_pods = build_inputs(MID_PODS, MID_TYPES, N_PROVISIONERS)
    fresh_history()
    mid = path_counts(mid_solver.solve(mid_pods, mid_nodes, mid_bound))
    print(json.dumps({"run": "existing mid-size", "bound_pods": len(mid_bound), **mid}),
          flush=True)
    slots_used("existing mid-size")
    if mid != MID_EXPECTED:
        fail(f"existing mid-size: {mid}, the JAX package's answer is {MID_EXPECTED}")
    del mid_solver, mid_pods

    t0 = time.perf_counter()
    state_nodes, bound_pods = build_cluster(N_NODES, N_TYPES, N_PROVISIONERS, FILL, CLUSTER_SEED)
    tainted = {n.node.name for n in state_nodes if n.node.spec.taints}
    print(json.dumps({"cluster": {
        "nodes": len(state_nodes), "bound_pods": len(bound_pods), "tainted": len(tainted),
        "allocatable_cpu": sum(n.allocatable().get("cpu", 0.0) for n in state_nodes),
        "requested_cpu": sum(n.pod_requests_total().get("cpu", 0.0) for n in state_nodes),
        "build_s": time.perf_counter() - t0,
    }}), flush=True)

    solver, pods = build_inputs(N_PODS, N_TYPES, N_PROVISIONERS)
    # the warm solve's snapshot and prepared planes, kept for the checks
    # below (encoding 2.77M bound pods again would take a minute of host time)
    kept = {}
    prepare = solver.prepare_encoded

    def keep_prepared(snapshot_, *args, **kwargs):
        kept["snapshot"], kept["prep"] = snapshot_, prepare(snapshot_, *args, **kwargs)
        return kept["prep"]

    solver.prepare_encoded = keep_prepared
    reset_launches()
    solve_ops.host_syncs = 0
    runs = []
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        ingest = PodIngest()
        ingest.add_all(pods)
        ingest_s = time.perf_counter() - t0
        results = solver.solve(ingest, state_nodes, bound_pods)
        torch.cuda.synchronize()
        runs.append((label, ingest_s, dict(solver.stages), time.perf_counter() - t0, results))
        if label == "cold":
            launches = launch_counts()
            syncs = solve_ops.host_syncs
    del solver.prepare_encoded
    out = solver.last_outputs
    for label, ingest_s, stages, total_s, results in runs:
        counts = path_counts(results)
        print(json.dumps({
            "run": f"existing {label}", "wall_s": total_s, "ingest_s": ingest_s, **stages,
            **counts, "E": int(out.assign_existing.shape[1]), "slots": int(out.assign.shape[1]),
        }), flush=True)
        placed = (counts["on_existing_nodes"] + counts["on_new_nodes"] + counts["failed"]
                  + counts["residual"])
        if placed != N_PODS:
            fail(f"existing {label}: {counts} accounts for {placed} pods, not {N_PODS}")
        if tainted & set(results.existing_assignments):
            fail(f"existing {label}: a tainted node took pods")
        if counts["on_existing_nodes"] <= 0:
            fail(f"existing {label}: no pod landed on an existing node")
    print(json.dumps({"existing_cold_run_launches": launches,
                      "existing_cold_run_host_syncs": syncs}), flush=True)
    check_launched(launches, PROVISIONING_KERNELS, "existing-node path")
    snapshot, prep = kept["snapshot"], kept["prep"]
    if not bool((out.ex_state.used <= prep.ex_static.alloc + 1e-4).all()):
        fail("an existing node's final usage exceeds its allocatable")
    print("existing path: every existing node's usage within its allocatable", flush=True)

    # the policy objective over this path's outputs: decode again, no re-solve
    solver.policy = PolicyConfig(enabled=True)
    before = launch_counts()["select_offerings"]
    policy_res = solver.decode(snapshot, out, state_nodes)
    selection = solver.last_selection
    plain_sel = select_for_state(out.state, planes_of(snapshot), solver.policy,
                                 snapshot.capacity_types, use_kernels=False)
    if any(not np.array_equal(a, b) for a, b in zip(selection, plain_sel)):
        fail("existing path: the policy selection differs from its plain twin's")
    launches["select_offerings"] = launch_counts()["select_offerings"] - before
    if launches["select_offerings"] != 1:
        fail("existing path: the policy decode did not launch select_offerings once")
    print(json.dumps({"run": "existing warm outputs decoded under the policy",
                      "objective_s": solver.stages["objective_s"],
                      "active": int(selection.active.sum()),
                      "selected": sum(d.selected is not None for d in policy_res.new_nodes),
                      "new_nodes": len(policy_res.new_nodes),
                      "fleet_cost": policy_res.fleet_cost,
                      "fleet_expected": policy_res.fleet_expected_cost}), flush=True)
    if policy_res.fleet_cost is None or not all(d.selected for d in policy_res.new_nodes):
        fail("existing path: a new node of the policy decode has no selected offering")
    solver.policy = None

    # the twins' scan on the warm solve's prepared planes
    plain_solver, _ = build_inputs(N_PODS, N_TYPES, N_PROVISIONERS, use_kernels=False)
    t0 = time.perf_counter()
    plain_out = plain_solver.run_prepared(prep)
    torch.cuda.synchronize()
    print(json.dumps({"run": "existing plain twins (use_kernels=False), the warm run's planes",
                      "wall_s": time.perf_counter() - t0}), flush=True)
    same_leaves(out, plain_out, "existing path")
    del plain_out

    # -- K5-K7 at this path's shapes: the zone-spread class against the
    # cluster as it stood before the solve -----------------------------------
    c = next(i for i, cls in enumerate(snapshot.classes) if cls.zone_spread is not None)
    ft = prep.features
    st = solve_ops.StaticArrays(*prep.statics_arrays)
    v = st.valid.shape[-1]
    st = st._replace(valid=mask_ops.pack_mask(st.valid))
    cls = solve_ops.ClassTensors(*(t[c] for t in prep.cls))
    cls = cls._replace(mask=mask_ops.pack_mask(cls.mask))
    cls_req = mask_ops.ReqTensor(cls.mask[None], cls.defined[None], cls.negative[None],
                                 cls.gt[None], cls.lt[None])
    ex, ex_static = prep.ex_state, prep.ex_static
    ex = ex._replace(kmask=mask_ops.pack_mask(ex.kmask))
    n_ex = ex.used.shape[0]
    key_ok = reqmerge.req_compat(
        mask_ops.ReqTensor(ex.kmask, ex.kdef, ex.kneg, ex.kgt, ex.klt), cls_req, st.valid,
        st.vocab_ints, st.is_custom, v, prep.key_has_bounds)
    merge = reqmerge.ClassMerge(cls_req, st.valid, st.vocab_ints, v, prep.key_has_bounds)
    host_cap = torch.full((n_ex,), solve_ops.UNLIMITED, dtype=torch.int32, device="cuda")
    k5 = (ex_static.alloc, ex.used, ex.open_, key_ok, ex_static.tol[c], ex.zone, cls.zone,
          ex.ct, cls.ct, ex.ports, cls.ports, ex_static.vol_limit, ex.vol_used,
          ex_static.cls_vol_add[c], ex_static.cls_vol_per_pod[c], cls.requests, host_cap)
    read = [ex_static.alloc, ex.used, ex.open_, key_ok, ex_static.tol[c], ex.zone, cls.zone,
            ex.ct, cls.ct, cls.requests, host_cap]
    if ft.host_ports:
        read += [ex.ports, cls.ports]
    if ft.volume_limits:
        read += [ex_static.vol_limit, ex.vol_used, ex_static.cls_vol_add[c],
                 ex_static.cls_vol_per_pod[c]]
    n_res, n_zones, n_ct = ex.used.shape[1], ex.zone.shape[1], ex.ct.shape[1]
    cap, _, _ = record_kernel(
        records, "existing_intake", "karpenter_core_tpu_torch/csrc/existing_intake.cu",
        "karpenter_core_tpu/ops/solve.py:548", launches["existing_intake"],
        lambda: existing.existing_intake(*k5, ft.host_ports, ft.volume_limits),
        lambda: existing.existing_intake_plain(*k5, ft.host_ports, ft.volume_limits),
        nbytes(*read) + n_ex * (4 + n_zones + n_ct), n_ex * (6 * n_res + n_zones + n_ct + 8),
    )
    # K6: the fused caps and fill of an all-zone phase (the class's count),
    # then the commit of that fill; timed as the pair of entry points a
    # phase without hole preferences launches
    all_zones = torch.ones(n_zones, dtype=torch.bool, device="cuda")
    quota = torch.clamp(cls.count, min=1)
    k6m = (cap, ex.zone, cls.zone, all_zones, None, False, quota)
    assigned, _, zone_ok = existing.existing_mask_fill(*k6m)
    k6c = (ex, merge, zone_ok, ex.ct & cls.ct[None, :], cls.ports, ex_static.cls_vol_add[c],
           ex_static.cls_vol_per_pod[c], cls.requests, assigned, ft.host_ports, ft.volume_limits)
    record_kernel(
        records, "existing_phase", "karpenter_core_tpu_torch/csrc/existing_phase.cu",
        "karpenter_core_tpu/ops/solve.py:624", launches["existing_phase"],
        lambda: (existing.existing_mask_fill(*k6m), existing.existing_commit(*k6c)),
        lambda: (existing.existing_mask_fill_plain(*k6m), existing.existing_commit_plain(*k6c)),
        nbytes(cap, ex.zone, cls.zone, all_zones, quota) + n_ex * (4 + n_zones) + 4
        + commit_bytes(*k6c),
        n_ex * (n_zones + 6 + 2 * n_res),
    )
    # the mask alone (the phases with hole preferences), K2 on its caps and
    # the fused entry's sum, equal to the fused fill
    cap_m, pri_m, _ = existing.existing_mask(cap, ex.zone, cls.zone, all_zones, None, False)
    if not torch.equal(fill.fill_by_priority(quota, cap_m, pri_m), assigned):
        fail("existing_phase: the fused fill differs from the mask and K2's fill")
    # the single-node pin and a restricted, partly-excluded phase, both entry
    # points
    taken = assigned > 0
    for args in ((cap, ex.zone, cls.zone, all_zones, None, True),
                 (cap, ex.zone, cls.zone, torch.arange(n_zones, device="cuda") != 1,
                  ~taken, False)):
        err = max(max_abs_err(existing.existing_mask(*args), existing.existing_mask_plain(*args)),
                  max_abs_err(existing.existing_mask_fill(*args, quota),
                              existing.existing_mask_fill_plain(*args, quota)))
        if err != 0.0:
            fail(f"existing_phase (mask or mask_fill) differs from its twin: {err}")
    # K7: the class's quota rounds against the existing members per zone
    g = cls.groups[0].long()
    member_ex = ex_static.grp_node_member.index_select(0, g.reshape(1))[0]
    single = (ex.zone.sum(dim=-1, dtype=torch.int32) == 1)[:, None] & ex.zone
    counts = (member_ex[:, None] * single.to(torch.int32)).sum(dim=0, dtype=torch.int32)
    unlimited = torch.full((n_zones,), solve_ops.UNLIMITED, dtype=torch.int32, device="cuda")
    k7 = (counts, cls.zone, torch.ones_like(cls.zone), unlimited,
          st.grp_skew.index_select(0, g.reshape(1))[0], cls.count,
          st.grp_member[c].index_select(0, g.reshape(1))[0])
    record_kernel(
        records, "spread_quota", "karpenter_core_tpu_torch/csrc/spread_quota.cu",
        "karpenter_core_tpu/ops/solve.py:277", launches["spread_quota"],
        lambda: spread.spread_quota(*k7), lambda: spread.spread_quota_plain(*k7),
        nbytes(*k7) + n_zones * 5 + 5, (n_zones + 1) * (n_zones * n_zones + 30 * n_zones),
    )
    finite = torch.tensor([40, 3, 0], dtype=torch.int32, device="cuda")[:n_zones]
    for caps, fillable in ((finite, torch.ones_like(cls.zone)),
                           (unlimited, torch.arange(n_zones, device="cuda") != 1)):
        args = (counts, cls.zone, fillable, caps) + k7[4:]
        err = max_abs_err(spread.spread_quota(*args), spread.spread_quota_plain(*args))
        if err != 0.0:
            fail(f"spread_quota with finite caps differs from its twin: {err}")
    print("existing path kernels exact: K5, K6 (mask_fill, mask, single-node pin, commit), "
          "K7 (unlimited and finite caps)", flush=True)
    for rec in records:
        rec["launches_per_path"] = {"cold": cold_launches[rec["name"]],
                                    "existing": launches[rec["name"]]}
    return (mid_nodes, mid_bound), (state_nodes, bound_pods), launches


def command_summary(cmd) -> dict:
    """A consolidation command in package-neutral terms (either package's)."""
    zone_key, ct_key = "topology.kubernetes.io/zone", "karpenter.sh/capacity-type"
    return {
        "action": cmd.action.value, "nodes_removed": len(cmd.nodes_to_remove),
        "replacements": [{
            "options": [it.name for it in r.instance_type_options],
            "zones": sorted(r.requirements.get(zone_key).values),
            "capacity_types": sorted(r.requirements.get(ct_key).values),
        } for r in cmd.replacement_nodes],
    }


def consolidation_path(records, mid_cluster, cluster, cold_launches, existing_launches):
    """Phase 4: multi-node consolidation of phase 3's clusters, every node a
    candidate and no pending pods; then K8 and K9 against their twins at
    this path's shapes.  Returns this path's launches, and the full-size
    search's (snapshot, SweepPrep, coarse prefix sizes, coarse pass
    outputs) for phase 9's crossed grid."""
    import numpy as np

    from karpenter_core_tpu_torch.kernels import consolidate as k89
    from karpenter_core_tpu_torch.ops import consolidate as consolidate_ops
    from karpenter_core_tpu_torch.ops import solve as solve_ops
    from karpenter_core_tpu_torch.solver.consolidation import (
        CudaConsolidationSearch,
        fetch_planes,
    )
    from karpenter_core_tpu_torch.testing.workloads import (
        build_provider,
        consolidation_candidates,
    )

    mid_nodes, mid_bound = mid_cluster
    fresh_history()
    t0 = time.perf_counter()
    mid_search = CudaConsolidationSearch(*build_provider(MID_TYPES, N_PROVISIONERS))
    mid_cmd = mid_search.compute_command(
        consolidation_candidates(mid_nodes, mid_bound, MID_TYPES, N_PROVISIONERS), [],
        mid_nodes, mid_bound)
    mid = command_summary(mid_cmd)
    print(json.dumps({"run": "consolidation mid-size", "wall_s": time.perf_counter() - t0,
                      "passes": [len(sizes) for sizes, _ in mid_search.passes], **mid}),
          flush=True)
    if mid != MID_CONSOLIDATION:
        fail(f"consolidation mid-size: {mid}, the JAX package's answer is {MID_CONSOLIDATION}")
    del mid_search, mid_cmd

    state_nodes, bound_pods = cluster
    t0 = time.perf_counter()
    candidates = consolidation_candidates(state_nodes, bound_pods, N_TYPES, N_PROVISIONERS)
    candidates_s = time.perf_counter() - t0
    search = CudaConsolidationSearch(*build_provider(N_TYPES, N_PROVISIONERS))
    fresh_history()
    reset_launches()
    solve_ops.host_syncs = 0
    passes = []
    sweep = consolidate_ops.sweep

    def spied_sweep(prep_, sizes_, use_kernels=True):
        """One pass of the search: its chunks, launches, host reads, wall
        and peak memory."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        l0, s0, t1 = launch_counts(), solve_ops.host_syncs, time.perf_counter()
        out, chunks, _ = spied_chunks(lambda: sweep(prep_, sizes_, use_kernels=use_kernels))
        torch.cuda.synchronize()
        l1 = launch_counts()
        passes.append({
            "lanes": len(sizes_), "sweep_s": time.perf_counter() - t1,
            "pass_host_syncs": solve_ops.host_syncs - s0, **chunk_summary(chunks),
            "pass_launches": {k: l1[k] - l0[k] for k in l1 if l1[k] != l0[k]},
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
            "allocated_before_bytes": mem0,
        })
        return out

    consolidate_ops.sweep = spied_sweep
    t0 = time.perf_counter()
    try:
        cmd = search.compute_command(candidates, [], state_nodes, bound_pods)
    finally:
        consolidate_ops.sweep = sweep
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    syncs = solve_ops.host_syncs
    summary = command_summary(cmd)
    k = summary["nodes_removed"]
    print(json.dumps({
        "run": "consolidation full-size", "candidates": len(candidates),
        "candidates_s": candidates_s, "wall_s": wall_s, **search.stages,
        "passes": [len(sizes) for sizes, _ in search.passes], "host_syncs": syncs,
        "slots_per_lane": consolidate_ops.SWEEP_SLOTS, **summary,
        "replacement_requests": [r.requests for r in cmd.replacement_nodes],
        "launches": launches,
    }), flush=True)
    for i, one in enumerate(passes):
        print(json.dumps({"run": "consolidation full-size pass", "pass": i, **one}), flush=True)
    slots_used("consolidation full-size")
    if summary != FULL_CONSOLIDATION:
        fail(f"consolidation full-size: {summary}, expected {FULL_CONSOLIDATION}")
    check_launched(launches, CONSOLIDATION_KERNELS, "consolidation path")
    if [n.name for n in cmd.nodes_to_remove] != [c.node.name for c in candidates[:k]]:
        fail("consolidation: the removed nodes are not a prefix of the candidate list")
    if k:
        sizes, out = next((sizes, out) for sizes, out in reversed(search.passes)
                          if k in sizes.tolist())
        lane = sizes.tolist().index(k)
        n_new, failed = int(out.n_new[lane]), int(out.failed[lane])
        uninit = bool(out.used_uninitialized[lane])
        old_price = float(search._candidate_price_cumsum(candidates)[k - 1])
        print(json.dumps({"chosen_lane": {
            "k": k, "n_new": n_new, "failed": failed, "used_uninitialized": uninit,
            "new_cost": float(out.new_cost[lane]), "removed_nodes_price": old_price,
        }}), flush=True)
        if failed or uninit or n_new > 1:
            fail(f"consolidation: the chosen lane (k={k}) has failed={failed}, "
                 f"uninit={uninit}, n_new={n_new}")

    # maximality: no evaluated lane above k is valid, and k + 1 was evaluated
    snapshot, prep = search.prepared
    evaluated = sorted({int(size) for sizes, _ in search.passes for size in sizes})
    valid_above = [size for sizes, out in search.passes
                   for lane, size in enumerate(sizes.tolist())
                   if size > k and search.lane_command(snapshot, out, lane,
                                                       candidates[:size]) is not None]
    print(json.dumps({"maximality": {"k": k, "evaluated": len(evaluated),
                                     "next_evaluated": k + 1 in evaluated,
                                     "valid_above_k": valid_above}}), flush=True)
    if valid_above:
        fail(f"consolidation: lanes {valid_above} above the chosen k={k} are valid")
    if k < len(candidates) and k + 1 not in evaluated:
        fail(f"consolidation: k={k} was chosen but k + 1 was never evaluated")

    def same_sweep(got_out, want_out, label):
        for name in consolidate_ops.SweepOutputs._fields:
            got, want = getattr(got_out, name), getattr(want_out, name)
            if got.dtype != want.dtype or got.shape != want.shape:
                fail(f"consolidation: SweepOutputs.{name} differs in dtype or shape ({label})")
            if name == "new_cost":
                if not np.allclose(got, want, rtol=1e-6, atol=0):
                    fail(f"consolidation: new_cost differs beyond rtol 1e-6 ({label})")
            elif not np.array_equal(got, want):
                fail(f"consolidation: SweepOutputs.{name} differs ({label})")
        return bool(np.array_equal(got_out.new_cost, want_out.new_cost))

    # every pass again through the plain twins (the batched scan's twins
    # run lane by lane)
    for i, (sizes, out) in enumerate(search.passes):
        t0 = time.perf_counter()
        plain_stack = consolidate_ops.run_lanes(prep, sizes, use_kernels=False)
        plain_out = consolidate_ops.SweepOutputs(*fetch_planes(
            consolidate_ops.finish_lanes(prep, plain_stack, use_kernels=False)))
        exact = same_sweep(out, plain_out, f"pass {i} against the plain twins")
        print(json.dumps({"run": "consolidation pass, plain twins (use_kernels=False)",
                          "pass": i, "lanes": len(sizes), "wall_s": time.perf_counter() - t0,
                          "every_lane_equal": True, "new_cost_bit_exact": exact}), flush=True)
        if i == 0:
            stack = plain_stack
        del plain_stack
    coarse_sizes, coarse_out = search.passes[0]
    # K23 at the lanes: the slot commit that took the most rows in a kernel
    # rerun of the coarse pass
    slot_commit_line(records, "lane_axis",
                     captured_commit(lambda: consolidate_ops.run_lanes(prep, coarse_sizes)))

    # three lanes of the coarse pass alone: K8 for the one lane, its solo
    # solve_core through the kernels, K9 on its one-lane stack
    for lane in sorted({0, len(coarse_sizes) // 2, len(coarse_sizes) - 1}):
        size = torch.as_tensor(coarse_sizes[lane:lane + 1], dtype=torch.int32, device="cuda")
        lane_open, lane_count = k89.sweep_lanes(prep.candidate_rank, prep.ex_state.open_,
                                                prep.cls.count, prep.ex_cls_count, size)
        s0 = solve_ops.host_syncs
        solo = solve_ops.solve_core(
            prep.cls._replace(count=lane_count[0]), prep.statics_arrays,
            consolidate_ops.SWEEP_SLOTS, prep.key_has_bounds,
            prep.ex_state._replace(open_=lane_open[0]), prep.ex_static, n_passes=prep.n_passes,
            features=prep.features)
        solo_syncs = solve_ops.host_syncs - s0
        one = consolidate_ops.LaneStack(*(t[None] for t in consolidate_ops.lane_planes(solo)))
        solo_out = consolidate_ops.SweepOutputs(*fetch_planes(
            consolidate_ops.finish_lanes(prep, one)))
        lane_out = consolidate_ops.SweepOutputs(*(plane[lane:lane + 1] for plane in coarse_out))
        exact = same_sweep(lane_out, solo_out, f"coarse lane {lane} against its solo solve")
        print(json.dumps({"run": "consolidation coarse lane, solo solve_core", "lane": lane,
                          "k": int(coarse_sizes[lane]), "host_syncs": solo_syncs,
                          "equal": True, "new_cost_bit_exact": exact}), flush=True)
    print("consolidation path: every SweepOutputs leaf of every pass equals the plain-twin "
          "pass, and three coarse lanes their solo solve_core", flush=True)

    # -- K8 and K9 at this path's shapes: the coarse pass ---------------------
    sizes_t = torch.as_tensor(coarse_sizes, dtype=torch.int32, device="cuda")
    k8 = (prep.candidate_rank, prep.ex_state.open_, prep.cls.count, prep.ex_cls_count, sizes_t)
    n_lanes, (n_cls, n_ex) = len(coarse_sizes), prep.ex_cls_count.shape
    subset_f = (prep.candidate_rank[None, :] < sizes_t[:, None]).float()
    counts_f = prep.ex_cls_count.float().t().contiguous()  # [E, C]
    lane_open, lane_count = record_kernel(
        records, "sweep_lanes", "karpenter_core_tpu_torch/csrc/sweep_lanes.cu",
        "karpenter_core_tpu/ops/consolidate.py:69", launches["sweep_lanes"],
        lambda: k89.sweep_lanes(*k8), lambda: k89.sweep_lanes_plain(*k8),
        nbytes(*k8) + n_lanes * n_ex + n_lanes * n_cls * 4, 2 * n_lanes * n_cls * n_ex,
        library_fn=lambda: torch.matmul(subset_f, counts_f),
    )
    lane_axis_records(records, prep, lane_open, lane_count)
    library_exact = torch.equal(torch.matmul(subset_f, counts_f).to(torch.int32)
                                + prep.cls.count[None, :], lane_count)
    k9 = (stack.viable, stack.zone, stack.ct, stack.open_, stack.pod_count, stack.failed,
          stack.assign_existing, prep.ex_static.init, prep.it_price)
    _, n_slots, n_types = stack.viable.shape
    n_offers = prep.it_price.shape[1] * prep.it_price.shape[2]
    record_kernel(
        records, "lane_finish", "karpenter_core_tpu_torch/csrc/lane_finish.cu",
        "karpenter_core_tpu/ops/solve.py:2140", launches["lane_finish"],
        lambda: k89.lane_finish(*k9), lambda: k89.lane_finish_plain(*k9),
        nbytes(*k9) + n_lanes * (n_slots * 4 + 9),
        n_lanes * (n_slots * n_types * n_offers + n_cls * n_ex),
    )
    # one lane; every slot closed (priced at nothing)
    one_lane = k8[:4] + (sizes_t[-1:],)
    if max_abs_err(k89.sweep_lanes(*one_lane), k89.sweep_lanes_plain(*one_lane)) != 0.0:
        fail("sweep_lanes with one lane differs from its twin")
    closed = (k9[0], k9[1], k9[2], torch.zeros_like(k9[3]), *k9[4:])
    if max_abs_err(k89.lane_finish(*closed), k89.lane_finish_plain(*closed)) != 0.0:
        fail("lane_finish with every slot closed differs from its twin")
    print(f"consolidation path kernels exact: K8 (the coarse pass and one lane), K9 (the "
          f"coarse pass and every slot closed); K8's matmul yardstick exact: {library_exact}",
          flush=True)
    for rec in records:
        per_path = rec.setdefault("launches_per_path", {"cold": cold_launches[rec["name"]],
                                                        "existing": existing_launches[rec["name"]]})
        per_path["consolidation"] = launches[rec["name"]]
    return launches, (snapshot, prep, coarse_sizes, coarse_out)


def lane_axis_records(records, prep, lane_open, lane_count) -> None:
    """Phase 4: K3's two entry points, K6's fused mask and fill and its
    commit at the coarse pass's lanes (B = 64) over phase 3's existing rows,
    stacked as the lanes stack them: the shared planes repeated, each lane
    its own ``open_`` and class counts (K8's outputs).  The class with the
    most pods over the lanes: its merge and compat (K3, both entry points,
    over the 64 x E stacked rows), its intake a lane (K5), the fill of its
    count, the commit of that fill (which merges the selected rows with the
    class row); each held exactly to its twin and timed (``lane_axis`` in
    K3's and K6's records)."""
    from karpenter_core_tpu_torch.kernels import batch, existing, reqmerge
    from karpenter_core_tpu_torch.ops import masks as mask_ops
    from karpenter_core_tpu_torch.ops import solve as solve_ops

    n_b, n_ex = lane_open.shape
    c = int(torch.argmax(lane_count.sum(dim=0)))
    ft = prep.features
    st = solve_ops.StaticArrays(*prep.statics_arrays)
    v = st.valid.shape[-1]
    cls = solve_ops.ClassTensors(*(t[c] for t in prep.cls))
    cls = cls._replace(mask=mask_ops.pack_mask(cls.mask))
    cls_req = mask_ops.ReqTensor(cls.mask[None], cls.defined[None], cls.negative[None],
                                 cls.gt[None], cls.lt[None])
    ex, es = prep.ex_state, prep.ex_static
    host_cap = torch.full((n_ex,), solve_ops.UNLIMITED, dtype=torch.int32, device="cuda")
    ex_b, cls_b, cls_req_b, valid_b, vocab_b, custom_b, es_b, host_cap_b = batch.repeat(
        (ex, cls, cls_req, mask_ops.pack_mask(st.valid), st.vocab_ints, st.is_custom,
         (es.alloc, es.tol[c], es.vol_limit, es.cls_vol_add[c], es.cls_vol_per_pod[c]),
         host_cap), n_b)
    ex_b = ex_b._replace(open_=lane_open.contiguous())
    khb = prep.key_has_bounds
    k3 = (mask_ops.ReqTensor(ex_b.kmask, ex_b.kdef, ex_b.kneg, ex_b.kgt, ex_b.klt), cls_req_b,
          valid_b, vocab_b, custom_b, v, khb)
    n_keys, n_words = ex.kmask.shape[-2:]
    shapes = dict(B=n_b, rows=n_ex, K=n_keys, W=n_words, V=st.vocab_ints.shape[-1])
    # each row's five planes read once (and, merging, written once), the
    # class row and vocabulary of each lane read, compat written
    rows_bytes, class_bytes = nbytes(k3[0]), nbytes(*k3[1:5])
    axis_line(records, "req_merge", "lane_axis", "merge_compat",
              lambda: reqmerge.merge_compat(*k3), lambda: reqmerge.merge_compat_twin(*k3),
              2 * rows_bytes + class_bytes + n_b * n_ex, n_b * n_ex * n_keys * 16, **shapes)
    key_ok_b = axis_line(records, "req_merge", "lane_axis", "req_compat",
                         lambda: reqmerge.req_compat(*k3), lambda: reqmerge.req_compat_twin(*k3),
                         rows_bytes + class_bytes + n_b * n_ex, n_b * n_ex * n_keys * 12,
                         **shapes)
    alloc, tol, vol_limit, vol_add, per_pod = es_b
    cap, _, ct_ok = existing.existing_intake(
        alloc, ex_b.used, ex_b.open_, key_ok_b, tol, ex_b.zone, cls_b.zone, ex_b.ct, cls_b.ct,
        ex_b.ports, cls_b.ports, vol_limit, ex_b.vol_used, vol_add, per_pod, cls_b.requests,
        host_cap_b, ft.host_ports, ft.volume_limits)
    n_zones = ex.zone.shape[-1]
    all_zones = torch.ones((n_b, n_zones), dtype=torch.bool, device="cuda")
    quota = torch.clamp(lane_count[:, c], min=1).contiguous()
    k6m = (cap, ex_b.zone, cls_b.zone, all_zones, None, False, quota)
    assigned, _, zone_ok = axis_line(
        records, "existing_phase", "lane_axis", "mask_fill",
        lambda: existing.existing_mask_fill(*k6m), lambda: existing.existing_mask_fill_twin(*k6m),
        nbytes(*k6m[:4], quota) + n_b * (n_ex * (4 + n_zones) + 4), n_b * n_ex * (n_zones + 6),
        B=n_b, rows=n_ex, cls=c)
    if not bool((assigned > 0).any()):
        fail("existing_phase lane axis: the fill placed nothing to commit")
    k6c = (ex_b, reqmerge.ClassMerge(cls_req_b, valid_b, vocab_b, v, khb), zone_ok, ct_ok,
           cls_b.ports, vol_add, per_pod, cls_b.requests, assigned, ft.host_ports,
           ft.volume_limits)
    selected = int((assigned > 0).sum())
    axis_line(records, "existing_phase", "lane_axis", "commit",
              lambda: existing.existing_commit(*k6c), lambda: existing.existing_commit_twin(*k6c),
              commit_bytes(*k6c), n_b * n_ex * (2 * ex.used.shape[-1] + 4) + selected * n_keys * 16,
              B=n_b, rows=n_ex, selected=selected)
    del ex_b, k3, k6m, k6c
    torch.cuda.empty_cache()


def carry_leaves(carry) -> dict:
    out = {"remaining": carry.remaining}
    for group in ("state", "ex_state", "topo"):
        tup = getattr(carry, group)
        for f in tup._fields:
            out[f"{group}.{f}"] = getattr(tup, f)
    return out


def same_lineage(got, want, label: str) -> None:
    """Two sessions' lineages: every carry leaf and the assignment planes."""
    import numpy as np

    a, b = carry_leaves(got._warm.carry), carry_leaves(want._warm.carry)
    for name, t in a.items():
        if t.shape != b[name].shape or t.dtype != b[name].dtype or not torch.equal(t, b[name]):
            fail(f"{label}: carry leaf {name} differs between the kernels and their plain twins")
    if not (np.array_equal(got._warm.assign, want._warm.assign)
            and np.array_equal(got._warm.assign_ex, want._warm.assign_ex)):
        fail(f"{label}: the assignment planes differ between the kernels and their plain twins")


def full_signature(solver, ingest, state_nodes=None, bound_pods=None):
    """The node signature of a from-scratch solve of the ingest, and its
    wall seconds (encode to decode)."""
    from karpenter_core_tpu_torch.models.store import class_key
    from karpenter_core_tpu_torch.solver.incremental import node_signature_of

    t0 = time.perf_counter()
    snapshot = solver.encode(ingest, state_nodes, bound_pods)
    solver.solve_encoded(snapshot, state_nodes, bound_pods)
    out = solver.last_outputs
    assign, assign_ex = out.assign.cpu().numpy(), out.assign_existing.cpu().numpy()
    wall_s = time.perf_counter() - t0
    keys = [class_key(c) for c in snapshot.classes]
    return node_signature_of(assign, keys) + node_signature_of(assign_ex, keys), wall_s


def churn_path(records, mid_cluster, path_launches) -> dict:
    """Phase 5: the warm repair's serial delta tick, at the headline's full
    width and on the mid-size live cluster; then K10-K12 against their twins
    on the headline's last tick's inputs."""
    from karpenter_core_tpu_torch.kernels import repair
    from karpenter_core_tpu_torch.models.columnar import PodIngest
    from karpenter_core_tpu_torch.ops import solve as solve_ops
    from karpenter_core_tpu_torch.solver.incremental import (
        FallbackPolicy,
        IncrementalSolveSession,
    )
    from karpenter_core_tpu_torch.testing.workloads import build_inputs, churn_tick

    # -- (a) the headline backlog under 2 % churn -----------------------------
    solver, pods = build_inputs(N_PODS, N_TYPES, N_PROVISIONERS)
    plain_solver, _ = build_inputs(N_PODS, N_TYPES, N_PROVISIONERS, use_kernels=False)
    fresh_history()
    ingest = PodIngest()
    ingest.add_all(pods)
    session = IncrementalSolveSession(solver, FallbackPolicy(**CHURN_POLICY))
    plain = IncrementalSolveSession(plain_solver, FallbackPolicy(**CHURN_POLICY))
    t0 = time.perf_counter()
    session.solve(ingest)
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    plain.solve(ingest)
    same_lineage(session, plain, "churn seed")
    # record the last tick's K10-K12 inputs for the kernel checks below
    recorded = {}
    originals = {name: getattr(solve_ops, name) for name in
                 ("repair_free", "gather_repair_window", "scatter_repair_window")}

    def recording(name):
        def call(*args, **kwargs):
            if kwargs.get("use_kernels", True):
                recorded[name] = args
            return originals[name](*args, **kwargs)
        return call

    launches = {name: 0 for name in launch_counts()}
    reps = {}
    ticks = []
    for tick in range(len(HEADLINE_CHURN["evicted"])):
        evicted, _ = churn_tick(ingest, tick, reps)
        full_sig, full_s = full_signature(solver, ingest)
        torch.cuda.synchronize()
        for name in originals:
            setattr(solve_ops, name, recording(name))
        reset_launches()
        solve_ops.host_syncs = 0
        t0 = time.perf_counter()
        session.solve(ingest)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        tick_launches = launch_counts()
        syncs = solve_ops.host_syncs
        for name, value in originals.items():
            setattr(solve_ops, name, value)
        for name, n in tick_launches.items():
            launches[name] += n
        plain.solve(ingest)
        window = session.last_window
        row = {"run": f"churn tick {tick}", "mode": session.last_mode,
               "reason": session.last_reason, "wall_s": wall_s, **session.stages,
               "full_resolve_s": full_s, "host_syncs": syncs, **session.last_evicted,
               "window": None if window is None else len(window[0]),
               "launches": {k: v for k, v in tick_launches.items() if v}}
        print(json.dumps(row), flush=True)
        ticks.append(row)
        if session.last_mode != "delta":
            fail(f"churn tick {tick}: {session.last_mode} ({session.last_reason}), not delta")
        if session.node_signature() != full_sig:
            fail(f"churn tick {tick}: the lineage differs from a full re-solve")
        want = {k: HEADLINE_CHURN[k][tick] for k in ("evicted", "hole_slots", "window")}
        got = {"evicted": len(evicted), "hole_slots": row["hole_slots"], "window": row["window"]}
        if got != want or session.last_evicted["evicted"] != len(evicted):
            fail(f"churn tick {tick}: {got}, the JAX package's answer is {want}")
        if (plain.last_mode, plain.last_reason) != (session.last_mode, session.last_reason):
            fail(f"churn tick {tick}: the plain-twin session took {plain.last_mode}")
        same_lineage(session, plain, f"churn tick {tick}")
    agg = session.aggregates()
    print(json.dumps({"churn_headline": {"seed_full_s": seed_s, "aggregates": agg,
                                         "launches": launches}}), flush=True)
    if agg != HEADLINE_CHURN["aggregates"]:
        fail(f"churn: {agg}, the JAX package's answer is {HEADLINE_CHURN['aggregates']}")
    check_launched(launches, CHURN_KERNELS, "churn path")
    print("churn path (a): 5 delta ticks identical to full re-solves, kernel lineage equal "
          "to the plain-twin lineage after every tick", flush=True)
    del plain, plain_solver

    # -- (b) the mid-size live cluster ----------------------------------------
    mid_nodes, mid_bound = mid_cluster
    mid_solver, mid_pods = build_inputs(MID_PODS, MID_TYPES, N_PROVISIONERS)
    slots_used("churn headline")
    fresh_history()
    mid_ingest = PodIngest()
    mid_ingest.add_all(mid_pods)
    mid = IncrementalSolveSession(mid_solver, FallbackPolicy(**CHURN_POLICY))
    check = IncrementalSolveSession(mid_solver, FallbackPolicy(enabled=False))
    t0 = time.perf_counter()
    mid.solve(mid_ingest, mid_nodes, mid_bound)
    check.solve(mid_ingest, mid_nodes, mid_bound)
    print(json.dumps({"run": "churn mid-size seed (both sessions)",
                      "wall_s": time.perf_counter() - t0}), flush=True)
    reps = {}
    evicted_ex, evicted_new = [], []
    for tick in range(MID_CHURN["ticks"]):
        churn_tick(mid_ingest, tick, reps)
        t0 = time.perf_counter()
        mid.solve(mid_ingest, mid_nodes, mid_bound)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        check.solve(mid_ingest, mid_nodes, mid_bound)
        print(json.dumps({"run": f"churn mid-size tick {tick}", "mode": mid.last_mode,
                          "wall_s": wall_s, **mid.stages, **mid.last_evicted}), flush=True)
        if mid.last_mode != "delta" or mid.node_signature() != check.node_signature():
            fail(f"churn mid-size tick {tick}: {mid.last_mode} ({mid.last_reason}), "
                 "or the lineage differs from a full re-solve")
        evicted_ex.append(mid.last_evicted["existing"])
        evicted_new.append(mid.last_evicted["new"])
    got = {"ticks": MID_CHURN["ticks"], "evicted_existing": evicted_ex,
           "evicted_new": evicted_new, "aggregates": mid.aggregates()}
    print(json.dumps({"churn_mid": got}), flush=True)
    slots_used("churn mid-size")
    if got != MID_CHURN:
        fail(f"churn mid-size: {got}, the JAX package's answer is {MID_CHURN}")
    del mid, check, mid_solver

    # -- K10-K12 on the headline's last tick's inputs --------------------------
    carry, free_new, free_ex, requests, member, own_inv = recorded["repair_free"]
    st, ex, topo = carry.state, carry.ex_state, carry.topo
    k10 = (st.used, st.pod_count, topo.fwd_new, topo.inv_new, ex.used, ex.pod_count,
           topo.fwd_ex, topo.inv_ex, free_new, free_ex, requests, member, own_inv)
    k10_out = repair.repair_free(*k10)
    n_cls, n_slots = free_new.shape
    n_res, g1 = requests.shape[1], member.shape[1]
    columns = n_slots + free_ex.shape[1]
    free_t = free_new.t().float().contiguous()
    record_kernel(
        records, "repair_free", "karpenter_core_tpu_torch/csrc/repair_free.cu",
        "karpenter_core_tpu/ops/solve.py:1960", launches["repair_free"],
        lambda: repair.repair_free(*k10), lambda: repair.repair_free_plain(*k10),
        nbytes(*k10) + nbytes(*k10_out), 2 * n_cls * columns * (n_res + 2 * g1 + 1),
        library_fn=lambda: torch.matmul(free_t, requests),
    )
    # K10 on dense evictions (most slots freed by several classes) and
    # full-mantissa requests, where the order of the fused class sum shows
    gen = torch.Generator(device="cpu").manual_seed(10)
    dense = (torch.randint(0, 8, tuple(free_new.shape), generator=gen, dtype=torch.int32).cuda(),
             torch.randint(0, 8, tuple(free_ex.shape), generator=gen, dtype=torch.int32).cuda(),
             (torch.rand(tuple(requests.shape), generator=gen) * 4).cuda())
    k10_dense = k10[:8] + dense + (member, own_inv)
    err = max_abs_err(repair.repair_free(*k10_dense), repair.repair_free_plain(*k10_dense))
    if err != 0.0:
        fail(f"repair_free on dense full-mantissa input differs from its twin: {err}")
    freed, idx, n_open = recorded["gather_repair_window"]
    rows = tuple(getattr(freed.state, f) for f in repair.ROW_PLANES)
    k11 = (rows, freed.topo.fwd_new, freed.topo.inv_new, idx, n_open)
    n_window = idx.shape[0]
    row_bytes = sum(nbytes(p) // n_slots for p in rows)
    bases_in = nbytes(freed.state.zone, freed.state.open_, freed.topo.fwd_new, freed.topo.inv_new)
    n_zones = freed.state.zone.shape[1]
    record_kernel(
        records, "repair_gather", "karpenter_core_tpu_torch/csrc/repair_gather.cu",
        "karpenter_core_tpu/ops/solve.py:2016", launches["repair_gather"],
        lambda: repair.gather_window(*k11), lambda: repair.gather_window_plain(*k11),
        2 * n_window * row_bytes + nbytes(idx) + bases_in + 2 * g1 * n_window * 4
        + 3 * g1 * n_zones * 4 + 4,
        n_slots * g1 * n_zones * 6,
    )
    full, window, idx_s, n_open_s = recorded["scatter_repair_window"]
    w_rows = tuple(getattr(window.state, f) for f in repair.ROW_PLANES)
    f_rows = tuple(getattr(full.state, f) for f in repair.ROW_PLANES)
    k12 = (f_rows, full.topo.fwd_new, full.topo.inv_new, full.state.n_next, w_rows,
           window.topo.fwd_new, window.topo.inv_new, window.state.n_next, idx_s, n_open_s)
    n_win = idx_s.shape[0]
    topo_row = 2 * g1 * 4  # fwd and inv, one int32 each per slot and group
    record_kernel(
        records, "repair_scatter", "karpenter_core_tpu_torch/csrc/repair_scatter.cu",
        "karpenter_core_tpu/ops/solve.py:2070", launches["repair_scatter"],
        lambda: repair.scatter_window(*k12), lambda: repair.scatter_window_plain(*k12),
        (n_slots - n_win) * (row_bytes + topo_row) + n_win * (row_bytes + topo_row)
        + nbytes(idx_s) + n_slots * (row_bytes + topo_row) + 12,
        n_slots * 2,
    )
    print(f"churn path kernels exact: K10 (C={n_cls}, N={n_slots}, E={free_ex.shape[1]}; and on "
          f"dense full-mantissa input), K11 and K12 (S={n_window} of N={n_slots})", flush=True)
    for rec in records:
        per_path = rec.setdefault("launches_per_path", {})
        for path, counts in path_launches.items():
            per_path.setdefault(path, counts[rec["name"]])
        per_path["churn"] = launches[rec["name"]]
    return launches


def policy_path(records, mid_cluster, path_launches) -> dict:
    """Phase 6: the policy objective — the headline backlog under the policy
    at full width (K13 on its final state against its twin), the mid-size
    consolidation under cost-delta scoring, and the mid-size session's
    escalation when an offering's interruption rate moves.  Returns (a)'s
    cold-run launches."""
    import numpy as np

    from karpenter_core_tpu_torch.kernels import objective
    from karpenter_core_tpu_torch.models.columnar import PodIngest
    from karpenter_core_tpu_torch.ops import objective as objective_ops
    from karpenter_core_tpu_torch.policy import PolicyConfig, planes_of
    from karpenter_core_tpu_torch.solver.consolidation import CudaConsolidationSearch
    from karpenter_core_tpu_torch.solver.incremental import (
        FallbackPolicy,
        IncrementalSolveSession,
    )
    from karpenter_core_tpu_torch.testing.workloads import (
        build_inputs,
        build_provider,
        churn_tick,
        consolidation_candidates,
        move_spot_market,
    )

    # -- (a) the headline backlog, zone-2 spot at 0.6x, the policy on ----------
    config = PolicyConfig(enabled=True)
    solver, pods = build_inputs(N_PODS, N_TYPES, N_PROVISIONERS, policy=config)
    move_spot_market(solver.cloud_provider)
    fresh_history()
    reset_launches()
    runs = []
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        ingest = PodIngest()
        ingest.add_all(pods)
        ingest_s = time.perf_counter() - t0
        results = solver.solve(ingest)
        torch.cuda.synchronize()
        runs.append((label, ingest_s, dict(solver.stages), time.perf_counter() - t0, results))
        if label == "cold":
            launches = launch_counts()
    slots_used("policy headline")
    selection = solver.last_selection
    for label, ingest_s, stages, total_s, results in runs:
        hist = {}
        for d in results.new_nodes:
            if d.selected is not None:
                key = f"{d.selected['zone']}/{d.selected['capacity_type']}"
                hist[key] = hist.get(key, 0) + 1
        got = {"active": sum(hist.values()), "hist": dict(sorted(hist.items())),
               "fleet_cost": results.fleet_cost, "fleet_expected": results.fleet_expected_cost}
        print(json.dumps({"run": f"policy {label}", "wall_s": total_s, "ingest_s": ingest_s,
                          **stages, "decode.objective_s": stages["objective_s"],
                          "nodes": len(results.new_nodes), **got}), flush=True)
        if got != POLICY_HEADLINE or len(results.new_nodes) != EXPECTED_NODES:
            fail(f"policy {label}: {got}, the JAX package's answer is {POLICY_HEADLINE}")
        for d in results.new_nodes:
            if d.zones != [d.selected["zone"]] or d.capacity_types != [
                    d.selected["capacity_type"]] or d.instance_type_names[0] != d.selected[
                    "instance_type"]:
                fail(f"policy {label}: a node's launch lists do not pin its selected offering")
    print(json.dumps({"policy_cold_run_launches": launches}), flush=True)
    check_launched(launches, POLICY_KERNELS, "policy path")
    plain_solver, _ = build_inputs(N_PODS, N_TYPES, N_PROVISIONERS, policy=config,
                                   use_kernels=False)
    move_spot_market(plain_solver.cloud_provider)
    ingest = PodIngest()
    ingest.add_all(pods)
    t0 = time.perf_counter()
    plain_solver.solve(ingest)
    torch.cuda.synchronize()
    print(json.dumps({"run": "policy plain twins (use_kernels=False)",
                      "wall_s": time.perf_counter() - t0, **plain_solver.stages}), flush=True)
    for name, a, b in zip(selection._fields, selection, plain_solver.last_selection):
        if not np.array_equal(a, b):
            fail(f"policy: selection leaf {name} differs from the use_kernels=False run")
    print("policy path (a): every selection leaf equals the plain-twin run; the JAX "
          "package's selection pinned", flush=True)
    del plain_solver

    # K13 on that final state, against its twin
    state = solver.last_outputs.state
    snapshot = solver.encode(ingest)
    planes = planes_of(snapshot)
    is_spot = torch.tensor([c == "spot" for c in snapshot.capacity_types], device="cuda")
    k13 = (state.viable, state.zone, state.ct, state.open_, state.pod_count,
           torch.as_tensor(planes.price).cuda(), torch.as_tensor(planes.risk).cuda(),
           torch.as_tensor(planes.throughput).cuda(), is_spot, objective_ops.weights_of(config))
    n_slots, n_types = state.viable.shape
    cells = planes.price.size
    record_kernel(
        records, "select_offerings", "karpenter_core_tpu_torch/csrc/select_offerings.cu",
        "karpenter_core_tpu/ops/objective.py:87", launches["select_offerings"],
        lambda: objective.select_offerings(*k13), lambda: objective.select_offerings_plain(*k13),
        nbytes(*k13[:9]) + n_slots * (5 * 4 + 1) + 8, 8 * n_slots * cells + 5 * cells,
    )
    # full-mantissa risks and throughputs with every knob non-zero
    gen = torch.Generator(device="cpu").manual_seed(13)
    knobs = objective_ops.weights_of(PolicyConfig(
        enabled=True, cost_weight=0.7310001, throughput_weight=0.3330001,
        risk_aversion=0.6170001))
    fuzz = k13[:6] + (torch.rand(tuple(planes.risk.shape), generator=gen).cuda(),
                      torch.rand(tuple(planes.throughput.shape), generator=gen).cuda(),
                      is_spot, knobs)
    err = max_abs_err(objective.select_offerings(*fuzz), objective.select_offerings_plain(*fuzz))
    if err != 0.0:
        fail(f"select_offerings with non-zero knobs differs from its twin: {err}")
    print("policy path kernel exact: K13 (the final state; full-mantissa knobs)", flush=True)
    rec = records[-1]
    rec["launches_per_path"] = {**{path: counts["select_offerings"]
                                   for path, counts in path_launches.items()},
                                "policy": launches["select_offerings"]}
    for other in records[:-1]:
        other["launches_per_path"]["policy"] = launches[other["name"]]
    del solver

    # -- (b) the mid-size consolidation under cost-delta scoring -----------------
    mid_nodes, mid_bound = mid_cluster
    fresh_history()
    t0 = time.perf_counter()
    search = CudaConsolidationSearch(*build_provider(MID_TYPES, N_PROVISIONERS), policy=config)
    cmd = search.compute_command(
        consolidation_candidates(mid_nodes, mid_bound, MID_TYPES, N_PROVISIONERS), [],
        mid_nodes, mid_bound)
    summary = command_summary(cmd)
    print(json.dumps({"run": "consolidation mid-size, policy on",
                      "wall_s": time.perf_counter() - t0,
                      "passes": [len(sizes) for sizes, _ in search.passes], **summary}), flush=True)
    if summary != MID_POLICY_CONSOLIDATION or len(search.passes) != 1:
        fail(f"policy consolidation: {summary}, the JAX package's answer is "
             f"{MID_POLICY_CONSOLIDATION} in one pass")
    del search, cmd

    # -- (c) the mid-size session escalates on an interruption-rate change ------
    mid_solver, mid_pods = build_inputs(MID_PODS, MID_TYPES, N_PROVISIONERS)
    mid_ingest = PodIngest()
    mid_ingest.add_all(mid_pods)
    session = IncrementalSolveSession(mid_solver, FallbackPolicy(**CHURN_POLICY))
    fresh_history()
    modes, reps = [], {}
    for tick in range(4):
        if tick == 2:
            mid_solver.cloud_provider.set_interruption_rate(f"fake-it-{MID_TYPES - 1}", 0.3)
        if tick:
            churn_tick(mid_ingest, tick, reps)
        session.solve(mid_ingest, mid_nodes, mid_bound)
        torch.cuda.synchronize()
        modes.append((session.last_mode, session.last_reason))
    print(json.dumps({"run": "churn mid-size, interruption rate moved before tick 2",
                      "ticks": modes}), flush=True)
    slots_used("policy escalation")
    want = [("full", "first"), ("delta", None), ("full", POLICY_ESCALATION_REASON),
            ("delta", None)]
    if [(m, r if m == "full" else None) for m, r in modes] != want:
        fail(f"policy escalation: {modes}, expected {want}")
    print("policy path (b, c): the consolidation command and the escalation equal the JAX "
          "package's", flush=True)
    return launches


def relax_summary(solver, results) -> dict:
    stats = solver.last_relax_stats or {}
    return {"mode": solver.last_solve_mode, "iters": stats.get("iters"),
            "converged": stats.get("converged"),
            "rounded_violations": stats.get("rounded_violations"),
            "placed": stats.get("placed"), "leftover": stats.get("leftover"),
            "nodes": len(results.new_nodes),
            "scheduled": sum(len(n.pods) for n in results.new_nodes),
            "failed": len(results.failed_pods), "fleet_cost": results.fleet_cost,
            "n_next": results.n_slots_used}


def class_axis_records(records, cls, statics) -> None:
    """K3 and K1 over the class axis at the relax path's shapes (the class
    planes of ``relax.kernel.class_template_planes``), each held against
    its twin class by class and timed; ``class_axis`` in their records."""
    from karpenter_core_tpu_torch.kernels import batch, capacity, reqmerge
    from karpenter_core_tpu_torch.ops import masks as mask_ops

    n_c = cls.count.shape[0]
    n_t, n_z = statics.tmpl_zone.shape
    n_i, n_ct = statics.it_alloc.shape[0], statics.tmpl_ct.shape[-1]
    rows = mask_ops.ReqTensor(*(t[:, None] for t in (cls.mask, cls.defined, cls.negative,
                                                     cls.gt, cls.lt)))
    tmpl, valid, vocab_ints, is_custom, it, daemon, alloc = batch.repeat(
        (statics.tmpl, statics.valid, statics.vocab_ints, statics.is_custom, statics.it,
         statics.tmpl_daemon, statics.it_alloc), n_c)
    v, khb = statics.mask_v, statics.key_has_bounds
    k3 = (tmpl, rows, valid, vocab_ints, is_custom, v, khb)
    merged, _ = reqmerge.merge_compat(*k3)
    ones = dict(dtype=torch.bool, device="cuda")
    k1 = (torch.ones((n_c, n_t, n_i), **ones), torch.ones((n_c, n_i), **ones), merged, it,
          vocab_ints, v, khb, torch.ones((n_c, n_t, n_z), **ones),
          torch.ones((n_c, n_t, n_ct), **ones), torch.ones((n_c, n_i, n_z, n_ct), **ones),
          daemon, cls.requests, alloc)
    # the bytes the class planes need: each shared template and catalog
    # plane once (not its C copies), each class's row and requests, the
    # outputs; K1's all-true planes are constants the function does not need
    shared_k3 = nbytes(statics.tmpl, statics.valid, statics.vocab_ints, statics.is_custom)
    shared_k1 = nbytes(statics.it, statics.vocab_ints, statics.tmpl_daemon, statics.it_alloc)
    for name, fn, plain, args, moved, ops in (
        ("req_merge", reqmerge.merge_compat, reqmerge.merge_compat_twin, k3,
         shared_k3 + nbytes(rows) + nbytes(tuple(merged)) + n_c * n_t, tmpl.mask.numel() * 8),
        ("it_capacity", capacity.it_capacity, capacity.it_capacity_twin, k1,
         shared_k1 + nbytes(tuple(merged), cls.requests) + n_c * n_t * (n_i * 5 + 4),
         n_c * n_t * n_i * (it.mask.shape[-2] * 6 + 12 + 4 * alloc.shape[-1])),
    ):
        axis_line(records, name, "class_axis", None, lambda: fn(*args), lambda: plain(*args),
                  moved, ops, B=n_c)


def relax_path(records, path_launches) -> dict:
    """Phase 7: the relax family — the headline backlog through the relax
    solver with the policy on and off, the two small fleets (relax_line's
    and the window's), then K14 and K16-K18 against their twins at the
    headline's shapes and in three edge cases.  Returns this path's
    launches (the cold relax solve of (a))."""
    from karpenter_core_tpu_torch.cloudprovider import fake as fake_cp
    from karpenter_core_tpu_torch.kernels import relax as kr
    from karpenter_core_tpu_torch.models.columnar import PodIngest
    from karpenter_core_tpu_torch.ops import masks as mask_ops
    from karpenter_core_tpu_torch.ops import solve as solve_ops
    from karpenter_core_tpu_torch.policy import PolicyConfig
    from karpenter_core_tpu_torch.relax import kernel as relax_kernel
    from karpenter_core_tpu_torch.relax import prng
    from karpenter_core_tpu_torch.relax import solve as relax_solve
    from karpenter_core_tpu_torch.solver import modes
    from karpenter_core_tpu_torch.solver.cuda import CudaSolver
    from karpenter_core_tpu_torch.testing import make_pod, make_provisioner
    from karpenter_core_tpu_torch.testing.workloads import (
        HEADLINE_SIZES,
        build_inputs,
        move_spot_market,
        relax_fleet,
    )

    # launches inside relax_core, read as it returns: the rest of a solve's
    # launches are its repair's and its decode's
    inner = {}
    core = relax_kernel.relax_core

    def counted_core(*args, **kwargs):
        out = core(*args, **kwargs)
        inner["relax"] = launch_counts()
        return out

    relax_kernel.relax_core = counted_core

    def run(solver, pods, label, pin, plain_solver=None):
        runs = []
        fresh_history()
        for lap in ("cold", "warm"):
            t0 = time.perf_counter()
            ingest = PodIngest()
            ingest.add_all(pods)
            ingest_s = time.perf_counter() - t0
            reset_launches()
            results = solver.solve(ingest)
            torch.cuda.synchronize()
            total = launch_counts()
            runs.append((lap, ingest_s, dict(solver.stages), time.perf_counter() - t0, results))
            if lap == "cold":
                launches = total
                repair = {k: total[k] - inner["relax"][k] for k in total}
                relax_only = dict(inner["relax"])
            got = relax_summary(solver, results)
            print(json.dumps({"run": f"{label} {lap}", "wall_s": runs[-1][3], "ingest_s": ingest_s,
                              **runs[-1][2], **got}), flush=True)
            if got != pin:
                fail(f"{label} {lap}: {got}, the JAX package's answer is {pin}")
        slots_used(label)
        out = solver.last_outputs
        if plain_solver is not None:
            ingest = PodIngest()
            ingest.add_all(pods)
            t0 = time.perf_counter()
            plain_solver.solve(ingest)
            torch.cuda.synchronize()
            print(json.dumps({"run": f"{label} plain twins (use_kernels=False)",
                              "wall_s": time.perf_counter() - t0, **plain_solver.stages}),
                  flush=True)
            same_leaves(out, plain_solver.last_outputs, label)
        return launches, relax_only, repair

    # -- (a) the headline backlog, zone-2 spot at 0.6x, the relax family --------
    config = PolicyConfig(enabled=True, solver_mode="relax")
    solver, pods = build_inputs(N_PODS, N_TYPES, N_PROVISIONERS, policy=config)
    plain, _ = build_inputs(N_PODS, N_TYPES, N_PROVISIONERS, policy=config, use_kernels=False)
    for s in (solver, plain):
        move_spot_market(s.cloud_provider)
    launches, relax_only, repair = run(solver, pods, "relax headline", RELAX_HEADLINE, plain)
    class_planes = {name: relax_only[name] for name in ("req_merge", "it_capacity")}
    print(json.dumps({"relax_cold_run_launches": launches, "in_relax_core": relax_only,
                      "in_repair_and_decode": repair,
                      "class_planes_launches": class_planes}), flush=True)
    check_launched(relax_only, RELAX_KERNELS, "relax path's relax_core")
    if class_planes != {"req_merge": 1, "it_capacity": 1}:
        fail(f"relax_core's class planes launched {class_planes}, not K3 and K1 once each")
    check_launched(repair, PROVISIONING_KERNELS, "relax path's repair")
    check_launched(launches, ("select_offerings",), "relax path's policy decode")
    del plain
    ingest = PodIngest()
    ingest.add_all(pods)
    prep = solver.prepare_encoded(solver.encode(ingest))

    # -- (b) phase 1's backlog, no policy, KC_SOLVER_MODE=relax -------------------
    os.environ["KC_SOLVER_MODE"] = "relax"
    off, _ = build_inputs(N_PODS, N_TYPES, N_PROVISIONERS)
    off_plain, _ = build_inputs(N_PODS, N_TYPES, N_PROVISIONERS, use_kernels=False)
    run(off, pods, "relax policy off", RELAX_OFF, off_plain)
    del os.environ["KC_SOLVER_MODE"], off, off_plain

    # -- (c) relax_line's fleet, both legs, and the window fleet -------------------
    legs = {}
    for mode in ("scan", "relax"):
        fresh_history()
        s, fleet = relax_fleet(4000, 24, ({"cpu": "500m", "memory": "512Mi"},), mode=mode)
        ingest = PodIngest()
        ingest.add_all(fleet)
        t0 = time.perf_counter()
        legs[mode] = relax_summary(s, s.solve(ingest))
        legs[mode]["wall_s"] = time.perf_counter() - t0
    got = {"fleet_cost_delta": legs["scan"]["fleet_cost"] - legs["relax"]["fleet_cost"],
           "relax_iters": legs["relax"]["iters"], "relax_leftover": legs["relax"]["leftover"],
           "scan_nodes": legs["scan"]["nodes"], "relax_nodes": legs["relax"]["nodes"],
           "fleet_cost": legs["relax"]["fleet_cost"]}
    print(json.dumps({"run": "relax_line", **got, "scan_wall_s": legs["scan"]["wall_s"],
                      "relax_wall_s": legs["relax"]["wall_s"]}), flush=True)
    if got != RELAX_LINE or legs["relax"]["mode"] != "relax":
        fail(f"relax_line: {got}, the JAX package's answer is {RELAX_LINE}")
    windows = []
    gather = solve_ops.gather_repair_window

    def spy(carry, idx, n_open_w, *args, **kwargs):
        windows.append(int(idx.shape[0]))
        return gather(carry, idx, n_open_w, *args, **kwargs)

    solve_ops.gather_repair_window = spy
    fresh_history()
    s, fleet = relax_fleet(2500, 24, HEADLINE_SIZES)
    ingest = PodIngest()
    ingest.add_all(fleet)
    reset_launches()
    results = s.solve(ingest)
    torch.cuda.synchronize()
    window_launches = launch_counts()
    solve_ops.gather_repair_window = gather
    got = {**relax_summary(s, results), "slots": int(s.last_outputs.assign.shape[1]),
           "window": windows[0] if len(windows) == 1 else windows}
    got.pop("converged"), got.pop("rounded_violations"), got.pop("scheduled"), got.pop("n_next")
    print(json.dumps({"run": "relax window fleet", **got, "launches": window_launches}),
          flush=True)
    if got != RELAX_WINDOW:
        fail(f"relax window fleet: {got}, the JAX package's answer is {RELAX_WINDOW}")
    check_launched(window_launches, ("repair_gather", "repair_scatter"), "relax window repair")

    # -- (d) K14, K16-K18 against their twins at (a)'s shapes ----------------------
    cls, statics = relax_kernel.packed_statics(prep.cls, prep.statics_arrays,
                                               prep.key_has_bounds)
    width = statics.mask_v
    class_axis_records(records, cls, statics)
    eligible = torch.as_tensor(relax_solve.eligible_classes(prep), device="cuda")
    counts = torch.where(eligible, cls.count, 0).to(torch.int32)
    merged, key_ok, it_int, per_pod = relax_kernel.class_template_planes(cls, statics)
    planes = kr.RelaxPlanes(it_int, per_pod, key_ok, statics.tmpl_it, cls.it, statics.tmpl_zone,
                            cls.zone, statics.tmpl_ct, cls.ct, statics.it_avail)
    weights = torch.as_tensor(relax_solve._policy_weights(config), device="cuda")
    pol = prep.pol
    n_c, n_t, n_i = it_int.shape
    n_z, n_ct = statics.tmpl_zone.shape[1], statics.tmpl_ct.shape[1]
    n_s, n_slots = n_i * n_z, prep.n_slots
    record = functools.partial(record_kernel, records)
    k14_in = (planes, pol.price, pol.risk, pol.throughput, weights, counts)
    cost, support, tstar, feas, cost_max = record(
        "relax_cost", "karpenter_core_tpu_torch/csrc/relax_cost.cu",
        "karpenter_core_tpu/relax/kernel.py:192", launches["relax_cost"],
        lambda: kr.relax_cost(*k14_in), lambda: kr.relax_cost_plain(*k14_in),
        nbytes(tuple(planes), *k14_in[1:]) + n_c * n_s * 9 + n_c * n_t * n_i * n_z + 4 * n_c,
        n_c * n_t * n_i * n_z * (6 * n_ct + 6))
    max_iters = modes.relax_max_iters()
    k16_in = (cost, support, cost_max, counts, max_iters, float(relax_solve.RELAX_TOL))
    projections = int(kr.simplex_pgd_plain(*k16_in)[2]) + 1  # this run's loop, and x0
    x, cost_eff, _, _ = record(
        "simplex_pgd", "karpenter_core_tpu_torch/csrc/simplex_pgd.cu",
        "karpenter_core_tpu/relax/kernel.py:94", launches["simplex_pgd"],
        lambda: kr.simplex_pgd(*k16_in), lambda: kr.simplex_pgd_plain(*k16_in),
        nbytes(cost, support, cost_max, counts) + 8 * n_c * n_s + 8,
        projections * n_c * (n_s * max(n_s - 1, 1).bit_length() + 10 * n_s))
    perm = torch.as_tensor(prng.permutation(relax_solve.RELAX_SEED, n_s).copy(), device="cuda")
    k17_in = (x, cost, cost_eff, support, counts, perm, tstar, planes)
    n_ok, _, _ = record(
        "relax_round", "karpenter_core_tpu_torch/csrc/relax_round.cu",
        "karpenter_core_tpu/relax/kernel.py:264", launches["relax_round"],
        lambda: kr.relax_round(*k17_in), lambda: kr.relax_round_plain(*k17_in),
        nbytes(x, cost, cost_eff, support, counts, perm, tstar, tuple(planes))
        + 4 * n_c * n_s + 8,
        n_c * (n_s * max(n_s - 1, 1).bit_length() + 20 * n_s))
    t_ct = statics.tmpl_ct[None] & cls.ct[:, None]
    kmask0 = mask_ops.const_words("full", width, "cuda")
    k18_in = (n_ok, tstar, per_pod, cls.count, merged, t_ct, feas, statics.tmpl_daemon,
              cls.requests, kmask0, n_slots, cls.ports.shape[-1])
    materialized = kr.relax_materialize(*k18_in)
    record(
        "relax_materialize", "karpenter_core_tpu_torch/csrc/relax_materialize.cu",
        "karpenter_core_tpu/relax/kernel.py:321", launches["relax_materialize"],
        lambda: tuple(kr.relax_materialize(*k18_in)),
        lambda: tuple(kr.relax_materialize_plain(*k18_in)),
        nbytes(*k18_in[:4], tuple(merged), t_ct, feas, statics.tmpl_daemon, cls.requests, kmask0)
        + nbytes(tuple(materialized)), n_c * n_s * 10 + n_slots * (n_i + 64))
    # edge cases: K16 stopped by its cap; K17's seeded order on a class of
    # 3,000,000 pods (24 types, 16 slots); K18 with half the slots it filled
    cap_in = (cost, support, cost_max, counts, 1, float(relax_solve.RELAX_TOL))
    err = max_abs_err(kr.simplex_pgd(*cap_in), kr.simplex_pgd_plain(*cap_in))
    if err != 0.0 or bool(kr.simplex_pgd(*cap_in)[3]):
        fail(f"simplex_pgd at max_iters=1 differs from its twin or converged ({err})")
    spill_slots = max(int(materialized.state[-1]) // 2, 1)  # half the nodes it opened
    spill_in = k18_in[:10] + (spill_slots,) + k18_in[11:]
    spilled = kr.relax_materialize(*spill_in)
    err = max_abs_err(tuple(spilled), tuple(kr.relax_materialize_plain(*spill_in)))
    if err != 0.0 or int(spilled.spilled) <= 0:
        fail(f"relax_materialize at {spill_slots} slots differs from its twin or did not "
             f"spill ({err})")
    big = CudaSolver(fake_cp.FakeCloudProvider(fake_cp.instance_types(24)),
                     [make_provisioner(name="default")],
                     policy=PolicyConfig(enabled=True, solver_mode="relax"))
    big_prep = big.prepare_encoded(big.encode([make_pod(requests={"cpu": 3})]))
    count = torch.zeros_like(big_prep.cls.count)
    count[0] = 3_000_000
    big_cls = big_prep.cls._replace(count=count)
    seeded = {}
    for seed in (0, 1, 7):
        runs = [relax_kernel.relax_core(
            big_cls, big_prep.statics_arrays, *big_prep.pol,
            torch.as_tensor(relax_solve.eligible_classes(big_prep, big_cls), device="cuda"),
            weights, max_iters, float(relax_solve.RELAX_TOL), seed, n_slots=16,
            key_has_bounds=big_prep.key_has_bounds, use_kernels=use) for use in (True, False)]
        err = max_abs_err(tuple(runs[0]), tuple(runs[1]))
        if err != 0.0:
            fail(f"relax_core on the 3,000,000-pod class (seed {seed}) differs: {err}")
        seeded[seed] = (int(runs[0].placed), int(torch.argmax(runs[0].state.zone[0].int())))
    print(json.dumps({"relax_seeded_rounding": seeded}), flush=True)
    if seeded != {0: (112, 0), 1: (112, 0), 7: (106, 1)}:
        fail(f"seeded rounding {seeded}, the JAX package's is 112/112/106 in zones 0/0/1")
    print("relax path kernels exact: K14, K16-K18 at the headline's shapes; K16 at "
          "max_iters=1; K17 seeds 0/1/7 on 3,000,000 pods; K18 spilling at half its slots",
          flush=True)
    relax_kernel.relax_core = core
    for rec in records[-4:]:
        rec["launches_per_path"] = {**{path: counts_[rec["name"]]
                                       for path, counts_ in path_launches.items()},
                                    "relax": launches[rec["name"]]}
    for other in records[:-4]:
        other["launches_per_path"]["relax"] = launches[other["name"]]
    return launches


def run_threads(fns):
    """Run thunks on threads, one each; returns their results in order and
    re-raises the first error."""
    import threading

    results, errors = [None] * len(fns), []

    def wrap(i, fn):
        try:
            results[i] = fn()
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(i, fn)) for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def capture_dispatch(entry, sink: list) -> None:
    """Record (prep, kwargs, outputs) of every dispatch a tenant's session
    makes through the plane's hook."""
    hook = entry.session._run_prepared

    def recorded(prep, **kw):
        out = hook(prep, **kw)
        sink.append((prep, kw, out))
        return out

    entry.session._run_prepared = recorded


def tenant_plane(window_s: float, max_batch: int):
    from karpenter_core_tpu_torch.service.tenant import TenantConfig, TenantPlane
    from karpenter_core_tpu_torch.utils.clock import FakeClock

    return TenantPlane(clock=FakeClock(), config=TenantConfig(
        rate_per_s=1000.0, burst=1000, max_inflight=64, batch_window_s=window_s,
        max_batch=max_batch))


def bind_tenants(plane, worlds, sinks=None) -> list:
    """Admit each tenant, bind its solver to its session and (with
    ``sinks``) record its dispatches; returns the entries."""
    entries = []
    for i, world in enumerate(worlds):
        decision = plane.admit(f"tenant-{i}")
        if not decision.admitted:
            fail(f"tenant-{i} not admitted: {decision.detail()}")
        decision.entry.session.rebind(world[0])
        if sinks is not None:
            capture_dispatch(decision.entry, sinks[i])
        entries.append(decision.entry)
    return entries


def stacked(trees):
    from karpenter_core_tpu_torch.kernels import batch

    return batch.stack(list(trees))


def tenant_world(b: int, n_pods: int):
    """(CudaSolver, pods) of headline tenant ``b``: ``n_pods`` pods of the
    headline mix on a catalog of its own.  Tenant 0 has the headline's
    catalog; tenant b > 0 halves the cpu and memory of its first 40·b types
    and takes the on-demand offering in test-zone-1 away from the 20 types
    after them.  Only values change, so every tenant keeps the headline's
    shapes and shape bucket, and a kernel that read another tenant's catalog
    would break the batched = solo check."""
    import dataclasses

    from karpenter_core_tpu_torch.cloudprovider.types import Offerings
    from karpenter_core_tpu_torch.solver.cuda import CudaSolver
    from karpenter_core_tpu_torch.testing.workloads import build_pods, build_provider

    provider, provisioners = build_provider(N_TYPES, N_PROVISIONERS)
    types = provider.get_instance_types(None)
    for it in types[:40 * b]:
        it.capacity = {k: v * 0.5 if k in ("cpu", "memory") else v
                       for k, v in it.capacity.items()}
    for it in types[40 * b:40 * b + 20] if b else ():
        it.offerings = Offerings([
            dataclasses.replace(o, available=False)
            if (o.zone, o.capacity_type) == ("test-zone-1", "on-demand") else o
            for o in it.offerings])
    return CudaSolver(provider, provisioners), build_pods(n_pods)


def tenant_line(records, path_launches, n_b, name, entry, kernel_fn, plain_fn, moved, ops):
    """Hold one batched entry point against its twin at B = ``n_b``
    (exactly), time both as the solo lines are, and file the result under
    the kernel record's ``tenant_axis``; returns the kernel's outputs."""
    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0.0:
        fail(f"{entry} at B = {n_b}: kernel differs from its twin (max_abs_err {err})")
    rec = {"B": n_b, "launches": path_launches[name], "max_abs_err": err,
           "ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn), **bound(moved, ops)}
    next(r for r in records if r["name"] == name).setdefault("tenant_axis", {})[entry] = rec
    print(f"{entry} B={n_b}: ms {rec['ms']:.4f} plain_ms {rec['plain_ms']:.4f} "
          f"bound_ms {rec['bound_ms']:.5f} ({rec['bound_by']}) exact", flush=True)
    return got


def tenant_path(records, path_launches) -> dict:
    """Phase 8: the coalesced multi-tenant solve — eight headline tenants
    through the tenant plane's batch coalescer, the fused repair under
    churn, existing-node coalescing, and each batched kernel entry point
    against its twin at B = 8."""
    from karpenter_core_tpu_torch.models.columnar import PodIngest
    from karpenter_core_tpu_torch.ops import solve as solve_ops
    from karpenter_core_tpu_torch.service import tenant as tenant_mod

    # -- (a) eight cold tenants at the headline ----------------------------------
    fresh_history()
    t0 = time.perf_counter()
    worlds = []
    for b, n in enumerate(TENANT_PODS):
        solver, pods = tenant_world(b, n)
        ingest = PodIngest()
        ingest.add_all(pods)
        worlds.append((solver, ingest, pods))
    preps = [w[0].prepare_encoded(w[0].encode(w[1])) for w in worlds]
    keys = [tenant_mod.bucket_key(p) for p in preps]
    alloc = [p.statics_arrays.it_alloc for p in preps]
    avail = [p.statics_arrays.it_avail for p in preps]
    own = [b for b in range(1, len(preps))
           if not torch.equal(alloc[b], alloc[0]) and not torch.equal(avail[b], avail[0])]
    print(json.dumps({"tenants": {"pods": list(TENANT_PODS), "slots": [p.n_slots for p in preps],
                                  "classes": int(preps[0].cls.count.shape[0]),
                                  "own_catalog_values": own,
                                  "one_bucket": all(k == keys[0] for k in keys),
                                  "build_s": time.perf_counter() - t0}}), flush=True)
    if any(k != keys[0] for k in keys):
        fail(f"the tenants of {TENANT_PODS} pods do not share one shape bucket")
    if own != list(range(1, len(preps))):
        fail(f"tenants {own} alone have catalog values of their own")

    # eight solo dispatches, one after another; tenant 0's alone is the B = 1
    # count of launches and host reads
    solo_out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, ((solver, _, _), prep) in enumerate(zip(worlds, preps)):
        if i == 0:
            reset_launches()
            solve_ops.host_syncs = 0
        solo_out.append(solver.run_prepared(prep))
        if i == 0:
            torch.cuda.synchronize()
            solo_launches, solo_syncs = launch_counts(), solve_ops.host_syncs
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t0
    # the batched program on the same preps: one dispatch for eight tenants
    reset_launches()
    solve_ops.host_syncs = 0
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    outs = tenant_mod.BatchCoalescer._run_batched(preps)
    torch.cuda.synchronize()
    batched_s = time.perf_counter() - t0
    batched_launches, batched_syncs = launch_counts(), solve_ops.host_syncs
    peak = torch.cuda.max_memory_allocated()
    scan = list(TENANT_KERNELS)
    print(json.dumps({"run": "eight tenants", "solo_wall_s": solo_s, "batched_wall_s": batched_s,
                      "solo_b1_launches": {k: solo_launches[k] for k in scan},
                      "batched_b8_launches": {k: batched_launches[k] for k in scan},
                      "solo_b1_host_syncs": solo_syncs, "batched_b8_host_syncs": batched_syncs,
                      "peak_allocated_bytes": peak, "allocated_before_bytes": mem0}), flush=True)
    for i, (got, want) in enumerate(zip(outs, solo_out)):
        same_leaves(got, want, f"eight tenants, tenant {i} in the batch", "its solo run_prepared")
    if any(batched_launches[k] != solo_launches[k] for k in scan) or batched_syncs != solo_syncs:
        fail("the batched scan at B = 8 launched or read the host a different number of "
             "times than at B = 1")
    del outs

    # the same eight through the tenant plane, from eight threads
    plane = tenant_plane(600.0, len(worlds))
    sinks = [[] for _ in worlds]
    entries = bind_tenants(plane, worlds, sinks)
    reset_launches()
    solve_ops.host_syncs = 0
    t0 = time.perf_counter()
    results = run_threads([lambda e=e, w=w: e.session.solve(w[1])
                           for e, w in zip(entries, worlds)])
    torch.cuda.synchronize()
    plane_s = time.perf_counter() - t0
    launches = launch_counts()
    summary = []
    for i, (entry, res, sink) in enumerate(zip(entries, results, sinks)):
        plane.release(entry.tenant_id)
        plane.record_ok(entry)
        if entry.last_batched != len(worlds):
            fail(f"tenant {i}: batch of {entry.last_batched}, the group had {len(worlds)}")
        same_leaves(sink[0][2], solo_out[i], f"tenant plane, tenant {i}", "its solo run_prepared")
        summary.append({"nodes": len(res.new_nodes), "failed": len(res.failed_pods),
                        "n_next": int(sink[0][2].state.n_next), "batch": entry.last_batched})
    print(json.dumps({"run": "tenant plane, eight threads", "wall_s": plane_s,
                      "tenants": summary, "launches": launches}), flush=True)
    for i, pin in TENANT_PINS.items():
        got = {k: summary[i][k] for k in pin}
        if got != pin:
            fail(f"tenant {i}: {got}, the JAX package's solo answer is {pin}")
    check_launched(launches, TENANT_KERNELS + ("pack_bool",), "tenant path")
    del solo_out, results, sinks, entries, plane

    # -- (d) the batched entry points against their twins at B = 8 ------------
    tenant_kernel_lines(records, worlds, preps, launches)
    del preps

    # -- (b) the fused repair under churn --------------------------------------
    fused_repair(worlds)
    del worlds

    # -- (c) existing-node coalescing -----------------------------------------
    existing_coalescing(records, launches)
    for rec in records:
        rec["tenants"] = launches[rec["name"]]
        rec.setdefault("launches_per_path", {})["tenants"] = launches[rec["name"]]
    return launches


def fused_repair(worlds) -> None:
    """Phase 8 (b): the eight backlogs as eight sessions under three ticks
    of 2 % churn, repairs fused through the plane (``KC_DELTA_WINDOW=0``:
    every repair runs at full width, so all share one bucket), against the
    same sessions with coalescing off (``batch_window_s=0``)."""
    import numpy as np

    from karpenter_core_tpu_torch.models.columnar import PodIngest
    from karpenter_core_tpu_torch.testing.workloads import churn_tick

    os.environ["KC_DELTA_WINDOW"] = "0"
    try:
        fused_plane, solo_plane = tenant_plane(600.0, len(worlds)), tenant_plane(0.0, len(worlds))
        fused = bind_tenants(fused_plane, worlds)
        solo = bind_tenants(solo_plane, worlds)
    finally:
        del os.environ["KC_DELTA_WINDOW"]
    # the solo plane's own ingests: the same pod objects, churned alike
    mirror = []
    for _solver, _ingest, pods in worlds:
        twin = PodIngest()
        twin.add_all(pods)
        mirror.append(twin)
    reps = [{} for _ in worlds]
    ticks = []
    for tick in range(FUSED_TICKS + 1):
        if tick:
            for i, (_solver, ingest, _pods) in enumerate(worlds):
                evicted, added = churn_tick(ingest, tick, reps[i])
                for uid in evicted:
                    mirror[i].remove(uid)
                for pod in added:
                    mirror[i].add(pod)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run_threads([lambda e=e, w=w: e.session.solve(w[1]) for e, w in zip(fused, worlds)])
        torch.cuda.synchronize()
        fused_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = [e.session.solve(m) for e, m in zip(solo, mirror)]
        torch.cuda.synchronize()
        solo_s = time.perf_counter() - t0
        modes = [e.session.last_mode for e in fused]
        batches = [e.last_batched for e in fused]
        for i, (a, b) in enumerate(zip(got, want)):
            if decision_summary(a) != decision_summary(b):
                fail(f"fused repair tick {tick}, tenant {i}: the decode differs from the "
                     "run with coalescing off")
            if modes[i] != solo[i].session.last_mode:
                fail(f"fused repair tick {tick}, tenant {i}: mode {modes[i]} against "
                     f"{solo[i].session.last_mode}")
        if batches != [len(worlds)] * len(worlds):
            fail(f"fused repair tick {tick}: batch sizes {batches}")
        if tick and modes != ["delta"] * len(worlds):
            fail(f"fused repair tick {tick}: modes {modes}")
        ticks.append({"tick": tick, "modes": modes[0], "batch": batches[0],
                      "fused_wall_s": fused_s, "solo_wall_s": solo_s})
    for i, (a, b) in enumerate(zip(fused, solo)):
        wa, wb = a.session._warm, b.session._warm
        ca, cb = carry_leaves(wa.carry), carry_leaves(wb.carry)
        if any(not torch.equal(t, cb[name]) for name, t in ca.items()):
            fail(f"fused repair, tenant {i}: the warm carry differs from the solo run's")
        if (wa.n_next != wb.n_next or wa.pod_loc != wb.pod_loc
                or not np.array_equal(wa.assign, wb.assign)
                or not np.array_equal(wa.assign_ex, wb.assign_ex)):
            fail(f"fused repair, tenant {i}: the warm bookkeeping differs from the solo run's")
    print(json.dumps({"run": "fused repair", "ticks": ticks,
                      "aggregates": [e.session.aggregates() for e in fused]}), flush=True)


def decision_summary(results):
    """A decode's decisions, by pod uid."""
    return (
        sorted((sorted(p.uid for p in n.pods), list(n.instance_type_names), list(n.zones))
               for n in results.new_nodes),
        sorted(p.uid for p in results.failed_pods),
        {k: sorted(p.uid for p in v) for k, v in results.existing_assignments.items()},
        sorted(p.uid for p in results.spread_residual_pods),
    )


def existing_coalescing(records, path_launches) -> None:
    """Phase 8 (c): tenants of different mid-size fleets whose padded
    existing-node planes share a bucket, coalesced through the plane, each
    equal to its solo solve; two of them pinned to the JAX package's solo
    answer.  Then K5 and K6 against their twins on the fleets' own
    existing-node planes (E = 384 rows a tenant)."""
    from karpenter_core_tpu_torch.models.columnar import PodIngest
    from karpenter_core_tpu_torch.service import tenant as tenant_mod
    from karpenter_core_tpu_torch.testing.workloads import build_cluster, build_inputs

    t0 = time.perf_counter()
    worlds, clusters = [], []
    for n_nodes, seed in EX_TENANT_FLEETS:
        solver, pods = build_inputs(EX_TENANT_PODS, MID_TYPES, N_PROVISIONERS)
        ingest = PodIngest()
        ingest.add_all(pods)
        worlds.append((solver, ingest, pods))
        clusters.append(build_cluster(n_nodes, MID_TYPES, N_PROVISIONERS, FILL, seed))
    build_s = time.perf_counter() - t0
    plane = tenant_plane(600.0, len(worlds))
    fresh_history()
    sinks = [[] for _ in worlds]
    entries = bind_tenants(plane, worlds, sinks)
    t0 = time.perf_counter()
    results = run_threads([lambda e=e, w=w, c=c: e.session.solve(w[1], c[0], c[1])
                           for e, w, c in zip(entries, worlds, clusters)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    keys = {tenant_mod.bucket_key(sink[0][0]) for sink in sinks}
    counts = []
    for i, (entry, res, sink, (solver, _, _)) in enumerate(zip(entries, results, sinks, worlds)):
        if entry.last_batched != len(worlds):
            fail(f"existing-node tenant {i}: batch of {entry.last_batched} "
                 f"({len(keys)} buckets among the {len(worlds)} fleets)")
        prep, _kw, out = sink[0]
        same_leaves(out, solver.run_prepared(prep), f"existing-node tenant {i}",
                    "its solo run_prepared")
        counts.append(path_counts(res))
    print(json.dumps({"run": "existing-node coalescing", "fleets": [n for n, _ in EX_TENANT_FLEETS],
                      "pods": EX_TENANT_PODS, "build_s": build_s, "wall_s": wall_s,
                      "counts": counts}), flush=True)
    slots_used("existing-node coalescing")
    for i, pin in EX_TENANT_PINS.items():
        if counts[i] != pin:
            fail(f"existing-node tenant {i}: {counts[i]}, the JAX package's answer is {pin}")
    fleet_kernel_lines(records, path_launches, [sink[0][0] for sink in sinks])


def fleet_kernel_lines(records, path_launches, preps) -> None:
    """Phase 8 (c): K5 and both K6 entry points at B = len(preps) on the
    fleets' stacked existing-node planes, class 0 of each tenant against the
    fleet as it stood before the solve, as phase 3 holds them solo."""
    from karpenter_core_tpu_torch.kernels import existing, fill, reqmerge
    from karpenter_core_tpu_torch.ops import masks as mask_ops
    from karpenter_core_tpu_torch.ops import solve as solve_ops

    n_b = len(preps)
    st = solve_ops.StaticArrays(*stacked([p.statics_arrays for p in preps]))
    v = st.valid.shape[-1]
    st = st._replace(valid=mask_ops.pack_mask(st.valid))
    cls = solve_ops.ClassTensors(*(t[:, 0].contiguous() for t in stacked([p.cls for p in preps])))
    cls = cls._replace(mask=mask_ops.pack_mask(cls.mask))
    cls_req = mask_ops.ReqTensor(cls.mask[:, None], cls.defined[:, None], cls.negative[:, None],
                                 cls.gt[:, None], cls.lt[:, None])
    ex = solve_ops.ExistingState(*stacked([p.ex_state for p in preps]))
    ex = ex._replace(kmask=mask_ops.pack_mask(ex.kmask))
    es = solve_ops.ExistingStatic(*stacked([p.ex_static for p in preps]))
    n_ex, n_zones = ex.used.shape[1], ex.zone.shape[-1]
    key_ok = reqmerge.req_compat(
        mask_ops.ReqTensor(ex.kmask, ex.kdef, ex.kneg, ex.kgt, ex.klt), cls_req, st.valid,
        st.vocab_ints, st.is_custom, v, preps[0].key_has_bounds)
    merge = reqmerge.ClassMerge(cls_req, st.valid, st.vocab_ints, v, preps[0].key_has_bounds)
    host_cap = torch.full((n_b, n_ex), solve_ops.UNLIMITED, dtype=torch.int32, device="cuda")
    vol_add, vol_per_pod = es.cls_vol_add[:, 0].contiguous(), es.cls_vol_per_pod[:, 0].contiguous()
    k5 = (es.alloc, ex.used, ex.open_, key_ok, es.tol[:, 0].contiguous(), ex.zone, cls.zone,
          ex.ct, cls.ct, ex.ports, cls.ports, es.vol_limit, ex.vol_used, vol_add, vol_per_pod,
          cls.requests, host_cap, True, True)

    def line(*args):
        return tenant_line(records, path_launches, n_b, *args)

    cap, _, _ = line("existing_intake", "existing_intake_fleets",
                     lambda: existing.existing_intake(*k5),
                     lambda: existing.existing_intake_twin(*k5),
                     nbytes(*k5[:17]) + n_b * n_ex * 9, n_b * n_ex * 64)
    all_zones = torch.ones((n_b, n_zones), dtype=torch.bool, device="cuda")
    k6m = (cap, ex.zone, cls.zone, all_zones, None, False)
    cap_m, pri_m, zone_ok = line("existing_phase", "existing_mask_fleets",
                                 lambda: existing.existing_mask(*k6m),
                                 lambda: existing.existing_mask_twin(*k6m),
                                 nbytes(*k6m[:4]) + n_b * n_ex * 8, n_b * n_ex * 16)
    assigned = fill.fill_by_priority(torch.clamp(cls.count, min=1), cap_m, pri_m)
    if not bool((assigned > 0).any()):
        fail("existing_commit on the fleets: the fill placed nothing to commit")
    k6c = (ex, merge, zone_ok, ex.ct & cls.ct[:, None, :], cls.ports, vol_add, vol_per_pod,
           cls.requests, assigned, True, True)
    line("existing_phase", "existing_commit_fleets", lambda: existing.existing_commit(*k6c),
         lambda: existing.existing_commit_twin(*k6c), nbytes(*k6c[:9]) * 2, n_b * n_ex * 64)


def tenant_kernel_lines(records, worlds, preps, path_launches) -> None:
    """Phase 8 (d): each batched entry point against its twin at B = 8, on
    the eight tenants' headline planes (class 0 of each into its final
    state), timed as the solo lines are; the record's ``tenant_axis``."""
    from karpenter_core_tpu_torch.kernels import capacity, existing, fill, reqmerge, spread
    from karpenter_core_tpu_torch.ops import masks as mask_ops
    from karpenter_core_tpu_torch.ops import solve as solve_ops
    from karpenter_core_tpu_torch.service import tenant as tenant_mod

    n_b = len(preps)
    outs = tenant_mod.BatchCoalescer._run_batched(preps)
    state = solve_ops.NodeState(*stacked([o.state for o in outs]))
    ex = solve_ops.ExistingState(*stacked([o.ex_state for o in outs]))
    st = solve_ops.StaticArrays(*stacked([p.statics_arrays for p in preps]))
    v = st.valid.shape[-1]
    st = st._replace(it=mask_ops.pack_req(st.it), valid=mask_ops.pack_mask(st.valid))
    cls0 = solve_ops.ClassTensors(*(t[:, 0].contiguous() for t in stacked([p.cls for p in preps])))
    cls0 = cls0._replace(mask=mask_ops.pack_mask(cls0.mask))
    cls_req = mask_ops.ReqTensor(cls0.mask[:, None], cls0.defined[:, None],
                                 cls0.negative[:, None], cls0.gt[:, None], cls0.lt[:, None])
    node_req = mask_ops.ReqTensor(state.kmask, state.kdef, state.kneg, state.kgt, state.klt)
    khb = preps[0].key_has_bounds

    def line(*args):
        return tenant_line(records, path_launches, n_b, *args)

    merged, _ = line(
        "req_merge", "merge_compat",
        lambda: reqmerge.merge_compat(node_req, cls_req, st.valid, st.vocab_ints, st.is_custom,
                                      v, khb),
        lambda: reqmerge.merge_compat_twin(node_req, cls_req, st.valid, st.vocab_ints,
                                            st.is_custom, v, khb),
        nbytes(node_req, cls_req, st.valid, st.vocab_ints, st.is_custom) * 2,
        state.kmask.numel() * 8)
    zone_ok = state.zone & cls0.zone[:, None, :]
    ct_ok = state.ct & cls0.ct[:, None, :]
    k1_args = (state.viable, cls0.it, merged, st.it, st.vocab_ints, v, khb, zone_ok, ct_ok,
               st.it_avail, state.used, cls0.requests, st.it_alloc)
    _, n_slots, n_types = state.viable.shape
    _, _, cap_n = line(
        "it_capacity", "it_capacity", lambda: capacity.it_capacity(*k1_args),
        lambda: capacity.it_capacity_twin(*k1_args),
        nbytes(*[a for a in k1_args if isinstance(a, (torch.Tensor, tuple))])
        + n_b * (n_slots * n_types * 5 + n_slots * 4),
        n_b * n_slots * n_types * (st.it.mask.shape[2] * 6 + 12 + 4 * st.it_alloc.shape[2]))
    priority = state.pod_count * n_slots + torch.arange(n_slots, dtype=torch.int32,
                                                        device="cuda")
    priority = torch.where(cap_n > 0, priority, 2**31 - 1)
    quota = torch.clamp(cls0.count, min=1000).contiguous()
    line("fill_priority", "fill_by_priority", lambda: fill.fill_by_priority(quota, cap_n, priority),
         lambda: fill.fill_by_priority_twin(quota, cap_n, priority),
         nbytes(quota, cap_n, priority) + n_b * n_slots * 4, n_b * n_slots * 32 * 4)
    # K5 / K6 on the tenants' one closed dummy existing row (the cold
    # variant's E = 1): the shapes the batched cold path gives them
    n_ex = ex.used.shape[1]
    host_cap = torch.full((n_b, n_ex), 1 << 30, dtype=torch.int32, device="cuda")
    es = stacked([solve_ops.empty_existing_static(p.cls.requests.shape[-1], p.cls.count.shape[0],
                                                  p.statics_arrays.grp_skew.shape[0],
                                                  device="cuda") for p in preps])
    key_ok = torch.ones((n_b, n_ex), dtype=torch.bool, device="cuda")
    k5 = (es.alloc, ex.used, ex.open_, key_ok, es.tol[:, 0].contiguous(), ex.zone, cls0.zone,
          ex.ct, cls0.ct, ex.ports, cls0.ports, es.vol_limit, ex.vol_used,
          es.cls_vol_add[:, 0].contiguous(), es.cls_vol_per_pod[:, 0].contiguous(),
          cls0.requests, host_cap, True, True)
    cap_e, _, ct_e = line("existing_intake", "existing_intake", lambda: existing.existing_intake(*k5),
                          lambda: existing.existing_intake_twin(*k5),
                          nbytes(*k5[:17]) + n_b * n_ex * 9, n_b * n_ex * 64)
    restrict = torch.ones((n_b, state.zone.shape[-1]), dtype=torch.bool, device="cuda")

    def existing_mask():
        return existing.existing_mask(cap_e, ex.zone, cls0.zone, restrict, None, False)

    def existing_mask_plain():
        return existing.existing_mask_twin(cap_e, ex.zone, cls0.zone, restrict, None, False)

    line("existing_phase", "existing_mask", existing_mask, existing_mask_plain,
         nbytes(cap_e, ex.zone, cls0.zone, restrict) + n_b * n_ex * 8, n_b * n_ex * 16)
    assigned = torch.zeros((n_b, n_ex), dtype=torch.int32, device="cuda")
    k6c = (ex, reqmerge.ClassMerge(cls_req, st.valid, st.vocab_ints, v, khb), ex.zone, ct_e,
           cls0.ports, es.cls_vol_add[:, 0].contiguous(),
           es.cls_vol_per_pod[:, 0].contiguous(), cls0.requests, assigned, True, True)

    def existing_commit():
        return existing.existing_commit(*k6c)

    def existing_commit_plain():
        return existing.existing_commit_twin(*k6c)

    line("existing_phase", "existing_commit", existing_commit, existing_commit_plain,
         nbytes(*k6c[:9]) * 2, n_b * n_ex * 64)
    counts_z = torch.zeros((n_b, state.zone.shape[-1]), dtype=torch.int32, device="cuda")
    k7 = (counts_z, restrict, restrict,
          torch.full_like(counts_z, 1 << 30), torch.ones(n_b, dtype=torch.int32, device="cuda"),
          cls0.count, torch.ones(n_b, dtype=torch.bool, device="cuda"))
    line("spread_quota", "spread_quota", lambda: spread.spread_quota(*k7), lambda: spread.spread_quota_twin(*k7),
         nbytes(*k7) + n_b * 40, n_b * 4000)
    del outs


def spied_chunks(study):
    """``study()`` with the batched scan spied on: per chunk, the cells it
    took, its host reads and its launches.  Returns (the study's result, the
    chunks, the last chunk's outputs)."""
    from karpenter_core_tpu_torch.ops import solve as solve_ops

    chunks, last = [], {}
    batched = solve_ops.solve_core_batched

    def spy(*args, **kwargs):
        l0, s0 = launch_counts(), solve_ops.host_syncs
        out = batched(*args, **kwargs)
        l1 = launch_counts()
        chunks.append({"cells": int(out.failed.shape[0]),
                       "host_syncs": solve_ops.host_syncs - s0,
                       "launches": {k: l1[k] - l0[k] for k in l1 if l1[k] != l0[k]}})
        last["out"] = out
        return out

    solve_ops.solve_core_batched = spy
    try:
        result = study()
    finally:
        solve_ops.solve_core_batched = batched
    return result, chunks, last.get("out")


def chunk_summary(chunks) -> dict:
    """The chunks' sizes, host reads and scan launches (each chunk's, when
    they differ)."""
    launches = [c["launches"] for c in chunks]
    return {"chunks": len(chunks), "cells": [c["cells"] for c in chunks],
            "host_syncs": [c["host_syncs"] for c in chunks],
            "launches": launches[0] if all(x == launches[0] for x in launches) else launches}


def crossed_path(inputs) -> dict:
    """Phase 9 (c), run right after phase 4 on its 5,000-node cluster: the
    crossed replica x prefix grid (R = 8 interruption replicas at rate 0.3
    x the search's coarse pass of prefix sizes), every cell a solve in the
    batched scan.  Its rate-0 row must equal the coarse pass of phase 4's
    serial sweep (failed and n_new); a 2 x 4 sub-grid must equal the twins'.
    Returns the grid's launches."""
    import numpy as np

    from karpenter_core_tpu_torch.kernels import consolidate as k89
    from karpenter_core_tpu_torch.ops import chunks as chunks_mod
    from karpenter_core_tpu_torch.ops import solve as solve_ops
    from karpenter_core_tpu_torch.parallel import mesh

    snapshot, prep, sizes, serial = inputs
    # the rate-0 row: one replica of the unperturbed availability
    zero = mesh.perturb_spot_availability(snapshot, 1, 0, 0.0)
    t0 = time.perf_counter()
    failed0, n_new0 = (t.cpu().numpy()[0] for t in mesh.crossed_sweep(prep, zero, sizes))
    row_s = time.perf_counter() - t0
    if not (np.array_equal(failed0, serial.failed) and np.array_equal(n_new0, serial.n_new)):
        fail("crossed grid: the rate-0 row differs from the serial sweep's coarse pass")
    print(json.dumps({"run": "crossed grid, rate-0 row", "cells": len(sizes), "wall_s": row_s,
                      "equals_serial_sweep": True}), flush=True)

    reset_launches()
    solve_ops.host_syncs = 0
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()

    def study():
        avail = mesh.perturb_spot_availability(snapshot, CROSSED_REPLICAS, CROSSED_SEED,
                                               WHATIF_RATE)
        return avail, mesh.crossed_sweep(prep, avail, sizes)

    (avail, grid), chunks, _ = spied_chunks(study)
    failed, n_new = (t.cpu().numpy() for t in grid)
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    feasible_sizes = np.where(failed == 0, np.asarray(sizes)[None, :], 0).max(axis=1)
    shared = (prep.cls, prep.statics_arrays, prep.ex_state, prep.ex_static)
    # classes some cells hold pods of and others do not: each such class
    # steps for all cells, the others keep their carry (the union of skips)
    _, counts = k89.sweep_lanes_plain(prep.candidate_rank, prep.ex_state.open_,
                                      prep.cls.count, prep.ex_cls_count,
                                      torch.as_tensor(sizes, dtype=torch.int32, device="cuda"))
    live = counts > 0
    mixed = int((live.any(dim=0) & ~live.all(dim=0)).sum())
    print(json.dumps({
        "run": "crossed grid", "replicas": CROSSED_REPLICAS, "prefix_sizes": len(sizes),
        "stacked_input_bytes_per_cell": nbytes(shared),
        "estimate_bytes_per_cell": chunks_mod.cell_bytes(mesh.consolidate_ops.SWEEP_SLOTS,
                                                         shared),
        "existing_rows": int(prep.ex_state.open_.shape[0]),
        "slots": mesh.consolidate_ops.SWEEP_SLOTS,
        "wall_s": wall_s, **chunk_summary(chunks),
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        "allocated_before_bytes": mem0, "safe_prefix": feasible_sizes.tolist(),
        "failed_cells": int((failed > 0).sum()), "classes": int(counts.shape[1]),
        "classes_live_in_some_cells_only": mixed, "launches": launches,
    }), flush=True)
    check_launched(launches, CROSSED_KERNELS, "crossed what-if grid")

    sub_f, sub_n = (t.cpu().numpy() for t in mesh.crossed_sweep(
        prep, avail[:2], sizes[:4], use_kernels=False))
    if not (np.array_equal(sub_f, failed[:2, :4]) and np.array_equal(sub_n, n_new[:2, :4])):
        fail("crossed grid: the 2 x 4 sub-grid through the twins differs from the kernels'")
    print("crossed grid: the rate-0 row equals the serial sweep; the 2 x 4 sub-grid equals "
          "the twins'", flush=True)
    return launches


def replica_line(out, it_price, use_kernels=True):
    """K20 (or its twin) over one batched scan's outputs."""
    from karpenter_core_tpu_torch.kernels import montecarlo

    fn = montecarlo.replica_finish if use_kernels else montecarlo.replica_finish_plain
    st = out.state
    return fn(out.assign, out.failed, st.viable, st.zone, st.ct, st.open_, st.pod_count,
              it_price)


def whatif_study(label, run):
    """One full-size study through its entry point, the batched scan spied
    on; prints its wall, chunks and peak memory."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    result, chunks, last = spied_chunks(run)
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    print(json.dumps({"run": label, "replicas": WHATIF_REPLICAS, "wall_s": wall_s,
                      **chunk_summary(chunks),
                      "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                      "allocated_before_bytes": mem0, "launches": launches}), flush=True)
    check_launched(launches, WHATIF_KERNELS, label)
    return result, launches, last, [c["cells"] for c in chunks]


def sampled_solos(snapshot, avail, study, n_slots, it_price, label):
    """Replicas ``WHATIF_SAMPLED`` of a study, each solved alone by
    ``solve_core`` on its own availability plane, must equal the study's
    four sums."""
    from karpenter_core_tpu_torch.kernels import batch
    from karpenter_core_tpu_torch.parallel import mesh
    from karpenter_core_tpu_torch.ops import solve as solve_ops

    cls, sa, khb = mesh.prepared(snapshot, "cuda")
    for r in WHATIF_SAMPLED:
        out = solve_ops.solve_core(cls, sa._replace(it_avail=avail[r]), n_slots, khb,
                                   n_passes=snapshot.scan_passes,
                                   features=solve_ops.snapshot_features(snapshot))
        got = [t.item() for t in replica_line(batch.add_axis(out), it_price)]
        want = [study[k][r].item() for k in ("scheduled", "failed", "nodes", "cost")]
        if got != want:
            fail(f"{label}: replica {r} is {want}, its solo solve gives {got}")
    print(f"{label}: replicas {list(WHATIF_SAMPLED)} equal their solo solve_core runs",
          flush=True)


def replica_axis_inputs(records, last, cls, sa, khb, avail, n_b):
    """K1's operands at the study's largest chunk, B = ``n_b`` replicas: a
    chunk's final slot states (the last chunk's replicas, wrapped round to
    ``n_b``), class 0 merged into their requirement rows by K3, the shared
    catalog planes repeated and each replica's own availability, as
    ``ops.chunks.solve_cells`` stacks them; and those slots' pod counts.
    That merge is held exactly to its twin replica by replica and timed
    (``replica_axis`` in K3's record, with the shapes it ran)."""
    from karpenter_core_tpu_torch.kernels import batch, reqmerge
    from karpenter_core_tpu_torch.ops import masks as mask_ops

    st = last.state
    n_last = st.viable.shape[0]
    first = avail.shape[0] - n_last  # the last chunk's first replica
    idx = torch.arange(n_b, device="cuda") % n_last
    v = sa.valid.shape[-1]
    cls0_mask = mask_ops.pack_mask(cls.mask[0])
    cls_req = mask_ops.ReqTensor(cls0_mask[None], cls.defined[0][None], cls.negative[0][None],
                                 cls.gt[0][None], cls.lt[0][None])
    it, valid, vocab_ints, is_custom, alloc, cls_it, size, cls_req = batch.repeat(
        (mask_ops.pack_req(sa.it), mask_ops.pack_mask(sa.valid), sa.vocab_ints, sa.is_custom,
         sa.it_alloc, cls.it[0], cls.requests[0], cls_req), n_b)
    node_req = mask_ops.ReqTensor(*(t[idx] for t in (st.kmask, st.kdef, st.kneg, st.kgt,
                                                     st.klt)))
    k3 = (node_req, cls_req, valid, vocab_ints, is_custom, v, khb)
    n_slots, n_keys, n_words = st.kmask.shape[1:]
    merged, _ = axis_line(
        records, "req_merge", "replica_axis", None, lambda: reqmerge.merge_compat(*k3),
        lambda: reqmerge.merge_compat_twin(*k3),
        2 * nbytes(node_req) + nbytes(*k3[1:5]) + n_b * n_slots, n_b * n_slots * n_keys * 16,
        B=n_b, rows=n_slots, K=n_keys, W=n_words, V=vocab_ints.shape[-1])
    zone_ok = st.zone[idx] & cls.zone[0]
    ct_ok = st.ct[idx] & cls.ct[0]
    return (st.viable[idx], cls_it, merged, it, vocab_ints, v, khb, zone_ok, ct_ok,
            avail[first + idx].contiguous(), st.used[idx], size, alloc), st.pod_count[idx]


def replica_fill_record(records, k1_args, pod_count, count) -> None:
    """K2 at the study's largest chunk: class 0's count filled over the caps
    of K1's replica-axis record, emptiest slot first (pod count * N + slot,
    as the scan packs it), held against its twin replica by replica and
    timed; ``replica_axis`` in K2's record."""
    from karpenter_core_tpu_torch.kernels import capacity, fill

    n_b, n_slots = pod_count.shape
    _, _, cap_n = capacity.it_capacity(*k1_args)
    priority = pod_count * n_slots + torch.arange(n_slots, dtype=torch.int32, device="cuda")
    priority = torch.where(cap_n > 0, priority, 2**31 - 1)
    quota = torch.full((n_b,), max(int(count), 1000), dtype=torch.int32, device="cuda")
    axis_line(records, "fill_priority", "replica_axis", None,
              lambda: fill.fill_by_priority(quota, cap_n, priority),
              lambda: fill.fill_by_priority_twin(quota, cap_n, priority),
              nbytes(quota, cap_n, priority) + n_b * n_slots * 4, n_b * n_slots * 8, B=n_b,
              kept=int((cap_n != 0).sum()))


def quota_replica_record(records, last, cls, sa, n_b) -> None:
    """K7 at the study's largest chunk, B = ``n_b`` replicas (the last
    chunk's, wrapped round): the quota rounds of the study's first
    zone-spread class against each replica's final slots, its group's
    members counted on the slots committed to one zone (as the scan counts
    them), its zones, skew, pod count and membership, caps UNLIMITED (no
    existing node); held exactly to its twin replica by replica and timed
    (``replica_axis`` in K7's record, with its shapes)."""
    from karpenter_core_tpu_torch.kernels import batch, spread

    g_dummy = sa.grp_skew.shape[0] - 1
    spread_cls = [c for c in range(cls.count.shape[0]) if int(cls.groups[c, 0]) < g_dummy]
    if not spread_cls:
        fail("spread_quota replica axis: the study has no zone-spread class")
    c = spread_cls[0]
    g = int(cls.groups[c, 0])
    st = last.state
    idx = torch.arange(n_b, device="cuda") % st.zone.shape[0]
    zone_i = (st.zone[idx] & st.open_[idx][..., None]).to(torch.int32)
    single = torch.where(zone_i.sum(dim=-1, dtype=torch.int32)[..., None] == 1, zone_i, 0)
    counts = (last.topo.fwd_new[idx, g][..., None] * single).sum(dim=1, dtype=torch.int32)
    n_zones = counts.shape[-1]
    k7 = (counts.contiguous(),) + batch.repeat(
        (cls.zone[c], torch.ones(n_zones, dtype=torch.bool, device="cuda"),
         torch.full((n_zones,), 1 << 30, dtype=torch.int32, device="cuda"), sa.grp_skew[g],
         cls.count[c], sa.grp_member[c, g]), n_b)
    axis_line(records, "spread_quota", "replica_axis", None, lambda: spread.spread_quota(*k7),
              lambda: spread.spread_quota_twin(*k7), nbytes(*k7) + n_b * (n_zones * 5 + 5),
              n_b * (n_zones + 1) * (n_zones * n_zones + 30 * n_zones), plain_reps=1, B=n_b,
              Z=n_zones, cls=c, m=int(cls.count[c]))


def replica_axis_record(records, k1_args) -> None:
    """K1 at the study's largest chunk, held against its twin replica by
    replica and timed (``ms``, ``device_ms``); its bound from the solo
    call's work: each replica's own slot planes, availability and outputs,
    the catalog and class planes once, the operations B times the solo
    call's.  ``replica_axis`` in K1's record."""
    from karpenter_core_tpu_torch.kernels import capacity

    n_b = k1_args[0].shape[0]
    moved, shared, ops = K1_WORK["solo"]
    axis_line(records, "it_capacity", "replica_axis", None,
              lambda: capacity.it_capacity(*k1_args), lambda: capacity.it_capacity_twin(*k1_args),
              shared + n_b * (moved - shared), n_b * ops, timed=True, B=n_b)


def whatif_path(records, path_launches, solver, pods, solo_out, crossed_launches) -> None:
    """Phase 9: the what-if studies (BASELINE.json config 5) on the headline
    backlog.  (a) ``monte_carlo_solve`` at R = 1,024, rate 0: every replica
    equals phase 1's solo solve (50,000 scheduled, 0 failed, 7,162 nodes,
    the same cost bit for bit).  (b) Rate 0.3, seed 0: replicas 0, 1, 511
    and 1,023 equal solo ``solve_core`` runs on their own availability; a
    chunk of 8 replicas through the kernels equals the twins' batch leaf for
    leaf.  (d) ``policy_monte_carlo`` at R = 1,024, seed 5, after the policy
    benchmark's spot move with every spot offering at interruption rate 0.3.
    Then K19 (both modes) and K20 against their twins at these shapes."""
    import numpy as np

    from karpenter_core_tpu_torch.kernels import batch, perturb
    from karpenter_core_tpu_torch.models.columnar import PodIngest
    from karpenter_core_tpu_torch.ops import chunks as chunks_mod
    from karpenter_core_tpu_torch.ops import solve as solve_ops
    from karpenter_core_tpu_torch.parallel import mesh
    from karpenter_core_tpu_torch.solver.cuda import CudaSolver
    from karpenter_core_tpu_torch.testing.workloads import build_provider, move_spot_market

    ingest = PodIngest()
    ingest.add_all(pods)
    snapshot = solver.encode(ingest)
    fresh_history()
    n_slots = solve_ops.estimate_slots(snapshot)
    it_price = torch.as_tensor(snapshot.it_price, device="cuda")
    if n_slots != solo_out.assign.shape[1]:
        fail(f"what-if: {n_slots} slots, phase 1's solve had {solo_out.assign.shape[1]}")
    solo = [t.item() for t in replica_line(batch.add_axis(solo_out), it_price)]
    print(json.dumps({"whatif_solo": dict(zip(("scheduled", "failed", "nodes", "cost"), solo)),
                      "slots": n_slots}), flush=True)
    if solo[:3] != [N_PODS, 0, EXPECTED_NODES]:
        fail(f"what-if: phase 1's solve sums to {solo}")

    # -- (a) rate 0: every replica is the unperturbed solve --------------------
    calm, _, _, _ = whatif_study("monte-carlo, rate 0", lambda: mesh.monte_carlo_solve(
        snapshot, WHATIF_REPLICAS, seed=0, interruption_rate=0.0))
    for key, want in zip(("scheduled", "failed", "nodes", "cost"), solo):
        if not np.all(calm[key] == want):
            fail(f"monte-carlo rate 0: {key} {np.unique(calm[key])[:4]}, the solo solve {want}")
    print("monte-carlo rate 0: every replica equals the solo solve (cost bit for bit)",
          flush=True)

    # -- (b) rate 0.3: sampled replicas, and a chunk against the twins ---------
    study, launches, last, cells = whatif_study(
        "monte-carlo, rate 0.3", lambda: mesh.monte_carlo_solve(
            snapshot, WHATIF_REPLICAS, seed=0, interruption_rate=WHATIF_RATE))
    largest = max(cells)  # K1's replica-axis record runs at the largest chunk
    print(json.dumps({"monte_carlo": {k: (v.tolist()[:8] if isinstance(v, np.ndarray) else v)
                                      for k, v in study.items()}}), flush=True)
    if not np.all(study["scheduled"] + study["failed"] == N_PODS):
        fail("monte-carlo rate 0.3: a replica lost pods")
    avail = mesh.perturb_spot_availability(snapshot, WHATIF_REPLICAS, 0, WHATIF_RATE)
    sampled_solos(snapshot, avail, study, n_slots, it_price, "monte-carlo rate 0.3")
    cls, sa, khb = mesh.prepared(snapshot, "cuda")
    # what a replica's stacked copy of the shared planes costs (the kernels
    # take dense operands; a stride-0 view would cost only the availability)
    print(json.dumps({"stacked_input_bytes_per_replica": nbytes((cls, sa)),
                      "own_availability_bytes_per_replica": int(avail[0].numel()),
                      "estimate_bytes_per_replica": chunks_mod.cell_bytes(n_slots, (cls, sa))}),
          flush=True)
    cls_b, sa_b = batch.repeat((cls, sa), WHATIF_TWIN_CHUNK)
    sa_b = sa_b._replace(it_avail=avail[:WHATIF_TWIN_CHUNK].contiguous())
    ft = solve_ops.snapshot_features(snapshot)
    t0 = time.perf_counter()
    kern = solve_ops.solve_core_batched(cls_b, sa_b, n_slots, khb,
                                        n_passes=snapshot.scan_passes, features=ft)
    torch.cuda.synchronize()
    kern_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    twin = solve_ops.solve_core_batched(cls_b, sa_b, n_slots, khb,
                                        n_passes=snapshot.scan_passes, features=ft,
                                        use_kernels=False)
    torch.cuda.synchronize()
    print(json.dumps({"run": f"a chunk of {WHATIF_TWIN_CHUNK} replicas", "kernels_wall_s": kern_s,
                      "twins_wall_s": time.perf_counter() - t0}), flush=True)
    same_leaves(kern, twin, f"monte-carlo, a chunk of {WHATIF_TWIN_CHUNK} replicas",
                "the twins' batch")
    del kern, twin, cls_b, sa_b

    # -- K19 at [1,024, 1,000, 3, 2], both modes; K20 on the last chunk ---------
    avail0 = torch.as_tensor(snapshot.it_avail, device="cuda")
    is_spot = torch.as_tensor(np.array([ct == "spot" for ct in snapshot.capacity_types]),
                              device="cuda")
    cells = WHATIF_REPLICAS * avail0.numel()
    k19 = record_kernel(
        records, "perturb_avail", "karpenter_core_tpu_torch/csrc/perturb_avail.cu",
        "karpenter_core_tpu/parallel/mesh.py:397", launches["perturb_avail"],
        lambda: perturb.perturb_avail(avail0, WHATIF_REPLICAS, 0, rate=WHATIF_RATE,
                                      is_spot=is_spot),
        lambda: perturb.perturb_avail_plain(avail0, WHATIF_REPLICAS, 0, rate=WHATIF_RATE,
                                            is_spot=is_spot),
        avail0.numel() + is_spot.numel() + cells, cells * THREEFRY_OPS, plain_reps=3,
    )
    if not torch.equal(k19, avail):
        fail("perturb_avail: the study's draw differs from the recorded call's")
    risk = torch.full(avail0.shape, WHATIF_RATE, dtype=torch.float32, device="cuda")
    risk[:, :, ~is_spot] = 0.0
    got = perturb.perturb_avail(avail0, WHATIF_REPLICAS, 0, risk=risk)
    if not torch.equal(got, perturb.perturb_avail_plain(avail0, WHATIF_REPLICAS, 0, risk=risk)):
        fail("perturb_avail (risk plane) differs from its twin")
    records[-1]["risk_mode"] = {
        "ms": time_ms(lambda: perturb.perturb_avail(avail0, WHATIF_REPLICAS, 0, risk=risk)),
        "plain_ms": time_ms(lambda: perturb.perturb_avail_plain(avail0, WHATIF_REPLICAS, 0,
                                                                risk=risk), 3),
        "bound_ms": max((avail0.numel() * 5 + cells) / HBM_BYTES_PER_S,
                        cells * THREEFRY_OPS / SCALAR_OPS_PER_S) * 1e3,
        "bound_by": "operations",
    }
    st = last.state
    priced = int((st.open_ & (st.pod_count > 0)).sum())
    n_b, n_cls, n_sl = last.assign.shape
    n_it, n_z, n_ct = it_price.shape
    record_kernel(
        records, "replica_finish", "karpenter_core_tpu_torch/csrc/replica_finish.cu",
        "karpenter_core_tpu/parallel/mesh.py:480", launches["replica_finish"],
        lambda: replica_line(last, it_price), lambda: replica_line(last, it_price, False),
        nbytes(last.assign, last.failed, st.pod_count, st.open_, it_price)
        + priced * (n_it + n_z + n_ct) + 16 * n_b,
        priced * n_it * n_z * n_ct + n_b * n_cls * n_sl, plain_reps=3,
    )
    k1_args, pod_count = replica_axis_inputs(records, last, cls, sa, khb, avail, largest)
    quota_replica_record(records, last, cls, sa, largest)
    del last, st
    torch.cuda.empty_cache()
    replica_axis_record(records, k1_args)
    replica_fill_record(records, k1_args, pod_count, cls.count[0])
    del k1_args, pod_count
    torch.cuda.empty_cache()
    # K23 at B = 147: the phase commit that took the most rows in one more
    # chunk of the study's replicas
    cls_b, sa_b = batch.repeat((cls, sa), largest)
    sa_b = sa_b._replace(it_avail=avail[:largest].contiguous())
    k23 = captured_commit(lambda: solve_ops.solve_core_batched(
        cls_b, sa_b, n_slots, khb, n_passes=snapshot.scan_passes, features=ft), phase_only=True)
    del cls_b, sa_b
    slot_commit_line(records, "replica_axis", k23)
    del k23
    torch.cuda.empty_cache()

    # -- (d) the risk-weighted variants after the spot move --------------------
    provider, provisioners = build_provider(N_TYPES, N_PROVISIONERS)
    move_spot_market(provider)
    for it in provider.get_instance_types(None):
        provider.set_interruption_rate(it.name, WHATIF_RATE)
    risky = CudaSolver(provider, provisioners)
    snap_p = risky.encode(ingest)
    policy, policy_launches, _, _ = whatif_study(
        "policy monte-carlo", lambda: mesh.policy_monte_carlo(snap_p, WHATIF_REPLICAS,
                                                              seed=POLICY_WHATIF_SEED))
    print(json.dumps({"policy_monte_carlo": {
        k: policy[k] for k in ("best_replica", "best_cost", "expected_cost", "cost_mean",
                               "cost_max", "feasible_replicas")}}), flush=True)
    if not np.all(policy["scheduled"] + policy["failed"] == N_PODS):
        fail("policy monte-carlo: a replica lost pods")
    avail_p = mesh.perturb_offering_availability(snap_p, snap_p.pol_risk, WHATIF_REPLICAS,
                                                 POLICY_WHATIF_SEED)
    sampled_solos(snap_p, avail_p, {**policy, "cost": policy["cost"].astype(np.float32)},
                  n_slots, torch.as_tensor(snap_p.pol_price, device="cuda"),
                  "policy monte-carlo")
    for rec in records:
        rec.setdefault("launches_per_path", {}).update(
            whatif=launches.get(rec["name"], 0), crossed=crossed_launches.get(rec["name"], 0))
    path_launches["whatif"] = launches


def tick_record(results) -> tuple:
    """A tick's placements by pod name (``tests/test_pipeline.py``'s
    ``_tick_record``, by name: two legs built from one pod list share their
    names, and ``churn_tick`` names its replacements by tick)."""
    new = tuple(sorted(tuple(sorted(p.metadata.name for p in d.pods)) for d in results.new_nodes))
    existing = tuple(sorted((name, tuple(sorted(p.metadata.name for p in pods)))
                            for name, pods in results.existing_assignments.items()))
    return new, existing, tuple(sorted(p.metadata.name for p in results.failed_pods))


def consume(results) -> int:
    """The launch path's reads of a tick's decisions (``bench.py
    pipeline_line``): offering lists and request vectors."""
    touched = 0
    for d in results.new_nodes:
        touched += len(d.instance_type_names[:4]) + len(d.zones) + len(d.requests)
    return touched


def clone_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone_tree(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone_tree(x) for x in tree)
    return tree


def set_pipeline(on: bool) -> None:
    os.environ["KC_PIPELINE"] = "1" if on else "0"


def pipeline_path(records, path_launches) -> dict:
    """Phase 10: the pipelined tick of the warm-repair session at the
    headline's full width.  (a) ``bench.py pipeline_line``'s anchor regime
    (FallbackPolicy(materialized=True): every tick re-anchors) over
    ``ANCHOR_TICKS`` ticks of 2 % churn, serial (KC_PIPELINE=0) and deferred
    (tick k consumed after tick k+1's dispatch): every tick's record equal.
    (b) Phase 5's steady repair (``CHURN_POLICY``, 2 % churn), serial and
    deferred with carry donation: records, evictions and windows equal, the
    donation and staging ledgers, K21 and K22 launched and K10 and K12 not.
    (c) K21 and K22 against their twins and against K10 / K12 on a clone,
    on (b)'s last tick's inputs.  (d) A barrier held up past the watchdog
    floor by a sleep on the compute stream: the tick re-anchors with reason
    ``watchdog-timeout`` to a serial full solve's records."""
    import statistics

    from karpenter_core_tpu_torch.kernels import repair
    from karpenter_core_tpu_torch.models.columnar import PodIngest
    from karpenter_core_tpu_torch.ops import solve as solve_ops
    from karpenter_core_tpu_torch.solver.incremental import (
        FallbackPolicy,
        IncrementalSolveSession,
    )
    from karpenter_core_tpu_torch.testing.workloads import build_inputs, churn_tick
    from karpenter_core_tpu_torch.utils import pipeline as pipeline_mod
    from karpenter_core_tpu_torch.utils import watchdog

    solver, pods = build_inputs(N_PODS, N_TYPES, N_PROVISIONERS)
    fresh_history()

    def fresh_ingest():
        ingest = PodIngest()
        ingest.add_all(pods)
        return ingest

    # -- (a) the anchor regime ------------------------------------------------
    def anchor_leg(pipelined: bool) -> dict:
        set_pipeline(pipelined)
        ingest = fresh_ingest()
        session = IncrementalSolveSession(solver, FallbackPolicy(
            enabled=True, audit_interval=0, max_delta_fraction=0.5, materialized=True))
        handle = session.solve(ingest, deferred=pipelined)
        first = handle.result() if pipelined else handle
        consume(first)
        recs, walls, overlaps, reps, pending = [tick_record(first)], [], [], {}, None
        for tick in range(ANCHOR_TICKS + 1):  # tick 0 warms; excluded from the means
            t0 = time.perf_counter()
            churn_tick(ingest, tick, reps)
            if pipelined:
                h = session.solve(ingest, deferred=True)
                if pending is not None:
                    res = pending.result()
                    consume(res)
                    recs.append(tick_record(res))
                    o = pipeline_mod.last_overlap()
                    if o["hidden_s"] + o["exposed_s"] > 0:
                        overlaps.append(o["hidden_s"] / (o["hidden_s"] + o["exposed_s"]))
                pending = h
            else:
                res = session.solve(ingest)
                consume(res)
                recs.append(tick_record(res))
            torch.cuda.synchronize()
            if tick > 0:
                walls.append(time.perf_counter() - t0)
        if pending is not None:
            res = pending.result()
            consume(res)
            recs.append(tick_record(res))
        return {"records": recs, "tick_s": statistics.mean(walls), "walls": walls,
                "overlap": statistics.median(overlaps) if overlaps else None,
                "modes": dict(session.mode_counts), "aggregates": session.aggregates(),
                "first": (len(first.new_nodes), len(first.failed_pods))}

    t0 = time.perf_counter()
    serial_a = anchor_leg(False)
    deferred_a = anchor_leg(True)
    print(json.dumps({"pipeline_anchor": {
        "ticks": ANCHOR_TICKS, "serial_tick_s": serial_a["tick_s"],
        "deferred_tick_s": deferred_a["tick_s"], "serial_walls": serial_a["walls"],
        "deferred_walls": deferred_a["walls"], "overlap_median": deferred_a["overlap"],
        "modes": deferred_a["modes"], "wall_s": time.perf_counter() - t0}}), flush=True)
    if serial_a["first"] != (EXPECTED_NODES, 0) or deferred_a["first"] != (EXPECTED_NODES, 0):
        fail(f"pipeline anchor: tick 0 gave {serial_a['first']} / {deferred_a['first']} "
             f"(nodes, failed), expected ({EXPECTED_NODES}, 0)")
    if serial_a["records"] != deferred_a["records"]:
        bad = [i for i, (x, y) in enumerate(zip(serial_a["records"], deferred_a["records"]))
               if x != y]
        fail(f"pipeline anchor: the deferred records differ from the serial ones at ticks {bad}")
    if serial_a["modes"] != deferred_a["modes"] or \
            serial_a["aggregates"] != deferred_a["aggregates"]:
        fail(f"pipeline anchor: {deferred_a['modes']} {deferred_a['aggregates']}, serial "
             f"{serial_a['modes']} {serial_a['aggregates']}")
    print(f"pipeline path (a): {ANCHOR_TICKS + 2} anchor-regime records equal, serial and "
          "deferred", flush=True)

    # -- (b) the steady repair with donation -----------------------------------
    recorded = {}
    originals = {name: getattr(solve_ops, name)
                 for name in ("repair_free", "scatter_repair_window")}

    def recording(name):
        def call(*args, **kwargs):
            if kwargs.get("inplace"):
                recorded[name] = clone_tree(args)
            return originals[name](*args, **kwargs)
        return call

    def ring_bytes(session) -> int:
        ring = session._staging
        return 0 if ring is None else sum(t.numel() for slot in ring._slots
                                          for t in slot.store if t is not None)

    def reference_drift(takes) -> int:
        """The reference ring's count over these takes: every change of
        shape or dtype at an index its slot held before."""
        held, drift = {}, 0
        for slot, layouts in takes:
            last = held.setdefault(slot, {})
            for i, layout in enumerate(layouts):
                if layout is None:
                    continue
                drift += i in last and last[i] != layout
                last[i] = layout
        return drift

    def steady_leg(pipelined: bool) -> dict:
        set_pipeline(pipelined)
        gc.collect()  # an earlier leg's session cycles hold device memory
        ingest = fresh_ingest()
        session = IncrementalSolveSession(solver, FallbackPolicy(**CHURN_POLICY))
        takes = []  # (slot, layouts) of every staging take, for the reference's count
        real_take = pipeline_mod.HostStagingRing.take

        def spied_take(ring, arrays):
            takes.append((ring._next, [None if a is None else (tuple(a.shape), a.dtype)
                                       for a in arrays]))
            return real_take(ring, arrays)

        pipeline_mod.HostStagingRing.take = spied_take
        try:
            handle = session.solve(ingest, deferred=pipelined)
            if pipelined:
                handle.result()
            torch.cuda.synchronize()
            pipeline_mod.reset_stats()
            reset_launches()
            recs, rows, reps, pending, bytes_after_first = [], [], {}, None, None
            for tick in range(len(HEADLINE_CHURN["evicted"])):
                evicted, _ = churn_tick(ingest, tick, reps)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                if pipelined:
                    h = session.solve(ingest, deferred=True)
                    window = session.last_window
                    if pending is not None:
                        recs.append(tick_record(pending.result()))
                    pending = h
                else:
                    recs.append(tick_record(session.solve(ingest)))
                    window = session.last_window
                torch.cuda.synchronize()
                rows.append({"tick": tick, "wall_s": time.perf_counter() - t0, **session.stages,
                             "peak_bytes": torch.cuda.max_memory_allocated(),
                             "peak_above_start_bytes": torch.cuda.max_memory_allocated() - before,
                             "evicted": len(evicted),
                             "hole_slots": session.last_evicted["hole_slots"],
                             "window": None if window is None else len(window[0])})
                if tick == 0:
                    bytes_after_first = ring_bytes(session)
            if pending is not None:
                recs.append(tick_record(pending.result()))
        finally:
            pipeline_mod.HostStagingRing.take = real_take
        torch.cuda.synchronize()
        return {"records": recs, "rows": rows, "launches": launch_counts(),
                "stats": pipeline_mod.stats(), "reference_drift": reference_drift(takes),
                "staging_bytes": (bytes_after_first, ring_bytes(session)),
                "modes": dict(session.mode_counts), "aggregates": session.aggregates(),
                "signature": session.node_signature()}

    serial_b = steady_leg(False)
    deferred_b = steady_leg(True)
    # the same ticks once more, recording the in-place kernels' inputs for
    # (c): the copies would count in the measured legs' peak memory
    for name in originals:
        setattr(solve_ops, name, recording(name))
    try:
        if steady_leg(True)["records"] != deferred_b["records"]:
            fail("pipeline steady: a second deferred leg gave other records")
    finally:
        for name, value in originals.items():
            setattr(solve_ops, name, value)
    for label, leg in (("serial", serial_b), ("deferred", deferred_b)):
        print(json.dumps({"pipeline_steady": label, "ticks": leg["rows"],
                          "stats": leg["stats"], "reference_drift": leg["reference_drift"],
                          "staging_bytes": leg["staging_bytes"], "modes": leg["modes"],
                          "launches": {k: v for k, v in leg["launches"].items() if v}}),
              flush=True)
    n_ticks = len(HEADLINE_CHURN["evicted"])
    for tick, row in enumerate(deferred_b["rows"]):
        want = {k: HEADLINE_CHURN[k][tick] for k in ("evicted", "hole_slots", "window")}
        if {k: row[k] for k in want} != want:
            fail(f"pipeline steady tick {tick}: {row}, the JAX package's answer is {want}")
    if serial_b["records"] != deferred_b["records"]:
        fail("pipeline steady: the deferred records differ from phase 5's serial session's")
    if (deferred_b["modes"] != {"full": 1, "delta": n_ticks} or serial_b["modes"] !=
            deferred_b["modes"] or deferred_b["signature"] != serial_b["signature"]):
        fail(f"pipeline steady: modes {deferred_b['modes']} / {serial_b['modes']}, or the "
             "lineages differ")
    if deferred_b["aggregates"] != HEADLINE_CHURN["aggregates"]:
        fail(f"pipeline steady: {deferred_b['aggregates']}, expected "
             f"{HEADLINE_CHURN['aggregates']}")
    st = deferred_b["stats"]
    if (st["donated"], st["donation_reallocs"], st["tickets_open"], st["donation_canceled"]) != \
            (n_ticks, 0, 0, 0):
        fail(f"pipeline steady: ledger {st}, expected {n_ticks} donated, 0 reallocs, 0 open")
    if st["staging_reallocs"] != deferred_b["reference_drift"]:
        fail(f"pipeline steady: staging_reallocs {st['staging_reallocs']}, the reference's "
             f"count over the same takes is {deferred_b['reference_drift']}")
    first_bytes, last_bytes = deferred_b["staging_bytes"]
    if last_bytes != first_bytes:
        fail(f"pipeline steady: the staging ring grew after the first tick ({first_bytes} -> "
             f"{last_bytes} bytes)")
    launches = deferred_b["launches"]
    check_launched(launches, ("repair_free_inplace", "repair_scatter_inplace", "repair_gather",
                              "slot_commit"), "pipelined churn path")
    if launches["repair_free"] or launches["repair_scatter"]:
        fail(f"pipeline steady: K10 / K12 launched on the donating leg ({launches})")
    if serial_b["launches"]["repair_free_inplace"] or serial_b["launches"][
            "repair_scatter_inplace"]:
        fail("pipeline steady: K21 / K22 launched with KC_PIPELINE=0")
    print(f"pipeline path (b): {n_ticks} deferred donating ticks equal to the serial "
          "session's, ledgers balanced, K21/K22 only", flush=True)

    # -- (c) K21 and K22 on the last tick's inputs -------------------------------
    carry, free_new, free_ex, requests, member, own_inv = recorded["repair_free"]
    st_, ex, topo = carry.state, carry.ex_state, carry.topo
    k21 = (st_.used, st_.pod_count, topo.fwd_new, topo.inv_new, ex.used, ex.pod_count,
           topo.fwd_ex, topo.inv_ex)
    rest = (free_new, free_ex, requests, member, own_inv)
    k10_out = repair.repair_free(*clone_tree(k21), *rest)
    k21_out = repair.repair_free(*clone_tree(k21), *rest, inplace=True)
    if max_abs_err(k21_out, k10_out) != 0.0:
        fail("repair_free_inplace differs from K10 on a clone")
    work_k, work_p = clone_tree(k21), clone_tree(k21)
    n_cls, n_slots = free_new.shape
    n_res, g1 = requests.shape[1], member.shape[1]
    columns = n_slots + free_ex.shape[1]
    free_t = free_new.t().float().contiguous()
    record_kernel(
        records, "repair_free_inplace", "karpenter_core_tpu_torch/csrc/repair_free.cu",
        "karpenter_core_tpu/ops/solve.py:2012", launches["repair_free_inplace"],
        lambda: repair.repair_free(*work_k, *rest, inplace=True),
        lambda: repair.repair_free_inplace_plain(*work_p, *rest),
        nbytes(*k21, *rest) + nbytes(*k21), 2 * n_cls * columns * (n_res + 2 * g1 + 1),
        library_fn=lambda: torch.matmul(free_t, requests),
    )
    full, window, idx, n_open = recorded["scatter_repair_window"]
    w_rows = tuple(getattr(window.state, f) for f in repair.ROW_PLANES)
    win = (w_rows, window.topo.fwd_new, window.topo.inv_new, window.state.n_next, idx, n_open)

    def full_planes():
        c = clone_tree(full)
        return (tuple(getattr(c.state, f) for f in repair.ROW_PLANES), c.topo.fwd_new,
                c.topo.inv_new, c.state.n_next)

    k12_out = repair.scatter_window(*full_planes(), *win)
    k22_out = repair.scatter_window(*full_planes(), *win, inplace=True)
    if max_abs_err(k22_out, k12_out) != 0.0:
        fail("repair_scatter_inplace differs from K12 on a clone")
    work_k, work_p = full_planes(), full_planes()
    n_win = idx.shape[0]
    row_bytes = sum(nbytes(p) // p.shape[0] for p in w_rows)
    record_kernel(
        records, "repair_scatter_inplace", "karpenter_core_tpu_torch/csrc/repair_scatter.cu",
        "karpenter_core_tpu/ops/solve.py:2115", launches["repair_scatter_inplace"],
        lambda: repair.scatter_window(*work_k, *win, inplace=True),
        lambda: repair.scatter_window_inplace_plain(*work_p, *win),
        2 * n_win * row_bytes + 2 * (2 * g1 * n_win * 4) + nbytes(idx) + 12,
        n_win * 2,
    )
    print(f"pipeline path kernels exact: K21 (C={n_cls}, N={n_slots}, E={free_ex.shape[1]}) "
          f"and K22 (S={n_win} of N={n_slots}), each equal to its twin and to K10 / K12 on a "
          "clone", flush=True)

    # -- (d) a barrier past the watchdog deadline ------------------------------
    set_pipeline(True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(100_000_000)
    end.record()
    end.synchronize()
    cycles = int(100_000_000 * STALL_S * 1e3 / start.elapsed_time(end))
    saved = {k: os.environ.get(k) for k in ("KC_WATCHDOG_FLOOR_S", "KC_WATCHDOG_COLD_MULT")}
    os.environ["KC_WATCHDOG_FLOOR_S"], os.environ["KC_WATCHDOG_COLD_MULT"] = "0.2", "1"
    try:
        ingest = fresh_ingest()
        session = IncrementalSolveSession(solver, FallbackPolicy(**CHURN_POLICY))
        session.solve(ingest, deferred=True).result()
        churn_tick(ingest, 0, {})
        watchdog.reset_stats()
        pipeline_mod.reset_stats()
        stall = {"left": 1}
        real_fetch = solver.begin_fetch

        def stalled_fetch(outputs, ring=None):
            if stall["left"]:
                stall["left"] -= 1
                torch.cuda._sleep(cycles)  # queued on the compute stream before the ticket
            return real_fetch(outputs, ring=ring)

        solver.begin_fetch = stalled_fetch
        t0 = time.perf_counter()
        try:
            handle = session.solve(ingest, deferred=True)
            res = handle.result()
        finally:
            del solver.begin_fetch
        torch.cuda.synchronize()
        settle_s = time.perf_counter() - t0
        st = pipeline_mod.stats()
        reference = IncrementalSolveSession(solver, FallbackPolicy(enabled=False))
        want = tick_record(reference.solve(ingest))
        row = {"reason": session.last_reason, "mode": session.last_mode, "stats": st,
               "watchdog": watchdog.stats(), "stall_cycles": cycles, "wall_s": settle_s}
        print(json.dumps({"pipeline_timeout": row}), flush=True)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if (session.last_mode, session.last_reason) != ("full", "watchdog-timeout"):
        fail(f"pipeline timeout: {session.last_mode} ({session.last_reason}), expected a full "
             "re-anchor for watchdog-timeout")
    if tick_record(res) != want or session.node_signature() != reference.node_signature():
        fail("pipeline timeout: the re-anchor differs from a serial full solve")
    if st["donated"] != 1 or st["donation_canceled"] != st["donated"] or st["tickets_open"]:
        fail(f"pipeline timeout: ledger {st}")
    if watchdog.stats()["timeouts"] != {pipeline_mod.FETCH_SITE: 1}:
        fail(f"pipeline timeout: watchdog {watchdog.stats()}")
    print("pipeline path (d): the stalled barrier timed out at the floor and re-anchored to a "
          "serial full solve; ledgers balanced", flush=True)
    for rec in records:
        per_path = rec.setdefault("launches_per_path", {})
        for path, counts in path_launches.items():
            per_path.setdefault(path, counts.get(rec["name"], 0))
        per_path.setdefault("crossed", 0)
        per_path.setdefault("tenants", 0)
        rec.setdefault("tenants", 0)
        per_path["pipeline"] = launches[rec["name"]]
    return launches


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from karpenter_core_tpu_torch import carry
    from karpenter_core_tpu_torch.kernels import (
        build, capacity, classfinish, commit, fill, packbits, reqmerge,
    )
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
    print(f"kernel build: {build_s:.2f} s ({len(build.SOURCES)} sources, parallel nvcc)",
          flush=True)
    for name in build.SOURCES:
        build.load(name)

    # -- 1. cold path --------------------------------------------------------
    solver, pods = build_inputs(N_PODS, N_TYPES, N_PROVISIONERS)

    def fresh_ingest():
        ingest = PodIngest()
        ingest.add_all(pods)
        return ingest

    reset_launches()
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
            launches = launch_counts()
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
    check_launched(launches, PROVISIONING_KERNELS, "cold path")
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
    same_leaves(kernel_out, plain_solver.last_outputs, "cold path")
    del plain_solver, plain_res

    # the same warm solve with the class planes padded on the card (K15)
    os.environ["KC_ENCODE_DEVICE_FINISH"] = "1"
    ingest = PodIngest()
    ingest.add_all(pods)
    reset_launches()
    t0 = time.perf_counter()
    solver.solve(ingest)
    torch.cuda.synchronize()
    finish_launches = launch_counts()
    del os.environ["KC_ENCODE_DEVICE_FINISH"]
    print(json.dumps({"run": "warm, KC_ENCODE_DEVICE_FINISH=1", "wall_s": time.perf_counter() - t0,
                      **solver.stages, "launches": finish_launches}), flush=True)
    check_launched(finish_launches, ("class_finish",), "cold path with device-side class finish")
    same_leaves(solver.last_outputs, kernel_out, "cold path, classes finished on the card",
                "the host-padded solve")
    launches["class_finish"] = finish_launches["class_finish"]

    # -- 2. kernels against their plain twins, at the main path's shapes ------
    state = kernel_out.state
    snapshot = solver.encode(ingest)
    prep = solver.prepare_encoded(snapshot)
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

    record = functools.partial(record_kernel, records)

    # K3 merge + compat of class 0 into every final slot
    merged, _ = record(
        "req_merge", "karpenter_core_tpu_torch/csrc/req_merge.cu",
        "karpenter_core_tpu/ops/solve.py:312", launches["req_merge"],
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
    K1_WORK["solo"] = (
        nbytes(*[a for a in k1_args if isinstance(a, (torch.Tensor, tuple))])
        + n_slots * n_types * 5 + n_slots * 4,
        nbytes(cls0.it, st.it, st.vocab_ints, cls0.requests, st.it_alloc),
        n_slots * n_types * (st.it.mask.shape[1] * 6 + 12 + 4 * st.it_alloc.shape[1]),
    )
    _, cap_ni, cap_n = record(
        "it_capacity", "karpenter_core_tpu_torch/csrc/it_capacity.cu",
        "karpenter_core_tpu/ops/solve.py:334", launches["it_capacity"],
        lambda: capacity.it_capacity(*k1_args), lambda: capacity.it_capacity_plain(*k1_args),
        K1_WORK["solo"][0], K1_WORK["solo"][2],
    )
    # K2 priority fill of class 0's count over the K1 caps
    priority = state.pod_count * n_slots + torch.arange(n_slots, dtype=torch.int32, device="cuda")
    priority = torch.where(cap_n > 0, priority, 2**31 - 1)
    quota = torch.tensor(int(cls0.count) if int(cls0.count) > 0 else 1000, dtype=torch.int32,
                         device="cuda")
    record(
        "fill_priority", "karpenter_core_tpu_torch/csrc/fill_priority.cu",
        "karpenter_core_tpu/ops/solve.py:419", launches["fill_priority"],
        lambda: fill.fill_by_priority(quota, cap_n, priority),
        lambda: fill.fill_by_priority_plain(quota, cap_n, priority),
        nbytes(quota, cap_n, priority) + n_slots * 4,
        n_slots * 32 * 4,
    )
    # K2 on a sorted input: the same caps with index priorities, the
    # existing-node fills' form (no sort)
    index_pri = torch.where(cap_n > 0, torch.arange(n_slots, dtype=torch.int32, device="cuda"),
                            2**31 - 1)
    axis_line(records, "fill_priority", "sorted_input", None,
              lambda: fill.fill_by_priority(quota, cap_n, index_pri),
              lambda: fill.fill_by_priority_plain(quota, cap_n, index_pri),
              nbytes(quota, cap_n, index_pri) + n_slots * 4, n_slots * 8, plain_reps=20,
              n=n_slots)
    # K2's multi-block path at N = 32,768: the main path's plane four times
    # over (duplicate priorities, so the sort's stability shows), then a
    # quota whose int32 prefix sums wrap
    k2 = records[-1]
    cap_m, pri_m = cap_n.repeat(4), priority.repeat(4)
    quota_m = torch.tensor(int(cap_m.sum()) // 2, dtype=torch.int32, device="cuda")
    big, wrap = torch.full_like(cap_m, 2**30), torch.tensor(2**31 - 1, dtype=torch.int32,
                                                            device="cuda")
    for args in ((quota_m, cap_m, pri_m), (wrap, big, pri_m)):
        err = max_abs_err(fill.fill_by_priority(*args), fill.fill_by_priority_plain(*args))
        if err != 0.0:
            fail(f"fill_priority at N = {cap_m.shape[0]} differs from its twin: {err}")
    n_m = cap_m.shape[0]
    k2["multi_block"] = {
        "n": n_m, "ms": time_ms(lambda: fill.fill_by_priority(quota_m, cap_m, pri_m)),
        "plain_ms": time_ms(lambda: fill.fill_by_priority_plain(quota_m, cap_m, pri_m)),
        "bound_ms": (12 * n_m + 4) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }
    print(f"fill_priority multi-block N={n_m}: ms {k2['multi_block']['ms']:.4f} "
          f"plain_ms {k2['multi_block']['plain_ms']:.4f} exact (and a wrapping quota)", flush=True)
    # K15: the headline's compact class rows into its bucket
    cls_c, sa_c, _ = solve_ops.prepare_host(snapshot)
    compact = solve_ops.ClassTensors(*(carry.to_tensor(a, "cuda") for a in cls_c))
    g1_old = sa_c.grp_skew.shape[0]
    ext = classfinish.Extents(
        solve_ops.bucket(cls_c.count.shape[0]), solve_ops.bucket(sa_c.valid.shape[0]),
        solve_ops.bucket(sa_c.valid.shape[1] - 1), g1_old,
        solve_ops.bucket(g1_old - 1, floor=4) + 1, solve_ops.bucket(cls_c.ports.shape[-1], floor=4))
    finished = record(
        "class_finish", "karpenter_core_tpu_torch/csrc/class_finish.cu",
        "karpenter_core_tpu/ops/solve.py:2623", launches["class_finish"],
        lambda: classfinish.finish_class_planes(compact, ext),
        lambda: classfinish.finish_class_planes_plain(compact, ext),
        nbytes(tuple(compact)) + nbytes(tuple(prep.cls)), sum(t.numel() for t in prep.cls),
    )
    if max_abs_err(finished, tuple(prep.cls)) != 0.0:
        fail("class_finish differs from the host padding of the same rows")
    # K4 bit-pack of the final viable plane
    record(
        "pack_bool", "karpenter_core_tpu_torch/csrc/pack_bool.cu",
        "karpenter_core_tpu/ops/solve.py:2121", launches["pack_bool"],
        lambda: packbits.pack_bool(state.viable), lambda: packbits.pack_bool_plain(state.viable),
        nbytes(state.viable) + n_slots * ((n_types + 7) // 8),
        n_slots * n_types * 2,
    )
    # K23 on the commit that took the most rows in one more warm solve
    k23 = captured_commit(lambda: solver.solve(fresh_ingest()))
    moved, ops, shapes = slot_commit_work(*k23)
    record(
        "slot_commit", "karpenter_core_tpu_torch/csrc/slot_commit.cu",
        "karpenter_core_tpu/ops/solve.py:755", launches["slot_commit"],
        lambda: commit.slot_commit(*k23), lambda: commit.slot_commit_twin(*k23), moved, ops,
    )
    records[-1]["shapes"] = shapes
    del k23

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

    mid_cluster, cluster, existing_launches = existing_path(records, launches)
    consolidation_launches, crossed_inputs = consolidation_path(
        records, mid_cluster, cluster, launches, existing_launches)
    del cluster
    crossed_launches = crossed_path(crossed_inputs)
    del crossed_inputs
    path_launches = {"cold": launches, "existing": existing_launches,
                     "consolidation": consolidation_launches}
    set_pipeline(False)  # phase 5 is the serial tick: K10 and K12
    churn_launches = churn_path(records, mid_cluster, path_launches)
    set_pipeline(True)
    path_launches["churn"] = churn_launches
    path_launches["policy"] = policy_path(records, mid_cluster, path_launches)
    path_launches["relax"] = relax_path(records, path_launches)
    tenant_path(records, path_launches)
    whatif_path(records, path_launches, solver, pods, kernel_out, crossed_launches)
    del solver, kernel_out
    pipeline_path(records, path_launches)
    print("library_ms: K8's is one torch.matmul of the f32 lane-subset mask with the f32 "
          "count plane; K10's and K21's one torch.matmul of the f32 eviction plane with the "
          "class requests; null for the others — no single PyTorch call computes them (K13: a "
          "masked argmin with the spot tie rule and ordered sums; K15: sixteen padded planes "
          "with a group remap; K14: a masked min over capacity types and templates with its "
          "argmin; K16: a sort, a blocked scan, a count and a threshold, iterated under a "
          "global stop; K17: an argmin, floors and a seeded stable sort with an audit; K18: "
          "a prefix over cells and a gather of slot rows; K19: a counter-based threefry draw "
          "and a threshold; K20: masked minima over offerings and sums in XLA's order; K22: "
          "row copies into thirteen planes, two column copies and an add; K23: row selects "
          "from three sources over thirteen planes, a compare of the K1 caps and an FMA)",
          flush=True)
    print(json.dumps({"chip_smoke_total_s": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
