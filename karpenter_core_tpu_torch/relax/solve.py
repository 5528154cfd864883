"""The relax family's host orchestrator: gate, dispatch, audit-repair, merge.

The port of ``karpenter_core_tpu/relax/solve.py``.  ``run_relax`` is the
cold-solve twin of ``CudaSolver.run_prepared``'s scan dispatch (which calls
it when solver/modes.py routes a batch here).  The contract with the caller
is all-or-nothing per batch:

  1. HOST GATES — constraint families the relaxation does not model raise
     ``RelaxFallback`` at once (the scan runs instead, and the reason lands
     in ``CudaSolver.last_solve_mode``): no objective planes on the prep,
     existing-node planes, finite provisioner limits, or no relax-eligible
     class at all.  A class with topology groups, host ports, a preference
     ladder or soft-anti terms is simply not eligible: its pods go to the
     exact repair pass with every constraint enforced.
  2. KERNEL — one ``relax_core`` (relax/kernel.py) on the prep's device.
  3. VERDICT — one host read of the verdict scalars; non-convergence or a
     fully-audited-away result raises ``RelaxFallback`` (nothing was
     committed; the scan re-solves from scratch).
  4. EXACT REPAIR — leftover pods (ineligible classes, audited-out cells,
     slot spill) run through the warm-start repair over the relax result's
     carry: a bounded window when it fits (``ops.solve.gather/
     scatter_repair_window``, K11/K12), retried at full width when the
     window runs out of slots, and the full width otherwise.  The repair is
     the exact scan (K1-K7).

Left out, each with a later item: the ``relax.solve`` tracing span and the
``solve.mode`` counter (ROADMAP 1.5, with the metrics and spans), the
watchdog around the dispatch (1.5), and the mesh ``device_put`` of the
inputs (1.8).  The reference's executable cache (``compilecache.
relax_callable``) has no counterpart: the port runs eagerly, and the seeded
permutation, the one input worth keeping, is memoized (``relax.prng``).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from karpenter_core_tpu_torch.ops import masks as mask_ops
from karpenter_core_tpu_torch.ops import solve as solve_ops

log = logging.getLogger(__name__)

# projected-gradient convergence tolerance (max per-class normalized step)
RELAX_TOL = np.float32(1e-4)
# deterministic rounding tie-order seed: a constant, so the same snapshot
# rounds identically across processes and replicas
RELAX_SEED = 0

I32 = torch.int32


class RelaxFallback(Exception):
    """The relax family declines this batch; the scan must run it.

    ``reason``: no-planes | existing-nodes | template-limits |
    no-eligible-classes | non-convergence | no-placements."""

    def __init__(self, reason: str) -> None:
        super().__init__(reason)
        self.reason = reason


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def eligible_classes(prep, cls=None) -> np.ndarray:
    """bool[C]: classes the relaxation models exactly — no topology group
    owned or joined, no host ports, no preference ladder, no soft-anti
    terms.  Everything else keeps full pod counts in ``leftover``."""
    if cls is None:
        cls = prep.cls
    sa = solve_ops.StaticArrays(*prep.statics_arrays)
    g1 = int(sa.grp_skew.shape[0])
    groups = _host(cls.groups)
    member = _host(sa.grp_member)
    idx = np.arange(groups.shape[0], dtype=np.int64)
    return (
        np.all(groups == g1 - 1, axis=1)
        & ~member[:, : max(g1 - 1, 0)].any(axis=1)
        & ~_host(cls.ports).any(axis=1)
        & (_host(cls.relax_next) < 0)
        & (_host(cls.root) == idx)
        & ~_host(cls.anti_soft).any(axis=1)
    )


def _policy_weights(policy) -> np.ndarray:
    """f32[3] (cost_weight, risk_aversion, throughput_weight).  With policy
    off the objective degrades to the raw price sheet."""
    if policy is not None and getattr(policy, "enabled", False):
        return np.asarray(
            [
                float(getattr(policy, "cost_weight", 1.0)),
                float(getattr(policy, "risk_aversion", 0.0)),
                float(getattr(policy, "throughput_weight", 0.0)),
            ],
            dtype=np.float32,
        )
    return np.asarray([1.0, 0.0, 0.0], dtype=np.float32)


def _empty_carry_planes(prep, cls, n_slots: int):
    """(ex_state, topo, remaining) for a cold relax result — the inert planes
    ``solve_core`` builds for a cold scan with no existing nodes, so the
    repair resumes over the same semantics.  Masks packed."""
    sa = solve_ops.StaticArrays(*prep.statics_arrays)
    dev = sa.it_alloc.device
    n_res = int(sa.it_alloc.shape[-1])
    n_keys = int(sa.valid.shape[0])
    width = int(sa.valid.shape[-1])
    g1 = int(sa.grp_skew.shape[0])
    ex_state = solve_ops.empty_existing_state(
        n_res, n_keys, width, int(cls.zone.shape[-1]), int(cls.ct.shape[-1]),
        int(cls.ports.shape[-1]), device=dev)
    ex_state = ex_state._replace(kmask=mask_ops.pack_mask(ex_state.kmask))
    topo = solve_ops.TopoCounts(
        fwd_ex=torch.zeros((g1, 1), dtype=I32, device=dev),
        inv_ex=torch.zeros((g1, 1), dtype=I32, device=dev),
        fwd_new=torch.zeros((g1, n_slots), dtype=I32, device=dev),
        inv_new=torch.zeros((g1, n_slots), dtype=I32, device=dev),
    )
    remaining = sa.tmpl_limits0.to(torch.float32).clone()
    return ex_state, topo, remaining


def _zero_repair_plan(n_classes: int, n_slots_w: int, g1: int, n_zones: int, device,
                      base=None) -> solve_ops.RepairPlan:
    """A no-preference RepairPlan (pure additions); ``base`` carries the
    out-of-window topology planes from ``gather_repair_window`` when the
    repair is bounded."""
    if base is None:
        zeros_gz = torch.zeros((g1, n_zones), dtype=I32, device=device)
        base = (zeros_gz, zeros_gz, zeros_gz)
    return solve_ops.RepairPlan(
        pref_new=torch.zeros((n_classes, n_slots_w), dtype=I32, device=device),
        pref_ex=torch.zeros((n_classes, 1), dtype=I32, device=device),
        base_fwd_sing=base[0],
        base_fwd_full=base[1],
        base_inv_full=base[2],
    )


def run_relax(solver, prep, cls=None, n_slots: int = 0) -> solve_ops.SolveOutputs:
    """Run one cold solve through the relax family (module docstring).

    ``solver`` is the CudaSolver (policy weights, kernels flag and the
    repair dispatch); ``prep`` a cold SolvePrep; ``cls`` optionally
    overrides the prep's class tensors (run_prepared's ``count`` merge).
    Returns full-width scan-shaped SolveOutputs or raises ``RelaxFallback``.
    ``solver.stages["relax_s"]`` gets the seconds from the dispatch to the
    verdict read, ``stages["relax_repair_s"]`` those of the repair after it
    (its dispatch: the scan's skip decisions wait for the card)."""
    from karpenter_core_tpu_torch.relax import kernel as relax_kernel
    from karpenter_core_tpu_torch.solver import modes

    if cls is None:
        cls = prep.cls
    pol = getattr(prep, "pol", None)
    if pol is None:
        raise RelaxFallback("no-planes")
    if prep.ex_state is not None:
        raise RelaxFallback("existing-nodes")
    sa = solve_ops.StaticArrays(*prep.statics_arrays)
    if bool(torch.isfinite(sa.tmpl_limits0).any()):
        raise RelaxFallback("template-limits")
    counts = _host(cls.count).astype(np.int64)
    eligible = eligible_classes(prep, cls)
    if not bool(np.any(eligible & (counts > 0))):
        raise RelaxFallback("no-eligible-classes")

    n_slots = int(n_slots or prep.n_slots)
    n_classes = int(counts.shape[0])
    dev = sa.it_alloc.device
    t0 = time.perf_counter()
    res = relax_kernel.relax_core(
        cls, prep.statics_arrays, pol.price, pol.risk, pol.throughput,
        torch.as_tensor(eligible, device=dev),
        torch.as_tensor(_policy_weights(solver.policy), device=dev),
        modes.relax_max_iters(), RELAX_TOL, RELAX_SEED,
        n_slots=n_slots, key_has_bounds=prep.key_has_bounds, use_kernels=solver.use_kernels,
    )
    # the one host read of the verdict
    verdict = torch.cat([torch.stack([
        res.iters.to(I32), res.converged.to(I32), res.violations.to(I32), res.placed.to(I32),
        res.state.n_next.to(I32)]), res.leftover.to(I32)]).cpu().numpy()
    iters, converged, violations, placed, n_used = (int(v) for v in verdict[:5])
    leftover = verdict[5:].astype(np.int32)
    t1 = time.perf_counter()
    solver.stages["relax_s"] = t1 - t0
    solver.last_relax_stats = {
        "iters": iters,
        "converged": bool(converged),
        "rounded_violations": violations,
        "placed": placed,
        "leftover": int(np.sum(leftover)),
    }
    if not converged:
        raise RelaxFallback("non-convergence")
    if placed == 0 and int(np.sum(counts)) > 0:
        raise RelaxFallback("no-placements")

    total_leftover = int(np.sum(leftover))
    ex_state, topo, remaining = _empty_carry_planes(prep, cls, n_slots)
    g1 = int(topo.fwd_ex.shape[0])
    n_zones = int(cls.zone.shape[-1])

    if total_leftover == 0:
        solver.stages["relax_repair_s"] = 0.0
        return solve_ops.SolveOutputs(
            assign=res.assign,
            assign_existing=torch.zeros((n_classes, 1), dtype=I32, device=dev),
            failed=torch.zeros((n_classes,), dtype=I32, device=dev),
            state=res.state,
            ex_state=ex_state,
            spread_suspect=torch.zeros((n_classes,), dtype=torch.bool, device=dev),
            topo=topo,
            remaining=remaining,
        )

    # -- exact repair over the relax carry ------------------------------------
    carry = solve_ops.WarmCarry(state=res.state, ex_state=ex_state, topo=topo,
                                remaining=remaining)
    # bounded window when it fits: the relax-open slots (the contiguous
    # prefix [0, n_used)) plus a fresh tail sized for the leftover
    window_w = solve_ops.bucket(min(n_used + max(total_leftover, 16), n_slots))
    repaired = None
    if window_w < n_slots:
        idx = torch.arange(window_w, dtype=I32, device=dev)
        win_carry, base = solve_ops.gather_repair_window(
            carry, idx, n_used, use_kernels=solver.use_kernels)
        plan = _zero_repair_plan(n_classes, window_w, g1, n_zones, dev, base=base)
        rep = solver.run_prepared(prep, count=leftover, warm_carry=win_carry,
                                  repair_plan=plan, n_slots=window_w, donate_carry=False)
        if solver.fetch_exhausted(solver.begin_fetch(rep).wait(), window_w):
            log.debug("relax repair window %d exhausted; retrying full-width", window_w)
        else:
            merged = solve_ops.scatter_repair_window(
                carry, solve_ops.warm_carry_of(rep), idx, n_used,
                use_kernels=solver.use_kernels)
            assign = res.assign.clone()
            assign[:, :window_w] += rep.assign
            repaired = (rep, merged, assign)
    if repaired is None:
        plan = _zero_repair_plan(n_classes, n_slots, g1, n_zones, dev)
        rep = solver.run_prepared(prep, count=leftover, warm_carry=carry, repair_plan=plan,
                                  n_slots=n_slots, donate_carry=False)
        merged = solve_ops.warm_carry_of(rep)
        repaired = (rep, merged, res.assign + rep.assign)
    rep, merged, assign = repaired
    solver.stages["relax_repair_s"] = time.perf_counter() - t1
    return solve_ops.SolveOutputs(
        assign=assign,
        assign_existing=rep.assign_existing,
        failed=rep.failed,
        state=merged.state,
        ex_state=merged.ex_state,
        spread_suspect=rep.spread_suspect,
        topo=merged.topo,
        remaining=merged.remaining,
    )
