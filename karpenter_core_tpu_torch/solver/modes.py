"""Solver-mode routing: which solver family runs a cold solve.

A copy of ``karpenter_core_tpu/solver/modes.py``.

Two families share the encoded planes (docs/RELAX.md):

  scan    the exact greedy-by-priority class scan (ops/solve.py) — the
          default, and the only family that handles every constraint
  relax   the convex-relaxation family (karpenter_core_tpu_torch/relax/):
          projected-gradient placement over the policy objective planes,
          deterministically rounded, exactly audited, scan-repaired

``KC_SOLVER_MODE=scan|relax|auto`` selects; a ``PolicyConfig.solver_mode``
(provisioner spec ``solverMode``) OVERRIDES the env — spec wins over env so a
per-tenant config can pin a family while the fleet default rides the flag.
``auto`` picks relax only at scale (>= ``KC_RELAX_MIN_PODS`` pods in the
batch): below that the scan is both exact and faster, above it the
relaxation's fixed iteration count beats the pod-proportional scan.

The dispatcher itself lives in ``CudaSolver.run_prepared`` (cold solves only:
warm-carry repairs always run the scan — the carry IS scan state), which
reports the outcome as ``last_solve_mode`` ("scan", "relax" or
"relax-fallback:<reason>").  A relax run that cannot stand (host gate,
non-convergence, audit wipeout) raises ``relax.solve.RelaxFallback`` and the
scan runs as if relax never existed — the mode is approximate in cost, never
wrong in placement.
"""

from __future__ import annotations

import os

MODE_SCAN = "scan"
MODE_RELAX = "relax"
MODE_AUTO = "auto"
_VALID = (MODE_SCAN, MODE_RELAX, MODE_AUTO)


def resolve_mode(policy=None) -> str:
    """The configured solver mode: provisioner/policy spec > KC_SOLVER_MODE
    env > scan.  Unknown values degrade to scan (the kill-switch semantics:
    a typo'd mode must not strand a tenant on an unintended family)."""
    spec = ""
    if policy is not None:
        spec = str(getattr(policy, "solver_mode", "") or "")
    mode = spec or os.environ.get("KC_SOLVER_MODE", "") or MODE_SCAN
    return mode if mode in _VALID else MODE_SCAN


def relax_min_pods() -> int:
    """KC_RELAX_MIN_PODS: the ``auto`` mode's pod-count threshold (default
    4096) — below it the exact scan wins on both latency and cost."""
    try:
        return int(os.environ.get("KC_RELAX_MIN_PODS", "4096"))
    except ValueError:
        return 4096


def relax_selected(mode: str, n_pods: int) -> bool:
    """Does this cold solve dispatch through the relax family?"""
    if mode == MODE_RELAX:
        return True
    if mode == MODE_AUTO:
        return int(n_pods) >= relax_min_pods()
    return False


def relax_max_iters() -> int:
    """KC_RELAX_MAX_ITERS: projected-gradient iteration cap (default 64).
    The iteration contracts geometrically (relax/kernel.py), so the default
    converges with a wide margin; a too-small cap is the convergence-fallback
    test's lever, not a production knob."""
    try:
        return int(os.environ.get("KC_RELAX_MAX_ITERS", "64"))
    except ValueError:
        return 64
