"""The relaxation solver family (``KC_SOLVER_MODE=relax``).

The port of ``karpenter_core_tpu/relax/``: pod-class -> (instance type,
zone, capacity type) placement as a continuous relaxation over the same
encoded planes the scan consumes — class counts as simplex constraints, the
packed-mask / capacity / offering predicates as the support, the policy
objective planes as the linear cost — solved by projected gradient on the
card (relax/kernel.py, K14 and K16-K18), rounded deterministically (largest
fraction first, seeded tie order from relax/prng.py), audited against the
exact predicate planes, and repaired by the warm-start scan (relax/solve.py).
Approximate in cost, never wrong in placement.
"""

from karpenter_core_tpu_torch.relax.kernel import RelaxResult, relax_core
from karpenter_core_tpu_torch.relax.solve import RelaxFallback, run_relax

__all__ = ["RelaxResult", "RelaxFallback", "relax_core", "run_relax"]
