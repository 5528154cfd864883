"""The policy objective: which offering each new node lands on.

Copies of ``karpenter_core_tpu/policy``'s host half:

  - ``config``: the ``PolicyConfig`` knob surface (weights, risk aversion,
    enable flags) resolved from env + the Provisioner's ``spec.policy`` block;
    the default is the feasibility-only decode, ``KC_POLICY=0`` the kill
    switch.
  - ``planes``: the dense objective planes (price / interruption risk /
    throughput over the instance-type x zone x capacity-type axes) that ride
    every encoded snapshot, and their no-encode digest.

The scoring and argmin run in ``ops.objective`` (K13, ``csrc/select_offerings.cu``).
"""

from karpenter_core_tpu_torch.policy.config import PolicyConfig, policy_enabled
from karpenter_core_tpu_torch.policy.planes import (
    ObjectivePlanes,
    attach_planes,
    build_planes,
    planes_of,
    policy_input_digest,
)

__all__ = [
    "PolicyConfig",
    "policy_enabled",
    "ObjectivePlanes",
    "attach_planes",
    "build_planes",
    "planes_of",
    "policy_input_digest",
]
