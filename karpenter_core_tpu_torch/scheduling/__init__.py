from karpenter_core_tpu_torch.scheduling.requirement import Requirement
from karpenter_core_tpu_torch.scheduling.requirements import Requirements
from karpenter_core_tpu_torch.scheduling.taints import Taints

__all__ = ["Requirement", "Requirements", "Taints"]
