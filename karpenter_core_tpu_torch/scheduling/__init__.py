from karpenter_core_tpu_torch.scheduling.requirement import Requirement
from karpenter_core_tpu_torch.scheduling.requirements import Requirements
from karpenter_core_tpu_torch.scheduling.taints import Taints
from karpenter_core_tpu_torch.scheduling.hostportusage import HostPortUsage
from karpenter_core_tpu_torch.scheduling.volumeusage import VolumeUsage, VolumeCount

__all__ = ["Requirement", "Requirements", "Taints", "HostPortUsage", "VolumeUsage", "VolumeCount"]
