from karpenter_core_tpu_torch.cloudprovider.types import (
    CloudProvider,
    InstanceType,
    InsufficientCapacityError,
    MachineNotFoundError,
    Offering,
    Offerings,
    TransientCloudError,
)

__all__ = [
    "CloudProvider",
    "InstanceType",
    "InsufficientCapacityError",
    "MachineNotFoundError",
    "Offering",
    "Offerings",
    "TransientCloudError",
]
