from karpenter_core_tpu_torch.testing.factories import (
    make_node,
    make_pod,
    make_pods,
    make_provisioner,
    make_daemonset_pod,
)

__all__ = ["make_node", "make_pod", "make_pods", "make_provisioner", "make_daemonset_pod"]
