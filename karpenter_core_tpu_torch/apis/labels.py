"""Label taxonomy: well-known, restricted, and normalized label keys.

Mirrors karpenter-core pkg/apis/v1alpha5/labels.go:26-109.
"""

from __future__ import annotations

GROUP = "karpenter.sh"
TESTING_GROUP = "testing.karpenter.sh"
COMPATIBILITY_GROUP = "compatibility." + GROUP

# Standard kubernetes label keys (k8s.io/api/core/v1 well-known labels)
LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_TOPOLOGY_ZONE = "topology.kubernetes.io/zone"
LABEL_TOPOLOGY_REGION = "topology.kubernetes.io/region"
LABEL_INSTANCE_TYPE_STABLE = "node.kubernetes.io/instance-type"
LABEL_ARCH_STABLE = "kubernetes.io/arch"
LABEL_OS_STABLE = "kubernetes.io/os"
LABEL_FAILURE_DOMAIN_BETA_ZONE = "failure-domain.beta.kubernetes.io/zone"
LABEL_FAILURE_DOMAIN_BETA_REGION = "failure-domain.beta.kubernetes.io/region"
LABEL_INSTANCE_TYPE_BETA = "beta.kubernetes.io/instance-type"
LABEL_NODE_EXCLUDE_BALANCERS = "node.kubernetes.io/exclude-from-external-load-balancers"
LABEL_NAMESPACE_SUFFIX_NODE = "node.kubernetes.io"

# Well-known values
ARCHITECTURE_AMD64 = "amd64"
ARCHITECTURE_ARM64 = "arm64"
CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_ON_DEMAND = "on-demand"

# Karpenter-specific labels
PROVISIONER_NAME_LABEL_KEY = GROUP + "/provisioner-name"
MACHINE_NAME_LABEL_KEY = GROUP + "/machine-name"
LABEL_NODE_INITIALIZED = GROUP + "/initialized"
LABEL_CAPACITY_TYPE = GROUP + "/capacity-type"

# Karpenter-specific annotations
DO_NOT_EVICT_POD_ANNOTATION_KEY = GROUP + "/do-not-evict"
DO_NOT_CONSOLIDATE_NODE_ANNOTATION_KEY = GROUP + "/do-not-consolidate"
EMPTINESS_TIMESTAMP_ANNOTATION_KEY = GROUP + "/emptiness-timestamp"
VOLUNTARY_DISRUPTION_ANNOTATION_KEY = GROUP + "/voluntary-disruption"
PROVIDER_COMPATIBILITY_ANNOTATION_KEY = COMPATIBILITY_GROUP + "/provider"
VOLUNTARY_DISRUPTION_DRIFTED_ANNOTATION_VALUE = "drifted"

# Finalizers
TERMINATION_FINALIZER = GROUP + "/termination"

# Restricted label domains: prohibited by the kubelet or reserved by the framework
RESTRICTED_LABEL_DOMAINS = frozenset({"kubernetes.io", "k8s.io", GROUP})

LABEL_DOMAIN_EXCEPTIONS = frozenset({
    "kops.k8s.io",
    LABEL_NAMESPACE_SUFFIX_NODE,
    TESTING_GROUP,
})

# Mutable: cloud providers may register additional well-known labels
# (mirrors v1alpha5.WellKnownLabels.Insert in the reference's fake provider).
WELL_KNOWN_LABELS = {
    PROVISIONER_NAME_LABEL_KEY,
    LABEL_TOPOLOGY_ZONE,
    LABEL_TOPOLOGY_REGION,
    LABEL_INSTANCE_TYPE_STABLE,
    LABEL_ARCH_STABLE,
    LABEL_OS_STABLE,
    LABEL_CAPACITY_TYPE,
}


def register_well_known_labels(*keys: str) -> None:
    WELL_KNOWN_LABELS.update(keys)

RESTRICTED_LABELS = frozenset({
    EMPTINESS_TIMESTAMP_ANNOTATION_KEY,
    LABEL_HOSTNAME,
})

# Aliased labels translated into their canonical forms on requirement construction
NORMALIZED_LABELS = {
    LABEL_FAILURE_DOMAIN_BETA_ZONE: LABEL_TOPOLOGY_ZONE,
    "beta.kubernetes.io/arch": LABEL_ARCH_STABLE,
    "beta.kubernetes.io/os": LABEL_OS_STABLE,
    LABEL_INSTANCE_TYPE_BETA: LABEL_INSTANCE_TYPE_STABLE,
    LABEL_FAILURE_DOMAIN_BETA_REGION: LABEL_TOPOLOGY_REGION,
}


def _domain(key: str) -> str:
    return key.split("/", 1)[0] if "/" in key else ""


def is_restricted_node_label(key: str) -> bool:
    """True for labels Karpenter must not inject onto nodes itself
    (labels.go:123-138): well-known labels are the CLOUD PROVIDER's to stamp
    (it knows the resolved zone/instance type; rendering them from a
    multi-valued requirement would pick an arbitrary value), restricted
    labels/domains are owned by other software."""
    if key in WELL_KNOWN_LABELS:
        return True
    if key in RESTRICTED_LABELS:
        return True
    domain = _domain(key)
    if domain in LABEL_DOMAIN_EXCEPTIONS or any(
        domain.endswith("." + exc) for exc in LABEL_DOMAIN_EXCEPTIONS
    ):
        return False
    return any(
        domain == restricted or domain.endswith("." + restricted)
        for restricted in RESTRICTED_LABEL_DOMAINS
    )
