"""PolicyConfig: the policy-objective knob surface.

A copy of ``karpenter_core_tpu/policy/config.py``.  One frozen config object
flows from the operator's environment and the Provisioner CRD's
``spec.policy`` block into every consumer — the snapshot planes
(policy.planes), the offering-selection kernel (ops.objective, K13) and
policy-aware consolidation (solver.consolidation).  The counter-proposal
knobs are carried so the digest matches the reference's; the port has no
counter-proposal engine yet.

Defaults are today's behavior EXACTLY: ``enabled=False`` means no objective
selection, no consolidation re-scoring, no counter-proposals — the solve
pipeline is bit-identical to a build without this package.  ``KC_POLICY=0``
is the process-wide kill switch: it forces ``enabled=False`` even when a
Provisioner's spec asks for the objective (triage lever, docs/POLICY.md).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, replace
from typing import Optional, Tuple


def policy_enabled() -> bool:
    """The process-wide kill switch: KC_POLICY=0 disables the objective stage
    everywhere regardless of per-provisioner spec (mirrors
    KC_SOLVER_INCREMENTAL's contract)."""
    return os.environ.get("KC_POLICY", "1") != "0"


@dataclass(frozen=True)
class PolicyConfig:
    """Objective weights + enable flags.

    The objective score of one (instance type i, zone z, capacity type ct)
    offering cell is

        score = cost_weight * price[i,z,ct] * (1 + risk_aversion * risk[i,z,ct])
                - throughput_weight * throughput[i]

    minimized over the node's feasible cells (ops.objective).  With the
    default weights the score IS the offering price, so selection is exactly
    ``Offerings.cheapest()`` — the host-oracle parity tier-1 pins.
    """

    enabled: bool = False
    cost_weight: float = 1.0
    # heterogeneity (Gavel-style): per-instance-type throughput weights make
    # a pricier type win when its throughput more than pays for the delta
    throughput_weight: float = 0.0
    # risk aversion scales the interruption-risk prior into an expected-cost
    # premium: 0 = price-only, 1 = a certain interruption doubles the price
    risk_aversion: float = 0.0
    # prefer spot over on-demand on exact score ties (the host convention:
    # worst_launch_price consults spot before on-demand, and consolidation
    # pins spot when both remain allowed)
    spot_preference: bool = True
    # counter-proposals: emit ShapeHint events for pods a bounded resize
    # would make schedulable on a strictly cheaper fleet
    counter_proposals: bool = False
    max_resize_fraction: float = 0.5
    # per-instance-type throughput weights, as a hashable sorted tuple of
    # (instance-type name, weight); types absent default to 0.0
    throughput: Tuple[Tuple[str, float], ...] = ()
    # solver-family routing (solver/modes.py): "" = defer to KC_SOLVER_MODE
    # env / scan; "scan" | "relax" | "auto" pins the family for this config
    # (spec wins over env).  Deliberately OUTSIDE digest(): the mode changes
    # which program runs, not the objective inputs — the incremental session
    # escalates on a flip via its own "mode-changed" reason instead.
    solver_mode: str = ""

    # -- construction ----------------------------------------------------------

    @classmethod
    def from_env(cls) -> "PolicyConfig":
        def _f(name: str, default: float) -> float:
            try:
                return float(os.environ.get(name, default))
            except ValueError:
                return default

        def _b(name: str, default: bool) -> bool:
            raw = os.environ.get(name)
            if raw is None:
                return default
            return raw not in ("0", "false", "False", "")

        return cls(
            enabled=_b("KC_POLICY_ENABLED", False) and policy_enabled(),
            cost_weight=_f("KC_POLICY_COST_WEIGHT", 1.0),
            throughput_weight=_f("KC_POLICY_THROUGHPUT_WEIGHT", 0.0),
            risk_aversion=_f("KC_POLICY_RISK_AVERSION", 0.0),
            spot_preference=_b("KC_POLICY_SPOT_PREFERENCE", True),
            counter_proposals=_b("KC_POLICY_COUNTER_PROPOSALS", False),
            max_resize_fraction=_f("KC_POLICY_MAX_RESIZE_FRACTION", 0.5),
            solver_mode=os.environ.get("KC_SOLVER_MODE", ""),
        )

    def merged(self, spec: Optional[dict]) -> "PolicyConfig":
        """Overlay a Provisioner ``spec.policy`` dict (wire-cased keys).
        Unknown keys are ignored; the KC_POLICY kill switch still wins."""
        if not spec:
            return self
        fields = {}
        mapping = {
            "enabled": ("enabled", bool),
            "costWeight": ("cost_weight", float),
            "throughputWeight": ("throughput_weight", float),
            "riskAversion": ("risk_aversion", float),
            "spotPreference": ("spot_preference", bool),
            "counterProposals": ("counter_proposals", bool),
            "maxResizeFraction": ("max_resize_fraction", float),
            "solverMode": ("solver_mode", str),
        }
        for wire_key, (attr, cast) in mapping.items():
            if wire_key in spec:
                try:
                    fields[attr] = cast(spec[wire_key])
                except (TypeError, ValueError):
                    continue
        if isinstance(spec.get("throughput"), dict):
            fields["throughput"] = tuple(
                sorted((str(k), float(v)) for k, v in spec["throughput"].items())
            )
        out = replace(self, **fields)
        if out.enabled and not policy_enabled():
            out = replace(out, enabled=False)
        return out

    @classmethod
    def resolve(cls, provisioners=None) -> "PolicyConfig":
        """The config one reconcile runs under: env defaults overlaid by the
        highest-weight provisioner that declares a ``spec.policy`` block
        (one fleet, one objective — mirrors how template preference order is
        already weight-driven)."""
        from karpenter_core_tpu_torch.apis.v1alpha5 import order_by_weight

        config = cls.from_env()
        for provisioner in order_by_weight(list(provisioners or [])):
            spec = getattr(provisioner.spec, "policy", None)
            if spec:
                return config.merged(spec)
        return config

    # -- identity --------------------------------------------------------------

    def throughput_of(self, name: str) -> float:
        for it_name, weight in self.throughput:
            if it_name == name:
                return weight
        return 0.0

    def digest(self) -> str:
        """Stable content digest of every objective-relevant knob — part of
        the incremental session's policy input digest, so flipping a weight
        escalates the next solve to full exactly like a price change."""
        h = hashlib.sha256()
        h.update(repr((
            self.enabled, self.cost_weight, self.throughput_weight,
            self.risk_aversion, self.spot_preference, self.throughput,
        )).encode())
        return h.hexdigest()
