"""Objective planes: the dense per-(instance type, zone, capacity type)
economics the offering-selection kernel (K13) scores over.  A copy of
``karpenter_core_tpu/policy/planes.py``.

Three planes ride every encoded snapshot (models.snapshot.EncodedSnapshot
``pol_price`` / ``pol_risk`` / ``pol_throughput``):

  price        f32[I, Z, CT] — the offering price sheet, +inf where no
               offering exists (mirrors ``it_price``; kept as its own plane
               so the ``policy`` digest group versions the price sheet
               independently of the feasibility planes)
  risk         f32[I, Z, CT] — interruption-risk prior in [0, 1].  Seeded
               from two places: per-offering ``interruption_rate`` (the
               cloud's own spot-reclaim signal, FakeCloudProvider.
               set_interruption_rate in tests) and the chaos plane's
               first-class capacity knobs — an instance type with pending
               ``capacity_errors`` is observably failing creates right now,
               which is the strongest interruption prior there is
  throughput   f32[I] — heterogeneity weight per instance type
               (PolicyConfig.throughput; Gavel's throughput matrices reduce
               to this per-type vector when the pod side is a single job
               class per solve)

``policy_input_digest`` digests the same inputs without encoding anything;
the incremental session folds it into its supply digest, so a price or risk
update escalates the next solve to full.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, NamedTuple, Optional

import numpy as np

# a type that is actively failing creates with InsufficientCapacityError is
# treated as (nearly) certain to interrupt — the chaos capacity knob is the
# failure-side twin of the spot-reclaim prior
CAPACITY_ERROR_RISK = 0.9


class ObjectivePlanes(NamedTuple):
    price: np.ndarray  # f32[I, Z, CT] (+inf where no offering)
    risk: np.ndarray  # f32[I, Z, CT] interruption-risk prior in [0, 1]
    throughput: np.ndarray  # f32[I]


def build_planes(
    it_names: List[str],
    zones: List[str],
    capacity_types: List[str],
    it_by_name: Dict[str, object],
    config=None,
    provider=None,
) -> ObjectivePlanes:
    """Build the objective planes on the snapshot's axes.

    ``it_by_name`` maps instance-type name -> cloudprovider.InstanceType;
    ``provider`` (optional) contributes the chaos-side capacity-error prior
    (any object with a ``capacity_errors`` dict — FakeCloudProvider's
    first-class failure knob)."""
    i_n, z_n, ct_n = len(it_names), len(zones), len(capacity_types)
    price = np.full((i_n, z_n, ct_n), np.inf, dtype=np.float32)
    risk = np.zeros((i_n, z_n, ct_n), dtype=np.float32)
    throughput = np.zeros(i_n, dtype=np.float32)
    zone_idx = {z: i for i, z in enumerate(zones)}
    ct_idx = {c: i for i, c in enumerate(capacity_types)}
    capacity_errors = getattr(provider, "capacity_errors", None) or {}
    for i, name in enumerate(it_names):
        it = it_by_name.get(name)
        if it is None:
            continue
        if config is not None:
            throughput[i] = config.throughput_of(name)
        pending_ice = capacity_errors.get(name, 0) > 0
        for off in it.offerings:
            if not off.available:
                continue
            z = zone_idx.get(off.zone)
            c = ct_idx.get(off.capacity_type)
            if z is None or c is None:
                continue
            price[i, z, c] = off.price
            rate = float(getattr(off, "interruption_rate", 0.0) or 0.0)
            if pending_ice:
                rate = max(rate, CAPACITY_ERROR_RISK)
            risk[i, z, c] = min(max(rate, 0.0), 1.0)
    return ObjectivePlanes(price=price, risk=risk, throughput=throughput)


def attach_planes(snapshot, it_by_name, config=None, provider=None) -> None:
    """Stamp the objective planes onto an encoded snapshot (the ``policy``
    digest group models.store versions).  Cheap — one pass over the catalog's
    offerings — so it runs on every encode whether or not the objective is
    enabled: the planes must exist for the digest to detect a price-sheet
    change even while policy is off."""
    planes = build_planes(
        snapshot.it_names, snapshot.zones, snapshot.capacity_types,
        it_by_name, config=config, provider=provider,
    )
    snapshot.pol_price = planes.price
    snapshot.pol_risk = planes.risk
    snapshot.pol_throughput = planes.throughput


def planes_of(snapshot) -> Optional[ObjectivePlanes]:
    price = getattr(snapshot, "pol_price", None)
    if price is None:
        return None
    return ObjectivePlanes(
        price=price,
        risk=snapshot.pol_risk,
        throughput=snapshot.pol_throughput,
    )


def policy_input_digest(instance_types, config=None, provider=None) -> str:
    """Content digest of the policy-relevant solve INPUTS — offering prices,
    interruption-rate priors, the config knobs, and the provider's live
    capacity-error state — computed without encoding anything.  The
    incremental session appends this to its supply digest: a ``set_price``
    on the provider (or a risk/weight change, or a type starting/stopping
    to ICE) flips it and the fallback policy escalates to a full solve with
    reason ``supply-changed`` (the regression tests/test_policy.py pins).

    ``instance_types`` is the solver's provisioner-name -> [InstanceType]
    map (or any iterable of lists).  ``provider`` contributes the
    capacity-error prior the risk planes fold in (``build_planes``): only
    the BINARY pending-or-not set per type is hashed — exactly what the
    plane encodes — so an ICE count ticking 3→2 does not escalate, while
    the 0↔pending transitions (risk appearing/clearing) do."""
    h = hashlib.sha256()
    capacity_errors = getattr(provider, "capacity_errors", None) or {}
    h.update(repr(sorted(
        name for name, count in capacity_errors.items() if count > 0
    )).encode())
    if isinstance(instance_types, dict):
        groups = [instance_types[k] for k in sorted(instance_types)]
    else:
        groups = [list(instance_types)]
    for its in groups:
        for it in its:
            h.update(it.name.encode())
            h.update(repr(sorted(
                (
                    o.zone, o.capacity_type, o.available, o.price,
                    float(getattr(o, "interruption_rate", 0.0) or 0.0),
                )
                for o in it.offerings
            )).encode())
        h.update(b"\x1e")
    if config is not None:
        h.update(config.digest().encode())
    return h.hexdigest()
