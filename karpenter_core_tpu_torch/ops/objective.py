"""The policy objective: score and select one offering per new node.

The port of ``karpenter_core_tpu/ops/objective.py``.  It runs after the
solve: the final state's per-slot planes (viable instance types, surviving
zone and capacity-type masks) bound each new node's offering cells, and K13
(``kernels/objective.py``, ``csrc/select_offerings.cu``) scores every cell
and takes each slot's argmin in one pass.

Objective of one (instance type i, zone z, capacity type ct) cell:

    expected[i,z,ct] = price[i,z,ct] * (1 + risk_aversion * risk[i,z,ct])
    score[i,z,ct]    = cost_weight * expected[i,z,ct]
                       - throughput_weight * throughput[i]

Exact score ties prefer spot when ``spot_preference`` is set, then the
first cell in (instance type, zone, capacity type) order.  ``select_for_state``
is the host entry: weights from a PolicyConfig, numpy selections out.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from karpenter_core_tpu_torch.apis import labels as labels_api
from karpenter_core_tpu_torch.kernels import objective as k13

ObjectiveWeights = k13.Weights


class ObjectiveSelection(NamedTuple):
    """Per-new-node-slot argmin selection (leading dim N)."""

    sel_it: object  # i32[N] selected instance-type index
    sel_zone: object  # i32[N]
    sel_ct: object  # i32[N]
    price: object  # f32[N] raw offering price at the selection
    expected: object  # f32[N] risk-weighted expected cost
    active: object  # bool[N] open, pod-carrying, selectable slots
    fleet_cost: object  # f32[] sum of selected prices over active slots
    fleet_expected: object  # f32[] risk-weighted fleet cost


def weights_of(config) -> ObjectiveWeights:
    """The config's knobs as float32 values (the reference's
    ``jnp.float32``)."""
    return ObjectiveWeights(
        cost_weight=float(np.float32(config.cost_weight)),
        throughput_weight=float(np.float32(config.throughput_weight)),
        risk_aversion=float(np.float32(config.risk_aversion)),
        spot_preference=bool(config.spot_preference),
    )


def cell_scores(price, risk, throughput, weights: ObjectiveWeights):
    """(expected f32[I,Z,CT], score f32[I,Z,CT]) of every offering cell."""
    return k13.cell_scores_plain(price, risk, throughput, weights)


def select_offerings(viable, zone, ct, open_, pod_count, price, risk, throughput, is_spot,
                     weights: ObjectiveWeights, use_kernels: bool = True) -> ObjectiveSelection:
    """One slot's selection per row of ``viable`` (bool[N, I]), ``zone``
    (bool[N, Z]) and ``ct`` (bool[N, CT]) over the f32[I, Z, CT] price and
    risk planes (+inf price: no offering).  ``use_kernels=False`` runs the
    plain twin on any device."""
    fn = k13.select_offerings if use_kernels else k13.select_offerings_plain
    return ObjectiveSelection(*fn(viable, zone, ct, open_, pod_count, price, risk, throughput,
                                  is_spot, weights))


def select_for_state(state, planes, config, capacity_types,
                     use_kernels: bool = True) -> ObjectiveSelection:
    """Host entry: the selection over a solve's final NodeState with the
    snapshot's objective planes (``policy.planes.ObjectivePlanes``, on the
    state's instance-type axis: the port pads no catalog), fetched to numpy.
    ``capacity_types`` is the snapshot's CT axis (names); spot is the
    well-known label value."""
    dev = state.viable.device
    is_spot = torch.as_tensor(np.array(
        [name == labels_api.CAPACITY_TYPE_SPOT for name in capacity_types], dtype=bool)).to(dev)
    selection = select_offerings(
        state.viable, state.zone, state.ct, state.open_, state.pod_count,
        *(torch.as_tensor(np.asarray(a, dtype=np.float32)).to(dev) for a in planes),
        is_spot, weights_of(config), use_kernels=use_kernels,
    )
    return ObjectiveSelection(*(t.cpu().numpy() for t in selection))


__all__ = ["ObjectiveSelection", "ObjectiveWeights", "cell_scores", "select_for_state",
           "select_offerings", "weights_of"]
