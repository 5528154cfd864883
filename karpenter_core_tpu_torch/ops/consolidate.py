"""The consolidation search's prefix sweep, in torch.

The port of ``karpenter_core_tpu/ops/consolidate.py``.  Multi-node
consolidation asks for the largest prefix of the disruption-sorted
candidates whose nodes can all go: their pods re-injected, the simulation
must place every pod with at most one new node.  The sweep evaluates many
prefix sizes k in one pass, each a lane:

  K8 (``kernels.consolidate.sweep_lanes``)  every lane's open mask (the
      first k candidates closed) and class counts (their pods displaced);
  ``ops.solve.solve_core_batched``  the lanes' simulations, the lane the
      scan's batch axis (the reference's ``jax.vmap(one_prefix)``): every
      launch of K1-K7 and every host read of a skip covers a chunk of
      lanes.  The lanes share the prepared planes, repeated over the chunk
      (the kernels take no stride-0 operand); each has its own class counts
      and ``ExistingState.open_``.  Chunks are sized to the card's free
      memory (``ops.chunks``); lanes are independent, so no output depends
      on the chunk;
  K9 (``kernels.consolidate.lane_finish``)  every lane's failures,
      uninitialized-node use and replacement price (``node_prices``) over
      the stacked lane outputs.

    prep = prepare_sweep(snapshot, ex_state, ex_static, rank, ex_cls_count, device)
    out = sweep(prep, prefix_sizes)             # SweepOutputs, leading dim S

``sweep`` is ``run_lanes`` (K8 and the lane solves) then ``finish_lanes``
(K9).  ``run_sweep`` is the reference's production entry (prepare, snap the
features, sweep) without its mesh branch (``_lane_sweep_fn``, ROADMAP 1.2);
the search prepares once per command and sweeps each pass.  The crossed
what-if grid (``parallel.mesh.crossed_sweep``) runs its cells through the
same chunk loop (``ops.chunks.solve_cells``).

``prepare_sweep`` pads E and C (``ops.solve.pad_planes``): the padded rows of
``rank`` hold ``1 << 30``, so they never enter a subset, and the padded
existing nodes are closed and hold no assignment, so they never make a lane
use an uninitialized node.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from karpenter_core_tpu_torch import carry
from karpenter_core_tpu_torch import device as device_mod
from karpenter_core_tpu_torch.kernels import consolidate as k89
from karpenter_core_tpu_torch.ops import chunks
from karpenter_core_tpu_torch.ops import masks as mask_ops
from karpenter_core_tpu_torch.ops import solve as solve_ops
from karpenter_core_tpu_torch.utils import compilecache

NOT_CANDIDATE = 1 << 30  # rank of a node outside the candidate list
# New-node slots per lane, the reference's run_sweep default: a valid lane
# opens at most one new node, so a lane that runs out of 16 slots has failed
# pods and is invalid anyway; nothing retries it.
SWEEP_SLOTS = 16


class SweepOutputs(NamedTuple):
    """Per-lane (prefix size) results; leading dim S."""

    n_new: torch.Tensor  # i32[S] new nodes the simulation opened
    failed: torch.Tensor  # i32[S] pods that failed to schedule
    used_uninitialized: torch.Tensor  # bool[S] relied on an uninitialized node
    new_viable: torch.Tensor  # bool[S, M, I] replacement instance viability
    new_zone: torch.Tensor  # bool[S, M, Z]
    new_ct: torch.Tensor  # bool[S, M, CT]
    new_used: torch.Tensor  # f32[S, M, R]
    new_tmpl: torch.Tensor  # i32[S, M]
    new_cost: torch.Tensor  # f32[S] sum of the opened slots' cheapest prices


class SweepPrep(NamedTuple):
    """One consolidation snapshot's sweep inputs, padded and on the device;
    every pass of the search reuses them."""

    cls: solve_ops.ClassTensors  # counts: the pending (base) pods only
    statics_arrays: solve_ops.StaticArrays
    key_has_bounds: tuple
    ex_state: solve_ops.ExistingState  # kmask bit-packed
    ex_static: solve_ops.ExistingStatic
    candidate_rank: torch.Tensor  # i32[E]: disruption order, NOT_CANDIDATE otherwise
    ex_cls_count: torch.Tensor  # i32[C, E]: candidate pods per class per node
    it_price: torch.Tensor  # f32[I, Z, CT]
    n_passes: int
    features: solve_ops.SnapshotFeatures

    def shared(self) -> tuple:
        """The planes every lane repeats (``ops.chunks.solve_cells``)."""
        return self.cls, self.statics_arrays, self.ex_state, self.ex_static


def prepare_sweep(snapshot, ex_state, ex_static, candidate_rank: np.ndarray,
                  ex_cls_count: np.ndarray, device=None) -> SweepPrep:
    """The sweep's inputs from an encoded snapshot (its ``cls_count`` the
    base counts) and the numpy existing-node planes of
    ``CudaSolver.encode_existing`` (``device=None``: CUDA); the features
    snapped (``utils.compilecache.snap_features``) as the reference's
    ``run_sweep`` snaps them."""
    dev = device_mod.resolve(device)
    features = compilecache.snap_features(solve_ops.features_with_existing(snapshot, ex_static))
    cls, statics_arrays, key_has_bounds = solve_ops.prepare_host(snapshot)
    cls, statics_arrays, key_has_bounds, ex_state, ex_static = solve_ops.pad_planes(
        cls, statics_arrays, key_has_bounds, ex_state, ex_static,
    )
    n_cls, n_ex = cls.count.shape[0], ex_state.open_.shape[0]
    rank = solve_ops._pad_axis(np.asarray(candidate_rank, dtype=np.int32), 0, n_ex,
                               NOT_CANDIDATE)
    counts = np.asarray(ex_cls_count, dtype=np.int32)
    counts = solve_ops._pad_axis(solve_ops._pad_axis(counts, 1, n_ex, 0), 0, n_cls, 0)
    cls_t, sa_t, khb = carry.tensors_from_numpy(cls, statics_arrays, key_has_bounds, dev)
    ex_state, ex_static = carry.existing_from_numpy(ex_state, ex_static, dev)
    ex_state = ex_state._replace(kmask=mask_ops.pack_mask(ex_state.kmask))
    return SweepPrep(
        cls=cls_t, statics_arrays=sa_t, key_has_bounds=khb, ex_state=ex_state,
        ex_static=ex_static, candidate_rank=carry.to_tensor(rank, dev),
        ex_cls_count=carry.to_tensor(counts, dev),
        it_price=carry.to_tensor(snapshot.it_price, dev), n_passes=snapshot.scan_passes,
        features=features,
    )


class LaneStack(NamedTuple):
    """The lane solves' outputs that the sweep keeps, stacked (leading dim S)."""

    n_next: torch.Tensor  # i32[S]
    viable: torch.Tensor  # bool[S, M, I]
    zone: torch.Tensor  # bool[S, M, Z]
    ct: torch.Tensor  # bool[S, M, CT]
    used: torch.Tensor  # f32[S, M, R]
    tmpl_id: torch.Tensor  # i32[S, M]
    open_: torch.Tensor  # bool[S, M]
    pod_count: torch.Tensor  # i32[S, M]
    failed: torch.Tensor  # i32[S, C]
    assign_existing: torch.Tensor  # i32[S, C, E]


def lane_planes(out) -> tuple:
    """The ``LaneStack`` fields of a (batched or solo) scan's outputs."""
    st = out.state
    return (st.n_next, st.viable, st.zone, st.ct, st.used, st.tmpl_id, st.open_, st.pod_count,
            out.failed, out.assign_existing)


def run_lanes(prep: SweepPrep, prefix_sizes, use_kernels: bool = True,
              n_slots: int = SWEEP_SLOTS) -> LaneStack:
    """K8's set-up of every lane, then the lanes' simulations over
    ``n_slots`` new-node slots through the batched scan, a chunk of lanes at
    a time (``ops.chunks.solve_cells``).  Each lane's outputs equal its solo
    ``solve_core``."""
    lanes = k89.sweep_lanes if use_kernels else k89.sweep_lanes_plain
    dev = prep.it_price.device
    sizes = torch.as_tensor(np.asarray(prefix_sizes, dtype=np.int32)).to(dev)
    lane_open, lane_count = lanes(prep.candidate_rank, prep.ex_state.open_, prep.cls.count,
                                  prep.ex_cls_count, sizes)
    return LaneStack(*chunks.solve_cells(
        prep.shared(), prep.key_has_bounds, sizes.shape[0], n_slots, lane_planes,
        count=lane_count, open_=lane_open, n_passes=prep.n_passes, features=prep.features,
        use_kernels=use_kernels))


def finish_lanes(prep: SweepPrep, stack: LaneStack, use_kernels: bool = True) -> SweepOutputs:
    """K9 over the stacked lane outputs: each lane's failures,
    uninitialized-node use and replacement cost."""
    finish = k89.lane_finish if use_kernels else k89.lane_finish_plain
    _, cost, failed, uninit = finish(stack.viable, stack.zone, stack.ct, stack.open_,
                                     stack.pod_count, stack.failed, stack.assign_existing,
                                     prep.ex_static.init, prep.it_price)
    return SweepOutputs(
        n_new=stack.n_next, failed=failed, used_uninitialized=uninit, new_viable=stack.viable,
        new_zone=stack.zone, new_ct=stack.ct, new_used=stack.used, new_tmpl=stack.tmpl_id,
        new_cost=cost,
    )


def sweep(prep: SweepPrep, prefix_sizes, use_kernels: bool = True,
          n_slots: int = SWEEP_SLOTS) -> SweepOutputs:
    """Simulate closing the first k candidates for every k in
    ``prefix_sizes``; device-resident outputs.  ``use_kernels=False`` runs
    every kernel's plain twin (the oracle on the card)."""
    stack = run_lanes(prep, prefix_sizes, use_kernels=use_kernels, n_slots=n_slots)
    return finish_lanes(prep, stack, use_kernels=use_kernels)


def run_sweep(snapshot, ex_state, ex_static, candidate_rank: np.ndarray,
              ex_cls_count: np.ndarray, prefix_sizes, n_slots: int = SWEEP_SLOTS,
              device=None) -> SweepOutputs:
    """The production sweep entry (the reference's ``run_sweep`` :156
    without its mesh branch): prepare the snapshot's planes (features
    snapped), then sweep ``prefix_sizes`` over ``n_slots`` slots a lane.
    Device-resident outputs (``device=None``: CUDA)."""
    prep = prepare_sweep(snapshot, ex_state, ex_static, candidate_rank, ex_cls_count, device)
    return sweep(prep, prefix_sizes, n_slots=n_slots)
