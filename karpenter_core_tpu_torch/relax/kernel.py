"""The relaxation kernel: encoded planes to rounded, materialized placements.

The port of ``karpenter_core_tpu/relax/kernel.py`` (its docstring has the
formulation).  For every relax-eligible class c the decision variable is a
mass vector x[c, i, z] >= 0 over (instance type, zone) cells summing to the
class's pod count; its support comes from the same exact predicate planes
the scan commits with, its linear cost is the policy objective's score of
the cheapest allowed capacity type over the cell's per-node pod intake.
Projected gradient on ``<cost, x> + mu/2 |x|^2`` with an exact sort-based
simplex projection, a crossover to the argmin vertex, seeded
largest-fraction rounding, an exact audit and a whole-node materializer.

``relax_core`` composes the port's kernels:

  K3 ``merge_compat``  every class merged into each template row (one
                       launch, the class its batch axis)
  K1 ``it_capacity``   each template's instance-type intersection and
                       per-node intake of every class (one launch, the
                       class its batch axis).
                       Its zone, capacity-type, offering and viability rows
                       are all true, so ``it_ok`` is the intersection and
                       ``cap_ni`` the intake where it holds (0 elsewhere);
                       every plane below reads the intake only where the
                       intersection holds, so the zeros are never read
  K14 ``relax_cost``   cell prices, support, template argmin
  K16 ``simplex_pgd``  the projected-gradient loop, on the device
  K17 ``relax_round``  crossover, ``relaxed_cost``, rounding, audit
  K18 ``relax_materialize``  cells to node slots

The masks arrive in the bool layout the encode produces and are bit-packed
here, as ``ops.solve.solve_core`` does (the production ``packed_masks``).
``use_kernels=False`` runs every kernel's plain torch twin.  The seeded tie
order is ``relax.prng.permutation(seed, S)``, uploaded once per (seed, S,
device).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from karpenter_core_tpu_torch.kernels import batch
from karpenter_core_tpu_torch.kernels import relax as kr
from karpenter_core_tpu_torch.ops import masks as mask_ops
from karpenter_core_tpu_torch.ops import solve as solve_ops
from karpenter_core_tpu_torch.relax import prng

I32 = torch.int32


class RelaxResult(NamedTuple):
    """Device outputs of one ``relax_core`` run."""

    assign: torch.Tensor  # i32[C, N] pods of class c materialized on slot n
    state: solve_ops.NodeState  # full-width slot planes (relax slots + cold tail)
    leftover: torch.Tensor  # i32[C] pods the exact repair pass must place
    iters: torch.Tensor  # i32[] projected-gradient iterations run
    converged: torch.Tensor  # bool[] final step delta <= tol
    violations: torch.Tensor  # i32[] rounded pods the exact audit rejected
    placed: torch.Tensor  # i32[] pods materialized onto slots
    spilled: torch.Tensor  # i32[] rounded pods that overflowed n_slots
    relaxed_cost: torch.Tensor  # f32[] <cost, x> of the crossed-over optimum


_PERMS: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}


def _perm(seed: int, n: int, device) -> torch.Tensor:
    key = (int(seed), int(n), torch.device(device))
    t = _PERMS.get(key)
    if t is None:
        t = torch.as_tensor(prng.permutation(seed, n).copy(), device=device)
        _PERMS[key] = t
    return t


# the Euclidean projection of each row onto {x >= 0 on support, sum x = m}
# (the reference's :94), K16's building block, in the reference's f32 order
_simplex_project = kr.simplex_project_plain


def packed_statics(class_tensors, statics_arrays, key_has_bounds, use_kernels: bool = True):
    """(ClassTensors, Statics) with the masks bit-packed, as the scan packs
    them; the Statics call the kernels, or their twins."""
    sa = solve_ops.StaticArrays(*statics_arrays)
    width = sa.valid.shape[-1]  # semantic slot count V+1, pre-packing
    sa = sa._replace(
        it=mask_ops.pack_req(sa.it),
        tmpl=mask_ops.pack_req(sa.tmpl),
        valid=mask_ops.pack_mask(sa.valid),
    )
    cls = class_tensors._replace(mask=mask_ops.pack_mask(class_tensors.mask))
    return cls, solve_ops.Statics(*sa, key_has_bounds=tuple(key_has_bounds), mask_v=width,
                                  k=solve_ops.KERNELS if use_kernels else solve_ops.PLAIN)


def class_template_planes(cls, statics: solve_ops.Statics):
    """(merged ReqTensor [C,T,...], key_ok bool[C,T], it_int bool[C,T,I],
    per_pod i32[C,T,I]) of every class against every template: one K3 and
    one K1 launch, the class their batch axis (the reference's
    ``jax.vmap(tmpl_planes)`` :178), the template and catalog planes
    repeated over the classes (the kernels take no stride-0 operand)."""
    n_classes = cls.count.shape[0]
    n_tmpl, n_zones = statics.tmpl_zone.shape
    n_it = statics.it_alloc.shape[0]
    n_ct = statics.tmpl_ct.shape[-1]
    ones = dict(dtype=torch.bool, device=statics.it_alloc.device)
    # each class row with a leading axis of 1 under the class axis (K3's
    # class operand)
    rows = mask_ops.ReqTensor(*(t[:, None] for t in (cls.mask, cls.defined, cls.negative,
                                                     cls.gt, cls.lt)))
    tmpl, valid, vocab_ints, is_custom, it, daemon, alloc = batch.repeat(
        (statics.tmpl, statics.valid, statics.vocab_ints, statics.is_custom, statics.it,
         statics.tmpl_daemon, statics.it_alloc), n_classes)
    merged, compat = statics.k.merge_compat(tmpl, rows, valid, vocab_ints, is_custom,
                                            statics.mask_v, statics.key_has_bounds)
    it_int, per_pod, _ = statics.k.it_capacity(
        torch.ones((n_classes, n_tmpl, n_it), **ones), torch.ones((n_classes, n_it), **ones),
        merged, it, vocab_ints, statics.mask_v, statics.key_has_bounds,
        torch.ones((n_classes, n_tmpl, n_zones), **ones),
        torch.ones((n_classes, n_tmpl, n_ct), **ones),
        torch.ones((n_classes, n_it, n_zones, n_ct), **ones), daemon, cls.requests, alloc)
    return merged, compat & cls.tol, it_int, per_pod


def relax_core(
    class_tensors,
    statics_arrays,
    pol_price,
    pol_risk,
    pol_throughput,
    eligible,
    weights,
    max_iters: int,
    tol: float,
    seed: int,
    *,
    n_slots: int,
    key_has_bounds,
    use_kernels: bool = True,
) -> RelaxResult:
    """Relax, round, audit, and materialize one snapshot's eligible classes.

    Inputs: the padded ``ClassTensors`` / ``StaticArrays`` the scan takes,
    the padded objective planes (f32[I, Z, CT] price/risk, f32[I]
    throughput), ``eligible`` bool[C], ``weights`` f32[3] (cost_weight,
    risk_aversion, throughput_weight), all tensors on one device; and the
    loop knobs ``max_iters``, ``tol`` and the tie-order ``seed``."""
    cls, statics = packed_statics(class_tensors, statics_arrays, key_has_bounds, use_kernels)
    k14, k16, k17, k18 = ((kr.relax_cost, kr.simplex_pgd, kr.relax_round,
                           kr.relax_materialize) if use_kernels else
                          (kr.relax_cost_plain, kr.simplex_pgd_plain, kr.relax_round_plain,
                           kr.relax_materialize_plain))
    n_it = statics.it_alloc.shape[0]
    n_zones = statics.tmpl_zone.shape[1]
    dev = statics.it_alloc.device

    counts = torch.where(eligible, cls.count, 0).to(I32)  # [C]
    merged, key_ok, it_int, per_pod = class_template_planes(cls, statics)
    planes = kr.RelaxPlanes(
        it_int=it_int, per_pod=per_pod, key_ok=key_ok, tmpl_it=statics.tmpl_it, cls_it=cls.it,
        tmpl_zone=statics.tmpl_zone, cls_zone=cls.zone, tmpl_ct=statics.tmpl_ct, cls_ct=cls.ct,
        it_avail=statics.it_avail)
    cost, support, tstar, feas, cost_max = k14(
        planes, pol_price, pol_risk, pol_throughput, weights, counts)
    x, cost_eff, iters, converged = k16(cost, support, cost_max, counts, int(max_iters),
                                        float(tol))
    n_ok, violations, relaxed_cost = k17(
        x, cost, cost_eff, support, counts, _perm(seed, n_it * n_zones, dev), tstar, planes)
    t_ct = statics.tmpl_ct[None] & cls.ct[:, None]
    out = k18(n_ok, tstar, per_pod, cls.count, merged, t_ct, feas, statics.tmpl_daemon,
              cls.requests, mask_ops.const_words("full", statics.mask_v, dev), int(n_slots),
              cls.ports.shape[-1])
    return RelaxResult(
        assign=out.assign,
        state=solve_ops.NodeState(*out.state),
        leftover=out.leftover,
        iters=iters,
        converged=converged,
        violations=violations,
        placed=out.placed,
        spilled=out.spilled,
        relaxed_cost=relaxed_cost,
    )
