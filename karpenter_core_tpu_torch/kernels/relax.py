"""K14, K16-K18: the relax family's device programs.

``relax.kernel.relax_core`` (the port of ``karpenter_core_tpu/relax/
kernel.py:109``) relaxes the eligible classes' placement into a continuous
program over (instance type, zone) cells, solves it by projected gradient,
rounds it, audits it against the exact predicate planes and materializes
whole nodes.  With S = I * Z cells a class, N node slots:

``relax_cost`` (K14, ``csrc/relax_cost.cu``; reference :192-210) prices every
cell: the objective score of each offering, with XLA's contraction in
``relax_core`` (its CPU object code: ``vfmadd213`` then ``vfmsub213``)::

    score[i,z,k] = fma(cw * price, fma(ra, risk, 1), -(tw * thr[i]))
                   (BIG where the offering is unavailable or unpriced)
    best[c,t,i,z] = min over the class-and-template-allowed k, in k order
    feas = base_ti & t_zone & (best < BIG / 2)
    unit = feas ? best / clip(per_pod, 1, 1e6) : BIG

and per (c, i, z) the minimum over templates, its first argmin ``tstar``,
``support = any_t feas & count > 0`` and the row's ``max |cost|`` over the
support (``cost_max``).

``simplex_pgd`` (K16, ``csrc/simplex_pgd.cu``; :94 ``_simplex_project`` and
the ``while_loop`` :220-251): ``cost_eff = fma(eps * scale, rank, cost)``,
``mu``, ``lr``, ``x0 = project(0)``, then while ``it < max_iters`` and the
largest per-class normalized step exceeds ``tol``::

    x = project(fma(-lr, fma(mu, x, cost_eff), x))

where ``project`` sorts the row descending, scans it in XLA's blocked order
(``fp32.cumsum_xla_plain``), counts ``ys * j > css - m``, and thresholds.
The loop runs on the device with no host read per iteration.

``relax_round`` (K17, ``csrc/relax_round.cu``; :264-318): the crossover to
the argmin vertex, ``relaxed_cost`` (XLA's CPU order for a 2-D sum,
``xla_sum_2d_plain``: windows of up to 32 x 32, each summed row-major from
+0, an axis longer than 32 padded evenly at both ends, repeated on the
window sums), floors, the seeded largest-fraction rounding (stable order (fraction desc,
rank in ``perm`` asc)) and the exact audit at ``tstar`` (the offering
``einsum`` of 0/1 values as a bitwise any).

``relax_materialize`` (K18, ``csrc/relax_materialize.cu``; :321-401): whole
nodes per cell, an int32 prefix over the C * S groups, and one slot row per
node: the merged requirement rows, the zone one-hot, the allowed capacity
types, the viable types and ``used = fma(a, requests, daemon)`` (XLA's FMA).

Each wrapper runs its plain torch twin for CPU tensors and launches its
kernel for CUDA tensors, never one in place of the other; the twins are the
CPU path and the kernels' oracle on the card.  No kernel writes a tensor it
was given.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from karpenter_core_tpu_torch.kernels import build
from karpenter_core_tpu_torch.kernels.capacity import to_i32
from karpenter_core_tpu_torch.kernels.fp32 import WINDOW, cumsum_xla_plain, fma_f32

I32 = torch.int32
F32 = torch.float32

# the reference's constants (relax/kernel.py), as float32 values
BIG = float(np.float32(1e30))
HALF_BIG = float(np.float32(5e29))
FRAC_Q = float(np.float32(2**20))
RANK_EPS = float(np.float32(3e-3))
MU0 = float(np.float32(1e-3))
FLOOR_SHAVE = float(np.float32(1.0 - 1e-6))
SCALE_FLOOR = float(np.float32(1e-20))
PP_CAP = float(np.float32(1e6))

cost_launches = 0  # K14 launches (CUDA path only)
pgd_launches = 0  # K16 launches (CUDA path only)
round_launches = 0  # K17 launches (CUDA path only)
materialize_launches = 0  # K18 launches (CUDA path only)


class RelaxPlanes(NamedTuple):
    """The per-(class, template) predicate planes K14 and K17 read."""

    it_int: torch.Tensor  # bool[C, T, I] merged requirements intersect the type
    per_pod: torch.Tensor  # i32[C, T, I] pods a fresh node of the type takes
    key_ok: torch.Tensor  # bool[C, T] key compatibility & the class tolerates t
    tmpl_it: torch.Tensor  # bool[T, I]
    cls_it: torch.Tensor  # bool[C, I]
    tmpl_zone: torch.Tensor  # bool[T, Z]
    cls_zone: torch.Tensor  # bool[C, Z]
    tmpl_ct: torch.Tensor  # bool[T, CT]
    cls_ct: torch.Tensor  # bool[C, CT]
    it_avail: torch.Tensor  # bool[I, Z, CT]


def _check_planes(p: RelaxPlanes, dev):
    c, t, i = p.it_int.shape
    z, ct = p.tmpl_zone.shape[1], p.tmpl_ct.shape[1]
    b = torch.bool
    for name, x, dt, shape in (
        ("it_int", p.it_int, b, (c, t, i)), ("per_pod", p.per_pod, I32, (c, t, i)),
        ("key_ok", p.key_ok, b, (c, t)), ("tmpl_it", p.tmpl_it, b, (t, i)),
        ("cls_it", p.cls_it, b, (c, i)), ("tmpl_zone", p.tmpl_zone, b, (t, z)),
        ("cls_zone", p.cls_zone, b, (c, z)), ("tmpl_ct", p.tmpl_ct, b, (t, ct)),
        ("cls_ct", p.cls_ct, b, (c, ct)), ("it_avail", p.it_avail, b, (i, z, ct)),
    ):
        build.check_input(name, x, dt, shape, dev)
    return c, t, i, z, ct


def _base(p: RelaxPlanes):
    """(base_ti bool[C,T,I], t_zone bool[C,T,Z], t_ct bool[C,T,CT])."""
    t_zone = p.tmpl_zone[None] & p.cls_zone[:, None]
    t_ct = p.tmpl_ct[None] & p.cls_ct[:, None]
    base = (p.tmpl_it[None] & p.cls_it[:, None] & p.it_int & (p.per_pod >= 1)
            & p.key_ok[:, :, None])
    return base, t_zone, t_ct


# -- K14 ------------------------------------------------------------------------


def relax_cost_plain(planes: RelaxPlanes, price, risk, throughput, weights, counts):
    """The plain torch version of K14: (cost f32[C,S], support bool[C,S],
    tstar i32[C,S], feas bool[C,T,I,Z], cost_max f32[C])."""
    base, t_zone, t_ct = _base(planes)
    n_c, n_t, n_i = planes.it_int.shape
    n_z = planes.tmpl_zone.shape[1]
    cw, ra, tw = weights[0], weights[1], weights[2]
    one = fma_f32(ra, risk, torch.ones((), dtype=F32, device=price.device))
    score = fma_f32(cw * price, one, -(tw * throughput[:, None, None]))
    score = torch.where(planes.it_avail & torch.isfinite(price), score, BIG)
    best = torch.full((n_c, n_t, n_i, n_z), BIG, dtype=F32, device=price.device)
    for k in range(planes.tmpl_ct.shape[1]):  # CT is tiny: unrolled, in order
        best = torch.minimum(best, torch.where(t_ct[:, :, None, None, k],
                                               score[None, None, :, :, k], BIG))
    feas = base[..., None] & t_zone[:, :, None, :] & (best < HALF_BIG)
    pp_f = torch.clamp(planes.per_pod.to(F32), 1.0, PP_CAP)
    unit = torch.where(feas, best / pp_f[..., None], BIG)
    unit_ciz, tstar = torch.min(unit, dim=1)  # the first minimum
    cost = unit_ciz.reshape(n_c, n_i * n_z)
    support = feas.any(dim=1).reshape(n_c, n_i * n_z) & (counts > 0)[:, None]
    cost_max = torch.where(support, cost.abs(), 0.0).amax(dim=1)
    return cost, support, tstar.reshape(n_c, n_i * n_z).to(I32), feas, cost_max


def relax_cost(planes: RelaxPlanes, price, risk, throughput, weights, counts):
    """K14 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors.  ``weights`` f32[3] (cw, ra, tw), ``counts`` i32[C] the
    eligible classes' counts."""
    global cost_launches
    dev = price.device
    if dev.type != "cuda":
        return relax_cost_plain(planes, price, risk, throughput, weights, counts)
    n_c, n_t, n_i, n_z, n_ct = _check_planes(planes, dev)
    for name, x, dt, shape in (
        ("price", price, F32, (n_i, n_z, n_ct)), ("risk", risk, F32, (n_i, n_z, n_ct)),
        ("throughput", throughput, F32, (n_i,)), ("weights", weights, F32, (3,)),
        ("counts", counts, I32, (n_c,)),
    ):
        build.check_input(name, x, dt, shape, dev)
    n_s = n_i * n_z
    cost = torch.empty((n_c, n_s), dtype=F32, device=dev)
    support = torch.empty((n_c, n_s), dtype=torch.bool, device=dev)
    tstar = torch.empty((n_c, n_s), dtype=I32, device=dev)
    feas = torch.empty((n_c, n_t, n_i, n_z), dtype=torch.bool, device=dev)
    cost_max = torch.zeros(n_c, dtype=F32, device=dev)
    fn = build.function("relax_cost", "kc_relax_cost",
                        [ctypes.c_int] * 5 + [ctypes.c_void_p] * 21)
    p = planes
    rc = fn(n_c, n_t, n_i, n_z, n_ct, *(x.data_ptr() for x in (
        p.it_int, p.per_pod, p.key_ok, p.tmpl_it, p.cls_it, p.tmpl_zone, p.cls_zone, p.tmpl_ct,
        p.cls_ct, p.it_avail, price, risk, throughput, weights, counts, cost, support, tstar,
        feas, cost_max)), build.stream(dev))
    build.check(rc, "relax_cost")
    cost_launches += 1
    return cost, support, tstar, feas, cost_max


# -- K16 ------------------------------------------------------------------------


def pgd_setup_plain(cost, support, cost_max, counts):
    """(m, cost_eff, mu, lr) of every class row, as ``relax_core`` forms
    them: XLA divides the rank iota by S as a multiply by the float32
    reciprocal, and contracts ``cost + (eps * scale) * rank`` to one FMA."""
    n_s = cost.shape[1]
    m = counts.to(F32)
    scale = torch.clamp(cost_max, min=SCALE_FLOOR)
    inv_s = torch.tensor(np.float32(1.0) / np.float32(max(n_s, 1)), device=cost.device)
    rank = torch.arange(n_s, dtype=F32, device=cost.device) * inv_s
    cost_eff = fma_f32((scale * RANK_EPS)[:, None], rank[None, :],
                       torch.where(support, cost, 0.0))
    mu = (scale * MU0) / torch.clamp(m, min=1.0)
    lr = 1.0 / (mu * 2.0)
    return m, cost_eff, mu, lr


def simplex_project_plain(y, support, m, jidx):
    """Euclidean projection of each row of ``y`` onto ``{x >= 0 on support,
    sum x = m}`` (the reference's ``_simplex_project`` :94)."""
    yy = torch.where(support, y, -BIG)
    ys = torch.sort(yy, dim=1, descending=True).values
    css = cumsum_xla_plain(ys)
    cond = ys * jidx[None, :] > css - m[:, None]
    rho = torch.clamp(cond.sum(dim=1, dtype=I32), 1, ys.shape[1])
    css_rho = torch.gather(css, 1, (rho - 1).long()[:, None])[:, 0]
    theta = (css_rho - m) / rho.to(F32)
    return torch.where(support, torch.clamp(y - theta[:, None], min=0.0), 0.0)


def simplex_pgd_plain(cost, support, cost_max, counts, max_iters: int, tol: float):
    """The plain torch version of K16: (x f32[C,S], cost_eff f32[C,S],
    iters i32[], converged bool[]).  Reads the step on the host each
    iteration (the kernel does not)."""
    n_s = cost.shape[1]
    m, cost_eff, mu, lr = pgd_setup_plain(cost, support, cost_max, counts)
    jidx = torch.arange(1, n_s + 1, dtype=F32, device=cost.device)
    x = simplex_project_plain(torch.zeros_like(cost), support, m, jidx)
    tol_t = torch.tensor(tol, dtype=F32, device=cost.device)
    delta = torch.tensor(float("inf"), dtype=F32, device=cost.device)
    it = 0
    norm = torch.clamp(m, min=1.0)[:, None]
    while it < max_iters and bool(delta > tol_t):
        y = fma_f32(-lr[:, None], fma_f32(mu[:, None], x, cost_eff), x)
        x1 = simplex_project_plain(y, support, m, jidx)
        delta = (torch.abs(x1 - x) / norm).amax()
        x, it = x1, it + 1
    return (x, cost_eff, torch.tensor(it, dtype=I32, device=cost.device), delta <= tol_t)


def simplex_pgd(cost, support, cost_max, counts, max_iters: int, tol: float):
    """K16 wrapper: the plain version for CPU tensors, one cooperative CUDA
    launch for CUDA tensors (one block a class row; the loop's condition is
    reduced across blocks on the device).  A row lives in shared memory, so
    S is bounded by it (about 10,000 cells), and the C blocks must all be
    resident at once; beyond either the launch raises."""
    global pgd_launches
    dev = cost.device
    if dev.type != "cuda":
        return simplex_pgd_plain(cost, support, cost_max, counts, max_iters, tol)
    n_c, n_s = cost.shape
    for name, x, dt, shape in (
        ("cost", cost, F32, (n_c, n_s)), ("support", support, torch.bool, (n_c, n_s)),
        ("cost_max", cost_max, F32, (n_c,)), ("counts", counts, I32, (n_c,)),
    ):
        build.check_input(name, x, dt, shape, dev)
    x = torch.empty((n_c, n_s), dtype=F32, device=dev)
    cost_eff = torch.empty((n_c, n_s), dtype=F32, device=dev)
    out = torch.zeros(2, dtype=I32, device=dev)  # iters, converged
    # per-block step maxima, one slot per iteration, and the barrier words
    scratch = torch.zeros(n_c * (max(int(max_iters), 0) + 1) + 2, dtype=I32, device=dev)
    fn = build.function("simplex_pgd", "kc_simplex_pgd",
                        [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 9)
    rc = fn(n_c, n_s, int(max_iters), float(np.float32(tol)), cost.data_ptr(),
            support.data_ptr(), cost_max.data_ptr(), counts.data_ptr(), x.data_ptr(),
            cost_eff.data_ptr(), out.data_ptr(), scratch.data_ptr(), build.stream(dev))
    build.check(rc, "simplex_pgd")
    pgd_launches += 1
    return x, cost_eff, out[0], out[1].to(torch.bool)


# -- K17 ------------------------------------------------------------------------


def _window_plan(n: int):
    """(window, windows, leading pad) of one axis in XLA's tree reduction:
    an axis of at most 32 is one window; a longer one is cut into windows of
    32, padded evenly at both ends."""
    if n <= WINDOW:
        return n, 1, 0
    count = -(-n // WINDOW)
    return WINDOW, count, (count * WINDOW - n) // 2


def xla_sum_2d_plain(v: torch.Tensor) -> torch.Tensor:
    """The float32 sum of f32[R, S] in XLA's CPU order inside ``relax_core``:
    while an axis is longer than 32, each window (32 along a long axis, the
    whole of a short one) is summed row-major from +0; then the rest,
    row-major from +0.  At S <= 8 columns too the fusion is one scalar
    accumulator, row-major (the object code of ``jit_relax_core`` at S = 3
    and 6); a standalone ``jnp.sum`` of the same expression vectorises over
    the rows instead, but ``relax_core`` does not."""
    while v.shape[0] > WINDOW or v.shape[1] > WINDOW:
        (wr, nr, lr), (wc, nc, lc) = _window_plan(v.shape[0]), _window_plan(v.shape[1])
        vp = torch.zeros((nr * wr, nc * wc), dtype=F32, device=v.device)
        vp[lr:lr + v.shape[0], lc:lc + v.shape[1]] = v
        blocks = vp.reshape(nr, wr, nc, wc).permute(0, 2, 1, 3).reshape(nr, nc, wr * wc)
        acc = torch.zeros((nr, nc), dtype=F32, device=v.device)
        for k in range(wr * wc):
            acc = acc + blocks[..., k]
        v = acc
    acc = torch.zeros((), dtype=F32, device=v.device)
    for x in v.reshape(-1):
        acc = acc + x
    return acc


def relax_round_plain(x, cost, cost_eff, support, counts, perm, tstar, planes: RelaxPlanes):
    """The plain torch version of K17: (n_ok i32[C,S], violations i32[],
    relaxed_cost f32[])."""
    n_c, n_s = x.shape
    dev = x.device
    # crossover: each class with support moves to its argmin-cost cell
    jstar = torch.argmin(torch.where(support, cost_eff, BIG), dim=1)
    cols = torch.arange(n_s, device=dev)
    onehot = (cols[None, :] == jstar[:, None]).to(F32)
    m = counts.to(F32)
    x = torch.where(support.any(dim=1)[:, None], m[:, None] * onehot * support.to(F32), x)
    relaxed_cost = xla_sum_2d_plain(torch.where(support, cost * x, 0.0))
    # floors, then the deficit one pod a cell in (fraction desc, seeded rank asc)
    x_r = x * FLOOR_SHAVE
    n0f = torch.floor(x_r)
    n0 = to_i32(n0f)
    deficit = torch.clamp(counts - n0.sum(dim=1, dtype=I32), min=0)
    fq = torch.where(support, to_i32(torch.floor((x_r - n0f) * FRAC_Q)), -1)
    perm_l = perm.long()
    ordb = torch.sort(-fq[:, perm_l], dim=1, stable=True).indices
    cells_sorted = perm_l[ordb]
    take = (cols[None, :] < deficit[:, None]).to(I32)
    add = torch.zeros((n_c, n_s), dtype=I32, device=dev).scatter_add(1, cells_sorted, take)
    n_round = (n0 + add) * support.to(I32)
    # the exact audit, re-gathered at the chosen template
    base, t_zone, t_ct = _base(planes)
    offer = (t_ct[:, :, None, None, :] & planes.it_avail[None, None]).any(dim=-1)
    audit = base[..., None] & t_zone[:, :, None, :] & offer  # [C,T,I,Z]
    audit_at = torch.gather(audit.reshape(n_c, audit.shape[1], n_s), 1,
                            tstar.long()[:, None, :])[:, 0]
    viol = (n_round > 0) & ~audit_at
    violations = torch.where(viol, n_round, 0).sum(dtype=I32)
    n_ok = torch.where(viol, 0, n_round)
    return n_ok, violations, relaxed_cost


def relax_round(x, cost, cost_eff, support, counts, perm, tstar, planes: RelaxPlanes):
    """K17 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors.  ``perm`` i32[S] is ``relax.prng.permutation(seed, S)``."""
    global round_launches
    dev = x.device
    if dev.type != "cuda":
        return relax_round_plain(x, cost, cost_eff, support, counts, perm, tstar, planes)
    n_c, n_t, n_i, n_z, n_ct = _check_planes(planes, dev)
    n_s = n_i * n_z
    for name, t, dt, shape in (
        ("x", x, F32, (n_c, n_s)), ("cost", cost, F32, (n_c, n_s)),
        ("cost_eff", cost_eff, F32, (n_c, n_s)), ("support", support, torch.bool, (n_c, n_s)),
        ("counts", counts, I32, (n_c,)), ("perm", perm, I32, (n_s,)),
        ("tstar", tstar, I32, (n_c, n_s)),
    ):
        build.check_input(name, t, dt, shape, dev)
    n_ok = torch.empty((n_c, n_s), dtype=I32, device=dev)
    violations = torch.zeros((), dtype=I32, device=dev)
    relaxed_cost = torch.empty((), dtype=F32, device=dev)
    products = torch.empty((n_c, n_s), dtype=F32, device=dev)  # where(support, cost * x, 0)
    fn = build.function("relax_round", "kc_relax_round",
                        [ctypes.c_int] * 5 + [ctypes.c_void_p] * 22)
    p = planes
    rc = fn(n_c, n_t, n_i, n_z, n_ct, *(t.data_ptr() for t in (
        x, cost, cost_eff, support, counts, perm, tstar, p.it_int, p.per_pod, p.key_ok,
        p.tmpl_it, p.cls_it, p.tmpl_zone, p.cls_zone, p.tmpl_ct, p.cls_ct, p.it_avail, n_ok,
        violations, relaxed_cost, products)), build.stream(dev))
    build.check(rc, "relax_round")
    round_launches += 1
    return n_ok, violations, relaxed_cost


# -- K18 ------------------------------------------------------------------------


class Materialized(NamedTuple):
    assign: torch.Tensor  # i32[C, N]
    state: tuple  # the NodeState fields, in order (used .. open_, n_next)
    leftover: torch.Tensor  # i32[C]
    placed: torch.Tensor  # i32[]
    spilled: torch.Tensor  # i32[]


def relax_materialize_plain(n_ok, tstar, per_pod, count, merged, t_ct, feas, tmpl_daemon,
                            requests, kmask0, n_slots: int, n_ports: int) -> Materialized:
    """The plain torch version of K18.  ``merged`` is the per-(class,
    template) requirement tensor (mask i32[C,T,K,W], defined/negative
    bool[C,T,K], gt/lt f32[C,T,K]); ``t_ct`` bool[C,T,CT]; ``kmask0``
    i32[W] the all-slots mask of a closed row."""
    n_c, n_s = n_ok.shape
    n_i = per_pod.shape[2]
    n_z = n_s // n_i
    n_total = n_c * n_s
    dev = n_ok.device
    i_of = torch.arange(n_s, device=dev) // n_z
    pp_cell = per_pod[torch.arange(n_c, device=dev)[:, None], tstar.long(), i_of[None, :]]
    ppg = torch.clamp(pp_cell.reshape(n_total), 1, 10**6)
    ncell = torch.div(n_ok.reshape(n_total), ppg, rounding_mode="floor") * ppg
    nodes_g = torch.div(ncell, ppg, rounding_mode="floor")
    cum = torch.cumsum(nodes_g, dim=0, dtype=I32)
    offs = cum - nodes_g
    total_nodes = nodes_g.sum(dtype=I32)
    used_slots = torch.clamp(total_nodes, max=n_slots).to(I32)
    avail_nodes = torch.minimum(torch.clamp(n_slots - offs, min=0), nodes_g)
    placed_g = torch.minimum(ncell, avail_nodes * ppg)
    placed_c = placed_g.reshape(n_c, n_s).sum(dim=1, dtype=I32)
    leftover = torch.clamp(count - placed_c, min=0).to(I32)
    spilled = ncell.sum(dtype=I32) - placed_g.sum(dtype=I32)

    slots = torch.arange(n_slots, dtype=I32, device=dev)
    gid = torch.searchsorted(cum, slots, right=True).to(I32)
    sel = slots < used_slots
    gidc = torch.clamp(gid, 0, n_total - 1).long()
    rank = slots - offs[gidc]
    a = torch.where(sel, torch.minimum(torch.clamp(ncell[gidc] - rank * ppg[gidc], min=0),
                                       ppg[gidc]), 0).to(I32)
    c_s = gidc // n_s
    z_s = (gidc - c_s * n_s) % n_z
    t_s = tstar.reshape(n_total)[gidc].long()
    km, kd, kn, kg, kl = (getattr(merged, f)[c_s, t_s] for f in merged._fields)
    zone_hot = torch.arange(n_z, device=dev)[None, :] == z_s[:, None]
    ct_row = t_ct[c_s, t_s]
    feas_z = feas[c_s, t_s].gather(2, z_s[:, None, None].expand(-1, n_i, 1))[:, :, 0]
    pp_row = per_pod[c_s, t_s]
    viable_row = feas_z & (pp_row >= a[:, None])
    used_row = fma_f32(a.to(F32)[:, None], requests[c_s], tmpl_daemon[t_s])
    s1, s2 = sel[:, None], sel[:, None, None]
    state = (
        torch.where(s1, used_row, 0.0),
        torch.where(s2, km, kmask0),
        torch.where(s1, kd, False),
        torch.where(s1, kn, False),
        torch.where(s1, kg, -np.inf).to(F32),
        torch.where(s1, kl, np.inf).to(F32),
        torch.where(s1, zone_hot, True),
        torch.where(s1, ct_row, True),
        torch.where(s1, viable_row, True),
        torch.zeros((n_slots, n_ports), dtype=torch.bool, device=dev),
        a,
        torch.where(sel, t_s, 0).to(I32),
        sel & (a > 0),
        used_slots,
    )
    assign = torch.where((torch.arange(n_c, device=dev)[:, None] == c_s[None, :]) & sel[None, :],
                         a[None, :], 0).to(I32)
    return Materialized(assign, state, leftover, placed_g.sum(dtype=I32), spilled.to(I32))


def relax_materialize(n_ok, tstar, per_pod, count, merged, t_ct, feas, tmpl_daemon, requests,
                      kmask0, n_slots: int, n_ports: int) -> Materialized:
    """K18 wrapper: the plain version for CPU tensors, the CUDA kernel (two
    launches) for CUDA tensors."""
    global materialize_launches
    dev = n_ok.device
    if dev.type != "cuda":
        return relax_materialize_plain(n_ok, tstar, per_pod, count, merged, t_ct, feas,
                                       tmpl_daemon, requests, kmask0, n_slots, n_ports)
    n_c, n_s = n_ok.shape
    _, n_t, n_i = per_pod.shape
    n_z = n_s // n_i
    n_keys, n_words = merged.mask.shape[2], merged.mask.shape[3]
    n_ct = t_ct.shape[2]
    n_res = tmpl_daemon.shape[1]
    b = torch.bool
    for name, t, dt, shape in (
        ("n_ok", n_ok, I32, (n_c, n_s)), ("tstar", tstar, I32, (n_c, n_s)),
        ("per_pod", per_pod, I32, (n_c, n_t, n_i)), ("count", count, I32, (n_c,)),
        ("merged.mask", merged.mask, I32, (n_c, n_t, n_keys, n_words)),
        ("merged.defined", merged.defined, b, (n_c, n_t, n_keys)),
        ("merged.negative", merged.negative, b, (n_c, n_t, n_keys)),
        ("merged.gt", merged.gt, F32, (n_c, n_t, n_keys)),
        ("merged.lt", merged.lt, F32, (n_c, n_t, n_keys)),
        ("t_ct", t_ct, b, (n_c, n_t, n_ct)), ("feas", feas, b, (n_c, n_t, n_i, n_z)),
        ("tmpl_daemon", tmpl_daemon, F32, (n_t, n_res)), ("requests", requests, F32, (n_c, n_res)),
        ("kmask0", kmask0, I32, (n_words,)),
    ):
        build.check_input(name, t, dt, shape, dev)
    if n_c * n_s >= 2**31:
        raise ValueError("relax_materialize: more than 2**31 cell groups")
    n = n_slots
    assign = torch.empty((n_c, n), dtype=I32, device=dev)
    used = torch.empty((n, n_res), dtype=F32, device=dev)
    kmask = torch.empty((n, n_keys, n_words), dtype=I32, device=dev)
    kdef = torch.empty((n, n_keys), dtype=b, device=dev)
    kneg = torch.empty((n, n_keys), dtype=b, device=dev)
    kgt = torch.empty((n, n_keys), dtype=F32, device=dev)
    klt = torch.empty((n, n_keys), dtype=F32, device=dev)
    zone = torch.empty((n, n_z), dtype=b, device=dev)
    ct = torch.empty((n, n_ct), dtype=b, device=dev)
    viable = torch.empty((n, n_i), dtype=b, device=dev)
    ports = torch.zeros((n, n_ports), dtype=b, device=dev)
    pod_count = torch.empty(n, dtype=I32, device=dev)
    tmpl_id = torch.empty(n, dtype=I32, device=dev)
    open_ = torch.empty(n, dtype=b, device=dev)
    leftover = torch.empty(n_c, dtype=I32, device=dev)
    scalars = torch.empty(4, dtype=I32, device=dev)  # n_next, placed, spilled, nodes
    # per group: cum, ncell, ppg; per class: placed
    scratch = torch.empty(3 * n_c * n_s + n_c, dtype=I32, device=dev)
    fn = build.function("relax_materialize", "kc_relax_materialize",
                        [ctypes.c_int] * 9 + [ctypes.c_void_p] * 31)
    rc = fn(n_c, n_t, n_i, n_z, n_ct, n_keys, n_words, n_res, n, *(t.data_ptr() for t in (
        n_ok, tstar, per_pod, count, *merged, t_ct, feas, tmpl_daemon, requests, kmask0,
        assign, used, kmask, kdef, kneg, kgt, klt, zone, ct, viable, pod_count, tmpl_id, open_,
        leftover, scalars, scratch)), build.stream(dev))
    build.check(rc, "relax_materialize")
    materialize_launches += 1
    state = (used, kmask, kdef, kneg, kgt, klt, zone, ct, viable, ports, pod_count, tmpl_id,
             open_, scalars[0])
    return Materialized(assign, state, leftover, scalars[1], scalars[2])
