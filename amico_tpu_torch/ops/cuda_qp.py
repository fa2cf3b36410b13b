"""Per-tile non-negative QP solves: the CUDA kernels, their plain PyTorch
twins, and the wrappers that pick between them by the tensors' device.

Counterpart of ``amico_tpu.ops.pallas_qp``, whose two kernels share one
solver (``_build_as_solve``); the twins here share :func:`_as_solve` the
same way.

**K2, the generic tile QP** (``nneg_qp_tiles_pallas``):
:func:`nneg_qp_tiles` solves, per voxel,
``min 1/2 x'Gx - b'x + lam1 sum(x) + lam2/2 |x|^2, x >= 0`` with G shared
by the tile: optional FISTA warm start, Lawson-Hanson rounds, and the
per-tile ``converge`` continuation.  CUDA tensors launch
``csrc/nneg_qp.cu``, CPU tensors take :func:`nneg_qp_tiles_torch`.

**K1, the fused 3-stage NODDI solve** (``noddi_fused_tiles_pallas``).  Each
tile holds M voxels that share one LUT direction, and each voxel runs

1. NNLS on the full Gram G1 from an empty working set;
2. Y2 = max(Y_dwi - iso*x_iso [- x_dot], 0), b2 = A2T Y2 and a
   non-negative elastic net (lam1, lam2) on G2;
3. a debias NNLS on G1 restricted to supp(x2) + {iso[, dot]}, with the
   working set seeded by that mask and CG warm-started from x1.

Every stage runs Lawson-Hanson rounds (masked CG, ratio-test step back,
prune, top-k adds) and a final CG polish at the stage's largest budget;
stages 1-2 may start with FISTA, any stage may append the per-tile
``converge`` continuation, and ``early_exit`` stops FISTA and the scheduled
rounds once the tile is settled.  Stage 2 may end with the tie-break (the
dominant atom swapped for its kappa neighbours, the lowest objective kept)
and the ``want_tie`` score.  All arithmetic is float32, whatever precision
the JAX kernel was asked for.

:func:`noddi_fused_tiles_torch` is the twin: the same math batched over
(C, M, n) tensors with Python loops over rounds.  :func:`noddi_fused_tiles`
takes the twin for CPU tensors and launches ``csrc/noddi_fused.cu`` for
CUDA tensors; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from .cuda_build import Launcher, entry
from .solvers import noddi_stage2_tiebreak

TOL = 3e-6          # prune / add gate, relative to max|b_eff| per voxel
FTOL = 1e-4         # FISTA's early exit, relative to the tile's max|b|
BIG = 3.0e38
MAX_ATOMS = 160     # csrc/noddi_fused.cu 32 * KMAX
SMEM_LD = 160       # csrc/noddi_fused.cu LD: row stride of a Gram in shared memory
SUP_WORDS = 5       # csrc/noddi_fused.cu KMAX: stage-2 support words a voxel


def _round_up8(n: int) -> int:
    """n padded as the TPU kernels pad the atom axis (a multiple of 8)."""
    return -(-int(n) // 8) * 8


@dataclass(frozen=True)
class StageSchedule:
    """One solve's Lawson-Hanson schedule: per-round CG budgets and inner
    passes, atoms added per round, and the final polish's CG budget.
    ``fista`` FISTA iterations run first when no working set is seeded.
    ``cont_cg`` > 0 turns on the ``converge`` continuation: rounds at that
    CG budget (and the largest inner-pass count) while the tile is not
    done, at most ``cont_rounds`` of them.  ``early_exit`` ends FISTA once
    no coefficient of the tile moves by more than FTOL * the tile's
    max|b|, and skips the scheduled rounds left once a round leaves the
    whole tile stable.  No rounds (``cg`` empty): the solve returns its
    FISTA iterate or warm start as it is."""
    cg: tuple
    inner: tuple
    add_k: int
    polish: int
    fista: int = 0
    cont_cg: int = 0
    cont_rounds: int = 0
    early_exit: bool = False


def stage_schedule(stage: tuple, has_fista: bool, n: int,
                   early_exit: bool = False) -> StageSchedule:
    """Normalise one ``stage_iters`` entry of an ``n``-atom solve exactly as
    the JAX package's ``_make_noddi_kernel.mk`` and ``_build_as_solve``
    read it.

    ``stage`` is (fista, rounds, cg, inner[, converge[, add_k]]) for stages
    1-2 and (rounds, cg, inner[, converge[, add_k]]) for stage 3, which
    never runs FISTA.  A ``cg`` or ``inner`` entry may be a per-round
    tuple (cut to ``rounds`` and extended at its last entry); the polish
    runs at the largest budget.  ``converge`` (True, or an int CG budget)
    adds the continuation at ``max(cap, npad)`` or ``max(cap, converge)``
    CG steps, at most ``3 * npad`` rounds, and moves the polish to that
    budget (npad: n rounded up to a multiple of 8, the TPU kernel's
    padding)."""
    stage = tuple(stage)
    base = 4 if has_fista else 3
    if len(stage) > base + 2:
        raise ValueError(f'stage tuple {stage} has {len(stage)} entries; at '
                         f'most {base + 2} are meaningful (base {base} + '
                         'converge + add_k)')
    if has_fista:
        fista, rounds, cg, inner = stage[:4]
    else:
        fista = 0
        rounds, cg, inner = stage[:3]
    converge = stage[base] if len(stage) > base else False
    add_k = int(stage[base + 1]) if len(stage) > base + 1 else 1
    rounds = max(int(rounds), 0)
    sched = tuple(int(c) for c in cg) if isinstance(cg, (tuple, list)) \
        else None
    inns = tuple(int(i) for i in inner) if isinstance(inner, (tuple, list)) \
        else None
    if inns is not None and sched is None:
        sched = (int(cg),) * rounds
    cap = max(sched) if sched else int(cg)
    ip = max(inns) if inns else int(inner)
    if sched is not None:
        sched = list(sched[:rounds])
        if sched and len(sched) < rounds:
            sched += [sched[-1]] * (rounds - len(sched))
        inner_r = list(inns[:len(sched)]) if inns is not None \
            else [ip] * len(sched)
        if inner_r and len(inner_r) < len(sched):
            inner_r += [inner_r[-1]] * (len(sched) - len(inner_r))
    else:
        sched = [cap] * rounds
        inner_r = [ip] * rounds
    if add_k < 1:
        raise ValueError(f'add_k must be >= 1, got {add_k}')
    if int(fista) < 0 or cap < 0 or ip < 0:
        raise ValueError(f'stage tuple {stage}: negative iteration counts')
    cont_cg = cont_rounds = 0
    polish = cap
    if converge:
        npad = _round_up8(n)
        cont_cg = max(cap, npad) if isinstance(converge, bool) \
            else max(cap, int(converge))
        cont_rounds = 3 * npad
        polish = cont_cg
    return StageSchedule(tuple(sched), tuple(inner_r), add_k, polish,
                         int(fista), cont_cg, cont_rounds, bool(early_exit))


def noddi_schedules(stage_iters, na: int, n_wm: int,
                    early_exit: bool = False) -> tuple:
    """The three stages' schedules of ``stage_iters`` for a dictionary of
    ``na`` atoms, ``n_wm`` of them in stage 2's."""
    s1, s2, s3 = stage_iters
    return (stage_schedule(s1, True, na, early_exit),
            stage_schedule(s2, True, n_wm, early_exit),
            stage_schedule(s3, False, na, early_exit))


# ------------------------------------------------------------------ twin
def _lipschitz(G):
    """Per-tile Lipschitz estimate of ``_build_as_solve``: 10 power
    iterations on G (C, n, n) from ones, L = v'Gv * 1.01 + 1e-30; (C, 1, 1)."""
    v = torch.ones(G.shape[:-1] + (1,), dtype=G.dtype, device=G.device)
    for _ in range(10):
        w = torch.matmul(G, v)
        v = w / (torch.sqrt((w * w).sum((-2, -1), keepdim=True)) + 1e-30)
    return (v * torch.matmul(G, v)).sum((-2, -1), keepdim=True) * 1.01 \
        + 1e-30


def _fista(mv, G, bm, l1, l2, cmask, iters, early_exit=False):
    """FISTA from zero with adaptive restart per voxel and one step size
    per tile; with ``early_exit`` a tile stops once no coefficient of it
    moved by more than FTOL * its max|bm| in an iteration."""
    step = 1.0 / (_lipschitz(G) + l2 + 1e-30)
    x = torch.zeros_like(bm)
    z = x
    t = torch.ones(bm.shape[:-1] + (1,), dtype=bm.dtype, device=bm.device)
    tile = (-1,) + (1,) * (bm.dim() - 1)
    if early_exit:
        xtol = FTOL * (bm.abs().flatten(1).amax(1) + 1e-30)
        settled = torch.zeros(bm.shape[0], dtype=torch.bool, device=bm.device)
    for _ in range(iters):
        if early_exit and bool(settled.all()):
            break
        grad = mv(z) - bm + l2 * z
        x_new = torch.clamp(z - step * (grad + l1), min=0.0) * cmask
        restart = ((z - x_new) * (x_new - x)).sum(-1, keepdim=True) > 0.0
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        beta = torch.where(restart, 0.0, (t - 1.0) / t_new)
        t_new = torch.where(restart, 1.0, t_new)
        z_new = x_new + beta * (x_new - x)
        if early_exit:
            run = (~settled).view(tile)
            settled = settled | \
                ((x_new - x).abs().flatten(1).amax(1) <= xtol)
            x_new = torch.where(run, x_new, x)
            z_new = torch.where(run, z_new, z)
            t_new = torch.where(run, t_new, t)
        x, z, t = x_new, z_new, t_new
    return x


def _as_solve(G, b, l1, l2, cmask, sch: StageSchedule, m0=None,
              x_init=None, tile_rounds=None):
    """One solve for a batch of tiles: G (C, n, n), b/cmask (C, M, n).
    The tile (dim 0) is the unit of the ``converge`` continuation; each
    tile's continuation rounds are added to ``tile_rounds`` (C,) if given."""
    Gt = G.transpose(-1, -2)

    def mv(v):                                  # G v for each voxel
        return torch.matmul(v, Gt)

    bm = b * cmask
    if m0 is None and sch.fista > 0:
        x = _fista(mv, G, bm, l1, l2, cmask, sch.fista, sch.early_exit)
    else:
        x = torch.zeros_like(b) if x_init is None else x_init
    if not sch.cg:
        return x
    b_eff = (bm - l1) * cmask
    scale = b_eff.abs().amax(-1, keepdim=True) + 1e-30
    gate = TOL * scale

    def cg(m, z0, iters):
        z = z0 * m
        r = b_eff * m - (mv(z) + l2 * z) * m
        p = r
        rs = (r * r).sum(-1, keepdim=True)
        for _ in range(iters):
            Ap = (mv(p) + l2 * p) * m
            denom = (p * Ap).sum(-1, keepdim=True)
            safe = denom > 1e-30
            alpha = torch.where(safe, rs / torch.where(safe, denom, 1.0),
                                0.0)
            z = z + alpha * p
            r = r - alpha * Ap
            rs_new = (r * r).sum(-1, keepdim=True)
            beta = torch.where(safe, rs_new / (rs + 1e-30), 0.0)
            p = r + beta * p
            rs = rs_new
        return torch.where(torch.isfinite(z), z, 0.0)

    def inner_solve(x, m, iters):
        z = cg(m, x, iters)
        # only coordinates with x > 0 bound the step back
        neg = (z <= 0.0) & (m > 0.0) & (x > 0.0)
        ratio = torch.where(neg, x / (x - z + 1e-30), BIG)
        alpha = ratio.amin(-1, keepdim=True).clamp(0.0, 1.0)
        x = (x + alpha * (z - x)) * m
        m = m * (x > gate).float()
        return x * m, m

    def as_round(x, m, iters, inner):
        """Inner passes, then the top-add_k adds; also whether the tile is
        stable: no voxel passed the first add's gate and no working set
        changed over the round (C,)."""
        m_before = m
        for _ in range(inner):
            x, m = inner_solve(x, m, iters)
        w = b_eff - mv(x) - l2 * x
        w_cand = torch.where((1.0 - m) * cmask > 0.0, w, -BIG)
        m_new = m
        for k in range(sch.add_k):
            # torch.argmax takes the lowest index among equal maxima, as
            # jnp.argmax does
            wk, jstar = w_cand.max(-1, keepdim=True)
            if k == 0:
                added = wk > gate
            onehot = torch.zeros_like(w_cand).scatter_(-1, jstar, 1.0)
            m_new = torch.clamp(m_new + (wk > gate).float() * onehot,
                                max=1.0)
            w_cand = torch.where(onehot > 0.0, -BIG, w_cand)
        stable = ~added.flatten(1).any(1) & \
            (m_new == m_before).flatten(1).all(1)
        return x, m_new, stable

    m = (x > 0.0).float() * cmask if m0 is None else m0 * cmask
    tile = (-1,) + (1,) * (x.dim() - 1)
    stable = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for iters, inner in zip(sch.cg, sch.inner):
        if not sch.early_exit:
            x, m, stable = as_round(x, m, iters, inner)
            continue
        # a stable tile skips the scheduled rounds left: its support
        # cannot change, and the polish recomputes x on it
        if bool(stable.all()):
            break
        xn, mn, st = as_round(x, m, iters, inner)
        run = (~stable).view(tile)
        x = torch.where(run, xn, x)
        m = torch.where(run, mn, m)
        stable = stable | st
    if sch.cont_cg:
        # per tile: continue while the working sets change and x still
        # moves by more than tol * the tile's largest scale
        xtol = TOL * scale.flatten(1).amax(1)
        done = stable
        inner = max(sch.inner)
        for _ in range(sch.cont_rounds):
            if bool(done.all()):
                break
            if tile_rounds is not None:
                tile_rounds += (~done).to(tile_rounds.dtype)
            xn, mn, st = as_round(x, m, sch.cont_cg, inner)
            done_now = st | ((xn - x).abs().flatten(1).amax(1) <= xtol)
            run = (~done).view(tile)
            x = torch.where(run, xn, x)
            m = torch.where(run, mn, m)
            done = done | done_now
    x, m = inner_solve(x, m, sch.polish)
    return torch.clamp(x, min=0.0)


def _tie_score(G2, b2, x2, lam1, lam2):
    """Per voxel (C, M): the stage-2 KKT gradient of the atoms outside
    supp(x2), over max|b2 - lam1|, at its largest (-BIG with none); near 0
    where a tied vertex exists.  One float32 matvec."""
    beff = b2 - lam1
    w = beff - (torch.matmul(x2, G2.transpose(-1, -2)) + lam2 * x2)
    scale = beff.abs().amax(-1, keepdim=True) + 1e-30
    return torch.where(x2 > 0.0, -BIG, w / scale).amax(-1)


def _fused_raw_torch(G1, G2, b1, Y_dwi, A2T, iso_dwi, icvf, kappa, lam1,
                     lam2, scheds, is_exvivo, tiebreak=None, want_tie=False):
    """(C, M, 4) raw estimates [NDI, k1, FWF, dot], x (C, M, na) and,
    with ``want_tie``, the tie score (C, M), else None.  ``tiebreak``:
    (nb_minus, nb_plus, CG budget) or None."""
    C, M, na = b1.shape
    n_wm = G2.shape[-1]
    ones1 = torch.ones_like(b1)
    x1 = _as_solve(G1, b1, 0.0, 0.0, ones1, scheds[0])
    Y2 = Y_dwi - iso_dwi * x1[..., na - 1:na]
    if is_exvivo:
        Y2 = Y2 - x1[..., na - 2:na - 1]
    Y2 = torch.clamp(Y2, min=0.0)
    # the same product whatever A2T's strides (the model hands a view)
    b2 = torch.matmul(Y2, A2T.contiguous().transpose(-1, -2))  # (C, M, n_wm)
    x2 = _as_solve(G2, b2, lam1, lam2, torch.ones_like(b2), scheds[1])
    if tiebreak is not None:
        nb_minus, nb_plus, cg_iters = tiebreak
        x2 = noddi_stage2_tiebreak(G2, b2, x2, lam1, lam2, nb_minus, nb_plus,
                                   cg_iters)
    tie = _tie_score(G2, b2, x2, lam1, lam2) if want_tie else None
    mask3 = torch.cat([(x2 > 0.0).float(),
                       torch.ones((C, M, na - n_wm), dtype=b1.dtype,
                                  device=b1.device)], -1)
    x = _as_solve(G1, b1, 0.0, 0.0, mask3, scheds[2], m0=mask3,
                  x_init=x1 * mask3)
    sum_atoms = x.sum(-1) + 1e-16
    xn_wm = x[..., :n_wm] / sum_atoms[..., None]
    sum_wm = xn_wm.sum(-1) + 1e-16
    f1 = (icvf * xn_wm).sum(-1) / sum_wm
    f2 = ((1.0 - icvf) * xn_wm).sum(-1) / sum_wm
    k1 = (kappa * xn_wm).sum(-1) / sum_wm
    ndi = f1 / (f1 + f2 + 1e-16)
    fwf = x[..., na - 1] / sum_atoms
    dot = x[..., na - 2] / sum_atoms if is_exvivo else torch.zeros_like(fwf)
    return torch.stack([ndi, k1, fwf, dot], -1), x, tie


def _finish(raw, is_exvivo):
    """ODI = 2/pi atan2(1, k1) (the kernel emits k1, as the TPU kernel did)."""
    odi = (2.0 / math.pi) * torch.atan2(torch.ones_like(raw[..., 1]),
                                        raw[..., 1])
    cols = [raw[..., 0], odi, raw[..., 2]]
    if is_exvivo:
        cols.append(raw[..., 3])
    return torch.stack(cols, -1)


def _check_inputs(G1, G2, b1, Y_dwi, A2T, iso_dwi, icvf, kappa):
    C, M, na = b1.shape
    n_wm = G2.shape[-1]
    ndwi = Y_dwi.shape[-1]
    want = {'G1': (G1, (C, na, na)), 'G2': (G2, (C, n_wm, n_wm)),
            'Y_dwi': (Y_dwi, (C, M, ndwi)), 'A2T': (A2T, (C, n_wm, ndwi)),
            'iso_dwi': (iso_dwi, (ndwi,)), 'icvf': (icvf, (n_wm,)),
            'kappa': (kappa, (n_wm,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f'{name} has shape {tuple(t.shape)}, '
                             f'expected {shape}')
    if not n_wm < na:
        raise ValueError(f'the stage-2 dictionary ({n_wm} atoms) must be '
                         f'smaller than the full one ({na})')
    devs = {t.device for t in (G1, G2, b1, Y_dwi, A2T, iso_dwi, icvf,
                               kappa)}
    if len(devs) != 1:
        raise ValueError(f'inputs live on several devices: {devs}')
    for t in (G1, G2, b1, Y_dwi, A2T, iso_dwi, icvf, kappa):
        if t.dtype != torch.float32:
            raise TypeError(f'inputs must be float32, got {t.dtype}')


def _tiebreak_args(tiebreak_cg, nb_minus, nb_plus, n_wm):
    """The tie-break's (nb_minus, nb_plus, CG budget) or None: it runs, as
    in the JAX kernel, only with a budget and both neighbour tables."""
    if not tiebreak_cg or nb_minus is None or nb_plus is None:
        return None
    tables = []
    for name, t in (('nb_minus', nb_minus), ('nb_plus', nb_plus)):
        t = torch.as_tensor(t)
        if tuple(t.shape) != (n_wm,):
            raise ValueError(f'{name} has shape {tuple(t.shape)}, expected '
                             f'({n_wm},)')
        if bool(((t < -1) | (t >= n_wm)).any()):
            raise ValueError(f'{name} holds an index outside [-1, {n_wm})')
        tables.append(t)
    return tables[0], tables[1], int(tiebreak_cg)


def _outputs(est, x, tie, want_x, want_tie):
    out = (est,) + ((x,) if want_x else ()) + ((tie,) if want_tie else ())
    return out if len(out) > 1 else est


def noddi_fused_tiles_torch(G1, G2, b1, Y_dwi, A2T, iso_dwi, icvf, kappa,
                            lam1=0.5, lam2=1e-3, stage_iters=None,
                            want_x=False, is_exvivo=False, tiebreak_cg=0,
                            want_tie=False, nb_minus=None, nb_plus=None,
                            early_exit=False):
    """Plain PyTorch version of the fused solve, on any device.

    G1 (C, na, na), G2 (C, n_wm, n_wm), b1 (C, M, na), Y_dwi (C, M, ndwi),
    A2T (C, n_wm, ndwi), iso_dwi (ndwi,), icvf/kappa (n_wm,), all float32.
    ``nb_minus``/``nb_plus`` (n_wm,) int: each atom's same-ICVF
    adjacent-kappa atom (-1 at the grid edge); with them and
    ``tiebreak_cg`` > 0, stage 2 ends with the tie-break at that CG budget
    a candidate.  ``early_exit`` as ``StageSchedule`` says.  Returns
    estimates (C, M, 3|4) [NDI, ODI, FWF(, dot)], then with ``want_x`` the
    debiased coefficients (C, M, na) and with ``want_tie`` the tie score
    (C, M), as ``noddi_fused_tiles_pallas`` returns them."""
    _check_inputs(G1, G2, b1, Y_dwi, A2T, iso_dwi, icvf, kappa)
    na, n_wm = b1.shape[-1], G2.shape[-1]
    scheds = noddi_schedules(_default_stage_iters(stage_iters), na, n_wm,
                             bool(early_exit))
    tb = _tiebreak_args(tiebreak_cg, nb_minus, nb_plus, n_wm)
    if tb is not None:
        tb = (tb[0].to(b1.device), tb[1].to(b1.device), tb[2])
    raw, x, tie = _fused_raw_torch(G1, G2, b1, Y_dwi, A2T, iso_dwi, icvf,
                                   kappa, float(lam1), float(lam2), scheds,
                                   bool(is_exvivo), tb, bool(want_tie))
    return _outputs(_finish(raw, is_exvivo), x, tie, want_x, want_tie)


def _default_stage_iters(stage_iters):
    if stage_iters is None:
        from ..models.base import DEFAULT_NODDI_STAGE_ITERS
        return DEFAULT_NODDI_STAGE_ITERS
    return stage_iters


# ---------------------------------------------------------------- kernel
SCHED_STAGE = 8     # csrc/noddi_fused.cu: header ints of a stage


def _general(scheds, tb, want_tie) -> bool:
    """Whether a launch needs the kernel's general path (csrc/noddi_fused.cu
    GEN): FISTA, `converge`, `early_exit`, a stage without rounds, the
    tie-break or the tie score.  The default schedule needs none."""
    return (tb is not None or bool(want_tie)
            or any(s.fista or s.cont_cg or s.early_exit or not s.cg
                   for s in scheds))


def _sched_arrays(scheds, tb, general):
    """Pack three schedules as csrc/noddi_fused.cu reads them: a host
    header, per stage [rounds, add_k, polish, fista, cont_cg, cont_rounds,
    cont_inner, offset], then [early_exit, tiebreak_cg, general]; and the
    per-round table, (cg, inner) for each round of the three stages one
    after the other (stage s's rounds from pair ``offset``)."""
    head = np.zeros(3 * SCHED_STAGE + 3, np.int32)
    rounds, off = [], 0
    for s, sch in enumerate(scheds):
        r = len(sch.cg)
        head[s * SCHED_STAGE:(s + 1) * SCHED_STAGE] = (
            r, sch.add_k, sch.polish, sch.fista if s < 2 else 0,
            sch.cont_cg, sch.cont_rounds, max(sch.inner, default=0), off)
        rounds += [v for pair in zip(sch.cg, sch.inner) for v in pair]
        off += r
    head[3 * SCHED_STAGE:] = (int(scheds[0].early_exit),
                              0 if tb is None else tb[2], int(general))
    return head, np.asarray(rounds or [0, 0], np.int32)


_ROUND_TABLES: dict = {}


def _round_table(table: np.ndarray, device) -> torch.Tensor:
    """The per-round table on ``device``, uploaded once per content and
    card and kept (a few hundred bytes): a launch then copies nothing."""
    key = (device.index, table.tobytes())
    t = _ROUND_TABLES.get(key)
    if t is None:
        t = _ROUND_TABLES[key] = torch.tensor(table, device=device)
    return t


_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_NODDI_LAUNCH = Launcher('noddi_fused_launch',
                         [_vp] * 15 + [_ci] * 6 + [_cf, _cf, _vp])
_QP_LAUNCH = Launcher('nneg_qp_launch',
                      [_vp] * 7 + [_ci] * 3 + [_cf, _cf, _vp])


def _max_smem(device) -> int:
    return entry('cuda_max_smem', [_ci])(device.index)


def noddi_scratch_words(na: int, n_wm: int, general: bool) -> int:
    """Scratch floats a voxel (csrc/noddi_fused.cu Params): stage 1's x and
    stage 2's support words; on the general path also the voxel's x, FISTA's
    z and t, b2 and a working-set word a lane between rounds."""
    return na + SUP_WORDS + ((2 * na + 1 + n_wm + 32) if general else 0)


def noddi_fused_tiles(G1, G2, b1, Y_dwi, A2T, iso_dwi, icvf, kappa,
                      lam1=0.5, lam2=1e-3, stage_iters=None, want_x=False,
                      is_exvivo=False, tiebreak_cg=0, want_tie=False,
                      nb_minus=None, nb_plus=None, early_exit=False):
    """Fused 3-stage NODDI solve: the CUDA kernel for CUDA tensors, the
    twin for CPU tensors.  Same arguments and returns as
    :func:`noddi_fused_tiles_torch`; ``A2T`` may have any strides (the
    kernel reads the dictionary as ``A2T.transpose(-1, -2)``, contiguous, so
    the transposed view of an (C, ndwi, n_wm) tensor costs no copy).
    ``noddi_fused_tiles.launches`` counts kernel launches."""
    if b1.device.type == 'cpu':
        return noddi_fused_tiles_torch(G1, G2, b1, Y_dwi, A2T, iso_dwi, icvf,
                                       kappa, lam1, lam2, stage_iters,
                                       want_x, is_exvivo, tiebreak_cg,
                                       want_tie, nb_minus, nb_plus,
                                       early_exit)
    if b1.device.type != 'cuda':
        raise ValueError(f'unsupported device {b1.device}')
    _check_inputs(G1, G2, b1, Y_dwi, A2T, iso_dwi, icvf, kappa)
    C, M, na = b1.shape
    n_wm = G2.shape[-1]
    ndwi = Y_dwi.shape[-1]
    scheds = noddi_schedules(_default_stage_iters(stage_iters), na, n_wm,
                             bool(early_exit))
    tb = _tiebreak_args(tiebreak_cg, nb_minus, nb_plus, n_wm)
    if na > MAX_ATOMS:
        raise NotImplementedError(f'the kernel takes at most {MAX_ATOMS} '
                                  f'atoms, got {na}')
    for name, t in (('G1', G1), ('G2', G2), ('b1', b1), ('Y_dwi', Y_dwi),
                    ('iso_dwi', iso_dwi), ('icvf', icvf), ('kappa', kappa)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    smem = na * SMEM_LD * 4
    smem_max = _max_smem(b1.device)
    if smem > smem_max:
        raise NotImplementedError(
            f'the kernel needs {smem} bytes of shared memory for a Gram of '
            f'{na} atoms; the card allows {smem_max}')
    dev = b1.device
    est = torch.empty((C, M, 4), dtype=torch.float32, device=dev)
    x = torch.empty((C, M, na), dtype=torch.float32, device=dev) \
        if want_x else None
    tie = torch.empty((C, M), dtype=torch.float32, device=dev) \
        if want_tie else None
    if C * M > 0:
        general = _general(scheds, tb, want_tie)
        head, table = _sched_arrays(scheds, tb, general)  # held across the call
        rtab = _round_table(table, dev)
        nbs = [None, None] if tb is None else \
            [t.to(dev, torch.int32).contiguous() for t in tb[:2]]
        A2 = A2T.transpose(-1, -2).contiguous()
        scratch = torch.empty(C * M * noddi_scratch_words(na, n_wm, general),
                              dtype=torch.float32, device=dev)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        _NODDI_LAUNCH(
            dev, G1.data_ptr(), G2.data_ptr(), b1.data_ptr(),
            Y_dwi.data_ptr(), A2.data_ptr(), iso_dwi.data_ptr(),
            icvf.data_ptr(), kappa.data_ptr(), ptr(nbs[0]), ptr(nbs[1]),
            est.data_ptr(), ptr(x), ptr(tie), scratch.data_ptr(),
            rtab.data_ptr(), C, M, na, n_wm, ndwi, int(bool(is_exvivo)),
            float(lam1), float(lam2), head.ctypes.data)
        noddi_fused_tiles.launches += 1
    return _outputs(_finish(est, is_exvivo), x, tie, want_x, want_tie)


noddi_fused_tiles.launches = 0


# ===================================================== K2: generic tile QP
QP_MAX_ATOMS = 160  # csrc/nneg_qp.cu: at most 5 coefficients per lane
QP_MAX_ROUNDS = 32  # csrc/nneg_qp.cu MAXR: distinct per-round CG budgets


def qp_schedule(n: int, fista_iters=60, refine_rounds=14, cg_iters=24,
                inner_passes=2, converge=False, add_k=1) -> StageSchedule:
    """Normalise ``nneg_qp_tiles_pallas``'s solver arguments exactly as
    ``_make_kernel`` and ``_build_as_solve`` do.

    A tuple ``cg_iters`` is a per-round CG budget, cut to ``refine_rounds``
    and extended at its last entry; its largest entry caps the polish.  An
    int is a flat budget.  ``converge`` (True, or an int CG budget) adds the
    per-tile continuation: CG budget ``max(cap, npad)`` (True) or
    ``max(cap, converge)``, at most ``3 * npad`` rounds, and its budget for
    the polish, where ``npad`` is n rounded up to a multiple of 8 as the
    TPU kernel pads it."""
    if isinstance(cg_iters, (tuple, list)):
        sched = [int(c) for c in cg_iters]
        if not sched:
            raise ValueError('cg_iters is an empty schedule')
        cap = max(sched)
    else:
        cap = int(cg_iters)
        sched = [cap]
    rounds = max(int(refine_rounds), 0)
    sched = sched[:rounds]
    if sched and len(sched) < rounds:
        sched += [sched[-1]] * (rounds - len(sched))
    if int(add_k) < 1:
        raise ValueError(f'add_k must be >= 1, got {add_k}')
    if int(inner_passes) < 0 or int(fista_iters) < 0:
        raise ValueError('inner_passes and fista_iters must be >= 0')
    cont_cg = cont_rounds = 0
    polish = cap
    if converge:
        npad = -(-int(n) // 8) * 8
        cont_cg = max(cap, npad) if isinstance(converge, bool) \
            else max(cap, int(converge))
        cont_rounds = 3 * npad
        polish = cont_cg
    return StageSchedule(tuple(sched), (int(inner_passes),) * len(sched),
                         int(add_k), polish, int(fista_iters), cont_cg,
                         cont_rounds)


def _check_qp_inputs(G, b, mask, m0, x0):
    if b.dim() != 3:
        raise ValueError(f'b must be (C, M, n), got shape {tuple(b.shape)}')
    C, M, n = b.shape
    want = {'G': (G, (C, n, n)), 'mask': (mask, (C, M, n)),
            'm0': (m0, (C, M, n)), 'x0': (x0, (C, M, n))}
    ts = [b]
    for name, (t, shape) in want.items():
        if t is None:
            continue
        ts.append(t)
        if tuple(t.shape) != shape:
            raise ValueError(f'{name} has shape {tuple(t.shape)}, '
                             f'expected {shape}')
    if len({t.device for t in ts}) != 1:
        raise ValueError('inputs live on several devices: '
                         f'{ {t.device for t in ts} }')
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f'inputs must be float32, got {t.dtype}')


def nneg_qp_tiles_torch(G, b, L=None, lam1=0.0, lam2=0.0, mask=None,
                        fista_iters=60, cd_sweeps=4, refine_rounds=14,
                        cg_iters=24, inner_passes=2, m0=None, x0=None,
                        converge=False, add_k=1, tile_rounds=None):
    """Plain PyTorch version of the tile QP, on any device.

    G (C, n, n), b (C, M, n) -> x (C, M, n), all float32; ``mask``, ``m0``
    and ``x0`` are (C, M, n).  ``m0``/``x0`` seed the working set and the
    first CG solve and skip FISTA.  ``L`` and ``cd_sweeps`` are accepted
    and ignored, as by ``nneg_qp_tiles_pallas``.  ``tile_rounds``, a (C,)
    int32 tensor on b's device, receives each tile's ``converge``
    continuation rounds (0 without)."""
    _check_qp_inputs(G, b, mask, m0, x0)
    _check_tile_rounds(tile_rounds, b)
    sch = qp_schedule(b.shape[-1], fista_iters, refine_rounds, cg_iters,
                      inner_passes, converge, add_k)
    cmask = torch.ones_like(b) if mask is None else mask
    if tile_rounds is not None:
        tile_rounds.zero_()
    if m0 is None:
        return _as_solve(G, b, float(lam1), float(lam2), cmask, sch,
                         tile_rounds=tile_rounds)
    x_init = (torch.zeros_like(b) if x0 is None else x0) * cmask
    return _as_solve(G, b, float(lam1), float(lam2), cmask, sch,
                     m0=m0 * cmask, x_init=x_init, tile_rounds=tile_rounds)


def _check_tile_rounds(tile_rounds, b):
    if tile_rounds is None:
        return
    if tile_rounds.dtype != torch.int32 \
            or tuple(tile_rounds.shape) != (b.shape[0],) \
            or tile_rounds.device != b.device \
            or not tile_rounds.is_contiguous():
        raise ValueError('tile_rounds must be a contiguous (C,) int32 '
                         f'tensor on {b.device}, got '
                         f'{tuple(tile_rounds.shape)} {tile_rounds.dtype} on '
                         f'{tile_rounds.device}')


def _qp_sched_array(sch: StageSchedule) -> np.ndarray:
    """Pack a K2 schedule as csrc/nneg_qp.cu reads it: [fista, rounds,
    inner, add_k, polish, cont_cg, cont_rounds, cg[QP_MAX_ROUNDS]]; round r
    runs cg[min(r, QP_MAX_ROUNDS - 1)]."""
    cg = list(sch.cg)
    if len(set(cg[QP_MAX_ROUNDS - 1:])) > 1:
        raise NotImplementedError(
            f'the kernel takes at most {QP_MAX_ROUNDS} distinct per-round CG '
            f'budgets (then a flat tail); got a schedule of {len(cg)} rounds')
    out = np.zeros(7 + QP_MAX_ROUNDS, np.int32)
    out[:7] = (sch.fista, len(cg), sch.inner[0] if cg else 0, sch.add_k,
               sch.polish, sch.cont_cg, sch.cont_rounds)
    head = cg[:QP_MAX_ROUNDS]
    out[7:7 + len(head)] = head
    return out


QP_NWARPS = 32        # csrc/nneg_qp.cu NWARPS: warps a block for n <= 32
QP_CLUSTER = 2        # csrc/nneg_qp.cu QP_CLUSTER: blocks a tile for n <= 32
QP_NWARPS_WIDE = 16   # csrc/nneg_qp.cu NWARPS_WIDE: for n > 32, one block
QP_SMEM_RESERVE = 1024  # csrc/nneg_qp.cu: bytes kept for static arrays


@dataclass(frozen=True)
class QpGeometry:
    """How ``csrc/nneg_qp.cu`` lays out a launch: a voxel is solved by a
    group of ``width`` lanes holding ``per_lane`` coefficients each; a
    tile is a cluster of ``cluster`` blocks of ``warps`` warps, which hold
    ``groups`` voxels in flight; and each block keeps the tile's per-voxel
    state in ``smem`` bytes of dynamic shared memory: G, each voxel's
    working-set and mask words and scale and, by ``state``, its x and
    b_eff (2), x only (1) or neither (0: x in the output, b_eff recomputed
    from b each round)."""
    width: int
    per_lane: int
    warps: int
    cluster: int
    groups: int
    state: int
    smem: int


def qp_geometry(n: int, M: int, smem_max: int) -> QpGeometry:
    """The launch the C entry point makes for n atoms and M voxels a tile
    on a card whose blocks may take ``smem_max`` bytes of shared memory
    (it applies the same rule).  Raises ``NotImplementedError`` above
    QP_MAX_ATOMS atoms and when G and the per-voxel words alone do not
    fit."""
    if n < 1:
        raise ValueError(f'a tile QP needs at least one atom, got {n}')
    if n > QP_MAX_ATOMS:
        raise NotImplementedError(f'the kernel takes at most {QP_MAX_ATOMS} '
                                  f'atoms, got {n} (ROADMAP queue 2, K2)')
    width = 8 if n <= 8 else 16 if n <= 16 else 32
    k = -(-n // width)
    words = n * 32 * k + M * (2 * k + 1)   # G, then words and scales
    rows = M * n                           # one voxel array (x or b_eff)
    avail = max(smem_max - QP_SMEM_RESERVE, 0) // 4
    state = 2 if words + 2 * rows <= avail else \
        1 if words + rows <= avail else 0
    if words > avail:
        raise NotImplementedError(
            f'the kernel needs {words * 4} bytes of shared memory for {n} '
            f'atoms and {M} voxels a tile; the card allows {smem_max}')
    warps, cluster = (QP_NWARPS, QP_CLUSTER) if k == 1 else \
        (QP_NWARPS_WIDE, 1)
    return QpGeometry(width, k, warps, cluster,
                      cluster * warps * 32 // width, state,
                      (words + state * rows) * 4)


def nneg_qp_tiles(G, b, L=None, lam1=0.0, lam2=0.0, mask=None,
                  fista_iters=60, cd_sweeps=4, refine_rounds=14, cg_iters=24,
                  inner_passes=2, m0=None, x0=None, converge=False, add_k=1,
                  tile_rounds=None):
    """Tile QP: the CUDA kernel for CUDA tensors, the twin for CPU tensors.
    Same arguments and return as :func:`nneg_qp_tiles_torch`.  The kernel
    takes n <= QP_MAX_ATOMS and 0/1 ``mask`` and ``m0``, and raises on the
    rest.  Without ``tile_rounds`` the kernel writes no round count.
    ``nneg_qp_tiles.launches`` counts kernel launches."""
    if b.device.type == 'cpu':
        return nneg_qp_tiles_torch(G, b, L, lam1, lam2, mask, fista_iters,
                                   cd_sweeps, refine_rounds, cg_iters,
                                   inner_passes, m0, x0, converge, add_k,
                                   tile_rounds)
    if b.device.type != 'cuda':
        raise ValueError(f'unsupported device {b.device}')
    _check_qp_inputs(G, b, mask, m0, x0)
    _check_tile_rounds(tile_rounds, b)
    C, M, n = b.shape
    qp_geometry(n, M, _max_smem(b.device))
    sched = _qp_sched_array(qp_schedule(n, fista_iters, refine_rounds,
                                        cg_iters, inner_passes, converge,
                                        add_k))
    named = (('G', G), ('b', b), ('mask', mask), ('m0', m0), ('x0', x0))
    for name, t in named:
        if t is not None and not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    for name, t in named[2:4]:
        if t is not None and not bool(((t == 0) | (t == 1)).all()):
            raise ValueError(f'the kernel takes a 0/1 {name}')
    x = torch.empty_like(b)
    if C * M > 0:
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        _QP_LAUNCH(b.device, G.data_ptr(), b.data_ptr(), ptr(mask), ptr(m0),
                   ptr(x0), x.data_ptr(), ptr(tile_rounds), C, M, n,
                   float(lam1), float(lam2), sched.ctypes.data)
        nneg_qp_tiles.launches += 1
    elif tile_rounds is not None:
        tile_rounds.zero_()
    return x


nneg_qp_tiles.launches = 0
