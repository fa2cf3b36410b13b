"""Fused 3-stage NODDI solve per tile: the CUDA kernel, its plain PyTorch
twin, and the wrapper that picks between them by the tensors' device.

Counterpart of ``amico_tpu.ops.pallas_qp.noddi_fused_tiles_pallas``.  Each
tile holds M voxels that share one LUT direction, and each voxel runs

1. NNLS on the full Gram G1 from an empty working set;
2. Y2 = max(Y_dwi - iso*x_iso [- x_dot], 0), b2 = A2T Y2 and a
   non-negative elastic net (lam1, lam2) on G2;
3. a debias NNLS on G1 restricted to supp(x2) + {iso[, dot]}, with the
   working set seeded by that mask and CG warm-started from x1.

Every stage runs Lawson-Hanson rounds (masked CG, ratio-test step back,
prune, top-k adds) and a final CG polish at the stage's largest budget.
All arithmetic is float32.

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

TOL = 3e-6          # prune / add gate, relative to max|b_eff| per voxel
BIG = 3.0e38
MAX_ROUNDS = 32     # csrc/noddi_fused.cu MAXR
MAX_ATOMS = 160     # csrc/noddi_fused.cu 32 * KMAX
SMEM_LD = 160       # csrc/noddi_fused.cu LD: row stride of a Gram in shared memory


@dataclass(frozen=True)
class StageSchedule:
    """One stage's Lawson-Hanson schedule: per-round CG budgets and inner
    passes, atoms added per round, and the final polish's CG budget."""
    cg: tuple
    inner: tuple
    add_k: int
    polish: int


def stage_schedule(stage: tuple, has_fista: bool) -> StageSchedule:
    """Normalise one ``stage_iters`` entry exactly as the JAX kernel builder
    does (``_make_noddi_kernel.mk`` + ``_build_as_solve``).

    ``stage`` is (fista, rounds, cg, inner[, converge[, add_k]]) for stages
    1-2 and (rounds, cg, inner[, converge[, add_k]]) for stage 3.  A ``cg``
    or ``inner`` entry may be a per-round tuple.  FISTA warm starts,
    ``converge`` continuation and empty schedules are not supported here
    (ROADMAP queue 2, K1 follow-ups) and raise ``NotImplementedError``.
    """
    stage = tuple(stage)
    base = 4 if has_fista else 3
    if len(stage) > base + 2:
        raise ValueError(f'stage tuple {stage} has {len(stage)} entries; at '
                         f'most {base + 2} are meaningful (base {base} + '
                         'converge + add_k)')
    if has_fista:
        fista, rounds, cg, inner = stage[:4]
        if int(fista) != 0:
            raise NotImplementedError(
                'FISTA warm starts in the fused NODDI solve are not ported '
                '(ROADMAP queue 2, K1 follow-ups); use fista=0')
    else:
        rounds, cg, inner = stage[:3]
    converge = stage[base] if len(stage) > base else False
    add_k = int(stage[base + 1]) if len(stage) > base + 1 else 1
    if converge is not False and converge != 0:
        raise NotImplementedError(
            "the fused NODDI solve's 'converge' continuation is not ported "
            '(ROADMAP queue 2, K1 follow-ups)')
    rounds = int(rounds)
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
    if not sched:
        raise NotImplementedError('a stage needs at least one round')
    if len(sched) > MAX_ROUNDS:
        raise NotImplementedError(
            f'at most {MAX_ROUNDS} rounds per stage, got {len(sched)}')
    if add_k < 1:
        raise ValueError(f'add_k must be >= 1, got {add_k}')
    return StageSchedule(tuple(sched), tuple(inner_r), add_k, cap)


def noddi_schedules(stage_iters) -> tuple:
    s1, s2, s3 = stage_iters
    return (stage_schedule(s1, True), stage_schedule(s2, True),
            stage_schedule(s3, False))


# ------------------------------------------------------------------ twin
def _as_solve(G, b, l1, l2, cmask, sch: StageSchedule, m0=None,
              x_init=None):
    """One stage for a batch of voxels: G (C, n, n), b/cmask (C, M, n)."""
    Gt = G.transpose(-1, -2)

    def mv(v):                                  # G v for each voxel
        return torch.matmul(v, Gt)

    bm = b * cmask
    x = torch.zeros_like(b) if x_init is None else x_init
    b_eff = (bm - l1) * cmask
    gate = TOL * (b_eff.abs().amax(-1, keepdim=True) + 1e-30)

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

    m = (x > 0.0).float() * cmask if m0 is None else m0 * cmask
    for iters, inner in zip(sch.cg, sch.inner):
        for _ in range(inner):
            x, m = inner_solve(x, m, iters)
        w = b_eff - mv(x) - l2 * x
        w_cand = torch.where((1.0 - m) * cmask > 0.0, w, -BIG)
        m_new = m
        for _ in range(sch.add_k):
            # torch.argmax takes the lowest index among equal maxima, as
            # jnp.argmax does
            wk, jstar = w_cand.max(-1, keepdim=True)
            onehot = torch.zeros_like(w_cand).scatter_(-1, jstar, 1.0)
            m_new = torch.clamp(m_new + (wk > gate).float() * onehot,
                                max=1.0)
            w_cand = torch.where(onehot > 0.0, -BIG, w_cand)
        m = m_new
    x, m = inner_solve(x, m, sch.polish)
    return torch.clamp(x, min=0.0)


def _fused_raw_torch(G1, G2, b1, Y_dwi, A2T, iso_dwi, icvf, kappa, lam1,
                     lam2, scheds, is_exvivo):
    """(C, M, 4) raw estimates [NDI, k1, FWF, dot] and x (C, M, na)."""
    C, M, na = b1.shape
    n_wm = G2.shape[-1]
    ones1 = torch.ones_like(b1)
    x1 = _as_solve(G1, b1, 0.0, 0.0, ones1, scheds[0])
    Y2 = Y_dwi - iso_dwi * x1[..., na - 1:na]
    if is_exvivo:
        Y2 = Y2 - x1[..., na - 2:na - 1]
    Y2 = torch.clamp(Y2, min=0.0)
    b2 = torch.matmul(Y2, A2T.transpose(-1, -2))          # (C, M, n_wm)
    x2 = _as_solve(G2, b2, lam1, lam2, torch.ones_like(b2), scheds[1])
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
    return torch.stack([ndi, k1, fwf, dot], -1), x


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


def _reject_unported(tiebreak_cg, want_tie):
    if tiebreak_cg:
        raise NotImplementedError(
            'the stage-2 tie-break of the fused NODDI solve is not ported '
            '(ROADMAP queue 2, K1 follow-ups)')
    if want_tie:
        raise NotImplementedError(
            "the fused NODDI solve's want_tie score is not ported (ROADMAP "
            'queue 2, K1 follow-ups)')


def noddi_fused_tiles_torch(G1, G2, b1, Y_dwi, A2T, iso_dwi, icvf, kappa,
                            lam1=0.5, lam2=1e-3, stage_iters=None,
                            want_x=False, is_exvivo=False, tiebreak_cg=0,
                            want_tie=False):
    """Plain PyTorch version of the fused solve, on any device.

    G1 (C, na, na), G2 (C, n_wm, n_wm), b1 (C, M, na), Y_dwi (C, M, ndwi),
    A2T (C, n_wm, ndwi), iso_dwi (ndwi,), icvf/kappa (n_wm,), all float32.
    Returns estimates (C, M, 3|4) [NDI, ODI, FWF(, dot)] and, with
    ``want_x``, the debiased coefficients (C, M, na).  ``tiebreak_cg`` and
    ``want_tie`` keep the JAX kernel's signature and raise when set."""
    _reject_unported(tiebreak_cg, want_tie)
    _check_inputs(G1, G2, b1, Y_dwi, A2T, iso_dwi, icvf, kappa)
    scheds = noddi_schedules(_default_stage_iters(stage_iters))
    raw, x = _fused_raw_torch(G1, G2, b1, Y_dwi, A2T, iso_dwi, icvf, kappa,
                              float(lam1), float(lam2), scheds,
                              bool(is_exvivo))
    est = _finish(raw, is_exvivo)
    return (est, x) if want_x else est


def _default_stage_iters(stage_iters):
    if stage_iters is None:
        from ..models.base import DEFAULT_NODDI_STAGE_ITERS
        return DEFAULT_NODDI_STAGE_ITERS
    return stage_iters


# ---------------------------------------------------------------- kernel
def _sched_array(scheds) -> np.ndarray:
    """Pack three schedules as csrc/noddi_fused.cu reads them: per stage
    [rounds, add_k, polish, cg[MAX_ROUNDS], inner[MAX_ROUNDS]]."""
    out = np.zeros((3, 3 + 2 * MAX_ROUNDS), np.int32)
    for s, sch in enumerate(scheds):
        r = len(sch.cg)
        out[s, :3] = (r, sch.add_k, sch.polish)
        out[s, 3:3 + r] = sch.cg
        out[s, 3 + MAX_ROUNDS:3 + MAX_ROUNDS + r] = sch.inner
    return out


def _library():
    from .cuda_build import load_library
    lib = load_library()
    fn = lib.noddi_fused_launch
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp] * 10 + [ci] * 6 + [cf, cf, vp, vp]
        fn.restype = ci
        lib.noddi_fused_max_smem.argtypes = [ci]
        lib.noddi_fused_max_smem.restype = ci
        lib.noddi_fused_error_string.argtypes = [ci]
        lib.noddi_fused_error_string.restype = ctypes.c_char_p
    return lib


def noddi_fused_tiles(G1, G2, b1, Y_dwi, A2T, iso_dwi, icvf, kappa,
                      lam1=0.5, lam2=1e-3, stage_iters=None, want_x=False,
                      is_exvivo=False, tiebreak_cg=0, want_tie=False):
    """Fused 3-stage NODDI solve: the CUDA kernel for CUDA tensors, the
    twin for CPU tensors.  Same arguments and returns as
    :func:`noddi_fused_tiles_torch`.  ``noddi_fused_tiles.launches`` counts
    kernel launches."""
    if b1.device.type == 'cpu':
        return noddi_fused_tiles_torch(G1, G2, b1, Y_dwi, A2T, iso_dwi, icvf,
                                       kappa, lam1, lam2, stage_iters,
                                       want_x, is_exvivo, tiebreak_cg,
                                       want_tie)
    if b1.device.type != 'cuda':
        raise ValueError(f'unsupported device {b1.device}')
    _reject_unported(tiebreak_cg, want_tie)
    _check_inputs(G1, G2, b1, Y_dwi, A2T, iso_dwi, icvf, kappa)
    scheds = noddi_schedules(_default_stage_iters(stage_iters))
    C, M, na = b1.shape
    n_wm = G2.shape[-1]
    ndwi = Y_dwi.shape[-1]
    if na > MAX_ATOMS:
        raise NotImplementedError(f'the kernel takes at most {MAX_ATOMS} '
                                  f'atoms, got {na}')
    for name, t in (('G1', G1), ('G2', G2), ('b1', b1), ('Y_dwi', Y_dwi),
                    ('A2T', A2T), ('iso_dwi', iso_dwi), ('icvf', icvf),
                    ('kappa', kappa)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    lib = _library()
    dev = b1.device.index if b1.device.index is not None \
        else torch.cuda.current_device()
    smem = (na + n_wm) * SMEM_LD * 4
    smem_max = lib.noddi_fused_max_smem(dev)
    if smem > smem_max:
        raise NotImplementedError(
            f'the kernel needs {smem} bytes of shared memory for Grams of '
            f'{na} and {n_wm} atoms; the card allows {smem_max}')
    est = torch.empty((C, M, 4), dtype=torch.float32, device=b1.device)
    x = torch.empty((C, M, na), dtype=torch.float32, device=b1.device) \
        if want_x else None
    if C * M > 0:
        sched = _sched_array(scheds)
        # the C side sets the smem attribute and launches on the current
        # device, which must be the tensors'
        with torch.cuda.device(b1.device):
            err = lib.noddi_fused_launch(
                G1.data_ptr(), G2.data_ptr(), b1.data_ptr(),
                Y_dwi.data_ptr(), A2T.data_ptr(), iso_dwi.data_ptr(),
                icvf.data_ptr(), kappa.data_ptr(), est.data_ptr(),
                x.data_ptr() if want_x else None,
                C, M, na, n_wm, ndwi, int(bool(is_exvivo)),
                float(lam1), float(lam2), sched.ctypes.data,
                torch.cuda.current_stream(b1.device).cuda_stream)
        if err != 0:
            raise RuntimeError('noddi_fused kernel launch failed: '
                               + lib.noddi_fused_error_string(err).decode())
        noddi_fused_tiles.launches += 1
    out = _finish(est, is_exvivo)
    return (out, x) if want_x else out


noddi_fused_tiles.launches = 0
