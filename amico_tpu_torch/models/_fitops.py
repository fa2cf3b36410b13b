"""Shared per-tile pieces of the model fit functions, in float32
(counterpart of ``amico_tpu.models._fitops``)."""
from __future__ import annotations

import torch

from ..ops.cuda_qp import nneg_qp_tiles


def predict(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y_est = A x per tile: A (C, nS, na), x (C, M, na) -> (C, M, nS)."""
    return torch.matmul(x, A.transpose(-1, -2))


def project(A: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """b = A'y per tile: A (C, nS, na), Y (C, M, nS) -> (C, M, na)."""
    return torch.matmul(Y, A)


def error_maps(A, x, Y, compute_rmse: bool, compute_nrmse: bool) -> dict:
    """RMSE / NRMSE maps exactly as the JAX package computes them."""
    out = {}
    if not (compute_rmse or compute_nrmse):
        return out
    sq = ((Y - predict(A, x)) ** 2).sum(-1)
    if compute_rmse:
        out['rmse'] = torch.sqrt(sq / Y.shape[-1])
    if compute_nrmse:
        den = (Y ** 2).sum(-1)
        out['nrmse'] = torch.where(
            den > 1e-16, torch.sqrt(sq / torch.clamp(den, min=1e-16)), 0.0)
    return out


def solve_tiles(G, b, L, lam1, lam2, mask=None, solver_kw=None,
                backend: str = 'auto', m0=None, x0=None):
    """Per-tile QP solve: G (C, n, n), b (C, M, n) -> x (C, M, n).

    'auto' and 'pallas' run the tile QP (``ops.cuda_qp.nneg_qp_tiles``: the
    CUDA kernel on a CUDA device, its twin on the CPU).  ``L`` is accepted
    and ignored (the solve estimates it per tile); ``m0``/``x0`` warm-start
    the active-set rounds and skip FISTA."""
    if backend == 'xla':
        raise NotImplementedError(
            "backend 'xla' (the stagewise nneg_qp_batch) is not ported yet "
            '(ROADMAP, still to port: nneg_qp_batch)')
    if backend not in ('auto', 'pallas'):
        raise ValueError(f'unknown backend {backend!r}')
    return nneg_qp_tiles(G, b, L, lam1, lam2, mask=mask, m0=m0, x0=x0,
                         **dict(solver_kw or {}))
