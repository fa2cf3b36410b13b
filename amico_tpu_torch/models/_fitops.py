"""Shared per-tile pieces of the model fit functions, in float32
(counterpart of ``amico_tpu.models._fitops``)."""
from __future__ import annotations

import torch


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
