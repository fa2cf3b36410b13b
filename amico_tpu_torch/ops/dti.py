"""Batched log-linear DTI fit for principal-direction estimation
(counterpart of ``amico_tpu.ops.dti``).

OLS only, the facade's default ('DTI_fit_method', core.py): one
pseudo-inverse product on the log signal and an analytic principal
eigenvector.  WLS, NLLS and RESTORE are ROADMAP queue 1 ("ops/dti.py").
"""
from __future__ import annotations

import math

import numpy as np
import torch

MIN_SIGNAL = 1e-6  # clamp for log(); data is b0-normalized upstream

_METHODS = ('OLS', 'LS', 'WLS', 'NLLS', 'RT', 'RESTORE')


def design_matrix(b: np.ndarray, g: np.ndarray) -> np.ndarray:
    """(nS, 7) log-linear DTI design matrix (a copy of the JAX package's,
    whose module imports jax).

    Columns: Dxx, Dyy, Dzz, Dxy, Dxz, Dyz, log(S0) with
    log S = -b (gx^2 Dxx + gy^2 Dyy + gz^2 Dzz + 2 gx gy Dxy
              + 2 gx gz Dxz + 2 gy gz Dyz) + log S0.
    """
    b = np.asarray(b, np.float64)
    g = np.asarray(g, np.float64)
    B = np.empty((b.shape[0], 7))
    B[:, 0] = -b * g[:, 0] ** 2
    B[:, 1] = -b * g[:, 1] ** 2
    B[:, 2] = -b * g[:, 2] ** 2
    B[:, 3] = -2 * b * g[:, 0] * g[:, 1]
    B[:, 4] = -2 * b * g[:, 0] * g[:, 2]
    B[:, 5] = -2 * b * g[:, 1] * g[:, 2]
    B[:, 6] = 1.0
    return B


def principal_eigenvector(D: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the largest eigenvalue of symmetric (..., 3, 3) D.

    Analytic (trigonometric) eigenvalues + product-of-shifted-matrices
    eigenvector: columns of (D - l2 I)(D - l3 I) span the l1 eigenspace.
    Degenerate (isotropic) voxels fall back to +z, as in the JAX package.
    """
    tr = D.diagonal(dim1=-2, dim2=-1).sum(-1)
    q = tr / 3.0
    I3 = torch.eye(3, dtype=D.dtype, device=D.device)
    Dq = D - q[..., None, None] * I3
    p2 = (Dq * Dq).sum((-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    detB = torch.linalg.det(Dq / p[..., None, None])
    phi = torch.arccos(torch.clamp(detB / 2.0, -1.0, 1.0)) / 3.0
    l1 = q + 2.0 * p * torch.cos(phi)
    l3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l2 = tr - l1 - l3
    M = (D - l2[..., None, None] * I3) @ (D - l3[..., None, None] * I3)
    norms = torch.linalg.norm(M, dim=-2)             # column norms
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(M, -1, best[..., None, None].expand(
        *M.shape[:-1], 1))[..., 0]
    vn = torch.linalg.norm(v, dim=-1, keepdim=True)
    ez = torch.zeros_like(v)
    ez[..., 2] = 1.0
    anisotropic = (p2 > 1e-24)[..., None] & (vn > 1e-20)
    return torch.where(anisotropic, v / torch.clamp(vn, min=1e-30), ez)


def _tensors_from_params(p: torch.Tensor) -> torch.Tensor:
    """(..., 7) params -> (..., 3, 3) symmetric tensors."""
    Dxx, Dyy, Dzz, Dxy, Dxz, Dyz = (p[..., i] for i in range(6))
    return torch.stack([torch.stack([Dxx, Dxy, Dxz], -1),
                        torch.stack([Dxy, Dyy, Dyz], -1),
                        torch.stack([Dxz, Dyz, Dzz], -1)], -2)


def fit_dti(y: torch.Tensor, b: np.ndarray, g: np.ndarray,
            method: str = 'OLS') -> torch.Tensor:
    """Fit the diffusion tensor per voxel; return principal directions.

    y: (N, nS) float32 signals on the fit's device (clamped to MIN_SIGNAL
    before the log); b, g: scheme.  Returns (N, 3) unit vectors on y's
    device."""
    meth = method.upper()
    if meth not in _METHODS:
        raise ValueError(f'unknown DTI fit method {method!r}; choose one '
                         'of OLS, LS, WLS, NLLS, RT, RESTORE')
    if meth not in ('OLS', 'LS'):
        raise NotImplementedError(
            f'DTI_fit_method {method!r} is not ported yet (ROADMAP queue 1, '
            '"ops/dti.py": WLS, NLLS, RESTORE); use OLS')
    pinv = torch.as_tensor(np.linalg.pinv(design_matrix(b, g)),
                           dtype=y.dtype, device=y.device)        # (7, nS)
    logy = torch.log(torch.clamp(y, min=MIN_SIGNAL))
    params = logy @ pinv.T
    return principal_eigenvector(_tensors_from_params(params))
