"""Batched DTI fit for principal-direction estimation (counterpart of
``amico_tpu.ops.dti``).

Every method of the JAX package, with its iteration counts, clips and
damping: 'OLS'/'LS' (one pseudo-inverse product on the log signal), 'WLS'
(weighted by the squared OLS-predicted signal), 'NLLS' (signal-space
Levenberg-Marquardt from WLS, 12 steps) and 'RESTORE'/'RT' (NLLS, four
Geman-McClure reweighted rounds of 2 steps, then an 8-step refit on the
inliers within 3 robust sigmas), then an analytic principal eigenvector.

Three departures from a literal transcription, none of them in the
arithmetic's meaning:
- ``torch.median`` returns the lower middle value; ``jnp.median`` the mean
  of the two, which :func:`_median` computes.
- The 7x7 systems are solved with ``torch.linalg.solve_ex``, which neither
  raises on a singular system nor syncs with the host; as in the JAX
  package, a non-finite step is rejected by the LM loop's ``isfinite``.
- ``J'WJ`` and ``J'Wr`` are products of an (N, nS) weight matrix with the
  design's (nS, 49) column products and (nS, 7) columns, instead of the
  JAX package's (N, nS, 7) Jacobians: the same sums, without two 1.1 GB
  tensors on a full brain.
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


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last dimension, keeping it, as ``jnp.median``: the
    mean of the two middle values for an even count."""
    v = torch.sort(x, dim=-1).values
    k = x.shape[-1] // 2
    if x.shape[-1] % 2:
        return v[..., k:k + 1]
    return 0.5 * (v[..., k - 1:k] + v[..., k:k + 1])


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched A^-1 b for (N, 7, 7) A and (N, 7) b; inf/NaN rows where A is
    singular."""
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


def _normal_matrix(w: torch.Tensor, BB: torch.Tensor) -> torch.Tensor:
    """sum_n w[v, n] B[n, p] B[n, q] as (N, 7, 7); ``BB`` (nS, 49)."""
    return (w @ BB).view(w.shape[0], 7, 7)


def _lm_refine(params: torch.Tensor, B: torch.Tensor, BB: torch.Tensor,
               y: torch.Tensor, w: torch.Tensor, iters: int) -> torch.Tensor:
    """Fixed-iteration batched Levenberg-Marquardt on the signal-space
    objective ``sum_n w_n (y_n - exp(B_n p))^2``, as the JAX package's
    ``_lm_refine``: per-voxel damping adapts by accept/reject, and rejected
    steps keep the old parameters."""
    def cost(p):
        pred = torch.exp(torch.clamp(p @ B.T, -60.0, 60.0))
        r = y - pred
        return pred, r, (w * r * r).sum(-1)

    eye = torch.eye(7, dtype=params.dtype, device=params.device)
    p = params
    _, _, c = cost(p)
    lam = torch.full(params.shape[:-1], 1e-3, dtype=params.dtype,
                     device=params.device)
    for _ in range(iters):
        pred, r, _ = cost(p)
        wp = w * pred                                   # J = pred * B
        grad = (wp * r) @ B
        H = _normal_matrix(wp * pred, BB)
        diagH = H.diagonal(dim1=-2, dim2=-1)
        damp = lam[..., None] * torch.clamp(diagH, min=1e-12) + 1e-12
        p_new = p + _solve(H + damp[..., None] * eye, grad)
        _, _, c_new = cost(p_new)
        ok = torch.isfinite(c_new) & (c_new < c)
        p = torch.where(ok[..., None], p_new, p)
        lam = torch.where(ok, lam / 3.0, lam * 4.0)
        c = torch.where(ok, c_new, c)
    return p


def _restore(params: torch.Tensor, B: torch.Tensor, BB: torch.Tensor,
             y: torch.Tensor, nlls_iters: int = 8,
             irls_rounds: int = 4) -> torch.Tensor:
    """Robust tensor fit (RESTORE, Chang/Jones/Pierpaoli MRM 2005), as the
    JAX package's ``_restore``: plain NLLS; Geman-McClure reweighted NLLS
    with the robust scale C = 1.4826 MAD about the per-voxel median
    residual; a refit on the samples within 3C.  Voxels with no outlier
    keep the plain-NLLS parameters."""
    p_nlls = _lm_refine(params, B, BB, y, torch.ones_like(y), nlls_iters)

    def center_scale(p):
        r = y - torch.exp(torch.clamp(p @ B.T, -60.0, 60.0))
        rc = r - _median(r)
        return rc, torch.clamp(1.4826 * _median(rc.abs()), min=1e-8)

    p = p_nlls
    for _ in range(irls_rounds):
        rc, C = center_scale(p)
        p = _lm_refine(p, B, BB, y, 1.0 / (rc * rc + C * C), 2)
    rc, C = center_scale(p)
    inlier = (rc.abs() <= 3.0 * C).to(y.dtype)
    has_outlier = (inlier == 0).any(-1)
    p_in = _lm_refine(p, B, BB, y, inlier, nlls_iters)
    return torch.where(has_outlier[..., None], p_in, p_nlls)


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
    Bd = design_matrix(b, g)
    on = dict(dtype=y.dtype, device=y.device)
    pinv = torch.as_tensor(np.linalg.pinv(Bd), **on)              # (7, nS)
    logy = torch.log(torch.clamp(y, min=MIN_SIGNAL))
    params = logy @ pinv.T
    if meth not in ('OLS', 'LS'):
        # WLS: weights = squared OLS-predicted signal (also the NLLS and
        # RESTORE starting point)
        B = torch.as_tensor(Bd, **on)
        BB = (B[:, :, None] * B[:, None, :]).reshape(B.shape[0], 49)
        w = torch.exp(2.0 * (params @ B.T))
        lhs = _normal_matrix(w, BB) + 1e-12 * torch.eye(7, **on)
        params = _solve(lhs, (w * logy) @ B)
        y_sig = torch.clamp(y, min=MIN_SIGNAL)
        if meth == 'NLLS':
            params = _lm_refine(params, B, BB, y_sig, torch.ones_like(y_sig),
                                12)
        elif meth in ('RT', 'RESTORE'):
            params = _restore(params, B, BB, y_sig)
    return principal_eigenvector(_tensors_from_params(params))
