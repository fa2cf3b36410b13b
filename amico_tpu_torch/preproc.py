"""Preprocessing: Rician-bias removal (counterpart of ``amico_tpu.preproc``).

The reference debiases each voxel by L-BFGS-B minimization of Kaden's SMT
functional over the whole signal vector.  The functional is *separable per
sample*: each measurement S contributes (S - g(E))^2 with

    g(E) = sigma sqrt(pi/2) L_{1/2}(-E^2/(2 sigma^2))

the Rician mean.  As the JAX package does, the port inverts g directly with
a vectorized, fixed-iteration Newton solve over all (voxel, sample) pairs
at once, in float32, using the stable Bessel form

    L_{1/2}(-x) = e^{-x/2} ((1+x) I0(x/2) + x I1(x/2)).

Where the JAX package differentiates g with ``jax.grad``, the port uses the
closed form: with z = x/2, d/dx [(1+x) i0e(z) + x i1e(z)] reduces to
(i0e(z) + i1e(z))/2, so dg/dx = k (i0e(x/2) + i1e(x/2))/2 (k/2 at x = 0).

Semantics match the reference: sigma = mean(b0)/SNR per voxel; voxels
outside the mask are returned as 0.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .device import resolve_device


def _rician_mean(E, sigma):
    """g(E) = E[Rician(E, sigma)], elementwise on tensors."""
    x = E * E / (2.0 * sigma * sigma + 1e-30)
    half = x / 2.0
    lag = (1.0 + x) * torch.special.i0e(half) + x * torch.special.i1e(half)
    return sigma * math.sqrt(math.pi / 2.0) * lag


def _g_and_dg(x, k):
    """g(x) = k ((1+x) i0e(x/2) + x i1e(x/2)), the Rician mean as a function
    of x = E^2/(2 sigma^2) with k = g(0), and dg/dx in closed form."""
    half = x / 2.0
    i0, i1 = torch.special.i0e(half), torch.special.i1e(half)
    return k * ((1.0 + x) * i0 + x * i1), k * (i0 + i1) / 2.0


def debias_rician_batch(signal, sigma, iters: int = 50) -> torch.Tensor:
    """Invert the Rician mean per sample: find E >= 0 with g(E) = S.

    signal: tensor of measured magnitudes; sigma broadcastable to it.
    Samples below the Rician noise floor g(0) = sigma sqrt(pi/2) map to 0.

    Newton runs in the variable x = E^2 / (2 sigma^2): dg/dE vanishes at
    E = 0, which makes Newton-in-E blow up for signals just above the
    noise floor, while dg/dx -> floor/2 > 0 stays bounded away from zero.
    """
    S = signal
    sigma = torch.broadcast_to(torch.as_tensor(sigma, dtype=S.dtype,
                                                device=S.device), S.shape)
    k = sigma * math.sqrt(math.pi / 2.0)               # = g(0), noise floor
    # sigma == 0 means no noise: the Rician mean IS the signal.  Guarding
    # here also keeps x0 = S^2/(2 sigma^2) from overflowing to inf
    sig2 = 2.0 * sigma * sigma
    noisy = sig2 > 0.0
    x = torch.where(noisy, torch.clamp(S * S - sig2, min=0.0)
                    / torch.where(noisy, sig2, torch.ones_like(sig2)),
                    torch.zeros_like(S))
    for _ in range(iters):
        g, dg = _g_and_dg(x, k)
        x = torch.clamp(x - (g - S) / torch.clamp(dg, min=1e-12), min=0.0)
    E = sigma * torch.sqrt(2.0 * x)
    return torch.where(noisy, torch.where(S <= k, torch.zeros_like(E), E), S)


def debiasRician(DWI, SNR, mask, scheme, device=None):
    """Reference-compatible entry point: 4-D DWI volume, scalar SNR, 3-D
    mask, Scheme.  Returns the debiased float32 volume (zeros outside the
    mask).  The solve runs on ``device``, resolved as the ``device`` config
    key is (None: the card)."""
    dev = resolve_device(device)
    DWI = np.asarray(DWI)
    mask = np.asarray(mask) > 0
    vox = DWI[mask]                                      # (N, nS)
    b0 = vox[:, scheme.b0_idx].mean(axis=1)
    sigma = (b0 / SNR)[:, None]
    out = np.zeros(DWI.shape, dtype=np.float32)
    with torch.no_grad():
        debiased = debias_rician_batch(
            torch.from_numpy(np.ascontiguousarray(vox, np.float32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(sigma, np.float32)).to(dev))
    out[mask] = debiased.cpu().numpy()
    return out
