"""AMICO's FreeWater (``models.pyx:995-1286``), voxel by voxel: one
non-negative elastic net on the zeppelins and balls; maps FiberVolume and
FW; the corrected DWI is the signal less the balls' prediction, clipped
at 0 (in units of the mean b0)."""
from __future__ import annotations

import numpy as np

from .qp import nonneg_elastic_net


def solve(config, D, y, lut, lambdas, want_dwi, q, bvals):
    n_perp = D['aniso'].shape[2]
    iso = q(D['iso'])
    maps = np.zeros((y.shape[0], 2))
    dwi = np.zeros(y.shape) if want_dwi else None
    for i in range(y.shape[0]):
        A = np.column_stack([q(D['aniso'][lut[i]]), iso])
        x = nonneg_elastic_net(A, y[i], *lambdas[i])
        v = x[:n_perp].sum() / (x.sum() + 1e-16)
        maps[i] = (v, 1 - v)
        if want_dwi:
            dwi[i] = np.clip(y[i] - iso @ x[n_perp:], 0, None)
    return {'maps': maps, 'dwi': dwi}
