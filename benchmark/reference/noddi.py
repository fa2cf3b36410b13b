"""NODDI as AMICO v2.1.0 fits it (``models.pyx:656-790``), voxel by voxel:
(1) NNLS on the whole dictionary, for the isotropic fraction; (2) the
non-negative elastic net on the norm-scaled DWI rows with the isotropic
prediction subtracted and clipped at 0; (3) NNLS on the positive support
of (2) with the isotropic atom, on all rows.  Maps NDI, ODI, FWF."""
from __future__ import annotations

import numpy as np

from .qp import nonneg_elastic_net, nonneg_lsq


def solve(config, D, y, lut, lambdas, want_dwi, q, bvals):
    dwi = np.nonzero(np.asarray(bvals) > 0)[0]
    n_wm = D['aniso'].shape[2]
    icvf, kappa = D['icvf'], D['kappa']
    iso = q(D['iso'][:, 0])
    maps = np.zeros((y.shape[0], 3))
    for i in range(y.shape[0]):
        A = np.column_stack([q(D['aniso'][lut[i]]), iso])
        x1 = nonneg_lsq(A, y[i])
        y2 = np.clip(y[i, dwi] - x1[-1] * iso[dwi], 0, None)
        A2 = q(A[dwi, :n_wm] * D['norms'][None])
        x2 = nonneg_elastic_net(A2, y2, *lambdas[i])
        sup = np.append(x2 > 0, True)
        x = np.zeros(n_wm + 1)
        x[sup] = nonneg_lsq(A[:, sup], y[i])
        sa = x.sum() + 1e-16
        xn = x[:n_wm] / sa
        sw = xn.sum() + 1e-16
        f1 = np.sum(icvf * xn) / sw
        f2 = np.sum((1 - icvf) * xn) / sw
        k1 = np.sum(kappa * xn) / sw
        maps[i] = (f1 / (f1 + f2 + 1e-16), 2 / np.pi * np.arctan2(1.0, k1),
                   x[-1] / sa)
    return {'maps': maps}
