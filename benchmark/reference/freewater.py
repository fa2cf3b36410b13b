"""AMICO's FreeWater (``models.pyx:995-1286``), voxel by voxel: one
non-negative elastic net on the zeppelins and balls; maps FiberVolume and
FW; the corrected DWI is the signal less the balls' prediction, clipped
at 0 (in units of the mean b0).

The atoms: zeppelins ``exp(-b (d_perp + (d_par - d_perp) cos^2))`` and
balls ``exp(-b d_iso)``."""
from __future__ import annotations

import numpy as np

from .dictionary import hr_samples
from .qp import nonneg_elastic_net


def atoms(params: dict, shells: list[dict], grad: np.ndarray):
    """A zeppelin a ``d_perps`` entry and a ball a ``d_isos`` entry along
    +z; no extras."""
    b_hr, cos_t = hr_samples(shells, grad)
    dpar = params['d_par']
    aniso = [np.exp(-b_hr * (dp + (dpar - dp) * cos_t ** 2))
             for dp in params['d_perps']]
    iso = [np.exp(-b_hr * di) for di in params['d_isos']]
    return np.array(aniso), np.array(iso), {}


def work(params: dict, n_samples: int, n_dwi: int) -> dict:
    """One stage: every atom on every sample."""
    n_aniso, n_iso = len(params['d_perps']), len(params['d_isos'])
    return {'n_aniso': n_aniso, 'n_iso': n_iso,
            'stages': [(n_samples, n_aniso + n_iso)]}


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
