"""NODDI as AMICO v2.1.0 fits it (``models.pyx:656-790``), voxel by voxel:
(1) NNLS on the whole dictionary, for the isotropic fraction; (2) the
non-negative elastic net on the norm-scaled DWI rows with the isotropic
prediction subtracted and clipped at 0; (3) NNLS on the positive support
of (2) with the isotropic atom, on all rows.  Maps NDI, ODI, FWF.

The atoms (Zhang et al., NeuroImage 2012): Watson-dispersed sticks plus a
hindered zeppelin on the (IC_OD, IC_VF) grid, OD-major, and one isotropic
atom; their timing derived from b, as AMICO's ``scheme2noddi`` does, so a
protocol's own timing is not read.  ``norms`` = 1 / |atom's DWI samples at
LUT direction 0|, as AMICO scales its stage-2 dictionary."""
from __future__ import annotations

import numpy as np
from scipy.special import dawsn, erf

from .dictionary import GAMMA, hr_samples, legendre_all
from .qp import nonneg_elastic_net, nonneg_lsq


def _noddi_protocol(b_hr):
    """NODDI's PGSE protocol from b-values (AMICO ``scheme2noddi``: G, Delta
    and delta from b with Gmax = 40 mT/m)."""
    maxb = b_hr.max()
    gmax = 0.04
    t = np.power(3 * maxb * 1e6 / (2 * GAMMA * GAMMA * gmax * gmax), 1 / 3)
    g = np.sqrt(b_hr / maxb) * gmax
    return g, t, t


def _lgi(x, n=6):
    """Legendre-Gaussian integrals (AMICO synthesis.py:600-656)."""
    x = np.asarray(x, np.float64)
    exact = x > 0.05
    xs = np.where(exact, x, 1.0)
    I = np.zeros(x.shape + (n + 1,))
    sq = np.sqrt(xs)
    I[..., 0] = np.sqrt(np.pi) * erf(sq) / sq
    emx = -np.exp(-xs)
    for i in range(1, n + 1):
        I[..., i] = (emx + (i - 0.5) * I[..., i - 1]) / xs
    c = [[1.0], [-0.5, 1.5], [0.375, -3.75, 4.375],
         [-0.3125, 6.5625, -19.6875, 14.4375],
         [0.2734375, -9.84375, 54.140625, -93.84375, 50.2734375],
         [-63 / 256, 3465 / 256, -30030 / 256, 90090 / 256, -109395 / 256,
          46189 / 256],
         [231 / 1024, -18018 / 1024, 225225 / 1024, -1021020 / 1024,
          2078505 / 1024, -1939938 / 1024, 676039 / 1024]]
    L = np.zeros(x.shape + (n + 1,))
    for i in range(n + 1):
        L[..., i] = sum(c[i][j] * I[..., j] for j in range(i + 1))
    A = np.zeros_like(L)
    A[..., 0] = 2 - 2 * x / 3 + x ** 2 / 5 - x ** 3 / 21 + x ** 4 / 108
    A[..., 1] = -4 * x / 15 + 4 * x ** 2 / 35 - 2 * x ** 3 / 63 \
        + 2 * x ** 4 / 297
    A[..., 2] = 8 * x ** 2 / 315 - 8 * x ** 3 / 693 + 4 * x ** 4 / 1287
    A[..., 3] = -16 * x ** 3 / 9009 + 16 * x ** 4 / 19305
    A[..., 4] = 32 * x ** 4 / 328185
    A[..., 5] = -64 * x ** 5 / 14549535
    A[..., 6] = 128 * x ** 6 / 760543875
    return np.where(exact[..., None], L, A)


def _watson_sh(kappa):
    """Even SH coefficients l = 0..12 of a Watson distribution (AMICO
    synthesis.py:658-759)."""
    C = np.zeros(7)
    C[0] = 2 * np.sqrt(np.pi)
    k = float(kappa)
    sk = np.sqrt(k)
    s = [sk * k ** i for i in range(7)]
    kk = [k ** i for i in range(7)]
    d = dawsn(sk)
    e = 0.5 * np.sqrt(np.pi) / d if d != 0 else np.inf
    if 0.1 < k <= 30:
        C[1] = np.sqrt(5) * (3 * sk - (3 + 2 * k) * d) * e / k
        C[2] = 0.375 * ((105 + 60 * k + 12 * kk[2]) * d - 105 * sk
                        + 10 * s[1]) * e / kk[2]
        C[3] = ((-3465 - 1890 * k - 420 * kk[2] - 40 * kk[3]) * d
                + 3465 * sk - 420 * s[1] + 84 * s[2]) \
            * np.sqrt(13 * np.pi) / 64 / kk[3] / d
        C[4] = ((675675 + 360360 * k + 83160 * kk[2] + 10080 * kk[3]
                 + 560 * kk[4]) * d - 675675 * sk + 90090 * s[1]
                - 23100 * s[2] + 744 * s[3]) * np.sqrt(17) * e / 512 / kk[4]
        C[5] = ((-43648605 - 22972950 * k - 5405400 * kk[2] - 720720 * kk[3]
                 - 55440 * kk[4] - 2016 * kk[5]) * d + 43648605 * sk
                - 6126120 * s[1] + 1729728 * s[2] - 82368 * s[3]
                + 5104 * s[4]) * np.sqrt(21 * np.pi) / 4096 / kk[5] / d
        C[6] = ((7027425405 + 3666482820 * k + 872972100 * kk[2]
                 + 122522400 * kk[3] + 10810800 * kk[4] + 576576 * kk[5]
                 + 14784 * kk[6]) * d - 7027425405 * sk + 1018467450 * s[1]
                - 302630328 * s[2] + 17153136 * s[3] - 1553552 * s[4]
                + 25376 * s[5]) * 5 * e / 16384 / kk[6]
    elif k > 30:
        p = np.array([(np.log(k) - np.log(30)) ** i for i in range(7)])
        C[1:] = [p @ c for c in (
            [7.52308, 0.411538, -0.214588, 0.0784091, -0.023981, 0.00731537,
             -0.0026467],
            [8.93718, 1.62147, -0.733421, 0.191568, -0.0202906, -0.00779095,
             0.00574847],
            [8.87905, 3.35689, -1.15935, 0.0673053, 0.121857, -0.066642,
             0.0180215],
            [7.84352, 5.03178, -1.0193, -0.426362, 0.328816, -0.0688176,
             -0.0229398],
            [6.30113, 6.09914, -0.16088, -1.05578, 0.338069, 0.0937157,
             -0.106935],
            [4.65678, 6.30069, 1.13754, -1.38393, -0.0134758, 0.331686,
             -0.105954])]
    else:
        C[1] = (4 / 3 * k + 8 / 63 * kk[2]) * np.sqrt(np.pi / 5)
        C[2] = (8 / 21 * kk[2] + 32 / 693 * kk[3]) * (np.sqrt(np.pi) * 0.2)
        C[3] = (16 / 693 * kk[3] + 32 / 10395 * kk[4]) * np.sqrt(np.pi / 13)
        C[4] = (32 / 19305 * kk[4]) * np.sqrt(np.pi / 17)
        C[5] = 64 * np.sqrt(np.pi / 21) * kk[5] / 692835
        C[6] = 128 * np.sqrt(np.pi) * kk[6] / 152108775
    return C


def _noddi_ic(b_hr, cos_t, d_par, kappa):
    g, delta, small = _noddi_protocol(b_hr)
    q = GAMMA * small * g
    le_par = -q * q * (delta - small / 3) * d_par * 1e-6
    P = legendre_all(12, np.clip(cos_t, -1, 1))
    sh = np.stack([np.sqrt((i + 0.25) / np.pi) * P[2 * i, 0]
                   for i in range(7)], -1)
    E = np.sum(_lgi(-le_par) * _watson_sh(kappa)[None] * sh, 1)
    floor = np.min(E[E > 0]) if (E > 0).any() else 1.0
    return 0.5 * np.where(E <= 0, floor * 0.1, E)


def _noddi_ec(b_hr, cos_t, d_par, kappa, v_ic):
    g, delta, small = _noddi_protocol(b_hr)
    dpar = d_par * 1e-6
    dperp = dpar * (1 - v_ic)
    dd = dpar - dperp
    if kappa < 1e-5:
        s = dpar + 2 * dperp
        w0 = s / 3 + 4 * dd * kappa / 45 + 8 * dd * kappa ** 2 / 945
        w1 = s / 3 - 2 * dd * kappa / 45 - 4 * dd * kappa ** 2 / 945
    else:
        f = np.sqrt(kappa) / dawsn(np.sqrt(kappa))
        w0 = (-dd + 2 * dperp * kappa + dd * f) / (2 * kappa)
        w1 = (dd + 2 * (dpar + dperp) * kappa - dd * f) / (4 * kappa)
    q = GAMMA * small * g
    bv = (delta - small / 3) * q * q
    return np.exp(-bv * ((w0 - w1) * cos_t ** 2 + w1))


def _noddi_iso(b_hr, d_iso):
    g, delta, small = _noddi_protocol(b_hr)
    q = GAMMA * small * g
    return np.exp(-(delta - small / 3) * q * q * d_iso * 1e-6)


def atoms(params: dict, shells: list[dict], grad: np.ndarray):
    """The (IC_OD, IC_VF) grid's atoms and the isotropic one along +z, with
    each atom's ``icvf`` and ``kappa``."""
    b_hr, cos_t = hr_samples(shells, grad)
    aniso, icvf, kappa = [], [], []
    for od in np.asarray(params['IC_ODs'], np.float64):
        k = 1 / np.tan(od * np.pi / 2)
        ic = _noddi_ic(b_hr, cos_t, params['dPar'], k)
        for v in np.asarray(params['IC_VFs'], np.float64):
            aniso.append(v * ic + (1 - v)
                         * _noddi_ec(b_hr, cos_t, params['dPar'], k, v))
            icvf.append(v)
            kappa.append(k)
    iso = [_noddi_iso(b_hr, params['dIso'])]
    return np.array(aniso), np.array(iso), {
        'icvf': np.array(icvf), 'kappa': np.array(kappa)}


def add_extras(D: dict, bvals) -> None:
    """``norms``: AMICO's stage-2 scaling of each atom."""
    dwi = np.nonzero(np.asarray(bvals) > 0)[0]
    D['norms'] = 1.0 / np.linalg.norm(D['aniso'][0][dwi], axis=0)


def work(params: dict, n_samples: int, n_dwi: int) -> dict:
    """Two full stages: the whole dictionary on all samples, the
    white-matter atoms on the DWI samples; the debias reuses the first
    stage's projection on a data-dependent support, counted as nothing."""
    n_aniso = len(params['IC_ODs']) * len(params['IC_VFs'])
    return {'n_aniso': n_aniso, 'n_iso': 1,
            'stages': [(n_samples, n_aniso + 1), (n_dwi, n_aniso)]}


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
