"""The reference's dictionaries, worked out again from a configuration.

A frozen copy of the AMICO v2.1.0 look-up-table recipe (``lut.pyx``,
``synthesis.py``), in plain NumPy: each atom's signal is synthesised along
+z on 500 high-resolution directions per shell, fitted with even real
spherical harmonics up to ``lmax``, rotated to each of the ``ndirs`` LUT
directions by the zonal-harmonic rule and sampled on the subject's
gradient directions.  b=0 samples are 1.  The direction set and the
high-resolution gradient table are upstream AMICO's published tables
(``amico_tables.npz``).  Nothing here imports the program.

Models:
- ``noddi``: Watson-dispersed sticks plus a hindered zeppelin on the
  (IC_OD, IC_VF) grid, OD-major, and one isotropic atom (Zhang et al.,
  NeuroImage 2012), with ``norms`` = 1 / |atom's DWI samples at LUT
  direction 0|, as AMICO scales its stage-2 dictionary.
- ``freewater``: zeppelins ``exp(-b (d_perp + (d_par - d_perp) cos^2))``
  and balls ``exp(-b d_iso)``.
"""
from __future__ import annotations

import os
from math import factorial

import numpy as np
from scipy.special import dawsn, erf

GAMMA = 2.675987e8
_TABLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       'amico_tables.npz')


def tables() -> tuple[np.ndarray, np.ndarray]:
    """(LUT directions (500, 3), high-resolution gradients (500, 3))."""
    with np.load(_TABLES) as z:
        return z['dirs_500'], z['highres_grad']


# ---------------------------------------------------------------- SH basis
def _cart2sphere(v):
    v = np.asarray(v, np.float64)
    r = np.linalg.norm(v, axis=-1)
    theta = np.arccos(np.clip(np.divide(v[..., 2], r, out=np.zeros_like(r),
                                        where=r > 0), -1, 1))
    return theta, np.arctan2(v[..., 1], v[..., 0])


def _legendre_all(lmax, x):
    x = np.asarray(x, np.float64)
    P = np.zeros((lmax + 1, lmax + 1) + x.shape)
    P[0, 0] = 1.0
    s = np.sqrt(np.clip(1.0 - x * x, 0.0, None))
    for m in range(1, lmax + 1):
        P[m, m] = -(2 * m - 1) * s * P[m - 1, m - 1]
    for m in range(lmax):
        P[m + 1, m] = (2 * m + 1) * x * P[m, m]
    for m in range(lmax + 1):
        for l in range(m + 2, lmax + 1):
            P[l, m] = ((2 * l - 1) * x * P[l - 1, m]
                       - (l + m - 1) * P[l - 2, m]) / (l - m)
    return P


def sh_basis(lmax, v):
    """Real even-order SH basis at unit vectors ``v`` (N, 3): (N, nSH)."""
    theta, phi = _cart2sphere(v)
    P = _legendre_all(lmax, np.cos(theta))
    cols = []
    for l in range(0, lmax + 1, 2):
        for m in range(-l, l + 1):
            am = abs(m)
            n = np.sqrt((2 * l + 1) / (4 * np.pi)
                        * factorial(l - am) / factorial(l + am))
            if m == 0:
                cols.append(n * P[l, 0])
            elif m > 0:
                cols.append(np.sqrt(2) * n * P[l, am] * np.cos(am * phi))
            else:
                cols.append(np.sqrt(2) * n * P[l, am] * np.sin(am * phi))
    return np.stack(cols, -1)


def _zonal(lmax):
    """Per column: the index of its degree's m = 0 column and
    sqrt(4 pi / (2l + 1))."""
    idx, const = [], []
    for l in range(0, lmax + 1, 2):
        c0 = (l // 2) * (l - 1) + l
        idx += [c0] * (2 * l + 1)
        const += [np.sqrt(4 * np.pi / (2 * l + 1))] * (2 * l + 1)
    return np.array(idx), np.array(const)


# ------------------------------------------------------- compartment signals
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
    P = _legendre_all(12, np.clip(cos_t, -1, 1))
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


# ------------------------------------------------------------ dictionaries
def atoms_along_z(model: dict, b_hr, grad):
    """The model's atoms along +z on the high-resolution samples: (n_aniso,
    n_hr) and (n_iso, n_hr) float64, plus per-atom extras."""
    cos_t = grad[:, 2] if grad.ndim == 2 else grad
    cos_t = np.tile(cos_t, b_hr.size // cos_t.size)
    kind = model['reference']
    if kind == 'noddi':
        ods = np.asarray(model['IC_ODs'], np.float64)
        vfs = np.asarray(model['IC_VFs'], np.float64)
        aniso, icvf, kappa = [], [], []
        for od in ods:
            k = 1 / np.tan(od * np.pi / 2)
            ic = _noddi_ic(b_hr, cos_t, model['dPar'], k)
            for v in vfs:
                aniso.append(v * ic + (1 - v)
                             * _noddi_ec(b_hr, cos_t, model['dPar'], k, v))
                icvf.append(v)
                kappa.append(k)
        iso = [_noddi_iso(b_hr, model['dIso'])]
        return np.array(aniso), np.array(iso), {
            'icvf': np.array(icvf), 'kappa': np.array(kappa)}
    if kind == 'freewater':
        dpar = model['d_par']
        aniso = [np.exp(-b_hr * (dp + (dpar - dp) * cos_t ** 2))
                 for dp in model['d_perps']]
        iso = [np.exp(-b_hr * di) for di in model['d_isos']]
        return np.array(aniso), np.array(iso), {}
    raise ValueError(f'no reference dictionary for {kind!r}')


def build(config: dict, bvals, bvecs) -> dict:
    """The configuration's dictionary on the subject's protocol at every LUT
    direction: ``aniso`` (ndirs, nS, n_aniso) and ``iso`` (nS, n_iso)
    float64, the LUT ``dirs`` (ndirs, 3), the quantizer ``htable`` and the
    per-atom extras (NODDI: icvf, kappa, norms)."""
    model = dict(config['model_params'], reference=config['reference'])
    lmax, ndirs = int(config['lut']['lmax']), int(config['lut']['ndirs'])
    dirs, grad = tables()
    if ndirs != dirs.shape[0]:
        raise ValueError('the frozen tables hold the 500-direction set only')
    bvals = np.asarray(bvals, np.float64)
    bvecs = np.asarray(bvecs, np.float64).copy()
    bvecs[bvecs[:, 1] < 0] *= -1
    shells = list(dict.fromkeys(float(b) for b in bvals if b > 0))
    b_hr = np.repeat(np.array(shells), grad.shape[0])
    aniso_z, iso_z, extra = atoms_along_z(model, b_hr, grad)
    B = sh_basis(lmax, grad)
    fit = np.linalg.pinv(B.T @ B) @ B.T                      # (nSH, 500)
    idx0, const = _zonal(lmax)
    Yrot = sh_basis(lmax, dirs)                              # (ndirs, nSH)
    nS = bvals.size
    A = np.ones((ndirs, nS, aniso_z.shape[0]))
    I = np.ones((nS, iso_z.shape[0]))
    n_hr = grad.shape[0]
    for s, b in enumerate(shells):
        rows = np.nonzero(bvals == b)[0]
        Yout = sh_basis(lmax, bvecs[rows])                   # (n_s, nSH)
        hr = slice(s * n_hr, (s + 1) * n_hr)
        klm = aniso_z[:, hr] @ fit.T                         # (n_an, nSH)
        zon = const[None] * klm[:, idx0]
        # rotated kernel at LUT direction i, sampled on this shell
        rot = Yrot[:, None, :] * zon[None]                   # (ndirs, n_an, nSH)
        A[:, rows, :] = np.transpose(rot @ Yout.T, (0, 2, 1))
        I[rows, :] = (iso_z[:, hr] @ fit.T @ Yout.T).T
    out = {'aniso': A, 'iso': I, 'dirs': dirs, 'htable': hash_table(dirs)}
    out.update(extra)
    if model['reference'] == 'noddi':
        dwi = np.nonzero(bvals > 0)[0]
        out['norms'] = 1.0 / np.linalg.norm(A[0][dwi], axis=0)
    return out


def hash_table(dirs: np.ndarray) -> np.ndarray:
    """AMICO's 181 x 181 quantizer: the nearest LUT direction (by |dot|,
    in float32 as upstream's shipped tables) of each 1-degree grid point."""
    t = np.deg2rad(np.arange(181.0))
    th, ph = np.meshgrid(t, t, indexing='ij')
    grid = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                     np.cos(th)], -1).reshape(-1, 3).astype(np.float32)
    return np.argmax(np.abs(grid @ dirs.T.astype(np.float32)), 1)


def lut_index(v: np.ndarray, htable: np.ndarray) -> np.ndarray:
    """AMICO's direction quantizer (lut.pyx:314-356) for (..., 3) vectors."""
    d = np.asarray(v, np.float64)
    d = np.where((d[..., 1] < 0)[..., None], -d, d)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    a = np.mod(np.arctan2(y, x), 2 * np.pi)
    gt = a > np.pi
    rho = np.hypot(x, y)
    i1 = np.where(gt, np.arctan2(rho, -z), np.arctan2(rho, z))
    i2 = np.where(gt, np.mod(np.arctan2(-y, -x), 2 * np.pi), a)
    i1 = np.rint(i1 / np.pi * 180).astype(np.int64)
    i2 = np.rint(i2 / np.pi * 180).astype(np.int64)
    return np.asarray(htable)[i1 * 181 + i2]
