"""The reference's dictionaries, worked out again from a configuration.

A frozen copy of the AMICO v2.1.0 look-up-table recipe (``lut.pyx``,
``synthesis.py``), in plain NumPy: each atom's signal is synthesised along
+z on 500 high-resolution directions per shell, fitted with even real
spherical harmonics up to ``lmax``, rotated to each of the ``ndirs`` LUT
directions by the zonal-harmonic rule and sampled on the subject's
gradient directions.  b=0 samples are 1.  The direction set and the
high-resolution gradient table are upstream AMICO's published tables
(``amico_tables.npz``).  The atoms along +z, and any extras, come from the
configuration's own module, ``reference/<reference>.py``.  Nothing here
imports the program.
"""
from __future__ import annotations

import os
from math import factorial

import numpy as np

from . import module

# the proton gyromagnetic ratio (rad/s/T) of AMICO's b-value and timing
# conversions (``synthesis.py``, ``scheme.py``)
GAMMA = 2.675987e8
TIMING = ('G', 'Delta', 'delta', 'TE')
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


def legendre_all(lmax, x):
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
    P = legendre_all(lmax, np.cos(theta))
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


# ------------------------------------------------------------ dictionaries
def shells(bvals, pulses=None) -> list[tuple[dict, np.ndarray]]:
    """The protocol's shells in first-appearance order, keyed by b and, with
    ``pulses`` (nS, 4: G, Delta, delta, TE), the timing: for each, the
    record a model's ``atoms`` receives (``b``, and the timing or None) and
    the shell's rows.  b=0 rows belong to no shell."""
    rows_of: dict[tuple, list[int]] = {}
    for i, b in enumerate(np.asarray(bvals, np.float64)):
        if b > 0:
            t = (None,) * 4 if pulses is None else map(float, pulses[i])
            rows_of.setdefault((float(b), *t), []).append(i)
    return [(dict(zip(('b',) + TIMING, key)), np.array(rows))
            for key, rows in rows_of.items()]


def hr_samples(shells: list[dict], grad: np.ndarray):
    """(b (n_hr,), cos of the angle to +z (n_hr,)) of the high-resolution
    samples of ``shells``: shell-major, a row of ``grad`` each."""
    return (np.repeat(np.array([s['b'] for s in shells]), grad.shape[0]),
            np.tile(grad[:, 2], len(shells)))


def build(config: dict, bvals, bvecs, pulses=None) -> dict:
    """The configuration's dictionary on the subject's protocol (with
    ``pulses``, its timing a sample, as ``shells`` takes it) at every LUT
    direction: ``aniso`` (ndirs, nS, n_aniso) and ``iso`` (nS, n_iso)
    float64, the LUT ``dirs`` (ndirs, 3), the quantizer ``htable`` and the
    model's per-atom extras."""
    model = module(config['reference'])
    lmax, ndirs = int(config['lut']['lmax']), int(config['lut']['ndirs'])
    dirs, grad = tables()
    if ndirs != dirs.shape[0]:
        raise ValueError('the frozen tables hold the 500-direction set only')
    bvals = np.asarray(bvals, np.float64)
    bvecs = np.asarray(bvecs, np.float64).copy()
    bvecs[bvecs[:, 1] < 0] *= -1
    groups = shells(bvals, pulses)
    aniso_z, iso_z, extra = model.atoms(config['model_params'],
                                        [rec for rec, _ in groups], grad)
    B = sh_basis(lmax, grad)
    fit = np.linalg.pinv(B.T @ B) @ B.T                      # (nSH, 500)
    idx0, const = _zonal(lmax)
    Yrot = sh_basis(lmax, dirs)                              # (ndirs, nSH)
    nS = bvals.size
    A = np.ones((ndirs, nS, aniso_z.shape[0]))
    I = np.ones((nS, iso_z.shape[0]))
    n_hr = grad.shape[0]
    for s, (_, rows) in enumerate(groups):
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
    if hasattr(model, 'add_extras'):
        model.add_extras(out, bvals)
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
