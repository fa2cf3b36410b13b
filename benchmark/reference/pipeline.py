"""The reference's fit of sampled voxels: the steps of the program's main
path, worked out again in float64 NumPy from the raw signal.

For each voxel: the b0 normalisation (division by the mean of the b=0
samples), the OLS diffusion tensor on the log signal and its principal
eigenvector, AMICO's direction quantizer, then the model's solve
(``reference/<reference>.py``) on the dictionary of that LUT direction.

``precision='tf32'`` is the control: every operand of a product (the
signal, the dictionary, the DTI design) rounded to TF32's 10-bit mantissa
before it is used, as a float32 product with TF32 allowed would round it.
"""
from __future__ import annotations

import numpy as np

from . import dictionary, module


def to_tf32(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to the nearest TF32 value (8-bit exponent, 10-bit
    mantissa), returned as float64."""
    bits = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.astype(np.int32).view(np.float32).astype(np.float64)


def rounder(precision: str):
    if precision == 'float64':
        return lambda a: np.asarray(a, np.float64)
    if precision == 'tf32':
        return to_tf32
    raise ValueError(f'unknown precision {precision!r}')


def dti_directions(y: np.ndarray, bvals, bvecs, q) -> np.ndarray:
    """Principal eigenvectors (n, 3) of the OLS tensor fit of ``y``."""
    b = np.asarray(bvals, np.float64)
    g = np.asarray(bvecs, np.float64)
    B = np.column_stack([-b * g[:, 0] ** 2, -b * g[:, 1] ** 2,
                         -b * g[:, 2] ** 2, -2 * b * g[:, 0] * g[:, 1],
                         -2 * b * g[:, 0] * g[:, 2], -2 * b * g[:, 1] * g[:, 2],
                         np.ones_like(b)])
    p = q(np.log(np.maximum(y, 1e-6))) @ q(np.linalg.pinv(B)).T
    D = np.stack([np.stack([p[:, 0], p[:, 3], p[:, 4]], -1),
                  np.stack([p[:, 3], p[:, 1], p[:, 5]], -1),
                  np.stack([p[:, 4], p[:, 5], p[:, 2]], -1)], -2)
    return np.linalg.eigh(D)[1][..., -1]


def solve_voxels(config: dict, D: dict, raw: np.ndarray, bvals, bvecs,
                 lambdas: np.ndarray, want_dwi: bool,
                 precision: str = 'float64') -> dict:
    """Answers for voxels with raw signals ``raw`` (n, nS), each fitted
    with its own (lambda1, lambda2) row of ``lambdas``: ``maps`` (n, k),
    the mean b0 ``b0`` (n,), and with ``want_dwi`` the corrected DWI
    ``dwi`` (n, nS) in units of the mean b0."""
    q = rounder(precision)
    bvals = np.asarray(bvals, np.float64)
    raw = np.asarray(raw, np.float64)
    b0 = raw[:, bvals == 0].mean(1)
    y = np.where(b0[:, None] > 0, raw / np.where(b0 > 0, b0, 1)[:, None], 0)
    y = np.clip(y, 0, None)
    dirs = dti_directions(y, bvals, bvecs, q)
    lut = dictionary.lut_index(dirs, D['htable'])
    out = module(config['reference']).solve(config, D, q(y), lut, lambdas,
                                            want_dwi, q, bvals)
    out['b0'] = b0
    return out
