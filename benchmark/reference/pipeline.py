"""The reference's fit of sampled voxels: the steps of the program's main
path, worked out again in float64 NumPy from the raw signal.

For each voxel: the b0 normalisation (division by the mean of the b=0
samples), the OLS diffusion tensor on the log signal and its principal
eigenvector, AMICO's direction quantizer, then the model's solve
(``reference/<reference>.py``) on the dictionary of that LUT direction.

A configuration's ``evaluation`` key states the facade settings the
harness applies before ``load_data``; only those whose preprocessing this
module mirrors are taken (``SETTINGS``).  With ``doDirectionalAverage``
(AMICO ``core.py``'s directional average, for a model without orientation)
the tensor and the quantizer are skipped: the normalised signal and the
dictionary are averaged over each shell, one b0 row first (the mean of the
b=0 samples) and the shells in ascending b, and the model's solve takes
them with no LUT index.

``precision='tf32'`` is the control: every operand of a product (the
signal, the dictionary, the DTI design) rounded to TF32's 10-bit mantissa
before it is used, as a float32 product with TF32 allowed would round it.
"""
from __future__ import annotations

import numpy as np

from . import dictionary, module

# the facade settings a configuration's ``evaluation`` key may state, with
# their type: each turns on a preprocessing step that ``solve_voxels``
# mirrors, so that the program and the reference fit the same signal
SETTINGS = {'doDirectionalAverage': bool}


def evaluation(config: dict) -> dict:
    """The configuration's facade settings (its ``evaluation`` key, {} when
    it has none); a setting this module does not mirror is refused."""
    settings = config.get('evaluation', {})
    if not isinstance(settings, dict):
        raise ValueError('"evaluation" is a dict of Evaluation.set_config '
                         'settings')
    for k, v in settings.items():
        if k not in SETTINGS:
            raise ValueError(
                f'evaluation setting {k!r} is not mirrored by the reference '
                f'(reference/pipeline.py takes {", ".join(SETTINGS)})')
        if type(v) is not SETTINGS[k]:
            raise ValueError(f'evaluation setting {k!r} is a '
                             f'{SETTINGS[k].__name__}, not {v!r}')
    return dict(settings)


def shell_rows(bvals, pulses=None) -> tuple[list[np.ndarray], np.ndarray]:
    """(the rows of each averaged sample, its b-value) in the order of the
    direction-averaged scheme: the b=0 rows first (b 0), then each shell,
    keyed by b and timing as ``dictionary.shells`` keys them, in ascending
    b (AMICO sorts the shells' b-values with ``np.argsort``)."""
    bvals = np.asarray(bvals, np.float64)
    groups = dictionary.shells(bvals, pulses)
    order = np.argsort([rec['b'] for rec, _ in groups])
    rows = [np.flatnonzero(bvals == 0)] + [groups[i][1] for i in order]
    return rows, np.array([0.0] + [groups[i][0]['b'] for i in order])


def shell_average(a: np.ndarray, rows: list[np.ndarray],
                  axis: int) -> np.ndarray:
    """``a`` with its samples along ``axis`` replaced by the mean of each
    group of ``rows``."""
    return np.stack([np.take(a, r, axis).mean(axis) for r in rows], axis)


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
                 precision: str = 'float64', pulses=None) -> dict:
    """Answers for voxels with raw signals ``raw`` (n, nS), each fitted
    with its own (lambda1, lambda2) row of ``lambdas``: ``maps`` (n, k),
    the mean b0 ``b0`` (n,), and with ``want_dwi`` the corrected DWI
    ``dwi`` (n, nS) in units of the mean b0.  ``pulses`` (nS, 4: G,
    Delta, delta, TE) keys the shells of a direction-averaged fit."""
    q = rounder(precision)
    bvals = np.asarray(bvals, np.float64)
    raw = np.asarray(raw, np.float64)
    b0 = raw[:, bvals == 0].mean(1)
    y = np.where(b0[:, None] > 0, raw / np.where(b0 > 0, b0, 1)[:, None], 0)
    y = np.clip(y, 0, None)
    model = module(config['reference'])
    if evaluation(config).get('doDirectionalAverage'):
        rows, b_avg = shell_rows(bvals, pulses)
        D = dict(D, iso=shell_average(D['iso'], rows, 0),
                 aniso=shell_average(D['aniso'], rows, 1))
        out = model.solve(config, D, q(shell_average(y, rows, 1)), None,
                          lambdas, want_dwi, q, b_avg)
    else:
        dirs = dti_directions(y, bvals, bvecs, q)
        lut = dictionary.lut_index(dirs, D['htable'])
        out = model.solve(config, D, q(y), lut, lambdas, want_dwi, q, bvals)
    out['b0'] = b0
    return out
