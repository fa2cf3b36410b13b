"""Copy of ``amico_tpu/io/scheme.py`` for the port, which imports nothing of
``amico_tpu``.

Acquisition-scheme layer.

TPU-native re-implementation of the reference scheme machinery
(reference amico/scheme.py:19-154).  Behavior parity:

* Camino-style text files, optional header lines, two formats
  (scheme.py:29-47): Nx4 ``bvec+b`` (version 0) and Nx7 STEJSKALTANNER
  ``dir,G,Delta,delta,TE`` (version 1);
* b derived for version 1 as ``b = (gamma*G*delta)^2 (Delta - delta/3) 1e-6``
  in mm^2/s (scheme.py:79);
* b0/dwi bookkeeping against ``b0_thr`` (scheme.py:84-88);
* hemisphere canonicalization: rows with y<0 are negated (scheme.py:91-92);
* shells grouped by unique rows of ``raw[:,3:]`` in first-appearance order
  (scheme.py:95-120);
* ``get_table`` reconstruction (scheme.py:123-150) and ``nS`` property.
"""
from __future__ import annotations

import os.path
import re

import numpy as np

from ..utils.logging import ERROR, LOG, PRINT, WARNING

# Proton gyromagnetic ratio, value used by the NODDI toolbox
# (reference synthesis.py:10)
GAMMA = 2.675987e8


class Scheme:
    """Acquisition scheme: directions + diffusion weighting per sample."""

    def __init__(self, data, b0_thr: float = 0):
        if isinstance(data, (str, os.PathLike)):
            try:
                n_skip = 0
                with open(data) as fid:
                    for line in fid:
                        if re.match(r'[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?', line.strip()):
                            break
                        n_skip += 1
                table = np.loadtxt(data, skiprows=n_skip)
            except Exception:
                ERROR(f'Could not read a numeric table from scheme file "{data}"')
            self.load_from_table(table, b0_thr)
        else:
            self.load_from_table(np.asarray(data, dtype=np.float64), b0_thr)

    def load_from_table(self, data: np.ndarray, b0_thr: float = 0) -> None:
        if data.ndim == 1:
            data = data[None, :]
        self.raw = np.array(data, dtype=np.float64)

        if self.raw.shape[1] == 4:
            self.version = 0
            self.b = self.raw[:, 3]
        elif self.raw.shape[1] == 7:
            self.version = 1
            # reference scheme.py:79
            self.b = (GAMMA * self.raw[:, 3] * self.raw[:, 5]) ** 2 \
                * (self.raw[:, 4] - self.raw[:, 5] / 3.0) * 1e-6
        else:
            ERROR('Scheme table must have 4 columns (bvec+b) or 7 (STEJSKALTANNER)')

        self.b0_thr = b0_thr
        self.b0_idx = np.where(self.b <= b0_thr)[0]
        self.b0_count = len(self.b0_idx)
        self.dwi_idx = np.where(self.b > b0_thr)[0]
        self.dwi_count = len(self.dwi_idx)

        # canonicalize directions into the y>=0 hemisphere (scheme.py:91-92)
        flip = self.raw[:, 1] < 0
        self.raw[flip, 0:3] = -self.raw[flip, 0:3]

        # group shells by the unique weighting rows, first-appearance order
        # (scheme.py:95-120)
        self.shells: list[dict] = []
        weights = np.ascontiguousarray(self.raw[:, 3:])
        _, first_idx = np.unique(weights, axis=0, return_index=True)
        for index in sorted(first_idx):
            b_val = self.b[index]
            if b_val <= b0_thr:
                continue
            row = weights[index]
            shell: dict = {'b': b_val}
            if self.version == 0:
                shell['G'] = shell['Delta'] = shell['delta'] = shell['TE'] = None
            else:
                shell['G'], shell['Delta'], shell['delta'], shell['TE'] = row
            shell['idx'] = np.where((weights == row).all(axis=1))[0]
            shell['grad'] = self.raw[shell['idx'], 0:3]
            self.shells.append(shell)

    def get_table(self) -> np.ndarray:
        """Rebuild the scheme matrix from the shell structure (scheme.py:123-150)."""
        if self.raw is None:
            ERROR('Scheme holds no data; build it from a table first')
        ncol = 4 if self.version == 0 else 7
        table = np.zeros((self.b0_count + self.dwi_count, ncol))
        for shell in self.shells:
            table[shell['idx'], 0:3] = shell['grad']
            if self.version == 0:
                table[shell['idx'], 3] = shell['b']
            else:
                table[shell['idx'], 3] = shell['G']
                table[shell['idx'], 4] = shell['Delta']
                table[shell['idx'], 5] = shell['delta']
                table[shell['idx'], 6] = shell['TE']
        return table

    @property
    def nS(self) -> int:
        return self.b0_count + self.dwi_count


def _load_bvals_bvecs(bvals_filename, bvecs_filename, delimiter):
    if not os.path.exists(bvals_filename):
        ERROR(f'bvals file does not exist: {bvals_filename}')
    if not os.path.exists(bvecs_filename):
        ERROR(f'bvecs file does not exist: {bvecs_filename}')
    bvecs = np.loadtxt(bvecs_filename, delimiter=delimiter)
    bvals = np.loadtxt(bvals_filename, delimiter=delimiter)
    if bvecs.ndim != 2 or bvals.ndim != 1 or bvecs.shape[0] != 3 \
            or bvecs.shape[1] != bvals.shape[0]:
        ERROR('bvals/bvecs shapes disagree: need bvecs (3, n) and bvals (n,)')
    return bvals, bvecs


def _apply_flips(bvecs, flipAxes):
    flipAxes = np.array(flipAxes, dtype=np.bool_)
    if flipAxes.ndim != 1 or flipAxes.size != 3:
        ERROR('flipAxes needs exactly one boolean per axis (3 values)')
    for ax in range(3):
        if flipAxes[ax]:
            bvecs[ax, :] *= -1
    return bvecs


def _round_bvals(bvals, bStep):
    """b-value rounding / shell-snapping (reference util.py:93-109)."""
    bStep = np.array(bStep, dtype=np.double)
    if bStep.size == 1 and bStep > 1.0:
        PRINT(f'-> Rounding b-values to multiples of {np.array_str(bStep)}')
        bvals = np.round(bvals / bStep) * bStep
    elif bStep.size > 1:
        PRINT(f'-> Snapping b-values onto the shells {np.array_str(bStep)}')
        for i in range(bvals.size):
            diff = np.min(np.abs(bvals[i] - bStep))
            ind = np.argmin(np.abs(bvals[i] - bStep))
            if (bStep[ind] == 0.0 and diff > 100) or \
                    (bStep[ind] > 0.0 and diff > bStep[ind] / 20.0):
                WARNING(f'sample {i}: b={bvals[i]:.0f} is far from any shell; '
                        f'snapping it to b={bStep[ind]:.0f}')
            bvals[i] = bStep[ind]
    return bvals


def fsl2scheme(bvalsFilename, bvecsFilename, schemeFilename=None,
               flipAxes=(False, False, False), bStep=1.0, delimiter=None):
    """Create a version-0 scheme file from FSL bvals+bvecs (reference util.py:52-114)."""
    if schemeFilename is None:
        schemeFilename = os.path.splitext(str(bvalsFilename))[0] + '.scheme'
    bvals, bvecs = _load_bvals_bvecs(bvalsFilename, bvecsFilename, delimiter)
    bvecs = _apply_flips(bvecs, flipAxes)
    bvals = _round_bvals(bvals, bStep)
    np.savetxt(schemeFilename, np.c_[bvecs.T, bvals], fmt='%.06f',
               delimiter='\t', header='VERSION: BVECTOR', comments='')
    LOG(f'\n-> Scheme written to {schemeFilename}')
    return schemeFilename


def sandi2scheme(bvalsFilename, bvecsFilename, Delta_data, smalldel_data,
                 TE_data=None, schemeFilename=None,
                 flipAxes=(False, False, False), bStep=1.0, delimiter=None):
    """Create a version-1 (STEJSKALTANNER) scheme file for SANDI acquisitions
    (reference util.py:117-228).  ``G`` is derived from b via
    ``G = sqrt(b*1e6 / (gamma^2 delta^2 (Delta - delta/3)))`` (util.py:223).
    """
    if schemeFilename is None:
        schemeFilename = os.path.splitext(str(bvalsFilename))[0] + '.scheme'
    bvals, bvecs = _load_bvals_bvecs(bvalsFilename, bvecsFilename, delimiter)

    def _load_percol(data, name):
        if isinstance(data, (str, os.PathLike)):
            if not os.path.exists(data):
                ERROR(f'{name} file does not exist: {data}')
            arr = np.loadtxt(data, delimiter=delimiter)
            if arr.ndim != 1 or arr.shape[0] != bvals.shape[0]:
                ERROR(f'{name} column must be a 1-D array matching bvals in length')
            if arr.mean() > 0.1:
                WARNING(f'{name} values average {arr.mean():.4f} -- timings are '
                        'expected in seconds; check the units')
        else:
            # scalar or per-sample array (both documented by the reference,
            # util.py:117-146)
            data = np.asarray(data, dtype=float)
            if data.ndim > 1 or (data.ndim == 1
                                 and data.shape != bvals.shape):
                ERROR(f'{name} must be a scalar or a 1-D array matching '
                      'bvals in length')
            arr = np.ones_like(bvals) * data
            if float(arr.mean()) > 0.1:
                WARNING(f'{name}={arr.mean():.4f} -- timings are expected in '
                        'seconds; check the units')
        return arr

    delta = _load_percol(Delta_data, 'delta')
    smalldel = _load_percol(smalldel_data, 'small delta')

    if TE_data is None:
        TE = delta + smalldel
    else:
        if isinstance(TE_data, (str, os.PathLike)):
            TE = np.loadtxt(TE_data, delimiter=delimiter)
            if TE.ndim != 1 or TE.shape[0] != bvals.shape[0]:
                ERROR('TE column must be a 1-D array matching bvals in length')
        else:
            TE = np.ones_like(bvals) * TE_data
        if not (TE >= (delta + smalldel)).all():
            ERROR('Every TE must be at least Delta + delta')

    bvecs = _apply_flips(bvecs, flipAxes)
    bvals = _round_bvals(bvals, bStep)

    G = np.sqrt(bvals * 1e6 / (GAMMA ** 2 * smalldel ** 2 * (delta - smalldel / 3.0)))
    np.savetxt(schemeFilename, np.c_[bvecs.T, G, delta, smalldel, TE], fmt='%.06f',
               delimiter='\t', header='VERSION: 1', comments='')
    LOG(f'\n-> Scheme written to {schemeFilename}')
    return schemeFilename
