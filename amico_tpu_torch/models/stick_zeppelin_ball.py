"""Stick-Zeppelin-Ball model on PyTorch (counterpart of
``amico_tpu.models.stick_zeppelin_ball``): kernel generation only.

COMMIT builds its kernels with it; ``set_solver`` and ``fit`` raise, as in
the JAX package.  ``set``, ``get_params``, ``generate`` and ``resample``
are the JAX package's, in NumPy over the shared ``lut``/``synthesis``
modules.

References
----------
Panagiotaki et al. (2012) NeuroImage 59: 2241-54.
"""
from __future__ import annotations

import numpy as np

from .. import lut as _lut
from ..synthesis import Ball, Stick, Zeppelin
from ..utils.logging import ERROR, get_verbose
from ..utils.progress import ProgressBar
from .base import BaseModel


class StickZeppelinBall(BaseModel):
    def __init__(self):
        self.id = 'StickZeppelinBall'
        self.name = 'Stick-Zeppelin-Ball'
        self.maps_name = []
        self.maps_descr = []
        self.scheme = None
        self.set()

    def set(self, d_par=1.7e-3,
            d_perps_zep=np.array([1.19e-3, 0.85e-3, 0.51e-3, 0.17e-3]),
            d_isos=np.array([3.0e-3]), d_par_zep=1.7e-3, d_perp=0):
        self.d_par = d_par
        self.d_perp = d_perp
        self.d_par_zep = d_par if d_par_zep is None else d_par_zep
        self.d_perps_zep = np.array(d_perps_zep)
        self.d_isos = np.array(d_isos)

    def get_params(self):
        return {'id': self.id, 'name': self.name, 'd_par': self.d_par,
                'd_perp': self.d_perp, 'd_par_zep': self.d_par_zep,
                'd_perps_zep': self.d_perps_zep, 'd_isos': self.d_isos}

    def set_solver(self):
        ERROR('Not implemented')

    def generate(self, out_path, aux, idx_in, idx_out, ndirs):
        """The stick (a zeppelin when d_perp > 0), the zeppelins, the
        balls."""
        scheme_high = _lut.create_high_resolution_scheme(self.scheme,
                                                         grad=aux.get('grad'))
        stick = Stick(scheme_high)
        zeppelin = Zeppelin(scheme_high)
        ball = Ball(scheme_high)
        first = (zeppelin, (self.d_par, self.d_perp)) if self.d_perp > 0 \
            else (stick, (self.d_par,))
        atoms = [first + (False,)] \
            + [(zeppelin, (self.d_par_zep, d), False)
               for d in self.d_perps_zep] \
            + [(ball, (d,), True) for d in self.d_isos]
        with ProgressBar(total=len(atoms),
                         disable=get_verbose() < 3) as pbar:
            for idx, (compartment, args, isotropic) in enumerate(atoms):
                signal = compartment.get_signal(*args)
                self._save_atom(out_path, idx + 1, _lut.rotate_kernel(
                    signal, aux, idx_in, idx_out, isotropic, ndirs))
                pbar.update()

    def resample(self, in_path, idx_out, Ylm_out, doMergeB0, ndirs):
        """KERNELS layout of the JAX package: 'wmr' (1, ndirs, nS), 'wmh'
        (n_zep, ndirs, nS) and 'iso' (n_iso, nS)."""
        nS, merge_idx = self._merge_idx(doMergeB0)
        KERNELS = {'model': self.id}
        KERNELS['wmr'] = np.zeros((1, ndirs, nS), dtype=np.float32)
        KERNELS['wmh'] = np.zeros((len(self.d_perps_zep), ndirs, nS),
                                  dtype=np.float32)
        KERNELS['iso'] = np.zeros((len(self.d_isos), nS), dtype=np.float32)

        nATOMS = 1 + len(self.d_perps_zep) + len(self.d_isos)
        idx = 0
        with ProgressBar(total=nATOMS, disable=get_verbose() < 3) as pbar:
            for key, isotropic in (('wmr', False), ('wmh', False),
                                   ('iso', True)):
                for i in range(KERNELS[key].shape[0]):
                    lm = self._load_atom(in_path, idx + 1, ndirs,
                                         isotropic=isotropic)
                    out = _lut.resample_kernel(lm, self.scheme.nS, idx_out,
                                               Ylm_out, isotropic, ndirs)
                    KERNELS[key][i] = out[merge_idx] if isotropic \
                        else out[:, merge_idx]
                    idx += 1
                    pbar.update()
        return KERNELS

    def fit(self, evaluation):
        ERROR('Not implemented')
