"""VolumeFractions model on PyTorch (counterpart of
``amico_tpu.models.volume_fractions``): all-ones kernels for COMMIT's
tests, no maps; ``set_solver`` and ``fit`` raise, as in the JAX package."""
from __future__ import annotations

import numpy as np

from ..utils.logging import ERROR
from .base import BaseModel


class VolumeFractions(BaseModel):
    def __init__(self):
        self.id = 'VolumeFractions'
        self.name = 'Volume fractions'
        self.maps_name = []
        self.maps_descr = []
        self.scheme = None
        self.set()

    def set(self):
        return

    def get_params(self):
        return {'id': self.id, 'name': self.name}

    def set_solver(self):
        ERROR('Not implemented')

    def generate(self, out_path, aux, idx_in, idx_out, ndirs):
        return

    def resample(self, in_path, idx_out, Ylm_out, doMergeB0, ndirs):
        """Identity kernels: 'wmr' of ones, empty 'wmh' and 'iso'."""
        nS, _ = self._merge_idx(doMergeB0)
        KERNELS = {'model': self.id}
        KERNELS['wmr'] = np.ones((1, ndirs, nS), dtype=np.float32)
        KERNELS['wmh'] = np.ones((0, ndirs, nS), dtype=np.float32)
        KERNELS['iso'] = np.ones((0, nS), dtype=np.float32)
        return KERNELS

    def fit(self, evaluation):
        ERROR('Not implemented')
