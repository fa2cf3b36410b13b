"""Free-Water elimination model on PyTorch (counterpart of
``amico_tpu.models.free_water``).

Human (10 zeppelins + 1 ball) and Mouse (10 zeppelins + 2 balls) variants,
one non-negative elastic net per voxel (lambda1 = 0, lambda2 = 1e-3), maps
FiberVolume and FW (plus FW_blood and FW_csf for Mouse), and optionally the
free-water-corrected DWI.  ``set``, ``get_params``, ``set_solver``,
``generate`` and ``resample`` are the JAX package's, in NumPy over the
shared ``lut``/``synthesis`` modules.  ``fit`` builds the per-direction
dictionaries and Grams once (:meth:`FreeWater.prepare`), then per chunk
gathers the tiles' dictionaries, forms ``b = A'y`` and solves
(:func:`amico_tpu_torch.models._fitops.solve_tiles`): the tile QP (the CUDA
kernel on a CUDA device, its plain PyTorch twin on the CPU), or with
``backend='xla'`` the stagewise solver.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import lut as _lut
from ..synthesis import Ball, Zeppelin
from ..utils.logging import PRINT, get_verbose
from ..utils.progress import ProgressBar
from ..device import resolve_device
from ..ops.solvers import gram, power_iteration_L
from ._fitops import error_maps, predict, project, solve_tiles
from .base import BaseModel


class FreeWater(BaseModel):
    # K2's widths at n = 11 and 12 (128 voxels in flight a tile: multiples
    # of 128) and its per-tile overhead in voxel slots for
    # engine.auto_tile_size.  The fit gives a negative overhead (-78 and -41
    # slots: a tile's `converge` exit waits for more voxels the wider it
    # is), so it is 0 here and the narrowest width, which pads least, is
    # picked: 128, the fastest of the ladder by 28-60% (tools/tile_widths.py
    # on an H100 80GB HBM3, 700 W; PERF.md)
    _tile_widths = (128, 256, 384, 512)
    _tile_step_overhead = 0.0

    def __init__(self):
        self.id = 'FreeWater'
        self.name = 'Free-Water'
        self.maps_name = []
        self.maps_descr = []
        self.scheme = None
        self.set()

    def set(self, d_par=None, d_perps=None, d_isos=None, type='Human'):
        self.type = type
        if self.type == 'Mouse':
            self.maps_name = ['FiberVolume', 'FW', 'FW_blood', 'FW_csf']
            self.maps_descr = ['fiber volume fraction',
                               'Isotropic free-water volume fraction',
                               'FW blood', 'FW csf']
            self.d_par = 1.0e-3 if d_par is None else d_par
            self.d_perps = np.linspace(0.15, 0.55, 10) * 1e-3 \
                if d_perps is None else np.asarray(d_perps)
            self.d_isos = [1.5e-3, 3e-3] if d_isos is None else d_isos
        else:
            self.maps_name = ['FiberVolume', 'FW']
            self.maps_descr = ['fiber volume fraction',
                               'Isotropic free-water volume fraction']
            self.d_par = 1.0e-3 if d_par is None else d_par
            self.d_perps = np.linspace(0.1, 1.0, 10) * 1e-3 \
                if d_perps is None else np.asarray(d_perps)
            self.d_isos = [2.5e-3] if d_isos is None else d_isos

        PRINT('      %s settings for Freewater elimination... ' % self.type)
        PRINT('             -iso  compartments: ', self.d_isos)
        PRINT('             -perp compartments: ', self.d_perps)
        PRINT('             -para compartments: ', self.d_par)

    def get_params(self):
        return {'id': self.id, 'name': self.name, 'd_par': self.d_par,
                'd_perps': self.d_perps, 'd_isos': self.d_isos,
                'type': self.type}

    def set_solver(self, lambda1=0.0, lambda2=1e-3, fista_iters=None,
                   cd_sweeps=None, refine_rounds=None, cg_iters=None,
                   backend=None):
        """Same signature and stored parameters as the JAX package's.
        ``backend`` 'auto' and 'pallas' run the tile QP, 'xla' the
        stagewise solver (``ops.solvers.nneg_qp_batch``)."""
        self._set_solver_common(lambda1, lambda2, fista_iters, cd_sweeps,
                                refine_rounds, cg_iters, backend)

    def generate(self, out_path, aux, idx_in, idx_out, ndirs):
        scheme_high = _lut.create_high_resolution_scheme(self.scheme,
                                                         grad=aux.get('grad'))
        zeppelin = Zeppelin(scheme_high)
        ball = Ball(scheme_high)

        nATOMS = len(self.d_perps) + len(self.d_isos)
        idx = 0
        with ProgressBar(total=nATOMS, disable=get_verbose() < 3) as pbar:
            for d in self.d_perps:
                signal = zeppelin.get_signal(self.d_par, d)
                self._save_atom(out_path, idx + 1, _lut.rotate_kernel(
                    signal, aux, idx_in, idx_out, False, ndirs))
                idx += 1
                pbar.update()
            for d in self.d_isos:
                signal = ball.get_signal(d)
                self._save_atom(out_path, idx + 1, _lut.rotate_kernel(
                    signal, aux, idx_in, idx_out, True, ndirs))
                idx += 1
                pbar.update()

    def resample(self, in_path, idx_out, Ylm_out, doMergeB0, ndirs):
        """KERNELS layout of the JAX package: 'D' (n_perp, ndirs, nS) and
        'CSF' (n_iso, nS)."""
        nS, merge_idx = self._merge_idx(doMergeB0)
        KERNELS = {'model': self.id}
        KERNELS['D'] = np.zeros((len(self.d_perps), ndirs, nS),
                                dtype=np.float32)
        KERNELS['CSF'] = np.zeros((len(self.d_isos), nS), dtype=np.float32)

        nATOMS = len(self.d_perps) + len(self.d_isos)
        idx = 0
        with ProgressBar(total=nATOMS, disable=get_verbose() < 3) as pbar:
            for i in range(len(self.d_perps)):
                lm = self._load_atom(in_path, idx + 1, ndirs)
                KERNELS['D'][i] = _lut.resample_kernel(
                    lm, self.scheme.nS, idx_out, Ylm_out, False,
                    ndirs)[:, merge_idx]
                idx += 1
                pbar.update()
            for i in range(len(self.d_isos)):
                lm = self._load_atom(in_path, idx + 1, ndirs, isotropic=True)
                KERNELS['CSF'][i] = _lut.resample_kernel(
                    lm, self.scheme.nS, idx_out, Ylm_out, True,
                    ndirs)[merge_idx]
                idx += 1
                pbar.update()
        return KERNELS

    def prepare(self, kernels: dict, device) -> dict:
        """Device constants of the fit from a resampled KERNELS dict (as
        either package's ``resample`` returns it): per-direction
        dictionaries ``A_all`` (ndirs, nS, n), zeppelins first, their
        Grams ``G_all`` (ndirs, n, n) and largest eigenvalues ``L_all``
        (ndirs,) for the stagewise solver; all float32."""
        f32 = dict(dtype=torch.float32, device=torch.device(device))
        _, ndirs, nS = kernels['D'].shape
        K_D = torch.as_tensor(np.ascontiguousarray(
            np.transpose(kernels['D'], (1, 2, 0))), **f32)
        K_CSF = torch.as_tensor(np.ascontiguousarray(kernels['CSF'].T), **f32)
        A_all = torch.cat([K_D, K_CSF[None].expand(ndirs, nS, -1)],
                          -1).contiguous()
        G_all = gram(A_all)
        return {'A_all': A_all, 'G_all': G_all,
                'L_all': power_iteration_L(G_all)}

    def fit(self, evaluation):
        device = resolve_device(evaluation.get_config('device'))
        configs = self._common_configs(evaluation)
        save_corrected = bool(evaluation.get_config('doSaveCorrectedDWI'))
        solver_kw = self._solver_kwargs()
        backend = self._solver_backend(device)
        lam1 = float(self.solver_params['lambda1'])
        lam2 = float(self.solver_params['lambda2'])
        kernels = evaluation.KERNELS
        n_perp = kernels['D'].shape[0]
        is_mouse = self.type == 'Mouse'

        def chunk_fn_for(device):
            """The chunk function with the fit's constants on ``device``."""
            c = self._constants((kernels['D'],), device,
                                lambda: self.prepare(kernels, device))

            def fit_chunk(Y, dirs, valid):
                A = c['A_all'][dirs]                       # (C, nS, n)
                x = solve_tiles(c['G_all'][dirs], project(A, Y),
                                c['L_all'][dirs], lam1, lam2,
                                solver_kw=solver_kw, backend=backend,
                                valid=valid)
                x_sum = x.sum(-1) + 1e-16
                v = x[..., :n_perp].sum(-1) / x_sum
                maps = [v, 1.0 - v]
                if is_mouse:
                    maps += [x[..., n_perp] / x_sum,
                             x[..., n_perp + 1] / x_sum]
                vmask = valid[..., None].to(x.dtype)
                out = {'estimates': torch.stack(maps, -1) * vmask}
                out.update(error_maps(A, x, Y, configs['compute_rmse'],
                                      configs['compute_nrmse']))
                if save_corrected:
                    # zero the fiber coefficients, subtract the isotropic
                    # prediction, clip at 0
                    x_iso = torch.cat([torch.zeros_like(x[..., :n_perp]),
                                       x[..., n_perp:]], -1)
                    out['y_corrected'] = torch.clamp(Y - predict(A, x_iso),
                                                     min=0.0) * vmask
                return out
            return fit_chunk

        shapes = {'estimates': (len(self.maps_name),)}
        if configs['compute_rmse']:
            shapes['rmse'] = ()
        if configs['compute_nrmse']:
            shapes['nrmse'] = ()
        if save_corrected:
            shapes['y_corrected'] = (kernels['D'].shape[2],)
        with torch.no_grad():
            return self._run_tiled_fit(evaluation, chunk_fn_for, shapes,
                                       device)
