"""NODDI model on PyTorch (counterpart of ``amico_tpu.models.noddi``).

``set``, ``get_params``, ``set_solver``, ``generate`` and ``resample`` are
the JAX package's, in NumPy over the shared ``lut``/``synthesis`` modules.
``fit`` builds the per-direction dictionaries and Grams once
(:meth:`NODDI.prepare`), then per chunk gathers the tiles' dictionaries,
forms ``b1 = A'y`` and runs the fused 3-stage solve
(:func:`amico_tpu_torch.ops.cuda_qp.noddi_fused_tiles`): the CUDA kernel
on a CUDA device, its plain PyTorch twin on the CPU.

References
----------
Zhang et al. (2012) NeuroImage 61: 1000-16.
"""
from __future__ import annotations

import numpy as np
import torch

from amico_tpu import lut as _lut
from amico_tpu.synthesis import (NODDIExtraCellular, NODDIIntraCellular,
                                 NODDIIsotropic)
from amico_tpu.utils.logging import get_verbose
from amico_tpu.utils.progress import ProgressBar
from ..device import resolve_device
from ..ops.cuda_qp import noddi_fused_tiles, noddi_schedules
from ..ops.solvers import gram
from ._fitops import error_maps, project
from .base import DEFAULT_NODDI_STAGE_ITERS, BaseModel


class NODDI(BaseModel):
    def __init__(self):
        self.id = 'NODDI'
        self.name = 'NODDI'
        self.maps_name = ['NDI', 'ODI', 'FWF']
        self.maps_descr = ['Neurite Density Index',
                           'Orientation Dispersion Index',
                           'Free Water Fraction']
        self.scheme = None
        self.set()

    def set(self, dPar=1.7e-3, dIso=3.0e-3,
            IC_VFs=np.linspace(0.1, 0.99, 12),
            IC_ODs=np.hstack((np.array([0.03, 0.06]), np.linspace(0.09, 0.99, 10))),
            isExvivo=False):
        self.dPar = dPar
        self.dIso = dIso
        self.IC_VFs = np.array(IC_VFs)
        self.IC_ODs = np.array(IC_ODs)
        self.isExvivo = isExvivo
        if isExvivo and 'dot' not in self.maps_name:
            self.maps_name = self.maps_name + ['dot']
            self.maps_descr = self.maps_descr + ['Dot volume fraction']

    def get_params(self):
        return {'id': self.id, 'name': self.name, 'dPar': self.dPar,
                'dIso': self.dIso, 'IC_VFs': self.IC_VFs,
                'IC_ODs': self.IC_ODs, 'isExvivo': self.isExvivo}

    def set_solver(self, lambda1=5e-1, lambda2=1e-3, fista_iters=None,
                   cd_sweeps=None, refine_rounds=None, cg_iters=None,
                   backend=None, stage_iters=None, precision=None,
                   tiebreak=None):
        """Same signature and stored parameters as the JAX package's
        ``NODDI.set_solver``.  ``fit`` takes ``backend`` 'auto' or
        'pallas' (the fused solve), ``precision`` None or 'highest'
        (float32) and no ``tiebreak``; the rest is ROADMAP work."""
        self._set_solver_common(lambda1, lambda2, fista_iters, cd_sweeps,
                                refine_rounds, cg_iters, backend)
        if stage_iters is not None:
            stage_iters = tuple(tuple(t) for t in stage_iters)
        self.solver_params['stage_iters'] = stage_iters
        if precision is not None and not isinstance(precision, str):
            precision = tuple(precision)
            if len(precision) != 3 or not all(
                    isinstance(e, (str, tuple, list)) for e in precision):
                raise ValueError(
                    'precision must be a string or a 3-tuple of per-stage '
                    f'entries, got {precision!r}')
        self.solver_params['precision'] = precision
        self.solver_params['tiebreak'] = (
            False if tiebreak is None
            else tiebreak if isinstance(tiebreak, bool)
            else int(tiebreak))

    def generate(self, out_path, aux, idx_in, idx_out, ndirs):
        """Coupled IC+EC atoms over the (IC_OD, IC_VF) grid + isotropic
        atom."""
        scheme_high = _lut.create_high_resolution_scheme(self.scheme,
                                                         grad=aux.get('grad'))
        noddi_ic = NODDIIntraCellular(scheme_high)
        noddi_ec = NODDIExtraCellular(scheme_high)
        noddi_iso = NODDIIsotropic(scheme_high)

        nATOMS = len(self.IC_ODs) * len(self.IC_VFs) + 1
        idx = 0
        with ProgressBar(total=nATOMS, disable=get_verbose() < 3) as pbar:
            IC_KAPPAs = 1 / np.tan(self.IC_ODs * np.pi / 2)
            for kappa in IC_KAPPAs:
                signal_ic = noddi_ic.get_signal(self.dPar, kappa)
                for v_ic in self.IC_VFs:
                    signal_ec = noddi_ec.get_signal(self.dPar, kappa, v_ic)
                    signal = v_ic * signal_ic + (1 - v_ic) * signal_ec
                    lm = _lut.rotate_kernel(signal, aux, idx_in, idx_out, False, ndirs)
                    self._save_atom(out_path, idx + 1, lm)
                    idx += 1
                    pbar.update()
            signal = noddi_iso.get_signal(self.dIso)
            lm = _lut.rotate_kernel(signal, aux, idx_in, idx_out, True, ndirs)
            self._save_atom(out_path, nATOMS, lm)
            pbar.update()

    def resample(self, in_path, idx_out, Ylm_out, doMergeB0, ndirs):
        """KERNELS layout of the JAX package: 'norms' is a per-atom
        vector."""
        nATOMS = len(self.IC_ODs) * len(self.IC_VFs) + 1
        nS, merge_idx = self._merge_idx(doMergeB0)
        n_wm = nATOMS - 1
        KERNELS = {'model': self.id}
        KERNELS['wm'] = np.zeros((n_wm, ndirs, nS), dtype=np.float32)
        KERNELS['iso'] = np.zeros(nS, dtype=np.float32)
        KERNELS['kappa'] = np.zeros(n_wm, dtype=np.float32)
        KERNELS['icvf'] = np.zeros(n_wm, dtype=np.float32)
        KERNELS['norms'] = np.zeros(n_wm, dtype=np.float64)

        idx = 0
        with ProgressBar(total=nATOMS, disable=get_verbose() < 3) as pbar:
            for i in range(len(self.IC_ODs)):
                for j in range(len(self.IC_VFs)):
                    lm = self._load_atom(in_path, idx + 1, ndirs)
                    KERNELS['wm'][idx] = _lut.resample_kernel(
                        lm, self.scheme.nS, idx_out, Ylm_out, False, ndirs)[:, merge_idx]
                    KERNELS['kappa'][idx] = 1.0 / np.tan(self.IC_ODs[i] * np.pi / 2.0)
                    KERNELS['icvf'][idx] = self.IC_VFs[j]
                    if doMergeB0:
                        dwi_part = KERNELS['wm'][idx, 0, 1:]
                    else:
                        dwi_part = KERNELS['wm'][idx, 0, self.scheme.dwi_idx]
                    KERNELS['norms'][idx] = 1.0 / np.linalg.norm(dwi_part)
                    idx += 1
                    pbar.update()
            lm = self._load_atom(in_path, nATOMS, ndirs, isotropic=True)
            KERNELS['iso'] = _lut.resample_kernel(
                lm, self.scheme.nS, idx_out, Ylm_out, True, ndirs)[merge_idx]
            pbar.update()
        return KERNELS

    def _rows_dwi(self, merged_b0: bool, nS: int) -> np.ndarray:
        """DWI columns of the fitted signal: after the doMergeB0 collapse
        they follow the single mean b0; otherwise they are the scheme's
        (the layout comes from config, never from the signal's shape)."""
        if merged_b0:
            return np.arange(1, nS)
        return np.asarray(self.scheme.dwi_idx, np.int64)

    def prepare(self, kernels: dict, device, merged_b0: bool = False) -> dict:
        """Device constants of the fit from a resampled KERNELS dict (as
        either package's ``resample`` returns it): per-direction
        dictionaries ``A_all`` (ndirs, nS, na), Grams ``G1_all``/``G2_all``,
        the scaled stage-2 dictionary transposed ``A2T_all`` (ndirs, n_wm,
        ndwi), and ``iso_dwi``, ``icvf``, ``kappa``; all float32."""
        device = torch.device(device)
        n_wm, ndirs, nS = kernels['wm'].shape
        rows = torch.as_tensor(self._rows_dwi(merged_b0, nS), device=device)
        f32 = dict(dtype=torch.float32, device=device)
        K_wm = torch.as_tensor(np.ascontiguousarray(
            np.transpose(kernels['wm'], (1, 2, 0))), **f32)
        K_iso = torch.as_tensor(kernels['iso'], **f32)
        norms = torch.as_tensor(kernels['norms'], **f32)
        cols = [K_wm]
        if self.isExvivo:
            cols.append(torch.ones((ndirs, nS, 1), **f32))
        cols.append(K_iso[None, :, None].expand(ndirs, nS, 1))
        A_all = torch.cat(cols, -1).contiguous()          # (ndirs, nS, na)
        A2_all = A_all[:, rows, :n_wm] * norms
        return {'A_all': A_all, 'G1_all': gram(A_all),
                'G2_all': gram(A2_all),
                'A2T_all': A2_all.transpose(1, 2).contiguous(),
                'iso_dwi': K_iso[rows].contiguous(),
                'icvf': torch.as_tensor(kernels['icvf'], **f32),
                'kappa': torch.as_tensor(kernels['kappa'], **f32),
                'rows_dwi': rows}

    def _stage_iters(self):
        sp = self.solver_params
        if sp.get('backend', 'auto') not in ('auto', 'pallas'):
            raise NotImplementedError(
                f"backend {sp['backend']!r} (the stagewise solve) is not "
                "ported yet (ROADMAP queue 1: nneg_qp_batch and "
                "backend='xla'); use 'auto'")
        if sp.get('tiebreak'):
            raise NotImplementedError(
                'the stage-2 tie-break is not ported (ROADMAP queue 2, K1 '
                'follow-ups)')
        if sp.get('precision') not in (None, 'highest'):
            raise NotImplementedError(
                f"precision {sp['precision']!r}: the port computes in "
                'float32 only; the precision tiers are ROADMAP work')
        stage_iters = sp.get('stage_iters')
        if stage_iters is None:
            if sp.get('custom_iters'):
                fi, rr, cg = sp['fista_iters'], sp['refine_rounds'], \
                    sp['cg_iters']
                stage_iters = ((fi, rr, cg, 2), (fi, rr, cg, 2),
                               (rr, cg, 2))
            else:
                stage_iters = DEFAULT_NODDI_STAGE_ITERS
        noddi_schedules(stage_iters)        # reject what the solve lacks
        return stage_iters

    def fit(self, evaluation):
        device = resolve_device(evaluation.get_config('device'))
        configs = self._common_configs(evaluation)
        modulated = bool(evaluation.get_config('doSaveModulatedMaps'))
        stage_iters = self._stage_iters()
        lam1 = float(self.solver_params['lambda1'])
        lam2 = float(self.solver_params['lambda2'])
        is_exvivo = bool(self.isExvivo)
        want_x = configs['compute_rmse'] or configs['compute_nrmse']
        c = self.prepare(evaluation.KERNELS, device,
                         bool(evaluation.get_config('doMergeB0')))
        rows = c['rows_dwi']

        def fit_chunk(Y, dirs, valid):
            A_full = c['A_all'][dirs]                      # (C, nS, na)
            b1 = project(A_full, Y)
            out = noddi_fused_tiles(
                c['G1_all'][dirs], c['G2_all'][dirs], b1,
                Y.index_select(-1, rows), c['A2T_all'][dirs], c['iso_dwi'],
                c['icvf'], c['kappa'], lam1=lam1, lam2=lam2,
                stage_iters=stage_iters, want_x=want_x, is_exvivo=is_exvivo)
            est, x = out if want_x else (out, None)
            vmask = valid[..., None].to(est.dtype)
            res = {'estimates': est * vmask}
            if want_x:
                res.update(error_maps(A_full, x, Y, configs['compute_rmse'],
                                      configs['compute_nrmse']))
            if modulated:
                tf = 1.0 - est[..., 2]
                res['estimates_mod'] = torch.stack(
                    [est[..., 0] * tf, est[..., 1] * tf], -1) * vmask
            return res

        shapes = {'estimates': (len(self.maps_name),)}
        if configs['compute_rmse']:
            shapes['rmse'] = ()
        if configs['compute_nrmse']:
            shapes['nrmse'] = ()
        if modulated:
            shapes['estimates_mod'] = (2,)
        with torch.no_grad():
            return self._run_tiled_fit(evaluation, fit_chunk, shapes, device)
