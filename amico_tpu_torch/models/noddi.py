"""NODDI model on PyTorch (counterpart of ``amico_tpu.models.noddi``).

``set``, ``get_params``, ``set_solver``, ``generate`` and ``resample`` are
the JAX package's, in NumPy over the shared ``lut``/``synthesis`` modules.
``fit`` builds the per-direction dictionaries and Grams once
(:meth:`NODDI.prepare`), then per chunk gathers the tiles' dictionaries,
forms ``b1 = A'y`` and runs the fused 3-stage solve
(:func:`amico_tpu_torch.ops.cuda_qp.noddi_fused_tiles`): the CUDA kernel
on a CUDA device, its plain PyTorch twin on the CPU.  ``backend='xla'``
runs the three stages one after the other on the stagewise solver
(:func:`amico_tpu_torch.ops.solvers.nneg_qp_batch`), as the JAX package's
XLA path does.

References
----------
Zhang et al. (2012) NeuroImage 61: 1000-16.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import lut as _lut
from ..synthesis import (NODDIExtraCellular, NODDIIntraCellular,
                         NODDIIsotropic)
from ..utils.logging import NOTE, get_verbose
from ..utils.progress import ProgressBar
from ..device import resolve_device
from ..ops.cuda_qp import noddi_fused_tiles
from ..ops.solvers import gram, noddi_stage2_tiebreak, power_iteration_L
from ._fitops import error_maps, project, solve_tiles
from .base import DEFAULT_NODDI_STAGE_ITERS, BaseModel

# CG budget of each tie-break candidate for set_solver(tiebreak=True), as in
# the JAX package (base.DEFAULT_NODDI_TIEBREAK_CG)
DEFAULT_NODDI_TIEBREAK_CG = 8


def _kappa_neighbours(icvf: np.ndarray, kappa: np.ndarray):
    """Per-atom index of the same-ICVF adjacent-kappa atom on the (IC_OD,
    IC_VF) grid, ascending-kappa order, -1 at the grid edges (the JAX
    package's helper): the stage-2 tie-break's candidates."""
    n = icvf.shape[0]
    nbm = np.full(n, -1, np.int32)
    nbp = np.full(n, -1, np.int32)
    for j in range(n):
        same = np.where(np.isclose(icvf, icvf[j], rtol=1e-6, atol=1e-9))[0]
        order = same[np.argsort(kappa[same], kind='stable')]
        pos = int(np.nonzero(order == j)[0][0])
        if pos > 0:
            nbm[j] = order[pos - 1]
        if pos + 1 < order.size:
            nbp[j] = order[pos + 1]
    return nbm, nbp


_PRECISIONS = ('highest', 'high', 'default', 'split3')


def _check_precision(precision) -> None:
    """Raise ValueError on a precision the JAX package's fused kernel does
    not resolve (``_resolve_precision``): a name of _PRECISIONS, or a
    3-tuple whose entries are names or an (iter, polish) or (iter, late,
    n_late) form with an int n_late."""
    def name(p):
        if not (isinstance(p, str) and p in _PRECISIONS):
            raise ValueError(f'precision {p!r} is none of {_PRECISIONS}')

    if precision is None or isinstance(precision, str):
        if precision is not None:
            name(precision)
        return
    for entry in precision:
        if isinstance(entry, str):
            name(entry)
            continue
        entry = tuple(entry)
        if len(entry) not in (2, 3):
            raise ValueError(f'precision entry {entry!r}: (iter, polish) or '
                             '(iter, late, n_late) expected')
        name(entry[0])
        name(entry[1])
        if len(entry) == 3 and (isinstance(entry[2], bool)
                                or not isinstance(entry[2], int)):
            raise ValueError(f'precision entry {entry!r}: n_late must be '
                             'an int')


class NODDI(BaseModel):
    # K1's widths (a warp a voxel, 32 warps a tile: multiples of 32) and its
    # per-tile overhead in voxel slots for engine.auto_tile_size.  Replayed
    # one launch after another, K1's launches at 32-256 fit the padded
    # slots with an overhead of 2 slots a tile (within 2%), which would
    # pick 64 (0.7% under 128); in the fit, whose chunks overlap on two
    # streams, 64 waited 2-5% longer than 128 in every reading and its
    # chunks' Grams raised the peak device memory by 135 MiB, so the
    # ladder holds 128 alone (tools/tile_widths.py, chip_smoke.py on an
    # H100 80GB HBM3, 700 W; PERF.md).  The maps are the same bit for bit
    # at every width
    _tile_widths = (128,)
    _tile_step_overhead = 2.0

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
        ``NODDI.set_solver``.  ``stage_iters`` overrides the per-stage
        schedule ((fista, rounds, cg, inner[, converge[, add_k]]) x2,
        (rounds, cg, inner[, converge[, add_k]])); the iteration knobs give
        the uniform FISTA-seeded one.  ``tiebreak`` True (CG budget
        DEFAULT_NODDI_TIEBREAK_CG) or an int turns on stage 2's tie-break.
        ``precision`` takes what the JAX package takes: 'highest',
        'high', 'default' or 'split3', or a 3-tuple of per-stage entries,
        each a name or an (iter, polish) or (iter, late, n_late) form.  The
        port computes every stage in float32, which is never less precise
        than asked: the precision is validated and stored, and the fit
        says so at verbose 2.  'auto' and 'pallas' run the fused solve
        (the CUDA kernel on a card, its twin on the CPU), 'xla' the
        stagewise one; both take every knob."""
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
        _check_precision(precision)
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
        dictionaries ``A_all`` (ndirs, nS, na), Grams ``G1_all``/``G2_all``
        and their largest eigenvalues ``L1_all``/``L2_all`` (ndirs,), the
        scaled stage-2 dictionary ``A2_all`` (ndirs, ndwi, n_wm) and its
        transpose ``A2T_all``, and ``iso_dwi``, ``icvf``, ``kappa``; all
        float32."""
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
        G1_all, G2_all = gram(A_all), gram(A2_all)
        return {'A_all': A_all, 'G1_all': G1_all, 'G2_all': G2_all,
                'L1_all': power_iteration_L(G1_all),
                'L2_all': power_iteration_L(G2_all), 'A2_all': A2_all,
                'A2T_all': A2_all.transpose(1, 2).contiguous(),
                'iso_dwi': K_iso[rows].contiguous(),
                'icvf': torch.as_tensor(kernels['icvf'], **f32),
                'kappa': torch.as_tensor(kernels['kappa'], **f32),
                'rows_dwi': rows}

    def _stage_iters(self):
        """The per-stage schedule: explicit ``stage_iters``, else the
        uniform one the iteration knobs give, else the validated
        default (the JAX package's order)."""
        sp = self.solver_params
        stage_iters = sp.get('stage_iters')
        if stage_iters is None:
            if sp.get('custom_iters'):
                fi, rr, cg = sp['fista_iters'], sp['refine_rounds'], \
                    sp['cg_iters']
                stage_iters = ((fi, rr, cg, 2), (fi, rr, cg, 2),
                               (rr, cg, 2))
            else:
                stage_iters = DEFAULT_NODDI_STAGE_ITERS
        return stage_iters

    def _stagewise_kwargs(self) -> tuple:
        """The stagewise solve's per-stage ``nneg_qp_batch`` arguments
        from the schedule, as the JAX XLA path unpacks it: trailing
        ``converge`` and ``add_k`` entries, and per-round inner-pass tuples
        taken at their largest."""
        s1, s2, s3 = self._stage_iters()
        for t, base in ((s1, 4), (s2, 4), (s3, 3)):
            if len(t) > base + 2:
                raise ValueError(
                    f'stage tuple {t} has {len(t)} entries; at most '
                    f'{base + 2} are meaningful (base {base} + converge '
                    '+ add_k)')
        out = []
        for t, base in ((s1, 4), (s2, 4), (s3, 3)):
            fi = int(t[0]) if base == 4 else 0
            rr, cg, ip = t[base - 3:base]
            out.append(dict(
                fista_iters=fi, cd_sweeps=0, refine_rounds=int(rr),
                cg_iters=tuple(cg) if isinstance(cg, (tuple, list)) else cg,
                inner_passes=max(ip) if isinstance(ip, (tuple, list))
                else int(ip),
                converge=t[base] if len(t) > base else False,
                add_k=int(t[base + 1]) if len(t) > base + 1 else 1))
        return tuple(out)

    def fit(self, evaluation):
        device = resolve_device(evaluation.get_config('device'))
        configs = self._common_configs(evaluation)
        modulated = bool(evaluation.get_config('doSaveModulatedMaps'))
        stagewise = self._solver_backend(device) == 'xla'
        if stagewise:
            kw1, kw2, kw3 = self._stagewise_kwargs()
        else:
            stage_iters = self._stage_iters()
            precision = self.solver_params.get('precision')
            if precision not in (None, 'highest'):
                NOTE(f'precision {precision!r}: the fused solve computes '
                     'every stage in float32')
        tb = self.solver_params.get('tiebreak', False)
        tb_cg = DEFAULT_NODDI_TIEBREAK_CG if tb is True else int(tb or 0)
        lam1 = float(self.solver_params['lambda1'])
        lam2 = float(self.solver_params['lambda2'])
        is_exvivo = bool(self.isExvivo)
        want_x = configs['compute_rmse'] or configs['compute_nrmse']
        kernels = evaluation.KERNELS
        merged_b0 = bool(evaluation.get_config('doMergeB0'))
        n_wm = kernels['wm'].shape[0]
        nb = _kappa_neighbours(np.asarray(kernels['icvf']),
                               np.asarray(kernels['kappa'])) if tb_cg else None

        def chunk_fn_for(device):
            """The chunk function with the fit's constants on ``device``."""
            c = self._constants(
                (kernels['wm'], is_exvivo, merged_b0), device,
                lambda: self.prepare(kernels, device, merged_b0))
            rows = c['rows_dwi']
            na = c['A_all'].shape[-1]
            nb_m = nb_p = None
            if tb_cg:
                nb_m, nb_p = (torch.as_tensor(t, device=device) for t in nb)

            def estimates(x):
                """NDI, ODI, FWF (and dot) from the debiased x (C, M,
                na)."""
                sum_atoms = x.sum(-1) + 1e-16
                xn_wm = x[..., :n_wm] / sum_atoms[..., None]
                sum_wm = xn_wm.sum(-1) + 1e-16
                f1 = (c['icvf'] * xn_wm).sum(-1) / sum_wm
                f2 = ((1.0 - c['icvf']) * xn_wm).sum(-1) / sum_wm
                k1 = (c['kappa'] * xn_wm).sum(-1) / sum_wm
                ndi = f1 / (f1 + f2 + 1e-16)
                odi = 2.0 / np.pi * torch.atan2(torch.ones_like(k1), k1)
                maps = [ndi, odi, x[..., -1] / sum_atoms]
                if is_exvivo:
                    maps.append(x[..., na - 2] / sum_atoms)
                return torch.stack(maps, -1)

            def solve_stagewise(A_full, b1, Y, dirs):
                """The JAX XLA path's three solves (models.pyx:911-942)."""
                G1, L1 = c['G1_all'][dirs], c['L1_all'][dirs]
                x1 = solve_tiles(G1, b1, L1, 0.0, 0.0, solver_kw=kw1,
                                 backend='xla')
                Y2 = Y.index_select(-1, rows) - x1[..., -1:] * c['iso_dwi']
                if is_exvivo:
                    Y2 = Y2 - x1[..., na - 2:na - 1]
                b2 = project(c['A2_all'][dirs], torch.clamp(Y2, min=0.0))
                G2 = c['G2_all'][dirs]
                x2 = solve_tiles(G2, b2, c['L2_all'][dirs], lam1, lam2,
                                 solver_kw=kw2, backend='xla')
                if tb_cg:
                    x2 = noddi_stage2_tiebreak(G2, b2, x2, lam1, lam2, nb_m,
                                               nb_p, cg_iters=tb_cg)
                # debias on the positive support, the working set seeded
                # with it and CG warm-started from the stage-1 solution
                mask = torch.cat([(x2 > 0.0).to(Y.dtype),
                                  torch.ones(Y.shape[:2] + (na - n_wm,),
                                             dtype=Y.dtype, device=Y.device)],
                                 -1)
                x = solve_tiles(G1, b1, L1, 0.0, 0.0, mask=mask, m0=mask,
                                x0=x1 * mask, solver_kw=kw3, backend='xla')
                return estimates(x), x

            def fit_chunk(Y, dirs, valid):
                A_full = c['A_all'][dirs]                  # (C, nS, na)
                b1 = project(A_full, Y)
                if stagewise:
                    est, x = solve_stagewise(A_full, b1, Y, dirs)
                else:
                    out = noddi_fused_tiles(
                        c['G1_all'][dirs], c['G2_all'][dirs], b1,
                        Y.index_select(-1, rows),
                        c['A2_all'][dirs].transpose(1, 2),  # no copy for K1
                        c['iso_dwi'], c['icvf'], c['kappa'], lam1=lam1,
                        lam2=lam2, stage_iters=stage_iters, want_x=want_x,
                        is_exvivo=is_exvivo, tiebreak_cg=tb_cg,
                        nb_minus=nb_m, nb_plus=nb_p)
                    est, x = out if want_x else (out, None)
                vmask = valid[..., None].to(est.dtype)
                res = {'estimates': est * vmask}
                if want_x:
                    res.update(error_maps(A_full, x, Y,
                                          configs['compute_rmse'],
                                          configs['compute_nrmse']))
                if modulated:
                    tf = 1.0 - est[..., 2]
                    res['estimates_mod'] = torch.stack(
                        [est[..., 0] * tf, est[..., 1] * tf], -1) * vmask
                return res
            return fit_chunk

        shapes = {'estimates': (len(self.maps_name),)}
        if configs['compute_rmse']:
            shapes['rmse'] = ()
        if configs['compute_nrmse']:
            shapes['nrmse'] = ()
        if modulated:
            shapes['estimates_mod'] = (2,)
        with torch.no_grad():
            return self._run_tiled_fit(evaluation, chunk_fn_for, shapes,
                                       device)
