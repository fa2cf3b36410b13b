"""SANDI (soma and neurite density imaging) on PyTorch (counterpart of
``amico_tpu.models.sandi``).

5 SphereGPD radii (fixed d_is) + 5 Astrosticks + 5 Balls, all
direction-averaged (isotropic), atoms L2-normalised at resample; one
non-negative lasso per voxel (lambda1 = 0, lambda2 = 5e-3) over one
dictionary shared by every voxel, the solution un-normalised by the stored
norms; maps fsoma, fneurite, fextra, Rsoma, Din, De.  Needs a
STEJSKALTANNER scheme and the ``doDirectionalAverage`` preprocessing.
``set``, ``get_params``, ``set_solver``, ``_solver_kwargs``, ``generate``
and ``resample`` are the JAX package's, in NumPy over the shared
``lut``/``synthesis`` modules.  ``fit`` is its direction-free chunked
fit on the stagewise solver (:func:`amico_tpu_torch.ops.solvers.
nneg_qp_batch`), the JAX package's only route for this model, on the
``device`` config's device: as in the JAX package, SANDI does not use the
``mesh`` config.

References
----------
Palombo et al. (2020) NeuroImage 215: 116835.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import lut as _lut
from .. import trace
from ..device import resolve_device
from ..ops.solvers import gram, nneg_qp_batch, power_iteration_L
from ..synthesis import Astrosticks, Ball, SphereGPD
from ..utils.logging import ERROR, WARNING, get_verbose
from ..utils.progress import ProgressBar
from ._fitops import error_maps
from .base import (DEFAULT_CD_SWEEPS, DEFAULT_CG_ITERS, DEFAULT_FISTA_ITERS,
                   DEFAULT_REFINE_ROUNDS, BaseModel, _concrete)


def sandi_estimates(xu: torch.Tensor, Rs: torch.Tensor, d_in: torch.Tensor,
                    d_isos: torch.Tensor) -> torch.Tensor:
    """fsoma, fneurite, fextra, Rsoma (um), Din and De (um^2/ms) (..., 6)
    from the un-normalised coefficients ``xu`` (..., n): spheres, sticks,
    balls in that order, as the JAX package computes them."""
    n_rs, n_in = Rs.shape[0], d_in.shape[0]
    x_sum = xu.sum(-1) + 1e-16
    xsph = xu[..., :n_rs].sum(-1)
    xstk = xu[..., n_rs:n_rs + n_in].sum(-1)
    xiso = xu[..., n_rs + n_in:].sum(-1)
    return torch.stack([
        xsph / x_sum, xstk / x_sum, xiso / x_sum,
        1e6 * (Rs * xu[..., :n_rs]).sum(-1) / (xsph + 1e-16),
        1e3 * (d_in * xu[..., n_rs:n_rs + n_in]).sum(-1) / (xstk + 1e-16),
        1e3 * (d_isos * xu[..., n_rs + n_in:]).sum(-1) / (xiso + 1e-16)], -1)


def sandi_chunk(N: int, voxels_per_chunk) -> int:
    """Voxels a chunk of an N-voxel fit: with 'auto' (or None) at most 4
    equal chunks of ~51,200 voxels, rounded up to a multiple of 4,096, as
    the JAX package splits them; else ``voxels_per_chunk``."""
    if voxels_per_chunk in (None, 'auto'):
        nchunks = max(1, min(4, -(-N // 51200)))
        per_chunk = -(-N // nchunks)
        return -(-per_chunk // 4096) * 4096
    return int(voxels_per_chunk)


class SANDI(BaseModel):
    def __init__(self):
        self.id = 'SANDI'
        self.name = 'SANDI'
        self.maps_name = ['fsoma', 'fneurite', 'fextra', 'Rsoma', 'Din', 'De']
        self.maps_descr = ['Intra-soma volume fraction',
                           'Intra-neurite volume fraction',
                           'Extra-cellular volume fraction',
                           'Apparent soma radius',
                           'Neurite axial diffusivity',
                           'Extra-cellular mean diffusivity']
        self.scheme = None
        self.set()

    def set(self, d_is=3.0e-3, Rs=np.linspace(1.0, 12.0, 5) * 1e-6,
            d_in=np.linspace(0.25, 3.0, 5) * 1e-3,
            d_isos=np.linspace(0.25, 3.0, 5) * 1e-3):
        self.d_is = d_is
        self.Rs = np.array(Rs)
        self.d_in = np.array(d_in)
        self.d_isos = np.array(d_isos)

    def get_params(self):
        return {'id': self.id, 'name': self.name, 'd_is': self.d_is,
                'Rs': self.Rs, 'd_in': self.d_in, 'd_isos': self.d_isos}

    def set_solver(self, lambda1=0.0, lambda2=5.0e-3, fista_iters=None,
                   cd_sweeps=None, refine_rounds=None, cg_iters=None,
                   backend=None):
        """Same signature and stored parameters as the JAX package's."""
        self._set_solver_common(lambda1, lambda2, fista_iters, cd_sweeps,
                                refine_rounds, cg_iters, backend)

    def _solver_kwargs(self) -> dict:
        """The directional-average system has rank nshells + 1 and a small
        ridge, so masked-CG convergence is set by conditioning, not by the
        working set's size: the FISTA + CD warm start with a flat CG budget
        (a per-round tuple is taken too), as in the JAX package."""
        sp = getattr(self, 'solver_params', {})
        cg = sp.get('cg_iters', DEFAULT_CG_ITERS)
        return {
            'fista_iters': int(sp.get('fista_iters', DEFAULT_FISTA_ITERS)),
            'cd_sweeps': int(sp.get('cd_sweeps', DEFAULT_CD_SWEEPS)),
            'refine_rounds': int(sp.get('refine_rounds',
                                        DEFAULT_REFINE_ROUNDS)),
            'cg_iters': (tuple(int(v) for v in cg)
                         if isinstance(cg, (tuple, list)) else int(cg)),
        }

    def generate(self, out_path, aux, idx_in, idx_out, ndirs):
        """Spheres, astrosticks and balls, all rotated as isotropic."""
        if self.scheme.version != 1:
            ERROR('This model requires a "VERSION: STEJSKALTANNER" scheme')
        scheme_high = _lut.create_high_resolution_scheme(self.scheme,
                                                         grad=aux.get('grad'))
        sphere = SphereGPD(scheme_high)
        astrosticks = Astrosticks(scheme_high)
        ball = Ball(scheme_high)
        atoms = [(sphere, (self.d_is, R)) for R in self.Rs] \
            + [(astrosticks, (d,)) for d in self.d_in] \
            + [(ball, (d,)) for d in self.d_isos]
        with ProgressBar(total=len(atoms),
                         disable=get_verbose() < 3) as pbar:
            for idx, (compartment, args) in enumerate(atoms):
                signal = compartment.get_signal(*args)
                self._save_atom(out_path, idx + 1, _lut.rotate_kernel(
                    signal, aux, idx_in, idx_out, True, ndirs))
                pbar.update()

    def resample(self, in_path, idx_out, Ylm_out, doMergeB0, ndirs):
        """KERNELS layout of the JAX package: 'signal' (nS, n) with each
        atom L2-normalised, and 'norms' (n,) the inverse norms."""
        nATOMS = len(self.Rs) + len(self.d_in) + len(self.d_isos)
        nS, merge_idx = self._merge_idx(doMergeB0)
        KERNELS = {'model': self.id}
        KERNELS['signal'] = np.zeros((nS, nATOMS), dtype=np.float64, order='F')
        KERNELS['norms'] = np.zeros(nATOMS, dtype=np.float64)

        with ProgressBar(total=nATOMS, disable=get_verbose() < 3) as pbar:
            for idx in range(nATOMS):
                lm = self._load_atom(in_path, idx + 1, ndirs, isotropic=True)
                signal = _lut.resample_kernel(
                    lm, self.scheme.nS, idx_out, Ylm_out, True, ndirs)[merge_idx].T
                KERNELS['norms'][idx] = 1.0 / np.linalg.norm(signal)
                KERNELS['signal'][:, idx] = signal * KERNELS['norms'][idx]
                pbar.update()
        return KERNELS

    def prepare(self, kernels: dict, device) -> tuple:
        """(A (nS, n), G, L, norms) on ``device``, float32."""
        device = torch.device(device)
        A = torch.as_tensor(kernels['signal'], dtype=torch.float32,
                            device=device)
        G = gram(A)
        return (A, G, power_iteration_L(G),
                torch.as_tensor(kernels['norms'], dtype=torch.float32,
                                device=device))

    def fit(self, evaluation):
        """Direction-free fit over one shared dictionary, in chunks that are
        all dispatched before any result is pulled."""
        device = resolve_device(evaluation.get_config('device'))
        configs = self._common_configs(evaluation)
        solver_kw = self._solver_kwargs()
        if self.solver_params.get('backend', 'auto') not in ('auto', 'xla'):
            WARNING("SANDI's direction-free fit always uses the batched "
                    "XLA solver (one shared 15-atom dictionary -- a VMEM "
                    "tile kernel has nothing to gain); 'backend' ignored")
        lam1 = float(self.solver_params['lambda1'])
        lam2 = float(self.solver_params['lambda2'])
        kernels = evaluation.KERNELS
        A, G, Lc, norms = self._constants(
            (kernels['signal'],), _concrete(device),
            lambda: self.prepare(kernels, device))
        f32 = dict(dtype=torch.float32, device=device)
        Rs = torch.as_tensor(self.Rs, **f32)
        d_in = torch.as_tensor(self.d_in, **f32)
        d_isos = torch.as_tensor(self.d_isos, **f32)

        def fit_chunk(Y):
            b = torch.matmul(Y, A)
            x = nneg_qp_batch(G, b, lam1, lam2, L=Lc, **solver_kw)
            out = {'estimates': sandi_estimates(x * norms, Rs, d_in, d_isos)}
            # the shared dictionary as a one-tile batch; A x is the
            # un-normalised prediction
            out.update({k: v[0] for k, v in error_maps(
                A[None], x[None], Y[None], configs['compute_rmse'],
                configs['compute_nrmse']).items()})
            return out

        y = np.asarray(evaluation.y, np.float32)
        N = y.shape[0]
        vpc = evaluation.get_config('voxels_per_chunk')
        chunk = sandi_chunk(N, vpc)
        # the signal's chunks stay on the card across fits of the same
        # evaluation.y (array identity)
        stage_key = (evaluation.y, chunk, device)
        staged = getattr(self, '_stage_cache', None)
        if staged is not None and staged[0][0] is stage_key[0] \
                and staged[0][1:] == stage_key[1:]:
            chunks_dev = staged[1]
        else:
            chunks_dev = {}
            self._stage_cache = (stage_key, chunks_dev)
        timers = {}
        pending = []
        with torch.no_grad(), trace.span('dispatch') as sp:
            for start in range(0, N, chunk):
                Yc_dev = chunks_dev.get(start)
                if Yc_dev is None:
                    Yc = y[start:start + chunk]
                    # 'auto' pads a lone chunk to its rounded size as the
                    # JAX package does; an explicit size keeps it as it is
                    pad = chunk - Yc.shape[0] if Yc.shape[0] < chunk and (
                        vpc in (None, 'auto') or N > chunk) else 0
                    if pad:
                        Yc = np.concatenate(
                            [Yc, np.zeros((pad, y.shape[1]), y.dtype)])
                    Yc_dev = chunks_dev[start] = torch.from_numpy(
                        np.ascontiguousarray(Yc)).to(device)
                pending.append((min(chunk, N - start), fit_chunk(Yc_dev)))
        timers['n_chunks'] = len(pending)
        timers['dispatch_s'] = sp.elapsed
        with trace.span('device_wait') as sp:
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
        timers['device_s'] = sp.elapsed
        with trace.span('pull') as sp:
            outs: dict[str, list] = {}
            for take, res in pending:
                for k, v in res.items():
                    outs.setdefault(k, []).append(
                        v[:take].float().cpu().numpy())
            out = {k: np.concatenate(v) for k, v in outs.items()}
        timers['pull_s'] = sp.elapsed
        self._last_fit_timers = timers
        return out
