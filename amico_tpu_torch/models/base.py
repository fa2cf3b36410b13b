"""Model base class and the torch tile driver (counterpart of
``amico_tpu.models.base``).

The host helpers and the NODDI schedule constant are copied from the JAX
package, whose module imports jax.  ``_run_tiled_fit`` replaces the JAX
driver: one float32 upload of the padded (N+1, nS) signal, a per-chunk
``index_select`` gather from the tile plan, every chunk dispatched before
any result is pulled, and outputs untiled to (N, ...) NumPy arrays.
"""
from __future__ import annotations

import time
from abc import ABC, abstractmethod
from os.path import join as pjoin

import numpy as np
import torch

from .. import lut as _lut
from ..utils.logging import ERROR
from .engine import build_tile_plan, iter_tile_chunks, untile_voxels

DEFAULT_BACKEND = 'auto'
DEFAULT_FISTA_ITERS = 40
DEFAULT_CD_SWEEPS = 4
DEFAULT_REFINE_ROUNDS = 12
DEFAULT_CG_ITERS = 12
# NODDI per-stage schedule ((fista, rounds, cg, inner, converge, add_k) x2,
# (rounds, cg, inner) for the warm-started debias), as in the JAX package:
# pure Lawson-Hanson from the empty working set with per-round CG budgets,
# validated there against the exact oracle on the full dictionary
DEFAULT_NODDI_STAGE_ITERS = ((0, 4, (4, 6, 8, 10), 1, False, 2),
                             (0, 6, (3, 5, 8, 10, 12, 14),
                              (1, 1, 2, 2, 2, 2), False, 2),
                             (6, (16, 10, 8, 8, 8, 8), 2))
# FreeWater's single solve, as in the JAX package (SANDI and
# CylinderZeppelinBall take their own, below and in their modules):
# Lawson-Hanson from the empty working set with per-round CG budgets, and
# `converge` rounds past the schedule until the tile's working sets are
# stable, so no support is cut at the round count
DEFAULT_AS_SOLVER_KW = {
    'fista_iters': 0,
    'cd_sweeps': 0,
    'refine_rounds': 12,
    'cg_iters': (6, 6, 6, 10, 10, 10, 12, 12, 12, 12, 12, 12),
    'converge': True,
}
# dense-support default (CylinderZeppelinBall's lambda2=4 ridge spreads the
# support over all its correlated atoms): FISTA first, a few rounds after
DENSE_AS_SOLVER_KW = {
    'fista_iters': 80,
    'cd_sweeps': 8,
    'refine_rounds': 6,
    'cg_iters': 16,
    'converge': True,
}
# tile width: the width the JAX package uses off the TPU.  Its TPU
# lane-width cost model is not carried over (ROADMAP: tile width on the H100)
DEFAULT_TILE_SIZE = 128
# voxels per dispatched chunk: bounds the per-chunk gathered dictionaries
# and Grams (about 230 KB per 128-voxel tile of the full NODDI grid)
DEFAULT_VOXELS_PER_CHUNK = 65536
DEFAULT_MAX_DEVICE_BYTES = 4 << 30


_SECOND_STREAMS: dict = {}


def _chunk_streams(device) -> list:
    """The streams the tile chunks go to, round robin: on a CUDA card the
    current stream and a second one, so that one chunk's last tiles (the
    `converge` tail of a tile solve) overlap the next chunk's; else None,
    for which ``torch.cuda.stream`` changes nothing.  The second waits for
    what the current one has queued (the uploads and the model's
    constants); every tensor it reads lives until the fit's synchronize.
    It is made once a card: the caching allocator keeps a stream's freed
    blocks for that stream, so a new one each fit would allocate its
    chunks' memory anew."""
    if device.type != 'cuda':
        return [None]
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    current = torch.cuda.current_stream(index)
    second = _SECOND_STREAMS.get(index)
    if second is None:
        second = _SECOND_STREAMS[index] = torch.cuda.Stream(index)
    second.wait_stream(current)
    return [current, second]


class BaseModel(ABC):
    """Base class for microstructure models (same contract as the JAX
    package's: set / get_params / set_solver / generate / resample / fit)."""

    @abstractmethod
    def __init__(self):
        self.id = 'BaseModel'
        self.name = 'Base Model'
        self.maps_name: list[str] = []
        self.maps_descr: list[str] = []
        self.scheme = None

    @abstractmethod
    def set(self, *args, **kwargs):
        ...

    @abstractmethod
    def get_params(self):
        ...

    def set_solver(self, **kwargs):
        """Initialize solver params; subclasses add model defaults."""
        self.solver_params = {
            'fista_iters': DEFAULT_FISTA_ITERS,
            'cd_sweeps': DEFAULT_CD_SWEEPS,
            'refine_rounds': DEFAULT_REFINE_ROUNDS,
            'cg_iters': DEFAULT_CG_ITERS,
            'backend': DEFAULT_BACKEND,
        }

    @abstractmethod
    def generate(self, out_path, aux, idx_in, idx_out, ndirs):
        ...

    @abstractmethod
    def resample(self, in_path, idx_out, Ylm_out, doMergeB0, ndirs):
        ...

    @abstractmethod
    def fit(self, evaluation):
        """Returns the result dict: 'estimates' (+'rmse', 'nrmse',
        'estimates_mod')."""
        ...

    # ------------------------------------------------------------ helpers
    def _save_atom(self, out_path: str, idx: int, lm: np.ndarray) -> None:
        """Kernel LUT file layout shared with the JAX package."""
        np.save(pjoin(out_path, f'A_{idx:03d}.npy'), lm)

    def _load_atom(self, in_path: str, idx: int, ndirs: int,
                   isotropic: bool = False) -> np.ndarray:
        lm = np.load(pjoin(in_path, f'A_{idx:03d}.npy'))
        if not isotropic and lm.shape[0] != ndirs:
            ERROR('Outdated LUT. Call "generate_kernels( regenerate=True )" to update the LUT')
        return lm

    def _merge_idx(self, doMergeB0: bool):
        """(nS, merge_idx) handling of the doMergeB0 option."""
        if doMergeB0:
            nS = 1 + self.scheme.dwi_count
            merge_idx = np.hstack((self.scheme.b0_idx[0], self.scheme.dwi_idx))
        else:
            nS = self.scheme.nS
            merge_idx = np.arange(self.scheme.nS)
        return nS, merge_idx

    def _common_configs(self, evaluation) -> dict:
        return {
            'compute_rmse': bool(evaluation.get_config('doComputeRMSE')),
            'compute_nrmse': bool(evaluation.get_config('doComputeNRMSE')),
        }

    def _set_solver_common(self, lambda1, lambda2, fista_iters=None,
                           cd_sweeps=None, refine_rounds=None, cg_iters=None,
                           backend=None):
        """Shared body for the per-model set_solver overrides."""
        BaseModel.set_solver(self)
        self.solver_params['lambda1'] = lambda1
        self.solver_params['lambda2'] = lambda2
        custom = False
        for key, val in (('fista_iters', fista_iters),
                         ('cd_sweeps', cd_sweeps),
                         ('refine_rounds', refine_rounds),
                         ('cg_iters', cg_iters)):
            if val is not None:
                self.solver_params[key] = (
                    tuple(int(x) for x in val)
                    if isinstance(val, (tuple, list)) else int(val))
                custom = True
        self.solver_params['custom_iters'] = custom
        if backend is not None:
            self.solver_params['backend'] = str(backend)

    def _solver_kwargs(self) -> dict:
        sp = getattr(self, 'solver_params', {})
        if not sp.get('custom_iters'):
            # the validated active-set default; users who set any iteration
            # knob get the uniform behaviour
            return dict(DEFAULT_AS_SOLVER_KW)
        return {
            'fista_iters': int(sp.get('fista_iters', DEFAULT_FISTA_ITERS)),
            'cd_sweeps': int(sp.get('cd_sweeps', DEFAULT_CD_SWEEPS)),
            'refine_rounds': int(sp.get('refine_rounds', DEFAULT_REFINE_ROUNDS)),
            'cg_iters': sp.get('cg_iters', DEFAULT_CG_ITERS),
        }

    def _solver_backend(self) -> str:
        """Resolve ``backend='auto'``: 'xla' (the stagewise solver) for a
        model with the ``_prefer_xla_backend`` hint (CylinderZeppelinBall),
        'pallas' (the tile kernels) otherwise, on either device.  The JAX
        package resolves the same on its TPU; the hint was chosen from TPU
        measurements and is kept so that 'auto' means the same in both
        packages (ROADMAP: re-derive it on the H100)."""
        backend = str(getattr(self, 'solver_params', {}).get(
            'backend', DEFAULT_BACKEND))
        if backend == 'auto':
            backend = 'xla' if getattr(self, '_prefer_xla_backend', False) \
                else 'pallas'
        if backend not in ('xla', 'pallas'):
            raise ValueError(f"backend must be 'auto', 'xla' or 'pallas', "
                             f'got {backend!r}')
        return backend

    # ------------------------------------------------- tiled fit driver
    def _run_tiled_fit(self, evaluation, fit_chunk_fn, n_outputs_like: dict,
                       device: torch.device):
        """Drive ``fit_chunk_fn`` over all voxels, tile by tile.

        ``fit_chunk_fn(Y (C, M, nS) f32, dirs (C,) int64, valid (C, M)
        bool)`` gets device tensors and returns a dict of device tensors
        with leading dims (C, M).  ``n_outputs_like``: {name: trailing
        shape} of the outputs.  Returns a dict of (N, ...) float32 NumPy
        arrays in the original voxel order."""
        t_enter = time.time()
        for key in ('mesh', 'distributed', 'fit_checkpoint'):
            if evaluation.get_config(key):
                raise NotImplementedError(
                    f'config "{key}" is not ported yet (ROADMAP queue 1: '
                    'mesh/dist and fit_checkpoint)')
        y = np.asarray(evaluation.y)
        lut_idx = _lut.dir_to_lut_idx(np.asarray(evaluation.DIRs, np.float64),
                                      evaluation.htable)
        cfg_tile = evaluation.get_config('tile_size')
        tile_size = DEFAULT_TILE_SIZE if cfg_tile in (None, 'auto') \
            else int(cfg_tile)
        vpc = evaluation.get_config('voxels_per_chunk')
        vpc = DEFAULT_VOXELS_PER_CHUNK if vpc in (None, 'auto') else int(vpc)
        chunk_tiles = max(1, vpc // tile_size)
        plan = build_tile_plan(lut_idx, tile_size)

        budget = int(evaluation.get_config('max_device_bytes')
                     or DEFAULT_MAX_DEVICE_BYTES)
        if (y.shape[0] + 1) * y.shape[1] * 4 > budget:
            raise NotImplementedError(
                f'the signal ({y.shape}) exceeds max_device_bytes={budget}; '
                'streaming host-tiled chunks is not ported yet')
        staged = getattr(evaluation, '_staged_y_ext_dev', None)
        if staged is not None and staged[0] is y \
                and staged[1].device == device \
                and tuple(staged[1].shape) == (y.shape[0] + 1, y.shape[1]):
            y_ext = staged[1]           # the facade's upload, shared with DTI
        else:
            y_ext = torch.from_numpy(np.concatenate(
                [y.astype(np.float32, copy=False),
                 np.zeros((1, y.shape[1]), np.float32)])).to(device)

        perm = torch.from_numpy(plan.perm.astype(np.int64)).to(device)
        dirs_t = torch.from_numpy(plan.tile_dirs.astype(np.int64)).to(device)
        valid_t = torch.from_numpy(plan.valid).to(device)
        timers = {'setup_s': time.time() - t_enter}
        t_loop = time.time()
        pending = []
        M, nS = tile_size, y.shape[1]
        streams = _chunk_streams(device)
        chunks = iter_tile_chunks(plan.n_tiles, chunk_tiles)
        for i, (start, stop, _pad) in enumerate(chunks):
            # the last chunk runs short instead of padded: eager dispatch
            # has no compiled shape to keep
            with torch.cuda.stream(streams[i % len(streams)]):
                idx = perm[start * M:stop * M]
                Yc = y_ext.index_select(0, idx).view(stop - start, M, nS)
                pending.append((start, stop, fit_chunk_fn(
                    Yc, dirs_t[start:stop], valid_t[start:stop])))
        timers['dispatch_s'] = time.time() - t_loop
        timers['n_chunks'] = len(pending)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        timers['device_s'] = time.time() - t_loop - timers['dispatch_s']

        t_pull = time.time()
        out_tiles = {k: np.zeros((plan.n_tiles, tile_size) + shape, np.float32)
                     for k, shape in n_outputs_like.items()}
        for start, stop, res in pending:
            for k, arr in res.items():
                out_tiles[k][start:stop] = arr.float().cpu().numpy()
        timers['pull_s'] = time.time() - t_pull
        t_unt = time.time()
        out = {k: untile_voxels(plan, v) for k, v in out_tiles.items()}
        timers['untile_s'] = time.time() - t_unt
        self._last_fit_timers = timers
        return out
