"""Model base class and the torch tile driver (counterpart of
``amico_tpu.models.base``).

The host helpers, the checkpoint fingerprint and the NODDI schedule
constant are copied from the JAX package, whose module imports jax.
``_run_tiled_fit`` replaces the JAX driver.  Within ``max_device_bytes`` it
uploads the padded (N+1, nS) float32 signal once and gathers each chunk on
the device from the tile plan (``index_select``); beyond it, it streams
host-tiled chunks from pinned memory with a bounded number in flight.  The
chunking is the same in both modes, so are the maps.  Chunks are pulled as
late as the in-flight window and the ``fit_checkpoint`` cadence allow, and
the outputs are untiled to (N, ...) NumPy arrays.
"""
from __future__ import annotations

import hashlib
import os
import time
from abc import ABC, abstractmethod
from os.path import join as pjoin

import numpy as np
import torch

from .. import lut as _lut
from ..utils.logging import ERROR
from .engine import (build_tile_plan, iter_tile_chunks, tile_voxels,
                     untile_voxels)

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
# voxels per dispatched chunk, in both staging modes: bounds the per-chunk
# gathered dictionaries and Grams (about 230 KB per 128-voxel tile of the
# full NODDI grid)
DEFAULT_VOXELS_PER_CHUNK = 65536
# the signal is staged on the device whole up to this many float32 bytes,
# and streamed in chunks beyond it (the JAX package's default)
DEFAULT_MAX_DEVICE_BYTES = 4 << 30


_SECOND_STREAMS: dict = {}


def _chunk_streams(device) -> list:
    """The streams the tile chunks go to, round robin: on a CUDA card the
    current stream and a second one, so that one chunk's last tiles (the
    `converge` tail of a tile solve) overlap the next chunk's; else None,
    for which ``torch.cuda.stream`` changes nothing.  The second waits for
    what the current one has queued (the uploads and the model's
    constants).  A chunk's streamed input is uploaded on the chunk's own
    stream, so the allocator reuses its block only after that chunk's
    work, and a chunk's outputs are pulled only after the event recorded
    on its stream.  The second stream is made once a card: the caching
    allocator keeps a stream's freed blocks for that stream, so a new one
    each fit would allocate its chunks' memory anew."""
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

    def _ckpt_fingerprint(self, plan, tile_size: int,
                          y: np.ndarray) -> np.ndarray:
        """Mid-fit checkpoint fingerprint, the JAX package's recipe: pins
        everything a resumed chunk's values depend on -- the tile plan
        (voxel bucketing), the signal content, and the model/solver
        parameters.  A crash-rerun with a changed lambda or an edited
        volume must recompute, not merge stale chunks."""
        pstride = max(1, plan.perm.size // 65536)
        perm_sum = int(np.sum(plan.perm[::pstride], dtype=np.int64))
        ystride = max(1, y.size // 65536)
        y_sum = float(np.sum(y.ravel()[::ystride], dtype=np.float64))
        params_repr = repr((sorted(getattr(self, 'solver_params',
                                           {}).items()),
                            sorted(self.get_params().items(),
                                   key=lambda kv: kv[0])))
        params_h = int.from_bytes(
            hashlib.blake2b(params_repr.encode(), digest_size=8).digest(),
            'little', signed=True)
        return np.array([plan.n_tiles, tile_size, perm_sum,
                         params_h, np.float64(y_sum).view(np.int64)],
                        np.int64)

    # ------------------------------------------------- tiled fit driver
    def _run_tiled_fit(self, evaluation, fit_chunk_fn, n_outputs_like: dict,
                       device: torch.device):
        """Drive ``fit_chunk_fn`` over all voxels, tile by tile.

        ``fit_chunk_fn(Y (C, M, nS) f32, dirs (C,) int64, valid (C, M)
        bool)`` gets device tensors and returns a dict of device tensors
        with leading dims (C, M).  ``n_outputs_like``: {name: trailing
        shape} of the outputs.  Returns a dict of (N, ...) float32 NumPy
        arrays in the original voxel order.

        With the ``fit_checkpoint`` config, every ``checkpoint_every``
        dispatched chunks the chunks done so far are written to that file
        (``plan_fp``, ``done_until`` and one array per output, replaced
        atomically); a rerun of the same fit skips the chunks below
        ``done_until``, and the file is deleted when the fit completes."""
        t_enter = time.time()
        for key in ('mesh', 'distributed'):
            if evaluation.get_config(key):
                raise NotImplementedError(
                    f'config "{key}" is not ported yet (ROADMAP queue 1, '
                    'entry 10: mesh and dist)')
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

        # the JAX driver's rule on the float32 bytes that would be staged:
        # within the budget the flat signal is staged once and each chunk
        # gathered on the device; beyond it host-tiled chunks stream, at
        # most max_inflight of them on the device at once, none cached
        budget = int(evaluation.get_config('max_device_bytes')
                     or DEFAULT_MAX_DEVICE_BYTES)
        M, nS = tile_size, y.shape[1]
        device_gather = y.size * 4 <= budget
        max_inflight = max(2, budget // max(chunk_tiles * M * nS * 4, 1))

        out_tiles = {k: np.zeros((plan.n_tiles, tile_size) + shape, np.float32)
                     for k, shape in n_outputs_like.items()}
        # a checkpoint is merged only when it matches this exact fit (the
        # fingerprint) and holds every requested output
        ckpt_path = evaluation.get_config('fit_checkpoint')
        ckpt_every = int(evaluation.get_config('checkpoint_every') or 4)
        done_until = 0
        if ckpt_path:
            ck_fp = self._ckpt_fingerprint(plan, tile_size, y)
            if os.path.isfile(ckpt_path):
                with np.load(ckpt_path) as ck:
                    if 'plan_fp' in ck \
                            and np.array_equal(ck['plan_fp'], ck_fp) \
                            and all(k in ck for k in out_tiles):
                        done_until = int(ck['done_until'])
                        for k in out_tiles:
                            out_tiles[k][:done_until] = ck[k][:done_until]

        if device_gather:
            staged = getattr(evaluation, '_staged_y_ext_dev', None)
            if staged is not None and staged[0] is y \
                    and staged[1].device == device \
                    and tuple(staged[1].shape) == (y.shape[0] + 1, nS):
                y_ext = staged[1]       # the facade's upload, shared with DTI
            else:
                y_ext = torch.from_numpy(np.concatenate(
                    [y.astype(np.float32, copy=False),
                     np.zeros((1, nS), np.float32)])).to(device)
            perm = torch.from_numpy(plan.perm.astype(np.int64)).to(device)
        else:
            Y_host = tile_voxels(plan, y.astype(np.float32, copy=False))
        dirs_t = torch.from_numpy(plan.tile_dirs.astype(np.int64)).to(device)
        valid_t = torch.from_numpy(plan.valid).to(device)
        timers = {'setup_s': time.time() - t_enter,
                  'streamed': int(not device_gather)}

        def pull(item):
            """Copy one chunk's outputs to the host, once the stream that
            made them has finished the chunk."""
            start, stop, res, done = item
            if done is not None:
                done.synchronize()
            for k, arr in res.items():
                out_tiles[k][start:stop] = arr.float().cpu().numpy()

        t_loop = time.time()
        pending = []
        n_dispatched = 0
        streams = _chunk_streams(device)
        chunks = iter_tile_chunks(plan.n_tiles, chunk_tiles)
        for i, (start, stop, _pad) in enumerate(chunks):
            if stop <= done_until:
                continue
            # the last chunk runs short instead of padded: eager dispatch
            # has no compiled shape to keep
            stream = streams[i % len(streams)]
            with torch.cuda.stream(stream):
                if device_gather:
                    idx = perm[start * M:stop * M]
                    Yc = y_ext.index_select(0, idx).view(stop - start, M, nS)
                else:
                    Yc = torch.from_numpy(Y_host[start:stop])
                    if device.type == 'cuda':
                        Yc = Yc.pin_memory().to(device, non_blocking=True)
                res = fit_chunk_fn(Yc, dirs_t[start:stop], valid_t[start:stop])
                done = None
                if stream is not None:
                    done = torch.cuda.Event()
                    done.record(stream)
            del Yc
            pending.append((start, stop, res, done))
            n_dispatched += 1
            if len(pending) >= max_inflight:
                pull(pending.pop(0))
            if ckpt_path and n_dispatched % ckpt_every == 0:
                for item in pending:
                    pull(item)
                pending = []
                np.savez(ckpt_path + '.tmp', plan_fp=ck_fp, done_until=stop,
                         **out_tiles)
                os.replace(ckpt_path + '.tmp.npz', ckpt_path)
        timers['dispatch_s'] = time.time() - t_loop
        timers['n_chunks'] = n_dispatched
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        timers['device_s'] = time.time() - t_loop - timers['dispatch_s']

        t_pull = time.time()
        for item in pending:
            pull(item)
        timers['pull_s'] = time.time() - t_pull
        if ckpt_path and os.path.isfile(ckpt_path):
            os.remove(ckpt_path)
        t_unt = time.time()
        out = {k: untile_voxels(plan, v) for k, v in out_tiles.items()}
        timers['untile_s'] = time.time() - t_unt
        self._last_fit_timers = timers
        return out
