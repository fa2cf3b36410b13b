"""Model base class and the torch tile driver (counterpart of
``amico_tpu.models.base``).

The host helpers, the checkpoint fingerprint and the NODDI schedule
constant are copied from the JAX package, whose module imports jax.
``_run_tiled_fit`` replaces the JAX driver: within ``max_device_bytes`` it
gathers each chunk from the signal staged on the device, beyond it it
streams host-tiled chunks from pinned memory, with the same chunks and maps
in both modes and over a ``mesh``.  As in the JAX driver,
``tile_size='auto'`` is ``engine.auto_tile_size``'s on the model's kernel
ladder, and a re-fit of the same objects reuses the LUT quantization and
tile plans (``_plans``), the staged inputs (``_staged``) and the model's
device constants (``_prep``), each a ``warm.Kept``; the facade hands the
driver its upload of the signal in a ``Handoff``.  The driver's phases are
spans of ``trace``, from which ``_last_fit_timers`` is built.
"""
from __future__ import annotations

import hashlib
import os
from abc import ABC, abstractmethod
from collections import namedtuple
from functools import cached_property
from os.path import join as pjoin

import numpy as np
import torch

from .. import lut as _lut
from .. import trace
from ..utils.logging import ERROR
from ..warm import Kept, PerDevice
from .engine import (auto_tile_size, build_tile_plan, iter_tile_chunks,
                     tile_voxels, untile_voxels)

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
# tile width of 'auto' off a CUDA card and on the stagewise solver: the width
# the JAX package uses off its accelerator.  On a CUDA card the tile kernels'
# widths come from engine.auto_tile_size on each model's kernel ladder
# (BaseModel._tile_size)
DEFAULT_TILE_SIZE = 128
# voxels per dispatched chunk, in both staging modes: bounds the per-chunk
# gathered dictionaries and Grams (about 230 KB per 128-voxel tile of the
# full NODDI grid).  The JAX driver's rule for a staged signal, at most 4
# equal chunks (there to hide 3 of 4 chunks' copies to the host behind
# compute), gained nothing here: at 128 voxels a tile, its warm fits in
# turns against this size's read NODDI 0.089 against 0.090 s, FreeWater
# 0.071 against 0.072, CZB (K2) 0.127 against 0.134, with device waits of
# 0.0446 / 0.0432, 0.0256 / 0.0240 and 0.0828 / 0.0853 s (tools/fit_turns.py
# --config-b voxels_per_chunk=110848 on an H100 80GB HBM3, 700 W; PERF.md)
DEFAULT_VOXELS_PER_CHUNK = 65536
# the signal is staged on the device whole up to this many float32 bytes,
# and streamed in chunks beyond it (the JAX package's default)
DEFAULT_MAX_DEVICE_BYTES = 4 << 30


_SECOND_STREAMS = PerDevice()


def _concrete(device) -> torch.device:
    """``device`` with its index: 'cuda' is the current card, so that a
    tensor's device (always indexed) compares equal to it."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


def _to_host(tensors: dict) -> dict:
    """Each tensor of ``tensors`` as a NumPy array: a CUDA tensor's in one
    non-blocking copy into pinned host memory (from the caching host
    allocator, which keeps the block for a later copy once the array is
    dropped), after one synchronise of the current streams; a CPU tensor as
    it is.  Into pinned memory the copy of a FreeWater fit's (409,600, 99)
    corrected DWI took 3.1 ms against 63.9 into pageable memory on an H100
    80GB HBM3 at 700 W (tools/tile_widths.py --d2h; PERF.md)."""
    out, cards = {}, set()
    for k, t in tensors.items():
        if t.device.type == 'cuda':
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            cards.add(t.device)
            t = host
        out[k] = t
    for d in cards:
        torch.cuda.current_stream(d).synchronize()
    return {k: t.numpy() for k, t in out.items()}


# the facade's ``evaluation.handoff`` to the tile driver during a fit: its
# upload (N+1, nS) of ``evaluation.y``, if any, and if the rows stay there
Handoff = namedtuple('Handoff', 'y_ext rows_on_device', defaults=(None, False))


class _Plans:
    """The LUT index of each voxel's direction, the tile plans by width and
    the direction buckets' sizes (for 'auto', made on the first ask)."""

    def __init__(self, lut_idx: np.ndarray):
        self.lut_idx, self.by_width = lut_idx, {}

    @cached_property
    def counts(self) -> np.ndarray:
        return np.unique(self.lut_idx, return_counts=True)[1]


# a gathered fit's inputs by device: the plan's (permutation, tile directions,
# masks), and the driver's own padded signal where the facade handed none
_Staged = namedtuple('_Staged', 'plan signal')


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
    second = _SECOND_STREAMS.on(index, lambda: torch.cuda.Stream(index))
    second.wait_stream(current)
    return [current, second]


class BaseModel(ABC):
    """Base class for microstructure models (same contract as the JAX
    package's: set / get_params / set_solver / generate / resample / fit)."""

    # the tile kernel's widths and per-tile overhead (in voxel slots) on a
    # CUDA card, the arguments of engine.auto_tile_size; None: the model
    # runs no tile kernel and 'auto' is DEFAULT_TILE_SIZE
    _tile_widths: tuple | None = None
    _tile_step_overhead = 0.0

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

    def _solver_backend(self, device=None) -> str:
        """Resolve ``backend='auto'`` for a fit on ``device``: 'pallas' (the
        tile kernels) on a CUDA card, where the kernels were measured
        faster (PERF.md); off it, 'xla' (the stagewise solver) for a model
        with the ``_prefer_xla_backend`` hint (CylinderZeppelinBall) and
        'pallas' otherwise, as the JAX package resolves on its TPU, so that
        the CPU fits compare with the JAX package's like with like."""
        backend = str(getattr(self, 'solver_params', {}).get(
            'backend', DEFAULT_BACKEND))
        if backend == 'auto':
            cuda = device is not None and torch.device(device).type == 'cuda'
            backend = 'xla' if getattr(self, '_prefer_xla_backend', False) \
                and not cuda else 'pallas'
        if backend not in ('xla', 'pallas'):
            raise ValueError(f"backend must be 'auto', 'xla' or 'pallas', "
                             f'got {backend!r}')
        return backend

    # the warm re-fit state: LUT quantization and tile plans (_Plans), staged
    # inputs (_Staged; SANDI's chunks), device constants (a PerDevice)
    _plans, _staged, _prep = Kept.slot(), Kept.slot(), Kept.slot()

    def release_staged(self):
        """Free what the model's driver keeps staged on its devices."""
        self._staged.drop()

    def _constants(self, key: tuple, device: torch.device, build):
        """The fit's device constants on ``device``, kept across fits as
        the JAX package's ``_prep_cache``, one set a device (a mesh's cards
        each keep theirs): ``key[0]`` is the KERNELS array they come from,
        compared by identity, the rest by value; ``build()`` on a miss."""
        consts, _ = self._prep.get(key[:1], key[1:], PerDevice)
        return consts.on(device, build)

    def _ckpt_fingerprint(self, plan, tile_size: int, y: np.ndarray,
                          y_sum: float | None = None) -> np.ndarray:
        """Mid-fit checkpoint fingerprint, the JAX package's recipe: pins
        everything a resumed chunk's values depend on -- the tile plan
        (voxel bucketing), the signal content, and the model/solver
        parameters.  A crash-rerun with a changed lambda or an edited
        volume must recompute, not merge stale chunks.  ``y_sum`` takes the
        strided sum of the signal the driver already took for its cache
        key."""
        pstride = max(1, plan.perm.size // 65536)
        perm_sum = int(np.sum(plan.perm[::pstride], dtype=np.int64))
        if y_sum is None:
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

    def _tile_size(self, evaluation, plans, backend: str, devices) -> int:
        """The fit's tile width: the ``tile_size`` config when it is set;
        else, on the tile kernels (``backend`` 'pallas') on CUDA cards,
        ``engine.auto_tile_size`` over the direction buckets' sizes on the
        model's kernel ladder (the counts kept in ``plans``, as the JAX
        driver keeps them); else DEFAULT_TILE_SIZE."""
        cfg = evaluation.get_config('tile_size')
        if cfg not in (None, 'auto'):
            return int(cfg)
        if backend != 'pallas' or self._tile_widths is None \
                or any(d.type != 'cuda' for d in devices):
            return DEFAULT_TILE_SIZE
        return auto_tile_size(plans.counts, self._tile_widths,
                              self._tile_step_overhead)

    # ------------------------------------------------- tiled fit driver
    def _run_tiled_fit(self, evaluation, chunk_fn_for, n_outputs_like: dict,
                       device: torch.device):
        """Drive the model's chunk function over all voxels, tile by tile.

        ``chunk_fn_for(device)`` builds the model's constants on ``device``
        and returns the chunk function there: ``fit_chunk(Y (C, M, nS) f32,
        dirs (C,) int64, valid (C, M) bool)`` gets tensors on that device
        and returns a dict of tensors with leading dims (C, M).
        ``n_outputs_like``: {name: trailing shape} of the outputs.  Returns
        a dict of (N, ...) float32 NumPy arrays in the original voxel
        order.  The tile width is :meth:`_tile_size`'s.

        Gathered on one device (no mesh, no checkpoint), each chunk's
        outputs are written in voxel order into an (N+1, ...) buffer on the
        device, on the chunk's stream (``index_copy_`` by the plan's
        permutation; the padding slots land in row N, dropped), and each
        buffer is copied to the host once after the last chunk; on a CUDA
        card, an ``evaluation`` whose ``handoff`` asks for it (the facade's
        single-process, meshless fit) gets the (N, ...) rows on the card
        instead, as tensors.  Otherwise
        each chunk's outputs are copied into a tiled host buffer (pinned
        for a CUDA device) on the chunk's stream as soon as it is computed,
        and untiled on the host at the end.  Both give the same maps, bit
        for bit.

        Every chunk goes to ``device``, or with the ``mesh`` config
        (``parallel.make_mesh``) whole chunks go to the mesh's devices
        round robin, each device with its own constants and its own copy
        of the staged signal.  The chunk boundaries are those of a
        one-device fit whatever the mesh, and so are the maps: a chunk is
        never split, since the stagewise solver's exits are batch-wide
        over a chunk.  The devices of the first chunks are recorded as
        ``_last_fit_devices``.

        With the ``fit_checkpoint`` config, every ``checkpoint_every``
        dispatched chunks the chunks done so far are written to that file
        (``plan_fp``, ``done_until`` and one array per output, replaced
        atomically); a rerun of the same fit skips the chunks below
        ``done_until``, and the file is deleted when the fit completes."""
        from ..parallel.mesh import Mesh
        with trace.span('plan') as plan_sp:
            mesh = evaluation.get_config('mesh')
            if mesh is None:
                mesh = Mesh([device])
            elif not isinstance(mesh, Mesh):
                ERROR('config "mesh" must be a mesh from '
                      f'amico_tpu_torch.parallel.make_mesh(), got {mesh!r}')
            devices = [_concrete(d) for d in mesh.devices]
            y = np.asarray(evaluation.y)
            with trace.span('quantize', cached=True) as sp:
                # the LUT index of each voxel's direction and the tile plans
                # by width depend on DIRs alone: a fit of the same DIRs and
                # htable objects with the same strided content sum of DIRs
                # (an in-place edit misses) reuses them
                DIRs = np.asarray(evaluation.DIRs, np.float64)
                dstride = max(1, DIRs.size // 65536)
                dirs_fp = (DIRs.shape, float(np.sum(
                    DIRs.ravel()[::dstride], dtype=np.float64)))
                plans, sp.attrs['cached'] = self._plans.get(
                    (evaluation.DIRs, evaluation.htable), (dirs_fp,),
                    lambda: _Plans(_lut.dir_to_lut_idx(DIRs,
                                                       evaluation.htable)))
            with trace.span('tile_plan', cached=True) as sp:
                tile_size = self._tile_size(
                    evaluation, plans, self._solver_backend(devices[0]),
                    devices)
                vpc = evaluation.get_config('voxels_per_chunk')
                vpc = DEFAULT_VOXELS_PER_CHUNK if vpc in (None, 'auto') \
                    else int(vpc)
                chunk_tiles = max(1, vpc // tile_size)
                plan = plans.by_width.get(tile_size)
                if plan is None:
                    sp.attrs['cached'] = False
                    plan = plans.by_width[tile_size] = build_tile_plan(
                        plans.lut_idx, tile_size)

            # the JAX driver's rule on the float32 bytes that would be
            # staged (on each device of a mesh): within the budget the flat
            # signal is staged once and each chunk gathered on the device;
            # beyond it host-tiled chunks stream, at most max_inflight of
            # them on the devices at once, none cached
            budget = int(evaluation.get_config('max_device_bytes')
                         or DEFAULT_MAX_DEVICE_BYTES)
            M, nS = tile_size, y.shape[1]
            device_gather = y.size * 4 <= budget
            max_inflight = max(2, budget // max(chunk_tiles * M * nS * 4, 1))

            # a strided sum of the signal: the staged inputs' key and the
            # checkpoint's fingerprint
            ystride = max(1, y.size // 65536)
            y_sum = float(np.sum(y.ravel()[::ystride], dtype=np.float64))
            ckpt_path = evaluation.get_config('fit_checkpoint')
            gathered = device_gather and not ckpt_path \
                and evaluation.get_config('mesh') is None
            N = y.shape[0]
            if gathered:
                # the outputs in voxel order on the device: every voxel's
                # row is written once, the padding slots' all go to row N
                out_dev = {k: torch.empty((N + 1,) + shape,
                                          dtype=torch.float32,
                                          device=devices[0])
                           for k, shape in n_outputs_like.items()}
            else:
                # pinned for a CUDA device, so that each chunk's copy runs
                # on its stream as soon as the chunk is done
                pin = any(d.type == 'cuda' for d in devices)
                out_t = {k: torch.zeros((plan.n_tiles, tile_size) + shape,
                                        dtype=torch.float32, pin_memory=pin)
                         for k, shape in n_outputs_like.items()}
                out_tiles = {k: t.numpy() for k, t in out_t.items()}
            # a checkpoint is merged only when it matches this exact fit
            # (the fingerprint) and holds every requested output
            ckpt_every = int(evaluation.get_config('checkpoint_every') or 4)
            done_until = 0
            if ckpt_path:
                ck_fp = self._ckpt_fingerprint(plan, tile_size, y,
                                               y_sum=y_sum)
                if os.path.isfile(ckpt_path):
                    with np.load(ckpt_path) as ck:
                        if 'plan_fp' in ck \
                                and np.array_equal(ck['plan_fp'], ck_fp) \
                                and all(k in ck for k in out_tiles):
                            done_until = int(ck['done_until'])
                            for k in out_tiles:
                                out_tiles[k][:done_until] = \
                                    ck[k][:done_until]
            handoff = getattr(evaluation, 'handoff', None) or Handoff()
            with trace.span('stage_inputs', cached=True) as sp:
                inputs, Y_host = self._staged_inputs(
                    evaluation, handoff.y_ext, y, y_sum, plan, tile_size,
                    chunk_tiles, device_gather, devices, sp)
        timers = {'setup_s': plan_sp.elapsed,
                  'streamed': int(not device_gather),
                  'staged_shared': sp.attrs['shared'], 'tile_size': tile_size,
                  'chunk_tiles': chunk_tiles}

        def pull(done):
            """Wait until a chunk's outputs are on the host."""
            if done is not None:
                done.synchronize()

        pending = []
        n_dispatched = 0
        with trace.span('dispatch') as disp_sp:
            # each device's chunk function, built before its streams are
            # taken: the second stream waits for the constants queued on
            # the current
            fns = [chunk_fn_for(d) for d in devices]
            streams = [_chunk_streams(d) for d in devices]
            first_devices = []
            chunks = iter_tile_chunks(plan.n_tiles, chunk_tiles)
            for i, (start, stop, _pad) in enumerate(chunks):
                if stop <= done_until:
                    continue
                # the last chunk runs short instead of padded: eager
                # dispatch has no compiled shape to keep
                j = i % len(devices)
                d = devices[j]
                k_stream = (i // len(devices)) % len(streams[j])
                stream = streams[j][k_stream]
                y_ext, perm, dirs_t, valid_t = inputs[d]
                with trace.span('chunk', start=start, stop=stop,
                                stream=k_stream), torch.cuda.stream(stream):
                    if device_gather:
                        idx = perm[start * M:stop * M]
                        Yc = y_ext.index_select(0, idx).view(stop - start,
                                                             M, nS)
                    else:
                        Yc = torch.from_numpy(Y_host[start:stop])
                        if d.type == 'cuda':
                            Yc = Yc.pin_memory().to(d, non_blocking=True)
                    res = fns[j](Yc, dirs_t[start:stop], valid_t[start:stop])
                    # on the chunk's stream, so after the chunk's work; the
                    # result blocks are freed to that stream, so the
                    # allocator reuses them only after these copies
                    for k, arr in res.items():
                        if gathered:
                            out_dev[k].index_copy_(
                                0, idx,
                                arr.reshape((-1,) + out_dev[k].shape[1:])
                                .float())
                        else:
                            out_t[k][start:stop].copy_(arr,
                                                       non_blocking=True)
                    done = None
                    if stream is not None:
                        done = torch.cuda.Event()
                        done.record(stream)
                del Yc, res
                if len(first_devices) < len(devices):
                    first_devices.append(d)
                pending.append(done)
                n_dispatched += 1
                if len(pending) >= max_inflight:
                    pull(pending.pop(0))
                if ckpt_path and n_dispatched % ckpt_every == 0:
                    for done in pending:
                        pull(done)
                    pending = []
                    np.savez(ckpt_path + '.tmp', plan_fp=ck_fp,
                             done_until=stop, **out_tiles)
                    os.replace(ckpt_path + '.tmp.npz', ckpt_path)
        timers['dispatch_s'] = disp_sp.elapsed
        timers['n_chunks'] = n_dispatched
        with trace.span('device_wait') as sp:
            for d in dict.fromkeys(devices):
                if d.type == 'cuda':
                    torch.cuda.synchronize(d)
        timers['device_s'] = sp.elapsed
        # the device counts of the chunks (K2's rounds), now complete
        trace.settle()

        # every device is synchronised: the buffers written on the second
        # stream are complete, and freed only after their copies below
        with trace.span('pull') as sp:
            if gathered:
                out = {k: v[:N] for k, v in out_dev.items()}
                # the facade's own fit asks for the rows on the card, where
                # it scatters them into volumes
                if devices[0].type != 'cuda' or not handoff.rows_on_device:
                    out = _to_host(out)
                del out_dev
        timers['pull_s'] = sp.elapsed
        if ckpt_path and os.path.isfile(ckpt_path):
            os.remove(ckpt_path)
        # the host untile: the streamed, mesh and checkpointed fits only
        timers['untile_s'] = 0.0
        if not gathered:
            with trace.span('untile') as sp:
                out = {k: untile_voxels(plan, v)
                       for k, v in out_tiles.items()}
            timers['untile_s'] = sp.elapsed
        self._last_fit_timers = timers
        self._last_fit_devices = first_devices
        return out

    def _staged_inputs(self, evaluation, facade, y, y_sum, plan, tile_size,
                       chunk_tiles, device_gather, devices, sp):
        """Each device's inputs of the chunks (the staged signal, the plan's
        permutation, tile directions and masks; the signal and permutation
        None when streamed) and the host-tiled signal when streamed (else
        None).  On the span ``sp``: ``cached``, and ``shared``, whether the
        facade's upload ``facade`` is the staged signal.

        Kept across fits in gathered mode only.  The JAX driver's key, with
        the mesh's devices and whether a mesh was given in place of its
        sharding (a one-card mesh and no mesh have the same devices, but
        only without a mesh does the facade stage the signal), and the plan
        compared exactly (the JAX key's strided sum of the permutation
        stays the same when new directions move voxels between tiles).  A
        miss or a streamed fit drops the old inputs before anything new is
        placed."""
        nS = y.shape[1]

        def tiles(d):
            return (torch.from_numpy(plan.tile_dirs.astype(np.int64)).to(d),
                    torch.from_numpy(plan.valid).to(d))
        if not device_gather:
            self._staged.drop()
            sp.attrs.update(cached=False, shared=0)
            return ({d: (None, None) + tiles(d) for d in devices},
                    tile_voxels(plan, y.astype(np.float32, copy=False)))
        staged, sp.attrs['cached'] = self._staged.get(
            (evaluation.y,), ((y.shape, y_sum), tile_size, chunk_tiles,
                              tuple(devices),
                              evaluation.get_config('mesh') is None, plan),
            lambda: _Staged({}, {}))
        inputs, host = {}, None
        for d in devices:
            if d not in staged.plan:
                staged.plan[d] = (
                    torch.from_numpy(plan.perm.astype(np.int64)).to(d),
                ) + tiles(d)
            y_ext = facade if facade is not None and facade.device == d \
                else staged.signal.get(d)
            if y_ext is None:
                if host is None:
                    host = torch.from_numpy(np.concatenate(
                        [y.astype(np.float32, copy=False),
                         np.zeros((1, nS), np.float32)]))
                y_ext = staged.signal[d] = host.to(d)
            inputs[d] = (y_ext,) + staged.plan[d]
        sp.attrs['shared'] = int(facade is not None
                                 and facade.device in devices)
        return inputs, None
