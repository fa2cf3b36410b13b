"""Orchestration facade of the port (counterpart of ``amico_tpu.core``).

Same public surface, call order and config keys as the JAX package:

    amico_tpu_torch.setup()
    ev = amico_tpu_torch.Evaluation(study_path, subject, device='cuda')
    ev.load_data(...); ev.set_model('NODDI')
    ev.generate_kernels(); ev.load_kernels(); ev.fit(); ev.save_results()

Host stages (NIfTI I/O, native preprocessing, LUT generation and
resampling, scatter, map writing) are the port's copies of the JAX
package's jax-free modules.
The fit uploads the padded float32 signal once to the ``device`` config's
device when it fits in ``max_device_bytes`` (the JAX facade's staging
rule); the DTI direction fit and the model's tile driver share that
upload.  Beyond the budget the DTI fit takes the host array and the tile
driver streams host-tiled chunks.  As in the JAX facade, a re-fit of the
same loaded data reuses the masked signal, its upload and the DTI
directions.  The Rician debias runs on the same device inside
``load_data``; ``profile_dir`` records the model fit with
``torch.profiler``.  Each stage runs in a span of ``trace`` (load_data,
load_kernels, the fit's stage_voxels, directions, model_fit and scatter,
save_results), from which the stage timers (``timers``,
``last_fit_timers()``) are read.  The ``mesh`` config
(``parallel.make_mesh``) spreads the tile driver's chunks over the cards
of one process; ``distributed`` (after ``parallel.dist.initialize``) gives
each process a slab of the voxels on its own card, gathers the maps on
every process and lets process 0 alone write them, as the JAX facade
does.
"""
from __future__ import annotations

import contextlib
import glob
import pickle
import time
from os import cpu_count, makedirs, remove, replace
from os.path import exists, isfile, join as pjoin

import numpy as np
import torch

from . import lut as _lut
from .io import nifti
from .io.scheme import Scheme
from .utils.logging import ERROR, LOG, NOTE, PRINT, WARNING, get_verbose
from .utils.progress import ProgressBar
from .utils.timers import StageTimers

from . import models as _models
from . import pipeline as _pl
from . import trace
from .device import DEFAULT_DEVICE, resolve_device
from .models.base import DEFAULT_MAX_DEVICE_BYTES, _concrete
from .parallel import dist

try:
    from threadpoolctl import ThreadpoolController
except ImportError:  # pragma: no cover
    ThreadpoolController = None


def _profiler(prof_dir: str, device: torch.device):
    """A ``torch.profiler`` capture (host ops, and on the card its kernels
    and copies) written as ``*.pt.trace.json`` under ``prof_dir`` when it
    ends: the counterpart of the JAX package's ``jax.profiler.trace``."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(prof_dir))


def _upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """The padded float32 signal on ``device`` (on the CPU, the host buffer
    itself)."""
    t = torch.from_numpy(np.ascontiguousarray(host, np.float32)).to(device)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    return t


def setup(lmax: int = 12) -> None:
    """One-time precompute of every (lmax, ndirs) rotation structure,
    disk-cached; safe to call repeatedly."""
    LOG('\n-> Precomputing rotation matrices:')
    dirs = _lut.valid_dirs()
    with ProgressBar(total=len(dirs), disable=get_verbose() < 3) as pbar:
        for ndirs in dirs:
            _lut.precompute_rotation_matrices(lmax, ndirs)
            pbar.update()
    LOG('   [ DONE ]')


def _default_config(study_path, subject, output_path, device) -> dict:
    """Initial config dict: the JAX package's keys (so config.pickle keeps
    its key set) plus ``device``."""
    from . import __version__
    cfg = dict(
        version=__version__,
        study_path=study_path,
        subject=subject,
        DATA_path=pjoin(study_path, subject),
        OUTPUT_path=output_path,
        peaks_filename=None,
        doNormalizeSignal=True,
        doKeepb0Intact=False,
        doComputeRMSE=False,
        doComputeNRMSE=False,
        doSaveModulatedMaps=False,
        doSaveCorrectedDWI=False,
        doMergeB0=False,
        doDebiasSignal=False,
        doDirectionalAverage=False,
        nthreads=-1,
        DTI_fit_method='OLS',
        BLAS_nthreads=1,
        # 'auto': on a CUDA card with the tile kernels, the width their
        # measured cost model picks (engine.auto_tile_size); else 128
        # (models/base.py, BaseModel._tile_size)
        tile_size='auto',
        voxels_per_chunk='auto',
        # 'auto' | 'reference' | 'generated': where direction sets and the
        # high-res gradient table come from (amico_tpu.ops.sphere)
        direction_source='auto',
        # multi-process fit (parallel/dist.py): per-process voxel slabs,
        # gathered maps, writes by process 0
        distributed=False,
        # a parallel.make_mesh() Mesh: the tile driver's chunks go to its
        # devices round robin (models/base.py)
        mesh=None,
        # directory for a torch.profiler trace of the model fit
        # (*.pt.trace.json, TensorBoard/Perfetto); None disables
        profile_dir=None,
        # mid-fit chunk checkpointing: path of the checkpoint file (None
        # disables) + flush cadence in dispatched chunks (models/base.py)
        fit_checkpoint=None,
        checkpoint_every=4,
        # cap on the bytes of the signal staged on the device; above it the
        # tile driver streams host-tiled chunks.  None = 4 GiB
        max_device_bytes=None,
        # SubjectSweep only: load the next subject on a background thread
        # while the current one fits (sweep.py)
        prefetch=True,
        # 'cuda' | 'cpu' (| 'cuda:N'): where the fit runs (device.py)
        device=device,
    )
    cfg['DWI-SNR'] = None
    return cfg


class Evaluation:
    """State holder + stage sequencer for one subject fit."""

    def __init__(self, study_path='.', subject='.', output_path=None,
                 device=DEFAULT_DEVICE):
        self.niiDWI = None
        self.niiDWI_img = None
        self.scheme = None
        self.niiMASK = None
        self.niiMASK_img = None
        self.model = None
        self.KERNELS = None
        self.y = None
        self.DIRs = None
        self.nthreads = None
        self.BLAS_nthreads = None
        self.RESULTS = None
        self.mean_b0s = None
        self.htable = None
        self.timers = StageTimers()
        self.CONFIG = _default_config(study_path, subject, output_path,
                                      device)
        self._controller = (ThreadpoolController()
                            if ThreadpoolController is not None else None)

    def set_config(self, key, value):
        self.CONFIG[key] = value

    def get_config(self, key):
        return self.CONFIG.get(key)

    def _blas_limit(self):
        import contextlib
        if self._controller is None:
            return contextlib.nullcontext()
        return self._controller.limit(limits=self.BLAS_nthreads or 1,
                                      user_api='blas')

    def _distributed(self) -> bool:
        """The ``distributed`` config within a group of several processes
        (``parallel.dist.initialize``); without one a fit is whole."""
        return bool(self.get_config('distributed')) \
            and dist.process_count() > 1

    def _stage_time(self, sp, name=None):
        """Add a closed span's seconds to ``timers`` (the JAX facade's
        ``StageTimers``), under ``name`` or the span's own."""
        t = self.timers.times
        name = name or sp.name
        t[name] = t.get(name, 0.0) + sp.elapsed

    def _resolve_threads(self, key):
        v = self.get_config(key)
        if v is None:
            return 1
        if v > 0:
            return v
        if v == -1:
            return cpu_count()
        ERROR(f'"{key}" must be a positive count or -1 (= all cores)')

    # ------------------------------------------------------------ load_data
    def load_data(self, dwi_filename='DWI.nii', scheme_filename='DWI.scheme',
                  mask_filename=None, b0_thr=0, b0_min_signal=0,
                  replace_bad_voxels=None):
        """Load DWI/scheme/mask, then run the preprocessing stages."""
        with trace.span('load_data'):
            with trace.span('nifti_read'):
                img = self._read_inputs(dwi_filename, scheme_filename,
                                        mask_filename, b0_thr, b0_min_signal,
                                        replace_bad_voxels)
            with trace.span('preprocess') as sp:
                self.niiDWI_img = self._preprocess(img, b0_thr, b0_min_signal,
                                                   replace_bad_voxels)
            self._stage_time(sp)

    def _read_inputs(self, dwi_filename, scheme_filename, mask_filename,
                     b0_thr, b0_min_signal, replace_bad_voxels):
        """Read the DWI header (its data mapped), the scheme and the mask;
        returns the DWI's raw data."""
        LOG('\n-> Loading data:')
        tic = time.time()
        data_path = self.get_config('DATA_path')
        self.set_config('dwi_filename', dwi_filename)
        self.set_config('scheme_filename', scheme_filename)
        self.set_config('mask_filename', mask_filename)
        self.set_config('b0_thr', b0_thr)
        self.set_config('b0_min_signal', b0_min_signal)
        self.set_config('replace_bad_voxels', replace_bad_voxels)

        PRINT('\t* DWI signal')
        if not isfile(pjoin(data_path, dwi_filename)):
            ERROR('DWI file not found')
        self.niiDWI = nifti.load(pjoin(data_path, dwi_filename))
        img = self.niiDWI.dataobj
        if img.ndim != 4:
            ERROR('DWI file is not a 4D image')
        hdr = self.niiDWI.header
        self.set_config('dim', img.shape[:3])
        self.set_config('pixdim', tuple(hdr.get_zooms()[:3]))
        PRINT('\t\t- dim    = %d x %d x %d x %d' % img.shape)
        PRINT('\t\t- pixdim = %.3f x %.3f x %.3f' % self.get_config('pixdim'))
        if _pl.rescale_meaningful(hdr.scl_slope, hdr.scl_inter):
            PRINT('\t\t- rescaling data  [OK]')

        PRINT('\t* Acquisition scheme')
        if not isfile(pjoin(data_path, scheme_filename)):
            ERROR('SCHEME file not found')
        self.scheme = Scheme(pjoin(data_path, scheme_filename), b0_thr)
        self._print_scheme_summary()
        if self.scheme.nS != img.shape[3]:
            ERROR('Scheme does not match with DWI data')

        PRINT('\t* Binary mask')
        if mask_filename is not None:
            if not isfile(pjoin(data_path, mask_filename)):
                ERROR('MASK file not found')
            self.niiMASK = nifti.load(pjoin(data_path, mask_filename))
            self.niiMASK_img = self.niiMASK.get_fdata().astype(np.uint8)
            if self.niiMASK.ndim != 3:
                ERROR('MASK file is not a 3D image')
            PRINT('\t\t- dim    = %d x %d x %d' % self.niiMASK_img.shape[:3])
            if self.get_config('dim') != self.niiMASK_img.shape[:3]:
                ERROR('MASK geometry does not match with DWI data')
        else:
            self.niiMASK = None
            self.niiMASK_img = np.ones(self.get_config('dim'), dtype=np.uint8)
            PRINT('\t\t- not specified')
        PRINT(f'\t\t- voxels = {np.count_nonzero(self.niiMASK_img)}')
        LOG(f'   [ {time.time() - tic:.1f} seconds ]')
        return img

    def _print_scheme_summary(self):
        sch = self.scheme
        PRINT(f'\t\t- {sch.nS} samples, {len(sch.shells)} shells')
        parts = [f'{sch.b0_count} @ b=0'] + \
            [f'{len(s["idx"])} @ b={s["b"]:.1f}' for s in sch.shells]
        PRINT('\t\t- ' + ' , '.join(parts))

    def _preprocess(self, img, b0_thr, b0_min_signal, replace_bad_voxels):
        """rescale/finite-guard -> debias -> b0-normalize -> merge-b0 ->
        directional average.  Without the debias, the rescale, finite guard
        and b0 normalization run as one threaded native pass
        (``ops.native.preprocess_dwi``) when the native library is
        available; the staged NumPy path is the same computation."""
        LOG('\n-> Preprocessing:')
        tic = time.time()
        hdr = self.niiDWI.header
        debias = bool(self.get_config('doDebiasSignal'))
        normalize = bool(self.get_config('doNormalizeSignal'))
        rescale = _pl.rescale_meaningful(hdr.scl_slope, hdr.scl_inter)
        if normalize and self.scheme.b0_count == 0:
            ERROR('No b0 volume to normalize signal with')

        fused = None
        if not debias:
            from .ops import native
            fused = native.preprocess_dwi(
                np.asarray(img), self.scheme.b0_idx, hdr.scl_slope,
                hdr.scl_inter, rescale, b0_min_signal, replace_bad_voxels,
                normalize)
        if fused is not None:
            img, mean_b0, info = fused
            _pl.finite_report(info['raw_bad'], replace_bad_voxels, 'raw')
            if normalize:
                PRINT('\t* Normalizing to b0... ', end='')
                self.mean_b0s = mean_b0
                PRINT(f'[ min={info["min"]:.2f},  mean={info["mean"]:.2f}, '
                      f'max={info["max"]:.2f} ]')
                _pl.finite_report(info['out_bad'], replace_bad_voxels,
                                  'preprocessed')
            return self._preprocess_tail(img, b0_thr, tic,
                                         finite_checked=True)

        img = np.array(img, dtype=np.float32)
        img, _ = _pl.intensity_rescale(img, hdr.scl_slope, hdr.scl_inter)
        img = _pl.ensure_finite(img, replace_bad_voxels, 'raw')
        if debias:
            PRINT('\t* Debiasing signal... ', end='')
            if self.get_config('DWI-SNR') is None:
                ERROR('Rician debias needs the acquisition SNR: '
                      "set_config('DWI-SNR', value) before load_data()")
            if self.scheme.b0_count == 0:
                # sigma is estimated from the b0 volumes; without any the
                # stage would silently no-op on NaN sigmas
                ERROR('No b0 volume to estimate the noise level '
                      'for the Rician debias')
            from .preproc import debiasRician
            img = debiasRician(img, self.get_config('DWI-SNR'),
                               self.niiMASK_img, self.scheme,
                               device=self.get_config('device'))
            PRINT(' [OK]')
        if normalize:
            PRINT('\t* Normalizing to b0... ', end='')
            img, self.mean_b0s = _pl.b0_normalize(img, self.scheme.b0_idx,
                                                  b0_min_signal)
            PRINT(f'[ min={img.min():.2f},  mean={img.mean():.2f}, '
                  f'max={img.max():.2f} ]')
        img = self._preprocess_tail(img, b0_thr, tic, finite_checked=False)
        return _pl.ensure_finite(img, replace_bad_voxels, 'preprocessed')

    def _preprocess_tail(self, img, b0_thr, tic, finite_checked):
        if self.get_config('doMergeB0'):
            if self.scheme.b0_count == 0:
                ERROR('No b0 volume to merge')
            if self.get_config('doDirectionalAverage'):
                NOTE('doMergeB0 is redundant with doDirectionalAverage '
                     '(the shell average already merges the b0s); skipping '
                     'the merge')
            else:
                PRINT('\t* Merging multiple b0 volume(s)')
                img = _pl.collapse_b0(img, self.scheme.b0_idx,
                                      self.scheme.dwi_idx)
        else:
            PRINT('\t* Keeping all b0 volume(s)')

        if self.get_config('doDirectionalAverage'):
            PRINT('\t* Directional average over each shell...')
            img, self.scheme = _pl.spherical_mean(img, self.scheme, b0_thr)
            self.set_config('dim', img.shape[:3])
            PRINT('\t\t- dim    = %d x %d x %d x %d' % img.shape)
            PRINT('\t* Acquisition scheme')
            self._print_scheme_summary()
            if self.scheme.nS != img.shape[3]:
                ERROR('Scheme does not match with DWI data')
        LOG(f'   [ {time.time() - tic:.1f} seconds ]')
        return img

    # ------------------------------------------------------------ set_model
    def set_model(self, model_name: str):
        """Instantiate a model class of the port's zoo by name."""
        if not hasattr(_models, model_name):
            ERROR(f'Model "{model_name}" not recognized')
        self.model = getattr(_models, model_name)()
        self.set_config('ATOMS_path', pjoin(self.get_config('study_path'),
                                            'kernels', self.model.id))
        self.set_solver()

    def set_solver(self, **params):
        """Pass solver knobs through to the model, dropping (with a warning)
        any the model's set_solver signature does not accept."""
        import inspect
        if self.model is None:
            ERROR('Model not set; call "set_model()" method first')
        accepted = set(inspect.signature(self.model.set_solver).parameters)
        known = {k: v for k, v in params.items() if k in accepted}
        for k in params.keys() - known.keys():
            WARNING(f'solver parameter "{k}" is not used by '
                    f'{self.model.name}; ignoring it')
        self.model.set_solver(**known)
        self.set_config('solver_params', known)

    # ----------------------------------------------------- generate_kernels
    def generate_kernels(self, regenerate=False, lmax=12, ndirs=500):
        """Build the high-resolution response-function LUT, unless a cached
        one already exists."""
        if self.scheme is None:
            ERROR('Scheme not loaded; call "load_data()" first')
        if self.model is None:
            ERROR('Model not set; call "set_model()" method first')
        if not _lut.is_valid(ndirs):
            ERROR(f'ndirs={ndirs} is not a precomputable direction count; '
                  f'valid values: {_lut.valid_dirs()}')
        if lmax % 2 or lmax < 0:
            ERROR(f'lmax={lmax} is invalid: the SH basis uses even degrees '
                  'only (axially symmetric kernels); pass an even lmax')
        self.BLAS_nthreads = self._resolve_threads('BLAS_nthreads')
        self.set_config('lmax', lmax)
        self.set_config('ndirs', ndirs)
        self.model.scheme = self.scheme
        atoms_path = self.get_config('ATOMS_path')
        LOG(f'\n-> Creating LUT for "{self.model.name}" model:')

        # under a distributed run a concurrent wipe and rebuild of a shared
        # ATOMS_path is not safe: the coordinator generates first and the
        # others wait at a barrier.  Then each of them checks its own path:
        # on a shared filesystem the coordinator's LUT is there and is
        # reused (even under regenerate=True: it was just built); on
        # per-host copies nothing appeared and the process builds its own,
        # with no other writer of that path left
        spmd = self._distributed()
        if spmd and not dist.is_coordinator():
            dist.barrier('generate_kernels')
            if regenerate and self._lut_is_current(atoms_path):
                regenerate = False
        try:
            self._generate_kernels_body(regenerate, lmax, ndirs, atoms_path)
        finally:
            # the coordinator (also a failed one: the others then build for
            # themselves) releases the waiters exactly once
            if spmd and dist.is_coordinator():
                dist.barrier('generate_kernels')

    def _lut_is_current(self, atoms_path: str) -> bool:
        """A completed LUT with a matching generation signature exists."""
        meta_path = pjoin(atoms_path, 'lut_meta.pickle')
        if not (glob.glob(pjoin(atoms_path, 'A_*.npy'))
                and isfile(meta_path)):
            return False
        with open(meta_path, 'rb') as fid:
            meta = pickle.load(fid)
        return meta.get('gen_sig') == self._kernel_signature()

    def _generate_kernels_body(self, regenerate, lmax, ndirs, atoms_path):
        meta_path = pjoin(atoms_path, 'lut_meta.pickle')
        if glob.glob(pjoin(atoms_path, 'A_*.npy')) and not regenerate:
            # lut_meta.pickle is the completion marker and pins the shell
            # parameters and atom grid the LUT was generated for
            if isfile(meta_path):
                with open(meta_path, 'rb') as fid:
                    meta = pickle.load(fid)
                want = self._kernel_signature()
                if meta.get('gen_sig', want) != want:
                    ERROR('Cached LUT was generated for a different '
                          'scheme/model configuration; call '
                          '"generate_kernels(regenerate=True)"')
                LOG('   [ cached LUT found on disk -- pass regenerate=True '
                    'to rebuild it ]')
                return
            WARNING('Found LUT atoms without a completion marker '
                    '(interrupted generation?); rebuilding')
        if not exists(atoms_path):
            makedirs(atoms_path)
        else:
            for f in glob.glob(pjoin(atoms_path, '*')):
                remove(f)

        aux = _lut.load_precomputed_rotation_matrices(
            lmax, ndirs, self.get_config('direction_source'))
        idx_IN, idx_OUT = _lut.aux_structures_generate(self.scheme, lmax)
        tic = time.time()
        with self.timers.stage('generate_kernels'), self._blas_limit():
            self.model.generate(atoms_path, aux, idx_IN, idx_OUT, ndirs)
        with open(meta_path + '.tmp', 'wb') as fid:
            pickle.dump({'lmax': lmax, 'ndirs': ndirs,
                         'source': aux.get('source'),
                         'gen_sig': self._kernel_signature()}, fid)
        replace(meta_path + '.tmp', meta_path)  # completion marker, atomic
        LOG(f'   [ {time.time() - tic:.1f} seconds ]')

    def _kernel_signature(self) -> str:
        """Hash of everything the generated atoms depend on: the shell
        parameters and the model's atom-grid parameters."""
        import hashlib
        shells = [(s['b'], s['G'], s['Delta'], s['delta'], s['TE'])
                  for s in self.scheme.shells]
        params = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                  for k, v in self.model.get_params().items()}
        text = repr((self.scheme.version, shells, sorted(params.items())))
        return hashlib.sha1(text.encode()).hexdigest()

    # --------------------------------------------------------- load_kernels
    def load_kernels(self):
        """Project the SH-space LUT onto this subject's gradient scheme."""
        with trace.span('load_kernels'):
            self._load_kernels()

    def _load_kernels(self):
        if self.model is None:
            ERROR('Model not set; call "set_model()" method first')
        if self.scheme is None:
            ERROR('Scheme not loaded; call "load_data()" first')
        self.BLAS_nthreads = self._resolve_threads('BLAS_nthreads')
        tic = time.time()
        LOG(f'\n-> Resampling LUT for subject "{self.get_config("subject")}":')
        with trace.span('resample_aux'):
            idx_OUT, Ylm_OUT = _lut.aux_structures_resample(
                self.scheme, self.get_config('lmax'))
        source = self.get_config('direction_source')
        meta_path = pjoin(self.get_config('ATOMS_path'), 'lut_meta.pickle')
        if isfile(meta_path):
            with open(meta_path, 'rb') as fid:
                meta = pickle.load(fid)
            source = meta.get('source', source)
            if meta.get('ndirs') != self.get_config('ndirs'):
                ERROR(f'Cached kernels were built with ndirs={meta.get("ndirs")}'
                      f' but this session uses ndirs={self.get_config("ndirs")};'
                      ' call generate_kernels(regenerate=True)')
            if meta.get('lmax') != self.get_config('lmax'):
                ERROR(f'Cached kernels were built with lmax={meta.get("lmax")}'
                      f' but this session uses lmax={self.get_config("lmax")};'
                      ' call generate_kernels(regenerate=True)')
        with trace.span('hash_table'):
            self.htable = _lut.load_precomputed_hash_table(
                self.get_config('ndirs'), source)
        with trace.span('model_resample') as sp, self._blas_limit():
            self.KERNELS = self.model.resample(
                self.get_config('ATOMS_path'), idx_OUT, Ylm_OUT,
                self.get_config('doMergeB0'), self.get_config('ndirs'))
        self._stage_time(sp, 'load_kernels')
        LOG(f'   [ {time.time() - tic:.1f} seconds ]')

    # ------------------------------------------------------------------ fit
    def fit(self):
        """Directions + model fit + scatter back to volumes.  The fit's
        spans (``trace``) give its phase timers, ``last_fit_timers()``."""
        with trace.span('fit') as sp:
            self._fit()
        s = sp.seconds
        tf = {'stage_voxels_s': s['stage_voxels'],
              'directions_s': s['directions'],
              'model_fit_s': s['model_fit'],
              'gather_s': s.get('gather', 0.0),
              'scatter_s': s['scatter'],
              'total_s': sp.elapsed}
        tf['unattributed_s'] = tf['total_s'] - sum(
            v for k, v in tf.items() if k != 'total_s')
        self._last_fit_facade_timers = tf

    def last_fit_timers(self) -> dict:
        """The last fit's phase timers, in seconds: ``'facade'`` (stage_voxels,
        directions, model_fit, gather, scatter, total and unattributed) and
        ``'engine'`` (the model's tile driver: plan as ``setup_s``,
        ``dispatch_s``, ``device_s`` (the wait for the device), ``pull_s``,
        ``untile_s``, and what the fit resolved)."""
        return {'facade': dict(self._last_fit_facade_timers),
                'engine': dict(self.model._last_fit_timers)}

    def _fit(self):
        if self.niiDWI is None:
            ERROR('Data not loaded; call "load_data()" first')
        if self.model is None:
            ERROR('Model not set; call "set_model()" first')
        if self.KERNELS is None:
            ERROR('Response functions not generated; call "generate_kernels()" '
                  'and "load_kernels()" first')
        if self.KERNELS['model'] != self.model.id:
            ERROR('Response functions were not created with the same model')
        device = _concrete(resolve_device(self.get_config('device')))
        method = _pl.resolve_dti_method(self.get_config('DTI_fit_method'))
        self.nthreads = self._resolve_threads('nthreads')
        self.BLAS_nthreads = self._resolve_threads('BLAS_nthreads')
        self.set_config('fit_time', None)
        mask = self.niiMASK_img
        mask_sel = np.ascontiguousarray(mask == 1)
        n_vox = int(mask_sel.sum())
        dist_on = self._distributed()
        # the JAX facade's staging rule: the signal is staged on the device
        # only for a single-process, single-device, direction-full fit
        # within the budget
        budget = int(self.get_config('max_device_bytes')
                     or DEFAULT_MAX_DEVICE_BYTES)
        want_stage = (not dist_on
                      and self.get_config('mesh') is None
                      and not self.get_config('doDirectionalAverage')
                      and n_vox * int(self.niiDWI_img.shape[3]) * 4 <= budget)

        self._staged_y_ext_dev = None
        with trace.span('stage_voxels', cached=False,
                        uploaded=False) as stage_sp:
            # warm re-fit state, the JAX facade's: a re-fit of the same
            # loaded volume and mask (identity) reuses the masked signal,
            # so that the model's identity-keyed caches hit.  A strided
            # sum of the volume (ravel(order='K') takes no copy), the voxel
            # count and an exact digest of the mask make an in-place edit
            # of either miss
            stride = max(1, self.niiDWI_img.size // 65536)
            img_fp = (float(np.sum(self.niiDWI_img.ravel(order='K')[::stride],
                                   dtype=np.float64)),
                      n_vox, hash(mask_sel.tobytes()))
            yc = getattr(self, '_fit_y_cache', None)
            if yc is not None and yc[0] is self.niiDWI_img \
                    and yc[1] is self.niiMASK_img and yc[2] == img_fp:
                self.y, slab_cache = yc[3], yc[4]
                stage_sp.attrs['cached'] = True
            else:
                # a new signal: the old one's cached copies on the card, the
                # facade's and the model's staged inputs, go before anything
                # new is gathered or uploaded
                yc = self._fit_y_cache = self._fit_dirs_cache = None
                self.model._stage_cache = None
                slab_cache = {}
                self.y = self._gather_signal(mask, slab_cache)
                self._fit_y_cache = (self.niiDWI_img, self.niiMASK_img,
                                     img_fp, self.y, slab_cache)
            # multi-process: this process fits its slab of the voxels
            # alone; the maps are gathered after the fit.  The slab view is
            # kept too, so that a re-fit hands the model the same object
            y_full = self.y
            if dist_on:
                slab = dist.host_slab(n_vox)
                sl = slab_cache.get((slab.start, slab.stop))
                if sl is None:
                    sl = slab_cache[(slab.start, slab.stop)] = y_full[slab]
                self.y = sl
                LOG(f'\n-> Distributed fit: process {dist.process_index()}/'
                    f'{dist.process_count()} takes voxels '
                    f'[{slab.start}:{slab.stop}) of {n_vox}')
            if want_stage:
                # one float32 upload a device, shared by the DTI fit and the
                # tile driver, kept across fits
                copies = slab_cache.setdefault('__y_ext_dev__', {})
                if device not in copies:
                    host = slab_cache.get('__y_ext_host__')
                    if host is None:
                        host = np.concatenate(
                            [self.y.astype(np.float32, copy=False),
                             np.zeros((1, self.y.shape[1]), np.float32)])
                    copies[device] = _upload(host, device)
                    stage_sp.attrs['uploaded'] = True
                self._staged_y_ext_dev = (self.y, copies[device])
            else:
                # unlike the JAX facade, a fit that does not stage keeps no
                # copy of the signal on a device: the budget bounds what
                # the fit holds there
                slab_cache.pop('__y_ext_dev__', None)
        self._stage_time(stage_sp)

        LOG(f"\n-> Estimating principal directions "
            f"({self.get_config('DTI_fit_method')}):")
        with trace.span('directions', cached=False) as sp:
            peaks_filename = self.get_config('peaks_filename')
            if peaks_filename is not None:
                self.DIRs = self._load_peaks(peaks_filename, mask)
                if dist_on:
                    self.DIRs = self.DIRs[slab]
            elif not self.get_config('doDirectionalAverage'):
                # the directions depend on (y, scheme, method, doMergeB0)
                # and the device they are fitted on: a re-fit reuses them
                # (and the tile driver's plan, keyed on their identity)
                dkey = (self.y, self.scheme, method,
                        bool(self.get_config('doMergeB0')), device)
                dc = getattr(self, '_fit_dirs_cache', None)
                if dc is not None and dc[0] is dkey[0] \
                        and dc[1] is dkey[1] and dc[2:5] == dkey[2:]:
                    self.DIRs = dc[5]
                    sp.attrs['cached'] = True
                else:
                    y_dti = (self._staged_y_ext_dev[1][:-1]
                             if self._staged_y_ext_dev is not None
                             else self.y)
                    with torch.no_grad():
                        self.DIRs = _pl.principal_directions(
                            y_dti, self.scheme, method, dkey[3],
                            device=device)
                    self._fit_dirs_cache = dkey + (self.DIRs,)
        if not sp.attrs['cached']:
            self._stage_time(sp)
        # the staging included, as in the JAX facade
        self.set_config('dirs_precomputing_time',
                        stage_sp.elapsed + sp.elapsed)
        LOG('   [ %s ]' % time.strftime(
            '%Hh %Mm %Ss',
            time.gmtime(self.get_config('dirs_precomputing_time'))))

        LOG(f"\n-> Fitting '{self.model.name}' model to {n_vox} voxels:")
        prof_dir = self.get_config('profile_dir')
        prof_ctx = _profiler(prof_dir, device) if prof_dir \
            else contextlib.nullcontext()
        # the 'fit' range: the benchmark attributes the kernels within it
        # to the model fit
        with prof_ctx, torch.profiler.record_function('fit'), \
                trace.span('model_fit') as sp:
            results = self.model.fit(self)
        self._stage_time(sp, 'fit')
        self.set_config('fit_time', sp.elapsed)
        LOG('   [ %s ]' % time.strftime(
            '%Hh %Mm %Ss', time.gmtime(self.get_config('fit_time'))))

        if dist_on:
            with trace.span('gather') as sp:
                results = {k: dist.allgather_rows(np.asarray(v), n_vox)
                           for k, v in results.items()}
                if self.DIRs is not None:
                    self.DIRs = dist.allgather_rows(
                        np.asarray(self.DIRs, np.float32), n_vox)
            self._stage_time(sp)
            self.y = y_full
        with trace.span('scatter') as sp:
            self.RESULTS = self._scatter_results(results, mask)
        self._stage_time(sp)

    def _gather_signal(self, mask, slab_cache):
        """The masked voxels (N, nS) of the loaded volume: the fused native
        gather (clip and zero pad row; the padded buffer is the device
        staging layout, kept as ``'__y_ext_host__'``), else the NumPy
        path."""
        from .ops import native as _native
        padded = _native.masked_gather_padded(self.niiDWI_img, mask)
        if padded is None:
            return _pl.masked_voxels(self.niiDWI_img, mask)
        slab_cache['__y_ext_host__'] = padded
        return padded[:-1]

    def _load_peaks(self, peaks_filename, mask):
        """Alternative direction source: a precomputed peaks NIfTI."""
        path = pjoin(self.get_config('DATA_path'), peaks_filename)
        if not isfile(path):
            ERROR('PEAKS file not found')
        peaks = nifti.load(path).get_fdata().astype(np.float32)
        if peaks.ndim != 4 or peaks.shape[3] < 3:
            ERROR('PEAKS file must be a 4D image with at least 3 '
                  'components (x, y, z of the principal direction)')
        PRINT('\t* peaks dim = %d x %d x %d x %d' % peaks.shape[:4])
        if peaks.shape[:3] != mask.shape[:3]:
            ERROR('PEAKS geometry does not match with DWI data')
        dirs = peaks[mask == 1, :3]
        bad = ~np.isfinite(dirs).all(axis=1)
        if bad.any():
            WARNING(f'{int(bad.sum())} voxels have non-finite peaks; '
                    'treating them as direction-free')
            dirs[bad] = 0.0
        return dirs

    def _scatter_results(self, results, mask):
        """Expand per-voxel fit outputs into full volumes."""
        dim = self.get_config('dim')
        with trace.span('scatter_maps'):
            out = {'MAPs': _pl.scatter(np.asarray(results['estimates'],
                                                  np.float32), mask, dim)}
            dirs = (np.asarray(self.DIRs, np.float32)
                    if self.DIRs is not None
                    else np.zeros((int(np.sum(mask == 1)), 3), np.float32))
            out['DIRs'] = _pl.scatter(dirs, mask, dim)
            if self.get_config('doComputeRMSE'):
                out['RMSE'] = _pl.scatter(results['rmse'], mask, dim)
            if self.get_config('doComputeNRMSE'):
                out['NRMSE'] = _pl.scatter(results['nrmse'], mask, dim)
            if self.model.name == 'NODDI' \
                    and self.get_config('doSaveModulatedMaps'):
                out['MAPs_mod'] = _pl.scatter(
                    np.asarray(results['estimates_mod'], np.float32), mask,
                    dim)
        if self.model.name == 'Free-Water' and self.get_config('doSaveCorrectedDWI'):
            mean_b0_masked = (self.mean_b0s[mask == 1]
                              if self.mean_b0s is not None else None)
            # under doMergeB0 the fitted signal has its one merged b0 at
            # column 0, not at the scheme's b0 columns
            b0_cols = (np.array([0]) if self.get_config('doMergeB0')
                       else self.scheme.b0_idx)
            has_b0 = self.scheme.b0_count > 0
            with trace.span('reinstate_dwi'):
                yc = _pl.reinstate_corrected_dwi(
                    results['y_corrected'], self.y, mean_b0_masked, b0_cols,
                    bool(self.get_config('doNormalizeSignal')) and has_b0,
                    bool(self.get_config('doKeepb0Intact')) and has_b0)
                out['DWI_corrected'] = _pl.scatter(
                    yc.astype(np.float32), mask,
                    self.niiDWI.shape[:3] + (yc.shape[1],))
        return out

    # --------------------------------------------------------- save_results
    def save_results(self, path_suffix=None, save_dir_avg=False):
        """Write parameter maps + metadata; config.pickle is written last.
        In distributed runs only the coordinator writes (every process
        holds the gathered maps); all processes meet at a barrier before
        returning."""
        with trace.span('save_results') as sp:
            self._save_results(path_suffix, save_dir_avg)
        self._stage_time(sp)

    def _save_results(self, path_suffix, save_dir_avg):
        if self.RESULTS is None:
            ERROR('Model not fitted to the data; call "fit()" first')
        dist_on = self._distributed()
        if dist_on and not dist.is_coordinator():
            LOG(f'\n-> Process {dist.process_index()}: the coordinator '
                'writes the results; waiting at the barrier')
            dist.barrier('save_results')
            return
        suffix = f'_{path_suffix}' if path_suffix else ''
        if self.get_config('OUTPUT_path') is None:
            rel = pjoin('AMICO', self.model.id) + suffix
            self.RESULTS['RESULTS_path'] = rel
            out_dir = pjoin(self.get_config('DATA_path'), rel)
        else:
            out_dir = self.get_config('OUTPUT_path') + suffix
            self.RESULTS['RESULTS_path'] = out_dir
        LOG(f'\n-> Saving output to "{pjoin(self.RESULTS["RESULTS_path"], "*")}":')

        if not exists(out_dir):
            makedirs(out_dir)
        else:
            for f in glob.glob(pjoin(out_dir, '*')):
                remove(f)

        tag = f' (AMICO-TPU-torch v{self.get_config("version")})'
        jobs = []

        def emit(data, fname, descrip=None, cal=(None, None)):
            jobs.append((data, fname, descrip, cal))

        if not self.get_config('doDirectionalAverage'):
            emit(self.RESULTS['DIRs'], 'fit_dir.nii.gz', cal=(-1, 1))
        if self.get_config('doComputeRMSE'):
            emit(self.RESULTS['RMSE'], 'fit_RMSE.nii.gz', cal=(0, 1))
        if self.get_config('doComputeNRMSE'):
            emit(self.RESULTS['NRMSE'], 'fit_NRMSE.nii.gz', cal=(0, 1))
        if self.get_config('doSaveCorrectedDWI'):
            if self.model.name == 'Free-Water':
                emit(self.RESULTS['DWI_corrected'], 'DWI_corrected.nii.gz',
                     cal=(0, 1))
            else:
                WARNING(f'"doSaveCorrectedDWI" is only meaningful for the '
                        f'Free-Water model, not "{self.model.name}"')
        for i, name in enumerate(self.model.maps_name):
            emit(self.RESULTS['MAPs'][:, :, :, i], f'fit_{name}.nii.gz',
                 descrip=self.model.maps_descr[i] + tag)
        if self.get_config('doSaveModulatedMaps'):
            if self.model.name == 'NODDI':
                for i in range(2):
                    emit(self.RESULTS['MAPs_mod'][:, :, :, i],
                         f'fit_{self.model.maps_name[i]}_modulated.nii.gz',
                         descrip=self.model.maps_descr[i] + ' modulated' + tag)
            else:
                WARNING(f'"doSaveModulatedMaps" is only meaningful for NODDI, '
                        f'not "{self.model.name}"')
        if save_dir_avg:
            if self.get_config('doDirectionalAverage'):
                emit(self.niiDWI_img, 'dir_avg_signal.nii.gz',
                     descrip='Directional average signal of each shell' + tag)
                np.savetxt(pjoin(out_dir, 'dir_avg.scheme'),
                           self.scheme.get_table(), fmt='%.06f',
                           delimiter='\t',
                           header=f'VERSION: {self.scheme.version}',
                           comments='')
            else:
                WARNING('No directional-average signal to save: enable '
                        'doDirectionalAverage before load_data()')

        # maps are compressed in parallel (zlib releases the GIL) and all
        # complete before config.pickle, the completion marker (the
        # resume marker of sweep.py)
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(
                max_workers=min(len(jobs), max(2, cpu_count() or 2))) as ex:
            futs = [(fname, ex.submit(_pl.write_map, data,
                                      pjoin(out_dir, fname), self.niiDWI,
                                      descrip=descrip, cal=cal))
                    for data, fname, descrip, cal in jobs]
            for fname, fut in futs:
                PRINT(f'\t- {fname}', end=' ')
                fut.result()
                PRINT(' [OK]')

        # a value that does not pickle (a live device mesh) is recorded by
        # its repr
        PRINT('\t- configuration', end=' ')
        cfg = {}
        for k, v in self.CONFIG.items():
            try:
                pickle.dumps(v, protocol=2)
                cfg[k] = v
            except Exception:
                cfg[k] = repr(v)
        tmp_cfg = pjoin(out_dir, 'config.pickle.tmp')
        with open(tmp_cfg, 'wb') as fid:
            pickle.dump(cfg, fid, protocol=2)
        replace(tmp_cfg, pjoin(out_dir, 'config.pickle'))
        PRINT(' [OK]')
        if dist_on:
            dist.barrier('save_results')
        LOG('   [ DONE ]')
