"""Orchestration facade of the port (counterpart of ``amico_tpu.core``).

Same public surface, call order and config keys as the JAX package:

    amico_tpu_torch.setup()
    ev = amico_tpu_torch.Evaluation(study_path, subject, device='cuda')
    ev.load_data(...); ev.set_model('NODDI')
    ev.generate_kernels(); ev.load_kernels(); ev.fit(); ev.save_results()

Host stages (NIfTI I/O, native preprocessing, LUT generation and
resampling, scatter, map writing) are the JAX package's jax-free modules.
The fit uploads the padded float32 signal once to the ``device`` config's
device; the OLS DTI direction fit and the model's tile driver share that
upload.  Single host only: the dist/mesh branches, Rician debias and the
profiler hook are ROADMAP work and raise when asked for.
"""
from __future__ import annotations

import glob
import pickle
import time
from os import cpu_count, makedirs, remove, replace
from os.path import exists, isfile, join as pjoin

import numpy as np
import torch

from amico_tpu import lut as _lut
from amico_tpu.io import nifti
from amico_tpu.io.scheme import Scheme
from amico_tpu.utils.logging import ERROR, LOG, NOTE, PRINT, WARNING, get_verbose
from amico_tpu.utils.progress import ProgressBar
from amico_tpu.utils.timers import StageTimers

from . import models as _models
from . import pipeline as _pl
from .device import DEFAULT_DEVICE, resolve_device

try:
    from threadpoolctl import ThreadpoolController
except ImportError:  # pragma: no cover
    ThreadpoolController = None


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
        # 'auto' = 128 voxels per tile (models/base.py)
        tile_size='auto',
        voxels_per_chunk='auto',
        # 'auto' | 'reference' | 'generated': where direction sets and the
        # high-res gradient table come from (amico_tpu.ops.sphere)
        direction_source='auto',
        # JAX-package keys kept for the config key set; setting them raises
        # until their ROADMAP items are ported
        distributed=False,
        profile_dir=None,
        mesh=None,
        fit_checkpoint=None,
        checkpoint_every=4,
        # cap on the bytes of the staged signal; None = 4 GiB
        max_device_bytes=None,
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

        with self.timers.stage('preprocess'):
            self.niiDWI_img = self._preprocess(img, b0_thr, b0_min_signal,
                                               replace_bad_voxels)

    def _print_scheme_summary(self):
        sch = self.scheme
        PRINT(f'\t\t- {sch.nS} samples, {len(sch.shells)} shells')
        parts = [f'{sch.b0_count} @ b=0'] + \
            [f'{len(s["idx"])} @ b={s["b"]:.1f}' for s in sch.shells]
        PRINT('\t\t- ' + ' , '.join(parts))

    def _preprocess(self, img, b0_thr, b0_min_signal, replace_bad_voxels):
        """rescale/finite-guard -> b0-normalize -> merge-b0 -> directional
        average.  The rescale, finite guard and b0 normalization run as
        one threaded native pass (``amico_tpu.ops.native.preprocess_dwi``)
        when the native library is available; the staged NumPy path is the
        same computation."""
        LOG('\n-> Preprocessing:')
        tic = time.time()
        if self.get_config('doDebiasSignal'):
            raise NotImplementedError(
                'doDebiasSignal (Rician debias) is not ported yet '
                '(ROADMAP queue 1: Rician debias)')
        hdr = self.niiDWI.header
        normalize = bool(self.get_config('doNormalizeSignal'))
        rescale = _pl.rescale_meaningful(hdr.scl_slope, hdr.scl_inter)
        if normalize and self.scheme.b0_count == 0:
            ERROR('No b0 volume to normalize signal with')

        from amico_tpu.ops import native
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
        if self.model is None:
            ERROR('Model not set; call "set_model()" method first')
        if self.scheme is None:
            ERROR('Scheme not loaded; call "load_data()" first')
        self.BLAS_nthreads = self._resolve_threads('BLAS_nthreads')
        tic = time.time()
        LOG(f'\n-> Resampling LUT for subject "{self.get_config("subject")}":')
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
        self.htable = _lut.load_precomputed_hash_table(
            self.get_config('ndirs'), source)
        with self.timers.stage('load_kernels'), self._blas_limit():
            self.KERNELS = self.model.resample(
                self.get_config('ATOMS_path'), idx_OUT, Ylm_OUT,
                self.get_config('doMergeB0'), self.get_config('ndirs'))
        LOG(f'   [ {time.time() - tic:.1f} seconds ]')

    # ------------------------------------------------------------------ fit
    def fit(self):
        """Directions + model fit + scatter back to volumes."""
        if self.niiDWI is None:
            ERROR('Data not loaded; call "load_data()" first')
        if self.model is None:
            ERROR('Model not set; call "set_model()" first')
        if self.KERNELS is None:
            ERROR('Response functions not generated; call "generate_kernels()" '
                  'and "load_kernels()" first')
        if self.KERNELS['model'] != self.model.id:
            ERROR('Response functions were not created with the same model')
        # the model's tile driver rejects mesh/distributed/fit_checkpoint
        if self.get_config('profile_dir'):
            raise NotImplementedError(
                'config "profile_dir" is not ported yet (ROADMAP queue 1)')
        device = resolve_device(self.get_config('device'))
        method = _pl.resolve_dti_method(self.get_config('DTI_fit_method'))
        self.nthreads = self._resolve_threads('nthreads')
        self.BLAS_nthreads = self._resolve_threads('BLAS_nthreads')
        self.set_config('fit_time', None)
        mask = self.niiMASK_img
        n_vox = int(np.count_nonzero(mask == 1))

        # facade phase timers: staging / directions / model fit / scatter
        tf = {}
        t_enter = t = time.time()
        with self.timers.stage('stage_voxels'):
            # fused native extraction (gather + clip + zero pad row); the
            # padded buffer is the device staging layout
            from amico_tpu.ops import native as _native
            padded = _native.masked_gather_padded(self.niiDWI_img, mask)
            if padded is None:
                self.y = _pl.masked_voxels(self.niiDWI_img, mask)
                padded = np.concatenate(
                    [self.y.astype(np.float32, copy=False),
                     np.zeros((1, self.y.shape[1]), np.float32)])
            else:
                self.y = padded[:-1]
            # one float32 upload, shared by the DTI fit and the tile driver
            y_ext_dev = torch.from_numpy(
                np.ascontiguousarray(padded, np.float32)).to(device)
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
        self._staged_y_ext_dev = (self.y, y_ext_dev)
        tf['stage_voxels_s'] = time.time() - t_enter

        LOG(f"\n-> Estimating principal directions "
            f"({self.get_config('DTI_fit_method')}):")
        peaks_filename = self.get_config('peaks_filename')
        if peaks_filename is not None:
            self.DIRs = self._load_peaks(peaks_filename, mask)
        elif not self.get_config('doDirectionalAverage'):
            with self.timers.stage('directions'), torch.no_grad():
                self.DIRs = _pl.principal_directions(
                    y_ext_dev[:-1], self.scheme, method,
                    bool(self.get_config('doMergeB0')))
        self.set_config('dirs_precomputing_time', time.time() - t)
        tf['directions_s'] = time.time() - t_enter - tf['stage_voxels_s']
        LOG('   [ %s ]' % time.strftime(
            '%Hh %Mm %Ss',
            time.gmtime(self.get_config('dirs_precomputing_time'))))

        t = time.time()
        LOG(f"\n-> Fitting '{self.model.name}' model to {n_vox} voxels:")
        with self.timers.stage('fit'):
            results = self.model.fit(self)
        self.set_config('fit_time', time.time() - t)
        tf['model_fit_s'] = time.time() - t
        LOG('   [ %s ]' % time.strftime(
            '%Hh %Mm %Ss', time.gmtime(self.get_config('fit_time'))))

        t = time.time()
        with self.timers.stage('scatter'):
            self.RESULTS = self._scatter_results(results, mask)
        tf['scatter_s'] = time.time() - t
        tf['total_s'] = time.time() - t_enter
        self._last_fit_facade_timers = tf

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
        out = {'MAPs': _pl.scatter(np.asarray(results['estimates'],
                                              np.float32), mask, dim)}
        dirs = (np.asarray(self.DIRs, np.float32) if self.DIRs is not None
                else np.zeros((int(np.sum(mask == 1)), 3), np.float32))
        out['DIRs'] = _pl.scatter(dirs, mask, dim)
        if self.get_config('doComputeRMSE'):
            out['RMSE'] = _pl.scatter(results['rmse'], mask, dim)
        if self.get_config('doComputeNRMSE'):
            out['NRMSE'] = _pl.scatter(results['nrmse'], mask, dim)
        if self.model.name == 'NODDI' and self.get_config('doSaveModulatedMaps'):
            out['MAPs_mod'] = _pl.scatter(
                np.asarray(results['estimates_mod'], np.float32), mask, dim)
        if self.model.name == 'Free-Water' and self.get_config('doSaveCorrectedDWI'):
            mean_b0_masked = (self.mean_b0s[mask == 1]
                              if self.mean_b0s is not None else None)
            # under doMergeB0 the fitted signal has its one merged b0 at
            # column 0, not at the scheme's b0 columns
            b0_cols = (np.array([0]) if self.get_config('doMergeB0')
                       else self.scheme.b0_idx)
            has_b0 = self.scheme.b0_count > 0
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
        """Write parameter maps + metadata; config.pickle is written last."""
        if self.RESULTS is None:
            ERROR('Model not fitted to the data; call "fit()" first')
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
            for i in range(2):
                emit(self.RESULTS['MAPs_mod'][:, :, :, i],
                     f'fit_{self.model.maps_name[i]}_modulated.nii.gz',
                     descrip=self.model.maps_descr[i] + ' modulated' + tag)
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
        # complete before config.pickle, the completion marker
        from concurrent.futures import ThreadPoolExecutor
        with self.timers.stage('save_results'), ThreadPoolExecutor(
                max_workers=min(len(jobs), max(2, cpu_count() or 2))) as ex:
            futs = [(fname, ex.submit(_pl.write_map, data,
                                      pjoin(out_dir, fname), self.niiDWI,
                                      descrip=descrip, cal=cal))
                    for data, fname, descrip, cal in jobs]
            for fname, fut in futs:
                PRINT(f'\t- {fname}', end=' ')
                fut.result()
                PRINT(' [OK]')

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
        LOG('   [ DONE ]')
