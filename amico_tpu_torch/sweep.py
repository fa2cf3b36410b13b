"""Multi-subject sweep driver (counterpart of ``amico_tpu.sweep``).

A study is fitted subject after subject with resume-by-existence at
subject granularity (a subject whose ``config.pickle`` exists is skipped)
and chunk-level mid-fit checkpointing via the 'fit_checkpoint' config.
The next subject's ``load_data`` runs on a background thread while the
current one fits, and subjects sharing a scheme and parameters reuse one
model instance and its resampled kernels.  ``mesh`` goes into each
subject's config.  Under ``distributed`` (``parallel.dist``) every process
runs the same sweep: the skip decision is the coordinator's, loads stay on
the main thread, and a failed subject raises on every process instead of
being recorded.
"""
from __future__ import annotations

import hashlib
import os
from os.path import join as pjoin

import numpy as np

from . import trace
from .core import Evaluation
from .parallel import dist
from .utils.logging import LOG, WARNING


class SubjectSweep:
    """Run one model over many subjects of a study."""

    def __init__(self, study_path: str, subjects: list[str], model_name: str,
                 dwi_filename='DWI.nii', scheme_filename='DWI.scheme',
                 mask_filename=None, b0_thr=0, ndirs=500, lmax=12,
                 mesh=None, config: dict | None = None,
                 model_params: dict | None = None,
                 solver_params: dict | None = None):
        self.study_path = study_path
        self.subjects = list(subjects)
        self.model_name = model_name
        self.dwi_filename = dwi_filename
        self.scheme_filename = scheme_filename
        self.mask_filename = mask_filename
        self.b0_thr = b0_thr
        self.ndirs = ndirs
        self.lmax = lmax
        self.mesh = mesh
        self.config = config or {}
        self.model_params = model_params or {}
        self.solver_params = solver_params or {}
        self.results: dict[str, str] = {}
        # wall seconds of each fitted subject, from its turn to its written
        # maps (a prefetched load counts only as long as the sweep waited):
        # its 'subject' span
        self.seconds: dict[str, float] = {}
        # cross-subject warm state: (signature, (model, KERNELS, htable)),
        # and the subjects of this sweep that reused it
        self._warm = None
        self.warm_reused: list[str] = []

    def _result_dir(self, subject: str) -> str:
        # an OUTPUT_path in config is a BASE dir: each subject gets its
        # own subdirectory (sharing one literal dir would make every
        # save_results wipe the previous subject's maps, and
        # resume-by-existence would never match)
        out_base = self.config.get('OUTPUT_path')
        if out_base is not None:
            return pjoin(out_base, subject)
        return pjoin(self.study_path, subject, 'AMICO', self.model_name)

    def _warm_signature(self, ev) -> tuple:
        """Everything the resampled kernels and the fit depend on: reuse
        across subjects is only valid when all of it matches."""
        scheme_h = hashlib.sha1(
            np.ascontiguousarray(ev.scheme.raw).tobytes()).hexdigest()
        return (self.model_name, scheme_h,
                repr(sorted(self.model_params.items())),
                repr(sorted(self.solver_params.items())),
                ev.get_config('ndirs'), ev.get_config('lmax'),
                bool(ev.get_config('doMergeB0')),
                ev.get_config('direction_source'), self.b0_thr)

    def _spmd(self) -> bool:
        return bool(self.config.get('distributed')) \
            and dist.process_count() > 1

    def _is_done(self, subject: str) -> bool:
        done = os.path.isfile(pjoin(self._result_dir(subject),
                                    'config.pickle'))
        # distributed: only the coordinator writes config.pickle, so after
        # a crash the processes' disks can disagree; the skip decision is
        # the coordinator's on every process, or the collectives that
        # follow pair up wrongly
        if self._spmd():
            done = bool(dist.broadcast_scalar(int(done)))
        return done

    def _prepare(self, subject: str, req: int | None = None):
        """Build the subject's Evaluation and run load_data (host I/O +
        native preprocessing).  Runs on the prefetch thread: on the
        default path everything here is host-side mask/volume staging, so
        subject k+1's load overlaps subject k's fit/save.  (run() gates
        prefetch off when doDebiasSignal is set -- that load_data stage
        runs on the device and must not race the active fit.)  Its spans
        take the request id ``req``, the subject's."""
        with trace.request(req):
            return self._load(subject)

    def _load(self, subject: str):
        out_base = self.config.get('OUTPUT_path')
        ev = Evaluation(self.study_path, subject,
                        output_path=None if out_base is None
                        else pjoin(out_base, subject))
        for k, v in self.config.items():
            if k != 'OUTPUT_path':
                ev.set_config(k, v)
        if self.mesh is not None:
            ev.set_config('mesh', self.mesh)
        ev.load_data(self.dwi_filename, self.scheme_filename,
                     mask_filename=self.mask_filename, b0_thr=self.b0_thr)
        return ev

    def run(self, resume: bool = True, checkpoint: bool = True) -> dict:
        """Process all subjects; returns {subject: results_path}."""
        # prefetch pipeline: while subject k fits/saves, subject k+1's
        # NIfTI load + preprocessing run on a background thread (the
        # native pass releases the GIL).  Costs: peak host memory holds
        # TWO preprocessed subject volumes, and at verbosity >= 2 the
        # prefetched subject's load messages interleave with the current
        # subject's fit output.  Disabled when (a) distributed: _is_done's
        # broadcast and the other collectives must stay on the main thread
        # in their program order, or (b) the Rician debias is on: it runs
        # on the DEVICE inside load_data, and a background device
        # allocation would race the active fit for device memory.  Opt
        # out: config={'prefetch': False}.
        prefetch_on = bool(self.config.get('prefetch', True)) \
            and not self.config.get('distributed') \
            and not self.config.get('doDebiasSignal')
        ex = None
        pending = {}            # subject -> Future
        reqs = {}               # subject -> the request id of its spans
        if prefetch_on and len(self.subjects) > 1:
            from concurrent.futures import ThreadPoolExecutor
            ex = ThreadPoolExecutor(max_workers=1,
                                    thread_name_prefix='sweep-prefetch')

        def start_prefetch(idx):
            for s in self.subjects[idx:]:
                if s not in pending and not (resume and self._is_done(s)):
                    reqs[s] = trace.new_req()
                    pending[s] = ex.submit(self._prepare, s, reqs[s])
                    return

        if ex is not None:
            start_prefetch(0)
        try:
            self._run_subjects(resume, checkpoint, ex, pending, reqs,
                               start_prefetch)
        finally:
            # also on KeyboardInterrupt/SystemExit: an uncancelled future
            # would keep the non-daemon worker loading for minutes and
            # block interpreter exit at the atexit join
            if ex is not None:
                for fut in pending.values():
                    fut.cancel()
                ex.shutdown(wait=True)
            # the kept model outlives the sweep: its staged inputs are the
            # last subject's signal on the card, of no use to another one
            if self._warm is not None:
                self._warm[1][0]._stage_cache = None
        return self.results

    def _run_subjects(self, resume, checkpoint, ex, pending, reqs,
                      start_prefetch):
        for si, subject in enumerate(self.subjects):
            if resume and self._is_done(subject):
                LOG(f'-> [{subject}] already fitted, skipping (resume)')
                self.results[subject] = self._result_dir(subject)
                continue
            try:
                with trace.span('subject', req=reqs.pop(subject, None)) as sp:
                    # the wait for the prefetched load, or the load itself
                    with trace.span('prefetch_wait'):
                        fut = pending.pop(subject, None)
                        ev = fut.result() if fut is not None \
                            else self._prepare(subject)
                    if ex is not None:
                        start_prefetch(si + 1)
                    if checkpoint:
                        ev.set_config('fit_checkpoint', pjoin(
                            self.study_path, subject,
                            f'.amico_tpu_ckpt_{self.model_name}.npz'))
                    ev.set_model(self.model_name)
                    if self.model_params:
                        ev.model.set(**self.model_params)
                    if self.solver_params:
                        ev.set_solver(**self.solver_params)
                    ev.generate_kernels(lmax=self.lmax, ndirs=self.ndirs)
                    # cross-subject warm state: subjects sharing a scheme and
                    # model/solver params reuse one model instance (its
                    # kernel-prep caches survive) and the resampled
                    # KERNELS/htable -- per-subject LUT resampling is the
                    # dominant sweep overhead once the fit itself is sub-second
                    sig = self._warm_signature(ev)
                    if self._warm is not None and self._warm[0] == sig:
                        model, kernels, htable = self._warm[1]
                        model.scheme = ev.scheme
                        ev.model = model
                        ev.KERNELS = kernels
                        ev.htable = htable
                        self.warm_reused.append(subject)
                    else:
                        ev.load_kernels()
                        self._warm = (sig, (ev.model, ev.KERNELS, ev.htable))
                    ev.fit()
                    ev.save_results()
                self.results[subject] = self._result_dir(subject)
                self.seconds[subject] = sp.elapsed
            except Exception as e:
                # distributed: the other processes are (or will be) waiting
                # in this subject's collectives; going on would pair the
                # next subject's collectives with theirs
                if self._spmd():
                    raise
                WARNING(f'[{subject}] failed: {e}')  # keep sweeping
                self.results[subject] = f'FAILED: {e}'
