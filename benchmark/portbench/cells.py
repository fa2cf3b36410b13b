"""Set-up, measured window and check of one cell.

The traffic file's ``kind`` picks the loop: ``refit`` (a regularisation
sweep on one loaded subject: ``Evaluation.set_solver`` then
``Evaluation.fit``, back to back) or ``study`` (``SubjectSweep.run`` over
sweeps of new subjects).  Both loops are closed, with one caller.
"""
from __future__ import annotations

import gc
import hashlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from reference import dictionary, module, pipeline

from . import arith, judge, nifti, registry, synth, trace, work

CACHE = os.path.join(registry.ROOT, 'build', 'bench')
FILES = ('DWI.nii', 'DWI.scheme', 'mask.nii')


class Run:
    """What one run measured: the per-layer readers take it."""

    def __init__(self, kind: str):
        self.kind = kind
        self.spans: list[dict] = []     # instrumented facade calls
        self.window = (0.0, 0.0)        # perf_counter seconds
        self.count = 0                  # fits (refit) or subjects (study)
        self.summary = None             # trace.summarize(), traced runs
        self.least_s = None             # least solve time of the window

    def in_window(self, name: str) -> list[dict]:
        lo, hi = self.window
        return [s for s in self.spans
                if s['name'] == name and lo <= s['t0'] <= hi]


def reference_dictionary(config: dict, bvals, bvecs, pulses=None) -> dict:
    """The reference's dictionary, kept in the checkout's cache by a key of
    the configuration, the protocol and the recipe's source: the shared
    recipe and the model's own module."""
    h = hashlib.sha256(json.dumps(config, sort_keys=True).encode())
    for src in (dictionary, module(config['reference'])):
        with open(src.__file__, 'rb') as f:
            h.update(f.read())
    h.update(np.ascontiguousarray(bvals).tobytes())
    h.update(np.ascontiguousarray(bvecs).tobytes())
    if pulses is not None:
        h.update(np.ascontiguousarray(pulses).tobytes())
    path = os.path.join(CACHE, 'reference',
                        f'{config["name"]}.{h.hexdigest()[:16]}.npz')
    if os.path.isfile(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    D = dictionary.build(config, bvals, bvecs, pulses)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp.npz'
    np.savez(tmp, **D)
    os.replace(tmp, path)
    return D


def write_subject(path: str, config: dict, vol: torch.Tensor, bvals, bvecs,
                  mask: np.ndarray, pulses=None) -> None:
    """DWI.nii (float32), DWI.scheme and mask.nii.  The scheme is
    ``VERSION: BVECTOR`` (x, y, z, b) without ``pulses``, and with them
    ``VERSION: STEJSKALTANNER`` (x, y, z, G, Delta, delta, TE) written to
    full float64 precision, so that the program derives the harness's
    b-values from it."""
    os.makedirs(path, exist_ok=True)
    dims = tuple(config['protocol']['matrix'])
    mm = float(config['protocol']['voxel_mm'])
    nifti.write(os.path.join(path, 'DWI.nii'), vol.cpu().numpy(),
                dims + (len(bvals),), mm)
    nifti.write(os.path.join(path, 'mask.nii'), mask.astype(np.uint8).T,
                dims, mm)
    scheme = os.path.join(path, 'DWI.scheme')
    if pulses is None:
        np.savetxt(scheme, np.column_stack([bvecs, bvals]), fmt='%.6f',
                   header='VERSION: BVECTOR', comments='')
    else:
        np.savetxt(scheme, np.column_stack([bvecs, pulses]), fmt='%.17g',
                   header='VERSION: STEJSKALTANNER', comments='')


def lambda_grid(config: dict, traffic: dict) -> list[dict]:
    """The traffic's scales of the configuration's swept lambda."""
    s = config['solver']
    base = {'lambda1': float(s['lambda1']), 'lambda2': float(s['lambda2'])}
    out = []
    for scale in traffic['lambda_scales']:
        lam = dict(base)
        lam[s['swept']] *= float(scale)
        out.append(lam)
    return out


def instrument(run: Run):
    """Time the facade's stages (each inside a ``portbench.<name>``
    profiler range, which names the device's idle gaps) and keep each
    fit's facade and tile-driver timers; returns the function that undoes
    it."""
    from torch.profiler import record_function

    from amico_tpu_torch.core import Evaluation
    saved = {}

    def wrap(name):
        orig = saved[name] = getattr(Evaluation, name)

        def timed(self, *args, **kwargs):
            with record_function('portbench.' + name):
                t0 = time.perf_counter()
                out = orig(self, *args, **kwargs)
                t1 = time.perf_counter()
            rec = {'name': name, 't0': t0, 't1': t1}
            if name == 'fit':
                rec['facade'] = dict(self._last_fit_facade_timers)
                rec['engine'] = dict(self.model._last_fit_timers)
            run.spans.append(rec)
            return out
        setattr(Evaluation, name, timed)

    for name in ('load_data', 'generate_kernels', 'load_kernels', 'fit',
                 'save_results'):
        wrap(name)

    def undo():
        for name, orig in saved.items():
            setattr(Evaluation, name, orig)
    return undo


class Cell:
    """One run of a cell: ``setup``, ``window`` and ``check``."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: str = 'cuda', workdir: str | None = None):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = device
        self.work = workdir or os.path.join(
            tempfile.gettempdir(), 'portbench', config['name'],
            traffic['name'])
        self.run = Run(traffic['kind'])
        # the facade settings applied before each load_data
        self.settings = pipeline.evaluation(config)
        self.bvals, self.bvecs, self.pulses = synth.protocol(config)
        self.mask = synth.mask(config)
        self.n_vox = int(self.mask.sum())
        self.xyz = np.argwhere(self.mask)          # C order: the fit's order

    # ------------------------------------------------------------ set-up
    def setup(self):
        """The inputs, then the program's set-up and warm-up."""
        self.inputs()
        getattr(self, '_setup_' + self.traffic['kind'])()
        if self.device == 'cuda':
            torch.cuda.synchronize()

    def inputs(self, write: bool = True):
        """Make the cell's subjects from the seed (written as files with
        ``write``) and keep the raw signals of the voxels to be checked."""
        import amico_tpu_torch
        amico_tpu_torch.set_verbose(1)
        shutil.rmtree(self.work, ignore_errors=True)
        os.makedirs(self.work)
        self.D = reference_dictionary(self.config, self.bvals, self.bvecs,
                                      self.pulses)
        f32 = dict(dtype=torch.float32, device=self.device)
        aniso = torch.as_tensor(self.D['aniso'], **f32)
        iso = torch.as_tensor(self.D['iso'], **f32)
        k = int(self.config['check']['voxels'])
        refit = self.traffic['kind'] == 'refit'
        n_pool = 1 if refit else int(self.traffic['pool_subjects'])
        self.pool_sel, self.pool_raw = [], []
        for p in range(n_pool):
            vol, y = synth.subject(self.config, aniso, iso, self.seed, p)
            if write:
                write_subject(os.path.join(self.work, 'pool', f'p{p}'),
                              self.config, vol, self.bvals, self.bvecs,
                              self.mask, self.pulses)
            sel = judge.sample(self.n_vox, k // n_pool, self.seed + p)
            self.pool_sel.append(sel)
            self.pool_raw.append(
                y[torch.as_tensor(sel, device=y.device)].cpu().numpy())
            del vol, y
        if refit:
            self.grid = lambda_grid(self.config, self.traffic)
            self.group = np.arange(self.pool_sel[0].size) % len(self.grid)

    def _atoms(self) -> str:
        """The program's LUT atoms of this configuration, in the checkout's
        cache: generated by the first run, reused by the later ones.  The
        facade settings join the key only where the configuration states
        them (the atoms of a direction-averaged fit are generated on the
        averaged scheme)."""
        keys = ('model', 'model_params', 'lut', 'protocol') + (
            ('evaluation',) if 'evaluation' in self.config else ())
        key = hashlib.sha256(json.dumps(
            [self.config[k] for k in keys],
            sort_keys=True).encode()).hexdigest()[:12]
        return os.path.join(CACHE, 'atoms', f'{self.config["name"]}.{key}')

    def _setup_refit(self):
        from amico_tpu_torch.core import Evaluation
        cfg = self.config
        ev = Evaluation(os.path.join(self.work, 'pool'), 'p0',
                        device=self.device)
        for k, v in self.settings.items():
            ev.set_config(k, v)
        ev.load_data('DWI.nii', 'DWI.scheme', mask_filename='mask.nii')
        ev.set_model(cfg['model'])
        ev.model.set(**cfg['model_params'])
        ev.set_config('ATOMS_path', os.path.join(self._atoms(), ev.model.id))
        if self.traffic.get('corrected_dwi'):
            ev.set_config('doSaveCorrectedDWI', True)
        ev.set_solver(**self.grid[0])
        ev.generate_kernels(ndirs=int(cfg['lut']['ndirs']),
                            lmax=int(cfg['lut']['lmax']))
        ev.load_kernels()
        for lam in self.grid:                      # warm-up: one fit a lambda
            ev.set_solver(**lam)
            ev.fit()
        self.ev = ev
        self.answers = [None] * len(self.grid)

    def _setup_study(self):
        self.study = os.path.join(self.work, 'study')
        os.makedirs(self._atoms(), exist_ok=True)
        os.makedirs(self.study)
        os.symlink(self._atoms(), os.path.join(self.study, 'kernels'))
        self.written = []                          # (output dir, pool index)
        self.attempted = self.failed = 0
        self._sweep('warm', int(self.traffic['warmup_subjects']),
                    count=False)

    def _sweep(self, tag: str, n: int, count: bool = True):
        from amico_tpu_torch.sweep import SubjectSweep
        cfg, P = self.config, int(self.traffic['pool_subjects'])
        names, pools = [], {}
        for j in range(n):
            name = f'{tag}_{j}'
            d = os.path.join(self.study, name)
            os.makedirs(d)
            for f in FILES:
                os.symlink(os.path.join(self.work, 'pool', f'p{j % P}', f),
                           os.path.join(d, f))
            names.append(name)
            pools[name] = j % P
        out = os.path.join(self.work, 'out', tag)
        s = cfg['solver']
        sw = SubjectSweep(
            self.study, names, cfg['model'], mask_filename='mask.nii',
            ndirs=int(cfg['lut']['ndirs']), lmax=int(cfg['lut']['lmax']),
            config={'OUTPUT_path': out, 'device': self.device,
                    **self.settings},
            model_params=cfg['model_params'],
            solver_params={'lambda1': float(s['lambda1']),
                           'lambda2': float(s['lambda2'])})
        results = sw.run()
        if count:
            self.attempted += n
            for name in names:
                if name in sw.seconds:
                    self.written.append((results[name], pools[name]))
                else:
                    self.failed += 1

    # ------------------------------------------------------------ window
    def window(self, seconds: float, traced: bool):
        """Run the traffic for ``seconds`` (the last fit or sweep started in
        time runs to its end); returns the end-to-end readings."""
        run = self.run
        undo = instrument(run) if traced else (lambda: None)
        try:
            with trace.profiled(traced) as tr:
                w0 = time.perf_counter()
                out = getattr(self, '_window_' + self.traffic['kind'])(
                    w0, w0 + seconds)
            run.summary = tr.summary
        finally:
            undo()
        return out

    def _window_refit(self, w0: float, deadline: float) -> dict:
        ev, grid = self.ev, self.grid
        x, y, z = self.xyz[self.pool_sel[0]].T
        lat, i, t1 = [], 0, w0
        while time.perf_counter() < deadline:
            k = i % len(grid)
            t0 = time.perf_counter()
            ev.set_solver(**grid[k])
            ev.fit()
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            g = self.group == k
            R = ev.RESULTS
            self.answers[k] = {
                'maps': R['MAPs'][x[g], y[g], z[g]],
                'dwi': (R['DWI_corrected'][x[g], y[g], z[g]]
                        if 'DWI_corrected' in R else None)}
            i += 1
        self.run.window, self.run.count = (w0, t1), len(lat)
        self.attempted, self.failed = len(lat), 0
        h = len(lat) // 2
        if h:
            print(f'diagnostic fits {len(lat)} median s first half '
                  f'{np.median(lat[:h])!r} second half '
                  f'{np.median(lat[h:])!r}', file=sys.stderr)
        return {'refit_voxels_per_s': arith.rate(self.n_vox * len(lat), w0,
                                                 t1),
                'refit_p90_s': arith.percentile(lat, 90)}

    def _window_study(self, w0: float, deadline: float) -> dict:
        n = int(self.traffic['sweep_subjects'])
        k, t1, sweeps = 0, w0, []
        while time.perf_counter() < deadline:
            t0 = time.perf_counter()
            self._sweep(f's{k:04d}', n)
            t1 = time.perf_counter()
            sweeps.append(t1 - t0)
            k += 1
        print(f'diagnostic sweeps s {sweeps!r}', file=sys.stderr)
        self.run.window, self.run.count = (w0, t1), len(self.written)
        return {'study_voxels_per_s': arith.rate(
            self.n_vox * len(self.written), w0, t1)}

    def release(self):
        """Drop the program's state and its device memory."""
        self.__dict__.pop('ev', None)
        gc.collect()
        if self.device == 'cuda':
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def check(self, precision: str = 'float64') -> dict:
        """The numbers compared with the reference, {name: (value, limit)};
        ``precision='tf32'`` puts the control in the program's place."""
        prog, ref = getattr(self, '_answers_' + self.traffic['kind'])(
            precision)
        return judge.compare(self.config, prog, ref)

    def _reference(self, raw, lambdas, precision):
        return pipeline.solve_voxels(
            self.config, self.D, raw, self.bvals, self.bvecs, lambdas,
            bool(self.traffic.get('corrected_dwi')), precision, self.pulses)

    def _answers_refit(self, precision):
        lam = np.array([[self.grid[k]['lambda1'], self.grid[k]['lambda2']]
                        for k in self.group])
        raw = self.pool_raw[0]
        ref = self._reference(raw, lam, 'float64')
        if precision != 'float64':
            ctl = self._reference(raw, lam, precision)
            if ctl.get('dwi') is not None:       # in the program's units
                ctl['dwi'] = ctl['dwi'] * ctl['b0'][:, None]
            return ctl, ref
        prog = {'maps': np.full(ref['maps'].shape, np.nan),
                'dwi': np.full(raw.shape, np.nan)}
        for k, ans in enumerate(self.answers):
            g = self.group == k
            if ans is not None:
                prog['maps'][g] = ans['maps']
                if ans['dwi'] is not None:
                    prog['dwi'][g] = ans['dwi']
            print(f'diagnostic map_median at {self.grid[k]} '
                  f'{judge.median_error(prog["maps"][g], ref["maps"][g])!r}',
                  file=sys.stderr)
        return prog, ref

    def _answers_study(self, precision):
        s = self.config['solver']

        def answers(p, prec):
            lam = np.tile([float(s['lambda1']), float(s['lambda2'])],
                          (self.pool_sel[p].size, 1))
            return self._reference(self.pool_raw[p], lam, prec)['maps']

        refs = [answers(p, 'float64') for p in range(len(self.pool_raw))]
        if precision != 'float64':
            return ({'maps': np.concatenate([answers(p, precision)
                                             for p in range(len(refs))])},
                    {'maps': np.concatenate(refs)})
        prog, ref = [], []
        for out_dir, p in self.written:
            x, y, z = self.xyz[self.pool_sel[p]].T
            prog.append(np.stack(
                [nifti.read(os.path.join(out_dir, f'fit_{m}.nii.gz'))[x, y, z]
                 for m in self.config['maps']], -1))
            ref.append(refs[p])
        if not prog:                     # no subject written: nothing holds
            return {'maps': np.full((1, 1), np.nan)}, {'maps': np.zeros((1, 1))}
        return {'maps': np.concatenate(prog)}, {'maps': np.concatenate(ref)}

    def cleanup(self):
        shutil.rmtree(self.work, ignore_errors=True)

    # --------------------------------------------------------- the solve
    def least_time(self) -> tuple[float, str]:
        """The least device time of the window's solves and its bound."""
        flops, nbytes = work.least_work(
            self.config, self.n_vox, self.run.count,
            bool(self.traffic.get('corrected_dwi')))
        return work.least_time(flops, nbytes)
