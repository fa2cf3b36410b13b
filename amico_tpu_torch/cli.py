"""Command-line interface of the port (counterpart of ``amico_tpu.cli``,
with the same verbs, flags and ``key=value`` parsing):

    python -m amico_tpu_torch setup [--lmax 12]
    python -m amico_tpu_torch warmup [--study STUDY --subject S --model M]
    python -m amico_tpu_torch fit STUDY SUBJECT --model NODDI \
        [--dwi DWI.nii] [--scheme DWI.scheme] [--mask mask.nii] \
        [--b0-thr 0] [--ndirs 500] [--lmax 12] [--regenerate] \
        [--config key=value ...] [--solver key=value ...] \
        [--param key=value ...] [--output-path DIR]
    python -m amico_tpu_torch sweep STUDY --subjects S1 S2 ... --model M
    python -m amico_tpu_torch fsl2scheme BVALS BVECS [-o OUT] [--b-step 1.0]
    python -m amico_tpu_torch sandi2scheme BVALS BVECS DELTA SMALLDEL [-o OUT]

``key=value`` options are parsed as Python literals when possible (so
``--solver lambda1=0.5`` and ``--config doComputeRMSE=True`` work), and are
passed through the same signature-filtered dispatch as the Python API.
The fit runs on the ``device`` config key's device: the card unless
``--config device=cpu`` is given.
"""
from __future__ import annotations

import argparse
import ast
import sys


def _kv(pairs):
    out = {}
    for p in pairs or []:
        if '=' not in p:
            raise SystemExit(f"expected key=value, got '{p}'")
        k, v = p.split('=', 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def _filter_model_params(model_name: str, params: dict) -> dict:
    """Signature-filter --param values against the model's set(), matching
    the WARNING-and-ignore behavior --solver gets (core.py set_solver)."""
    if not params:
        return params
    import inspect

    from . import models as _models
    from .utils.logging import WARNING
    if not hasattr(_models, model_name):
        return params            # set_model will raise the clear error
    accepted = set(inspect.signature(
        getattr(_models, model_name).set).parameters) - {'self'}
    known = {k: v for k, v in params.items() if k in accepted}
    for k in params.keys() - known.keys():
        WARNING(f'model parameter "{k}" is not used by {model_name}; '
                'ignoring it')
    return known


def _cmd_setup(args):
    from . import setup
    setup(lmax=args.lmax)
    return 0


def _cmd_fit(args):
    # validate key=value options before touching any data
    config = _kv(args.config)
    solver = _kv(args.solver)
    params = _filter_model_params(args.model, _kv(args.param))

    from . import Evaluation, set_verbose
    set_verbose(args.verbose)
    ev = Evaluation(args.study, args.subject, output_path=args.output_path)
    for k, v in config.items():
        ev.set_config(k, v)
    ev.load_data(dwi_filename=args.dwi, scheme_filename=args.scheme,
                 mask_filename=args.mask, b0_thr=args.b0_thr)
    ev.set_model(args.model)
    if params:
        ev.model.set(**params)
    ev.set_solver(**solver)
    ev.generate_kernels(regenerate=args.regenerate, lmax=args.lmax,
                        ndirs=args.ndirs)
    ev.load_kernels()
    ev.fit()
    ev.save_results(path_suffix=args.suffix)
    return 0


def _cmd_sweep(args):
    config = _kv(args.config)
    solver = _kv(args.solver)
    params = _filter_model_params(args.model, _kv(args.param))

    from . import set_verbose
    from .sweep import SubjectSweep
    set_verbose(args.verbose)
    sweep = SubjectSweep(args.study, args.subjects, args.model,
                         dwi_filename=args.dwi, scheme_filename=args.scheme,
                         mask_filename=args.mask, b0_thr=args.b0_thr,
                         ndirs=args.ndirs, lmax=args.lmax,
                         config=config, model_params=params,
                         solver_params=solver)
    results = sweep.run(resume=not args.no_resume,
                        checkpoint=not args.no_checkpoint)
    failed = [s for s, r in results.items() if str(r).startswith('FAILED')]
    for s, r in results.items():
        print(f'{s}: {r}')
    return 1 if failed else 0


def _cmd_warmup(args):
    """Build what the first fit on this machine would otherwise build --
    the CUDA kernels (nvcc, into ``build/amico_tpu_torch/<hash>/``) and the
    native host library (g++) -- then run the fit once: the generic
    full-brain NODDI fit, or with --study the production pipeline on the
    real subject.  There is no compilation cache to fill: the builds are
    the one-time cost.  Run once after install, or in an image build."""
    import os
    import time

    import numpy as np

    from . import set_verbose
    from .device import resolve_device
    from .io.scheme import Scheme
    from .ops import native
    from .ops.sphere import amico_home, fibonacci_hemisphere
    from .testing import demo_noddi, demo_voxels
    set_verbose(args.verbose)
    config = _kv(args.config)
    device = resolve_device(config.get('device'))
    t0 = time.time()
    native.available()
    if device.type == 'cuda':
        import torch

        from .ops import cuda_build
        cuda_build.load_library()
        where = (f'{torch.cuda.get_device_name(device)}; CUDA kernels in '
                 f'{os.path.dirname(cuda_build.library_path())}')
    else:
        where = 'cpu'
    built = f'builds {time.time() - t0:.1f}s'

    if args.study:
        # study mode: drive the production pipeline once on the real
        # subject (its LUT is generated into the study and reused by every
        # later fit).  --param/--config/--solver mirror `fit` so the warmed
        # LUT matches the configuration the real fit will use.
        from . import Evaluation
        solver = _kv(args.solver)
        params = _filter_model_params(args.model, _kv(args.param))
        ev = Evaluation(args.study, args.subject)
        for k, v in config.items():
            ev.set_config(k, v)
        ev.load_data(dwi_filename=args.dwi or 'DWI.nii',
                     scheme_filename=args.scheme or 'DWI.scheme',
                     mask_filename=args.mask, b0_thr=args.b0_thr)
        ev.set_model(args.model)
        if params:
            ev.model.set(**params)
        ev.set_solver(**solver)
        ev.generate_kernels()
        ev.load_kernels()
        t0 = time.time()
        ev.fit()
        print(f'warmup: ran the {args.model} fit for study "{args.study}" '
              f'on {where} in {time.time() - t0:.1f}s ({built})')
        return 0

    if args.scheme:
        scheme = Scheme(args.scheme, b0_thr=args.b0_thr)
    else:
        # the flagship 2-shell NODDI protocol (the bench workload)
        rows = [np.zeros((9, 4)),
                np.c_[fibonacci_hemisphere(30), np.full(30, 700.0)],
                np.c_[fibonacci_hemisphere(60), np.full(60, 2000.0)]]
        scheme = Scheme(np.vstack(rows))

    kdir = os.path.join(amico_home(), 'warmup_kernels')
    os.makedirs(kdir, exist_ok=True)
    model, kernels, htable = demo_noddi(scheme, small=False,
                                        kernels_dir=kdir)
    y, DIRs, _ = demo_voxels(args.voxels, kernels, htable, seed=0)

    class _Ctx:
        def __init__(self):
            self.y, self.DIRs, self.htable, self.KERNELS = \
                y, DIRs, htable, kernels

        def get_config(self, k):
            return {'tile_size': 'auto', 'voxels_per_chunk': 'auto',
                    'device': device}.get(k)

    t0 = time.time()
    model.fit(_Ctx())
    t_first = time.time() - t0
    t0 = time.time()
    model.fit(_Ctx())
    t_warm = time.time() - t0
    # Evaluation.fit runs the DTI direction fit before every model fit
    from .pipeline import principal_directions
    principal_directions(y, scheme, 'OLS', False, device=device)
    print(f'warmup: ran the {args.voxels}-voxel NODDI fit on {where} in '
          f'{t_first:.1f}s (warm re-fit {t_warm:.2f}s; {built})')
    return 0


def _cmd_fsl2scheme(args):
    from .io.scheme import fsl2scheme
    out = fsl2scheme(args.bvals, args.bvecs, schemeFilename=args.output,
                     bStep=args.b_step,
                     flipAxes=(args.flip_x, args.flip_y, args.flip_z))
    print(out)
    return 0


def _cmd_sandi2scheme(args):
    from .io.scheme import sandi2scheme
    out = sandi2scheme(args.bvals, args.bvecs, args.Delta, args.smalldel,
                       TE_data=args.TE, schemeFilename=args.output,
                       bStep=args.b_step)
    print(out)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog='amico_tpu_torch',
        description='AMICO on PyTorch and CUDA: linearized microstructure '
        'fitting.')
    sub = p.add_subparsers(dest='command', required=True)

    ps = sub.add_parser('setup', help='precompute SH rotation matrices')
    ps.add_argument('--lmax', type=int, default=12)
    ps.set_defaults(func=_cmd_setup)

    pwu = sub.add_parser(
        'warmup', help='build the CUDA kernels and the native library and '
        'run the fit once (one-time; makes the first real fit start warm)')
    pwu.add_argument('--scheme', default=None,
                     help='protocol to warm up for (default: the standard '
                     '2-shell NODDI protocol; with --study: the scheme '
                     'filename inside the subject directory)')
    pwu.add_argument('--voxels', type=int, default=409600,
                     help='masked voxel count to size the chunk shapes for '
                     '(default: full brain, 409600)')
    pwu.add_argument('--study', default=None,
                     help='study directory: warm up by driving the real '
                     'pipeline once on --subject (its LUT, mask geometry '
                     'and protocol)')
    pwu.add_argument('--subject', default='.',
                     help='subject subdirectory for --study mode')
    pwu.add_argument('--model', default='NODDI',
                     help='model to fit in --study mode')
    pwu.add_argument('--dwi', default=None,
                     help='DWI filename for --study mode (default DWI.nii)')
    pwu.add_argument('--mask', default=None,
                     help='mask filename for --study mode')
    pwu.add_argument('--b0-thr', type=float, default=0)
    pwu.add_argument('--config', action='append', metavar='KEY=VALUE',
                     help='pipeline config for --study mode, and device= '
                     'in both modes (repeatable)')
    pwu.add_argument('--solver', action='append', metavar='KEY=VALUE',
                     help='solver params for --study mode (repeatable)')
    pwu.add_argument('--param', action='append', metavar='KEY=VALUE',
                     help='model params for --study mode (repeatable)')
    pwu.add_argument('-v', '--verbose', type=int, default=2)
    pwu.set_defaults(func=_cmd_warmup)

    pf = sub.add_parser('fit', help='run the full single-subject pipeline')
    pf.add_argument('study', help='study directory')
    pf.add_argument('subject', help='subject subdirectory')
    pf.add_argument('--model', required=True,
                    help='NODDI | FreeWater | CylinderZeppelinBall | SANDI | ...')
    pf.add_argument('--dwi', default='DWI.nii')
    pf.add_argument('--scheme', default='DWI.scheme')
    pf.add_argument('--mask', default=None)
    pf.add_argument('--b0-thr', type=float, default=0.0)
    pf.add_argument('--ndirs', type=int, default=500)
    pf.add_argument('--lmax', type=int, default=12)
    pf.add_argument('--regenerate', action='store_true')
    pf.add_argument('--output-path', default=None)
    pf.add_argument('--suffix', default=None)
    pf.add_argument('--verbose', type=int, default=2, choices=(0, 1, 2, 3))
    pf.add_argument('--config', action='append', metavar='KEY=VALUE',
                    help='pipeline config (repeatable)')
    pf.add_argument('--solver', action='append', metavar='KEY=VALUE',
                    help='solver params (repeatable)')
    pf.add_argument('--param', action='append', metavar='KEY=VALUE',
                    help='model params for model.set() (repeatable)')
    pf.set_defaults(func=_cmd_fit)

    pw = sub.add_parser('sweep', help='fit one model over many subjects '
                        '(resume + warm cross-subject caches)')
    pw.add_argument('study', help='study directory')
    pw.add_argument('--subjects', nargs='+', required=True,
                    help='subject subdirectories')
    pw.add_argument('--model', required=True,
                    help='model name (e.g. NODDI, FreeWater, SANDI)')
    pw.add_argument('--dwi', default='DWI.nii')
    pw.add_argument('--scheme', default='DWI.scheme')
    pw.add_argument('--mask', default=None)
    pw.add_argument('--b0-thr', type=float, default=0.0)
    pw.add_argument('--ndirs', type=int, default=500)
    pw.add_argument('--lmax', type=int, default=12)
    pw.add_argument('--no-resume', action='store_true',
                    help='re-fit subjects whose results already exist')
    pw.add_argument('--no-checkpoint', action='store_true',
                    help='disable chunk-level mid-fit checkpoints')
    pw.add_argument('--verbose', type=int, default=2, choices=(0, 1, 2, 3))
    pw.add_argument('--config', action='append', metavar='KEY=VALUE',
                    help='Evaluation config override (repeatable)')
    pw.add_argument('--solver', action='append', metavar='KEY=VALUE',
                    help='solver parameter (repeatable)')
    pw.add_argument('--param', action='append', metavar='KEY=VALUE',
                    help='model parameter (repeatable)')
    pw.set_defaults(func=_cmd_sweep)

    p1 = sub.add_parser('fsl2scheme', help='FSL bvals/bvecs -> scheme file')
    p1.add_argument('bvals')
    p1.add_argument('bvecs')
    p1.add_argument('-o', '--output', default=None)
    p1.add_argument('--b-step', type=float, default=1.0)
    p1.add_argument('--flip-x', action='store_true')
    p1.add_argument('--flip-y', action='store_true')
    p1.add_argument('--flip-z', action='store_true')
    p1.set_defaults(func=_cmd_fsl2scheme)

    p2 = sub.add_parser('sandi2scheme',
                        help='FSL bvals/bvecs + timings -> STEJSKALTANNER scheme')
    p2.add_argument('bvals')
    p2.add_argument('bvecs')
    p2.add_argument('Delta', type=float, help='gradient separation [s]')
    p2.add_argument('smalldel', type=float, help='gradient duration [s]')
    p2.add_argument('--TE', type=float, default=None)
    p2.add_argument('-o', '--output', default=None)
    p2.add_argument('--b-step', type=float, default=1.0)
    p2.set_defaults(func=_cmd_sandi2scheme)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == '__main__':
    sys.exit(main())
