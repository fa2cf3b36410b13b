"""End-to-end NODDI demo on a synthetic subject.

The port of the JAX package's ``examples/noddi_demo.py``: it builds a small
synthetic DWI study (2-shell scheme + volume), then runs the exact pipeline
a reference AMICO user would run, on the card unless ``--device cpu`` is
given:

    python -m amico_tpu_torch.examples.noddi_demo [study_dir] [--device cpu]
"""
import argparse
import os
import tempfile

import numpy as np

import amico_tpu_torch
from amico_tpu_torch.device import resolve_device
from amico_tpu_torch.io import nifti
from amico_tpu_torch.ops.sphere import fibonacci_hemisphere

DIM = (16, 16, 8)


def make_subject(study, subject='subject1', dim=DIM, seed=0):
    subj = os.path.join(study, subject)
    os.makedirs(subj, exist_ok=True)

    # 2-shell scheme: 2 b0 + 30 @ b=700 + 30 @ b=2000
    rows = [np.zeros((2, 4)),
            np.c_[fibonacci_hemisphere(30), np.full(30, 700.0)],
            np.c_[fibonacci_hemisphere(30), np.full(30, 2000.0)]]
    tab = np.vstack(rows)
    np.savetxt(os.path.join(subj, 'DWI.scheme'), tab, fmt='%.6f',
               header='VERSION: BVECTOR', comments='')

    # synthetic volume: smooth anisotropic signal + noise
    rng = np.random.RandomState(seed)
    g = tab[:, :3]
    b = tab[:, 3]
    nvox = int(np.prod(dim))
    axes = rng.randn(nvox, 3)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    cos2 = (g @ axes.T) ** 2
    sig = np.exp(-b[:, None] * (0.4e-3 + 1.3e-3 * cos2)).T
    fwf = rng.uniform(0, 0.3, (nvox, 1))
    sig = (1 - fwf) * sig + fwf * np.exp(-b * 3e-3)[None, :]
    vol = (800 * np.abs(sig * (1 + 0.02 * rng.randn(*sig.shape)))) \
        .reshape(dim + (tab.shape[0],)).astype(np.float32)
    nifti.save(nifti.Nifti1Image(vol, affine=np.diag([2., 2., 2., 1.])),
               os.path.join(subj, 'DWI.nii.gz'))
    return subject


def run(study, device='cuda', dim=DIM):
    """The demo on a ``dim`` subject in ``study``, fitted on ``device``;
    returns the maps' directory."""
    resolve_device(device)           # no card: AmicoError, before any work
    subject = make_subject(study, dim=dim)

    amico_tpu_torch.set_verbose(2)
    ev = amico_tpu_torch.Evaluation(study, subject, device=device)
    ev.set_config('doComputeNRMSE', True)
    ev.load_data('DWI.nii.gz', 'DWI.scheme')
    ev.set_model('NODDI')
    ev.generate_kernels(ndirs=500)
    ev.load_kernels()
    ev.fit()
    ev.save_results()

    out = os.path.join(study, subject, 'AMICO', 'NODDI')
    ndi = nifti.load(os.path.join(out, 'fit_NDI.nii.gz')).get_fdata()
    odi = nifti.load(os.path.join(out, 'fit_ODI.nii.gz')).get_fdata()
    fwf = nifti.load(os.path.join(out, 'fit_FWF.nii.gz')).get_fdata()
    print(f'\nResults in {out}')
    print(f'  NDI mean {ndi.mean():.3f}  ODI mean {odi.mean():.3f}  '
          f'FWF mean {fwf.mean():.3f}')
    return out


def parse_args(argv, prefix):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('study', nargs='?', help='study directory (default: a '
                   'new temporary one)')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default), 'cuda:N' or 'cpu'")
    args = p.parse_args(argv)
    return (args.study or tempfile.mkdtemp(prefix=prefix)), args.device


def main(argv=None):
    study, device = parse_args(argv, 'amico_tpu_torch_demo_')
    run(study, device)


if __name__ == '__main__':
    main()
