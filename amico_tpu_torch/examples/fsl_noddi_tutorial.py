"""The reference AMICO wiki's NODDI tutorial flow, unchanged.

The port of the JAX package's ``examples/fsl_noddi_tutorial.py``.  The
canonical reference usage (wiki "Fitting the NODDI model") is:

    amico.util.fsl2scheme("bvals", "bvecs")   # FSL gradient files -> scheme
    ae = amico.Evaluation("Study01", "Subject01")
    ae.load_data(...); ae.set_model("NODDI"); ae.generate_kernels()
    ae.load_kernels(); ae.fit(); ae.save_results()

This runs that exact sequence against amico_tpu_torch on a synthetic
subject whose gradients are provided as FSL bvals/bvecs files, on the card
unless ``--device cpu`` is given:

    python -m amico_tpu_torch.examples.fsl_noddi_tutorial [study_dir] \\
        [--device cpu]
"""
import os

import numpy as np

import amico_tpu_torch
from amico_tpu_torch.device import resolve_device
from amico_tpu_torch.examples.noddi_demo import parse_args
from amico_tpu_torch.io import nifti
from amico_tpu_torch.ops.sphere import fibonacci_hemisphere

DIM = (12, 12, 6)


def make_subject(study, subject='Subject01', dim=DIM, seed=0):
    """Synthetic 2-shell subject with FSL-style bvals/bvecs files."""
    subj = os.path.join(study, subject)
    os.makedirs(subj, exist_ok=True)

    g1, g2 = fibonacci_hemisphere(24), fibonacci_hemisphere(32)
    bvals = np.concatenate([np.zeros(2), np.full(24, 700.0),
                            np.full(32, 2000.0)])
    bvecs = np.vstack([np.zeros((2, 3)), g1, g2]).T     # (3, nS) FSL layout
    np.savetxt(os.path.join(subj, 'bvals'), bvals[None], fmt='%.1f')
    np.savetxt(os.path.join(subj, 'bvecs'), bvecs, fmt='%.6f')

    # simple synthetic signal: per-voxel mono-exponential + noise
    rng = np.random.RandomState(seed)
    nv = int(np.prod(dim))
    adc = 0.4e-3 + 2.2e-3 * rng.rand(nv, 1)
    sig = np.exp(-bvals[None, :] * adc) + 0.02 * rng.randn(nv, bvals.size)
    vol = np.clip(sig, 0, None).reshape(dim + (bvals.size,)).astype(np.float32)
    nifti.save(nifti.Nifti1Image(vol, np.eye(4)),
               os.path.join(subj, 'DWI.nii.gz'))
    nifti.save(nifti.Nifti1Image(np.ones(dim, np.uint8), np.eye(4)),
               os.path.join(subj, 'mask.nii.gz'))
    return subj


def run(study, device='cuda', dim=DIM):
    """The tutorial on a ``dim`` subject in ``study``, fitted on
    ``device``; returns the maps' directory."""
    resolve_device(device)           # no card: AmicoError, before any work
    subj = make_subject(study, dim=dim)

    # --- the reference tutorial, line for line -------------------------
    amico_tpu_torch.util.fsl2scheme(os.path.join(subj, 'bvals'),
                                    os.path.join(subj, 'bvecs'))
    ae = amico_tpu_torch.Evaluation(study, 'Subject01', device=device)
    ae.load_data(dwi_filename='DWI.nii.gz', scheme_filename='bvals.scheme',
                 mask_filename='mask.nii.gz', b0_thr=0)
    ae.set_model('NODDI')
    # (shrunk atom grid so the demo runs in seconds on the CPU; a real
    # study keeps the default 12x12 grid)
    ae.model.set(IC_VFs=np.linspace(0.3, 0.99, 4),
                 IC_ODs=np.array([0.06, 0.3, 0.8]))
    ae.generate_kernels(regenerate=True)
    ae.load_kernels()
    ae.fit()
    ae.save_results()
    # -------------------------------------------------------------------

    out = os.path.join(subj, 'AMICO', 'NODDI')
    maps = sorted(f for f in os.listdir(out) if f.endswith('.nii.gz'))
    print(f'\nmaps written to {out}:')
    for f in maps:
        img = nifti.load(os.path.join(out, f)).get_fdata()
        print(f'  {f:24s} range [{img.min():.3f}, {img.max():.3f}]')
    return out


def main(argv=None):
    study, device = parse_args(argv, 'amico_tpu_torch_fsl_')
    run(study, device)


if __name__ == '__main__':
    main()
