"""Multi-subject sweep over a device mesh.

The port of the JAX package's ``examples/sweep_multichip_demo.py``: one
model fitted over many subjects, voxel tiles spread over every local card
(``parallel.make_mesh``), resume at subject granularity and chunk-level
mid-fit checkpointing.  On the card unless ``--device cpu`` is given (a
one-entry CPU mesh):

    python -m amico_tpu_torch.examples.sweep_multichip_demo [study_dir] \\
        [--device cpu]
"""
import os

import amico_tpu_torch
from amico_tpu_torch.device import resolve_device
from amico_tpu_torch.examples.noddi_demo import make_subject, parse_args
from amico_tpu_torch.parallel.mesh import make_mesh
from amico_tpu_torch.sweep import SubjectSweep

DIM = (12, 12, 6)


def run(study, device='cuda', dim=DIM, n_subjects=3):
    """The sweep over ``n_subjects`` subjects of ``dim`` voxels in
    ``study`` on a mesh of ``device``; returns {subject: maps directory}."""
    resolve_device(device)           # no card: AmicoError, before any work
    subjects = [make_subject(study, f'subject{i}', dim=dim, seed=i)
                for i in range(n_subjects)]

    amico_tpu_torch.set_verbose(2)
    mesh = make_mesh(device=device)  # all local cards on the ('data',) axis
    print(f'Mesh: {mesh.size} x {mesh.devices[0].type}')

    sweep = SubjectSweep(
        study, subjects, 'NODDI',
        dwi_filename='DWI.nii.gz',
        mesh=mesh,
        # chunk-level mid-fit checkpointing: a killed sweep resumes
        # mid-subject (the reference has no fit-level resume at all)
        config={'fit_checkpoint': os.path.join(study, 'fit_ckpt.npz'),
                'device': device},
    )
    results = sweep.run(resume=True)
    for subject, path in results.items():
        print(f'  {subject}: {path}')

    # re-running is a no-op thanks to resume-by-existence
    again = SubjectSweep(study, subjects, 'NODDI',
                         dwi_filename='DWI.nii.gz', mesh=mesh,
                         config={'device': device}).run(resume=True)
    assert again.keys() == results.keys()
    return results


def main(argv=None):
    study, device = parse_args(argv, 'amico_tpu_torch_sweep_')
    run(study, device)


if __name__ == '__main__':
    main()
