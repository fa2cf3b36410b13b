"""The port's examples (amico_tpu_torch/examples/) on the CPU, each on a
4x4x2 subject: the NODDI demo and the FSL tutorial against the same steps
through the JAX package's examples (its subject writer, its facade) at
tests/test_torch_edge_cases.py's NODDI bounds, the sweep demo on a
one-entry CPU mesh; and each refusing to run without a card unless asked
for the CPU."""
import gzip
import os

import numpy as np
import pytest
import torch

import amico_tpu
from amico_tpu.io import nifti
from tests.test_torch_edge_cases import JAX_SOLVER, assert_noddi_close

torch.set_num_threads(1)

DIM = (4, 4, 2)
NRMSE_ATOL = 1e-6


def same_files(a_dir, b_dir, names):
    """Each file alike in both directories (a .gz by its decompressed
    bytes: the gzip header carries the write time)."""
    def read(path):
        with (gzip.open if path.endswith('.gz') else open)(path, 'rb') as f:
            return f.read()
    for f in names:
        a, b = (os.path.join(d, f) for d in (a_dir, b_dir))
        assert read(a) == read(b), f


def load(out, name):
    return nifti.load(os.path.join(out, name + '.nii.gz')).get_fdata()


def jax_fit(study, subject, load_kw, model_set=None, regenerate=False,
            solver=None):
    """The JAX example's steps through amico_tpu.Evaluation on ``solver``
    (JAX_SOLVER's by default); returns the maps' directory."""
    ev = amico_tpu.Evaluation(study, subject)
    ev.set_config('doComputeNRMSE', True)
    ev.load_data(**load_kw)
    ev.set_model('NODDI')
    if model_set:
        ev.model.set(**model_set)
    ev.set_solver(**(solver or JAX_SOLVER['NODDI']))
    ev.generate_kernels(regenerate=regenerate, ndirs=500)
    ev.load_kernels()
    ev.fit()
    ev.save_results(path_suffix=None if solver is None else 'xla')
    return os.path.join(study, subject, 'AMICO',
                        'NODDI' if solver is None else 'NODDI_xla')


def compare_with_jax(out, ref_out, jax_stagewise, nrmse):
    """The port's written NDI, ODI and FWF against the JAX package's
    (``assert_noddi_close``), finite; NRMSE within NRMSE_ATOL where the
    maps agree to the golden's max."""
    names = ('fit_NDI', 'fit_ODI', 'fit_FWF')
    got = np.stack([load(out, n) for n in names], -1)
    ref = np.stack([load(ref_out, n) for n in names], -1)
    assert np.isfinite(got).all()
    assert_noddi_close(got, ref, lambda: np.stack(
        [load(jax_stagewise(), n) for n in names], -1), 'maps')
    if nrmse:
        same = (np.abs(got - ref) < 5e-3).all(-1)
        np.testing.assert_allclose(load(out, 'fit_NRMSE')[same],
                                   load(ref_out, 'fit_NRMSE')[same],
                                   atol=NRMSE_ATOL)


def test_noddi_demo_matches_jax(tmp_path):
    """examples/noddi_demo.py's steps (2 b0 + 2 x 30 DWIs, the full 12x12
    grid, NRMSE): the port's run() against the JAX example's subject and
    steps."""
    import examples.noddi_demo as jax_demo
    from amico_tpu_torch.examples import noddi_demo
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    out = noddi_demo.run(str(tmp_path / 'port'), 'cpu', dim=DIM)
    subject = jax_demo.make_subject(str(tmp_path / 'jax'), dim=DIM)
    same_files(tmp_path / 'port' / subject, tmp_path / 'jax' / subject,
               ('DWI.scheme', 'DWI.nii.gz'))
    amico_tpu.set_verbose(0)
    kw = dict(dwi_filename='DWI.nii.gz', scheme_filename='DWI.scheme')
    study = str(tmp_path / 'jax')
    ref = jax_fit(study, subject, kw)
    compare_with_jax(out, ref, lambda: jax_fit(study, subject, kw,
                                               solver={'backend': 'xla'}),
                     nrmse=True)


def test_fsl_tutorial_matches_jax(tmp_path):
    """examples/fsl_noddi_tutorial.py's steps (FSL bvals/bvecs through
    fsl2scheme, a mask, the shrunk grid): the port's run() against the JAX
    example's subject and steps."""
    import examples.fsl_noddi_tutorial as jax_tut
    from amico_tpu_torch.examples import fsl_noddi_tutorial
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    out = fsl_noddi_tutorial.run(str(tmp_path / 'port'), 'cpu', dim=DIM)
    subj = jax_tut.make_subject(str(tmp_path / 'jax'), dim=DIM)
    amico_tpu.util.fsl2scheme(os.path.join(subj, 'bvals'),
                              os.path.join(subj, 'bvecs'))
    same_files(tmp_path / 'port' / 'Subject01',
               tmp_path / 'jax' / 'Subject01',
               ('bvals', 'bvecs', 'bvals.scheme', 'DWI.nii.gz',
                'mask.nii.gz'))
    amico_tpu.set_verbose(0)
    kw = dict(dwi_filename='DWI.nii.gz', scheme_filename='bvals.scheme',
              mask_filename='mask.nii.gz', b0_thr=0)
    grid = dict(IC_VFs=np.linspace(0.3, 0.99, 4),
                IC_ODs=np.array([0.06, 0.3, 0.8]))
    study = str(tmp_path / 'jax')
    ref = jax_fit(study, 'Subject01', kw, grid, regenerate=True)
    compare_with_jax(out, ref, lambda: jax_fit(
        study, 'Subject01', kw, grid, solver={'backend': 'xla'}),
        nrmse=False)


def test_sweep_demo_on_a_cpu_mesh(tmp_path, capsys):
    """examples/sweep_multichip_demo.py's steps on make_mesh(device='cpu')
    (one entry): three subjects written with finite maps, the rerun a
    no-op (its own assert), and subject0's maps equal to the NODDI demo's
    fit of the same subject (seed 0) bit for bit."""
    from amico_tpu_torch.examples import noddi_demo, sweep_multichip_demo
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    study = str(tmp_path / 'sweep')
    results = sweep_multichip_demo.run(study, 'cpu', dim=DIM)
    assert 'Mesh: 1 x cpu' in capsys.readouterr().out
    assert sorted(results) == ['subject0', 'subject1', 'subject2']
    for subject, path in results.items():
        assert path == os.path.join(study, subject, 'AMICO', 'NODDI')
        for name in ('fit_NDI', 'fit_ODI', 'fit_FWF', 'fit_dir'):
            assert np.isfinite(load(path, name)).all(), (subject, name)
    assert not os.path.exists(os.path.join(study, 'fit_ckpt.npz'))
    demo = noddi_demo.run(str(tmp_path / 'demo'), 'cpu', dim=DIM)
    for name in ('fit_NDI', 'fit_ODI', 'fit_FWF'):
        np.testing.assert_array_equal(load(results['subject0'], name),
                                      load(demo, name), err_msg=name)


@pytest.mark.parametrize('name', ['noddi_demo', 'fsl_noddi_tutorial',
                                  'sweep_multichip_demo'])
def test_examples_run_on_the_card_by_default(tmp_path, name):
    """Without ``--device cpu`` an example asks for the card: off one it
    raises the port's AmicoError before writing anything."""
    import importlib
    from amico_tpu_torch import AmicoError
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default runs there')
    mod = importlib.import_module(f'amico_tpu_torch.examples.{name}')
    with pytest.raises(AmicoError, match='no CUDA card'):
        mod.main([str(tmp_path / 'study')])
    assert not (tmp_path / 'study').exists()
