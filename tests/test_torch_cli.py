"""The port's command line (``python -m amico_tpu_torch``, amico_tpu_torch.cli)
on the CPU (``--config device=cpu``): the cases of tests/test_cli.py, each
verb's output against the JAX package's CLI on the same inputs (FreeWater
maps at tests/test_torch_freewater.py's Human bounds, the scheme files
byte for byte), the ``profile_dir`` trace, and the card as the default."""
import glob
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from amico_tpu import cli as jax_cli
from amico_tpu.io import nifti
from amico_tpu_torch.cli import _cmd_warmup, build_parser, main
from tests.test_cli import study  # noqa: F401  (the fixture)
from tests.test_torch_freewater import BOUNDS, assert_close_dist

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ['--config', 'device=cpu']
FIT = ['--model', 'FreeWater', '--b0-thr', '50', '--lmax', '6',
       '--verbose', '0', '--config', 'doComputeNRMSE=True',
       '--solver', 'lambda2=1e-3']


def load(path):
    return nifti.load(str(path)).get_fdata()


def test_cli_fit_freewater_matches_jax(study, tmp_path):  # noqa: F811
    """tests/test_cli.py:30 on the port, its maps against the JAX CLI's."""
    rc = main(['fit', str(study), 's1', *FIT, '--regenerate', *CPU,
               '--output-path', str(tmp_path / 'port')])
    assert rc == 0
    assert jax_cli.main(['fit', str(study), 's1', *FIT, '--regenerate',
                         '--output-path', str(tmp_path / 'jax')]) == 0
    fw = load(tmp_path / 'port' / 'fit_FW.nii.gz')
    assert np.isfinite(fw).all()
    assert (tmp_path / 'port' / 'fit_NRMSE.nii.gz').is_file()
    for name in ('fit_FW', 'fit_NRMSE'):
        assert_close_dist(load(tmp_path / 'port' / f'{name}.nii.gz'),
                          load(tmp_path / 'jax' / f'{name}.nii.gz'),
                          BOUNDS['Human'], name)


def _fsl_files(tmp_path):
    np.savetxt(tmp_path / 'bvals', np.array([[0, 1000, 1000, 2000]]))
    bvecs = np.array([[0, 1, 0, 0.7071],
                      [0, 0, 1, 0.7071],
                      [0, 0, 0, 0.0]])
    np.savetxt(tmp_path / 'bvecs', bvecs)
    return str(tmp_path / 'bvals'), str(tmp_path / 'bvecs')


@pytest.mark.parametrize('verb,extra', [
    ('fsl2scheme', ['--b-step', '100', '--flip-y']),
    ('sandi2scheme', ['0.03', '0.01', '--TE', '0.08'])])
def test_cli_scheme_converters_match_jax(tmp_path, capsys, verb, extra):
    """tests/test_cli.py:43 on the port, and the same file as the JAX
    CLI's, byte for byte."""
    bvals, bvecs = _fsl_files(tmp_path)
    texts = []
    for name, fn in (('port', main), ('jax', jax_cli.main)):
        out = tmp_path / f'{name}.scheme'
        assert fn([verb, bvals, bvecs, *extra, '-o', str(out)]) == 0
        assert capsys.readouterr().out.splitlines()[-1] == str(out)
        texts.append(out.read_text())
    assert texts[0] == texts[1]
    table = np.loadtxt(tmp_path / 'port.scheme', skiprows=1)
    assert table.shape[0] == 4
    if verb == 'fsl2scheme':
        assert table[1, 3] == pytest.approx(1000.0)


def test_cli_kv_parsing_error():
    """tests/test_cli.py:58 on the port."""
    with pytest.raises(SystemExit):
        main(['fit', '.', '.', '--model', 'NODDI', '--solver', 'oops'])


def test_cli_sweep_two_subjects(study, capsys):  # noqa: F811
    """tests/test_cli.py:63 on the port."""
    shutil.copytree(study / 's1', study / 's2')
    args = ['--model', 'FreeWater', '--b0-thr', '50', '--lmax', '6',
            '--verbose', '0', '--config', 'tile_size=32', *CPU]
    rc = main(['sweep', str(study), '--subjects', 's1', 's2', *args])
    assert rc == 0
    for s in ('s1', 's2'):
        assert (study / s / 'AMICO' / 'FreeWater' / 'fit_FW.nii.gz').exists()
    out = capsys.readouterr().out
    assert 's1:' in out and 's2:' in out
    rc = main(['sweep', str(study), '--subjects', 'nope', 's1',
               '--no-resume', *args])
    assert rc == 1


def test_warmup_parser_and_defaults():
    """tests/test_cli.py:83 on the port."""
    p = build_parser()
    assert p.prog == 'amico_tpu_torch'
    a = p.parse_args(['warmup'])
    assert a.func is _cmd_warmup
    assert a.voxels == 409600 and a.scheme is None
    a2 = p.parse_args(['warmup', '--voxels', '1000', '--scheme', 's.scheme',
                       '-v', '0'])
    assert a2.voxels == 1000 and a2.scheme == 's.scheme'
    jax_verbs = set(jax_cli.build_parser()._subparsers._group_actions[0]
                    .choices)
    assert set(p._subparsers._group_actions[0].choices) == jax_verbs


def test_cli_warmup_study_mode(study, capsys):  # noqa: F811
    """tests/test_cli.py:96 on the port: the fit runs, nothing is
    written, and the line names the device."""
    rc = main(['warmup', '--study', str(study), '--subject', 's1',
               '--model', 'FreeWater', '--b0-thr', '50', '-v', '0', *CPU])
    assert rc == 0
    assert not (study / 's1' / 'AMICO' / 'FreeWater').exists()
    assert 'FreeWater fit' in capsys.readouterr().out


def test_cli_warmup_generic(tmp_path, capsys, monkeypatch):
    """The generic warmup: the full-grid NODDI fit on a few voxels."""
    monkeypatch.setenv('AMICO_TPU_HOME', str(tmp_path / 'home'))
    assert main(['warmup', '--voxels', '16', '-v', '0', *CPU]) == 0
    out = capsys.readouterr().out
    assert '16-voxel NODDI fit on cpu' in out


def test_cli_setup(tmp_path, monkeypatch):
    """setup fills the rotation-matrix cache the JAX package's setup fills,
    with the same file names."""
    names = []
    for pkg, fn in (('port', main), ('jax', jax_cli.main)):
        monkeypatch.setenv('AMICO_TPU_HOME', str(tmp_path / pkg))
        assert fn(['setup', '--lmax', '2']) == 0
        names.append(sorted(os.listdir(tmp_path / pkg)))
    assert names[0] and names[0] == names[1]


def test_cli_profile_dir_writes_a_trace(study, tmp_path):  # noqa: F811
    """fit with profile_dir: a *.pt.trace.json under the directory holds
    the 'fit' range, and the maps equal an unprofiled fit's."""
    prof = tmp_path / 'prof'
    for out, cfg in (('a', []), ('b', ['--config', f'profile_dir={prof}'])):
        assert main(['fit', str(study), 's1', *FIT, *CPU, *cfg,
                     '--output-path', str(tmp_path / out)]) == 0
    traces = glob.glob(str(prof / '*.pt.trace.json'))
    assert len(traces) == 1, traces
    with open(traces[0]) as f:
        assert '"name": "fit"' in f.read()
    np.testing.assert_array_equal(load(tmp_path / 'a' / 'fit_FW.nii.gz'),
                                  load(tmp_path / 'b' / 'fit_FW.nii.gz'))


def test_cli_defaults_to_the_card(study):  # noqa: F811
    """Without device=cpu the fit goes to the card; with none it raises."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default runs there')
    from amico_tpu_torch import AmicoError
    with pytest.raises(AmicoError, match='no CUDA card'):
        main(['fit', str(study), 's1', *FIT])


def test_python_m_runs_the_cli(tmp_path):
    """``python -m amico_tpu_torch`` in a fresh process where neither jax
    nor amico_tpu can be imported."""
    bvals, bvecs = _fsl_files(tmp_path)
    out = str(tmp_path / 'o.scheme')
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = sys.modules['amico_tpu'] = None\n"
            f"sys.argv = ['amico_tpu_torch', 'fsl2scheme', {bvals!r}, "
            f"{bvecs!r}, '-o', {out!r}]\n"
            "runpy.run_module('amico_tpu_torch', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == out and os.path.isfile(out)
    proc = subprocess.run([sys.executable, '-m', 'amico_tpu_torch', 'fit'],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 2 and 'usage: amico_tpu_torch fit' in \
        proc.stderr
