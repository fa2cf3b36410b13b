"""The port's Evaluation facade (device='cpu') against the JAX package's
full-facade golden, in this process and in a fresh one where jax cannot be
imported (as on a GPU machine without JAX)."""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(__file__), 'data')
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the map set of tests/test_golden.py::FACADE_MAPS
FACADE_MAPS = ('fit_NDI', 'fit_ODI', 'fit_FWF', 'fit_dir', 'fit_NRMSE',
               'fit_NDI_modulated', 'fit_ODI_modulated')


def run_port_facade(study, home):
    """tests/test_golden.py::run_facade_study's recipe through the port;
    returns {map name: array} and the config.pickle key set."""
    os.environ['AMICO_TPU_HOME'] = home
    import torch
    torch.set_num_threads(1)
    import amico_tpu_torch
    from amico_tpu.io import nifti
    ev = amico_tpu_torch.Evaluation(study, 'subj', device='cpu')
    ev.set_config('doComputeNRMSE', True)
    ev.set_config('doSaveModulatedMaps', True)
    ev.load_data(dwi_filename='DWI.nii.gz', scheme_filename='DWI.scheme')
    ev.set_model('NODDI')
    ev.model.set(IC_VFs=np.linspace(0.3, 0.99, 4),
                 IC_ODs=np.array([0.06, 0.3, 0.8]))
    ev.generate_kernels(ndirs=500)
    ev.load_kernels()
    ev.fit()
    ev.save_results()
    out = os.path.join(study, 'subj', 'AMICO', 'NODDI')
    maps = {name: nifti.load(os.path.join(out, name + '.nii.gz'))
            .get_fdata().astype(np.float32) for name in FACADE_MAPS}
    with open(os.path.join(out, 'config.pickle'), 'rb') as fid:
        cfg = pickle.load(fid)
    return maps, set(cfg)


def check_against_golden(maps, cfg_keys):
    """tests/test_golden.py::test_facade_golden's bounds."""
    fixture = np.load(os.path.join(DATA, 'golden_facade.npz'))
    for name in FACADE_MAPS:
        ref = fixture[name]
        assert maps[name].shape == ref.shape, name
        err = np.abs(maps[name] - ref)
        assert np.percentile(err, 95) < 1e-3, (name, np.percentile(err, 95))
        assert err.max() < 5e-3, (name, err.max())
    missing = set(fixture['config_keys'].tolist()) - cfg_keys
    assert not missing, f'config.pickle lost keys: {sorted(missing)}'
    assert 'device' in cfg_keys


@pytest.fixture
def study(tmp_path):
    from tests.test_dist import make_study
    make_study(str(tmp_path / 'study'))
    return str(tmp_path / 'study')


def test_facade_golden(study, tmp_path):
    check_against_golden(*run_port_facade(study, str(tmp_path / 'home')))


def test_facade_runs_without_jax(study, tmp_path):
    code = (
        "import sys, pickle\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from tests.test_torch_facade import run_port_facade\n"
        f"maps, keys = run_port_facade({study!r}, {str(tmp_path / 'home')!r})\n"
        "assert not any(m == 'jax' or m.startswith('jax.')\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        f"pickle.dump((maps, keys), open({str(tmp_path / 'out.pkl')!r}, 'wb'))\n")
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp_path / 'out.pkl', 'rb') as fid:
        check_against_golden(*pickle.load(fid))


def test_package_sources_import_no_jax():
    root = os.path.join(REPO, 'amico_tpu_torch')
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith('.py'):
                with open(os.path.join(dirpath, f)) as fid:
                    text = fid.read()
                assert 'import jax' not in text and 'from jax' not in text, f


def test_model_zoo(tmp_path):
    import amico_tpu_torch
    ev = amico_tpu_torch.Evaluation(str(tmp_path), 'subj', device='cpu')
    for name in ('FreeWater', 'CylinderZeppelinBall', 'SANDI',
                 'StickZeppelinBall', 'VolumeFractions'):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            ev.set_model(name)
    with pytest.raises(amico_tpu_torch.AmicoError):
        ev.set_model('NoSuchModel')


@pytest.mark.parametrize('key,value', [('distributed', True),
                                       ('profile_dir', '/nonexistent'),
                                       ('doDebiasSignal', True)])
def test_unported_config_raises(study, tmp_path, key, value):
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    import amico_tpu_torch
    ev = amico_tpu_torch.Evaluation(study, 'subj', device='cpu')
    ev.set_config(key, value)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        ev.load_data(dwi_filename='DWI.nii.gz', scheme_filename='DWI.scheme')
        ev.set_model('NODDI')
        ev.model.set(IC_VFs=np.linspace(0.3, 0.99, 4),
                     IC_ODs=np.array([0.06, 0.3, 0.8]))
        ev.generate_kernels(ndirs=500)
        ev.load_kernels()
        ev.fit()
