"""The port's Evaluation facade (device='cpu') against the JAX package's
full-facade golden, in this process and in a fresh one where neither jax nor
amico_tpu can be imported (the port stands alone, as on a GPU machine
without JAX); and no source of the port or chip_smoke.py imports either."""
import ast
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


def run_port_facade(study, home, config=None, jax_package=False):
    """tests/test_golden.py::run_facade_study's recipe through the port (or,
    with ``jax_package``, through amico_tpu), with ``config`` set before
    load_data; returns {map name: array} and the config.pickle key set."""
    os.environ['AMICO_TPU_HOME'] = home
    import torch
    torch.set_num_threads(1)
    if jax_package:
        import amico_tpu as pkg
        from amico_tpu.io import nifti
        ev = pkg.Evaluation(study, 'subj')
    else:
        import amico_tpu_torch as pkg
        from amico_tpu_torch.io import nifti
        ev = pkg.Evaluation(study, 'subj', device='cpu')
    ev.set_config('doComputeNRMSE', True)
    ev.set_config('doSaveModulatedMaps', True)
    for k, v in (config or {}).items():
        ev.set_config(k, v)
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


def check_against_golden(maps, cfg_keys, fixture=None):
    """tests/test_golden.py::test_facade_golden's bounds, against its
    fixture or against ``fixture``'s maps."""
    if fixture is None:
        fixture = np.load(os.path.join(DATA, 'golden_facade.npz'))
        missing = set(fixture['config_keys'].tolist()) - cfg_keys
        assert not missing, f'config.pickle lost keys: {sorted(missing)}'
        assert 'device' in cfg_keys
    for name in FACADE_MAPS:
        ref = fixture[name]
        assert maps[name].shape == ref.shape, name
        err = np.abs(maps[name] - ref)
        assert np.percentile(err, 95) < 1e-3, (name, np.percentile(err, 95))
        assert err.max() < 5e-3, (name, err.max())


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
        "sys.modules['amico_tpu'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from tests.test_torch_facade import run_port_facade\n"
        f"maps, keys = run_port_facade({study!r}, {str(tmp_path / 'home')!r})\n"
        "import importlib, pkgutil, amico_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    amico_tpu_torch.__path__, 'amico_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for name in ('ops.native', 'preproc', 'sweep', 'cli', '__main__',\n"
        "             'examples.noddi_demo', 'examples.fsl_noddi_tutorial',\n"
        "             'examples.sweep_multichip_demo'):\n"
        "    assert 'amico_tpu_torch.' + name in names, names\n"
        "from amico_tpu_torch.ops import native\n"
        "assert native.available()\n"
        "assert not any(m.split('.')[0] in ('jax', 'amico_tpu')\n"
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


def _imports(path):
    """Top-level module names a source imports (relative imports skipped)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_neither_jax_nor_amico_tpu():
    files = [os.path.join(REPO, 'chip_smoke.py')]
    for dirpath, _, names in os.walk(os.path.join(REPO, 'amico_tpu_torch')):
        files += [os.path.join(dirpath, f) for f in names if f.endswith('.py')]
    assert len(files) > 30
    # the examples are modules of the package, and the walk covers them
    for name in ('__init__', 'noddi_demo', 'fsl_noddi_tutorial',
                 'sweep_multichip_demo'):
        assert os.path.join(REPO, 'amico_tpu_torch', 'examples',
                            name + '.py') in files, name
    bad = [(os.path.relpath(f, REPO), name) for f in files
           for name in _imports(f)
           if name.split('.')[0] in ('jax', 'amico_tpu')]
    assert not bad, bad


def test_principal_directions_default_to_the_card():
    """No device means the card, as the facade's 'device' key does: without
    one it raises instead of running on the CPU."""
    import torch

    from amico_tpu_torch import AmicoError
    from amico_tpu_torch.pipeline import principal_directions
    from amico_tpu_torch.testing import demo_scheme
    scheme = demo_scheme()
    y = np.random.RandomState(0).rand(5, scheme.nS)
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default runs there')
    with pytest.raises(AmicoError, match='no CUDA card'):
        principal_directions(y, scheme, 'OLS', False)
    assert principal_directions(y, scheme, 'OLS', False,
                                device='cpu').shape == (5, 3)


def test_model_zoo(tmp_path):
    """All six models of the JAX package: the four that fit are set; the
    two kernel-only ones raise from their set_solver as the JAX package's
    facade does."""
    import amico_tpu
    import amico_tpu_torch
    ev = amico_tpu_torch.Evaluation(str(tmp_path), 'subj', device='cpu')
    ev_j = amico_tpu.Evaluation(str(tmp_path), 'subj')
    for name in ('NODDI', 'FreeWater', 'CylinderZeppelinBall', 'SANDI'):
        ev.set_model(name)
        ev_j.set_model(name)
        assert ev.model.id == ev_j.model.id == name
        assert ev.model.maps_name == ev_j.model.maps_name
        assert ev.get_config('solver_params') == \
            ev_j.get_config('solver_params')
    for name in ('StickZeppelinBall', 'VolumeFractions'):
        for e, err in ((ev, amico_tpu_torch.AmicoError),
                       (ev_j, amico_tpu.AmicoError)):
            with pytest.raises(err, match='Not implemented'):
                e.set_model(name)
        assert ev.model.id == ev_j.model.id == name
    with pytest.raises(amico_tpu_torch.AmicoError):
        ev.set_model('NoSuchModel')


def test_top_level_api_matches_the_jax_packages():
    """Every name of amico_tpu.__all__, and the submodules a reference
    script reaches as attributes, resolve on the port to the port's own
    objects, preproc, sweep and cli among them."""
    import amico_tpu
    import amico_tpu_torch
    for name in amico_tpu.__all__ + ['util', 'scheme', 'synthesis', 'lut']:
        obj = getattr(amico_tpu_torch, name)
        mod = getattr(obj, '__module__', None) or obj.__name__ \
            if not isinstance(obj, str) else 'amico_tpu_torch'
        assert mod.startswith('amico_tpu_torch'), (name, mod)
    assert set(amico_tpu.__all__) <= set(amico_tpu_torch.__all__)
    from amico_tpu_torch.io.scheme import Scheme, fsl2scheme, sandi2scheme
    assert amico_tpu_torch.util.fsl2scheme is fsl2scheme
    assert amico_tpu_torch.util.sandi2scheme is sandi2scheme
    assert amico_tpu_torch.scheme.Scheme is Scheme
    assert amico_tpu_torch.get_verbose() == amico_tpu_torch.util.get_verbose()
    assert sorted(amico_tpu_torch.util.__all__) == \
        sorted(amico_tpu.util.__all__)
    assert sorted(amico_tpu_torch.scheme.__all__) == \
        sorted(amico_tpu.scheme.__all__)
    import amico_tpu.preproc
    import amico_tpu.sweep
    for name, names in (('preproc', ('_rician_mean', 'debias_rician_batch',
                                     'debiasRician')),
                        ('sweep', ('SubjectSweep',)),
                        ('cli', ('main', 'build_parser'))):
        mod = getattr(amico_tpu_torch, name)
        assert mod.__name__ == f'amico_tpu_torch.{name}'
        for attr in names:
            assert callable(getattr(mod, attr)), (name, attr)
            if name != 'cli':
                assert hasattr(getattr(amico_tpu, name), attr)


@pytest.mark.parametrize('key', ['distributed', 'mesh'])
def test_mesh_and_distributed_configs(study, tmp_path, key):
    """``distributed=True`` in a one-process gloo group, and a 4-entry CPU
    mesh: the facade's maps equal the plain facade's bit for bit (so they
    hold the golden's bounds too), and config.pickle keeps its key set.
    tests/test_torch_dist.py runs two processes."""
    import torch.distributed as tdist
    from amico_tpu_torch.parallel import dist, make_mesh
    from tests.test_torch_dist import free_port
    home = str(tmp_path / 'home')
    plain, _ = run_port_facade(study, home)
    if key == 'mesh':
        maps, keys = run_port_facade(study, home,
                                     {'mesh': make_mesh(4, device='cpu')})
    else:
        tdist.init_process_group('gloo', world_size=1, rank=0,
                                 init_method=f'tcp://localhost:{free_port()}')
        try:
            assert dist.process_count() == 1 and dist.is_coordinator()
            dist.initialize()          # a group exists: a no-op
            maps, keys = run_port_facade(study, home, {'distributed': True})
        finally:
            tdist.destroy_process_group()
    check_against_golden(maps, keys)
    for name in FACADE_MAPS:
        np.testing.assert_array_equal(maps[name], plain[name], err_msg=name)


def test_profile_dir_config(study, tmp_path):
    """profile_dir, once a raise case: the facade writes a torch.profiler
    trace holding the 'fit' range, and its maps hold the golden's bounds."""
    import glob
    prof = tmp_path / 'prof'
    check_against_golden(*run_port_facade(study, str(tmp_path / 'home'),
                                          {'profile_dir': str(prof)}))
    traces = glob.glob(str(prof / '*.pt.trace.json'))
    assert len(traces) == 1, traces
    with open(traces[0]) as f:
        assert '"name": "fit"' in f.read()


def test_debias_config_matches_jax(study, tmp_path):
    """doDebiasSignal, once a raise case: the port's facade against the JAX
    package's with the same SNR, at the golden's bounds."""
    import shutil
    cfg = {'doDebiasSignal': True, 'DWI-SNR': 25.0}
    jax_study = str(tmp_path / 'jax_study')
    shutil.copytree(study, jax_study)
    ref, _ = run_port_facade(jax_study, str(tmp_path / 'jax_home'), cfg,
                             jax_package=True)
    maps, keys = run_port_facade(study, str(tmp_path / 'home'), cfg)
    check_against_golden(maps, keys, fixture=ref)
    plain, _ = run_port_facade(study, str(tmp_path / 'home'))
    assert not np.array_equal(plain['fit_NDI'], maps['fit_NDI'])


def test_modulated_maps_are_noddi_only(tmp_path, capsys):
    """doSaveModulatedMaps on FreeWater: both facades warn with the JAX
    package's text and write the same files, the other maps; the port's
    match the JAX package's (on its Pallas kernel) at
    tests/test_torch_freewater.py's bounds."""
    import amico_tpu
    import amico_tpu_torch
    from amico_tpu.io import nifti
    from amico_tpu_torch.testing import (demo_freewater, demo_scheme,
                                         freewater_voxels, write_demo_subject)
    from tests.test_torch_freewater import (BOUNDS, PROTOCOL,
                                            assert_close_dist)
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    scheme = demo_scheme(**PROTOCOL)
    _, kernels, htable = demo_freewater(scheme, 'Human', str(tmp_path / 'k'))
    y, _, _, _ = freewater_voxels(300, kernels, htable, seed=11)
    written = {}
    for pkg in (amico_tpu_torch, amico_tpu):
        study = str(tmp_path / pkg.__name__)
        write_demo_subject(os.path.join(study, 'subj'), scheme, y, (10, 6, 5))
        kw = {'device': 'cpu'} if pkg is amico_tpu_torch else {}
        ev = pkg.Evaluation(study, 'subj', **kw)
        ev.set_config('doSaveModulatedMaps', True)
        ev.load_data(dwi_filename='DWI.nii', scheme_filename='DWI.scheme')
        ev.set_model('FreeWater')
        if not kw:
            ev.set_solver(backend='pallas')
        ev.generate_kernels(ndirs=500)
        ev.load_kernels()
        ev.fit()
        capsys.readouterr()
        level = pkg.get_verbose()
        pkg.set_verbose(1)              # another test may have silenced it
        try:
            ev.save_results()
        finally:
            pkg.set_verbose(level)
        assert ('"doSaveModulatedMaps" is only meaningful for NODDI, not '
                '"Free-Water"') in capsys.readouterr().out, pkg.__name__
        out = os.path.join(study, 'subj', 'AMICO', 'FreeWater')
        written[pkg] = {f: nifti.load(os.path.join(out, f)).get_fdata()
                        for f in os.listdir(out) if f.endswith('.nii.gz')}
    got, ref = written[amico_tpu_torch], written[amico_tpu]
    assert sorted(got) == sorted(ref) == [
        'fit_FW.nii.gz', 'fit_FiberVolume.nii.gz', 'fit_dir.nii.gz']
    np.testing.assert_allclose(got['fit_dir.nii.gz'], ref['fit_dir.nii.gz'],
                               atol=1e-5)
    for name in ('fit_FiberVolume.nii.gz', 'fit_FW.nii.gz'):
        assert_close_dist(got[name], ref[name], BOUNDS['Human'], name)
