"""A model without orientation, stated by files alone: a reference module
with no anisotropic atom and a configuration whose ``evaluation`` key sets
``doDirectionalAverage``, which the harness applies before ``load_data``.

The model here is a stub placed on the ``reference`` package's path by the
test alone (a ball a diffusivity), on a timed protocol with two diffusion
times.  Its dictionary has an empty ``aniso`` axis, its seeded signal is
constant across each shell before noise, the program's averaged scheme
and shell means are the reference's, the reference's solve receives the
averaged signal and dictionary with no LUT index, and the least-work count
reads one b0 and one sample a shell and one dictionary.  The harness's
re-fit and study loops then run the program's SANDI on such a subject
(its maps are not held against a reference here: the stub's solve is not
SANDI's).  A configuration without the key loads as before."""
import hashlib
import importlib
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

import reference
from conftest import small_bench
from portbench import cells, registry, synth, work
from reference import dictionary, pipeline

ISO_STUB = '''"""A model of the test alone, without orientation: a ball a
diffusivity of ``d_in`` and of ``d_isos``."""
import numpy as np

from .dictionary import hr_samples

SEEN = []


def atoms(params, shells, grad):
    b_hr, _ = hr_samples(shells, grad)
    d = list(params['d_in']) + list(params['d_isos'])
    return (np.zeros((0, b_hr.size)), np.array([np.exp(-b_hr * x) for x in d]),
            {})


def work(params, n_samples, n_dwi):
    n = len(params['d_in']) + len(params['d_isos'])
    return {'n_aniso': 0, 'n_iso': n, 'stages': [(n_samples, n)]}


def solve(config, D, y, lut, lambdas, want_dwi, q, bvals):
    SEEN.append({'lut': lut, 'D': D, 'y': y, 'bvals': bvals})
    return {'maps': np.zeros((y.shape[0], len(config['maps'])))}
'''

# two diffusion times; b = 1000 at both, so only the timing tells those
# two shells apart
TWO_TIMES = [[1000.0, 6, {'Delta': 0.019, 'delta': 0.008}],
             [3000.0, 6, {'Delta': 0.019, 'delta': 0.008}],
             [1000.0, 6, {'Delta': 0.049, 'delta': 0.008}],
             [2500.0, 6, {'Delta': 0.049, 'delta': 0.008}]]
N_SHELLS = len(TWO_TIMES)
SANDI_MAPS = ['fsoma', 'fneurite', 'fextra', 'Rsoma', 'Din', 'De']
SEED = 2 ** 31 + 2021


def _config(**evaluation) -> dict:
    return {
        'name': 'iso_tiny', 'model': 'SANDI', 'reference': 'iso_model',
        'maps': SANDI_MAPS,
        'model_params': {
            'd_is': 3.0e-3,
            'Rs': [float(r) for r in np.linspace(1.0, 12.0, 5) * 1e-6],
            'd_in': [float(d) for d in np.linspace(0.25, 3.0, 5) * 1e-3],
            'd_isos': [float(d) for d in np.linspace(0.25, 3.0, 5) * 1e-3]},
        'solver': {'lambda1': 0.0, 'lambda2': 5.0e-3, 'swept': 'lambda2'},
        'lut': {'ndirs': 500, 'lmax': 12},
        'protocol': {'b0': 4, 'blocks': 2, 'shells': TWO_TIMES,
                     'voxel_mm': 2.0, 'matrix': [6, 6, 4]},
        'mask': {'semi_axes': [2.5, 2.5, 1.5]},
        'signal': {'s0': 1000.0, 'snr_b0': 25.0, 'density': 0.3,
                   'lead': 0.5},
        'check': {'voxels': 64, 'limits': {'map_median': 1.0}},
        'evaluation': {'doDirectionalAverage': True, **evaluation}}


@pytest.fixture
def iso(tmp_path, monkeypatch):
    """``reference.iso_model``, a file found on the package's path; the
    harness's caches, the program's tables and the cells' files under the
    test's temporary directory."""
    src = tmp_path / 'models'
    src.mkdir()
    (src / 'iso_model.py').write_text(ISO_STUB)
    monkeypatch.setattr(reference, '__path__',
                        list(reference.__path__) + [str(src)])
    monkeypatch.setattr(cells, 'CACHE', str(tmp_path / 'cache'))
    monkeypatch.setenv('AMICO_TPU_HOME', str(tmp_path / 'amico_home'))
    importlib.invalidate_caches()
    yield reference.module('iso_model')
    sys.modules.pop('reference.iso_model', None)
    reference.__dict__.pop('iso_model', None)


def _dictionary(c):
    b, g, P = synth.protocol(c)
    return b, g, P, dictionary.build(c, b, g, P)


def test_an_empty_aniso_axis_and_a_signal_constant_on_each_shell(iso):
    c = _config()
    b, g, P, D = _dictionary(c)
    nS = b.size
    assert nS == 4 + 6 * N_SHELLS
    assert D['aniso'].shape == (500, nS, 0) and D['iso'].shape == (nS, 10)
    assert np.all(D['iso'][b == 0] == 1)
    c['signal']['snr_b0'] = math.inf                 # no noise
    gen = torch.Generator().manual_seed(5)
    y = synth.voxel_signals(
        c, torch.as_tensor(D['aniso'], dtype=torch.float32),
        torch.as_tensor(D['iso'], dtype=torch.float32), 40, gen).numpy()
    assert y.shape == (40, nS) and np.all(np.isfinite(y))
    assert np.allclose(y[:, b == 0], 1000.0, rtol=1e-6, atol=0)
    groups = dictionary.shells(b, P)
    assert len(groups) == N_SHELLS
    for _, rows in groups:
        s = y[:, rows]
        assert np.all(np.ptp(s, 1) <= 1e-6 * s.mean(1)), rows
    # one b at two diffusion times: two shells
    assert [(round(r['b']), r['Delta']) for r, _ in groups] == [
        (1000, 0.019), (3000, 0.019), (1000, 0.049), (2500, 0.049)]


def test_the_programs_average_is_the_references(iso, tmp_path):
    """The STEJSKALTANNER scheme the harness writes, read back by the
    program with ``doDirectionalAverage``: n_shells + 1 samples, in the
    reference's order, and each voxel's shell means equal to the
    reference's to float32 rounding."""
    from amico_tpu_torch.core import Evaluation
    c = _config()
    b, g, P, D = _dictionary(c)
    vol, raw = synth.subject(
        c, torch.as_tensor(D['aniso'], dtype=torch.float32),
        torch.as_tensor(D['iso'], dtype=torch.float32), SEED)
    mask = synth.mask(c)
    cells.write_subject(str(tmp_path / 's'), c, vol, b, g, mask, P)
    ev = Evaluation(str(tmp_path), 's', device='cpu')
    ev.set_config('doDirectionalAverage', True)
    ev.load_data('DWI.nii', 'DWI.scheme', mask_filename='mask.nii')
    rows, b_avg = pipeline.shell_rows(b, P)
    assert ev.scheme.nS == N_SHELLS + 1 == len(rows)
    assert np.array_equal(ev.scheme.b, b_avg)
    assert b_avg[0] == 0 and np.all(np.diff(b_avg) >= 0)
    # each averaged sample's timing is that of the reference's shell in
    # its place, the two b = 1000 shells included
    assert np.array_equal(ev.scheme.raw[1:, 3:], P[[r[0] for r in rows[1:]]])
    assert sorted(P[r[0], 1] for r in rows[1:3]) == [0.019, 0.049]
    assert b_avg[1:3] == pytest.approx([1000.0, 1000.0], rel=1e-12)
    raw = raw.numpy().astype(np.float64)
    y = raw / raw[:, b == 0].mean(1, keepdims=True)
    ref = pipeline.shell_average(y, rows, 1)
    prog = ev.niiDWI_img[mask]
    assert prog.shape == ref.shape == (int(mask.sum()), N_SHELLS + 1)
    assert np.allclose(prog, ref, rtol=1e-6, atol=1e-7)


def test_the_references_solve_takes_the_average(iso):
    c = _config()
    b, g, P, D = _dictionary(c)
    rng = np.random.default_rng(3)
    raw = 1000 * rng.random((5, 10)) @ D['iso'].T
    lam = np.zeros((5, 2))
    rows, b_avg = pipeline.shell_rows(b, P)
    for precision in ('float64', 'tf32'):
        out = pipeline.solve_voxels(c, D, raw, b, g, lam, False, precision,
                                    P)
        seen = iso.SEEN[-1]
        assert seen['lut'] is None
        assert np.array_equal(seen['bvals'], b_avg)
        assert seen['D']['aniso'].shape == (500, N_SHELLS + 1, 0)
        assert np.array_equal(seen['D']['iso'],
                              pipeline.shell_average(D['iso'], rows, 0))
        assert np.array_equal(seen['D']['htable'], D['htable'])
        q = pipeline.rounder(precision)
        y = raw / raw[:, b == 0].mean(1, keepdims=True)
        assert np.array_equal(seen['y'],
                              q(pipeline.shell_average(y, rows, 1)))
        assert out['maps'].shape == (5, 6)
        assert np.allclose(out['b0'], raw[:, b == 0].mean(1))
    assert not np.array_equal(iso.SEEN[-1]['y'], iso.SEEN[-2]['y'])


def test_least_work_of_one_dictionary_and_a_sample_a_shell(iso):
    """One stage of 10 atoms on 1 + 4 samples: 2 (5 x 10 + 10^2) = 300
    operations a voxel; a fit reads 5 floats and writes 6 maps a voxel,
    and reads the dictionary once (5 x 10)."""
    s = work.shapes(_config())
    assert (s['nS'], s['n_dwi'], s['n_aniso'], s['n_iso']) == (
        N_SHELLS + 1, N_SHELLS, 0, 10)
    flops, nbytes = work.least_work(_config(), n_voxels=7, n_fits=3,
                                    corrected_dwi=False)
    assert flops == 3 * 7 * 300
    assert nbytes == 3 * 4 * (7 * (5 + 6) + 5 * 10)


@pytest.mark.parametrize('settings', [{'doMergeB0': True},
                                      {'doDirectionalAverage': 1},
                                      {'doDirectionalAverage': 'yes'}])
def test_a_setting_the_reference_does_not_mirror_is_refused(settings):
    c = _config()
    c['evaluation'] = settings
    with pytest.raises(ValueError, match='evaluation setting'):
        pipeline.evaluation(c)
    with pytest.raises(ValueError, match='evaluation setting'):
        cells.Cell(c, {'name': 'refit', 'kind': 'refit'}, 1, 'cpu')
    with pytest.raises(ValueError, match='evaluation setting'):
        work.shapes(c)
    c['evaluation'] = [('doDirectionalAverage', True)]
    with pytest.raises(ValueError, match='a dict'):
        pipeline.evaluation(c)


def _fits(monkeypatch) -> list:
    """The maps of every ``Evaluation.fit`` from here on."""
    from amico_tpu_torch.core import Evaluation
    orig, maps = Evaluation.fit, []

    def fit(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        maps.append(np.array(self.RESULTS['MAPs']))
        return out
    monkeypatch.setattr(Evaluation, 'fit', fit)
    return maps


def test_the_harness_runs_sandi_averaged(iso, tmp_path, monkeypatch):
    """The re-fit loop (two lambdas: its two warm-up fits, then the
    window) and the study loop (one sweep of two subjects) run the
    program's SANDI on a direction-averaged subject: six finite maps of
    the mask's shape a fit, ``fit_<map>.nii.gz`` written and no
    ``fit_dir.nii.gz``; the check and the least time take it."""
    c = _config()
    mask = synth.mask(c)
    maps = _fits(monkeypatch)
    refit = {'name': 'refit', 'kind': 'refit', 'lambda_scales': [1.0, 2.0],
             'corrected_dwi': False}
    cell = cells.Cell(c, refit, SEED, 'cpu', str(tmp_path / 'refit'))
    cell.setup()
    assert cell.ev.get_config('doDirectionalAverage') is True
    assert cell.ev.scheme.nS == N_SHELLS + 1
    assert len(maps) == 2
    cell.window(0.5, False)
    assert cell.run.count >= 1 and len(maps) == 2 + cell.run.count
    for m in maps:
        assert m.shape == mask.shape + (6,) and np.all(np.isfinite(m))
    assert np.any(maps[0][mask] != 0)
    cell.release()
    n = len(iso.SEEN)
    numbers = cell.check()
    assert set(numbers) == {'map_median'}
    assert np.isfinite(numbers['map_median'][0])
    assert len(iso.SEEN) == n + 1 and iso.SEEN[-1]['lut'] is None
    # more voxels to check than the mask holds: each is checked
    assert iso.SEEN[-1]['y'].shape == (int(mask.sum()), N_SHELLS + 1)
    t, by = cell.least_time()
    assert t > 0 and by in ('operations', 'bytes')
    cell.cleanup()

    study = {'name': 'study', 'kind': 'study', 'pool_subjects': 2,
             'sweep_subjects': 2, 'warmup_subjects': 1}
    cell = cells.Cell(c, study, SEED + 1, 'cpu', str(tmp_path / 'study'))
    cell.setup()
    del maps[:]
    cell.window(0.1, False)
    assert cell.attempted >= 2 and cell.failed == 0
    assert len(cell.written) == cell.attempted == len(maps)
    for m in maps:
        assert m.shape == mask.shape + (6,) and np.all(np.isfinite(m))
    for out_dir, _ in cell.written:
        files = set(os.listdir(out_dir))
        assert {f'fit_{m}.nii.gz' for m in SANDI_MAPS} <= files
        assert 'fit_dir.nii.gz' not in files
    numbers = cell.check()
    assert np.isfinite(numbers['map_median'][0])
    assert iso.SEEN[-1]['lut'] is None
    cell.cleanup()


class _Stop(Exception):
    """Ends a set-up once ``load_data`` has run."""


def _stop(self, *args, **kwargs):
    raise _Stop


@pytest.fixture
def tiny_configs(tmp_path):
    d = str(tmp_path / 'bench')
    small_bench(d)
    return d


def test_without_the_key_load_data_takes_no_settings(tiny_configs, tmp_path,
                                                     monkeypatch):
    """A configuration without ``evaluation``: the re-fit's facade
    enters and leaves ``load_data`` with the config of a fresh Evaluation
    that loads the same files, and each sweep is given the output
    directory and the device alone."""
    from amico_tpu_torch.core import Evaluation
    from amico_tpu_torch.sweep import SubjectSweep
    monkeypatch.setattr(cells, 'CACHE', str(tmp_path / 'cache'))
    monkeypatch.setenv('AMICO_TPU_HOME', str(tmp_path / 'amico_home'))
    c = registry.config('freewater_human_tiny', tiny_configs)
    assert 'evaluation' not in c
    orig, seen = Evaluation.load_data, []

    def load_data(self, *args, **kwargs):
        before = dict(self.CONFIG)
        orig(self, *args, **kwargs)
        seen.append((before, dict(self.CONFIG)))
    monkeypatch.setattr(Evaluation, 'load_data', load_data)
    cell = cells.Cell(c, registry.traffic('refit', tiny_configs), SEED,
                      'cpu', str(tmp_path / 'refit'))
    assert cell.settings == {}
    cell.inputs()
    monkeypatch.setattr(Evaluation, 'set_model', _stop)
    with pytest.raises(_Stop):
        cell._setup_refit()
    fresh = Evaluation(os.path.join(cell.work, 'pool'), 'p0', device='cpu')
    fresh.load_data('DWI.nii', 'DWI.scheme', mask_filename='mask.nii')
    assert len(seen) == 2 and seen[0] == seen[1]
    assert seen[0][1]['doDirectionalAverage'] is False
    cell.cleanup()

    given = []
    monkeypatch.setattr(SubjectSweep, 'run',
                        lambda self: given.append(self.config) or {})
    cell = cells.Cell(c, registry.traffic('study', tiny_configs), SEED,
                      'cpu', str(tmp_path / 'study'))
    cell.inputs()
    cell._setup_study()
    assert given == [{'OUTPUT_path': os.path.join(cell.work, 'out', 'warm'),
                      'device': 'cpu'}]
    # the atoms' cache path is keyed as before the key existed
    key = cell._atoms().rsplit('.', 1)[1]
    assert key == hashlib.sha256(json.dumps(
        [c[k] for k in ('model', 'model_params', 'lut', 'protocol')],
        sort_keys=True).encode()).hexdigest()[:12]
    cell.cleanup()
