"""A model is a file of its own: ``reference/<reference>.py``, found by
the configuration's ``reference``.

NODDI's and FreeWater's dictionaries, protocols and scheme files are those
the harness made while their atoms were written into
``reference/dictionary.py`` (``fixtures/two_models.npz``: each at
``small_bench``'s size, every 50th LUT direction of ``aniso``).  A stub
model placed on the ``reference`` package's path by the test alone is
taken by the dictionary, the least-work count, the reference's solve and
the dictionary's cache key, and receives each shell's pulse timing from a
timed protocol, whose STEJSKALTANNER scheme the program reads back.  The
seeded subjects of the three configurations are pinned by digest."""
import importlib
import os
import sys

import numpy as np
import pytest
import torch

import reference
from conftest import small_bench
from portbench import cells, registry, synth, work
from reference import dictionary, pipeline

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       'fixtures', 'two_models.npz')

STUB = '''"""A model of the test alone: a stick along +z and a ball."""
import numpy as np

from .dictionary import hr_samples
from .qp import nonneg_lsq

SEEN = []


def atoms(params, shells, grad):
    SEEN.append([dict(s) for s in shells])
    b_hr, cos_t = hr_samples(shells, grad)
    return (np.array([np.exp(-b_hr * params['d'] * cos_t ** 2)]),
            np.array([np.exp(-b_hr * params['d_iso'])]),
            {'G': np.array([s['G'] for s in shells])})


def add_extras(D, bvals):
    D['n_samples'] = np.array(len(bvals))


def work(params, n_samples, n_dwi):
    return {'n_aniso': 1, 'n_iso': 1,
            'stages': [(n_samples, 2), (n_dwi, 1), (n_dwi, 1)]}


def solve(config, D, y, lut, lambdas, want_dwi, q, bvals):
    return {'maps': np.array([
        nonneg_lsq(np.column_stack([D['aniso'][k], D['iso']]), v)
        for k, v in zip(lut, y)])}
'''

TIMED = [[1000.0, 6, {'Delta': 0.03, 'delta': 0.01}],
         [3000.0, 6, {'Delta': 0.035, 'delta': 0.015, 'TE': 0.07}]]


@pytest.fixture(scope='module')
def tiny_configs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('bench'))
    small_bench(d)
    return d


def _as_before(tiny_configs, name):
    """(configuration, its protocol, the fixture's arrays of it)."""
    c = registry.config(name + '_tiny', tiny_configs)
    with np.load(FIXTURE) as z:
        old = {k.split('.', 1)[1]: z[k] for k in z.files
               if k.startswith(name + '.')}
        old['htable'] = z['htable']
    return c, synth.protocol(c), old


@pytest.mark.parametrize('name', ['noddi_ukb', 'freewater_human'])
def test_dictionaries_as_before(tiny_configs, name):
    c, (b, g, P), old = _as_before(tiny_configs, name)
    assert P is None
    assert np.array_equal(b, old.pop('bvals'))
    assert np.array_equal(g, old.pop('bvecs'))
    old.pop('scheme')
    D = dictionary.build(c, b, g)
    assert np.array_equal(D['htable'], old.pop('htable'))
    assert set(D) - {'dirs', 'htable'} == set(old)
    for k, v in old.items():
        new = D[k][::50] if k == 'aniso' else D[k]
        assert new.shape == v.shape, k
        assert np.allclose(new, v, rtol=1e-12, atol=0), k


# SHA-256 of the float32 volume and of the masked voxels' signals of
# ``synth.subject(..., 2 ** 31 + 12345, 1)`` on the CPU at ``small_bench``'s
# size, as the harness made them before a configuration could state facade
# settings (and before a model could have no anisotropic atom)
SUBJECTS = {
    'noddi_ukb': (
        '5f6b81133072bbb8adcae069418d2dac573149fc727ddb58a6bc52014ec86fb6',
        '56f31563e45172a94531c88810d4a7fa55208bdcf09f5f5f35b26a9766538f3d'),
    'freewater_human': (
        'bfe192915e64820045670a5f1aa1cef50ee749bfa9c6fc9bad45667240739ce6',
        '809fae9ad78c4b05c4f067f9ff0848aff22e1b44a20f664fea956725fb472068'),
    'activeax_cdmd': (
        'ca66558f4ad327ffc75c2903b0e9ec9d02406d5ae7281f47c2f7a8f1560b1845',
        'd183825c9e2d7693b102260cc175781e9673388f40ce7584463b611b472a5104')}


@pytest.mark.parametrize('name', sorted(SUBJECTS))
def test_seeded_subjects_as_before(tiny_configs, name):
    import hashlib
    c = registry.config(name + '_tiny', tiny_configs)
    b, g, P = synth.protocol(c)
    D = dictionary.build(c, b, g, P)
    vol, y = synth.subject(c, torch.as_tensor(D['aniso'], dtype=torch.float32),
                           torch.as_tensor(D['iso'], dtype=torch.float32),
                           2 ** 31 + 12345, 1)
    assert (hashlib.sha256(vol.numpy().tobytes()).hexdigest(),
            hashlib.sha256(y.numpy().tobytes()).hexdigest()) == SUBJECTS[name]


@pytest.mark.parametrize('name', ['noddi_ukb', 'freewater_human'])
def test_bvector_schemes_as_before(tiny_configs, tmp_path, name):
    c, (b, g, P), old = _as_before(tiny_configs, name)
    cells.write_subject(str(tmp_path), c, torch.zeros((b.size, 8, 12, 12)),
                        b, g, synth.mask(c), P)
    with open(tmp_path / 'DWI.scheme', 'rb') as f:
        assert f.read() == old['scheme'].tobytes()


def _stub_config(shells=TIMED):
    return {'name': 'stub_tiny', 'reference': 'stub_model', 'maps': ['A'],
            'model_params': {'d': 1.7e-3, 'd_iso': 3e-3},
            'lut': {'ndirs': 500, 'lmax': 12},
            'protocol': {'b0': 2, 'blocks': 2, 'shells': shells,
                         'voxel_mm': 2.0, 'matrix': [4, 4, 2]},
            'mask': {'semi_axes': [2.0, 2.0, 1.0]}}


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """``reference.stub_model``, a file found on the package's path."""
    src = tmp_path / 'models'
    src.mkdir()
    (src / 'stub_model.py').write_text(STUB)
    monkeypatch.setattr(reference, '__path__',
                        list(reference.__path__) + [str(src)])
    importlib.invalidate_caches()
    yield src / 'stub_model.py'
    sys.modules.pop('reference.stub_model', None)
    reference.__dict__.pop('stub_model', None)


def test_a_stub_model_is_one_file(stub, tmp_path, monkeypatch):
    c = _stub_config()
    b, g, P = synth.protocol(c)
    D = dictionary.build(c, b, g, P)
    seen = sys.modules['reference.stub_model'].SEEN
    # each shell's record: b derived back from G, and the timing in SI
    for rec, (b_nom, _, t) in zip(seen[-1], TIMED):
        G = synth.gradient(b_nom, t['Delta'], t['delta'])
        assert rec['G'] == G and rec['Delta'] == t['Delta']
        assert rec['delta'] == t['delta']
        assert rec['TE'] == t.get('TE', t['Delta'] + t['delta'])
        assert rec['b'] == pytest.approx(b_nom, rel=1e-12)
    assert len(seen[-1]) == 2
    assert D['aniso'].shape == (500, 14, 1) and D['iso'].shape == (14, 1)
    assert int(D['n_samples']) == 14
    assert np.array_equal(D['G'], [r['G'] for r in seen[-1]])
    assert np.all(D['aniso'][:, b == 0] == 1)
    # least work: the stub's three stages, 2 (14 x 2 + 4) + 2 x 2 (12 + 1)
    # a voxel; a fit reads the signal (14) and writes one map a voxel, and
    # reads the dictionary (500 x 14 x 2)
    flops, nbytes = work.least_work(c, n_voxels=10, n_fits=2,
                                    corrected_dwi=False)
    assert flops == 2 * 10 * (2 * (14 * 2 + 4) + 2 * 2 * (12 + 1))
    assert nbytes == 2 * 4 * (10 * (14 + 1) + 500 * 14 * 2)
    # the reference's solve is the stub's
    raw = 1000 * np.column_stack([D['aniso'][7], D['iso']]) @ [[0.7], [0.3]]
    out = pipeline.solve_voxels(c, D, np.repeat(raw.T, 3, 0), b, g,
                                np.zeros((3, 2)), False)
    assert out['maps'].shape == (3, 2) and np.allclose(out['b0'], 1000)
    # the cache key holds the model's own module
    monkeypatch.setattr(cells, 'CACHE', str(tmp_path / 'cache'))
    n = len(seen)
    cells.reference_dictionary(c, b, g, P)
    cells.reference_dictionary(c, b, g, P)
    assert len(seen) == n + 1
    stub.write_text(STUB + '# another revision\n')
    cells.reference_dictionary(c, b, g, P)
    assert len(seen) == n + 2
    assert len(os.listdir(tmp_path / 'cache' / 'reference')) == 2


def test_stejskaltanner_scheme_round_trip(tmp_path):
    from amico_tpu_torch.io.scheme import Scheme
    c = _stub_config()
    b, g, P = synth.protocol(c)
    cells.write_subject(str(tmp_path), c, torch.zeros((b.size, 2, 4, 4)),
                        b, g, synth.mask(c), P)
    with open(tmp_path / 'DWI.scheme') as f:
        assert f.readline().strip() == 'VERSION: STEJSKALTANNER'
    s = Scheme(str(tmp_path / 'DWI.scheme'))
    assert s.version == 1 and s.b0_count == 2 and len(s.shells) == 2
    assert np.allclose(s.b, b, rtol=1e-12, atol=0)
    flip = np.where(g[:, 1:2] < 0, -1.0, 1.0)
    assert np.array_equal(s.raw[:, :3], g * flip)
    assert np.array_equal(s.raw[:, 3:], P)
    # shells keyed by b and timing alike on both sides
    ref = dictionary.shells(b, P)
    assert [r['b'] for r, _ in ref] == [sh['b'] for sh in s.shells]
    for (_, rows), sh in zip(ref, s.shells):
        assert np.array_equal(rows, sh['idx'])


def test_protocol_timing_on_every_shell_or_none():
    c = _stub_config([TIMED[0], [3000.0, 6]])
    with pytest.raises(ValueError, match='every shell'):
        synth.protocol(c)
    untimed = _stub_config([[1000.0, 6], [3000.0, 6]])
    b, g, P = synth.protocol(untimed)
    assert P is None
    assert np.array_equal(np.unique(b), [0.0, 1000.0, 3000.0])
    assert [r for r, _ in dictionary.shells(b)] == [
        {'b': x, 'G': None, 'Delta': None, 'delta': None, 'TE': None}
        for x in (1000.0, 3000.0)]
