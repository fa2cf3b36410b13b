"""The port's SANDI, StickZeppelinBall and VolumeFractions
(amico_tpu_torch.models) against the JAX package's, on the same
numpy-seeded inputs: SANDI's fit (against the JAX fit and the exact
native oracle), its facade with doDirectionalAverage, its solver knobs,
RMSE/NRMSE, chunking and caches; the kernel-only models' generate/resample
and their fit's error."""
import os

import numpy as np
import pytest
import torch

import amico_tpu
from amico_tpu.io import nifti as jax_nifti
from amico_tpu.models import SANDI as JaxSANDI
from amico_tpu_torch import AmicoError
from amico_tpu_torch.models import SANDI

torch.set_num_threads(1)

# The JAX bench's SANDI audit (bench.py:538-555, columns 0-3) on this
# protocol, 1,000 of the 2,048 voxels of facade_fits through the JAX
# package's facade (CPU): fractions median 1.21e-5, p95 3.59e-5, max
# 7.73e-5; Rsoma (um) median 1.13e-4, p95 4.30e-4, max 1.77e-3 (the port's
# CPU fit: 1.40e-5, 4.70e-5, 9.75e-5; 1.32e-4, 4.92e-4, 1.33e-3).  The
# bounds, about ten times those readings, are chip_smoke.py's SANDI_AUDIT:
SANDI_AUDIT = {'fractions': (1e-4, 5e-4, 5e-3), 'Rsoma': (1e-3, 5e-3, 5e-2)}
# The port's fit against the JAX package's on the same voxels: the
# directional-average system (rank 3, ridge 5e-3) leaves the maps flat in
# some directions, where the FISTA + CD + rounds solve stops at the
# summation order's whim.  Read on these 150 voxels (CPU): fractions median
# 2.6e-5, p95 9.4e-5, Rsoma (um) median 2.7e-4, p95 1.5e-3, while each fit
# sits a fractions median of ~6e-5 from the exact oracle.  Bounds ((median,
# p95) of fractions, of Rsoma), rounded up from that reading:
SANDI_PORT_JAX = ((1e-4, 5e-4), (1e-3, 5e-3))
SANDI_FILES = ('fit_fsoma', 'fit_fneurite', 'fit_fextra', 'fit_Rsoma',
               'fit_Din', 'fit_De', 'dir_avg_signal')


class Ctx:
    """The slice of Evaluation a model's fit reads."""

    def __init__(self, y, kernels, model=None, **config):
        self.y, self.KERNELS, self.model = y, kernels, model
        self.DIRs = self.htable = None
        self.config = config

    def get_config(self, key):
        return self.config.get(key)


@pytest.fixture(scope='module')
def sandi(tmp_path_factory):
    """The port's SANDI on the bench's VERSION: 1 protocol (b0 + 30 + 30
    directions at b = 3000, 6000), its KERNELS and 150 voxels."""
    d = tmp_path_factory.mktemp('sandi')
    os.environ['AMICO_TPU_HOME'] = str(d / 'home')
    from amico_tpu_torch.testing import demo_sandi, sandi_voxels
    model, kernels, _ = demo_sandi(kernels_dir=str(d / 'k'))
    y, _ = sandi_voxels(150, kernels, seed=4)
    return model, kernels, y


def oracle_estimates(model, kernels, y):
    from amico_tpu_torch.testing import sandi_oracle_maps
    return np.stack([sandi_oracle_maps(model, kernels, yi) for yi in y])


def jax_sandi(**solver_kw):
    m = JaxSANDI()
    m.set_solver(**solver_kw)
    return m


def test_sandi_fit_matches_jax_and_the_oracle(sandi):
    """tests/test_models.py::test_sandi_fit_parity's recipe: the port's fit
    on the CPU against the JAX package's fit of the same voxels (one f32
    stagewise solve each, another summation order) and against the exact
    oracle at that test's bounds (fractions median < 5e-3, Rsoma median
    < 0.3 um)."""
    model, kernels, y = sandi
    est = model.fit(Ctx(y, kernels, device='cpu'))['estimates']
    ref = np.asarray(jax_sandi().fit(Ctx(y, kernels))['estimates'])
    assert est.shape == ref.shape == (150, 6)
    d = np.abs(est - ref)
    for cols, bound in ((slice(0, 3), SANDI_PORT_JAX[0]),
                        (slice(3, 4), SANDI_PORT_JAX[1])):
        got = (np.median(d[:, cols]), np.percentile(d[:, cols], 95))
        assert all(g < b for g, b in zip(got, bound)), (cols, got)
    err = np.abs(est - oracle_estimates(model, kernels, y))
    assert np.median(err[:, :3]) < 5e-3 and np.median(err[:, 3]) < 0.3
    assert ((est[:, :3] >= 0) & (est[:, :3] <= 1 + 1e-6)).all()


def test_sandi_rmse_nrmse_through_the_shared_helper(sandi):
    """RMSE/NRMSE go through _fitops.error_maps on the shared dictionary
    lifted to one tile, as in the JAX package."""
    model, kernels, y = sandi
    cfg = dict(doComputeRMSE=True, doComputeNRMSE=True)
    res = model.fit(Ctx(y, kernels, device='cpu', **cfg))
    ref = jax_sandi().fit(Ctx(y, kernels, **cfg))
    for key in ('rmse', 'nrmse'):
        assert res[key].shape == (150,)
        # x differs at test_sandi_fit_matches_jax_and_the_oracle's level:
        # 2 of 150 voxels read 3.4e-4 relative here (CPU)
        np.testing.assert_allclose(res[key], np.asarray(ref[key]),
                                   rtol=2e-3, atol=1e-6)


def test_sandi_solver_kwargs_accepts_cg_tuple():
    """tests/test_solver_review.py:83: a per-round CG tuple and an int,
    as the JAX package takes them."""
    for cg in ((4, 8, 12), 24):
        m, j = SANDI(), JaxSANDI()
        m.set_solver(cg_iters=cg)
        j.set_solver(cg_iters=cg)
        assert m._solver_kwargs() == j._solver_kwargs()
        assert m._solver_kwargs()['cg_iters'] == cg
    assert SANDI()._solver_kwargs() == JaxSANDI()._solver_kwargs()


def test_sandi_chunks_caches_and_timers(sandi):
    """At most 4 equal chunks rounded up to 4,096 voxels (a lone chunk
    padded), every chunk dispatched before any pull; the device constants
    and the staged signal are reused on a second fit of the same arrays;
    an explicit voxels_per_chunk splits as asked and gives the same maps;
    any backend but 'auto'/'xla' is ignored with a warning."""
    from amico_tpu_torch.models.sandi import sandi_chunk
    assert sandi_chunk(409_600, 'auto') == 102_400
    assert sandi_chunk(1000, None) == 4096
    assert sandi_chunk(60_000, 'auto') == 32_768
    assert sandi_chunk(60_000, 1000) == 1000
    model, kernels, y = sandi
    ctx = Ctx(y, kernels, device='cpu')
    first = model.fit(ctx)['estimates']
    consts, staged = model._prep.value, model._staged.value
    second = model.fit(ctx)['estimates']
    assert model._prep.value is consts and model._staged.value is staged
    assert np.array_equal(first, second)
    assert set(model._last_fit_timers) == {'n_chunks', 'dispatch_s',
                                           'device_s', 'pull_s'}
    assert model._last_fit_timers['n_chunks'] == 1
    split = model.fit(Ctx(y, kernels, device='cpu', voxels_per_chunk=40))
    assert model._last_fit_timers['n_chunks'] == 4
    assert np.allclose(split['estimates'], first, atol=1e-5)
    m = SANDI()
    m.set_solver(backend='pallas')
    assert np.array_equal(m.fit(Ctx(y, kernels, device='cpu'))['estimates'],
                          first)


def write_subject(subject_dir, scheme, y):
    from amico_tpu_torch.testing import write_demo_subject
    write_demo_subject(subject_dir, scheme, y, (16, 16, 8))


@pytest.fixture(scope='module')
def facade_fits(tmp_path_factory):
    """2,048 voxels of the bench protocol written as a NIfTI (S0 = 1000),
    through each package's facade with doDirectionalAverage: load_data ->
    set_model('SANDI') -> generate_kernels -> load_kernels -> fit ->
    save_results(save_dir_avg=True)."""
    import amico_tpu_torch
    from amico_tpu_torch.testing import czb_scheme, demo_sandi, sandi_voxels
    d = tmp_path_factory.mktemp('sandi_facade')
    os.environ['AMICO_TPU_HOME'] = str(d / 'home')
    _, kernels, _ = demo_sandi(kernels_dir=str(d / 'k'))
    y, _ = sandi_voxels(2048, kernels, seed=7)
    fits = {}
    for name, pkg in (('port', amico_tpu_torch), ('jax', amico_tpu)):
        study = d / name
        write_subject(str(study / 'subj'), czb_scheme(), y)
        pkg.set_verbose(1)
        kw = {'device': 'cpu'} if name == 'port' else {}
        ev = pkg.Evaluation(str(study), 'subj', **kw)
        ev.set_config('doDirectionalAverage', True)
        ev.load_data(dwi_filename='DWI.nii', scheme_filename='DWI.scheme')
        ev.set_model('SANDI')
        ev.generate_kernels(ndirs=500)
        ev.load_kernels()
        ev.fit()
        ev.save_results(save_dir_avg=True)
        fits[name] = ev
    return fits


def test_sandi_facade_directional_average(facade_fits):
    """After tests/test_pipeline.py:142: the port's facade writes the same
    files as the JAX package's, and its maps match the JAX package's."""
    out = {name: os.path.join(ev.get_config('DATA_path'), 'AMICO', 'SANDI')
           for name, ev in facade_fits.items()}
    assert sorted(os.listdir(out['port'])) == sorted(os.listdir(out['jax']))
    for f in SANDI_FILES:
        assert os.path.isfile(os.path.join(out['port'], f + '.nii.gz')), f
    assert os.path.isfile(os.path.join(out['port'], 'dir_avg.scheme'))
    port, ref = facade_fits['port'], facade_fits['jax']
    assert port.scheme.nS == ref.scheme.nS == 3
    mask = port.niiMASK_img == 1
    maps_p, maps_j = port.RESULTS['MAPs'][mask], ref.RESULTS['MAPs'][mask]
    assert maps_p.shape == (2048, 6)
    d = np.abs(maps_p - maps_j)
    assert np.median(d[:, :3]) < 5e-3 and np.median(d[:, 3]) < 0.3
    fsoma = jax_nifti.load(os.path.join(out['port'], 'fit_fsoma.nii.gz'))
    fsoma = fsoma.get_fdata()
    assert (fsoma >= 0).all() and (fsoma <= 1 + 1e-6).all()


@pytest.mark.parametrize('name', ['port', 'jax'])
def test_sandi_oracle_audit_within_bounds(facade_fits, name):
    """testing.sandi_oracle_audit on 1,000 voxels of each facade fit, at
    the bounds chip_smoke.py holds the card's fit to (SANDI_AUDIT): the
    JAX package's reading is where they come from."""
    from amico_tpu_torch.testing import sandi_oracle_audit
    err = sandi_oracle_audit(facade_fits[name], n=1000, seed=0)
    for cols, key in ((slice(0, 3), 'fractions'), (slice(3, 4), 'Rsoma')):
        e = err[:, cols]
        got = (np.median(e), np.percentile(e, 95), e.max())
        assert all(g < b for g, b in zip(got, SANDI_AUDIT[key])), (key, got)


# -------------------------------------- StickZeppelinBall, VolumeFractions
def _v0_scheme():
    from amico_tpu_torch.ops.sphere import fibonacci_hemisphere
    g = fibonacci_hemisphere(20)
    return np.vstack([np.zeros((1, 4)), np.c_[g, np.full(20, 1000.0)]])


@pytest.mark.parametrize('name', ['StickZeppelinBall', 'VolumeFractions'])
def test_kernel_only_models_match_jax(tmp_path, name):
    """After tests/test_pipeline_v1.py:75: generate and resample give the
    JAX package's KERNELS on the same scheme, and fit (and set_solver)
    raise its error."""
    from importlib import import_module

    import amico_tpu_torch
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    out = {}
    for pkg in (amico_tpu, amico_tpu_torch):
        lut = import_module(f'{pkg.__name__}.lut')
        model = getattr(import_module(f'{pkg.__name__}.models'), name)()
        model.scheme = pkg.Scheme(_v0_scheme())
        d = tmp_path / pkg.__name__
        d.mkdir()
        model.generate(str(d), lut.load_precomputed_rotation_matrices(12, 500),
                       *lut.aux_structures_generate(model.scheme, 12), 500)
        out[pkg.__name__] = model.resample(
            str(d), *lut.aux_structures_resample(model.scheme, 12), False,
            500)
        assert model.get_params()['id'] == name
    port, ref = out['amico_tpu_torch'], out['amico_tpu']
    assert sorted(port) == sorted(ref)
    for k in ref:
        if k == 'model':
            assert port[k] == ref[k] == name
        else:
            assert port[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(port[k], ref[k])
    cls = getattr(import_module('amico_tpu_torch.models'), name)
    for call in (lambda m: m.fit(None), lambda m: m.set_solver()):
        with pytest.raises(AmicoError, match='Not implemented'):
            call(cls())
