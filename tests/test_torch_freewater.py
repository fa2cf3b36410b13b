"""The port's FreeWater model (amico_tpu_torch.models.FreeWater) against the
JAX package's: the LUT (generate, resample), the device constants, the fit
(maps, RMSE, NRMSE, corrected DWI) against the JAX fit on its Pallas kernel
(interpret mode, same tile size), and the facade's DWI_corrected.nii.gz
against amico_tpu.Evaluation's.

The fits are compared by distribution, at bounds set from the JAX package
against itself: its XLA path against its Pallas kernel on 2,048 voxels of
this protocol (``freewater_voxels``, seed 7; CPU) read
  Human  maps median 1.8e-5, p95 2.1e-4, max 1.3e-3; DWI max 1.3e-3
  Mouse  maps median 9.0e-5, p95 1.3e-3, max 5.1e-3; DWI max 3.9e-3
and the port's twin against the Pallas kernel on the same voxels
  Human  maps median 4.6e-6, p95 5.1e-5, max 7.5e-4
  Mouse  maps median 2.0e-5, p95 6.8e-4, max 5.0e-3.
FreeWater's adjacent zeppelins are near-collinear: a change of summation
order (the Grams, A'y, the solver's) moves x between them at no cost in
the objective, and the maps move with it."""
import os

import numpy as np
import pytest
import torch

from amico_tpu import lut as _lut
from amico_tpu.models import FreeWater as JaxFreeWater
from amico_tpu_torch.models import FreeWater
from amico_tpu_torch.models.base import DEFAULT_AS_SOLVER_KW

torch.set_num_threads(1)

PROTOCOL = dict(nb0=9, shells=(700.0, 2000.0), ndir=(30, 60))
# (median, p95, max) of |port - JAX| per output, from the readings above
BOUNDS = {'Human': (5e-5, 1e-3, 5e-3), 'Mouse': (2e-4, 3e-3, 1e-2)}


class Ctx:
    """The slice of Evaluation a model's fit reads."""

    def __init__(self, y, DIRs, htable, kernels, **config):
        self.y, self.DIRs, self.htable, self.KERNELS = y, DIRs, htable, kernels
        self.config = config

    def get_config(self, key):
        return self.config.get(key)


@pytest.fixture(scope='module')
def problem(tmp_path_factory):
    d = tmp_path_factory.mktemp('freewater_torch')
    os.environ['AMICO_TPU_HOME'] = str(d / 'home')
    from amico_tpu_torch.testing import demo_freewater, demo_scheme
    scheme = demo_scheme(**PROTOCOL)
    return scheme, {t: demo_freewater(scheme, t, str(d / t))
                    for t in ('Human', 'Mouse')}


def assert_close_dist(got, ref, bounds, what):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    med, p95, mx = bounds
    assert np.median(err) < med, (what, np.median(err))
    assert np.percentile(err, 95) < p95, (what, np.percentile(err, 95))
    assert err.max() < mx, (what, err.max())


@pytest.mark.parametrize('type,merge_b0', [('Human', False), ('Mouse', True)])
def test_lut_matches_jax(problem, tmp_path, type, merge_b0):
    """generate writes the JAX package's atoms and resample returns its
    KERNELS, with and without doMergeB0."""
    scheme = problem[0]
    aux = _lut.load_precomputed_rotation_matrices(12, 500)
    idx_in, idx_out = _lut.aux_structures_generate(scheme, 12)
    ridx, Ylm = _lut.aux_structures_resample(scheme, 12)
    got = {}
    for name, cls in (('port', FreeWater), ('jax', JaxFreeWater)):
        model = cls()
        model.set(type=type)
        model.scheme = scheme
        out = tmp_path / name
        out.mkdir()
        model.generate(str(out), aux, idx_in, idx_out, 500)
        got[name] = (model.resample(str(out), ridx, Ylm, merge_b0, 500),
                     {f: np.load(out / f) for f in sorted(os.listdir(out))})
    (k_port, atoms_port), (k_jax, atoms_jax) = got['port'], got['jax']
    assert atoms_port.keys() == atoms_jax.keys()
    for f in atoms_port:
        np.testing.assert_array_equal(atoms_port[f], atoms_jax[f])
    assert k_port.keys() == k_jax.keys() == {'model', 'D', 'CSF'}
    n_iso = 2 if type == 'Mouse' else 1
    nS = 1 + scheme.dwi_count if merge_b0 else scheme.nS
    assert k_port['D'].shape == (10, 500, nS)
    assert k_port['CSF'].shape == (n_iso, nS)
    for key in ('D', 'CSF'):
        np.testing.assert_array_equal(k_port[key], k_jax[key])


def test_prepare_from_jax_kernels(problem):
    """prepare takes the JAX package's KERNELS as they are (NumPy): A_all
    (ndirs, nS, n), zeppelins then balls, and its Grams, in float32."""
    _, models = problem
    kernels = models['Mouse'][1]
    model = FreeWater()
    model.set(type='Mouse')
    c = model.prepare(kernels, 'cpu')
    A = np.concatenate([np.transpose(kernels['D'], (1, 2, 0)),
                        np.broadcast_to(kernels['CSF'].T[None],
                                        (500,) + kernels['CSF'].T.shape)], -1)
    assert c['A_all'].dtype == c['G_all'].dtype == torch.float32
    np.testing.assert_array_equal(c['A_all'].numpy(), A)
    A64 = A.astype(np.float64)
    np.testing.assert_allclose(c['G_all'].numpy(),
                               np.einsum('dsi,dsj->dij', A64, A64),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('type', ['Human', 'Mouse'])
def test_fit_matches_jax_pallas(problem, type):
    """Maps, RMSE, NRMSE and the corrected DWI against the JAX FreeWater
    fit on its Pallas kernel, from the same KERNELS, voxels and tile size."""
    from amico_tpu_torch.testing import freewater_voxels
    scheme, models = problem
    model, kernels, htable = models[type]
    y, DIRs, _, _ = freewater_voxels(512, kernels, htable, seed=7)
    cfg = dict(tile_size=32, voxels_per_chunk=4096, doComputeRMSE=True,
               doComputeNRMSE=True, doSaveCorrectedDWI=True)
    res = model.fit(Ctx(y, DIRs, htable, kernels, device='cpu', **cfg))
    jax_model = JaxFreeWater()
    jax_model.set(type=type)
    jax_model.set_solver(backend='pallas')
    jax_model.scheme = scheme
    ref = jax_model.fit(Ctx(y, DIRs, htable, kernels, **cfg))
    n_maps = 4 if type == 'Mouse' else 2
    assert res['estimates'].shape == (512, n_maps)
    assert res['y_corrected'].shape == y.shape
    for key in ('estimates', 'rmse', 'nrmse', 'y_corrected'):
        assert_close_dist(res[key], ref[key], BOUNDS[type], key)
    est = res['estimates']
    assert ((est >= 0) & (est <= 1)).all()
    np.testing.assert_allclose(est[:, 0] + est[:, 1], 1.0, atol=1e-6)
    assert (res['y_corrected'] >= 0).all()


def test_solver_kwargs_and_backends(problem):
    """The default schedule is DEFAULT_AS_SOLVER_KW; any iteration knob
    gives the uniform schedule, as in the JAX package; 'auto' resolves to
    the tile QP, and backend 'xla' runs the stagewise solver, whose fit of
    a few voxels equals a direct ``nneg_qp_batch`` solve of them."""
    from amico_tpu_torch.ops.solvers import nneg_qp_batch
    from amico_tpu_torch.testing import freewater_voxels
    scheme, models = problem
    _, kernels, htable = models['Human']
    model = FreeWater()
    model.set_solver()
    assert model._solver_kwargs() == DEFAULT_AS_SOLVER_KW
    assert model._solver_backend() == 'pallas'
    jax_model = JaxFreeWater()
    for kw in ({}, dict(fista_iters=20, cg_iters=(4, 8))):
        model.set_solver(**kw)
        jax_model.set_solver(**kw)
        assert model._solver_kwargs() == jax_model._solver_kwargs()
    model.set_solver(backend='xla')
    assert model._solver_backend() == 'xla'
    model.scheme = scheme
    y, DIRs, lut_idx, _ = freewater_voxels(4, kernels, htable, seed=2)
    res = model.fit(Ctx(y, DIRs, htable, kernels, device='cpu'))
    A = model.prepare(kernels, 'cpu')['A_all'][torch.from_numpy(
        lut_idx.astype(np.int64))]
    b = (torch.from_numpy(y.astype(np.float32))[:, None] @ A)[:, 0]
    x = nneg_qp_batch(A.transpose(1, 2) @ A, b, 0.0, 1e-3,
                      **DEFAULT_AS_SOLVER_KW)
    v = (x[:, :-1].sum(-1) / (x.sum(-1) + 1e-16)).numpy()
    # the fit's tiles sum in another order: FreeWater's near-collinear
    # zeppelins move its map by up to 2e-5 on these voxels (CPU)
    np.testing.assert_allclose(res['estimates'][:, 0], v, atol=1e-4)


@pytest.mark.parametrize('type', ['Human', 'Mouse'])
def test_fit_xla_matches_jax_xla(problem, type):
    """backend='xla': maps, RMSE, NRMSE and the corrected DWI against the
    JAX FreeWater fit on its stagewise path, from the same KERNELS, voxels
    and tile size (bounds as for the Pallas comparison)."""
    from amico_tpu_torch.testing import freewater_voxels
    scheme, models = problem
    model, kernels, htable = models[type]
    y, DIRs, _, _ = freewater_voxels(512, kernels, htable, seed=7)
    cfg = dict(tile_size=32, voxels_per_chunk=4096, doComputeRMSE=True,
               doComputeNRMSE=True, doSaveCorrectedDWI=True)
    model.set_solver(backend='xla')
    try:
        res = model.fit(Ctx(y, DIRs, htable, kernels, device='cpu', **cfg))
    finally:
        model.set_solver()
    jax_model = JaxFreeWater()
    jax_model.set(type=type)
    jax_model.set_solver(backend='xla')
    jax_model.scheme = scheme
    ref = jax_model.fit(Ctx(y, DIRs, htable, kernels, **cfg))
    for key in ('estimates', 'rmse', 'nrmse', 'y_corrected'):
        assert_close_dist(res[key], ref[key], BOUNDS[type], key)
    est = res['estimates']
    assert ((est >= 0) & (est <= 1)).all()


def run_facade(pkg, study, merge_b0):
    """FreeWater through a facade with doSaveCorrectedDWI; returns the
    written maps and corrected DWI."""
    from amico_tpu.io import nifti
    kw = {'device': 'cpu'} if pkg.__name__ == 'amico_tpu_torch' else {}
    ev = pkg.Evaluation(study, 'subj', **kw)
    ev.set_config('doSaveCorrectedDWI', True)
    ev.set_config('doMergeB0', merge_b0)
    ev.load_data(dwi_filename='DWI.nii', scheme_filename='DWI.scheme')
    ev.set_model('FreeWater')
    if not kw:
        ev.set_solver(backend='pallas')
    ev.generate_kernels(ndirs=500)
    ev.load_kernels()
    ev.fit()
    ev.save_results(path_suffix=pkg.__name__)
    out = os.path.join(study, 'subj', 'AMICO', f'FreeWater_{pkg.__name__}')
    return {name: nifti.load(os.path.join(out, name + '.nii.gz'))
            .get_fdata().astype(np.float32)
            for name in ('fit_FiberVolume', 'fit_FW', 'fit_dir',
                         'DWI_corrected')}


@pytest.mark.parametrize('merge_b0', [False, True])
def test_facade_writes_corrected_dwi(problem, tmp_path, merge_b0):
    """The port's facade on the CPU writes the maps and DWI_corrected.nii.gz
    of amico_tpu.Evaluation (on its Pallas kernel): the corrected DWI has
    the fitted signal's columns (one merged b0 with doMergeB0), the b0
    normalisation undone."""
    import amico_tpu
    import amico_tpu_torch
    from amico_tpu_torch.testing import freewater_voxels, write_demo_subject
    scheme, models = problem
    _, kernels, htable = models['Human']
    y, _, _, _ = freewater_voxels(300, kernels, htable, seed=11)
    study = str(tmp_path / 'study')
    write_demo_subject(os.path.join(study, 'subj'), scheme, y, (10, 6, 5))
    got = run_facade(amico_tpu_torch, study, merge_b0)
    ref = run_facade(amico_tpu, study, merge_b0)
    nS = 1 + scheme.dwi_count if merge_b0 else scheme.nS
    assert got['DWI_corrected'].shape == (10, 6, 5, nS)
    np.testing.assert_allclose(got['fit_dir'], ref['fit_dir'], atol=1e-5)
    for name in ('fit_FiberVolume', 'fit_FW'):
        assert_close_dist(got[name], ref[name], BOUNDS['Human'], name)
    # the corrected DWI is in the scanner's units (S0 = 1000)
    assert_close_dist(got['DWI_corrected'] / 1000.0,
                      ref['DWI_corrected'] / 1000.0, BOUNDS['Human'],
                      'DWI_corrected')
    assert (got['DWI_corrected'] >= 0).all()
