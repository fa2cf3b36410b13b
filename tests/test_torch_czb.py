"""The port's CylinderZeppelinBall (ACTIVEAX) model against the JAX
package's: the LUT (generate, resample), the device constants, the fit on
both backends ('auto', which resolves to the stagewise solver, and 'pallas',
K2's twin here against the JAX Pallas kernel in interpret mode), the full
21-radius grid against the exact oracle, and the facade on a VERSION: 1
scheme.

Bounds on |port - JAX| of the maps v (volume fraction), a (diameter, um)
and d, and of RMSE/NRMSE, from the JAX package against itself: its XLA
path against its Pallas kernel on 4,096 voxels of this protocol
(``czb_voxels``, seed 7, full grid, tile 128; CPU) read
  v median 3.6e-7, p95 1.1e-6, max 2.4e-6
  a median 5.7e-6, p95 1.7e-5, max 4.7e-5
and the port against it on the same voxels: 'auto' v max 2.3e-6, a max
3.8e-5; 'pallas' v max 1.6e-6, a max 2.2e-5.  The lambda2 = 4 ridge makes
the QP strongly convex, so both solvers land on one vertex."""
import os

import numpy as np
import pytest
import torch

import amico_tpu
from amico_tpu import lut as _lut
from amico_tpu.models import CylinderZeppelinBall as JaxCZB
from amico_tpu.ops import native
from amico_tpu_torch.models import NODDI, CylinderZeppelinBall, FreeWater
from amico_tpu_torch.models.base import DENSE_AS_SOLVER_KW

torch.set_num_threads(1)

REDUCED_RS = np.concatenate(([0.01], np.linspace(0.5, 8.0, 6))) * 1e-6
# (median, p95, max) of |port - JAX|: v and d, a (um), RMSE/NRMSE
BOUNDS = {'v': (1e-5, 5e-5, 5e-4), 'a': (1e-4, 5e-4, 5e-3),
          'err': (1e-5, 5e-5, 5e-4)}


class Ctx:
    """The slice of Evaluation a model's fit reads."""

    def __init__(self, y, DIRs, htable, kernels, **config):
        self.y, self.DIRs, self.htable, self.KERNELS = y, DIRs, htable, kernels
        self.config = config

    def get_config(self, key):
        return self.config.get(key)


@pytest.fixture(scope='module')
def problem(tmp_path_factory):
    d = tmp_path_factory.mktemp('czb_torch')
    os.environ['AMICO_TPU_HOME'] = str(d / 'home')
    from amico_tpu_torch.testing import czb_scheme, demo_czb
    scheme = czb_scheme()
    return scheme, {'reduced': demo_czb(scheme, str(d / 'reduced'),
                                        Rs=REDUCED_RS),
                    'full': demo_czb(scheme, str(d / 'full'))}


def assert_close_dist(got, ref, bounds, what):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    med, p95, mx = bounds
    assert np.median(err) < med, (what, np.median(err))
    assert np.percentile(err, 95) < p95, (what, np.percentile(err, 95))
    assert err.max() < mx, (what, err.max())


def test_scheme_is_the_bench_protocol(problem):
    """1 b0 + 30 @ b = 3000 + 30 @ b = 6000, Delta 35 ms, delta 15 ms."""
    scheme = problem[0]
    assert scheme.version == 1 and scheme.nS == 61
    assert scheme.b0_count == 1 and scheme.dwi_count == 60
    np.testing.assert_allclose(sorted({round(s['b']) for s in scheme.shells}),
                               [3000, 6000])
    assert {(s['Delta'], s['delta']) for s in scheme.shells} == {(0.035,
                                                                  0.015)}


@pytest.mark.parametrize('merge_b0', [False, True])
def test_lut_matches_jax(problem, tmp_path, merge_b0):
    """generate writes the JAX package's atoms and resample returns its
    KERNELS (wmr, wmh, iso), with and without doMergeB0."""
    scheme = problem[0]
    aux = _lut.load_precomputed_rotation_matrices(12, 500)
    idx_in, idx_out = _lut.aux_structures_generate(scheme, 12)
    ridx, Ylm = _lut.aux_structures_resample(scheme, 12)
    got = {}
    for name, cls in (('port', CylinderZeppelinBall), ('jax', JaxCZB)):
        model = cls()
        model.set(Rs=REDUCED_RS)
        model.scheme = scheme
        out = tmp_path / name
        out.mkdir()
        model.generate(str(out), aux, idx_in, idx_out, 500)
        got[name] = (model.resample(str(out), ridx, Ylm, merge_b0, 500),
                     {f: np.load(out / f) for f in sorted(os.listdir(out))})
    (k_port, atoms_port), (k_jax, atoms_jax) = got['port'], got['jax']
    assert atoms_port.keys() == atoms_jax.keys() and len(atoms_port) == 12
    for f in atoms_port:
        np.testing.assert_array_equal(atoms_port[f], atoms_jax[f])
    assert k_port.keys() == k_jax.keys() == {'model', 'wmr', 'wmh', 'iso'}
    nS = 1 + scheme.dwi_count if merge_b0 else scheme.nS
    assert k_port['wmr'].shape == (7, 500, nS)
    assert k_port['wmh'].shape == (4, 500, nS)
    assert k_port['iso'].shape == (1, nS)
    for key in ('wmr', 'wmh', 'iso'):
        np.testing.assert_array_equal(k_port[key], k_jax[key])


def test_generate_needs_a_stejskaltanner_scheme(tmp_path):
    from amico_tpu_torch import AmicoError
    from amico_tpu_torch.testing import demo_scheme
    model = CylinderZeppelinBall()
    model.scheme = demo_scheme()
    with pytest.raises(AmicoError, match='STEJSKALTANNER'):
        model.generate(str(tmp_path), {}, None, None, 500)


def test_prepare_from_jax_kernels(problem):
    """prepare takes the JAX package's KERNELS as they are (NumPy): A_all
    (ndirs, nS, 26), cylinders, zeppelins, ball; its Grams and their
    largest eigenvalues, in float32."""
    from amico_tpu_torch.models.cylinder_zeppelin_ball import czb_dictionary
    _, kernels, _ = problem[1]['full']
    c = CylinderZeppelinBall().prepare(kernels, 'cpu')
    A = czb_dictionary(kernels)
    assert A.shape == (500, 61, 26)
    assert c['A_all'].dtype == c['G_all'].dtype == c['L_all'].dtype \
        == torch.float32
    np.testing.assert_array_equal(c['A_all'].numpy(), A)
    A64 = A.astype(np.float64)
    G = np.einsum('dsi,dsj->dij', A64, A64)
    np.testing.assert_allclose(c['G_all'].numpy(), G, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c['L_all'].numpy(),
                               np.linalg.eigvalsh(G).max(-1), rtol=1e-4)


def test_estimates_are_the_jax_formulas():
    """v, a, d from random coefficients as the JAX fit computes them."""
    from amico_tpu_torch.models.cylinder_zeppelin_ball import czb_estimates
    model = CylinderZeppelinBall()
    x = np.random.RandomState(0).rand(5, 26) \
        * (np.random.RandomState(1).rand(5, 26) < 0.5)
    got = czb_estimates(torch.from_numpy(x), torch.from_numpy(model.Rs),
                        len(model.d_perps)).numpy()
    f1 = x[:, :21].sum(1)
    f2 = x[:, 21:25].sum(1) + 1e-16
    v = f1 / (f1 + f2 + 1e-16)
    a = 1e6 * 2.0 * (model.Rs * x[:, :21]).sum(1) / (f1 + 1e-16)
    np.testing.assert_allclose(got, np.stack(
        [v, a, 4.0 * v / (np.pi * a ** 2 + 1e-16)], 1), rtol=1e-12)


def jax_fit(scheme, kernels, y, DIRs, htable, backend, Rs=None, **cfg):
    model = JaxCZB()
    if Rs is not None:
        model.set(Rs=Rs)
    model.set_solver(backend=backend)
    model.scheme = scheme
    return model.fit(Ctx(y, DIRs, htable, kernels, **cfg))


@pytest.mark.parametrize('backend', ['auto', 'pallas'])
def test_fit_matches_jax(problem, backend):
    """Maps, RMSE and NRMSE on the reduced grid against the JAX fit on the
    same backend ('auto': the stagewise solver in both packages; 'pallas':
    K2's twin against the JAX kernel in interpret mode), from the same
    KERNELS, voxels and tile size."""
    from amico_tpu_torch.testing import czb_voxels
    scheme, models = problem
    model, kernels, htable = models['reduced']
    model.set_solver(backend=backend)
    y, DIRs, _, _ = czb_voxels(384, kernels, htable, seed=7)
    cfg = dict(tile_size=32, voxels_per_chunk=4096, doComputeRMSE=True,
               doComputeNRMSE=True)
    res = model.fit(Ctx(y, DIRs, htable, kernels, device='cpu', **cfg))
    ref = jax_fit(scheme, kernels, y, DIRs, htable,
                  'xla' if backend == 'auto' else backend, Rs=REDUCED_RS,
                  **cfg)
    est, ref_est = res['estimates'], np.asarray(ref['estimates'])
    assert est.shape == (384, 3)
    for col, key in ((0, 'v'), (1, 'a'), (2, 'v')):
        assert_close_dist(est[:, col], ref_est[:, col], BOUNDS[key],
                          f'map {col}')
    for key in ('rmse', 'nrmse'):
        assert_close_dist(res[key], ref[key], BOUNDS['err'], key)
    assert ((est[:, 0] >= 0) & (est[:, 0] <= 1)).all()
    assert ((est[:, 1] >= 0) & (est[:, 1] < 20)).all()


def test_full_grid_oracle_parity(problem):
    """tests/test_solver_review.py::test_czb_full_grid_oracle_parity through
    the port, at its bounds (v median < 2e-3, p95 < 2e-2; a median <
    2e-2), and against the JAX fit on the same voxels."""
    from tests.test_models import EvalStub, _rand_voxels
    scheme, models = problem
    model, kernels, htable = models['full']
    model.set_solver()
    n_rs, n_perp = len(model.Rs), len(model.d_perps)

    def A_of(d):
        return np.column_stack([kernels['wmr'][:, d, :].T,
                                kernels['wmh'][:, d, :].T, kernels['iso'].T])

    y, DIRs, lut_idx = _rand_voxels(80, A_of, htable, seed=4)
    est = model.fit(EvalStub(y, DIRs, htable, kernels,
                             device='cpu'))['estimates']
    ref = np.zeros((80, 3))
    supports = []
    for i in range(80):
        x = native.lasso(A_of(lut_idx[i]), y[i], 0.0, 4.0)
        supports.append(int((x > 1e-9).sum()))
        f1 = x[:n_rs].sum()
        f2 = x[n_rs:n_rs + n_perp].sum() + 1e-16
        v = f1 / (f1 + f2 + 1e-16)
        a = 1e6 * 2 * np.sum(model.Rs * x[:n_rs]) / (f1 + 1e-16)
        ref[i] = [v, a, 4 * v / (np.pi * a ** 2 + 1e-16)]
    assert max(supports) > 12
    err = np.abs(est - ref)
    assert np.median(err[:, 0]) < 2e-3
    assert np.percentile(err[:, 0], 95) < 2e-2
    assert np.median(err[:, 1]) < 2e-2
    jax_model = JaxCZB()
    jax_model.set_solver()
    jax_model.scheme = scheme
    jax_est = np.asarray(jax_model.fit(EvalStub(y, DIRs, htable,
                                                kernels))['estimates'])
    assert_close_dist(est[:, 0], jax_est[:, 0], BOUNDS['v'], 'v')
    assert_close_dist(est[:, 1], jax_est[:, 1], BOUNDS['a'], 'a')


def test_solver_kwargs_and_backend_resolution():
    """DENSE_AS_SOLVER_KW unless an iteration knob is set (then the uniform
    schedule, as in the JAX package); 'auto' resolves to the stagewise
    solver for CylinderZeppelinBall and to the tile kernels for NODDI and
    FreeWater, on either device."""
    model, jax_model = CylinderZeppelinBall(), JaxCZB()
    for kw in ({}, dict(fista_iters=20, cg_iters=(4, 8)), dict(lambda2=1.0)):
        model.set_solver(**kw)
        jax_model.set_solver(**kw)
        assert model._solver_kwargs() == jax_model._solver_kwargs()
        assert model.solver_params == jax_model.solver_params
    model.set_solver()
    assert model._solver_kwargs() == DENSE_AS_SOLVER_KW
    assert model.solver_params['lambda1'] == 0.0
    assert model.solver_params['lambda2'] == 4.0
    assert model._solver_backend() == 'xla'
    for other in (NODDI(), FreeWater()):
        other.set_solver()
        assert other._solver_backend() == 'pallas'
    for backend in ('xla', 'pallas'):
        model.set_solver(backend=backend)
        assert model._solver_backend() == backend
    model.set_solver(backend='tpu')
    with pytest.raises(ValueError, match='backend'):
        model._solver_backend()


def run_facade(pkg, study):
    """CylinderZeppelinBall (reduced grid) through a facade; returns the
    written maps."""
    from amico_tpu.io import nifti
    kw = {'device': 'cpu'} if pkg.__name__ == 'amico_tpu_torch' else {}
    ev = pkg.Evaluation(study, 'subj', **kw)
    ev.load_data(dwi_filename='DWI.nii', scheme_filename='DWI.scheme')
    assert ev.scheme.version == 1
    ev.set_model('CylinderZeppelinBall')
    ev.model.set(Rs=REDUCED_RS)
    ev.generate_kernels(ndirs=500)
    ev.load_kernels()
    ev.fit()
    ev.save_results(path_suffix=pkg.__name__)
    out = os.path.join(study, 'subj', 'AMICO',
                       f'CylinderZeppelinBall_{pkg.__name__}')
    return {name: nifti.load(os.path.join(out, name + '.nii.gz'))
            .get_fdata().astype(np.float32)
            for name in ('fit_v', 'fit_a', 'fit_d', 'fit_dir')}


def test_facade_version1_scheme(problem, tmp_path):
    """The port's facade on the CPU reads a VERSION: 1 scheme (7 columns)
    as written by ``write_demo_subject`` and writes amico_tpu.Evaluation's
    maps."""
    import amico_tpu_torch
    from amico_tpu_torch.testing import czb_voxels, write_demo_subject
    scheme, models = problem
    _, kernels, htable = models['reduced']
    y, _, _, _ = czb_voxels(240, kernels, htable, seed=11)
    study = str(tmp_path / 'study')
    write_demo_subject(os.path.join(study, 'subj'), scheme, y, (10, 6, 4))
    with open(os.path.join(study, 'subj', 'DWI.scheme')) as f:
        lines = f.read().splitlines()
    assert lines[0] == 'VERSION: 1' and len(lines[1].split()) == 7
    got = run_facade(amico_tpu_torch, study)
    ref = run_facade(amico_tpu, study)
    assert got['fit_v'].shape == (10, 6, 4)
    # the OLS DTI in float32 on b = 3000/6000 shells: 1.2e-5 on one of 720
    # direction components (CPU)
    np.testing.assert_allclose(got['fit_dir'], ref['fit_dir'], atol=5e-5)
    for name, key in (('fit_v', 'v'), ('fit_a', 'a'), ('fit_d', 'v')):
        assert_close_dist(got[name], ref[name], BOUNDS[key], name)
    assert ((got['fit_v'] >= 0) & (got['fit_v'] <= 1)).all()
