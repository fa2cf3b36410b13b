"""The JAX package's preprocessing and model options, through the port on
the CPU: doDebiasSignal, replace_bad_voxels, b0_thr with b0_min_signal,
profile_dir, doKeepb0Intact, doMergeB0 (with the corrected DWI and with
doDirectionalAverage), the exvivo dot atom, FreeWater Mouse, the peaks
input, per-round CG budgets, the VERSION: 1 (ACTIVEAX) path, the kernel-only
models, NODDI's ground-truth recovery, the declared config keys and the
``python -m`` entry point.

Each test is the JAX test it comes from (cited by file:line), with its
assertions; where that test checks values, the same numpy-seeded subject
also goes through the JAX package (its facade, or its model where the JAX
test drives a model) and the two are compared at the bounds of
tests/test_torch_edge_cases.py, plus:
  corrected DWI           within 1e-3 relative
  debiased signal         tests/test_torch_preproc.py's (rtol 1e-4, atol
                          2e-3 sigma)
  CylinderZeppelinBall    tests/test_torch_czb.py's BOUNDS
  stagewise solver x      tests/test_torch_solvers.py's atol 5e-5.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import amico_tpu
import amico_tpu_torch
from amico_tpu.ops.sphere import fibonacci_hemisphere
from tests.test_models import EvalStub, _prepare, _rand_voxels, _scheme_v0
from tests.test_torch_czb import BOUNDS as CZB_BOUNDS
from tests.test_torch_edge_cases import (FW_BOUNDS,
                                         JAX_SOLVER, PKGS, Subject,
                                         assert_close_dist,
                                         assert_maps_match,
                                         assert_noddi_close,
                                         assert_preproc_equal, bvector_tab,
                                         evaluation, fit_one, raises_both,
                                         run_facades)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(IC_VFs=np.linspace(0.3, 0.99, 3), IC_ODs=np.array([0.1, 0.5]))
DWI_RTOL = 1e-3


def port_model(jax_model):
    """The port's model of the JAX one's class, with its parameters and
    scheme."""
    import amico_tpu_torch.models as pm
    model = getattr(pm, type(jax_model).__name__)()
    model.set(**{k: v for k, v in jax_model.get_params().items()
                 if k not in ('id', 'name')})
    model.set_solver()
    model.scheme = jax_model.scheme
    return model


def fit_models(jax_model, ctx_args, solver=None, **config):
    """The port's model and the JAX one (on ``solver`` and JAX_SOLVER's)
    on one EvalStub's inputs: (port result, JAX result, a function that
    fits the JAX model's stagewise path on them, ``assert_noddi_close``'s
    second reference)."""
    model = port_model(jax_model)
    if solver:
        model.set_solver(**solver)
    res = model.fit(EvalStub(*ctx_args, device='cpu', **config))

    def jax_fit(**backend):
        jax_model.set_solver(**(solver or {}), **backend)
        return {k: np.array(v) for k, v in
                jax_model.fit(EvalStub(*ctx_args, **config)).items()}
    ref = jax_fit(**JAX_SOLVER.get(type(jax_model).__name__, {}))
    return res, ref, lambda: jax_fit(backend='xla')['estimates']


@pytest.fixture(scope='module')
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp('kernels_options')
    os.environ['AMICO_TPU_HOME'] = str(d / 'home')
    return d


# ------------------------------------- tests/test_pipeline_options.py

def test_debias_signal_in_pipeline(tmp_path):
    """tests/test_pipeline_options.py:37: without the SNR both raise; with
    it the debiased signal sits below the biased one, the port's against
    the JAX package's at tests/test_torch_preproc.py's bounds."""
    rng = np.random.RandomState(0)
    true = 300 * (0.3 + 0.5 * rng.rand(4, 4, 2, 50))
    true[..., :2] = 300.0
    sigma = 15.0
    vol = np.sqrt((true + sigma * rng.randn(*true.shape)) ** 2
                  + (sigma * rng.randn(*true.shape)) ** 2)
    sub = Subject(bvector_tab(), vol)
    cfg = {'doDebiasSignal': True, 'doNormalizeSignal': False}
    raises_both(lambda pkg: fit_one(pkg, tmp_path / 'nosnr' / pkg.__name__,
                                    sub, config=cfg), 'SNR')
    evs = run_facades(tmp_path, sub, config=dict(cfg, **{'DWI-SNR':
                                                         300.0 / sigma}))
    got = evs[amico_tpu_torch].niiDWI_img
    assert got.mean() < vol.mean()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, evs[amico_tpu].niiDWI_img, rtol=1e-4,
                               atol=2e-3 * sigma)


def test_replace_bad_voxels(tmp_path):
    """tests/test_pipeline_options.py:63: a NaN and an Inf sample raise in
    both packages unless replace_bad_voxels is given; then the signal is
    finite and bit for bit the JAX package's."""
    vol = 100 * np.ones((3, 3, 2, 50))
    vol[0, 0, 0, 5] = np.nan
    vol[1, 1, 1, 7] = np.inf
    sub = Subject(bvector_tab(), vol)
    raises_both(lambda pkg: fit_one(pkg, tmp_path / 'raw' / pkg.__name__,
                                    sub), 'Non-finite')
    evs = run_facades(tmp_path, sub, load={'replace_bad_voxels': 0.0})
    assert np.isfinite(evs[amico_tpu_torch].niiDWI_img).all()
    assert_preproc_equal(evs)


def test_b0_thr_and_min_signal(tmp_path):
    """tests/test_pipeline_options.py:79: b = 5 counted as b0 under
    b0_thr=10, a dead-b0 voxel zeroed by b0_min_signal; bit for bit the
    JAX package's."""
    g = fibonacci_hemisphere(24)
    tab = np.vstack([np.full((2, 4), [1, 0, 0, 5.0]),     # b=5 'b0s'
                     np.c_[g, np.full(24, 1000.0)]])
    rng = np.random.RandomState(1)
    vol = 200 * (0.4 + 0.4 * rng.rand(3, 3, 2, 26))
    vol[..., :2] = 200.0
    vol[0, 0, 0, :2] = 0.0          # dead-b0 voxel
    evs = run_facades(tmp_path, Subject(tab, vol),
                      load={'b0_thr': 10, 'b0_min_signal': 0.1})
    ev = evs[amico_tpu_torch]
    assert ev.scheme.b0_count == 2        # b=5 counted as b0 with thr=10
    assert ev.niiDWI_img[0, 0, 0].max() == 0.0
    assert ev.niiDWI_img[1, 1, 1, 0] == pytest.approx(1.0, rel=1e-5)
    assert_preproc_equal(evs)


def test_profile_dir_captures_trace(tmp_path):
    """tests/test_pipeline_options.py:96: profile_dir wraps the fit in the
    port's profiler (torch.profiler: a ``*.pt.trace.json`` holding the
    'fit' range, where the JAX package writes its xplane); the maps
    against the JAX package's, fitted without its profiler (its own test
    covers that)."""
    rng = np.random.RandomState(7)
    tab = bvector_tab()
    vol = np.abs(300 * (0.3 + 0.5 * rng.rand(3, 3, 2, tab.shape[0])))
    vol[..., :2] = 300.0
    prof = str(tmp_path / 'trace')
    evs = {pkg: fit_one(pkg, tmp_path / pkg.__name__, Subject(tab, vol),
                        'FreeWater', config={'tile_size': 32, 'profile_dir':
                                             prof if pkg is amico_tpu_torch
                                             else None})
           for pkg in PKGS}
    dumped = []
    for base, _, files in os.walk(prof):
        dumped += [os.path.join(base, f) for f in files]
    assert dumped, 'profiler capture produced no files'
    traces = [f for f in dumped if f.endswith('.pt.trace.json')]
    assert len(traces) == 1, dumped
    with open(traces[0]) as f:
        assert '"name": "fit"' in f.read()
    assert_maps_match(evs, FW_BOUNDS['Human'])


# ------------------------------------------ tests/test_models_extra.py

def test_noddi_exvivo_dot_atom(workdir):
    """tests/test_models_extra.py:24: exvivo NODDI's dot map against the
    exact oracle at that test's bounds, and against the JAX model
    (``assert_noddi_close``) on the same KERNELS and voxels."""
    from amico_tpu.models import NODDI
    from amico_tpu.ops import native
    scheme = _scheme_v0()
    jmodel = NODDI()
    jmodel.set(isExvivo=True, **SMALL)
    jmodel.set_solver()
    kernels, htable = _prepare(jmodel, scheme, workdir)
    n_wm = kernels['wm'].shape[0]

    def A_of(d):
        return np.column_stack([kernels['wm'][:, d, :].T,
                                np.ones(scheme.nS), kernels['iso']])

    y, DIRs, lut_idx = _rand_voxels(120, A_of, htable, seed=7)
    res, ref, other = fit_models(jmodel, (y, DIRs, htable, kernels))
    assert port_model(jmodel).maps_name == ['NDI', 'ODI', 'FWF', 'dot']
    est = res['estimates']
    assert est.shape == (120, 4)
    assert np.isfinite(est).all()
    assert_noddi_close(est, ref['estimates'], other,
                       'estimates')

    # oracle with the exvivo branch (models.pyx:906-907,922-923,931)
    dwi = scheme.dwi_idx
    ests_ref = np.zeros((120, 4))
    for i in range(120):
        A = A_of(lut_idx[i])
        x1, _ = native.nnls(A, y[i])
        y2 = np.clip(y[i][dwi] - x1[-1] * kernels['iso'][dwi]
                     - x1[-2] * 1.0, 0, None)
        A2 = A[dwi][:, :n_wm] * kernels['norms'][None, :]
        x2 = native.lasso(A2, y2, 0.5, 1e-3)
        x = np.zeros(n_wm + 2)
        x[:n_wm] = x2
        x[-2] = 1.0
        x[-1] = 1.0
        sup = np.where(x > 0)[0]
        x3, _ = native.nnls(A[:, sup], y[i])
        x[:] = 0
        x[sup] = x3
        sa = x.sum() + 1e-16
        xn = x[:n_wm] / sa
        sw = xn.sum() + 1e-16
        f1 = np.sum(kernels['icvf'] * xn) / sw
        f2 = np.sum((1 - kernels['icvf']) * xn) / sw
        k1 = np.sum(kernels['kappa'] * xn) / sw
        ests_ref[i] = [f1 / (f1 + f2 + 1e-16),
                       2 / np.pi * np.arctan2(1.0, k1),
                       x[-1] / sa, x[-2] / sa]
    err = np.abs(est - ests_ref)
    assert np.median(err) < 1e-3
    assert np.percentile(err, 90) < 3e-2


def test_freewater_mouse(workdir):
    """tests/test_models_extra.py:73: Mouse FreeWater's blood and CSF
    fractions against native.lasso at that test's bounds, and the maps
    against the JAX model's at Mouse's bounds."""
    from amico_tpu.models import FreeWater
    from amico_tpu.ops import native
    scheme = _scheme_v0()
    jmodel = FreeWater()
    jmodel.set(type='Mouse')
    jmodel.set_solver()
    kernels, htable = _prepare(jmodel, scheme, workdir)
    n_perp = kernels['D'].shape[0]
    model = port_model(jmodel)
    assert model.maps_name == ['FiberVolume', 'FW', 'FW_blood', 'FW_csf']
    assert len(model.d_isos) == 2

    def A_of(d):
        return np.column_stack([kernels['D'][:, d, :].T, kernels['CSF'].T])

    y, DIRs, lut_idx = _rand_voxels(100, A_of, htable, seed=8)
    res, ref, _ = fit_models(jmodel, (y, DIRs, htable, kernels))
    est = res['estimates']
    assert est.shape == (100, 4)
    for i in range(0, 100, 10):
        A = A_of(lut_idx[i])
        x = native.lasso(A, y[i], 0.0, 1e-3)
        xs = x.sum() + 1e-16
        np.testing.assert_allclose(est[i, 2], x[n_perp] / xs, atol=2e-2)
        np.testing.assert_allclose(est[i, 3], x[n_perp + 1] / xs, atol=2e-2)
    assert_close_dist(est, ref['estimates'], FW_BOUNDS['Mouse'], 'Mouse')


def test_noddi_merge_b0(workdir):
    """tests/test_models_extra.py:99: the port's merged-b0 KERNELS (equal
    to the JAX package's) collapse the b0 columns; merged and full fits of
    the same voxels agree at that test's bound, each against the JAX
    model's."""
    from amico_tpu import lut as jlut
    from amico_tpu.models import NODDI
    from amico_tpu_torch import lut as _lut
    scheme = _scheme_v0()
    kernels = {}
    for name, lut in (('port', _lut), ('jax', jlut)):
        jmodel = NODDI()
        jmodel.set(**SMALL)
        jmodel.set_solver()
        jmodel.scheme = scheme
        model = port_model(jmodel) if name == 'port' else jmodel
        out = workdir / f'NODDI_merge_{name}'
        out.mkdir(exist_ok=True)
        aux = lut.load_precomputed_rotation_matrices(12, 500)
        idx_in, idx_out = lut.aux_structures_generate(scheme, 12)
        model.generate(str(out), aux, idx_in, idx_out, 500)
        ridx, Ylm = lut.aux_structures_resample(scheme, 12)
        kernels[name] = {merged: model.resample(str(out), ridx, Ylm, merged,
                                                500)
                         for merged in (True, False)}
    for merged in (True, False):
        for key in ('wm', 'iso', 'kappa', 'icvf', 'norms'):
            np.testing.assert_array_equal(kernels['port'][merged][key],
                                          kernels['jax'][merged][key])
    k_merged, k_full = kernels['port'][True], kernels['port'][False]
    htable = _lut.load_precomputed_hash_table(500)
    assert k_merged['wm'].shape[2] == 1 + scheme.dwi_count
    assert k_full['wm'].shape[2] == scheme.nS

    y, DIRs, lut_idx = _rand_voxels(100, lambda d: np.column_stack(
        [k_full['wm'][:, d, :].T, k_full['iso']]), htable, seed=9)
    y_merged = np.column_stack([y[:, scheme.b0_idx].mean(1),
                                y[:, scheme.dwi_idx]])
    res_full, ref_full, other_full = fit_models(
        jmodel, (y, DIRs, htable, k_full))
    res_merged, ref_merged, other_merged = fit_models(
        jmodel, (y_merged, DIRs, htable, k_merged), doMergeB0=True)
    err = np.abs(res_full['estimates'] - res_merged['estimates'])
    assert np.median(err) < 5e-3
    assert_noddi_close(res_full['estimates'], ref_full['estimates'],
                       other_full, 'full')
    assert_noddi_close(res_merged['estimates'], ref_merged['estimates'],
                       other_merged, 'merged')


def test_peaks_file_input(tmp_path):
    """tests/test_models_extra.py:134: the directions are the peaks image's
    exactly (no DTI fit), in both packages; NODDI's maps against the JAX
    package's (``assert_noddi_close``, its stagewise facade the second
    reference, fitted only if the golden's bounds miss)."""
    g = fibonacci_hemisphere(24)
    tab = np.vstack([np.zeros((2, 4)), np.c_[g, np.full(24, 1000.0)],
                     np.c_[g, np.full(24, 2500.0)]])
    rng = np.random.RandomState(1)
    vol = np.abs(300 * (0.3 + 0.5 * rng.rand(4, 4, 2, 50)))
    vol[..., :2] = 300.0
    peaks = rng.randn(4, 4, 2, 3).astype(np.float32)
    peaks /= np.linalg.norm(peaks, axis=-1, keepdims=True)
    sub = Subject(tab, vol, extra={'peaks.nii.gz': peaks})
    kw = dict(config={'peaks_filename': 'peaks.nii.gz', 'tile_size': 32},
              model_set=SMALL)
    evs = run_facades(tmp_path, sub, 'NODDI', **kw)
    for ev in evs.values():
        np.testing.assert_allclose(np.asarray(ev.DIRs).reshape(4, 4, 2, 3),
                                   peaks, atol=1e-6)
        assert np.isfinite(ev.RESULTS['MAPs']).all()
    fit = evs[amico_tpu].niiMASK_img == 1

    def jax_stagewise():
        ev = evaluation(amico_tpu, tmp_path / 'amico_tpu')
        for k, v in kw['config'].items():
            ev.set_config(k, v)
        ev.load_data('DWI.nii.gz', 'DWI.scheme')
        ev.set_model('NODDI')
        ev.model.set(**SMALL)
        ev.set_solver(backend='xla')
        ev.generate_kernels()
        ev.load_kernels()
        ev.fit()
        return ev.RESULTS['MAPs'][fit]
    assert_noddi_close(evs[amico_tpu_torch].RESULTS['MAPs'][fit],
                       evs[amico_tpu].RESULTS['MAPs'][fit], jax_stagewise,
                       'MAPs')


def test_staging_cache_invalidation(workdir):
    """tests/test_models_extra.py:170: a re-fit of identical data hits the
    port's caches and gives the same maps; y changed in place is seen; the
    maps against the JAX model's."""
    from amico_tpu.models import FreeWater
    scheme = _scheme_v0()
    jmodel = FreeWater()
    jmodel.set()
    jmodel.set_solver()
    kernels, htable = _prepare(jmodel, scheme, workdir)

    def A_of(d):
        return np.column_stack([kernels['D'][:, d, :].T, kernels['CSF'].T])

    y, DIRs, _ = _rand_voxels(96, A_of, htable, seed=11)
    model = port_model(jmodel)
    ev = EvalStub(y, DIRs, htable, kernels, device='cpu')
    est1 = model.fit(ev)['estimates']
    est2 = model.fit(ev)['estimates']          # cache hit
    np.testing.assert_array_equal(est1, est2)
    _, ref, _ = fit_models(jmodel, (y.copy(), DIRs, htable, kernels))
    assert_close_dist(est1, ref['estimates'], FW_BOUNDS['Human'], 'est1')

    y *= 0.5                                    # in-place, same object
    est3 = model.fit(ev)['estimates']
    ev_fresh = EvalStub(y.copy(), DIRs, htable, kernels, device='cpu')
    est4 = model.fit(ev_fresh)['estimates']
    np.testing.assert_allclose(est3, est4, rtol=0, atol=1e-6)


def test_solver_tuple_cg_schedule_matches_flat():
    """tests/test_models_extra.py:199: a per-round CG tuple reaches the
    flat budget's minimizer on the port's stagewise solver, and each
    schedule's x the JAX solver's (tests/test_torch_solvers.py's atol)."""
    import jax.numpy as jnp
    from amico_tpu.ops import solvers as jsolvers
    from amico_tpu_torch.ops.solvers import gram, nneg_qp_batch
    rng = np.random.RandomState(3)
    A = rng.rand(40, 12)
    X = rng.rand(64, 12) * (rng.rand(64, 12) < 0.3)
    Y = X @ A.T + 0.01 * rng.randn(64, 40)
    # float32 on both sides: JAX computes in float32 what numpy gives it
    G = np.array(jsolvers.gram(jnp.asarray(A)))
    np.testing.assert_allclose(
        gram(torch.from_numpy(A.astype(np.float32))).numpy(), G, rtol=1e-5)
    b = (Y @ A).astype(np.float32)
    kw = dict(fista_iters=0, cd_sweeps=0, refine_rounds=12)
    sched_cg = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 12, 12)
    xs = {}
    for cg in (16, sched_cg):
        x = nneg_qp_batch(torch.from_numpy(G), torch.from_numpy(b), 0.0,
                          1e-3, cg_iters=cg, **kw).numpy()
        ref = np.asarray(jsolvers.nneg_qp_batch(G, b, 0.0, 1e-3,
                                                cg_iters=cg, **kw))
        np.testing.assert_allclose(x, ref, atol=5e-5)
        xs[cg] = x
    np.testing.assert_allclose(xs[sched_cg], xs[16], rtol=0, atol=5e-5)


def test_set_solver_accepts_cg_tuple(workdir):
    """tests/test_models_extra.py:219: a per-round CG tuple passes the
    port's set_solver and fits; against the JAX model on the same
    schedule."""
    from amico_tpu.models import FreeWater
    scheme = _scheme_v0()
    jmodel = FreeWater()
    jmodel.set()
    jmodel.set_solver()
    kernels, htable = _prepare(jmodel, scheme, workdir)
    solver = dict(cg_iters=(4, 6, 8), refine_rounds=8)
    model = port_model(jmodel)
    model.set_solver(**solver)
    assert model.solver_params['cg_iters'] == (4, 6, 8)

    def A_of(d):
        return np.column_stack([kernels['D'][:, d, :].T, kernels['CSF'].T])

    y, DIRs, _ = _rand_voxels(64, A_of, htable, seed=2)
    res, ref, _ = fit_models(jmodel, (y, DIRs, htable, kernels), solver,
                             tile_size=32)
    est = res['estimates']
    assert np.isfinite(est).all() and np.abs(est).sum() > 0
    assert_close_dist(est, ref['estimates'], FW_BOUNDS['Human'], 'est')


# -------------------------------------------- tests/test_pipeline_v1.py

def v1_tab():
    from amico_tpu.io.scheme import GAMMA
    Delta, delta = 0.035, 0.015
    rows = [np.array([[0, 0, 0, 0, Delta, delta, Delta + delta]])]
    for b in (3000.0, 6000.0):
        g = fibonacci_hemisphere(24)
        G = np.sqrt(b * 1e6 / (GAMMA ** 2 * delta ** 2 * (Delta - delta / 3)))
        rows.append(np.c_[g, np.full(24, G), np.full(24, Delta),
                          np.full(24, delta), np.full(24, Delta + delta)])
    return np.vstack(rows)


def test_activeax_end_to_end(tmp_path):
    """tests/test_pipeline_v1.py:25: a VERSION: 1 scheme with a rescaled
    volume through CylinderZeppelinBall; the written maps, and the maps
    against the JAX package's at tests/test_torch_czb.py's bounds."""
    tab = v1_tab()
    rng = np.random.RandomState(0)
    vol = np.abs(250 * (0.3 + 0.5 * rng.rand(4, 4, 2, tab.shape[0])))
    vol[..., 0] = 250.0
    sub = Subject(tab, vol, header='VERSION: 1', scl=(2.0, 10.0))
    rs = np.concatenate(([0.01], np.linspace(0.5, 8.0, 6))) * 1e-6
    evs = run_facades(tmp_path, sub, 'CylinderZeppelinBall',
                      config={'tile_size': 32}, model_set={'Rs': rs},
                      save=True)
    ev = evs[amico_tpu_torch]
    assert ev.scheme.version == 1
    assert abs(ev.niiDWI_img.max()) > 0  # loaded + rescaled + normalized
    assert_preproc_equal(evs)
    from amico_tpu_torch.io import nifti
    out = tmp_path / 'amico_tpu_torch' / 's' / 'AMICO' / \
        'CylinderZeppelinBall'
    for f in ['fit_v.nii.gz', 'fit_a.nii.gz', 'fit_d.nii.gz',
              'fit_dir.nii.gz']:
        assert (out / f).exists(), f
    v = nifti.load(str(out / 'fit_v.nii.gz')).get_fdata()
    a = nifti.load(str(out / 'fit_a.nii.gz')).get_fdata()
    assert (v >= 0).all() and (v <= 1).all()
    assert (a >= 0).all() and (a < 20).all()
    mp = ev.RESULTS['MAPs']
    mj = evs[amico_tpu].RESULTS['MAPs']
    for col, key in ((0, 'v'), (1, 'a'), (2, 'v')):
        assert_close_dist(mp[..., col], mj[..., col], CZB_BOUNDS[key], key)


def test_v1_get_table_roundtrip():
    """tests/test_pipeline_v1.py:64: the port's table equals the JAX
    package's and reads back to the same shells."""
    from amico_tpu_torch.io.scheme import Scheme
    s = Scheme(v1_tab())
    t = s.get_table()
    assert t.shape[1] == 7
    np.testing.assert_array_equal(t, amico_tpu.Scheme(v1_tab()).get_table())
    s2 = Scheme(t)
    np.testing.assert_allclose(s2.b, s.b, rtol=1e-12)
    assert len(s2.shells) == len(s.shells)
    for sh, sh2 in zip(s.shells, s2.shells):
        assert sh2['G'] == pytest.approx(sh['G'])
        assert sh2['delta'] == pytest.approx(sh['delta'])


def test_stick_zeppelin_ball_generate_resample(tmp_path):
    """tests/test_pipeline_v1.py:76: the kernel-only models' LUTs (equal to
    the JAX package's) and their fit raising."""
    from amico_tpu import lut as jlut
    from amico_tpu.models import StickZeppelinBall as JaxSZB
    from amico_tpu.models import VolumeFractions as JaxVF
    from amico_tpu_torch import lut as _lut
    from amico_tpu_torch.io.scheme import Scheme
    from amico_tpu_torch.models import StickZeppelinBall, VolumeFractions
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    g = fibonacci_hemisphere(20)
    tab = np.vstack([np.zeros((1, 4)), np.c_[g, np.full(20, 1000.0)]])
    got = {}
    for name, szb, vf, lut, S in (
            ('port', StickZeppelinBall, VolumeFractions, _lut, Scheme),
            ('jax', JaxSZB, JaxVF, jlut, amico_tpu.Scheme)):
        scheme = S(tab)
        model = szb()
        model.scheme = scheme
        out = tmp_path / f'szb_{name}'
        out.mkdir()
        aux = lut.load_precomputed_rotation_matrices(12, 500)
        i_in, i_out = lut.aux_structures_generate(scheme, 12)
        model.generate(str(out), aux, i_in, i_out, 500)
        ridx, Ylm = lut.aux_structures_resample(scheme, 12)
        K = model.resample(str(out), ridx, Ylm, False, 500)
        vmodel = vf()
        vmodel.scheme = scheme
        got[name] = (model, K, vmodel, vmodel.resample('', ridx, Ylm, False,
                                                       500))
    model, K, vmodel, Kv = got['port']
    assert K['wmr'].shape == (1, 500, 21)
    assert K['wmh'].shape == (4, 500, 21)
    assert K['iso'].shape == (1, 21)
    for key in ('wmr', 'wmh', 'iso'):
        np.testing.assert_array_equal(K[key], got['jax'][1][key])
        np.testing.assert_array_equal(Kv[key], got['jax'][3][key])
    assert (Kv['wmr'] == 1).all()
    for m in (model, vmodel):
        with pytest.raises(amico_tpu_torch.AmicoError):
            m.fit(None)


# -------------------------------------------- tests/test_ground_truth.py

def test_noddi_ground_truth_recovery(workdir):
    """tests/test_ground_truth.py:31: signals from the NODDI forward model
    (the port's synthesis, equal to the JAX package's) at known NDI, ODI
    and FWF on the full 12x12 grid are recovered at that test's bounds,
    and the port's maps against the JAX model's."""
    from amico_tpu.models import NODDI
    from amico_tpu_torch.synthesis import (NODDIExtraCellular,
                                           NODDIIntraCellular,
                                           NODDIIsotropic)
    from amico_tpu.synthesis import NODDIIntraCellular as JaxIC
    scheme = _scheme_v0()
    jmodel = NODDI()
    jmodel.set()            # full 12x12 grid -- the production dictionary
    jmodel.set_solver()
    kernels, htable = _prepare(jmodel, scheme, workdir)

    rng = np.random.RandomState(9)
    n = 160
    ndi_true = np.concatenate([
        rng.choice(jmodel.IC_VFs, n // 2),                 # on-grid
        rng.uniform(0.2, 0.95, n - n // 2)])               # off-grid
    odi_true = np.concatenate([
        rng.choice(jmodel.IC_ODs[1:], n // 2),
        rng.uniform(0.06, 0.9, n - n // 2)])
    fwf_true = rng.uniform(0.0, 0.4, n)

    ic = NODDIIntraCellular(scheme)
    ec = NODDIExtraCellular(scheme)
    iso = NODDIIsotropic(scheme)
    S_iso = iso.get_signal(jmodel.dIso)
    y = np.zeros((n, scheme.nS))
    for i in range(n):
        kappa = 1.0 / np.tan(odi_true[i] * np.pi / 2.0)
        S_ic = ic.get_signal(jmodel.dPar, kappa)
        if i == 0:
            np.testing.assert_array_equal(
                S_ic, JaxIC(scheme).get_signal(jmodel.dPar, kappa))
        S_ec = ec.get_signal(jmodel.dPar, kappa, ndi_true[i])
        S_wm = ndi_true[i] * S_ic + (1.0 - ndi_true[i]) * S_ec
        y[i] = (1.0 - fwf_true[i]) * S_wm + fwf_true[i] * S_iso
    y = np.clip(y + (np.abs(y).mean() / 50.0) * rng.randn(*y.shape), 0, None)

    DIRs = np.tile([0.0, 0.0, 1.0], (n, 1))
    res, ref, other = fit_models(jmodel, (y, DIRs, htable, kernels))
    est = res['estimates']
    for col, truth in enumerate((ndi_true, odi_true, fwf_true)):
        err = np.abs(est[:, col] - truth)
        assert np.median(err) < 0.05, (col, np.median(err))
        assert np.percentile(err, 90) < 0.12, (col, np.percentile(err, 90))
    assert_noddi_close(est, ref['estimates'], other,
                       'estimates')


# ----------------------------------- tests/test_sweep.py (FreeWater DWI)

def sweep_subject(seed):
    """tests/test_sweep.py:14's subject (5x4x2, 2 b0 + 2x24)."""
    rng = np.random.RandomState(seed)
    vol = np.abs(400 * (0.3 + 0.5 * rng.rand(5, 4, 2, 50)))
    vol[..., :2] = 400.0
    return Subject(bvector_tab(), vol)


def assert_dwi_close(evs):
    got = evs[amico_tpu_torch].RESULTS['DWI_corrected']
    ref = np.asarray(evs[amico_tpu].RESULTS['DWI_corrected'])
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=DWI_RTOL,
                               atol=DWI_RTOL * np.abs(ref).max())


@pytest.mark.parametrize('merge_b0', [False, True],
                         ids=['keep_b0_intact', 'merge_b0'])
def test_corrected_dwi(tmp_path, merge_b0):
    """tests/test_sweep.py:156 (doKeepb0Intact) and :212 (with doMergeB0):
    the corrected DWI keeps the b0 signal (one merged b0 at column 0 under
    doMergeB0) and corrects the DWI columns; against the JAX package's
    within 1e-3 relative, the maps at FreeWater's bounds."""
    cfg = {'doSaveCorrectedDWI': True, 'doKeepb0Intact': True,
           'doMergeB0': merge_b0, 'tile_size': 32}
    evs = run_facades(tmp_path, sweep_subject(9 if merge_b0 else 7),
                      'FreeWater', config=cfg)
    ev = evs[amico_tpu_torch]
    corr = ev.RESULTS['DWI_corrected']
    mask = ev.niiMASK_img == 1
    if merge_b0:
        assert corr.shape[3] == 1 + ev.scheme.dwi_count     # merged layout
        expected_b0 = ev.y[:, 0] * ev.mean_b0s[mask]
        np.testing.assert_allclose(corr[mask][:, 0], expected_b0, rtol=1e-5)
        # DWI columns hold the *corrected* signal, not reinstated raw
        assert not np.allclose(corr[mask][:, 1:],
                               ev.y[:, 1:] * ev.mean_b0s[mask][:, None])
    else:
        expected_b0 = ev.y[:, ev.scheme.b0_idx] * ev.mean_b0s[mask][:, None]
        np.testing.assert_allclose(corr[mask][:, ev.scheme.b0_idx],
                                   expected_b0, rtol=1e-5)
    assert_preproc_equal(evs)
    assert_dwi_close(evs)
    assert_maps_match(evs, FW_BOUNDS['Human'])


def test_wrong_model_name_raises(tmp_path):
    """tests/test_pipeline.py:183."""
    raises_both(lambda pkg: evaluation(pkg, tmp_path).set_model('NotAModel'),
                'NotAModel')


# ------------------------------------------ tests/test_review_fixes.py

def test_merge_b0_with_directional_average_is_consistent(tmp_path):
    """tests/test_review_fixes.py:173: doMergeB0 with doDirectionalAverage
    skips the merge; the averages equal the plain directional average's,
    and both equal the JAX package's bit for bit."""
    from amico_tpu.io.scheme import GAMMA
    Delta, delta = 0.035, 0.015
    rows = [np.array([[0, 0, 0, 0, Delta, delta, Delta + delta]])] * 2
    for b in (1000.0, 2500.0):
        g = fibonacci_hemisphere(20)
        G = np.sqrt(b * 1e6 / (GAMMA ** 2 * delta ** 2 * (Delta - delta / 3)))
        rows.append(np.c_[g, np.full(20, G), np.full(20, Delta),
                          np.full(20, delta), np.full(20, Delta + delta)])
    vol = np.abs(100 * (0.3 + 0.7 * np.random.RandomState(0)
                        .rand(4, 4, 2, 42)))
    vol[..., :2] = 100.0
    sub = Subject(np.vstack(rows), vol, header='VERSION: 1')
    evs = run_facades(tmp_path, sub, config={'doMergeB0': True,
                                             'doDirectionalAverage': True})
    ev = evs[amico_tpu_torch]
    # 2 shells -> 1 mean b0 + 2 shell means, matching the derived scheme
    assert ev.niiDWI_img.shape[3] == 3
    assert ev.scheme.nS == 3
    assert np.isfinite(ev.niiDWI_img).all()
    assert_preproc_equal(evs)
    np.testing.assert_array_equal(ev.scheme.get_table(),
                                  evs[amico_tpu].scheme.get_table())
    plain = run_facades(tmp_path / 'plain', sub,
                        config={'doDirectionalAverage': True})
    np.testing.assert_array_equal(ev.niiDWI_img,
                                  plain[amico_tpu_torch].niiDWI_img)


def test_every_get_config_key_is_declared_or_stage_set():
    """tests/test_review_fixes.py:351 over the port's sources: every key it
    reads is declared by the port's _default_config (``device`` among them)
    or set by a stage, and the port declares every key the JAX package
    does."""
    import re
    from amico_tpu.core import _default_config as jax_default_config
    from amico_tpu_torch.core import _default_config
    pkg = os.path.dirname(os.path.abspath(amico_tpu_torch.__file__))
    reads, writes = set(), set()
    for root, _dirs, files in os.walk(pkg):
        for fn in files:
            if not fn.endswith('.py'):
                continue
            with open(os.path.join(root, fn)) as f:
                src = f.read()
            reads |= set(re.findall(r"get_config\(['\"]([^'\"]+)['\"]", src))
            writes |= set(re.findall(r"set_config\(['\"]([^'\"]+)['\"]", src))
    declared = set(_default_config('.', '.', None, 'cpu'))
    undeclared = reads - declared - writes
    assert not undeclared, (
        f'config keys read but neither declared in _default_config nor '
        f'set by any stage: {sorted(undeclared)}')
    assert {'mesh', 'fit_checkpoint', 'checkpoint_every',
            'max_device_bytes', 'device'} <= declared
    assert declared - {'device'} == set(jax_default_config('.', '.', None))


def test_main_module_import_does_not_exit():
    """tests/test_review_fixes.py:134: importing the port's __main__ runs
    no CLI and does not exit."""
    code = ('import importlib; m = importlib.import_module('
            '"amico_tpu_torch.__main__"); '
            'print("imported", hasattr(m, "main"))')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert 'imported True' in out.stdout
