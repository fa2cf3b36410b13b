"""The port's NODDI model (amico_tpu_torch.models.NODDI) against the JAX
package: the frozen solver golden, the JAX NODDI fit on the exvivo +
RMSE/NRMSE path, the device constants, and every set_solver route on the
fused path against the JAX package's fused fit."""
import os

import numpy as np
import pytest
import torch

from amico_tpu.models import NODDI as JaxNODDI
from amico_tpu_torch.models import NODDI

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), 'data')
SMALL = dict(IC_VFs=np.linspace(0.3, 0.99, 4),
             IC_ODs=np.array([0.06, 0.3, 0.8]))


class Ctx:
    """The slice of Evaluation a model's fit reads."""

    def __init__(self, y, DIRs, htable, kernels, **config):
        self.y, self.DIRs, self.htable, self.KERNELS = y, DIRs, htable, kernels
        self.config = config

    def get_config(self, key):
        return self.config.get(key)


@pytest.fixture(scope='module')
def small_problem(tmp_path_factory):
    d = tmp_path_factory.mktemp('noddi_torch')
    os.environ['AMICO_TPU_HOME'] = str(d / 'home')
    from amico_tpu_torch.testing import demo_noddi, demo_scheme
    scheme = demo_scheme()
    model, kernels, htable = demo_noddi(scheme, small=True,
                                        kernels_dir=str(d / 'k'))
    return scheme, model, kernels, htable


def test_fit_matches_golden(small_problem):
    """tests/test_golden.py::test_noddi_golden's recipe through the port.
    The golden was frozen from the JAX package's stagewise XLA path; the
    JAX package's own fused kernel (the one the port carries) departs from
    it on a few degenerate voxels, so the max is held to that departure."""
    from amico_tpu_torch.testing import demo_voxels
    scheme, model, kernels, htable = small_problem
    y, DIRs, _ = demo_voxels(256, kernels, htable, seed=42)
    res = model.fit(Ctx(y, DIRs, htable, kernels, tile_size=32,
                        voxels_per_chunk=8192, device='cpu'))
    ref = np.load(os.path.join(DATA, 'golden_noddi_small.npz'))['estimates']
    assert res['estimates'].shape == ref.shape
    err = np.abs(res['estimates'] - ref)
    assert np.median(err) < 1e-5, np.median(err)
    assert np.percentile(err, 95) < 1e-3, np.percentile(err, 95)

    jax_model = JaxNODDI()
    jax_model.set(**SMALL)
    jax_model.set_solver(backend='pallas', precision='highest')
    jax_model.scheme = scheme
    jax_res = jax_model.fit(Ctx(y, DIRs, htable, kernels, tile_size=32,
                                voxels_per_chunk=8192))
    jax_max = np.abs(np.asarray(jax_res['estimates']) - ref).max()
    assert err.max() < max(5e-3, jax_max + 5e-3), (err.max(), jax_max)


def test_exvivo_rmse_matches_jax_fused(small_problem, tmp_path):
    """Exvivo NODDI with RMSE/NRMSE (the want_x path) against the JAX NODDI
    fit on its fused kernel, both from the same resampled KERNELS."""
    from amico_tpu import lut as _lut
    scheme = small_problem[0]
    kdir = str(tmp_path / 'k_ex')
    os.makedirs(kdir)
    model = NODDI()
    model.set(isExvivo=True, **SMALL)
    model.set_solver()
    model.scheme = scheme
    model.generate(kdir, _lut.load_precomputed_rotation_matrices(12, 500),
                   *_lut.aux_structures_generate(scheme, 12), 500)
    kernels = model.resample(kdir, *_lut.aux_structures_resample(scheme, 12),
                             False, 500)
    htable = _lut.load_precomputed_hash_table(500)
    jax_model = JaxNODDI()
    jax_model.set(isExvivo=True, **SMALL)
    jax_model.set_solver(backend='pallas', precision='highest')
    jax_model.scheme = scheme

    from amico_tpu_torch.testing import demo_voxels
    y, DIRs, _ = demo_voxels(256, kernels, htable, seed=4)
    cfg = dict(tile_size=16, voxels_per_chunk=4096, doComputeRMSE=True,
               doComputeNRMSE=True)
    res = model.fit(Ctx(y, DIRs, htable, kernels, device='cpu', **cfg))
    ref = jax_model.fit(Ctx(y, DIRs, htable, kernels, **cfg))
    assert res['estimates'].shape == (256, 4)          # NDI, ODI, FWF, dot
    for key in ('estimates', 'rmse', 'nrmse'):
        d = np.abs(res[key] - np.asarray(ref[key]))
        assert np.median(d) < 1e-5, (key, np.median(d))
        assert np.percentile(d, 95) < 1e-2, (key, np.percentile(d, 95))


@pytest.mark.parametrize('exvivo,merged_b0', [(False, False), (True, False),
                                              (False, True)])
def test_prepare_builds_the_fit_constants(small_problem, exvivo, merged_b0):
    scheme, _, kernels, _ = small_problem
    model = NODDI()
    model.set(isExvivo=exvivo, **SMALL)
    model.scheme = scheme
    c = model.prepare(kernels, 'cpu', merged_b0=merged_b0)
    n_wm, ndirs, nS = kernels['wm'].shape
    cols = [np.transpose(kernels['wm'], (1, 2, 0))]
    if exvivo:
        cols.append(np.ones((ndirs, nS, 1)))
    cols.append(np.broadcast_to(kernels['iso'][None, :, None], (ndirs, nS, 1)))
    A = np.concatenate(cols, -1).astype(np.float32).astype(np.float64)
    rows = np.arange(1, nS) if merged_b0 else np.asarray(scheme.dwi_idx)
    A2 = A[:, rows, :n_wm] * kernels['norms'].astype(np.float32)
    np.testing.assert_array_equal(c['A_all'].numpy(), A.astype(np.float32))
    np.testing.assert_allclose(c['G1_all'].numpy(),
                               np.einsum('dsi,dsj->dij', A, A),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c['G2_all'].numpy(),
                               np.einsum('dsi,dsj->dij', A2, A2),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(c['A2T_all'].numpy(),
                               np.swapaxes(A2, 1, 2), rtol=1e-6)
    np.testing.assert_array_equal(c['iso_dwi'].numpy(), kernels['iso'][rows])
    assert c['A_all'].shape[-1] == n_wm + 1 + int(exvivo)


@pytest.mark.parametrize('solver_kw', [
    dict(stage_iters=((0, 4, 8, 1, True), (0, 6, 8, 1), (6, 8, 2))),
    dict(tiebreak=True),
    dict(precision='split3'),
    dict(fista_iters=40)])
def test_unported_solver_options_raise(small_problem, solver_kw):
    """Once a raise on the fused route ('auto'), now a fit: the `converge`
    continuation, the tie-break, a precision tier (computed in float32:
    the same maps as at 'highest') and FISTA through the iteration knobs,
    each held against the JAX package's fused NODDI fit with the same
    set_solver arguments on the golden's voxels, within
    tests/test_golden.py's median and p95 bounds."""
    scheme, _, kernels, htable = small_problem
    y, DIRs, _ = golden_inputs(small_problem)
    fits = {}
    # the JAX fit at 'highest', which is what the port computes: its own
    # default and 'split3' take bf16 passes (at 'split3' it sits a median
    # 8.7e-5 from the port here, CPU)
    jax_kw = dict(solver_kw, backend='pallas', precision='highest')
    runs = (('port', NODDI, solver_kw), ('jax', JaxNODDI, jax_kw))
    if 'precision' in solver_kw:
        runs += (('port-highest', NODDI, dict(precision='highest')),)
    for name, cls, kw in runs:
        model = cls()
        model.set(**SMALL)
        model.set_solver(**kw)
        model.scheme = scheme
        dev = {} if name == 'jax' else {'device': 'cpu'}
        fits[name] = np.asarray(model.fit(Ctx(
            y, DIRs, htable, kernels, tile_size=32, voxels_per_chunk=8192,
            **dev))['estimates'])
    assert fits['port'].shape == fits['jax'].shape == (256, 3)
    if 'port-highest' in fits:
        assert np.array_equal(fits['port'], fits['port-highest'])
    err = np.abs(fits['port'] - fits['jax'])
    assert np.median(err) < 1e-5, np.median(err)
    assert np.percentile(err, 95) < 1e-3, np.percentile(err, 95)


@pytest.mark.parametrize('precision', [
    'high', 'default', ('highest', 'split3', 'default'),
    (('default', 'split3', 1), 'split3', ('split3', 'highest', 2))])
def test_precision_is_validated_and_stored(precision):
    """Every precision the JAX package's fused kernel resolves is taken and
    stored; names it does not know raise."""
    model = NODDI()
    model.set_solver(precision=precision)
    assert model.solver_params['precision'] == (
        precision if isinstance(precision, str) else tuple(precision))
    for bad in ('float32', ('highest', 'bf16', 'default'),
                (('split3', 'highest', 2.5), 'split3', 'highest')):
        with pytest.raises(ValueError):
            NODDI().set_solver(precision=bad)


# The stagewise path (backend='xla') against the golden, which was frozen
# from the JAX package's stagewise path: median 6.4e-6 and p95 2.1e-4 hold
# the golden's bounds, the max (0.0362) cannot.  The JAX stagewise path
# against itself with its WM atoms listed in another order (permutations of
# seeds 0-5; CPU) reads max 0.0142-0.0348 and 0.8-1.6% of voxels off by
# more than 5e-3: the tail is the stage-2 vertex degeneracy below f32
# resolution.  Its bounds, rounded up from those readings:
STAGEWISE_MAX, STAGEWISE_SHARE_OFF = 0.04, 0.03


def permuted_kernels(kernels, seed):
    """The same KERNELS with the WM atoms in another order."""
    p = np.random.RandomState(seed).permutation(kernels['wm'].shape[0])
    out = dict(kernels)
    for key in ('wm', 'kappa', 'icvf', 'norms'):
        out[key] = np.ascontiguousarray(kernels[key][p])
    return out


def golden_inputs(small_problem):
    from amico_tpu_torch.testing import demo_voxels
    _, _, kernels, htable = small_problem
    y, DIRs, _ = demo_voxels(256, kernels, htable, seed=42)
    ref = np.load(os.path.join(DATA, 'golden_noddi_small.npz'))['estimates']
    return y, DIRs, ref


def test_stagewise_fit_matches_golden(small_problem):
    """tests/test_golden.py::test_noddi_golden's recipe through the port's
    stagewise path: median and p95 at the golden bounds, the tail at the
    JAX stagewise path's own reorder bounds."""
    scheme, _, kernels, htable = small_problem
    y, DIRs, ref = golden_inputs(small_problem)
    model = NODDI()
    model.set(**SMALL)
    model.set_solver(backend='xla')
    model.scheme = scheme
    res = model.fit(Ctx(y, DIRs, htable, kernels, tile_size=32,
                        voxels_per_chunk=8192, device='cpu'))
    assert res['estimates'].shape == ref.shape
    err = np.abs(res['estimates'] - ref)
    assert np.median(err) < 1e-5, np.median(err)
    assert np.percentile(err, 95) < 1e-3, np.percentile(err, 95)
    assert err.max() < STAGEWISE_MAX, err.max()
    assert np.mean(err.max(-1) > 5e-3) < STAGEWISE_SHARE_OFF


@pytest.mark.parametrize('seed', [1, 2])
def test_jax_stagewise_departs_from_golden_under_atom_reorder(small_problem,
                                                              seed):
    """The reading behind STAGEWISE_MAX: the JAX stagewise path on the
    golden's inputs with its WM atoms reordered (mathematically the same
    problem) leaves max < 5e-3 and stays within the port's bounds."""
    scheme, _, kernels, htable = small_problem
    y, DIRs, ref = golden_inputs(small_problem)
    jax_model = JaxNODDI()
    jax_model.set(**SMALL)
    jax_model.set_solver(backend='xla')
    jax_model.scheme = scheme
    est = np.asarray(jax_model.fit(Ctx(
        y, DIRs, htable, permuted_kernels(kernels, seed), tile_size=32,
        voxels_per_chunk=8192))['estimates'])
    err = np.abs(est - ref)
    assert np.median(err) < 1e-5 and np.percentile(err, 95) < 1e-3
    assert 5e-3 < err.max() < STAGEWISE_MAX, err.max()
    assert np.mean(err.max(-1) > 5e-3) < STAGEWISE_SHARE_OFF


# Exvivo on voxels without a dot compartment lets the dot and iso atoms
# trade places (as on the fused path).  The port's stagewise fit against
# itself with its WM atoms reordered reads median 2.5e-6-2.7e-6 and p95
# 1.1e-3-7.5e-3 (1.3e-2 on NDI) on voxel seeds 4 and 5; the JAX stagewise
# path against itself reordered, median 3.0e-6 and p95 2.1e-3-5.1e-3
# (modulated maps 5.9e-3); the port against JAX, median 9.1e-6 and p95
# 1.26e-2 (seed 4; CPU).  Rounded up from those readings:
EXVIVO_BOUNDS = (2e-5, 2e-2)


@pytest.mark.parametrize('case', ['exvivo-rmse-modulated', 'tiebreak',
                                  'custom-iters', 'merged-b0'])
def test_stagewise_matches_jax_xla(small_problem, tmp_path, case):
    """The port's stagewise fit against the JAX package's (backend 'xla'),
    from the same KERNELS: exvivo with RMSE/NRMSE and modulated maps, the
    stage-2 tie-break, the uniform schedule of custom iteration knobs, and
    the doMergeB0 row layout.  Maps by median and p95: in vivo at the
    exvivo fused test's bounds (the stage-2 vertex is degenerate below
    f32), exvivo at EXVIVO_BOUNDS."""
    from amico_tpu import lut as _lut
    from amico_tpu_torch.testing import demo_voxels
    scheme, _, kernels, htable = small_problem
    exvivo = case.startswith('exvivo')
    merged = case == 'merged-b0'
    solver_kw = {'tiebreak': dict(tiebreak=True),
                 'custom-iters': dict(fista_iters=20, refine_rounds=8,
                                      cg_iters=(4, 8, 12))}.get(case, {})
    if exvivo or merged:
        model = NODDI()
        model.set(isExvivo=exvivo, **SMALL)
        model.scheme = scheme
        kdir = str(tmp_path / 'k')
        os.makedirs(kdir)
        model.generate(kdir, _lut.load_precomputed_rotation_matrices(12, 500),
                       *_lut.aux_structures_generate(scheme, 12), 500)
        kernels = model.resample(kdir, *_lut.aux_structures_resample(
            scheme, 12), merged, 500)
    # with doMergeB0 the KERNELS, and so the voxels, hold one b0 column
    y, DIRs, _ = demo_voxels(256, kernels, htable, seed=4)
    cfg = dict(tile_size=16, voxels_per_chunk=4096, doMergeB0=merged)
    if exvivo:
        cfg.update(doComputeRMSE=True, doComputeNRMSE=True,
                   doSaveModulatedMaps=True)
    fits = {}
    for name, cls in (('port', NODDI), ('jax', JaxNODDI)):
        model = cls()
        model.set(isExvivo=exvivo, **SMALL)
        model.set_solver(backend='xla', **solver_kw)
        model.scheme = scheme
        kw = {'device': 'cpu'} if name == 'port' else {}
        fits[name] = model.fit(Ctx(y, DIRs, htable, kernels, **cfg, **kw))
    res, ref = fits['port'], fits['jax']
    assert res['estimates'].shape == (256, 4 if exvivo else 3)
    keys = ['estimates'] + (['rmse', 'nrmse', 'estimates_mod'] if exvivo
                            else [])
    med, p95 = EXVIVO_BOUNDS if exvivo else (1e-5, 1e-2)
    for key in keys:
        d = np.abs(res[key] - np.asarray(ref[key]))
        assert np.median(d) < med, (key, np.median(d))
        assert np.percentile(d, 95) < p95, (key, np.percentile(d, 95))


def test_cuda_device_without_card_raises(small_problem):
    from amico_tpu_torch import AmicoError
    scheme, model, kernels, htable = small_problem
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    with pytest.raises(AmicoError, match='no CUDA card'):
        model.fit(Ctx(np.ones((4, scheme.nS)), np.eye(4, 3), htable, kernels,
                      device='cuda'))
