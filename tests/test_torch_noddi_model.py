"""The port's NODDI model (amico_tpu_torch.models.NODDI) against the JAX
package: the frozen solver golden, the JAX NODDI fit on the exvivo +
RMSE/NRMSE path, the device constants, and the options not yet ported."""
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


@pytest.mark.parametrize('solver_kw', [dict(backend='xla'),
                                       dict(tiebreak=True),
                                       dict(precision='split3'),
                                       dict(fista_iters=40)])
def test_unported_solver_options_raise(small_problem, solver_kw):
    scheme, _, kernels, htable = small_problem
    model = NODDI()
    model.set(**SMALL)
    model.set_solver(**solver_kw)
    model.scheme = scheme
    y = np.ones((4, scheme.nS))
    with pytest.raises(NotImplementedError):
        model.fit(Ctx(y, np.eye(4, 3), htable, kernels, device='cpu'))


def test_cuda_device_without_card_raises(small_problem):
    from amico_tpu_torch import AmicoError
    scheme, model, kernels, htable = small_problem
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    with pytest.raises(AmicoError, match='no CUDA card'):
        model.fit(Ctx(np.ones((4, scheme.nS)), np.eye(4, 3), htable, kernels,
                      device='cuda'))
