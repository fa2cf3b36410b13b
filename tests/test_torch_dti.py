"""The port's OLS DTI direction fit against amico_tpu.ops.dti.fit_dti."""
import os

import numpy as np
import pytest
import torch

from amico_tpu import lut as _lut
from amico_tpu import pipeline as jax_pipeline
from amico_tpu_torch import pipeline as torch_pipeline
from amico_tpu_torch.ops.dti import fit_dti, principal_eigenvector

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def noddi_signals(tmp_path_factory):
    """NODDI mixtures through the small dictionary: realistic anisotropy,
    noise and isotropic voxels."""
    d = tmp_path_factory.mktemp('dti')
    os.environ['AMICO_TPU_HOME'] = str(d / 'home')
    from amico_tpu_torch.testing import demo_noddi, demo_scheme, demo_voxels
    scheme = demo_scheme()
    _, kernels, htable = demo_noddi(scheme, small=True,
                                    kernels_dir=str(d / 'k'))
    y, _, _ = demo_voxels(4000, kernels, htable, seed=5)
    return scheme, y.astype(np.float32), htable


@pytest.mark.parametrize('merged_b0', [False, True])
def test_ols_directions_match_jax(noddi_signals, merged_b0):
    scheme, y, htable = noddi_signals
    if merged_b0:
        y = np.concatenate([y[:, scheme.b0_idx].mean(1, keepdims=True),
                            y[:, scheme.dwi_idx]], 1)
    d_jax = jax_pipeline.principal_directions(y, scheme, 'OLS', merged_b0)
    d_port = torch_pipeline.principal_directions(y, scheme, 'OLS', merged_b0,
                                                 device='cpu')
    assert d_port.shape == d_jax.shape and d_port.dtype == np.float32
    cos = np.abs(np.sum(d_jax.astype(np.float64) * d_port, 1))  # sign-free
    assert cos.min() > 1 - 1e-6, np.sort(cos)[:10]
    agree = np.mean(_lut.dir_to_lut_idx(d_jax, htable)
                    == _lut.dir_to_lut_idx(d_port, htable))
    assert agree >= 0.999, agree


def test_principal_eigenvector_known_tensors():
    rng = np.random.RandomState(0)
    Q, _ = np.linalg.qr(rng.randn(3, 3))
    D = Q @ np.diag([3.0, 1.0, 0.5]) @ Q.T
    v = principal_eigenvector(torch.tensor(D)[None]).numpy()[0]
    assert abs(abs(v @ Q[:, 0]) - 1) < 1e-9
    # isotropic tensor: the +z fallback the LUT pole expects
    iso = principal_eigenvector(torch.eye(3, dtype=torch.float64)[None])
    assert np.array_equal(iso.numpy()[0], [0.0, 0.0, 1.0])


@pytest.mark.parametrize('method', ['WLS', 'NLLS', 'RESTORE'])
def test_unported_methods_raise(method):
    y = torch.ones((2, 4))
    b = np.array([0.0, 1000.0, 1000.0, 1000.0])
    g = np.eye(4, 3)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        fit_dti(y, b, g, method)
    with pytest.raises(ValueError):
        fit_dti(y, b, g, 'bogus')
