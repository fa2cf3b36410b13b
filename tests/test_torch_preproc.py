"""The port's Rician debias (amico_tpu_torch.preproc) against the JAX
package's (amico_tpu.preproc) on the same numpy-seeded inputs, against the
reference's L-BFGS-B oracle, and through the facade's doDebiasSignal."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

import amico_tpu
import amico_tpu_torch
from amico_tpu import preproc as jax_preproc
from amico_tpu.io import nifti
from amico_tpu.io.scheme import Scheme
from amico_tpu.ops.sphere import fibonacci_hemisphere
from amico_tpu_torch import preproc
from tests.test_preproc_oracle import _oracle_debias

torch.set_num_threads(1)


def _grid():
    """(S, sigma): per sigma (0, 0.5, 10, 100), signals below the noise
    floor sigma sqrt(pi/2), at it, just above it and far above it."""
    floor = np.sqrt(np.pi / 2)
    ratios = np.r_[0.0, 0.3, 1.0, floor, floor * (1 + 1e-3), floor * 1.05,
                   1.5, 2.0, 3.0, 10.0, 100.0, 1e3]
    S, sig = [], []
    for sigma in (0.0, 0.5, 10.0, 100.0):
        S.append(ratios * (sigma or 1.0))
        sig.append(np.full(ratios.shape, sigma))
    return (np.concatenate(S).astype(np.float32),
            np.concatenate(sig).astype(np.float32))


def test_debias_batch_matches_jax():
    S, sigma = _grid()
    ref = np.asarray(jax_preproc.debias_rician_batch(jnp.asarray(S),
                                                     jnp.asarray(sigma)))
    got = preproc.debias_rician_batch(torch.from_numpy(S),
                                      torch.from_numpy(sigma)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got == 0, ref == 0)     # the floor
    np.testing.assert_array_equal(got[sigma == 0], S[sigma == 0])
    # just above the floor E = sigma sqrt(2x) with x ~ 2(S - floor)/floor:
    # float32 rounding of S - floor sets the spread there
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-3 * sigma.max())
    far = S > 2 * sigma
    np.testing.assert_allclose(got[far], ref[far], rtol=1e-4)


def test_closed_form_derivative_matches_jax_grad():
    """dg/dx = k (i0e(x/2) + i1e(x/2))/2 against jax.grad of the JAX
    package's g(x) = k ((1+x) i0e(x/2) + x i1e(x/2)) for x > 0.  At x = 0
    the closed form is the one-sided derivative k/2 (x >= 0 is the whole
    domain); jax.grad reads k there, since JAX differentiates i0e's |x|
    with sign(0) = 0.  Both Newton solves reach the same roots (the test
    above)."""
    from jax.scipy.special import i0e, i1e
    k = np.float32(1.3)
    x = np.r_[0.0, np.logspace(-6, 3, 400)].astype(np.float32)
    dg = jax.grad(lambda x: (k * ((1.0 + x) * i0e(x / 2)
                                  + x * i1e(x / 2))).sum())
    ref = np.asarray(dg(jnp.asarray(x)))
    got = preproc._g_and_dg(torch.from_numpy(x), float(k))[1].numpy()
    np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-4)
    assert got[0] == pytest.approx(k / 2) and ref[0] == pytest.approx(k)


def test_rician_mean_matches_laguerre():
    """tests/test_preproc_oracle.py:43 on the port, in float32."""
    rng = np.random.RandomState(0)
    E = np.abs(rng.rand(500)) * 50.0
    sigma = 0.5 + rng.rand(500) * 5.0
    ours = preproc._rician_mean(torch.tensor(E, dtype=torch.float32),
                                torch.tensor(sigma, dtype=torch.float32))
    ref = np.sqrt(np.pi * sigma ** 2 / 2.0) * scipy.special.eval_laguerre(
        0.5, -(E ** 2) / (2.0 * sigma ** 2))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-5)


def test_newton_inversion_matches_lbfgsb_oracle():
    """tests/test_preproc_oracle.py:56 on the port."""
    rng = np.random.RandomState(1)
    n, nS = 40, 20
    E_true = np.abs(rng.rand(n, nS)) * 3.0 + 0.2
    sigma = 0.15 + rng.rand(n) * 0.2
    S = np.asarray(jax_preproc._rician_mean(E_true, sigma[:, None]))
    ours = preproc.debias_rician_batch(
        torch.from_numpy(S.astype(np.float32)),
        torch.from_numpy(sigma[:, None].astype(np.float32))).numpy()
    delta = np.abs(ours - _oracle_debias(S, sigma))
    assert np.max(delta) < 5e-3, np.max(delta)
    assert np.median(delta) < 5e-4
    np.testing.assert_allclose(ours, E_true, atol=5e-3)


def test_debias_pipeline_entry_matches_oracle():
    """tests/test_preproc_oracle.py:76 on the port's debiasRician, and the
    same volume through the JAX package's."""
    rng = np.random.RandomState(2)
    tab = np.vstack([np.zeros((2, 4)),
                     np.c_[rng.randn(10, 3), np.full(10, 1000.0)]])
    tab[2:, :3] /= np.linalg.norm(tab[2:, :3], axis=1, keepdims=True)
    scheme = Scheme(tab)
    dim = (3, 3, 2)
    nvox = int(np.prod(dim))
    vol = np.abs(100.0 * (0.4 + 0.6 * rng.rand(nvox, scheme.nS)))
    vol[:, scheme.b0_idx] = 100.0 + rng.randn(nvox, 2)
    mask = np.ones(dim, np.uint8)
    mask[0, 0, 0] = 0
    DWI = vol.reshape(dim + (scheme.nS,))
    ours = preproc.debiasRician(DWI, 20.0, mask, scheme, device='cpu')
    assert ours.shape == DWI.shape and ours.dtype == np.float32
    assert np.all(ours[0, 0, 0] == 0)
    vox = DWI[mask > 0]
    sigma = vox[:, scheme.b0_idx].mean(axis=1) / 20.0
    delta = np.abs(ours[mask > 0] - _oracle_debias(vox, sigma))
    assert np.max(delta) < 1e-2, np.max(delta)
    assert np.median(delta) < 1e-3
    np.testing.assert_allclose(
        ours, jax_preproc.debiasRician(DWI, 20.0, mask, scheme), rtol=1e-4,
        atol=1e-4)


def _subject(root, name, vol, tab):
    subj = root / name
    subj.mkdir()
    np.savetxt(subj / 'DWI.scheme', tab, fmt='%.6f',
               header='VERSION: BVECTOR', comments='')
    nifti.save(nifti.Nifti1Image(vol.astype(np.float32)),
               str(subj / 'DWI.nii.gz'))


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    d = tmp_path_factory.mktemp('torch_debias')
    os.environ['AMICO_TPU_HOME'] = str(d / 'home')
    amico_tpu.set_verbose(0)
    amico_tpu_torch.set_verbose(0)
    g = fibonacci_hemisphere(24)
    tab = np.vstack([np.zeros((2, 4)), np.c_[g, np.full(24, 1000.0)],
                     np.c_[g, np.full(24, 2500.0)]])
    # tests/test_pipeline_options.py:37's Rician-biased volume
    rng = np.random.RandomState(0)
    true = 300 * (0.3 + 0.5 * rng.rand(4, 4, 2, 50))
    true[..., :2] = 300.0
    sigma = 15.0
    vol = np.sqrt((true + sigma * rng.randn(*true.shape)) ** 2
                  + (sigma * rng.randn(*true.shape)) ** 2)
    _subject(d, 'deb', vol, tab)
    _subject(d, 'nob0', np.abs(rng.rand(4, 4, 2, 48) * 100 + 50), tab[2:])
    return d


@pytest.mark.parametrize('normalize', [False, True])
def test_facade_debias_matches_jax(root, normalize):
    """niiDWI_img after load_data with doDebiasSignal: the port's facade
    (device='cpu') against the JAX facade's, and below the biased input."""
    evs = []
    for ev in (amico_tpu.Evaluation(str(root), 'deb'),
               amico_tpu_torch.Evaluation(str(root), 'deb', device='cpu')):
        ev.set_config('doDebiasSignal', True)
        ev.set_config('doNormalizeSignal', normalize)
        ev.set_config('DWI-SNR', 300.0 / 15.0)
        ev.load_data('DWI.nii.gz', 'DWI.scheme')
        evs.append(ev)
    ref, got = (ev.niiDWI_img for ev in evs)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    scale = 1.0 if normalize else 300.0
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)
    if normalize:
        np.testing.assert_allclose(evs[1].mean_b0s, evs[0].mean_b0s,
                                   rtol=1e-5)
    else:
        raw = nifti.load(str(root / 'deb' / 'DWI.nii.gz')).get_fdata()
        assert got.mean() < raw.mean()


@pytest.mark.parametrize('subject,cfg,match', [
    ('deb', {}, 'SNR'),                              # test_pipeline_options:37
    ('nob0', {'DWI-SNR': 20}, '[Nn]o b0')])          # test_review_fixes:211
def test_debias_errors(root, subject, cfg, match):
    ev = amico_tpu_torch.Evaluation(str(root), subject, device='cpu')
    ev.set_config('doDebiasSignal', True)
    ev.set_config('doNormalizeSignal', False)
    for k, v in cfg.items():
        ev.set_config(k, v)
    with pytest.raises(amico_tpu_torch.AmicoError, match=match):
        ev.load_data('DWI.nii.gz', 'DWI.scheme')
