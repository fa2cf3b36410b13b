"""The port's DTI direction fit (OLS, WLS, NLLS, RESTORE) against
amico_tpu.ops.dti.fit_dti on the same numpy-seeded inputs."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amico_tpu import lut as _lut
from amico_tpu import pipeline as jax_pipeline
from amico_tpu.ops import dti as jax_dti
from amico_tpu.ops.sphere import fibonacci_hemisphere
from amico_tpu_torch import pipeline as torch_pipeline
from amico_tpu_torch.ops.dti import (_lm_refine, _median, fit_dti,
                                     principal_eigenvector)

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


# the inputs of tests/test_dti.py's WLS, NLLS, RESTORE and offset cases,
# rebuilt from their seeds
def _zeppelins(axes, b, g, d_par=1.7e-3, d_perp=0.3e-3, s0=1.0):
    cos2 = (g @ axes.T) ** 2
    return (s0 * np.exp(-b[:, None] * (d_perp + (d_par - d_perp) * cos2))).T


def _protocol(bval):
    g = np.vstack([np.zeros((2, 3)), fibonacci_hemisphere(40)])
    return np.concatenate([np.zeros(2), np.full(40, bval)]), g


def case_noisy():                           # tests/test_dti.py:47
    rng = np.random.RandomState(1)
    b, g = _protocol(1500.0)
    axes = fibonacci_hemisphere(64)
    y = _zeppelins(axes, b, g)
    return np.abs(y + 0.02 * rng.randn(*y.shape)), b, g, axes


def case_noiseless():                       # tests/test_dti.py:79
    b, g = _protocol(2000.0)
    axes = fibonacci_hemisphere(64)
    return _zeppelins(axes, b, g), b, g, axes


def case_rician():                          # tests/test_dti.py:79
    rng = np.random.RandomState(7)
    y, b, g, axes = case_noiseless()
    s = 0.04
    return np.sqrt((y + s * rng.randn(*y.shape)) ** 2
                   + (s * rng.randn(*y.shape)) ** 2), b, g, axes


def case_spikes():                          # tests/test_dti.py:106
    rng = np.random.RandomState(3)
    b, g = _protocol(1500.0)
    axes = fibonacci_hemisphere(80)
    y = np.abs(_zeppelins(axes, b, g) + 0.01 * rng.randn(80, 42))
    for v in range(y.shape[0]):
        hit = rng.choice(np.arange(2, y.shape[1]), size=3, replace=False)
        y[v, hit] *= rng.uniform(2.5, 4.0, size=3)
    return y, b, g, axes


def case_offset():                          # tests/test_dti.py:149
    rng = np.random.RandomState(11)
    b, g = _protocol(1500.0)
    axes = fibonacci_hemisphere(60)
    y = _zeppelins(axes, b, g)
    return y + 0.05 + 0.002 * rng.randn(*y.shape), b, g, axes


CASES = {name[5:]: fn for name, fn in list(globals().items())
         if name.startswith('case_')}


def port_dirs(y, b, g, method):
    return fit_dti(torch.from_numpy(np.asarray(y, np.float32)), b, g,
                   method).numpy()


def angles(d, ref):
    """Sign-free angle in degrees between unit vectors, in float64."""
    dots = np.abs(np.sum(np.asarray(d, np.float64)
                         * np.asarray(ref, np.float64), axis=1))
    return np.degrees(np.arccos(np.clip(dots, 0.0, 1.0)))


@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('method', ['WLS', 'NLLS', 'RESTORE'])
def test_methods_match_jax(case, method):
    """The port's fit_dti against amico_tpu.ops.dti.fit_dti on the JAX
    tests' inputs: direction angle median < 0.05 deg, p99 < 0.5 deg."""
    y, b, g, _ = CASES[case]()
    d_jax = np.asarray(jax_dti.fit_dti(jnp.asarray(y, jnp.float32), b, g,
                                       method))
    ang = angles(port_dirs(y, b, g, method), d_jax)
    assert np.median(ang) < 0.05 and np.percentile(ang, 99) < 0.5, \
        (np.median(ang), np.percentile(ang, 99), ang.max())


def test_jax_assertions_hold_on_the_port():
    """tests/test_dti.py's own assertions on WLS, NLLS and RESTORE, rerun
    on the port."""
    def med_err(y, b, g, axes, method):
        return np.median(angles(port_dirs(y, b, g, method), axes))

    y, b, g, axes = case_noisy()                    # test_dti.py:47
    for method in ('OLS', 'WLS'):
        dots = np.cos(np.deg2rad(angles(port_dirs(y, b, g, method), axes)))
        assert np.median(dots) > np.cos(np.deg2rad(4.0)), method
    y, b, g, axes = case_noiseless()                # test_dti.py:79
    dots = np.abs(np.sum(port_dirs(y, b, g, 'NLLS') * axes, axis=1))
    assert dots.min() > 1 - 1e-5
    y, b, g, axes = case_rician()
    e_nlls = med_err(y, b, g, axes, 'NLLS')
    assert np.isfinite(e_nlls)
    assert e_nlls <= med_err(y, b, g, axes, 'OLS') + 0.5
    y, b, g, axes = case_spikes()                   # test_dti.py:106
    e_ols, e_rob = (med_err(y, b, g, axes, m) for m in ('OLS', 'RESTORE'))
    assert e_rob < e_ols and e_rob < 3.0, (e_rob, e_ols)
    rng = np.random.RandomState(3)
    clean = np.abs(_zeppelins(axes, b, g) + 0.01 * rng.randn(80, 42))
    dots = np.abs(np.sum(port_dirs(clean, b, g, 'RESTORE') * axes, axis=1))
    assert np.median(dots) > np.cos(np.deg2rad(2.0))
    y, b, g, axes = case_offset()                   # test_dti.py:149
    err = angles(port_dirs(y, b, g, 'RESTORE'), axes)
    assert np.median(err) < 3.0 and np.percentile(err, 95) < 10.0


def test_lm_refine_matches_jax():
    """_lm_refine's parameters against the JAX package's from the same WLS
    start on well-conditioned voxels (S0 = 2, 1% noise): rtol 1e-4, with
    each parameter's error relative to its own size plus its column's
    largest (the off-diagonal entries of a zeppelin cross zero)."""
    rng = np.random.RandomState(5)
    b, g = _protocol(1500.0)
    b = np.where(np.arange(42) % 2, b, b * 2 / 3)        # two shells
    axes = fibonacci_hemisphere(64)
    y = (_zeppelins(axes, b, g, s0=2.0)
         * (1 + 0.01 * rng.randn(64, 42))).astype(np.float32)
    Bd = jax_dti.design_matrix(b, g)
    logy = np.log(y)
    p0 = (logy @ np.linalg.pinv(Bd).T).astype(np.float32)
    w = rng.uniform(0.5, 1.5, y.shape).astype(np.float32)
    B = torch.as_tensor(Bd, dtype=torch.float32)
    BB = (B[:, :, None] * B[:, None, :]).reshape(-1, 49)
    for iters in (2, 12):
        got = _lm_refine(torch.from_numpy(p0), B, BB, torch.from_numpy(y),
                         torch.from_numpy(w), iters).numpy()
        ref = np.asarray(jax_dti._lm_refine(
            jnp.asarray(p0), jnp.asarray(Bd, jnp.float32), jnp.asarray(y),
            jnp.asarray(w), iters))
        err = np.abs(got - ref) / (np.abs(ref) + np.abs(ref).max(0))
        assert err.max() < 1e-4, (iters, err.max(0))


@pytest.mark.parametrize('n', [41, 42])
def test_median_matches_jnp_median(n):
    """jnp.median's mean of the two middle values on an even count (where
    torch.median takes the lower one), and the middle one on an odd."""
    x = np.random.RandomState(n).randn(50, n).astype(np.float32)
    x[0] = 1.0                                       # ties
    got = _median(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jnp.median(jnp.asarray(x), axis=-1, keepdims=True)))
    lower = torch.from_numpy(x).median(-1, keepdim=True).values.numpy()
    assert np.array_equal(got, lower) == (n % 2 == 1)


@pytest.mark.parametrize('method', ['WLS', 'NLLS', 'RESTORE'])
def test_flat_signal_stays_finite(method):
    """Background voxels (zeros, a tiny constant, a flat 1) give singular
    or near-singular systems: no raise, and finite unit directions."""
    b, g = _protocol(1000.0)
    y = np.zeros((4, 42), np.float32)
    y[1] = 1e-7
    y[2] = 1.0
    y[3] = case_noisy()[0][0]
    d = port_dirs(y, b, g, method)
    assert np.isfinite(d).all()
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, rtol=1e-5)
    with pytest.raises(ValueError):
        port_dirs(y, b, g, 'bogus')


@pytest.mark.parametrize('method', ['WLS', 'NLLS', 'RT'])
def test_pipeline_methods_match_jax(noddi_signals, method):
    """principal_directions with every DTI_fit_method alias on realistic
    NODDI mixtures: the LUT direction agrees with the JAX package's."""
    scheme, y, htable = noddi_signals
    m = jax_pipeline.resolve_dti_method(method)
    assert torch_pipeline.resolve_dti_method(method) == m
    d_jax = jax_pipeline.principal_directions(y, scheme, m, False)
    d_port = torch_pipeline.principal_directions(y, scheme, m, False,
                                                 device='cpu')
    ang = angles(d_port, d_jax)
    assert np.median(ang) < 0.05 and np.percentile(ang, 99) < 0.5, \
        (np.median(ang), np.percentile(ang, 99))
    agree = np.mean(_lut.dir_to_lut_idx(d_jax, htable)
                    == _lut.dir_to_lut_idx(d_port, htable))
    assert agree >= 0.999, agree
