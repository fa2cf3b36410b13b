"""The port's stagewise solver (amico_tpu_torch.ops.solvers) against the JAX
package's (amico_tpu.ops.solvers) and the exact native oracle, on
tests/test_solvers.py's recipes and on every schedule form the models use.

Both run in float64 (JAX inside ``jax.enable_x64``) unless a case says
float32.  Tolerances: x within the oracle tolerance of the recipe it comes
from (5e-5 for NNLS and masked solves, 2e-5 for the lasso pairs), against
the oracle and against JAX; the objective 1/2 x'Gx - b'x + lam1 sum(x) +
lam2/2 |x|^2 of the port within 1e-6 relative of JAX's."""
import numpy as np
import pytest
import torch
from scipy.optimize import nnls as scipy_nnls

import jax
import jax.numpy as jnp

from amico_tpu.models import base as jax_base
from amico_tpu.ops import native
from amico_tpu.ops import solvers as jsolvers
from amico_tpu_torch.models import base
from amico_tpu_torch.ops import solvers

torch.set_num_threads(1)

OBJ_GAP = 1e-6


def random_problems(B=16, m=60, n=24, seed=0, correlated=False):
    """tests/test_solvers.py's problems."""
    rng = np.random.RandomState(seed)
    if correlated:
        t = np.linspace(0, 1, m)
        A = np.stack([np.exp(-t * (1 + 8 * j / n)) for j in range(n)], axis=1)
        A += 0.01 * rng.randn(m, n)
    else:
        A = rng.randn(m, n)
    Y = rng.rand(B, m)
    return A, Y


def run_jax(fn, *args, **kw):
    """``fn`` of the JAX package on NumPy arguments, in float64 when they
    are; NumPy out."""
    conv = lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a  # noqa: E731
    with jax.enable_x64(True):
        return np.asarray(fn(*[conv(a) for a in args],
                             **{k: conv(v) for k, v in kw.items()}))


def run_torch(fn, *args, **kw):
    conv = lambda a: torch.from_numpy(np.array(a)) \
        if isinstance(a, np.ndarray) else a  # noqa: E731
    return fn(*[conv(a) for a in args],
              **{k: conv(v) for k, v in kw.items()}).numpy()


def objective(G, b, lam1, lam2, x):
    G, b, x = (np.asarray(a, np.float64) for a in (G, b, x))
    Gx = np.squeeze(np.broadcast_to(G, b.shape + b.shape[-1:])
                    @ x[..., None], -1)
    return 0.5 * (x * Gx).sum(-1) - (b * x).sum(-1) + lam1 * x.sum(-1) \
        + 0.5 * lam2 * (x * x).sum(-1)


def assert_matches_jax(G, b, lam1, lam2, x_t, x_j, atol):
    np.testing.assert_allclose(x_t, x_j, atol=atol)
    o_t, o_j = objective(G, b, lam1, lam2, x_t), \
        objective(G, b, lam1, lam2, x_j)
    gap = np.abs(o_t - o_j) / (np.abs(o_j) + 1e-6)
    assert gap.max() < OBJ_GAP, gap.max()


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_power_iteration_matches_jax(dtype):
    rng = np.random.RandomState(1)
    A = rng.randn(3, 40, 20).astype(dtype)
    G = np.einsum('cmi,cmj->cij', A, A)
    L_t = run_torch(solvers.power_iteration_L, G)
    L_j = run_jax(jsolvers.power_iteration_L, G)
    assert L_t.dtype == dtype
    np.testing.assert_allclose(L_t, L_j, rtol=1e-6 if dtype == np.float64
                               else 1e-5)
    np.testing.assert_allclose(L_t, np.linalg.eigvalsh(
        G.astype(np.float64)).max(-1), rtol=1e-3)


def test_cg_masked_matches_jax():
    A, Y = random_problems(B=6, m=50, n=20, seed=4)
    G, b = A.T @ A, Y @ A
    rng = np.random.RandomState(5)
    m = (rng.rand(6, 20) > 0.4).astype(np.float64)
    x0 = rng.rand(6, 20) * 0.1
    for iters in (3, 25):
        z_t = run_torch(solvers._cg_masked, G, b, m, x0, 1e-3, iters)
        z_j = run_jax(jsolvers._cg_masked, G, b, m, x0, 1e-3, iters)
        np.testing.assert_allclose(z_t, z_j, rtol=1e-9, atol=1e-9)
        assert (z_t[m == 0] == 0).all()


@pytest.mark.parametrize('correlated', [False, True])
def test_nnls_vs_scipy_and_jax(correlated):
    A, Y = random_problems(B=12, correlated=correlated)
    kw = dict(fista_iters=300, cd_sweeps=60)
    X = run_torch(solvers.nnls_from_A, A, Y, **kw)
    X_j = run_jax(jsolvers.nnls_from_A, A, Y, **kw)
    for i in range(Y.shape[0]):
        x_ref, _ = scipy_nnls(A, Y[i])
        obj = lambda x: 0.5 * np.sum((Y[i] - A @ x) ** 2)  # noqa: E731
        assert obj(X[i]) <= obj(x_ref) * (1 + 1e-6) + 1e-10
        np.testing.assert_allclose(X[i], x_ref, atol=5e-5)
    assert_matches_jax(A.T @ A, Y @ A, 0.0, 0.0, X, X_j, 5e-5)


@pytest.mark.parametrize('lam1,lam2', [(0.0, 4.0), (0.5, 1e-3), (0.0, 1e-3),
                                       (0.0, 5e-3)])
def test_lasso_vs_native_oracle_and_jax(lam1, lam2):
    """The four (lam1, lam2) pairs are the reference models' defaults:
    CylinderZeppelinBall, NODDI, FreeWater, SANDI."""
    A, Y = random_problems(B=10, m=80, n=30, seed=3, correlated=True)
    kw = dict(fista_iters=400, cd_sweeps=80)
    X = run_torch(solvers.nneg_lasso_from_A, A, Y, lam1, lam2, **kw)
    X_j = run_jax(jsolvers.nneg_lasso_from_A, A, Y, lam1, lam2, **kw)
    for i in range(Y.shape[0]):
        np.testing.assert_allclose(X[i], native.lasso(A, Y[i], lam1, lam2),
                                   atol=2e-5, err_msg=f'problem {i}')
    assert_matches_jax(A.T @ A, Y @ A, lam1, lam2, X, X_j, 2e-5)


def test_exact_zeros_for_support_detection():
    A, Y = random_problems(B=8, m=60, n=25, seed=7, correlated=True)
    X = run_torch(solvers.nneg_lasso_from_A, A, Y, 0.5, 1e-3,
                  fista_iters=200, cd_sweeps=40)
    for i in range(8):
        x_ref = native.lasso(A, Y[i], 0.5, 1e-3)
        assert set(np.where(X[i] > 0)[0]) == set(np.where(x_ref > 1e-12)[0])


def test_shared_vs_batched_G_agree():
    A, Y = random_problems(B=8, m=40, n=16, seed=6)
    G, b = A.T @ A, Y @ A
    kw = dict(lam1=0.1, lam2=0.01, fista_iters=200, cd_sweeps=40)
    Xs = run_torch(solvers.nneg_qp_batch, G, b, **kw)
    Xb = run_torch(solvers.nneg_qp_batch,
                   np.broadcast_to(G, (8,) + G.shape).copy(), b, **kw)
    np.testing.assert_allclose(Xs, Xb, atol=1e-10)


def active_set_problems(seed=0, T=3, M=8, m=40, n=20, lam_ridge=False):
    """tests/test_solvers.py::test_add_k_oracle_parity_both_backends's
    non-negative mixtures, as T tiles of M voxels, each tile with its own
    dictionary: per-tile Grams G (T, 1, n, n), b (T, M, n), the
    dictionaries (T, m, n) and signals (T, M, m)."""
    rng = np.random.RandomState(seed)
    A = np.abs(rng.randn(T, m, n))
    Xt = rng.rand(T, M, n) * (rng.rand(T, M, n) < 0.4)
    Y = np.einsum('tmn,tbn->tbm', A, Xt) + 0.01 * rng.randn(T, M, m)
    G = np.einsum('tmi,tmj->tij', A, A)
    b = np.einsum('tmi,tbm->tbi', A, Y)
    return G[:, None], b, A, Y


DEFAULT = base.DEFAULT_AS_SOLVER_KW
DENSE = base.DENSE_AS_SOLVER_KW
# (lam1, lam2, extra inputs, solver kwargs): every schedule form and input
# of nneg_qp_batch that a model or a test of the JAX package passes
SCHEDULES = {
    'default-tuple-converge': (0.0, 1e-3, None, DEFAULT),
    'dense-flat-converge': (0.0, 4.0, None, DENSE),
    'flat-early-exit': (0.0, 1e-3, None,
                        dict(fista_iters=40, cd_sweeps=4, refine_rounds=12,
                             cg_iters=12)),
    'flat-no-early-exit': (0.0, 1e-3, None,
                           dict(fista_iters=40, cd_sweeps=4, refine_rounds=12,
                                cg_iters=12, early_exit=False)),
    'fista-no-early-exit': (0.5, 1e-3, None,
                            dict(fista_iters=60, cd_sweeps=0, refine_rounds=0,
                                 early_exit=False)),
    'short-tuple-extended': (0.0, 1e-3, None,
                             dict(fista_iters=0, cd_sweeps=0, refine_rounds=6,
                                  cg_iters=(3, 5), converge=True)),
    'converge-int': (0.0, 1e-3, None,
                     dict(fista_iters=0, cd_sweeps=0, refine_rounds=3,
                          cg_iters=6, converge=9)),
    'add_k2': (0.0, 1e-3, None,
               dict(fista_iters=0, cd_sweeps=0, refine_rounds=6,
                    cg_iters=(4, 6, 8, 10, 12, 12), converge=True, add_k=2)),
    'mask': (0.0, 0.0, 'mask',
             dict(fista_iters=40, cd_sweeps=4, refine_rounds=8, cg_iters=16)),
    'warm-m0-x0': (0.0, 0.0, 'warm',
                   dict(fista_iters=0, cd_sweeps=0, refine_rounds=6,
                        cg_iters=(16, 10, 8, 8, 8, 8), inner_passes=2)),
    'warm-mask-converge': (0.0, 1e-3, 'warm-mask',
                           dict(fista_iters=0, cd_sweeps=0, refine_rounds=3,
                                cg_iters=12, converge=True)),
}


def schedule_inputs(extra, b):
    rng = np.random.RandomState(11)
    inputs = {}
    if extra in ('mask', 'warm-mask'):
        inputs['mask'] = (rng.rand(*b.shape) > 0.3).astype(b.dtype)
    if extra in ('warm', 'warm-mask'):
        m0 = (rng.rand(*b.shape) > 0.5).astype(b.dtype)
        if 'mask' in inputs:
            m0 = m0 * inputs['mask']
        inputs['m0'], inputs['x0'] = m0, rng.rand(*b.shape) * 0.1 * m0
    return inputs


@pytest.mark.parametrize('case', list(SCHEDULES))
def test_schedules_match_jax_and_oracle(case):
    """Per-tile Grams (T, 1, n, n), as ``solve_tiles`` passes them: x and
    the objective against the JAX solver; with an exact schedule, x against
    the native oracle (NNLS, or the lasso when a ridge is set) too."""
    lam1, lam2, extra, kw = SCHEDULES[case]
    G, b, A, Y = active_set_problems(seed=sum(map(ord, case)) % 97)
    inputs = schedule_inputs(extra, b)
    x_t = run_torch(solvers.nneg_qp_batch, G, b, lam1, lam2, **inputs, **kw)
    x_j = run_jax(jsolvers.nneg_qp_batch, G, b, lam1, lam2, **inputs, **kw)
    assert x_t.shape == b.shape and (x_t >= 0).all()
    assert_matches_jax(G, b, lam1, lam2, x_t, x_j, 5e-5)
    if 'mask' in inputs:
        assert (x_t[inputs['mask'] == 0] == 0).all()
    if extra is None and kw.get('refine_rounds', 0) and kw.get('converge'):
        for t in range(b.shape[0]):
            for v in range(b.shape[1]):
                x_or = native.lasso(A[t], Y[t, v], lam1, lam2) if lam2 \
                    else native.nnls(A[t], Y[t, v])[0]
                np.testing.assert_allclose(x_t[t, v], x_or, atol=5e-5)


@pytest.mark.parametrize('case', ['default-tuple-converge',
                                  'dense-flat-converge', 'flat-early-exit'])
def test_float32_tiles_match_jax(case):
    """float32, as the models run: the objective within 1e-6 relative of
    the JAX solver's and x within 5e-4 (f32 resolution on these Grams)."""
    lam1, lam2, _, kw = SCHEDULES[case]
    G, b, _, _ = active_set_problems(seed=2, T=4, M=16)
    G, b = G.astype(np.float32), b.astype(np.float32)
    x_t = run_torch(solvers.nneg_qp_batch, G, b, lam1, lam2, **kw)
    x_j = run_jax(jsolvers.nneg_qp_batch, G, b, lam1, lam2, **kw)
    assert x_t.dtype == np.float32
    assert_matches_jax(G, b, lam1, lam2, x_t, x_j, 5e-4)


@pytest.mark.parametrize('case', ['dense-flat-converge', 'flat-early-exit',
                                  'converge-int'])
def test_exit_flag_read_interval_changes_nothing(monkeypatch, case):
    """Each loop freezes its state once its batch-wide exit condition holds,
    so reading the flag on the host at any interval (every iteration on the
    CPU, every few on a CUDA device) gives the same x, bit for bit."""
    lam1, lam2, _, kw = SCHEDULES[case]
    G, b, _, _ = active_set_problems(seed=5)
    every = run_torch(solvers.nneg_qp_batch, G, b, lam1, lam2, **kw)
    for k in (3, 1000):
        monkeypatch.setattr(solvers, '_exit_check',
                            lambda x, i, k=k: i % k == 0)
        got = run_torch(solvers.nneg_qp_batch, G, b, lam1, lam2, **kw)
        np.testing.assert_array_equal(got, every)


def test_exits_are_batch_wide():
    """The FISTA and round loops stop on a max over the whole call: one
    slow problem keeps every problem iterating, as in the JAX solver; a
    problem solved alone stops earlier and lands elsewhere."""
    kw = dict(fista_iters=50, cd_sweeps=0, refine_rounds=0)
    A, Y = random_problems(B=8, m=40, n=16, seed=9, correlated=True)
    G, b = A.T @ A, Y @ A
    x_all = run_torch(solvers.nneg_qp_batch, G, b, **kw)
    x_j = run_jax(jsolvers.nneg_qp_batch, G, b, **kw)
    np.testing.assert_allclose(x_all, x_j, rtol=1e-9, atol=1e-12)
    x_one = np.stack([run_torch(solvers.nneg_qp_batch, G, b[i:i + 1], **kw)[0]
                      for i in range(8)])
    assert np.abs(x_one - x_all).max() > 1e-9


def test_stage2_tiebreak_matches_jax():
    """noddi_stage2_tiebreak on NODDI-like tiles whose voxels each hold one
    atom, with x2 put on a grid neighbour of it (or on the atom itself):
    swaps win on some voxels; neighbour tables with grid edges (-1)."""
    rng = np.random.RandomState(3)
    C, M, m, n = 3, 8, 50, 12
    t = np.linspace(0, 1, m)
    A = np.stack([np.stack([np.exp(-t * (1 + 8 * j / n))
                            + 0.01 * rng.randn(m) for j in range(n)], 1)
                  for _ in range(C)])
    true = rng.randint(n, size=(C, M))
    Y = np.take_along_axis(A, true[:, None, :], 2).transpose(0, 2, 1) \
        + 0.001 * rng.randn(C, M, m)
    G = np.einsum('cmi,cmj->cij', A, A)
    b = np.einsum('cmi,cbm->cbi', A, Y)
    off = np.clip(true + rng.randint(-1, 2, size=(C, M)), 0, n - 1)
    x2 = np.zeros((C, M, n))
    np.put_along_axis(x2, off[..., None], 0.9, -1)
    nbm = np.array([-1] + list(range(n - 1)), np.int32)
    nbp = np.array(list(range(1, n)) + [-1], np.int32)
    for cg in (2, 8):
        x_t = run_torch(solvers.noddi_stage2_tiebreak, G, b, x2, 0.05, 1e-3,
                        nbm, nbp, cg_iters=cg)
        x_j = run_jax(jsolvers.noddi_stage2_tiebreak, G, b, x2, 0.05, 1e-3,
                      nbm, nbp, cg_iters=cg)
        np.testing.assert_allclose(x_t, x_j, rtol=1e-9, atol=1e-12)
        assert (x_t.argmax(-1) != off).any()       # some voxels swapped


def test_gram_matches_jax():
    A = np.random.RandomState(0).randn(4, 30, 12).astype(np.float32)
    np.testing.assert_allclose(run_torch(solvers.gram, A),
                               run_jax(jsolvers.gram, A), rtol=1e-5,
                               atol=1e-5)


def test_defaults_are_the_jax_packages():
    assert base.DEFAULT_CG_ITERS == jax_base.DEFAULT_CG_ITERS
    assert base.DEFAULT_REFINE_ROUNDS == jax_base.DEFAULT_REFINE_ROUNDS
