"""The tile QP of the port (amico_tpu_torch.ops.cuda_qp.nneg_qp_tiles and
its twin) against the JAX package's Pallas kernel, run as its own tests run
it on the CPU: ``nneg_qp_tiles_pallas(interpret=True)``.

Tolerance: x within atol 2e-4, rtol 1e-3, as tests/test_pallas_qp.py holds
the Pallas kernel to the XLA solver, and the objective
1/2 x'Gx - b'x + lam1 sum(x) + lam2/2 |x|^2 within 1e-6 relative.  The twin
runs the same float32 operations in another summation order; on these
problems it reads within 3e-7 of the Pallas kernel (CPU)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amico_tpu.models import base as jax_base
from amico_tpu.ops.pallas_qp import nneg_qp_tiles_pallas
from amico_tpu_torch.models import base
from amico_tpu_torch.ops import cuda_qp
from amico_tpu_torch.ops.cuda_qp import nneg_qp_tiles, nneg_qp_tiles_torch
from amico_tpu_torch.testing import random_qp_problems

torch.set_num_threads(1)

X_ATOL, X_RTOL, OBJ_GAP = 2e-4, 1e-3, 1e-6
KW40 = dict(fista_iters=40, cd_sweeps=4, refine_rounds=8, cg_iters=16)


def problems(C=3, M=128, n=21, seed=0):
    """tests/test_pallas_qp.py's random problems."""
    return random_qp_problems(C, n, M=M, seed=seed)


def mask_for(b, seed=1):
    return (np.random.RandomState(seed).rand(*b.shape) > 0.4).astype(
        np.float32)


def warm_for(b, seed=5):
    rng = np.random.RandomState(seed)
    return ((rng.rand(*b.shape) > 0.6).astype(np.float32),
            (rng.rand(*b.shape) * 0.1).astype(np.float32))


def pallas(G, b, lam1, lam2, mask=None, m0=None, x0=None, **kw):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return np.asarray(nneg_qp_tiles_pallas(
        jnp.asarray(G), jnp.asarray(b), jnp.zeros(G.shape[0]), lam1, lam2,
        mask=j(mask), m0=j(m0), x0=j(x0), interpret=True, **kw))


def twin(G, b, lam1, lam2, mask=None, m0=None, x0=None, **kw):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return nneg_qp_tiles_torch(t(G), t(b), None, lam1, lam2, mask=t(mask),
                               m0=t(m0), x0=t(x0), **kw).numpy()


def objective(G, b, lam1, lam2, x):
    x = x.astype(np.float64)
    Gx = np.einsum('cij,cmj->cmi', G.astype(np.float64), x)
    return 0.5 * (x * Gx).sum(-1) - (b * x).sum(-1) + lam1 * x.sum(-1) \
        + 0.5 * lam2 * (x * x).sum(-1)


# (n, seed, lam1, lam2, inputs, solver kwargs)
CASES = {
    'plain': (21, 0, 0.0, 0.0, None, KW40),
    'lasso': (21, 0, 0.5, 1e-3, None, KW40),
    'ridge': (21, 0, 0.0, 4.0, None, KW40),
    'mask': (21, 3, 0.0, 0.0, 'mask', KW40),
    'mask-converge': (21, 3, 0.0, 1e-3, 'mask',
                      dict(fista_iters=0, refine_rounds=3, cg_iters=(4, 8),
                           converge=True)),
    'warm': (21, 0, 0.0, 1e-3, 'warm',
             dict(fista_iters=40, refine_rounds=4, cg_iters=16)),
    'warm-converge': (21, 0, 0.0, 1e-3, 'warm',
                      dict(fista_iters=0, refine_rounds=2, cg_iters=16,
                           converge=True)),
    'default': (21, 0, 0.0, 1e-3, None, base.DEFAULT_AS_SOLVER_KW),
    'dense': (21, 0, 0.0, 4.0, None, base.DENSE_AS_SOLVER_KW),
    # n = 11 and 12 pad to npad = 16: continuation CG 16, round cap 48
    'default-n11': (11, 0, 0.0, 1e-3, None, base.DEFAULT_AS_SOLVER_KW),
    'default-n12': (12, 0, 0.0, 1e-3, None, base.DEFAULT_AS_SOLVER_KW),
    'short-n11': (11, 0, 0.0, 1e-3, None,
                  dict(fista_iters=0, refine_rounds=2, cg_iters=(3, 5),
                       converge=True)),
    'converge-int': (12, 0, 0.0, 1e-3, None,
                     dict(fista_iters=0, refine_rounds=3, cg_iters=6,
                          converge=9)),
    'add_k2': (21, 0, 0.0, 1e-3, None,
               dict(fista_iters=0, refine_rounds=3, cg_iters=6,
                    converge=True, add_k=2)),
    'fista-only': (21, 0, 0.0, 1e-3, None,
                   dict(fista_iters=30, refine_rounds=0, cg_iters=16)),
    'fista-one-pass': (21, 0, 0.0, 1e-3, None,
                       dict(fista_iters=10, refine_rounds=1, cg_iters=8,
                            inner_passes=1, converge=True)),
}


@pytest.mark.parametrize('case', list(CASES))
def test_twin_matches_pallas(case):
    n, seed, lam1, lam2, extra, kw = CASES[case]
    G, b = problems(n=n, seed=seed)
    inputs = {}
    if extra == 'mask':
        inputs['mask'] = mask_for(b)
    elif extra == 'warm':
        inputs['m0'], inputs['x0'] = warm_for(b)
    x_j = pallas(G, b, lam1, lam2, **inputs, **kw)
    x_t = twin(G, b, lam1, lam2, **inputs, **kw)
    assert x_t.shape == x_j.shape == b.shape
    np.testing.assert_allclose(x_t, x_j, atol=X_ATOL, rtol=X_RTOL)
    o_j, o_t = objective(G, b, lam1, lam2, x_j), \
        objective(G, b, lam1, lam2, x_t)
    gap = np.abs(o_t - o_j) / (np.abs(o_j) + 1e-6)
    assert gap.max() < OBJ_GAP, gap.max()
    if 'mask' in inputs:
        assert (x_t[inputs['mask'] == 0] == 0).all()
    if kw['refine_rounds'] > 0:
        assert (x_t >= 0).all()


def test_converge_exits_per_tile():
    """With an inexact CG budget (2 steps) every continuation round moves
    x, so the number of rounds a voxel runs shows in its result.  The
    Pallas kernel runs each tile's rounds until the whole tile is done;
    the twin does too (within 1e-5), and solving each voxel as a tile of
    its own (a per-voxel exit) lands further away than that."""
    kw = dict(fista_iters=0, refine_rounds=1, cg_iters=2, converge=2)
    G, b = problems(n=11)
    x_j = pallas(G, b, 0.0, 1e-3, **kw)
    x_t = twin(G, b, 0.0, 1e-3, **kw)
    assert np.abs(x_t - x_j).max() < 1e-5, np.abs(x_t - x_j).max()
    C, M, n = b.shape
    x_v = twin(np.repeat(G, M, axis=0), b.reshape(C * M, 1, n), 0.0, 1e-3,
               **kw).reshape(C, M, n)
    assert np.abs(x_v - x_j).max() > 1e-5, np.abs(x_v - x_j).max()


@pytest.mark.parametrize('name', ['DEFAULT_AS_SOLVER_KW',
                                  'DENSE_AS_SOLVER_KW'])
def test_solver_defaults_are_the_jax_packages(name):
    assert getattr(base, name) == getattr(jax_base, name)


def test_schedule_matches_the_pallas_kernel():
    kw = base.DEFAULT_AS_SOLVER_KW
    s = cuda_qp.qp_schedule(11, **{k: v for k, v in kw.items()
                                   if k != 'cd_sweeps'})
    # npad = 16 for n = 11: the Pallas kernel's budget and cap, not the
    # XLA path's (12, 33)
    assert (s.cont_cg, s.cont_rounds, s.polish) == (16, 48, 16)
    assert s.cg == kw['cg_iters'] and s.inner == (2,) * 12
    assert (s.fista, s.add_k) == (0, 1)
    s = cuda_qp.qp_schedule(21, fista_iters=80, refine_rounds=6, cg_iters=16,
                            converge=True)
    assert (s.cg, s.cont_cg, s.cont_rounds, s.fista) == ((16,) * 6, 24, 72,
                                                         80)
    s = cuda_qp.qp_schedule(12, refine_rounds=5, cg_iters=(3, 7),
                            converge=20)
    assert (s.cg, s.cont_cg, s.polish) == ((3, 7, 7, 7, 7), 20, 20)
    s = cuda_qp.qp_schedule(12, refine_rounds=2, cg_iters=(3, 7, 9))
    assert (s.cg, s.cont_cg, s.polish) == ((3, 7), 0, 9)
    assert cuda_qp.qp_schedule(12, refine_rounds=0).cg == ()
    with pytest.raises(ValueError, match='add_k'):
        cuda_qp.qp_schedule(12, add_k=0)
    with pytest.raises(ValueError, match='empty'):
        cuda_qp.qp_schedule(12, cg_iters=())


def test_kernel_schedule_packing():
    arr = cuda_qp._qp_sched_array(cuda_qp.qp_schedule(
        11, fista_iters=0, refine_rounds=12,
        cg_iters=(6, 6, 6, 10, 10, 10, 12), converge=True, add_k=2))
    assert list(arr[:7]) == [0, 12, 2, 2, 16, 16, 48]
    assert list(arr[7:19]) == [6, 6, 6, 10, 10, 10] + [12] * 6
    # a flat tail past the round array is packed; distinct budgets raise
    long_flat = cuda_qp.qp_schedule(11, refine_rounds=100, cg_iters=8)
    assert cuda_qp._qp_sched_array(long_flat)[1] == 100
    ramp = cuda_qp.qp_schedule(11, refine_rounds=40,
                               cg_iters=tuple(range(1, 41)))
    with pytest.raises(NotImplementedError, match='distinct'):
        cuda_qp._qp_sched_array(ramp)


def test_wrapper_takes_the_twin_on_cpu():
    G, b = problems(C=2, M=16, seed=4)
    G, b = torch.from_numpy(G), torch.from_numpy(b)
    before = nneg_qp_tiles.launches
    x = nneg_qp_tiles(G, b, None, 0.0, 1e-3, **base.DEFAULT_AS_SOLVER_KW)
    x_t = nneg_qp_tiles_torch(G, b, None, 0.0, 1e-3,
                              **base.DEFAULT_AS_SOLVER_KW)
    assert torch.equal(x, x_t)
    assert nneg_qp_tiles.launches == before       # no kernel ran
    assert x.shape == (2, 16, 21) and bool((x >= 0).all())


def test_wrapper_rejects_malformed_inputs():
    G, b = (torch.from_numpy(a) for a in problems(C=2, M=8, seed=1))
    with pytest.raises(ValueError, match='G'):
        nneg_qp_tiles(G[:, :-1], b)
    with pytest.raises(ValueError, match='mask'):
        nneg_qp_tiles(G, b, mask=torch.ones(2, 8, 20))
    with pytest.raises(TypeError):
        nneg_qp_tiles(G, b.double())
    with pytest.raises(ValueError, match='device'):
        nneg_qp_tiles(G, b.to('meta'))
