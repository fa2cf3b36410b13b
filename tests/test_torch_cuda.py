"""The CUDA kernels (the fused NODDI solve K1, the tile QP K2) against their
plain PyTorch twins, both on the card, and the kernels' launch counters.  Every test needs a CUDA card and
skips without one; the module imports no JAX, so it also runs where JAX is
absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from amico_tpu_torch.models import NODDI
from amico_tpu_torch.models.base import (DEFAULT_AS_SOLVER_KW,
                                         DENSE_AS_SOLVER_KW)
from amico_tpu_torch.ops import cuda_qp
from amico_tpu_torch.ops.cuda_qp import (nneg_qp_tiles, nneg_qp_tiles_torch,
                                         noddi_fused_tiles,
                                         noddi_fused_tiles_torch)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope='module')
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (torch.cuda.is_available() is false)')
    from amico_tpu_torch.device import resolve_device
    return resolve_device('cuda')


@pytest.fixture(scope='module')
def problem(cuda, tmp_path_factory):
    d = tmp_path_factory.mktemp('cuda')
    os.environ['AMICO_TPU_HOME'] = str(d / 'home')
    from amico_tpu_torch.testing import demo_noddi, demo_scheme
    scheme = demo_scheme()
    small = demo_noddi(scheme, small=True, kernels_dir=str(d / 'ks'))
    full = demo_noddi(scheme, small=False, kernels_dir=str(d / 'kf'))
    return scheme, {'small': small, 'full': full}


def _inputs(problem, grid, exvivo, n_tiles):
    from amico_tpu_torch.testing import noddi_tile_inputs
    scheme, dicts = problem
    model, kernels, htable = dicts[grid]
    m = NODDI()
    m.set(isExvivo=exvivo, **({} if grid == 'full' else dict(
        IC_VFs=model.IC_VFs, IC_ODs=model.IC_ODs)))
    m.scheme = scheme
    return noddi_tile_inputs(m, kernels, htable, 'cuda', n_tiles, seed=2)


@pytest.mark.parametrize('grid,exvivo', [('small', False), ('small', True),
                                         ('full', False), ('full', True)])
def test_kernel_matches_twin(problem, grid, exvivo):
    """Same float32 math, different summation order: maps by median (and,
    in vivo, p95), coefficients by stage-3 objective, both ways and one way
    (chip_smoke.py's criteria and reasons)."""
    from amico_tpu_torch.testing import fused_agreement
    args = _inputs(problem, grid, exvivo, 64)
    out_k = noddi_fused_tiles(*args, want_x=True, is_exvivo=exvivo)
    out_t = noddi_fused_tiles_torch(*args, want_x=True, is_exvivo=exvivo)
    torch.cuda.synchronize()
    assert out_k[0].shape == out_t[0].shape and out_k[1].shape == out_t[1].shape
    assert bool(torch.isfinite(out_k[0]).all())
    a = fused_agreement(args, out_k, out_t)
    assert a['map_median'] < 1e-5, a
    if not exvivo:
        assert a['map_p95'] < 5e-3, a
    assert a['obj_gap_p99'] < 1e-3, a
    assert a['obj_share_worse'] < 1e-3, a


def test_launch_counter_counts_kernel_launches(problem):
    args = _inputs(problem, 'small', False, 4)
    before = noddi_fused_tiles.launches
    noddi_fused_tiles(*args)
    noddi_fused_tiles(*args, want_x=True)
    assert noddi_fused_tiles.launches == before + 2
    noddi_fused_tiles_torch(*args)                   # the twin counts nothing
    noddi_fused_tiles(*[a.cpu() for a in args])      # nor the CPU route
    empty = noddi_fused_tiles(*[a[:0] if a.dim() == 3 else a for a in args])
    assert empty.shape == (0, 128, 3)                 # nor an empty call
    assert noddi_fused_tiles.launches == before + 2


def test_model_fit_on_cuda_launches_the_kernel(problem):
    from amico_tpu_torch.testing import demo_voxels
    scheme, dicts = problem
    model, kernels, htable = dicts['small']
    y, DIRs, _ = demo_voxels(2000, kernels, htable, seed=9)

    class Ctx:
        def __init__(s):
            s.y, s.DIRs, s.htable, s.KERNELS = y, DIRs, htable, kernels

        def get_config(s, k):
            return {'device': 'cuda'}.get(k)

    before = noddi_fused_tiles.launches
    res = model.fit(Ctx())
    assert noddi_fused_tiles.launches > before
    est = res['estimates']
    assert est.shape == (2000, 3) and np.isfinite(est).all()
    assert ((est >= 0) & (est <= 1)).all()


def test_kernel_rejects_what_it_does_not_take(problem):
    args = _inputs(problem, 'small', False, 2)
    with pytest.raises(NotImplementedError, match='FISTA'):
        noddi_fused_tiles(*args, stage_iters=((40, 4, 8, 1),
                                              (0, 6, 8, 1), (6, 8, 2)))
    with pytest.raises(NotImplementedError, match='converge'):
        noddi_fused_tiles(*args, stage_iters=((0, 4, 8, 1, True),
                                              (0, 6, 8, 1), (6, 8, 2)))
    with pytest.raises(NotImplementedError, match='tie-break'):
        noddi_fused_tiles(*args, tiebreak_cg=8)
    with pytest.raises(NotImplementedError, match='want_tie'):
        noddi_fused_tiles(*args, want_tie=True)
    strided = list(args)
    strided[2] = args[2].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match='contiguous'):
        noddi_fused_tiles(*strided)
    wide = [torch.zeros((1, 170, 170), device='cuda'),
            torch.zeros((1, 12, 12), device='cuda'),
            torch.zeros((1, 4, 170), device='cuda'),
            torch.zeros((1, 4, 8), device='cuda'),
            torch.zeros((1, 12, 8), device='cuda'),
            torch.zeros(8, device='cuda'), torch.zeros(12, device='cuda'),
            torch.zeros(12, device='cuda')]
    with pytest.raises(NotImplementedError, match='at most'):
        noddi_fused_tiles(*wide)
    assert cuda_qp.MAX_ATOMS == 160


# ------------------------------------------------------------ K2: tile QP
def qp_problems(C, n, M=128, seed=0):
    """tests/test_pallas_qp.py's random problems, on the card."""
    from amico_tpu_torch.testing import random_qp_problems
    G, b = random_qp_problems(C, n, M=M, seed=seed)
    return torch.from_numpy(G).cuda(), torch.from_numpy(b).cuda()


@pytest.fixture(scope='module')
def freewater(cuda, tmp_path_factory):
    d = tmp_path_factory.mktemp('cuda_fw')
    os.environ['AMICO_TPU_HOME'] = str(d / 'home')
    from amico_tpu_torch.testing import demo_freewater, demo_scheme
    scheme = demo_scheme(nb0=9, shells=(700.0, 2000.0), ndir=(30, 60))
    return {t: demo_freewater(scheme, t, str(d / t)) for t in ('Human',
                                                              'Mouse')}


@pytest.mark.parametrize('case', ['Human', 'Mouse', 'dense'])
def test_nneg_qp_kernel_matches_twin(freewater, case):
    """chip_smoke.py's three cases at 64 tiles, at its bounds: FreeWater
    maps (or, on the random problems, x) by median, p95 and max, and the
    objective both ways and one way."""
    from amico_tpu_torch.testing import freewater_tile_inputs, qp_agreement
    if case == 'dense':
        (G, b), lam2, kw, n_perp = qp_problems(64, 21), 4.0, \
            DENSE_AS_SOLVER_KW, None
        bounds = (1e-5, 2e-4, 2e-4)
    else:
        model, kernels, htable = freewater[case]
        G, b = freewater_tile_inputs(model, kernels, htable, 'cuda', 64,
                                     seed=3)
        lam2, kw, n_perp = 1e-3, DEFAULT_AS_SOLVER_KW, kernels['D'].shape[0]
        # Mouse's map median floor is 1.5e-5 under any change of summation
        # order (chip_smoke.py QP_BOUNDS)
        bounds = (1e-5, 1e-3, 5e-3) if case == 'Human' else (3e-5, 5e-3,
                                                             2e-2)
    x_k = nneg_qp_tiles(G, b, None, 0.0, lam2, **kw)
    x_t = nneg_qp_tiles_torch(G, b, None, 0.0, lam2, **kw)
    torch.cuda.synchronize()
    assert x_k.shape == b.shape and bool(torch.isfinite(x_k).all())
    assert bool((x_k >= 0).all())
    a = qp_agreement(G, b, 0.0, lam2, x_k, x_t, n_perp=n_perp)
    key = 'x' if n_perp is None else 'map'
    assert a[f'{key}_median'] < bounds[0], a
    assert a[f'{key}_p95'] < bounds[1], a
    assert a[f'{key}_max'] < bounds[2], a
    assert a['obj_gap_p99'] < 1e-3, a
    assert a['obj_share_worse'] < 1e-3, a


# every semantic of the kernel on small random problems: (n, lam1, lam2,
# inputs, solver kwargs); n = 40 and 150 run the 2- and 5-coefficient lanes
QP_SEMANTICS = {
    'fista-flat': (21, 0.5, 1e-3, None,
                   dict(fista_iters=40, refine_rounds=8, cg_iters=16)),
    'mask': (21, 0.0, 0.0, 'mask',
             dict(fista_iters=40, refine_rounds=8, cg_iters=16)),
    'warm': (21, 0.0, 1e-3, 'warm',
             dict(fista_iters=40, refine_rounds=2, cg_iters=16,
                  converge=True)),
    'warm-x0-none': (21, 0.0, 1e-3, 'm0',
                     dict(refine_rounds=3, cg_iters=12)),
    'short-converge': (11, 0.0, 1e-3, None,
                       dict(fista_iters=0, refine_rounds=2, cg_iters=(3, 5),
                            converge=True)),
    'inexact-converge': (11, 0.0, 1e-3, None,
                         dict(fista_iters=0, refine_rounds=1, cg_iters=2,
                              converge=2)),
    'add_k2': (21, 0.0, 1e-3, None,
               dict(fista_iters=0, refine_rounds=3, cg_iters=6,
                    converge=True, add_k=2)),
    'fista-only': (21, 0.0, 1e-3, None,
                   dict(fista_iters=30, refine_rounds=0, cg_iters=16)),
    'long-flat': (21, 0.0, 1e-3, None,
                  dict(fista_iters=0, refine_rounds=40, cg_iters=12)),
    'n40': (40, 0.0, 1e-3, None, DEFAULT_AS_SOLVER_KW),
    'n150': (150, 0.0, 4.0, None, DENSE_AS_SOLVER_KW),
}


@pytest.mark.parametrize('case', list(QP_SEMANTICS))
def test_nneg_qp_kernel_semantics(cuda, case):
    """The kernel against the twin, both on the card, on each semantic the
    JAX kernel has: x within 2e-4 (+1e-3 relative), as
    tests/test_pallas_qp.py, except where CG is cut short on purpose
    ('inexact-converge', 'fista-only'), where the summation order shows
    more, and the objective within 1e-4 relative."""
    from amico_tpu_torch.testing import qp_agreement
    n, lam1, lam2, extra, kw = QP_SEMANTICS[case]
    G, b = qp_problems(6, n, seed=1)
    rng = np.random.RandomState(5)
    inputs = {}
    if extra == 'mask':
        inputs['mask'] = torch.from_numpy(
            (rng.rand(*b.shape) > 0.4).astype(np.float32)).cuda()
    if extra in ('warm', 'm0'):
        inputs['m0'] = torch.from_numpy(
            (rng.rand(*b.shape) > 0.6).astype(np.float32)).cuda()
    if extra == 'warm':
        inputs['x0'] = torch.from_numpy(
            (rng.rand(*b.shape) * 0.1).astype(np.float32)).cuda()
    x_k = nneg_qp_tiles(G, b, None, lam1, lam2, **inputs, **kw)
    x_t = nneg_qp_tiles_torch(G, b, None, lam1, lam2, **inputs, **kw)
    torch.cuda.synchronize()
    if 'mask' in inputs:
        assert bool((x_k[inputs['mask'] == 0] == 0).all())
    a = qp_agreement(G, b, lam1, lam2, x_k, x_t)
    assert a['obj_gap_max'] < 1e-4, a
    if case not in ('inexact-converge', 'fista-only'):
        torch.testing.assert_close(x_k, x_t, atol=2e-4, rtol=1e-3)


def test_nneg_qp_launch_counter(cuda):
    G, b = qp_problems(2, 11, M=16)
    before = nneg_qp_tiles.launches
    nneg_qp_tiles(G, b, None, 0.0, 1e-3, **DEFAULT_AS_SOLVER_KW)
    nneg_qp_tiles(G, b, None, 0.0, 4.0, **DENSE_AS_SOLVER_KW)
    assert nneg_qp_tiles.launches == before + 2
    nneg_qp_tiles_torch(G, b)                         # the twin counts nothing
    nneg_qp_tiles(G.cpu(), b.cpu())                   # nor the CPU route
    assert nneg_qp_tiles(G[:0], b[:0]).shape == (0, 16, 11)   # nor empty
    assert nneg_qp_tiles.launches == before + 2


def test_nneg_qp_rejects_what_it_does_not_take(cuda):
    before = nneg_qp_tiles.launches
    G, b = qp_problems(1, 161, M=4)
    with pytest.raises(NotImplementedError, match='at most 160'):
        nneg_qp_tiles(G, b)
    G, b = qp_problems(1, 11, M=4)
    with pytest.raises(ValueError, match='0/1 mask'):
        nneg_qp_tiles(G, b, mask=torch.full_like(b, 0.5))
    with pytest.raises(NotImplementedError, match='distinct'):
        nneg_qp_tiles(G, b, refine_rounds=40, cg_iters=tuple(range(1, 41)))
    with pytest.raises(ValueError, match='contiguous'):
        nneg_qp_tiles(G, b.transpose(1, 2).contiguous().transpose(1, 2))
    assert nneg_qp_tiles.launches == before
    assert cuda_qp.QP_MAX_ATOMS == 160


def test_freewater_fit_on_cuda_launches_the_kernel(freewater):
    from amico_tpu_torch.testing import freewater_voxels
    model, kernels, htable = freewater['Mouse']
    y, DIRs, _, _ = freewater_voxels(2000, kernels, htable, seed=9)

    class Ctx:
        def __init__(s):
            s.y, s.DIRs, s.htable, s.KERNELS = y, DIRs, htable, kernels

        def get_config(s, k):
            return {'device': 'cuda', 'doSaveCorrectedDWI': True}.get(k)

    before = nneg_qp_tiles.launches
    res = model.fit(Ctx())
    assert nneg_qp_tiles.launches > before
    est = res['estimates']
    assert est.shape == (2000, 4) and np.isfinite(est).all()
    assert ((est >= 0) & (est <= 1)).all()
    assert res['y_corrected'].shape == y.shape
    assert (res['y_corrected'] >= 0).all()
