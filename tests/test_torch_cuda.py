"""The CUDA kernels (the fused NODDI solve K1, the tile QP K2, the build-cache
probe T1) against their plain PyTorch twins, both on the card, and the
kernels' launch counters; the stagewise solver on the card against the CPU,
and K2 against it on CylinderZeppelinBall tiles.  Every test needs a CUDA
card and skips without one; the module imports no JAX, so it also runs where
JAX is absent:

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


@pytest.mark.parametrize('C,M,exvivo', [(133, 50, False), (133, 50, True),
                                         (7, 33, True), (1, 1, False)])
def test_kernel_at_ragged_shapes(problem, C, M, exvivo):
    """Tile counts that are not a multiple of the blocks in flight (one a
    card's SM), tiles whose voxels are not a multiple of the warps a block
    (32), exvivo and want_x: the kernel against the twin at
    test_kernel_matches_twin's bounds, and the twin's map of every voxel
    it was handed."""
    from amico_tpu_torch.testing import fused_agreement
    args = _inputs(problem, 'full', exvivo, 4 * ((C + 3) // 4))
    args = [a[:C].contiguous() if a.dim() == 3 else a for a in args]
    args[2], args[3] = (args[2][:, :M].contiguous(),
                        args[3][:, :M].contiguous())
    out_k = noddi_fused_tiles(*args, want_x=True, is_exvivo=exvivo)
    out_t = noddi_fused_tiles_torch(*args, want_x=True, is_exvivo=exvivo)
    torch.cuda.synchronize()
    assert out_k[0].shape == (C, M, 4 if exvivo else 3)
    assert out_k[1].shape == (C, M, args[2].shape[-1])
    assert bool(torch.isfinite(out_k[0]).all())
    a = fused_agreement(args, out_k, out_t)
    assert a['map_median'] < 1e-5, a
    assert a['obj_gap_p99'] < 1e-3, a
    # at most one voxel of a small call may land on a worse vertex
    assert a['obj_share_worse'] * C * M <= max(1.0, 1e-3 * C * M), a


def test_kernel_takes_a2t_as_a_transposed_view(problem):
    """The model hands the stage-2 dictionary as the transposed view of its
    (C, ndwi, n_wm) tensor; the kernel reads it without a copy and gives
    what the contiguous A2T gives, bit for bit."""
    args = _inputs(problem, 'full', False, 8)
    view = list(args)
    view[4] = args[4].transpose(1, 2).contiguous().transpose(1, 2)
    assert not view[4].is_contiguous()
    for a, b in zip(noddi_fused_tiles(*args, want_x=True),
                    noddi_fused_tiles(*view, want_x=True)):
        assert torch.equal(a, b)


def test_launcher_raises_on_a_refused_launch(cuda):
    """A launch the card refuses (here: more shared memory than a block may
    take) raises from the shared launch path, naming the entry point, and
    counts nothing."""
    import ctypes
    from amico_tpu_torch.ops.cuda_build import Launcher
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    launch = Launcher('nneg_qp_launch', [vp] * 7 + [ci] * 3 + [cf, cf, vp])
    G, b = qp_problems(1, 160, M=4)
    x = torch.empty_like(b)
    sched = cuda_qp._qp_sched_array(cuda_qp.qp_schedule(160))
    before = nneg_qp_tiles.launches
    with pytest.raises(RuntimeError, match='kernel launch failed '
                                           r'\(nneg_qp_launch\)'):
        launch(b.device, G.data_ptr(), b.data_ptr(), None, None, None,
               x.data_ptr(), None, 1, 100_000, 160, 0.0, 0.0,
               sched.ctypes.data)
    assert nneg_qp_tiles.launches == before
    torch.cuda.synchronize()


# K1's general path (csrc/noddi_fused.cu GEN) on each route the JAX kernel
# has beyond the production schedule; chip_smoke.py's K1a phase at 16 tiles
_PROD = ((0, 4, (4, 6, 8, 10), 1, False, 2),
         (0, 6, (3, 5, 8, 10, 12, 14), (1, 1, 2, 2, 2, 2), False, 2),
         (6, (16, 10, 8, 8, 8, 8), 2))
K1_ROUTES = {
    'fista-stage1': dict(stage_iters=((40, 4, 8, 1),) + _PROD[1:]),
    'converge-stage1': dict(stage_iters=((0, 4, 8, 1, True),) + _PROD[1:]),
    'knobs': dict(stage_iters=((40, 8, 12, 2), (40, 8, 12, 2), (8, 12, 2))),
    'converge-stage2': dict(stage_iters=(_PROD[0], (0, 3, (3, 3, 4), 2, 24),
                                         _PROD[2])),
    'zero-round-stage1': dict(stage_iters=((0, 0, 8, 1),) + _PROD[1:]),
    'early-exit': dict(early_exit=True),
    'tiebreak': dict(tiebreak_cg=8),
    'want_tie': dict(want_tie=True),
}


def _neighbours(problem, grid):
    from amico_tpu_torch.models.noddi import _kappa_neighbours
    kernels = problem[1][grid][1]
    return _kappa_neighbours(kernels['icvf'], kernels['kappa'])


@pytest.mark.parametrize('route', list(K1_ROUTES))
def test_kernel_matches_twin_on_solver_routes(problem, route):
    """Each route, once a raise, against the twin on the card at K1's
    agreement bounds (test_kernel_matches_twin's); the tie score by a
    median gap < 1e-4."""
    from amico_tpu_torch.testing import fused_agreement
    args = _inputs(problem, 'full', False, 16)
    kw = dict(K1_ROUTES[route], want_x=True)
    if route == 'tiebreak':
        kw['nb_minus'], kw['nb_plus'] = _neighbours(problem, 'full')
    before = noddi_fused_tiles.launches
    out_k = noddi_fused_tiles(*args, **kw)
    out_t = noddi_fused_tiles_torch(*args, **kw)
    torch.cuda.synchronize()
    assert noddi_fused_tiles.launches == before + 1
    assert bool(torch.isfinite(out_k[0]).all())
    if route == 'want_tie':
        gap = (out_k[2] - out_t[2]).abs()
        assert float(gap.median()) < 1e-4, float(gap.median())
    a = fused_agreement(args, out_k[:2], out_t[:2])
    assert a['map_median'] < 1e-5 and a['map_p95'] < 5e-3, a
    assert a['obj_gap_p99'] < 1e-3 and a['obj_share_worse'] < 1e-3, a


@pytest.mark.parametrize('exvivo', [False, True])
def test_general_path_agrees_with_the_default(problem, exvivo):
    """The tie score sends the production schedule down the general path
    (voxel state in device memory between phases, lambda2 a run-time value
    on every stage), which runs the default path's operations: the maps
    and x at K1's agreement bounds (the compiler fuses multiplies and adds
    differently in the two, so the degenerate voxels may move)."""
    from amico_tpu_torch.testing import fused_agreement
    args = _inputs(problem, 'full', exvivo, 8)
    out = noddi_fused_tiles(*args, want_x=True, is_exvivo=exvivo)
    est_g, x_g, tie = noddi_fused_tiles(*args, want_x=True, want_tie=True,
                                        is_exvivo=exvivo)
    assert tie.shape == est_g.shape[:2] and bool(torch.isfinite(tie).all())
    a = fused_agreement(args, (est_g, x_g), out)
    assert a['map_median'] < 1e-5, a
    assert a['obj_gap_p99'] < 1e-3 and a['obj_share_worse'] < 1e-2, a


def test_kernel_rejects_what_it_does_not_take(problem):
    args = _inputs(problem, 'small', False, 2)
    with pytest.raises(ValueError, match='nb_minus'):
        noddi_fused_tiles(*args, tiebreak_cg=8, nb_minus=[0] * 5,
                          nb_plus=[0] * 5)
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
    from functools import partial
    from amico_tpu_torch.testing import (freewater_maps, freewater_tile_inputs,
                                         qp_agreement)
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
    a = qp_agreement(G, b, 0.0, lam2, x_k, x_t, maps=None if n_perp is None
                     else partial(freewater_maps, n_perp=n_perp))
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


@pytest.mark.parametrize('n,M,extra', [
    (n, M, extra) for n in (8, 9, 16, 17) for M in (1, 7, 33)
    for extra in (None, 'mask', 'warm')])
def test_nneg_qp_kernel_at_lane_group_edges(cuda, n, M, extra):
    """The kernel's lane-group edges (8 lanes a voxel up to n = 8, 16 up to
    16, a warp above) at ragged voxel counts, plain under the default
    schedule, with a mask, and with a warm start under a short schedule
    with `converge`: the kernel against the twin, both on the card, x
    within 2e-4 (+1e-3 relative) and the objective within 1e-4 relative,
    as test_nneg_qp_kernel_semantics."""
    from amico_tpu_torch.testing import qp_agreement
    G, b = qp_problems(5, n, M=M, seed=n + M)
    rng = np.random.RandomState(n * M)
    on = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa
    inputs, kw = {}, DEFAULT_AS_SOLVER_KW
    if extra == 'mask':
        inputs['mask'] = on(rng.rand(*b.shape) > 0.4)
    if extra == 'warm':
        inputs['m0'] = on(rng.rand(*b.shape) > 0.6)
        inputs['x0'] = on(rng.rand(*b.shape) * 0.1)
        kw = dict(fista_iters=0, refine_rounds=3, cg_iters=(3, 5),
                  converge=True)
    x_k = nneg_qp_tiles(G, b, None, 0.0, 1e-3, **inputs, **kw)
    x_t = nneg_qp_tiles_torch(G, b, None, 0.0, 1e-3, **inputs, **kw)
    torch.cuda.synchronize()
    if 'mask' in inputs:
        assert bool((x_k[inputs['mask'] == 0] == 0).all())
    assert qp_agreement(G, b, 0.0, 1e-3, x_k, x_t)['obj_gap_max'] < 1e-4
    torch.testing.assert_close(x_k, x_t, atol=2e-4, rtol=1e-3)


def test_nneg_qp_kernel_without_room_for_its_state(cuda):
    """At 160 atoms and 256 voxels a tile neither x nor b_eff fits beside G
    in shared memory: x stays in the output and b_eff is rebuilt from b
    each round (ops/cuda_qp.py:qp_geometry)."""
    from amico_tpu_torch.testing import qp_agreement
    G, b = qp_problems(3, 160, M=256, seed=2)
    assert cuda_qp.qp_geometry(160, 256, cuda_qp._max_smem(b.device)).state \
        == 0
    x_k = nneg_qp_tiles(G, b, None, 0.0, 4.0, **DENSE_AS_SOLVER_KW)
    x_t = nneg_qp_tiles_torch(G, b, None, 0.0, 4.0, **DENSE_AS_SOLVER_KW)
    torch.cuda.synchronize()
    assert qp_agreement(G, b, 0.0, 4.0, x_k, x_t)['obj_gap_max'] < 1e-4
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


def test_fit_chunks_on_two_streams_match_one(freewater, monkeypatch):
    """The tile driver sends its chunks round robin to two CUDA streams;
    on one stream the same fit writes the same maps, bit for bit."""
    from amico_tpu_torch.models import base
    from amico_tpu_torch.testing import freewater_voxels
    model, kernels, htable = freewater['Human']
    y, DIRs, _, _ = freewater_voxels(6000, kernels, htable, seed=4)

    class Ctx:
        def __init__(s):
            s.y, s.DIRs, s.htable, s.KERNELS = y, DIRs, htable, kernels

        def get_config(s, k):
            # 1,024-voxel chunks: several chunks on each stream
            return {'device': 'cuda', 'voxels_per_chunk': 1024}.get(k)

    assert len(base._chunk_streams(torch.device('cuda'))) == 2
    two = model.fit(Ctx())
    assert model._last_fit_timers['n_chunks'] >= 4
    monkeypatch.setattr(base, '_chunk_streams', lambda device: [None])
    one = model.fit(Ctx())
    assert np.array_equal(two['estimates'], one['estimates'])


def test_second_stream_waits_for_the_constants(freewater, monkeypatch):
    """The model's constants are queued on the current stream; the chunks
    sent to the second stream read them only once they are done.  Here the
    constants are poisoned and written back after a long sleep of the
    current stream: the two-stream maps still equal the one-stream ones."""
    from amico_tpu_torch.models import base
    from amico_tpu_torch.testing import freewater_voxels
    model, kernels, htable = freewater['Human']
    y, DIRs, _, _ = freewater_voxels(6000, kernels, htable, seed=4)
    prepare = model.prepare

    def late(*args):
        c = prepare(*args)
        kept = {k: v.clone() for k, v in c.items()}
        for v in c.values():
            v.fill_(float('nan'))
        torch.cuda._sleep(1 << 30)          # about half a second
        for k, v in c.items():
            v.copy_(kept[k])
        return c

    class Ctx:
        def __init__(s):
            s.y, s.DIRs, s.htable, s.KERNELS = y, DIRs, htable, kernels

        def get_config(s, k):
            return {'device': 'cuda', 'voxels_per_chunk': 1024}.get(k)

    monkeypatch.setattr(model, 'prepare', late)
    model._prep_cache = None            # built in this fit, not an earlier one
    two = model.fit(Ctx())
    assert model._last_fit_timers['n_chunks'] >= 2
    monkeypatch.setattr(base, '_chunk_streams', lambda device: [None])
    one = model.fit(Ctx())
    assert np.isfinite(one['estimates']).all()
    assert np.array_equal(two['estimates'], one['estimates'])


def test_device_untile_waits_for_its_chunk(freewater, monkeypatch):
    """Gathered on one card, each chunk's outputs are written in voxel order
    on the chunk's own stream, after its work, and copied to the host after
    the last chunk.  Here every chunk's outputs are poisoned, then written
    back after a long sleep of the chunk's stream: the two-stream maps
    still equal the one-stream ones.  Written on the current stream (which
    does not wait for the second), or pulled before the streams are done,
    they would hold the poison."""
    from amico_tpu_torch.models import base
    from amico_tpu_torch.testing import freewater_voxels
    model, kernels, htable = freewater['Human']
    y, DIRs, _, _ = freewater_voxels(6000, kernels, htable, seed=4)
    run = model._run_tiled_fit

    def late(evaluation, chunk_fn_for, *args):
        def late_for(device):
            fit_chunk = chunk_fn_for(device)

            def chunk(*a):
                res = fit_chunk(*a)
                kept = {k: v.clone() for k, v in res.items()}
                for v in res.values():
                    v.fill_(float('nan'))
                torch.cuda._sleep(1 << 28)
                for k, v in res.items():
                    v.copy_(kept[k])
                return res
            return chunk
        return run(evaluation, late_for, *args)

    class Ctx:
        def __init__(s):
            s.y, s.DIRs, s.htable, s.KERNELS = y, DIRs, htable, kernels

        def get_config(s, k):
            return {'device': 'cuda', 'voxels_per_chunk': 1024,
                    'doSaveCorrectedDWI': True}.get(k)

    monkeypatch.setattr(model, '_run_tiled_fit', late)
    two = model.fit(Ctx())
    assert model._last_fit_timers['n_chunks'] >= 2
    monkeypatch.setattr(base, '_chunk_streams', lambda device: [None])
    one = model.fit(Ctx())
    for k in one:
        assert np.isfinite(one[k]).all()
        assert np.array_equal(two[k], one[k]), k


def test_mesh_fit_matches_one_card(freewater):
    """make_mesh() over the visible cards: whole chunks go to the cards
    round robin, and the maps equal the one-card fit's bit for bit."""
    from amico_tpu_torch.parallel import make_mesh
    from amico_tpu_torch.testing import freewater_voxels
    model, kernels, htable = freewater['Human']
    y, DIRs, _, _ = freewater_voxels(6000, kernels, htable, seed=4)
    mesh = make_mesh()

    class Ctx:
        def __init__(s, mesh=None):
            s.y, s.DIRs, s.htable, s.KERNELS = y, DIRs, htable, kernels
            s.cfg = {'device': 'cuda', 'voxels_per_chunk': 1024,
                     'mesh': mesh}

        def get_config(s, k):
            return s.cfg.get(k)

    one = model.fit(Ctx())
    n_chunks = model._last_fit_timers['n_chunks']
    got = model.fit(Ctx(mesh))
    assert model._last_fit_devices == [
        torch.device('cuda', i) for i in range(min(mesh.size, n_chunks))]
    assert np.array_equal(got['estimates'], one['estimates'])


# --------------------------------------------------- T1: build-cache probe
@pytest.mark.parametrize('shape', [(8, 128), (1,), (1_000_003,), (3, 5, 7)])
def test_loc_probe_matches_twin_bit_for_bit(cuda, shape):
    from amico_tpu_torch.ops.loc_probe import loc_probe, loc_probe_torch
    x = torch.randn(shape, device='cuda') * 1e3
    before = loc_probe.launches
    o = loc_probe(x)
    torch.cuda.synchronize()
    assert torch.equal(o, loc_probe_torch(x))
    assert loc_probe.launches == before + 1


def test_loc_probe_unaligned_buffers(cuda):
    """Buffers that are not 16 bytes aligned take the scalar path."""
    from amico_tpu_torch.ops.loc_probe import loc_probe, loc_probe_torch
    base = torch.randn(1_000_007, device='cuda') * 1e3
    for offset in (1, 2, 3):
        x = base[offset:]
        assert x.data_ptr() % 16 != 0
        assert torch.equal(loc_probe(x), loc_probe_torch(x))


def test_loc_probe_launch_counter_and_rejects(cuda):
    from amico_tpu_torch.ops.loc_probe import loc_probe, loc_probe_torch
    before = loc_probe.launches
    assert loc_probe(torch.empty(0, device='cuda')).shape == (0,)  # no launch
    loc_probe(torch.ones(4))                          # the CPU route
    loc_probe_torch(torch.ones(4, device='cuda'))     # the twin
    with pytest.raises(TypeError, match='float32'):
        loc_probe(torch.ones(4, device='cuda', dtype=torch.float64))
    with pytest.raises(ValueError, match='contiguous'):
        loc_probe(torch.ones(4, 6, device='cuda').t())
    assert loc_probe.launches == before


def test_loc_experiment_is_call_site_stable(cuda):
    from amico_tpu_torch.tools import loc_experiment
    rows = loc_experiment.probe()
    assert [r['desc'] for r in rows] == ['in-process',
                                         'other process, other cwd']
    assert all(r['stable'] for r in rows) and rows[1]['reused']
    assert all(loc_experiment.line(r).split()[-1 if not r['note'] else -3]
               == 'STABLE' for r in rows)


# ------------------------------------- the stagewise solver, on the card
def stagewise_problems(T=16, M=128, m=40, n=21, seed=0):
    """Non-negative mixtures, each tile with its own dictionary: G (T, 1,
    n, n), b (T, M, n), float32 on the card."""
    rng = np.random.RandomState(seed)
    A = np.abs(rng.randn(T, m, n))
    X = rng.rand(T, M, n) * (rng.rand(T, M, n) < 0.4)
    Y = np.einsum('tmn,tbn->tbm', A, X) + 0.01 * rng.randn(T, M, m)
    G = np.einsum('tmi,tmj->tij', A, A)[:, None]
    b = np.einsum('tmi,tbm->tbi', A, Y)
    return (torch.from_numpy(G.astype(np.float32)).cuda(),
            torch.from_numpy(b.astype(np.float32)).cuda())


STAGEWISE_CASES = {
    'default': (1e-3, DEFAULT_AS_SOLVER_KW),
    'dense': (4.0, DENSE_AS_SOLVER_KW),
    'flat-early-exit': (1e-3, dict(fista_iters=40, cd_sweeps=4,
                                   refine_rounds=12, cg_iters=12)),
}


@pytest.mark.parametrize('case', list(STAGEWISE_CASES))
def test_nneg_qp_batch_on_cuda_matches_cpu(cuda, case):
    """The same float32 solve on the card and on the CPU: the objective
    within 1e-5 relative and x within 1e-3 (another summation order)."""
    from amico_tpu_torch.ops.solvers import nneg_qp_batch
    from amico_tpu_torch.testing import qp_agreement
    lam2, kw = STAGEWISE_CASES[case]
    G, b = stagewise_problems()
    x_g = nneg_qp_batch(G, b, 0.0, lam2, **kw)
    x_c = nneg_qp_batch(G.cpu(), b.cpu(), 0.0, lam2, **kw)
    assert x_g.device.type == 'cuda' and bool((x_g >= 0).all())
    a = qp_agreement(G[:, 0].cpu(), b.cpu(), 0.0, lam2, x_g.cpu(), x_c)
    assert a['obj_gap_max'] < 1e-5, a
    assert a['x_max'] < 1e-3, a


@pytest.mark.parametrize('case', list(STAGEWISE_CASES))
def test_nneg_qp_batch_exit_read_interval_on_cuda(cuda, monkeypatch, case):
    """On the card the exit flags are read every few iterations; reading
    them every iteration gives the same x bit for bit."""
    from amico_tpu_torch.ops import solvers
    lam2, kw = STAGEWISE_CASES[case]
    G, b = stagewise_problems(seed=1)
    x_sparse = solvers.nneg_qp_batch(G, b, 0.0, lam2, **kw)
    monkeypatch.setattr(solvers, '_exit_check', lambda x, i: True)
    x_every = solvers.nneg_qp_batch(G, b, 0.0, lam2, **kw)
    assert torch.equal(x_sparse, x_every)


# ------------------------------- CylinderZeppelinBall: K2 vs stagewise
@pytest.fixture(scope='module')
def czb(cuda, tmp_path_factory):
    d = tmp_path_factory.mktemp('cuda_czb')
    os.environ['AMICO_TPU_HOME'] = str(d / 'home')
    from amico_tpu_torch.testing import czb_scheme, demo_czb
    return demo_czb(czb_scheme(), str(d / 'k'))


def test_k2_matches_stagewise_on_czb_tiles(czb):
    """chip_smoke.py's CZB comparison at 64 tiles, at its bounds: v and a
    by median, p95 and max, and the objective both ways and one way."""
    from amico_tpu_torch.models.cylinder_zeppelin_ball import czb_estimates
    from amico_tpu_torch.ops.solvers import nneg_qp_batch
    from amico_tpu_torch.testing import czb_tile_inputs, qp_agreement
    model, kernels, htable = czb
    G, b, L = czb_tile_inputs(model, kernels, htable, 'cuda', 64, seed=3)
    x_k = nneg_qp_tiles(G, b, None, 0.0, 4.0, **DENSE_AS_SOLVER_KW)
    x_s = nneg_qp_batch(G[:, None], b, 0.0, 4.0, L=L[:, None],
                        **DENSE_AS_SOLVER_KW)
    torch.cuda.synchronize()
    Rs = torch.as_tensor(model.Rs, dtype=torch.float32, device='cuda')
    a = qp_agreement(G, b, 0.0, 4.0, x_k, x_s,
                     maps=lambda x: czb_estimates(x, Rs, 4)[..., :2])
    for i, bounds in enumerate(((1e-5, 1e-4, 1e-3), (1e-4, 1e-3, 1e-2))):
        got = (a['map_medians'][i], a['map_p95s'][i], a['map_maxs'][i])
        assert all(g < bd for g, bd in zip(got, bounds)), a
    assert a['obj_gap_p99'] < 1e-5 and a['obj_share_worse'] < 1e-3, a


def test_czb_fit_on_cuda_both_backends(czb):
    """'xla' runs the stagewise solver (no kernel launch), 'pallas' K2, and
    'auto' resolves to K2 on the card; their maps agree."""
    from amico_tpu_torch.testing import czb_voxels
    model, kernels, htable = czb
    y, DIRs, _, _ = czb_voxels(2000, kernels, htable, seed=9)

    class Ctx:
        def __init__(s):
            s.y, s.DIRs, s.htable, s.KERNELS = y, DIRs, htable, kernels

        def get_config(s, k):
            return {'device': 'cuda'}.get(k)

    est = {}
    for backend in ('xla', 'pallas', 'auto'):
        model.set_solver(backend=backend)
        before = nneg_qp_tiles.launches
        est[backend] = model.fit(Ctx())['estimates']
        launched = nneg_qp_tiles.launches - before
        assert (launched > 0) == (backend != 'xla')
        assert est[backend].shape == (2000, 3)
        assert np.isfinite(est[backend]).all()
    model.set_solver()
    assert np.array_equal(est['auto'], est['pallas'])
    d = np.abs(est['xla'] - est['pallas'])
    assert np.median(d[:, 0]) < 1e-5 and d[:, 0].max() < 1e-3
    assert np.median(d[:, 1]) < 1e-4 and d[:, 1].max() < 1e-2
