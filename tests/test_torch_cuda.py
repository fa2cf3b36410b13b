"""The fused NODDI CUDA kernel against its plain PyTorch twin, both on the
card, and the kernel's launch counter.  Every test needs a CUDA card and
skips without one; the module imports no JAX, so it also runs where JAX is
absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from amico_tpu_torch.models import NODDI
from amico_tpu_torch.ops import cuda_qp
from amico_tpu_torch.ops.cuda_qp import (noddi_fused_tiles,
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
