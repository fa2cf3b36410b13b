"""The port's NumPy tile engine (amico_tpu_torch.models.engine) against the
JAX package's: identical plans, tiling and chunking."""
import numpy as np
import pytest

from amico_tpu.models import engine as jax_engine
from amico_tpu_torch.models import engine as torch_engine


@pytest.mark.parametrize('n,ndirs,tile', [(0, 10, 8), (1, 5, 4),
                                          (300, 3, 128), (1000, 50, 32),
                                          (5000, 500, 128)])
def test_plans_identical(n, ndirs, tile):
    rng = np.random.RandomState(n + tile)
    lut_idx = rng.randint(0, ndirs, n)
    pj = jax_engine.build_tile_plan(lut_idx, tile)
    pt = torch_engine.build_tile_plan(lut_idx, tile)
    for field in ('perm', 'tile_dirs', 'valid'):
        a, b = getattr(pj, field), getattr(pt, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert np.array_equal(a, b), field
    assert (pj.n_voxels, pj.tile_size, pj.n_tiles) == \
        (pt.n_voxels, pt.tile_size, pt.n_tiles)
    y = rng.rand(n, 5).astype(np.float32)
    tj, tt = jax_engine.tile_voxels(pj, y), torch_engine.tile_voxels(pt, y)
    assert np.array_equal(tj, tt)
    assert np.array_equal(torch_engine.untile_voxels(pt, tt), y)
    assert np.array_equal(jax_engine.untile_voxels(pj, tj),
                          torch_engine.untile_voxels(pt, tt))


@pytest.mark.parametrize('n_tiles,chunk', [(1, 1), (7, 3), (64, 16),
                                           (100, 128)])
def test_chunks_identical(n_tiles, chunk):
    assert list(jax_engine.iter_tile_chunks(n_tiles, chunk)) == \
        list(torch_engine.iter_tile_chunks(n_tiles, chunk))
