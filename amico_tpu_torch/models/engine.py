"""Voxel-tiling fit engine (NumPy; a copy of ``amico_tpu.models.engine``).

Voxels are bucketed by LUT direction index so that every tile of
``tile_size`` voxels shares one dictionary: the fused NODDI kernel then
keeps that tile's Gram matrices in shared memory for the whole solve.

Host-side (NumPy) responsibilities: sorting voxels by direction, padding
ragged buckets to tile multiples, and scattering results back.  The padding
is deterministic, so results do not depend on the chunking.  The module is
copied rather than imported because ``amico_tpu.models`` imports jax;
tests/test_torch_engine.py holds the two copies to identical plans.  The
TPU lane-width cost model (``auto_tile_size``) is not carried over.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TilePlan:
    """Deterministic voxel->tile assignment for one fit."""
    perm: np.ndarray        # (n_tiles * tile_size,) int32 indices into the
                            # voxel array; padding entries == n_voxels
    tile_dirs: np.ndarray   # (n_tiles,) int32 LUT direction per tile
    valid: np.ndarray       # (n_tiles, tile_size) bool, False on padding
    n_voxels: int
    tile_size: int

    @property
    def n_tiles(self) -> int:
        return self.tile_dirs.shape[0]


def build_tile_plan(lut_idx: np.ndarray, tile_size: int = 128) -> TilePlan:
    """Bucket voxels by LUT direction into fixed-size tiles.

    Voxels with the same direction index land in consecutive tiles; each
    bucket is padded up to a tile multiple.  Device-multiple padding for
    sharding happens at the chunk level (models/base.py), not here.  An
    empty voxel set still yields one fully-invalid tile so downstream
    shapes stay rank-stable.
    """
    lut_idx = np.asarray(lut_idx, np.int64)
    n = lut_idx.shape[0]
    order = np.argsort(lut_idx, kind='stable')
    sorted_dirs = lut_idx[order]
    uniq, counts = np.unique(sorted_dirs, return_counts=True)

    perm_parts, dir_parts, valid_parts = [], [], []
    start = 0
    for d, c in zip(uniq, counts):
        n_t = -(-c // tile_size)
        padded = n_t * tile_size
        block = np.full(padded, n, np.int64)
        block[:c] = order[start:start + c]
        perm_parts.append(block)
        dir_parts.append(np.full(n_t, d, np.int64))
        v = np.zeros(padded, bool)
        v[:c] = True
        valid_parts.append(v)
        start += c

    perm = np.concatenate(perm_parts) if perm_parts else np.zeros(0, np.int64)
    tile_dirs = np.concatenate(dir_parts) if dir_parts else np.zeros(0, np.int64)
    valid = np.concatenate(valid_parts) if valid_parts else np.zeros(0, bool)

    if tile_dirs.shape[0] == 0:
        perm = np.full(tile_size, n, np.int64)
        tile_dirs = np.zeros(1, np.int64)
        valid = np.zeros(tile_size, bool)

    return TilePlan(perm=perm.astype(np.int32),
                    tile_dirs=tile_dirs.astype(np.int32),
                    valid=valid.reshape(-1, tile_size),
                    n_voxels=n, tile_size=tile_size)


def tile_voxels(plan: TilePlan, y: np.ndarray, fill=0.0) -> np.ndarray:
    """(N, F) voxel array -> (n_tiles, tile_size, F) tiled array."""
    y = np.asarray(y)
    pad_row = np.full((1,) + y.shape[1:], fill, y.dtype)
    y_ext = np.concatenate([y, pad_row], axis=0)
    return y_ext[plan.perm].reshape(plan.n_tiles, plan.tile_size, *y.shape[1:])


def untile_voxels(plan: TilePlan, tiles: np.ndarray) -> np.ndarray:
    """Inverse of :func:`tile_voxels`: scatter tile results back to (N, ...)."""
    flat = np.asarray(tiles).reshape(plan.n_tiles * plan.tile_size,
                                     *np.asarray(tiles).shape[2:])
    out = np.zeros((plan.n_voxels,) + flat.shape[1:], flat.dtype)
    sel = plan.perm < plan.n_voxels
    out[plan.perm[sel]] = flat[sel]
    return out


def iter_tile_chunks(n_tiles: int, chunk: int):
    """Yield (start, stop, pad) spans covering all tiles in fixed-size chunks
    (the last chunk reports how many padding tiles the caller must add so
    every dispatch has an identical shape)."""
    for start in range(0, n_tiles, chunk):
        stop = min(start + chunk, n_tiles)
        yield start, stop, chunk - (stop - start)

