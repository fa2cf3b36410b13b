"""A minimal NIfTI-1 writer and reader of the benchmark's own: single-file
``.nii`` (optionally gzipped), little-endian, float32 or uint8, voxel data
in the file's order (x fastest)."""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

_CODES = {np.dtype(np.uint8): (2, 8), np.dtype(np.float32): (16, 32)}
_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
           64: np.float64}


def header(dims: tuple, dtype, voxel_mm: float) -> bytes:
    """The 352 bytes before the voxel data: a NIfTI-1 header with an
    identity-scaled sform of ``voxel_mm`` and no extension."""
    code, bitpix = _CODES[np.dtype(dtype)]
    h = bytearray(352)
    struct.pack_into('<i', h, 0, 348)
    d = [len(dims)] + list(dims) + [1] * (7 - len(dims))
    struct.pack_into('<8h', h, 40, *d)
    struct.pack_into('<2h', h, 70, code, bitpix)
    pix = [1.0] + [voxel_mm] * 3 + [1.0] * 4
    struct.pack_into('<8f', h, 76, *pix)
    struct.pack_into('<f', h, 108, 352.0)          # vox_offset
    struct.pack_into('<2f', h, 112, 1.0, 0.0)      # scl_slope, scl_inter
    h[123] = 10                                     # mm, s
    struct.pack_into('<2h', h, 252, 0, 1)          # qform_code, sform_code
    for row in range(3):
        srow = [0.0] * 4
        srow[row] = voxel_mm
        struct.pack_into('<4f', h, 280 + 16 * row, *srow)
    h[344:348] = b'n+1\0'
    return bytes(h)


def write(path: str, data_file_order: np.ndarray, dims: tuple,
          voxel_mm: float) -> None:
    """Write ``data_file_order`` (any shape, C-contiguous in the file's
    order, x fastest: e.g. (T, Z, Y, X)) as an uncompressed ``.nii`` of
    ``dims`` (X, Y, Z[, T])."""
    a = np.ascontiguousarray(data_file_order)
    with open(path, 'wb') as f:
        f.write(header(dims, a.dtype, voxel_mm))
        a.tofile(f)
        # on disk before the window, so that no writeback of the inputs
        # runs inside it
        f.flush()
        os.fsync(f.fileno())


def read(path: str) -> np.ndarray:
    """The voxel data of a single-file NIfTI-1, as an (X, Y, Z[, T]) array
    in Fortran order, scaled by scl_slope and scl_inter when set."""
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rb') as f:
        raw = f.read()
    ndim = struct.unpack_from('<h', raw, 40)[0]
    dims = struct.unpack_from(f'<{ndim}h', raw, 42)
    code = struct.unpack_from('<h', raw, 70)[0]
    off = int(struct.unpack_from('<f', raw, 108)[0])
    slope, inter = struct.unpack_from('<2f', raw, 112)
    n = int(np.prod(dims))
    a = np.frombuffer(raw, _DTYPES[code], n, off).reshape(dims, order='F')
    if slope not in (0.0, 1.0) or inter != 0.0:
        a = a * slope + inter
    return a
