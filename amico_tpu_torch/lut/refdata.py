"""Copy of ``amico_tpu/lut/refdata.py`` for the port, which imports nothing of
``amico_tpu``.

Loaders for the reference AMICO binary data files.

The reference ships hemisphere direction sets and 181x181 quantizer hash
tables as raw binaries (``ndirs=N.bin``: N*3 float64; ``htable_ndirs=N.bin``:
32761 int16 -- read at reference amico/lut.pyx:47-91), plus a 500-dir
per-shell gradient table embedded in source (lut.pyx:390-891).  This module
makes all three available here so that kernels, LUT indices, and therefore
parameter maps reproduce upstream AMICO's exactly:

* ``highres_grad500.npy`` -- the embedded 500-dir gradient table, vendored
  as data (values from lut.pyx:390-891);
* ``ref_directions.npz`` -- ALL shipped direction sets + hash tables
  (ndirs 500..10000 step 500, 1, 32761; built by
  tests/data/make_ref_bundle.py from the upstream binaries), so every
  supported ndirs is bit-compatible with upstream out of the box;
* an AMICO ``directions/`` folder named by the
  ``AMICO_TPU_REFERENCE_DIRECTIONS`` environment variable (or an explicit
  ``path=``) takes precedence, in the upstream binary format -- useful to
  test against a different upstream version.

Validation (tests/test_refdata.py): the bundle is asserted bit-identical
to the shipped binaries at several ndirs, and our programmatic generators
reproduce the data (the hash-table generator matches ``htable_ndirs=500.bin``
bit-for-bit; the 32761-dir set is exactly the 1-degree grid with an
identity table).
"""
from __future__ import annotations

import os
import threading

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), 'data')

N_GRID = 32761  # 181 x 181 quantizer grid (lut.pyx:349-356)

_bundle = None
_bundle_lock = threading.Lock()


def _get_bundle():
    """The vendored npz, opened once (NpzFile decompresses lazily per key)."""
    global _bundle
    if _bundle is None:
        with _bundle_lock:
            if _bundle is None:
                _bundle = np.load(
                    os.path.join(_DATA_DIR, 'ref_directions.npz'))
    return _bundle


def reference_grad() -> np.ndarray:
    """The (500, 3) float64 per-shell gradient table the reference uses to
    synthesize every high-resolution kernel (lut.pyx:390-891)."""
    return np.load(os.path.join(_DATA_DIR, 'highres_grad500.npy'))


def _search_dir(path: str | None) -> str | None:
    if path is not None:
        return path
    return os.environ.get('AMICO_TPU_REFERENCE_DIRECTIONS')


def has_reference_directions(ndirs: int, path: str | None = None) -> bool:
    """True when the upstream direction set for ``ndirs`` is obtainable --
    present in a configured AMICO directions folder, or in the vendored
    bundle (every ndirs the reference ships)."""
    d = _search_dir(path)
    if d is not None and os.path.isfile(
            os.path.join(d, f'ndirs={ndirs}.bin')):
        return True
    return f'dirs_{ndirs}' in _get_bundle().files


def load_reference_directions(ndirs: int,
                              path: str | None = None) -> np.ndarray:
    """(ndirs, 3) float64 hemisphere direction set in the upstream binary
    layout (raw little-endian float64, C order; lut.pyx:65-66)."""
    d = _search_dir(path)
    fname = None if d is None else os.path.join(d, f'ndirs={ndirs}.bin')
    if fname is None or not os.path.isfile(fname):
        # vendored fallback: the configured folder (if any) may hold only a
        # subset of the upstream sets
        key = f'dirs_{ndirs}'
        bundle = _get_bundle()
        if key in bundle.files:
            return bundle[key]
        raise FileNotFoundError(
            f'No reference direction data for ndirs={ndirs} (not an '
            'upstream-shipped count): set AMICO_TPU_REFERENCE_DIRECTIONS '
            'to an AMICO "directions" folder holding it')
    arr = np.fromfile(fname, dtype=np.float64)
    if arr.size != ndirs * 3:
        raise ValueError(f'ndirs={ndirs}.bin holds {arr.size} float64 values, '
                         f'expected {ndirs * 3}')
    return arr.reshape(ndirs, 3)


def load_reference_hash_table(ndirs: int,
                              path: str | None = None) -> np.ndarray:
    """(32761,) int16 quantizer table in the upstream binary layout
    (raw little-endian int16; lut.pyx:89)."""
    d = _search_dir(path)
    fname = None if d is None else os.path.join(d, f'htable_ndirs={ndirs}.bin')
    if fname is None or not os.path.isfile(fname):
        key = f'htable_{ndirs}'
        bundle = _get_bundle()
        if key in bundle.files:
            return bundle[key]
        raise FileNotFoundError(
            f'No reference hash table for ndirs={ndirs} (not an '
            'upstream-shipped count): set AMICO_TPU_REFERENCE_DIRECTIONS '
            'to an AMICO "directions" folder holding it')
    ht = np.fromfile(fname, dtype=np.int16)
    if ht.size != N_GRID:
        raise ValueError(f'htable_ndirs={ndirs}.bin holds {ht.size} int16 '
                         f'values, expected {N_GRID}')
    return ht
