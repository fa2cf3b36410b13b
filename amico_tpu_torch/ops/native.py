"""Copy of ``amico_tpu/ops/native.py`` for the port, which imports nothing of
``amico_tpu``; only the library's build differs.

Exact active-set solvers: ctypes bindings + pure-NumPy fallback.

Native counterpart of the reference's SPAMS C++ dependency
(reference amico/models.pyx:18; cyspams interfaces).  The library is
the port's copy of the host source, ``amico_tpu_torch/native/
amico_native.cpp``, compiled with g++ at first use into
``build/amico_tpu_torch_native/<hash>/libamico_native.so`` beside the
package (the hash covers the source and the flags, so an unchanged checkout
reuses its build).  Without a compiler, a pure-NumPy Lawson-Hanson
implementation (exact, slower) takes its place -- so the package works on
toolchain-free machines.  Force it with ``AMICO_TPU_NO_NATIVE=1``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, 'native', 'amico_native.cpp')
_BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), 'build',
                           'amico_tpu_torch_native')
# native/Makefile's flags
_CXXFLAGS = ['-O3', '-fPIC', '-std=c++17', '-Wall', '-pthread']

_lib = None
_load_error = None


def _load():
    global _lib, _load_error
    if _lib is not None:
        return _lib
    if _load_error is not None:
        # cache the failure: re-spawning a failing `make` (or re-probing a
        # corrupt .so) on EVERY solver call would cost milliseconds per
        # call and distort any timing that runs on the fallback path
        raise RuntimeError(_load_error)
    try:
        _lib = _load_uncached()
        return _lib
    except Exception as e:
        _load_error = str(e)
        raise RuntimeError(_load_error) from e


def _load_uncached():
    if os.environ.get('AMICO_TPU_NO_NATIVE') == '1':
        raise RuntimeError('native solvers disabled via AMICO_TPU_NO_NATIVE')
    path = _build()
    # OSError here (truncated/wrong-arch .so) is caught by _load and
    # cached as a failure -> the NumPy fallback engages
    lib = ctypes.CDLL(path)
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.amico_qp_nonneg.argtypes = [dptr, dptr, ctypes.c_int, dptr]
    lib.amico_qp_nonneg.restype = ctypes.c_int
    lib.amico_nnls.argtypes = [dptr, dptr, ctypes.c_int, ctypes.c_int, dptr, dptr]
    lib.amico_nnls.restype = ctypes.c_int
    lib.amico_lasso.argtypes = [dptr, dptr, ctypes.c_int, ctypes.c_int, dptr,
                                ctypes.c_double, ctypes.c_double]
    lib.amico_lasso.restype = ctypes.c_int
    lib.amico_lasso_lars.argtypes = [dptr, dptr, ctypes.c_int, ctypes.c_int,
                                     dptr, ctypes.c_double, ctypes.c_double]
    lib.amico_lasso_lars.restype = ctypes.c_int
    lib.amico_qp_lars_nonneg.argtypes = [dptr, dptr, ctypes.c_int,
                                         ctypes.c_double, dptr]
    lib.amico_qp_lars_nonneg.restype = ctypes.c_int
    fptr = ctypes.POINTER(ctypes.c_float)
    iptr = ctypes.POINTER(ctypes.c_int)
    llptr = ctypes.POINTER(ctypes.c_longlong)
    try:
        lib.amico_preprocess_dwi.argtypes = [
            fptr, ctypes.c_longlong, ctypes.c_int, iptr, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_double,
            ctypes.c_int, ctypes.c_float, ctypes.c_int,
            fptr, fptr, dptr, llptr, llptr, ctypes.c_int]
        lib.amico_preprocess_dwi.restype = ctypes.c_int
    except AttributeError:  # stale prebuilt .so without the symbol
        lib.amico_preprocess_dwi = None
    try:
        lib.amico_masked_gather.argtypes = [
            fptr, ctypes.c_longlong, ctypes.c_int, llptr, ctypes.c_longlong,
            fptr, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.amico_masked_gather.restype = ctypes.c_int
    except AttributeError:  # stale prebuilt .so without the symbol
        lib.amico_masked_gather = None
    return lib


def _build() -> str:
    """Compile the source unless this hash is already built; return the
    library's path."""
    h = hashlib.sha256(' '.join(_CXXFLAGS).encode())
    with open(_SRC, 'rb') as f:
        h.update(f.read())
    path = os.path.join(_BUILD_ROOT, h.hexdigest()[:16], 'libamico_native.so')
    if os.path.isfile(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    try:
        subprocess.run(['g++'] + _CXXFLAGS + ['-shared', '-o', tmp, _SRC],
                       check=True, capture_output=True)
    except Exception as e:  # pragma: no cover
        raise RuntimeError(f'cannot build libamico_native.so: {e}') from e
    os.replace(tmp, path)       # atomic: a concurrent loader never sees half
    return path


def available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


# ------------------------------------------------------------------------
# pure-NumPy fallback: classic Lawson-Hanson on the normal equations --
# the same algorithm amico_native.cpp implements (exact solves on the
# working set, full anti-cycling removal loop)
# ------------------------------------------------------------------------
def _qp_nonneg_py(G: np.ndarray, b: np.ndarray,
                  max_iter: int | None = None) -> np.ndarray:
    n = b.shape[0]
    max_iter = max_iter or 30 * n
    x = np.zeros(n)
    P = np.zeros(n, bool)              # working set
    w = b.copy()                       # negative gradient at x=0
    tol = 1e-11 * (np.abs(b).max() + 1.0)
    for _ in range(max_iter):
        w_free = np.where(~P, w, -np.inf)
        j = int(np.argmax(w_free))
        if w_free[j] <= tol:
            break
        P[j] = True
        while True:
            idx = np.where(P)[0]
            # same tiny ridge as the C++ solver: a singular working-set
            # Gram (duplicated atoms) must not crash or emit garbage
            z = np.linalg.solve(
                G[np.ix_(idx, idx)] + 1e-13 * np.eye(idx.size), b[idx])
            if (z > 0).all():
                x[:] = 0.0
                x[idx] = z
                break
            # step back to the feasible boundary, drop offending atoms
            neg = z <= 0
            alpha = np.min(x[idx][neg] / (x[idx][neg] - z[neg] + 1e-300))
            x[idx] = x[idx] + alpha * (z - x[idx])
            P[idx[x[idx] <= tol]] = False
            x[x <= tol] = 0.0
        w = b - G @ x
    else:
        # same failure contract as the native wrapper (rc=-1 -> raise):
        # silently returning a non-converged x would feed wrong
        # coefficients downstream as if they were exact
        raise RuntimeError('NNLS (NumPy fallback) did not converge')
    return x


def _nnls_py(A, y):
    G = A.T @ A
    x = _qp_nonneg_py(G, A.T @ y)
    return x, float(np.linalg.norm(y - A @ x))


def _lasso_py(A, y, lambda1, lambda2):
    G = A.T @ A + lambda2 * np.eye(A.shape[1])
    return _qp_nonneg_py(G, A.T @ y - lambda1)


def _qp_lars_nonneg_py(G: np.ndarray, b: np.ndarray,
                       lambda1: float) -> np.ndarray:
    """NumPy mirror of amico_qp_lars_nonneg (LARS/homotopy path for the
    non-negative elastic net on ridge-folded normal equations; the
    algorithm SPAMS runs for the reference lasso calls,
    reference amico/models.pyx:615,926,1238,1569)."""
    n = b.shape[0]
    x = np.zeros(n)
    lam = float(b.max(initial=0.0))
    tol = 1e-12 * max(1.0, lam)
    if lam <= lambda1 + tol:
        return x
    in_P = np.zeros(n, bool)
    in_P[int(np.argmax(b))] = True
    ridge_eye = 1e-13
    for _ in range(8 * n + 50):
        P = np.where(in_P)[0]
        Gpp = G[np.ix_(P, P)]
        Gpp = Gpp + ridge_eye * (np.diag(np.diag(Gpp)) + np.eye(P.size))
        u = np.linalg.solve(Gpp, np.ones(P.size))
        v = np.linalg.solve(Gpp, b[P])
        # entering: c_i(lam') = lam'  =>  lam' = (b_i - q_i) / (1 - p_i)
        Gip = G[:, P]
        p = Gip @ u
        q = Gip @ v
        denom = 1.0 - p
        li = np.where((~in_P) & (denom > 1e-12),
                      (b - q) / np.where(denom > 1e-12, denom, 1.0), -1.0)
        li[li >= lam - tol] = -1.0
        j_in = int(np.argmax(li))
        lam_in = float(li[j_in])
        # leaving: x_a(lam') = v_a - lam' u_a = 0, only u_a < 0 can cross
        la = np.where(u < 0.0, v / np.where(u < 0.0, u, 1.0), -1.0)
        la[la >= lam - tol] = -1.0
        a_out = int(np.argmax(la))
        lam_out = float(la[a_out])
        lam_next = max(lam_in, lam_out)
        if lam_next <= lambda1:
            x[:] = 0.0
            x[P] = np.maximum(v - lambda1 * u, 0.0)
            return x
        x[:] = 0.0
        x[P] = v - lam_next * u
        if lam_out >= lam_in:
            drop = P[a_out]
            x[drop] = 0.0
            in_P[drop] = False
            if not in_P.any():
                # restart scan excludes the atom just dropped at lam_next:
                # re-adding it at the same lambda cycles drop/re-add until
                # the event cap on degenerate inputs (mirrors the C++ guard)
                b_r = np.array(b)
                b_r[drop] = -np.inf
                if b_r.max(initial=0.0) <= lam_next:
                    return x
                in_P[int(np.argmax(b_r))] = True
        else:
            in_P[j_in] = True
        lam = lam_next
    raise RuntimeError('LARS homotopy (NumPy fallback) exceeded event cap')


def _lasso_lars_py(A, y, lambda1, lambda2):
    G = A.T @ A + lambda2 * np.eye(A.shape[1])
    return _qp_lars_nonneg_py(G, A.T @ y, lambda1)


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def qp_nonneg(G: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact min 0.5 x'Gx - b'x, x>=0 (active set)."""
    G = np.ascontiguousarray(G, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    if not available():
        return _qp_nonneg_py(G, b)
    lib = _load()
    n = b.shape[0]
    x = np.zeros(n)
    rc = lib.amico_qp_nonneg(_dp(G), _dp(b), n, _dp(x))
    if rc < 0:
        raise RuntimeError('amico_qp_nonneg did not converge')
    return x


def nnls(A: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, float]:
    """Exact NNLS; returns (x, residual norm).  Mirrors the SPAMS nnls
    signature used at reference models.pyx:911."""
    A = np.asfortranarray(A, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    if not available():
        return _nnls_py(A, y)
    lib = _load()
    m, n = A.shape
    x = np.zeros(n)
    r = ctypes.c_double(0.0)
    rc = lib.amico_nnls(_dp(A), _dp(y), m, n, _dp(x), ctypes.byref(r))
    if rc < 0:
        raise RuntimeError('amico_nnls did not converge')
    return x, r.value


def lasso(A: np.ndarray, y: np.ndarray, lambda1: float, lambda2: float,
          algorithm: str = 'lars') -> np.ndarray:
    """Exact non-negative elastic net, SPAMS mode=2/pos semantics
    (reference models.pyx:615,926,1238,1569).

    ``algorithm='lars'`` (default) runs the LARS/homotopy path -- the
    algorithm SPAMS itself uses for these calls, so the oracle pins down
    the same vertex the reference reports on near-degenerate
    dictionaries.  ``algorithm='activeset'`` runs Lawson-Hanson
    most-violated-first pivoting on the same objective (identical
    minimizer when the problem is strictly convex and well-conditioned;
    kept for cross-checking the two pivot orders)."""
    if algorithm not in ('lars', 'activeset'):
        raise ValueError(f'unknown lasso algorithm: {algorithm!r}')
    A = np.asfortranarray(A, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    if not available():
        if algorithm == 'lars':
            return _lasso_lars_py(A, y, lambda1, lambda2)
        return _lasso_py(A, y, lambda1, lambda2)
    lib = _load()
    m, n = A.shape
    x = np.zeros(n)
    fn = lib.amico_lasso_lars if algorithm == 'lars' else lib.amico_lasso
    rc = fn(_dp(A), _dp(y), m, n, _dp(x), lambda1, lambda2)
    if rc < 0:
        raise RuntimeError(f'amico_lasso ({algorithm}) did not converge')
    return x


def preprocess_available() -> bool:
    """The fused native preprocessing pass is present (a stale prebuilt
    .so from an older wheel may lack the symbol)."""
    if not available():
        return False
    return getattr(_load(), 'amico_preprocess_dwi', None) is not None


def preprocess_dwi(raw: np.ndarray, b0_idx: np.ndarray,
                   slope: float, inter: float, rescale: bool,
                   b0_min_signal: float, fill: float | None,
                   normalize: bool, nthreads: int | None = None):
    """Fused load-time preprocessing (native, threaded, single pass):
    rescale + non-finite counting/substitution + b0 normalization + output
    stats.  Mirrors the staged pipeline
    (pipeline.intensity_rescale/ensure_finite/b0_normalize; reference
    reference amico/core.py:146-158,209-223) at memory-bandwidth
    speed -- equivalence asserted in tests/test_pipeline.py.

    ``raw`` must be the F-contiguous float32 4-D volume (the NIfTI memmap
    layout: each sample volume contiguous).  Returns ``(out, mean_b0,
    info)`` where ``info`` carries ``raw_bad``/``out_bad`` non-finite
    counts and the min/mean/max of ``out``; ``mean_b0`` is None unless
    ``normalize``.  Returns None when the native library is unavailable
    (caller falls back to the staged NumPy path).
    """
    if not preprocess_available():
        return None
    if raw.ndim != 4 or raw.dtype != np.float32 \
            or not raw.flags.f_contiguous:
        return None
    lib = _load()
    nvox = int(np.prod(raw.shape[:3]))
    nS = int(raw.shape[3])
    b0 = np.ascontiguousarray(np.asarray(b0_idx, np.int32))
    out = np.empty(raw.shape, np.float32, order='F')
    mean_b0 = np.empty(raw.shape[:3], np.float32, order='F') \
        if normalize else np.empty(1, np.float32)
    stats = np.zeros(3, np.float64)
    raw_bad = ctypes.c_longlong(0)
    out_bad = ctypes.c_longlong(0)
    if nthreads is None:
        nthreads = os.cpu_count() or 1
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.amico_preprocess_dwi(
        raw.ctypes.data_as(fp), nvox, nS,
        b0.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), int(b0.size),
        np.float32(slope if np.isfinite(slope) else 1.0),
        np.float32(inter if np.isfinite(inter) else 0.0),
        int(bool(rescale)), float(b0_min_signal),
        int(fill is not None),
        np.float32(fill if fill is not None else 0.0),
        int(bool(normalize)),
        out.ctypes.data_as(fp), mean_b0.ctypes.data_as(fp), _dp(stats),
        ctypes.byref(raw_bad), ctypes.byref(out_bad), int(nthreads))
    if rc != 0:
        return None
    info = {
        'raw_bad': int(raw_bad.value),
        'out_bad': int(out_bad.value),
        'min': float(stats[0]),
        'max': float(stats[1]),
        'mean': float(stats[2]) / max(1, nvox * nS),
    }
    return out, (mean_b0 if normalize else None), info


def masked_gather_available() -> bool:
    """The fused masked-voxel extraction is present in the loaded .so."""
    if not available():
        return False
    return getattr(_load(), 'amico_masked_gather', None) is not None


def masked_gather_padded(vol: np.ndarray, mask: np.ndarray,
                         pad_rows: int = 1, clip: bool = True,
                         nthreads: int | None = None,
                         blocks: int = 1, block_cb=None):
    """Fused masked voxel extraction (native, threaded, single pass):
    ``vol[mask == 1, :]`` + negative clipping + ``pad_rows`` zero rows
    appended, written straight into one (N + pad_rows, nS) float32
    row-major buffer -- the tile engine's gather layout.  Replaces three
    full-volume passes (numpy transpose-gather, clip, pad concatenate);
    semantics equivalence vs pipeline.masked_voxels is asserted in
    tests/test_preproc_fused.py.

    Row order is numpy boolean-indexing order (C order over the mask),
    regardless of either array's memory layout.  Returns the buffer, or
    None when the native library is unavailable or ``vol`` is not the
    F-contiguous float32 4-D production layout (caller falls back).

    With ``blocks > 1`` and a ``block_cb``, the gather runs block-by-block
    over row ranges and ``block_cb(view)`` fires as each contiguous row
    slice completes (the final block includes the pad rows) -- the caller
    can start the H2D transfer of block k while block k+1 is still
    gathering, pipelining extraction with the device upload.
    """
    if not masked_gather_available():
        return None
    if vol.ndim != 4 or vol.dtype != np.float32 \
            or not vol.flags.f_contiguous:
        return None
    lib = _load()
    dim = vol.shape[:3]
    nvox = int(np.prod(dim))
    nS = int(vol.shape[3])
    # F-order linear indices of the masked voxels, enumerated in C order
    # (numpy's boolean-indexing row order)
    sel = np.asarray(mask == 1)
    flat_c = np.flatnonzero(np.ravel(sel, order='C'))
    vidx = np.ravel_multi_index(
        np.unravel_index(flat_c, dim, order='C'), dim, order='F') \
        .astype(np.int64)
    vidx = np.ascontiguousarray(vidx)
    n = int(vidx.size)
    out = np.empty((n + pad_rows, nS), np.float32)
    if nthreads is None:
        nthreads = os.cpu_count() or 1
    fp = ctypes.POINTER(ctypes.c_float)
    lp = ctypes.POINTER(ctypes.c_longlong)
    if blocks <= 1 or block_cb is None:
        rc = lib.amico_masked_gather(
            vol.ctypes.data_as(fp), nvox, nS, vidx.ctypes.data_as(lp), n,
            out.ctypes.data_as(fp), int(pad_rows), int(bool(clip)),
            int(nthreads))
        if rc != 0:
            return None
        return out
    itemsz = out.itemsize
    step = -(-n // int(blocks))
    for r0 in range(0, max(n, 1), max(step, 1)):
        r1 = min(n, r0 + step)
        last = r1 == n
        rc = lib.amico_masked_gather(
            vol.ctypes.data_as(fp), nvox, nS,
            ctypes.cast(vidx.ctypes.data + r0 * 8, lp), r1 - r0,
            ctypes.cast(out.ctypes.data + r0 * nS * itemsz, fp),
            int(pad_rows) if last else 0, int(bool(clip)), int(nthreads))
        if rc != 0:
            return None
        block_cb(out[r0:r1 + pad_rows] if last else out[r0:r1])
        if last:        # covers n == 0 too: one iteration, pad rows only
            break
    return out
