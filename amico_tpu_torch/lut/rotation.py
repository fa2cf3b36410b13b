"""Copy of ``amico_tpu/lut/rotation.py`` for the port, which imports nothing of
``amico_tpu``, without its JAX-only ``dir_to_lut_idx_jax``.

LUT / zonal-rotation engine.

TPU-native re-design of the reference's Cython LUT machinery
(reference amico/lut.pyx).  Same math, tensorized:

* high-resolution response functions are synthesized on a fixed 500-dir
  per-shell gradient set (the reference embeds a hard-coded table,
  lut.pyx:387-891; we generate a spherical-Fibonacci set);
* each axially-symmetric kernel is SH-fit per shell and rotated to all
  ``ndirs`` orientations with the zonal-harmonic trick: the rotated SH
  coefficients are ``const[c] * Klm[idx_m0[c]] * Ylm(u)[c]``
  (lut.pyx:129-138,258-264) -- here a single einsum over all directions;
* ``resample`` projects SH -> the subject's gradient directions with one
  matmul per kernel (vs the per-direction loop at lut.pyx:297-311);
* ``dir_to_lut_idx`` (lut.pyx:314-356) becomes vectorized integer math over
  whole voxel batches.

Disk-cache layout mirrors the reference: AUX pickles keyed by
``(lmax, ndirs)`` under the amico home dir (lut.pyx:104-108), kernel LUTs as
``A_{idx:03d}.npy`` per model (models.pyx:308).
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ..io.scheme import Scheme
from ..ops import sh as _sh
from ..ops import sphere as _sphere
from ..utils.logging import ERROR

N_HIGHRES_DIRS = 500  # directions per shell of the high-resolution scheme


def highres_grad(source: str | None = None) -> np.ndarray:
    """The (500, 3) per-shell gradient set used to synthesize kernels.

    'reference' (the default -- the table is vendored) returns upstream's
    embedded ``grad`` table (lut.pyx:390-891) so synthesized kernels match
    upstream bit-for-bit; 'generated' returns a deterministic
    spherical-Fibonacci hemisphere set.
    """
    src = source or os.environ.get('AMICO_TPU_DIRECTION_SOURCE', 'auto')
    if src in ('auto', 'reference'):
        from . import refdata
        return refdata.reference_grad()
    return _sphere.fibonacci_hemisphere(N_HIGHRES_DIRS)


# re-exported sphere helpers so this module covers the reference lut surface
valid_dirs = _sphere.valid_dirs
is_valid = _sphere.is_valid
load_directions = _sphere.load_directions
load_precomputed_hash_table = _sphere.load_precomputed_hash_table


def _aux_filename(lmax: int, ndirs: int, source: str) -> str:
    # reference-sourced AUX keeps the upstream cache name (lut.pyx:106);
    # generated-source gets its own key so the two never collide
    suffix = '' if source == 'reference' else '_src=generated'
    return os.path.join(
        _sphere.amico_home(),
        f'AMICO_aux_matrices_lmax={lmax}_ndirs={ndirs}{suffix}.pickle')


def precompute_rotation_matrices(lmax: int, ndirs: int,
                                 source: str | None = None) -> None:
    """Precompute the per-(lmax, ndirs) rotation structures (lut.pyx:94-141).

    AUX = {fit, Ylm_rot, const, idx_m0, lmax, ndirs, grad, source} where
    ``Ylm_rot`` is a dense (ndirs, nSH) matrix (the reference stores an
    object-array of row vectors, lut.pyx:122-126) and ``grad`` is the
    high-res gradient set the SH fit matrix was built on.
    Cached on disk; re-entry is a no-op (lut.pyx:107-108).
    """
    source = _sphere.resolve_source(ndirs, source)
    filename = _aux_filename(lmax, ndirs, source)
    if os.path.isfile(filename):
        return
    directions = _sphere.load_directions(ndirs, source)
    grad = highres_grad(source)

    _, theta, phi = _sh.cart2sphere(grad[:, 0], grad[:, 1], grad[:, 2])
    fit = _sh.sh_fit_matrix(lmax, theta, phi)

    _, theta_d, phi_d = _sh.cart2sphere(directions[:, 0], directions[:, 1],
                                        directions[:, 2])
    Ylm_rot = _sh.real_sh_basis(lmax, theta_d, phi_d)

    _, _, idx_m0, const = _sh.sh_degree_info(lmax)

    AUX = {'lmax': lmax, 'ndirs': ndirs, 'fit': fit, 'Ylm_rot': Ylm_rot,
           'const': const, 'idx_m0': idx_m0, 'grad': grad, 'source': source}
    # atomic write: a concurrent reader (another process resuming setup)
    # must never see a partially-written pickle
    tmp = filename + f'.tmp{os.getpid()}'
    with open(tmp, 'wb') as fid:
        pickle.dump(AUX, fid, protocol=4)
    os.replace(tmp, filename)


def load_precomputed_rotation_matrices(lmax: int, ndirs: int,
                                       source: str | None = None) -> dict:
    """Load AUX; errors if setup() was never run (lut.pyx:144-167)."""
    source = _sphere.resolve_source(ndirs, source)
    filename = _aux_filename(lmax, ndirs, source)
    if not os.path.isfile(filename):
        # unlike the reference we can self-heal: precompute is cheap
        precompute_rotation_matrices(lmax, ndirs, source)
    with open(filename, 'rb') as fid:
        AUX = pickle.load(fid)
    if AUX.get('source') != source:
        # cache written by an older build (or with different data): rebuild
        os.remove(filename)
        precompute_rotation_matrices(lmax, ndirs, source)
        with open(filename, 'rb') as fid:
            AUX = pickle.load(fid)
    return AUX


def aux_structures_generate(scheme: Scheme, lmax: int = 12):
    """Index structures for kernel generation (lut.pyx:170-193)."""
    nSH = _sh.num_sh_coeff(lmax)
    idx_IN = [range(N_HIGHRES_DIRS * s, N_HIGHRES_DIRS * (s + 1))
              for s in range(len(scheme.shells))]
    idx_OUT = [range(nSH * s, nSH * (s + 1)) for s in range(len(scheme.shells))]
    return idx_IN, idx_OUT


def aux_structures_resample(scheme: Scheme, lmax: int = 12):
    """Subject-specific SH -> signal-space projector (lut.pyx:196-224)."""
    nSH = _sh.num_sh_coeff(lmax)
    idx_OUT = np.zeros(scheme.dwi_count, dtype=np.int32)
    Ylm_OUT = np.zeros((scheme.dwi_count, nSH * len(scheme.shells)),
                       dtype=np.float32)
    idx = 0
    for s, shell in enumerate(scheme.shells):
        nS = len(shell['idx'])
        idx_OUT[idx:idx + nS] = shell['idx']
        g = shell['grad']
        _, theta, phi = _sh.cart2sphere(g[:, 0], g[:, 1], g[:, 2])
        Ylm_OUT[idx:idx + nS, nSH * s:nSH * (s + 1)] = \
            _sh.real_sh_basis(lmax, theta, phi)
        idx += nS
    return idx_OUT, Ylm_OUT


def rotate_kernel(K: np.ndarray, AUX: dict, idx_IN, idx_OUT,
                  is_isotropic: bool, ndirs: int) -> np.ndarray:
    """SH-fit a z-aligned kernel per shell and rotate it to all ndirs
    orientations (lut.pyx:227-271), vectorized.

    Returns float32 (ndirs, nshells*nSH) for anisotropic kernels, or a flat
    (nshells*nSH,) SH vector for isotropic ones.
    """
    nshells = len(idx_IN)
    nSH = AUX['fit'].shape[0]
    # per-shell SH coefficients: Klm[s] = fit @ K[shell samples]
    Klm = np.stack([AUX['fit'] @ np.asarray(K, np.float64)[np.asarray(idx_IN[s])]
                    for s in range(nshells)])          # (nshells, nSH)
    if is_isotropic:
        return Klm.reshape(-1).astype(np.float32)
    # zonal rotation, all directions at once:
    # KRlm[i, s, c] = const[c] * Klm[s, idx_m0[c]] * Ylm_rot[i, c]
    zonal = AUX['const'][None, :] * Klm[:, AUX['idx_m0']]     # (nshells, nSH)
    KRlm = AUX['Ylm_rot'][:, None, :] * zonal[None, :, :]     # (ndirs, nshells, nSH)
    return KRlm.reshape(ndirs, nshells * nSH).astype(np.float32)


def resample_kernel(KRlm: np.ndarray, nS: int, idx_out: np.ndarray,
                    Ylm_out: np.ndarray, is_isotropic: bool,
                    ndirs: int) -> np.ndarray:
    """Project rotated SH kernels to the subject signal space
    (lut.pyx:274-311).  b0 samples keep the value 1 like the reference
    (np.ones initialization at lut.pyx:298,305).
    """
    try:
        if not is_isotropic:
            KR = np.ones((ndirs, nS), dtype=np.float32)
            KR[:, idx_out] = (KRlm.astype(np.float64) @ Ylm_out.T.astype(np.float64)).astype(np.float32)
        else:
            KR = np.ones(nS, dtype=np.float32)
            KR[idx_out] = (Ylm_out.astype(np.float64) @ KRlm.astype(np.float64)).astype(np.float32)
    except ValueError:
        ERROR('Outdated LUT. Call "generate_kernels( regenerate=True )" to update the LUT')
    return KR


def create_high_resolution_scheme(scheme: Scheme, b_scale: float = 1,
                                  grad: np.ndarray | None = None) -> Scheme:
    """Replicate the high-res gradient set for each shell (lut.pyx:359-384).

    ``grad`` should be the set the rotation AUX was built on (AUX['grad']);
    defaults to the module-level resolution for callers without an AUX.
    """
    n = len(scheme.shells)
    if grad is None:
        grad = highres_grad()
    raw = np.zeros((N_HIGHRES_DIRS * n, 4 if scheme.version == 0 else 7))
    row = 0
    for i in range(n):
        raw[row:row + N_HIGHRES_DIRS, 0:3] = grad
        if scheme.version == 0:
            raw[row:row + N_HIGHRES_DIRS, 3] = scheme.shells[i]['b'] * b_scale
        else:
            raw[row:row + N_HIGHRES_DIRS, 3] = scheme.shells[i]['G']
            raw[row:row + N_HIGHRES_DIRS, 4] = scheme.shells[i]['Delta']
            raw[row:row + N_HIGHRES_DIRS, 5] = scheme.shells[i]['delta']
            raw[row:row + N_HIGHRES_DIRS, 6] = scheme.shells[i]['TE']
        row += N_HIGHRES_DIRS
    return Scheme(raw)


def dir_to_lut_idx(directions: np.ndarray, hash_table: np.ndarray) -> np.ndarray:
    """Vectorized NumPy port of the per-voxel quantizer (lut.pyx:314-356).

    directions: (..., 3) array of (possibly unnormalized) orientations.
    Returns int32 LUT indices of the same leading shape.
    """
    d = np.asarray(directions, np.float64)
    flip = d[..., 1] < 0.0
    d = np.where(flip[..., None], -d, d)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]

    i2 = np.mod(np.arctan2(y, x), 2.0 * np.pi)
    i2 = np.where(i2 < 0.0, np.mod(i2 + 2.0 * np.pi, 2.0 * np.pi), i2)
    gt = i2 > np.pi
    i2_alt = np.mod(np.arctan2(-y, -x), 2.0 * np.pi)
    rho = np.sqrt(x * x + y * y)
    i1 = np.where(gt, np.arctan2(rho, -z), np.arctan2(rho, z))
    i2 = np.where(gt, i2_alt, i2)

    ii1 = np.rint(i1 / np.pi * 180.0).astype(np.int64)
    ii2 = np.rint(i2 / np.pi * 180.0).astype(np.int64)
    if ((ii1 < 0) | (ii1 > 180) | (ii2 < 0) | (ii2 > 180)).any():
        raise RuntimeError('"dir_to_lut_idx" index out of bounds')
    return np.asarray(hash_table, np.int32)[ii1 * 181 + ii2]

