"""Synthetic-data helpers for the port's tests and chip_smoke.py
(counterpart of ``amico_tpu.testing``, without its JAX compile cache)."""
from __future__ import annotations

import hashlib
import os
import tempfile

import numpy as np

from amico_tpu import lut as _lut
from amico_tpu.io.scheme import Scheme
from amico_tpu.ops.sphere import fibonacci_hemisphere, resolve_source

LMAX = 12
NDIRS = 500


def demo_scheme(nb0: int = 2, shells=(700.0, 2000.0), ndir=24) -> Scheme:
    """``nb0`` b=0 volumes, then per shell ``ndir`` directions (an int, or
    one count per shell)."""
    ndirs = ndir if isinstance(ndir, (tuple, list)) else (ndir,) * len(shells)
    rows = [np.zeros((nb0, 4))]
    for b, n in zip(shells, ndirs):
        rows.append(np.c_[fibonacci_hemisphere(n), np.full(n, b)])
    return Scheme(np.vstack(rows))


def demo_noddi(scheme: Scheme | None = None, small: bool = True,
               kernels_dir: str | None = None):
    """Build the port's NODDI model + resampled KERNELS + hash table.

    ``small=True`` shrinks the atom grid (12 coupled + 1 iso);
    ``small=False`` uses the full grid (144 + 1 atoms).  The atoms are
    generated into ``kernels_dir`` once per scheme and grid (a marker file
    keys them) and resampled on every call."""
    from .models import NODDI
    model = NODDI()
    if small:
        model.set(IC_VFs=np.linspace(0.3, 0.99, 4),
                  IC_ODs=np.array([0.06, 0.3, 0.8]))
    return _demo_model(model, scheme or demo_scheme(), kernels_dir)


def demo_freewater(scheme: Scheme | None = None, type: str = 'Human',
                   kernels_dir: str | None = None):
    """Build the port's FreeWater model (``type`` 'Human' or 'Mouse') +
    resampled KERNELS + hash table, cached in ``kernels_dir`` as
    :func:`demo_noddi` caches its atoms."""
    from .models import FreeWater
    model = FreeWater()
    model.set(type=type)
    return _demo_model(model, scheme or demo_scheme(), kernels_dir)


def _demo_model(model, scheme: Scheme, kernels_dir: str | None):
    model.set_solver()
    model.scheme = scheme
    out = kernels_dir or tempfile.mkdtemp(prefix='amico_tpu_torch_demo_')
    os.makedirs(out, exist_ok=True)
    src = resolve_source(NDIRS)
    sig = hashlib.sha1(repr((
        np.asarray(scheme.raw).tobytes(),
        sorted((k, v.tolist() if isinstance(v, np.ndarray) else v)
               for k, v in model.get_params().items()),
        LMAX, NDIRS)).encode()).hexdigest()[:16]
    marker = os.path.join(out, f'source={src}_sig={sig}')
    import fcntl
    with open(os.path.join(out, '.lock'), 'w') as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if not (os.path.isfile(os.path.join(out, 'A_001.npy'))
                and os.path.isfile(marker)):
            for f in os.listdir(out):
                if (f.startswith('A_') and f.endswith('.npy')) \
                        or f.startswith('source='):
                    os.remove(os.path.join(out, f))
            aux = _lut.load_precomputed_rotation_matrices(LMAX, NDIRS)
            idx_in, idx_out = _lut.aux_structures_generate(scheme, LMAX)
            model.generate(out, aux, idx_in, idx_out, NDIRS)
            open(marker, 'w').close()
    ridx, Ylm = _lut.aux_structures_resample(scheme, LMAX)
    kernels = model.resample(out, ridx, Ylm, False, NDIRS)
    htable = _lut.load_precomputed_hash_table(NDIRS)
    return model, kernels, htable


def demo_voxels(n: int, kernels: dict, htable: np.ndarray, seed: int = 0):
    """Random NODDI mixtures through the actual dictionary + noise (the
    same draws as ``amico_tpu.testing.demo_voxels`` for the same seed)."""
    rng = np.random.RandomState(seed)
    n_wm = kernels['wm'].shape[0]
    DIRs = rng.randn(n, 3)
    DIRs /= np.linalg.norm(DIRs, axis=1, keepdims=True)
    lut_idx = _lut.dir_to_lut_idx(DIRs, htable)
    W = rng.rand(n, n_wm + 1) * (rng.rand(n, n_wm + 1) < 0.3)
    W[np.arange(n), rng.randint(n_wm + 1, size=n)] += 0.5
    W /= np.maximum(W.sum(1, keepdims=True), 1e-9)
    K = np.transpose(kernels['wm'], (1, 2, 0))          # (ndirs, nS, n_wm)
    y = np.empty((n, kernels['wm'].shape[2]), np.float64)
    step = 8192
    for i in range(0, n, step):
        sl = slice(i, min(i + step, n))
        Asl = K[lut_idx[sl]]                            # (B, nS, n_wm)
        y[sl] = np.einsum('bsa,ba->bs', Asl, W[sl, :n_wm]) \
            + W[sl, n_wm:] * kernels['iso'][None, :]
    y = np.clip(y + 0.002 * rng.randn(*y.shape), 0, None)
    return y, DIRs, lut_idx


def noddi_tile_inputs(model, kernels, htable, device, n_tiles: int,
                      seed: int = 0) -> list:
    """The fused solve's inputs (G1, G2, b1, Y_dwi, A2T, iso_dwi, icvf,
    kappa) for the first ``n_tiles`` 128-voxel tiles of ``demo_voxels``,
    built as ``model.fit`` builds them."""
    import torch
    from .models._fitops import project
    from .models.engine import build_tile_plan
    y, _, lut_idx = demo_voxels(n_tiles * 160, kernels, htable, seed=seed)
    plan = build_tile_plan(lut_idx, 128)
    c = model.prepare(kernels, device)
    y_ext = torch.as_tensor(np.concatenate([y, np.zeros((1, y.shape[1]))]),
                            dtype=torch.float32, device=device)
    perm = torch.as_tensor(plan.perm[:n_tiles * 128].astype(np.int64),
                           device=device)
    Y = y_ext[perm].view(n_tiles, 128, -1)
    dirs = torch.as_tensor(plan.tile_dirs[:n_tiles].astype(np.int64),
                           device=device)
    return [c['G1_all'][dirs], c['G2_all'][dirs],
            project(c['A_all'][dirs], Y),
            Y.index_select(-1, c['rows_dwi']).contiguous(),
            c['A2T_all'][dirs], c['iso_dwi'], c['icvf'], c['kappa']]


def fused_agreement(args, kernel_out, twin_out) -> dict:
    """How the fused solve's kernel agrees with its twin on the same inputs
    (``args`` as :func:`noddi_tile_inputs` builds them; each output is the
    ``(est, x)`` of a ``want_x=True`` call).

    Maps: median, p95 and max of |est_k - est_t|, and the share of voxels
    with a map off by more than 5e-3.  Coefficients, by the stage-3
    objective 0.5 x'G1 x - b1'x in float64: the 99th percentile and max of
    the relative gap, the shares of voxels whose kernel objective is worse
    (and better) than the twin's by more than 1e-3 relative, and how many
    voxels of each end above 0, worse than x = 0."""
    import torch
    (est_k, x_k), (est_t, x_t) = kernel_out, twin_out
    G1, b1 = args[0].double(), args[2].double()

    def obj(x):
        x = x.double()
        return 0.5 * (x * (x @ G1.transpose(1, 2))).sum(-1) - (b1 * x).sum(-1)

    o_k, o_t = obj(x_k), obj(x_t)
    rel = ((o_k - o_t) / (o_t.abs() + 1e-6)).flatten().cpu().numpy()
    err = (est_k - est_t).abs().cpu().numpy()
    return {'map_median': float(np.median(err)),
            'map_p95': float(np.percentile(err, 95)),
            'map_max': float(err.max()),
            'map_share_off': float(np.mean(err.max(-1) > 5e-3)),
            'obj_gap_p99': float(np.percentile(np.abs(rel), 99)),
            'obj_gap_max': float(np.abs(rel).max()),
            'obj_share_worse': float(np.mean(rel > 1e-3)),
            'obj_share_better': float(np.mean(rel < -1e-3)),
            'obj_above_zero': (int(torch.count_nonzero(o_k > 0)),
                               int(torch.count_nonzero(o_t > 0)))}


def freewater_voxels(n: int, kernels: dict, htable: np.ndarray,
                     seed: int = 0):
    """Random FreeWater mixtures through the actual dictionary + noise:
    ``tests/test_models.py::_rand_voxels``'s recipe (weights U(0,1) on ~30%
    of the atoms, +0.5 on one atom, normalised; 0.002 Gaussian noise,
    clipped at 0), drawn in bulk as :func:`demo_voxels` draws.  Returns
    (y (n, nS), DIRs (n, 3), true LUT directions (n,), weights W (n,
    n_atoms), zeppelins first)."""
    rng = np.random.RandomState(seed)
    n_perp = kernels['D'].shape[0]
    na = n_perp + kernels['CSF'].shape[0]
    DIRs = rng.randn(n, 3)
    DIRs /= np.linalg.norm(DIRs, axis=1, keepdims=True)
    lut_idx = _lut.dir_to_lut_idx(DIRs, htable)
    W = rng.rand(n, na) * (rng.rand(n, na) < 0.3)
    W[np.arange(n), rng.randint(na, size=n)] += 0.5
    W /= np.maximum(W.sum(1, keepdims=True), 1e-9)
    K = np.transpose(kernels['D'], (1, 2, 0))          # (ndirs, nS, n_perp)
    y = W[:, n_perp:] @ kernels['CSF'].astype(np.float64)
    step = 8192
    for i in range(0, n, step):
        sl = slice(i, min(i + step, n))
        y[sl] += np.einsum('bsa,ba->bs', K[lut_idx[sl]], W[sl, :n_perp])
    y = np.clip(y + 0.002 * rng.randn(*y.shape), 0, None)
    return y, DIRs, lut_idx, W


def freewater_tile_inputs(model, kernels, htable, device, n_tiles: int,
                          seed: int = 0) -> list:
    """The tile QP's inputs [G, b] for the first ``n_tiles`` 128-voxel
    tiles of :func:`freewater_voxels`, built as ``FreeWater.fit`` builds
    them."""
    import torch
    from .models._fitops import project
    from .models.engine import build_tile_plan
    y, _, lut_idx, _ = freewater_voxels(n_tiles * 160, kernels, htable,
                                        seed=seed)
    plan = build_tile_plan(lut_idx, 128)
    c = model.prepare(kernels, device)
    y_ext = torch.as_tensor(np.concatenate([y, np.zeros((1, y.shape[1]))]),
                            dtype=torch.float32, device=device)
    perm = torch.as_tensor(plan.perm[:n_tiles * 128].astype(np.int64),
                           device=device)
    Y = y_ext[perm].view(n_tiles, 128, -1)
    dirs = torch.as_tensor(plan.tile_dirs[:n_tiles].astype(np.int64),
                           device=device)
    return [c['G_all'][dirs], project(c['A_all'][dirs], Y)]


def random_qp_problems(C: int, n: int, M: int = 128, m: int = 60,
                       seed: int = 0):
    """tests/test_pallas_qp.py's random tile QPs: A ~ N(0, 1) (C, m, n),
    Y ~ U(0, 1) (C, M, m); returns float32 NumPy G = A'A (C, n, n) and
    b = A'y (C, M, n)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(C, m, n)
    Y = np.abs(rng.rand(C, M, m))
    G = np.einsum('cmi,cmj->cij', A, A)
    b = np.einsum('cmi,cbm->cbi', A, Y)
    return G.astype(np.float32), b.astype(np.float32)


def freewater_maps(x, n_perp: int):
    """FreeWater's maps from its coefficients x (..., n), zeppelins first:
    FiberVolume, FW (and the iso fractions FW_blood, FW_csf for Mouse)."""
    import torch
    x_sum = x.sum(-1, keepdim=True) + 1e-16
    v = x[..., :n_perp].sum(-1, keepdim=True) / x_sum
    iso = x[..., n_perp:] / x_sum if x.shape[-1] - n_perp > 1 else v[..., :0]
    return torch.cat([v, 1.0 - v, iso], -1)


def qp_agreement(G, b, lam1, lam2, x_kernel, x_twin,
                 n_perp: int | None = None) -> dict:
    """How the tile QP's kernel agrees with its twin on the same inputs:
    |x_k - x_t| by median, p95 and max; the objective 1/2 x'Gx - b'x +
    lam1 sum(x) + lam2/2 |x|^2 in float64, as the 99th percentile and max
    of the relative gap, and the shares of voxels whose kernel objective is
    worse (and better) than the twin's by more than 1e-3 relative.  With
    ``n_perp``, also FreeWater's maps (:func:`freewater_maps`) by median,
    p95 and max: adjacent zeppelins are near-collinear, so x can move
    between them at no cost in the objective, and the maps cannot."""
    G, b = G.double(), b.double()

    def obj(x):
        x = x.double()
        return 0.5 * (x * (x @ G.transpose(1, 2))).sum(-1) \
            - (b * x).sum(-1) + lam1 * x.sum(-1) + 0.5 * lam2 * (x * x).sum(-1)

    o_k, o_t = obj(x_kernel), obj(x_twin)
    rel = ((o_k - o_t) / (o_t.abs() + 1e-6)).flatten().cpu().numpy()
    err = (x_kernel - x_twin).abs().cpu().numpy()
    out = {'x_median': float(np.median(err)),
           'x_p95': float(np.percentile(err, 95)),
           'x_max': float(err.max()),
           'obj_gap_p99': float(np.percentile(np.abs(rel), 99)),
           'obj_gap_max': float(np.abs(rel).max()),
           'obj_share_worse': float(np.mean(rel > 1e-3)),
           'obj_share_better': float(np.mean(rel < -1e-3))}
    if n_perp is not None:
        merr = (freewater_maps(x_kernel, n_perp)
                - freewater_maps(x_twin, n_perp)).abs().cpu().numpy()
        out.update(map_median=float(np.median(merr)),
                   map_p95=float(np.percentile(merr, 95)),
                   map_max=float(merr.max()))
    return out


def write_demo_subject(subject_dir: str, scheme: Scheme, y: np.ndarray,
                       dim: tuple, s0: float = 1000.0) -> None:
    """Write voxel signals ``y`` (prod(dim), nS), scaled by ``s0``, as
    ``DWI.nii`` (float32, 2 mm voxels) and ``scheme`` as ``DWI.scheme``."""
    from amico_tpu.io import nifti
    os.makedirs(subject_dir, exist_ok=True)
    vol = (s0 * np.asarray(y)).astype(np.float32).reshape(
        tuple(dim) + (y.shape[1],))
    nifti.save(nifti.Nifti1Image(vol, np.diag([2.0, 2.0, 2.0, 1.0])),
               os.path.join(subject_dir, 'DWI.nii'))
    np.savetxt(os.path.join(subject_dir, 'DWI.scheme'), scheme.raw[:, :4],
               fmt='%.6f', header='VERSION: BVECTOR', comments='')


def noddi_oracle_voxel(kernels, dwi_idx, y_i, lut_i, lam1=0.5, lam2=1e-3):
    """Exact per-voxel NODDI 3-stage solve with the shared native solvers
    (``amico_tpu.ops.native``: NNLS, LARS lasso): (1) NNLS on the full
    dictionary for the CSF fraction; (2) non-negative lasso on the
    norm-scaled DWI subproblem with the iso prediction subtracted, clipped
    >= 0; (3) debias NNLS on the positive support with iso forced in.
    Returns the (NDI, ODI, FWF) vector, as ``amico_tpu.testing`` does."""
    from amico_tpu.ops import native
    n_wm = kernels['wm'].shape[0]
    A = np.column_stack([kernels['wm'][:, lut_i, :].T, kernels['iso']])
    x1, _ = native.nnls(A, y_i)
    y2 = np.clip(y_i[dwi_idx] - x1[-1] * kernels['iso'][dwi_idx], 0, None)
    A2 = A[dwi_idx][:, :n_wm] * kernels['norms'][None, :]
    x2 = native.lasso(A2, y2, lam1, lam2)
    x = np.zeros(n_wm + 1)
    x[:n_wm] = x2
    x[-1] = 1.0
    sup = np.where(x > 0)[0]
    x3, _ = native.nnls(A[:, sup], y_i)
    x[:] = 0.0
    x[sup] = x3
    sa = x.sum() + 1e-16
    xn = x[:n_wm] / sa
    sw = xn.sum() + 1e-16
    f1 = np.sum(kernels['icvf'] * xn) / sw
    f2 = np.sum((1 - kernels['icvf']) * xn) / sw
    k1 = np.sum(kernels['kappa'] * xn) / sw
    return np.array([f1 / (f1 + f2 + 1e-16),
                     2 / np.pi * np.arctan2(1.0, k1), x[-1] / sa])


def direction_agreement(evaluation, lut_true: np.ndarray,
                        voxels: np.ndarray | None = None) -> float:
    """Share of a fitted ``Evaluation``'s masked voxels (those selected by
    the boolean ``voxels``, if given) whose principal direction (``DIRs``)
    falls on the LUT direction ``lut_true``."""
    lut_idx = _lut.dir_to_lut_idx(np.asarray(evaluation.DIRs, np.float64),
                                  evaluation.htable)
    agree = lut_idx == np.asarray(lut_true)
    return float(np.mean(agree if voxels is None else agree[voxels]))


def freewater_oracle_audit(evaluation, n: int = 1000,
                           seed: int = 0) -> np.ndarray:
    """|fitted maps - oracle maps| (n, n_maps) for ``n`` voxels of a fitted
    FreeWater ``Evaluation``, sampled with ``seed``.  The oracle is the
    exact non-negative elastic net ``amico_tpu.ops.native.lasso(A, y,
    lambda1, lambda2)`` (LARS) on each voxel's signal and the dictionary of
    its fitted LUT direction; its maps are FiberVolume, FW (and FW_blood,
    FW_csf for Mouse), as the fit computes them."""
    from amico_tpu.ops import native
    K = evaluation.KERNELS
    n_perp = K['D'].shape[0]
    lam1 = float(evaluation.model.solver_params['lambda1'])
    lam2 = float(evaluation.model.solver_params['lambda2'])
    y = np.asarray(evaluation.y, np.float64)
    maps = evaluation.RESULTS['MAPs'][evaluation.niiMASK_img == 1]
    rng = np.random.RandomState(seed)
    sel = rng.choice(y.shape[0], size=min(n, y.shape[0]), replace=False)
    lut_idx = _lut.dir_to_lut_idx(
        np.asarray(evaluation.DIRs, np.float64)[sel], evaluation.htable)
    ref = []
    for i, li in zip(sel, lut_idx):
        A = np.column_stack([K['D'][:, li, :].T, K['CSF'].T]).astype(
            np.float64)
        x = native.lasso(A, y[i], lam1, lam2)
        xs = x.sum() + 1e-16
        v = x[:n_perp].sum() / xs
        iso = [x[n_perp] / xs, x[n_perp + 1] / xs] if maps.shape[1] == 4 \
            else []
        ref.append([v, 1.0 - v] + iso)
    return np.abs(maps[sel] - np.asarray(ref))


def noddi_oracle_audit(evaluation, n: int = 1000, seed: int = 0) -> np.ndarray:
    """|fitted maps - oracle maps| (n, 3) for ``n`` voxels of a fitted
    in-vivo NODDI ``Evaluation``, sampled with ``seed``: each voxel's signal
    and LUT direction go through :func:`noddi_oracle_voxel`, and the result
    is held against the NDI/ODI/FWF the fit wrote into ``RESULTS``."""
    y = np.asarray(evaluation.y, np.float64)
    maps = evaluation.RESULTS['MAPs'][evaluation.niiMASK_img == 1][:, :3]
    rng = np.random.RandomState(seed)
    sel = rng.choice(y.shape[0], size=min(n, y.shape[0]), replace=False)
    lut_idx = _lut.dir_to_lut_idx(
        np.asarray(evaluation.DIRs, np.float64)[sel], evaluation.htable)
    if evaluation.get_config('doMergeB0'):
        dwi_idx = np.arange(1, y.shape[1])
    else:
        dwi_idx = np.asarray(evaluation.scheme.dwi_idx)
    ref = np.stack([noddi_oracle_voxel(evaluation.KERNELS, dwi_idx, y[i], li)
                    for i, li in zip(sel, lut_idx)])
    return np.abs(maps[sel] - ref)
