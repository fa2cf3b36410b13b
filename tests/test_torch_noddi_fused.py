"""The fused 3-stage NODDI solve of the port (amico_tpu_torch.ops.cuda_qp)
against the JAX package's Pallas kernel, run as its own tests run it on the
CPU: ``noddi_fused_tiles_pallas(interpret=True, precision='highest')`` with
the production schedule DEFAULT_NODDI_STAGE_ITERS.

Maps are compared by distribution and coefficients by stage-3 objective.
JAX and torch sum in different orders, and the stage-2 lasso's vertex is
degenerate below float32 resolution on a few voxels (PARITY.md, round 5),
where a ulp moves the support by one grid atom.  On these adversarial
inputs the Pallas kernel itself leaves the golden's p95 < 1e-3 / max < 5e-3
when only the order of its WM atoms changes; the map tail is held to fixed
bounds set from that reading (TAIL_BOUNDS), and
``test_pallas_departs_from_itself_under_atom_reorder`` reproduces it."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amico_tpu.models.base import \
    DEFAULT_NODDI_STAGE_ITERS as JAX_STAGE_ITERS
from amico_tpu.ops.pallas_qp import noddi_fused_tiles_pallas
from amico_tpu_torch.models.base import DEFAULT_NODDI_STAGE_ITERS
from amico_tpu_torch.ops import cuda_qp
from amico_tpu_torch.ops.cuda_qp import (noddi_fused_tiles,
                                         noddi_fused_tiles_torch)

torch.set_num_threads(1)

CASES = [('small', False, 3), ('small', True, 3), ('full', False, 2)]
# Map tail bounds on |twin - Pallas| per case, beside the Pallas kernel's
# own tail against itself on the same problem with its WM atoms reordered
# (permute_wm seeds 0, 1, 2; CPU, interpret mode, highest precision), the
# bound rounded up from the largest reading by a few voxels:
#   case           p95                  voxels off > 5e-3     max
#   small in vivo  1.4e-5 .. 2.0e-5     1.6% .. 2.3% (of 384)  0.033 .. 0.061
#   small exvivo   2.8e-4 .. 4.4e-4     3.1% .. 4.4% (of 384)  0.34 .. 0.38
#   full in vivo   2.1e-3 .. 3.0e-3     3.9% .. 7.4% (of 256)  0.011 .. 0.012
# The twin against the Pallas kernel read 1.7e-5, 1.8%, 0.034 (small in
# vivo); 5.4e-4, 4.4%, 0.38 (small exvivo); 2.3e-3, 3.9%, 0.0087 (full).
# (p95, share of voxels with a map off by more than 5e-3, max)
TAIL_BOUNDS = {('small', False): (1e-3, 0.03, 0.1),
               ('small', True): (1e-3, 0.06, 0.5),
               ('full', False): (5e-3, 0.10, 0.02)}
MAP_MEDIAN = 1e-5


def assert_map_tail(err, grid, exvivo):
    p95_max, share_max, max_max = TAIL_BOUNDS[grid, exvivo]
    share = np.mean(err.reshape(-1, err.shape[-1]).max(-1) > 5e-3)
    assert np.median(err) < MAP_MEDIAN, np.median(err)
    assert np.percentile(err, 95) < p95_max, np.percentile(err, 95)
    assert share < share_max, share
    assert err.max() < max_max, err.max()


@pytest.fixture(scope='module')
def dictionaries(tmp_path_factory):
    d = tmp_path_factory.mktemp('fused_torch')
    os.environ['AMICO_TPU_HOME'] = str(d / 'home')
    from amico_tpu_torch.testing import demo_noddi, demo_scheme
    scheme = demo_scheme()
    small = demo_noddi(scheme, small=True, kernels_dir=str(d / 'ks'))[1]
    full = demo_noddi(scheme, small=False, kernels_dir=str(d / 'kf'))[1]
    return scheme, {'small': small, 'full': full}


def fused_inputs(scheme, kernels, C, M, seed, exvivo):
    """The inputs of tests/test_pallas_fused.py (random directions per tile,
    sparse mixtures + 0.05 on every atom, 0.002 noise), in float32."""
    n_wm = kernels['wm'].shape[0]
    dwi = np.asarray(scheme.dwi_idx)
    rng = np.random.RandomState(seed)
    ds = rng.randint(0, 500, C)
    dot = [np.ones(scheme.nS)] if exvivo else []
    A = np.stack([np.column_stack([kernels['wm'][:, d, :].T] + dot
                                  + [kernels['iso']]) for d in ds])
    na = A.shape[-1]
    W = rng.rand(C, M, na) * (rng.rand(C, M, na) < 0.3) + 0.05
    Y = np.einsum('csa,cma->cms', A,
                  W / np.maximum(W.sum(-1, keepdims=True), 1e-9))
    Y = np.clip(Y + 0.002 * rng.randn(*Y.shape), 0, None).astype(np.float32)
    A = A.astype(np.float32).astype(np.float64)
    A2 = A[:, dwi, :n_wm] * kernels['norms'][None, None, :].astype(np.float32)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return [f32(np.einsum('csi,csj->cij', A, A)),
            f32(np.einsum('csi,csj->cij', A2, A2)),
            f32(np.einsum('csa,cms->cma', A, Y)), f32(Y[:, :, dwi]),
            f32(np.swapaxes(A2, 1, 2)), f32(kernels['iso'][dwi]),
            f32(kernels['icvf']), f32(kernels['kappa'])]


def permute_wm(args, seed):
    """The same problem with its WM atoms in another order (the iso and dot
    rows stay last, where the solve expects them)."""
    G1, G2, b1, Y_dwi, A2T, iso, icvf, kappa = args
    n_wm, na = G2.shape[-1], G1.shape[-1]
    p = np.random.RandomState(seed).permutation(n_wm)
    p1 = np.concatenate([p, np.arange(n_wm, na)])
    c = np.ascontiguousarray
    return [c(G1[:, p1][:, :, p1]), c(G2[:, p][:, :, p]), c(b1[..., p1]),
            Y_dwi, c(A2T[:, p]), iso, c(icvf[p]), c(kappa[p])]


def twin(args, **kw):
    out = noddi_fused_tiles_torch(*[torch.from_numpy(a) for a in args],
                                  stage_iters=DEFAULT_NODDI_STAGE_ITERS, **kw)
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) \
        else out.numpy()


def pallas(args, exvivo, **kw):
    out = noddi_fused_tiles_pallas(
        *[jnp.asarray(a) for a in args], lam1=0.5, lam2=1e-3,
        stage_iters=JAX_STAGE_ITERS, is_exvivo=exvivo, interpret=True,
        precision='highest', **kw)
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) \
        else np.asarray(out)


@pytest.fixture(scope='module')
def pallas_runs(dictionaries):
    """Each case's inputs and the Pallas kernel's (est, x) on them."""
    scheme, kernels = dictionaries
    runs = {}

    def get(grid, exvivo, C):
        if (grid, exvivo) not in runs:
            args = fused_inputs(scheme, kernels[grid], C, 128, seed=0,
                                exvivo=exvivo)
            runs[grid, exvivo] = args, pallas(args, exvivo, want_x=True)
        return runs[grid, exvivo]
    return get


def test_default_schedule_is_the_jax_packages():
    assert DEFAULT_NODDI_STAGE_ITERS == JAX_STAGE_ITERS


@pytest.mark.parametrize('grid,exvivo,C', CASES)
def test_pallas_departs_from_itself_under_atom_reorder(pallas_runs, grid,
                                                       exvivo, C):
    """The reading behind TAIL_BOUNDS: the Pallas kernel on the same problem
    with its WM atoms listed in another order (mathematically identical
    maps) stays inside the bounds, and leaves the golden's max < 5e-3 (and,
    on the full grid, its p95 < 1e-3)."""
    args, (est_j, _) = pallas_runs(grid, exvivo, C)
    err = np.abs(pallas(permute_wm(args, 0), exvivo) - est_j)
    assert_map_tail(err, grid, exvivo)
    assert err.max() > 5e-3, err.max()
    if grid == 'full':
        assert np.percentile(err, 95) > 1e-3, np.percentile(err, 95)


@pytest.mark.parametrize('grid,exvivo,C', CASES)
def test_twin_matches_pallas(pallas_runs, grid, exvivo, C):
    args, (est_j, x_j) = pallas_runs(grid, exvivo, C)
    est_t, x_t = twin(args, want_x=True, is_exvivo=exvivo)
    assert est_t.shape == est_j.shape == (C, 128, 4 if exvivo else 3)
    assert x_t.shape == x_j.shape == args[2].shape
    assert_map_tail(np.abs(est_t - est_j), grid, exvivo)

    # coefficients: equal stage-3 objectives mean both solve the same
    # debias NNLS, whichever of two tied supports each picked
    assert np.median(np.abs(x_t - x_j)) < 1e-5
    G1, b1 = args[0].astype(np.float64), args[2].astype(np.float64)

    def obj(x):
        x = x.astype(np.float64)
        return 0.5 * np.sum(x * np.einsum('cab,cmb->cma', G1, x), -1) \
            - np.sum(b1 * x, -1)

    o_t, o_j = obj(x_t), obj(x_j)
    gap = np.abs(o_t - o_j) / (np.abs(o_j) + 1e-6)
    assert np.percentile(gap, 99) < 1e-3, np.percentile(gap, 99)


def test_wrapper_takes_the_twin_on_cpu(dictionaries):
    scheme, kernels = dictionaries
    args = [torch.from_numpy(a) for a in
            fused_inputs(scheme, kernels['small'], 2, 16, seed=3,
                         exvivo=False)]
    before = noddi_fused_tiles.launches
    est, x = noddi_fused_tiles(*args, want_x=True)
    est_t, x_t = noddi_fused_tiles_torch(*args, want_x=True)
    assert torch.equal(est, est_t) and torch.equal(x, x_t)
    assert noddi_fused_tiles.launches == before      # no kernel ran
    assert est.shape == (2, 16, 3)
    assert bool(((est >= 0) & (est <= 1)).all())


def test_wrapper_rejects_malformed_inputs(dictionaries):
    scheme, kernels = dictionaries
    args = [torch.from_numpy(a) for a in
            fused_inputs(scheme, kernels['small'], 2, 8, seed=1,
                         exvivo=False)]
    bad_shape = list(args)
    bad_shape[0] = args[0][:, :-1]
    with pytest.raises(ValueError, match='G1'):
        noddi_fused_tiles(*bad_shape)
    bad_dtype = list(args)
    bad_dtype[2] = args[2].double()
    with pytest.raises(TypeError):
        noddi_fused_tiles(*bad_dtype)


def test_stage_schedule_matches_the_kernel_builder():
    s1, s2, s3 = cuda_qp.noddi_schedules(DEFAULT_NODDI_STAGE_ITERS)
    assert (s1.cg, s1.inner, s1.add_k, s1.polish) == \
        ((4, 6, 8, 10), (1, 1, 1, 1), 2, 10)
    assert (s2.cg, s2.inner, s2.add_k, s2.polish) == \
        ((3, 5, 8, 10, 12, 14), (1, 1, 2, 2, 2, 2), 2, 14)
    assert (s3.cg, s3.inner, s3.add_k, s3.polish) == \
        ((16, 10, 8, 8, 8, 8), (2,) * 6, 1, 16)
    # int budgets and short per-round tuples extend as _build_as_solve does
    s = cuda_qp.stage_schedule((0, 4, (5, 7), (1, 2)), True)
    assert (s.cg, s.inner, s.polish) == ((5, 7, 7, 7), (1, 2, 2, 2), 7)
    s = cuda_qp.stage_schedule((3, 9, 2), False)
    assert (s.cg, s.inner, s.add_k) == ((9, 9, 9), (2, 2, 2), 1)


@pytest.mark.parametrize('flag', [dict(tiebreak_cg=8), dict(want_tie=True)])
def test_tiebreak_and_tie_score_raise(dictionaries, flag):
    scheme, kernels = dictionaries
    args = [torch.from_numpy(a) for a in
            fused_inputs(scheme, kernels['small'], 1, 4, seed=2,
                         exvivo=False)]
    for fn in (noddi_fused_tiles, noddi_fused_tiles_torch):
        with pytest.raises(NotImplementedError, match='K1 follow-ups'):
            fn(*args, **flag)


@pytest.mark.parametrize('stage,has_fista', [((40, 4, 8, 1), True),
                                             ((0, 4, 8, 1, True), True),
                                             ((4, 8, 2, 16), False),
                                             ((0, 0, 8, 1), True)])
def test_unsupported_schedules_raise(stage, has_fista):
    with pytest.raises(NotImplementedError):
        cuda_qp.stage_schedule(stage, has_fista)
