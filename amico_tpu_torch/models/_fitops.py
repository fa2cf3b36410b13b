"""Shared per-tile pieces of the model fit functions, in float32
(counterpart of ``amico_tpu.models._fitops``)."""
from __future__ import annotations

import torch

from .. import trace
from ..ops.cuda_qp import TAIL_EXITS, nneg_qp_tiles, qp_lockstep
from ..ops.solvers import nneg_qp_batch


def predict(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y_est = A x per tile: A (C, nS, na), x (C, M, na) -> (C, M, nS)."""
    return torch.matmul(x, A.transpose(-1, -2))


def project(A: torch.Tensor, Y: torch.Tensor, dtype=None) -> torch.Tensor:
    """b = A'y per tile: A (C, nS, na), Y (C, M, nS) -> (C, M, na), in Y's
    dtype.  With ``dtype`` the products are summed in that precision and
    rounded once at the end."""
    if dtype is None:
        return torch.matmul(Y, A)
    return torch.matmul(Y.to(dtype), A.to(dtype)).to(Y.dtype)


def error_maps(A, x, Y, compute_rmse: bool, compute_nrmse: bool) -> dict:
    """RMSE / NRMSE maps exactly as the JAX package computes them."""
    out = {}
    if not (compute_rmse or compute_nrmse):
        return out
    sq = ((Y - predict(A, x)) ** 2).sum(-1)
    if compute_rmse:
        out['rmse'] = torch.sqrt(sq / Y.shape[-1])
    if compute_nrmse:
        den = (Y ** 2).sum(-1)
        out['nrmse'] = torch.where(
            den > 1e-16, torch.sqrt(sq / torch.clamp(den, min=1e-16)), 0.0)
    return out


def solve_tiles(G, b, L, lam1, lam2, mask=None, solver_kw=None,
                backend: str = 'pallas', m0=None, x0=None, valid=None):
    """Per-tile QP solve: G (C, n, n), b (C, M, n), L (C,) -> x (C, M, n).

    'pallas' runs the tile QP (``ops.cuda_qp.nneg_qp_tiles``: the CUDA
    kernel on a CUDA device, its twin on the CPU), which estimates L per
    tile and ignores ``L``.  'xla' runs the stagewise
    ``ops.solvers.nneg_qp_batch`` on the per-tile Grams ``G[:, None]`` with
    ``L[:, None]``, as the JAX package does.  ``m0``/``x0`` warm-start the
    active-set rounds and skip FISTA.  While the port is traced, the tile
    QP's continuation rounds, summed on the device, and its tiles go to
    the counters ``k2.rounds`` and ``k2.tiles``, its tiles again to
    ``k2.lockstep`` where n sends them down the kernel's lockstep path
    (``cuda_qp.qp_lockstep``; else 0), and the tiles whose
    continuation ended by the stall test or at the round cap to
    ``k2.stalled`` and ``k2.capped``; with ``valid`` (C, M), the
    atoms with x > 0 of the valid voxels and those voxels, summed on the
    device, go to ``k2.support`` and ``k2.voxels`` (the tile driver reads
    the device sums after its synchronise)."""
    kw = dict(solver_kw or {})
    if backend == 'xla':
        return nneg_qp_batch(G[:, None], b, lam1, lam2, mask=mask,
                             L=L[:, None], m0=m0, x0=x0, **kw)
    if backend != 'pallas':
        raise ValueError(f'unknown backend {backend!r}')
    if not trace.on():
        return nneg_qp_tiles(G, b, L, lam1, lam2, mask=mask, m0=m0, x0=x0,
                             **kw)
    rounds, exits = torch.empty((2, b.shape[0]), dtype=torch.int32,
                                device=b.device)
    x = nneg_qp_tiles(G, b, L, lam1, lam2, mask=mask, m0=m0, x0=x0,
                      tile_rounds=rounds, tile_exits=exits, **kw)
    trace.count_on_device('k2.rounds', rounds.sum())
    trace.count('k2.tiles', b.shape[0])
    trace.count('k2.lockstep', b.shape[0] if qp_lockstep(b.shape[-1]) else 0)
    for counter, exit in (('k2.stalled', 'stalled'), ('k2.capped', 'cap')):
        trace.count_on_device(counter,
                              (exits == TAIL_EXITS.index(exit)).sum())
    if valid is not None:
        trace.count_on_device('k2.support', ((x > 0) & valid[..., None]).sum())
        trace.count_on_device('k2.voxels', valid.sum())
    return x
