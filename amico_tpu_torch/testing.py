"""Synthetic-data helpers for the port's tests and chip_smoke.py
(counterpart of ``amico_tpu.testing``, without its JAX compile cache)."""
from __future__ import annotations

import hashlib
import os
import tempfile

import numpy as np

from . import lut as _lut
from .io.scheme import Scheme
from .ops.sphere import fibonacci_hemisphere, resolve_source

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


def czb_scheme() -> Scheme:
    """The JAX bench's STEJSKALTANNER protocol for CylinderZeppelinBall:
    1 b0 + 30 directions at b = 3000 + 30 at b = 6000 s/mm^2, Delta = 35
    ms, delta = 15 ms (61 samples, 7 columns)."""
    from .io.scheme import GAMMA
    Delta, delta = 0.035, 0.015
    rows = [np.array([[0, 0, 0, 0, Delta, delta, Delta + delta]])]
    for b in (3000.0, 6000.0):
        G = np.sqrt(b * 1e6 / (GAMMA ** 2 * delta ** 2 * (Delta - delta / 3)))
        rows.append(np.c_[fibonacci_hemisphere(30), np.full(30, G),
                          np.full(30, Delta), np.full(30, delta),
                          np.full(30, Delta + delta)])
    return Scheme(np.vstack(rows))


def demo_czb(scheme: Scheme | None = None, kernels_dir: str | None = None,
             Rs=None):
    """Build the port's CylinderZeppelinBall model (the default 21 radii,
    or ``Rs``) + resampled KERNELS + hash table on ``scheme`` (default
    :func:`czb_scheme`), cached in ``kernels_dir`` as :func:`demo_noddi`
    caches its atoms."""
    from .models import CylinderZeppelinBall
    model = CylinderZeppelinBall()
    if Rs is not None:
        model.set(Rs=Rs)
    return _demo_model(model, scheme or czb_scheme(), kernels_dir)


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


def _tiles(y: np.ndarray, lut_idx: np.ndarray, device, n_tiles: int,
           M: int = 128):
    """The first ``n_tiles`` M-voxel tiles of voxels ``y`` as a model's
    fit gathers them: signals Y (n_tiles, M, nS) float32 and the tiles'
    LUT directions (n_tiles,)."""
    import torch
    from .models.engine import build_tile_plan
    plan = build_tile_plan(lut_idx, M)
    y_ext = torch.as_tensor(np.concatenate([y, np.zeros((1, y.shape[1]))]),
                            dtype=torch.float32, device=device)
    perm = torch.as_tensor(plan.perm[:n_tiles * M].astype(np.int64),
                           device=device)
    dirs = torch.as_tensor(plan.tile_dirs[:n_tiles].astype(np.int64),
                           device=device)
    return y_ext[perm].view(n_tiles, M, -1), dirs


def noddi_tile_inputs(model, kernels, htable, device, n_tiles: int,
                      seed: int = 0, M: int = 128) -> list:
    """The fused solve's inputs (G1, G2, b1, Y_dwi, A2T, iso_dwi, icvf,
    kappa) for the first ``n_tiles`` M-voxel tiles of ``demo_voxels``
    (n_tiles x 5M/4 of them), built as ``model.fit`` builds them."""
    from .models._fitops import project
    y, _, lut_idx = demo_voxels(n_tiles * M * 5 // 4, kernels, htable,
                                seed=seed)
    Y, dirs = _tiles(y, lut_idx, device, n_tiles, M)
    c = model.prepare(kernels, device)
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


def solve_work(twin, *args, **kwargs):
    """Run a tile-solve twin (``noddi_fused_tiles_torch`` or
    ``nneg_qp_tiles_torch``) on its inputs and count the work that its
    kernel needs on them: the least operations of the roofline bound.

    Every matvec of the twin (``_as_solve``'s ``G v``) is counted at 2 x
    (rows the solve needs) x (nonzeros of v) per voxel: a CG step needs
    only the working set's rows, an add step the gradient outside it, a
    FISTA step every allowed row.  A CG step adds ~12 operations per
    working-set row (the dots and the axpys).  A ``converge`` round counts
    only on the tiles still running, as the kernel runs it; the Lipschitz
    power iterations and stage 2's ``A2 Y2`` count in full.  Also counted,
    for the kernels' shared-memory traffic: the 32-lane Gram reads a matvec
    makes, ceil(n/32) per nonzero for a full matvec and one per
    working-set slot (a 32-row band holding a working-set row) for a CG
    one.  Returns (the twin's output, a dict of float totals)."""
    import torch
    keys = ('flops', 'matvecs', 'nonzeros', 'rows', 'reads_full',
            'reads_slots')
    acc = {}

    def add(key, t):
        t = t.double().sum()
        acc[key] = acc[key] + t if key in acc else t

    def on_dense(flops):
        add('flops', torch.tensor(flops))

    def on_matvec(v, rows, name, run):
        nnz = (v != 0).sum(-1).to(v.dtype)
        nrows = (rows > 0).sum(-1).to(v.dtype)
        n = v.shape[-1]
        K = -(-n // 32)
        add('flops', 2.0 * nnz * nrows * run)
        if name == 'cg':
            add('flops', 12.0 * nrows * run)
        add('matvecs', run)
        add('nonzeros', nnz * run)
        add('rows', nrows * run)
        add('reads_full', K * nnz * run)
        if name == 'cg':
            pad = torch.nn.functional.pad(rows, (0, 32 * K - n))
            slots = (pad.view(pad.shape[:-1] + (K, 32)) > 0).any(-1).sum(-1)
            add('reads_slots', slots.to(v.dtype) * nnz * run)
        else:
            add('reads_slots', K * nnz * run)

    with _TwinMatvecs(on_matvec, on_dense):
        out = twin(*args, **kwargs)
    return out, {k: float(acc[k]) if k in acc else 0.0 for k in keys}


class _TwinMatvecs:
    """While the block runs, ``torch.matmul`` reports each matvec of the
    twins' ``_as_solve`` (its ``G v``) as ``on_matvec(v, rows, name, run)``:
    the vectors v (..., n), the rows the solve needs of the product (a CG
    step the working set, an add step the allowed rows outside it, a
    FISTA step every allowed row), the caller's name ('cg', 'as_round',
    '_fista') and ``run`` (v.shape[:-1]), 1 where the tile still runs (a
    ``converge`` round runs only on the tiles not done) and 0 elsewhere.
    The dense products of ``_lipschitz`` and ``_fused_raw_torch`` go to
    ``on_dense(flops)``."""

    def __init__(self, on_matvec, on_dense=None):
        self.on_matvec, self.on_dense = on_matvec, on_dense

    def __enter__(self):
        import sys

        import torch
        from .ops import cuda_qp
        solve_code = cuda_qp._as_solve.__code__
        mv_code = next(c for c in solve_code.co_consts
                       if getattr(c, 'co_name', None) == 'mv')
        matmul = self.matmul = torch.matmul

        def counted(a, b, *rest, **kw):
            out = matmul(a, b, *rest, **kw)
            code = sys._getframe(1).f_code
            if code is mv_code:
                report(a, sys._getframe(2))
            elif self.on_dense and code.co_name in ('_lipschitz',
                                                    '_fused_raw_torch'):
                self.on_dense(2.0 * out.numel() * a.shape[-1])
            return out

        def report(v, caller):
            loc = caller.f_locals
            name = caller.f_code.co_name
            rows = {'cg': lambda: loc['m'],
                    'as_round': lambda: (1.0 - loc['m']) * loc['cmask'],
                    '_fista': lambda: loc['cmask']}[name]()
            run = torch.ones(v.shape[:-1], dtype=v.dtype, device=v.device)
            f, chain = caller, []
            while f.f_code is not solve_code:
                chain.append(f.f_code.co_name)
                f = f.f_back
            if 'as_round' in chain and 'done' in f.f_locals:
                run = run * (~f.f_locals['done']).to(v.dtype).view(
                    (-1,) + (1,) * (v.dim() - 2))
            self.on_matvec(v, rows, name, run)

        torch.matmul = counted
        return self

    def __exit__(self, *exc):
        import torch
        torch.matmul = self.matmul


TAIL_EXITS = ('off', 'stable', 'stalled', 'xtol', 'cap')  # cuda_qp's


def qp_tail(G, b, L=None, lam1=0.0, lam2=0.0, **kw):
    """Run ``nneg_qp_tiles_torch`` on its inputs (its arguments) and read
    what each tile's ``converge`` continuation did, the tail that sets a
    tile QP launch's time.  Per tile (C,):

    - ``rounds``: the continuation rounds the tile ran;
    - ``exit``: what ended them, an index into ``TAIL_EXITS``: 'stable'
      (no voxel added an atom or changed its working set in a round; with
      0 rounds, the schedule's last round did), 'stalled' (each voxel was
      stable or back in the working set of one of its last
      ``cuda_qp.STALL_ROUNDS`` rounds, or in its anchor, without a lower
      objective), 'xtol'
      (x moved by at most tol * the tile's largest max|b_eff|), 'cap' (the
      round cap, 3 * npad) or 'off' (no continuation in the schedule);
    - ``matvecs``: the matvecs on a voxel's chain (every voxel of a tile
      runs as many, one after another);
    - ``chain_nonzeros``: the tile's longest voxel chain counted in the
      nonzeros its matvecs walk, one G row read (one shuffle and fma step
      of the kernel's matvec) each;

    and ``cap``, the schedule's round cap.  It reads the twin as
    :func:`solve_work` does (``_as_solve``'s locals as the solve runs), so
    the twin's own arithmetic is what is read, and it decides each exit
    anew from the round's state (its stability, its working sets and
    objectives against the history and the anchors the round started from,
    and x against x before the round) rather than from the twin's verdict,
    which it checks.  Returns (x, that dict)."""
    import sys

    import torch
    from .ops import cuda_qp
    solve_code = cuda_qp._as_solve.__code__
    C, M = b.shape[:2]
    dev = b.device
    tail = {'rounds': torch.zeros(C, dtype=torch.int64, device=dev),
            'exit': torch.zeros(C, dtype=torch.int64, device=dev)}
    chain = {'matvecs': torch.zeros(C, M, dtype=torch.float64, device=dev),
             'chain_nonzeros': torch.zeros(C, M, dtype=torch.float64,
                                           device=dev)}
    # the twin's `done` when last seen new, x, the history and the anchors
    # then
    seen = {'done': None}
    exit_of = {e: TAIL_EXITS.index(e) for e in TAIL_EXITS}

    def on_matvec(v, rows, name, run):
        run = run.double()
        chain['matvecs'] += run
        chain['chain_nonzeros'] += (v != 0).sum(-1).double() * run

    def whole(v):                               # per voxel -> per tile
        return v.flatten(1).all(1)

    def round_exits(f):
        """Each tile's exit by the continuation round just run (C,); 'cap'
        where the round ended nothing."""
        st, mn, fn = f['st'], f['mn'], f['fn']
        settled = st
        if f['stall']:
            for pm, pf in seen['past'] + [seen['anchor']]:
                settled = settled | ((mn == pm).all(-1)
                                     & (fn >= pf - cuda_qp.STALL * pf.abs()))
        moved = (f['xn'] - seen['x']).abs().flatten(1).amax(1)
        return torch.where(whole(st), exit_of['stable'], torch.where(
            whole(settled), exit_of['stalled'], torch.where(
                moved <= f['xtol'], exit_of['xtol'], exit_of['cap'])))

    def local(frame, event, arg):
        # `done` is bound by the schedule's last round, then rebound after
        # each continuation round: a new tensor marks a round just run
        done = frame.f_locals.get('done') if event == 'line' else None
        prev = seen['done']
        if done is not None and done is not prev:
            f = frame.f_locals
            if prev is None:
                tail['exit'] = torch.where(done, exit_of['stable'],
                                           exit_of['cap'])
            else:
                tail['rounds'] += (~prev).long()
                ended = round_exits(f)
                if not torch.equal(done, prev | (ended != exit_of['cap'])):
                    raise AssertionError('the twin ended other tiles than '
                                         'its round state says')
                tail['exit'] = torch.where(done & ~prev, ended, tail['exit'])
            seen.update(done=done, x=f['x'], past=f['past'],
                        anchor=(f['am'], f['af']))
        return local

    def glob(frame, event, arg):
        return local if frame.f_code is solve_code else None

    old = sys.gettrace()
    sys.settrace(glob)
    try:
        with _TwinMatvecs(on_matvec):
            x = cuda_qp.nneg_qp_tiles_torch(G, b, L, lam1, lam2, **kw)
    finally:
        sys.settrace(old)
    tail.update({k: v.amax(-1) for k, v in chain.items()})
    sched_kw = {k: v for k, v in kw.items()
                if k not in ('cd_sweeps', 'mask', 'm0', 'x0')}
    tail['cap'] = cuda_qp.qp_schedule(b.shape[-1], **sched_kw).cont_rounds
    return x, tail


def tail_histogram(tail) -> dict:
    """:func:`qp_tail`'s tiles by continuation rounds (0, 1-8, 9 to the cap
    less one, at the cap) and by exit, as counts."""
    r, cap = tail['rounds'], tail['cap']
    bins = {'0': r == 0, '1-8': (r >= 1) & (r <= 8),
            f'9-{max(cap - 1, 9)}': (r >= 9) & (r < cap),
            'cap': (r >= cap) & (r > 0)}
    return {'rounds': {k: int(v.sum()) for k, v in bins.items()},
            'exit': {name: int((tail['exit'] == i).sum())
                     for i, name in enumerate(TAIL_EXITS)}}


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
                          seed: int = 0, M: int = 128) -> list:
    """The tile QP's inputs [G, b] for the first ``n_tiles`` M-voxel tiles
    of :func:`freewater_voxels` (n_tiles x 5M/4 of them), built as
    ``FreeWater.fit`` builds them."""
    from .models._fitops import project
    y, _, lut_idx, _ = freewater_voxels(n_tiles * M * 5 // 4, kernels,
                                        htable, seed=seed)
    Y, dirs = _tiles(y, lut_idx, device, n_tiles, M)
    c = model.prepare(kernels, device)
    return [c['G_all'][dirs], project(c['A_all'][dirs], Y)]


def czb_voxels(n: int, kernels: dict, htable: np.ndarray, seed: int = 0):
    """Random CylinderZeppelinBall mixtures through the actual dictionary
    + noise, :func:`freewater_voxels`'s recipe over the 26 atoms (weights
    U(0,1) on ~30% of the atoms, +0.5 on one atom, normalised; 0.002
    Gaussian noise, clipped at 0), drawn in bulk.  Returns (y (n, nS),
    DIRs (n, 3), true LUT directions (n,), weights W (n, n_atoms))."""
    from .models.cylinder_zeppelin_ball import czb_dictionary
    rng = np.random.RandomState(seed)
    K = czb_dictionary(kernels)                        # (ndirs, nS, na)
    na = K.shape[-1]
    DIRs = rng.randn(n, 3)
    DIRs /= np.linalg.norm(DIRs, axis=1, keepdims=True)
    lut_idx = _lut.dir_to_lut_idx(DIRs, htable)
    W = rng.rand(n, na) * (rng.rand(n, na) < 0.3)
    W[np.arange(n), rng.randint(na, size=n)] += 0.5
    W /= np.maximum(W.sum(1, keepdims=True), 1e-9)
    y = np.empty((n, K.shape[1]), np.float64)
    step = 8192
    for i in range(0, n, step):
        sl = slice(i, min(i + step, n))
        y[sl] = np.einsum('bsa,ba->bs', K[lut_idx[sl]], W[sl])
    y = np.clip(y + 0.002 * rng.randn(*y.shape), 0, None)
    return y, DIRs, lut_idx, W


def demo_sandi(scheme: Scheme | None = None, kernels_dir: str | None = None):
    """Build the port's SANDI model + resampled KERNELS + hash table on
    ``scheme`` (default :func:`czb_scheme`, whose two shells' directional
    average is the JAX bench's SANDI protocol: b0 + b = 3000 and 6000
    s/mm^2 at Delta = 35 ms, delta = 15 ms), cached in ``kernels_dir`` as
    :func:`demo_noddi` caches its atoms."""
    from .models import SANDI
    return _demo_model(SANDI(), scheme or czb_scheme(), kernels_dir)


def sandi_voxels(n: int, kernels: dict, seed: int = 0):
    """Random SANDI mixtures of the un-normalised atoms + noise,
    ``tests/test_models.py::test_sandi_fit_parity``'s recipe (weights
    U(0,1) on ~30% of the atoms, +0.5 on one atom, normalised; 0.002
    Gaussian noise, clipped at 0), drawn in bulk.  The atoms are isotropic,
    so a voxel's signal is the same on every direction of a shell.
    Returns (y (n, nS), weights W (n, n_atoms))."""
    rng = np.random.RandomState(seed)
    A = kernels['signal'] / kernels['norms'][None, :]    # un-normalised
    na = A.shape[1]
    W = rng.rand(n, na) * (rng.rand(n, na) < 0.3)
    W[np.arange(n), rng.randint(na, size=n)] += 0.5
    W /= np.maximum(W.sum(1, keepdims=True), 1e-9)
    y = W @ A.T
    y = np.clip(y + 0.002 * rng.randn(*y.shape), 0, None)
    return y, W


def sandi_oracle_maps(model, kernels: dict, y: np.ndarray) -> np.ndarray:
    """The six SANDI maps of the exact non-negative elastic net
    ``ops.native.lasso(A, y, lambda1, lambda2)`` (LARS) on one voxel's
    (direction-averaged) signal, un-normalised by the KERNELS' norms, as
    the JAX bench's SANDI oracle computes them."""
    from .ops import native
    n_rs, n_in = len(model.Rs), len(model.d_in)
    x = native.lasso(np.asarray(kernels['signal'], np.float64),
                     np.asarray(y, np.float64),
                     float(model.solver_params['lambda1']),
                     float(model.solver_params['lambda2'])) * kernels['norms']
    xs = x.sum() + 1e-16
    xsph, xstk = x[:n_rs].sum(), x[n_rs:n_rs + n_in].sum()
    xiso = x[n_rs + n_in:].sum()
    return np.array([
        xsph / xs, xstk / xs, xiso / xs,
        1e6 * np.sum(model.Rs * x[:n_rs]) / (xsph + 1e-16),
        1e3 * np.sum(model.d_in * x[n_rs:n_rs + n_in]) / (xstk + 1e-16),
        1e3 * np.sum(model.d_isos * x[n_rs + n_in:]) / (xiso + 1e-16)])


def sandi_oracle_audit(evaluation, n: int = 1000,
                       seed: int = 0) -> np.ndarray:
    """|fitted - oracle| of fsoma, fneurite, fextra and Rsoma (um), (n, 4),
    for ``n`` voxels of a fitted SANDI ``Evaluation``, sampled with
    ``seed``, against :func:`sandi_oracle_maps` on each voxel's signal, as
    the JAX bench audits SANDI (its ``oracle_cols`` 0-3)."""
    y = np.asarray(evaluation.y, np.float64)
    maps = evaluation.RESULTS['MAPs'][evaluation.niiMASK_img == 1]
    rng = np.random.RandomState(seed)
    sel = rng.choice(y.shape[0], size=min(n, y.shape[0]), replace=False)
    ref = np.stack([sandi_oracle_maps(evaluation.model, evaluation.KERNELS,
                                      y[i]) for i in sel])
    return np.abs(maps[sel][:, :4] - ref[:, :4])


def czb_tile_inputs(model, kernels, htable, device, n_tiles: int,
                    seed: int = 0, M: int = 128) -> list:
    """The tile QP's inputs [G, b, L] for the first ``n_tiles`` M-voxel
    tiles of :func:`czb_voxels` (n_tiles x 5M/4 of them), built as
    ``CylinderZeppelinBall.fit`` builds them."""
    from .models._fitops import project
    y, _, lut_idx, _ = czb_voxels(n_tiles * M * 5 // 4, kernels, htable,
                                  seed=seed)
    Y, dirs = _tiles(y, lut_idx, device, n_tiles, M)
    c = model.prepare(kernels, device)
    return [c['G_all'][dirs], project(c['A_all'][dirs], Y), c['L_all'][dirs]]


def czb_oracle_maps(model, A: np.ndarray, y: np.ndarray) -> np.ndarray:
    """v, a, d of the exact non-negative elastic net
    ``ops.native.lasso(A, y, 0, 4)`` (LARS, the reference's
    algorithm) on one voxel, as the JAX bench's CylinderZeppelinBall oracle
    computes them."""
    from .ops import native
    n_rs, n_perp = len(model.Rs), len(model.d_perps)
    x = native.lasso(np.asarray(A, np.float64), np.asarray(y, np.float64),
                     float(model.solver_params['lambda1']),
                     float(model.solver_params['lambda2']))
    f1 = x[:n_rs].sum()
    f2 = x[n_rs:n_rs + n_perp].sum() + 1e-16
    v = f1 / (f1 + f2 + 1e-16)
    a = 1e6 * 2 * np.sum(model.Rs * x[:n_rs]) / (f1 + 1e-16)
    return np.array([v, a, 4 * v / (np.pi * a ** 2 + 1e-16)])


def czb_oracle_audit(evaluation, n: int = 1000, seed: int = 0) -> np.ndarray:
    """|fitted - oracle| of v and a (n, 2) for ``n`` voxels of a fitted
    CylinderZeppelinBall ``Evaluation``, sampled with ``seed``, against
    :func:`czb_oracle_maps` on each voxel's signal and the dictionary of
    its fitted LUT direction.  d = 4v/(pi a^2) is left out, as the JAX
    bench leaves it out: it blows small diameter differences up on
    near-empty voxels."""
    from .models.cylinder_zeppelin_ball import czb_dictionary
    K = czb_dictionary(evaluation.KERNELS)
    y = np.asarray(evaluation.y, np.float64)
    maps = evaluation.RESULTS['MAPs'][evaluation.niiMASK_img == 1]
    rng = np.random.RandomState(seed)
    sel = rng.choice(y.shape[0], size=min(n, y.shape[0]), replace=False)
    lut_idx = _lut.dir_to_lut_idx(
        np.asarray(evaluation.DIRs, np.float64)[sel], evaluation.htable)
    ref = np.stack([czb_oracle_maps(evaluation.model, K[li], y[i])
                    for i, li in zip(sel, lut_idx)])
    return np.abs(maps[sel][:, :2] - ref[:, :2])


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


def qp_agreement(G, b, lam1, lam2, x_kernel, x_twin, maps=None) -> dict:
    """How two solves of the same tile QPs agree (the kernel and its twin,
    or the kernel and the stagewise solver): |x_k - x_t| by median, p95
    and max; the objective 1/2 x'Gx - b'x + lam1 sum(x) + lam2/2 |x|^2 in
    float64, as the 99th percentile and max of the relative gap, and the
    shares of voxels whose kernel objective is worse (and better) than the
    twin's by more than 1e-3 relative.  With ``maps`` (a function of x to
    (..., k) maps, such as :func:`freewater_maps`), also the maps by
    median, p95 and max, per map as ``map_*`` lists and over all maps as
    ``map_median`` etc.: FreeWater's adjacent zeppelins are
    near-collinear, so x can move between them at no cost in the
    objective, and the maps cannot."""
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
    if maps is not None:
        merr = (maps(x_kernel) - maps(x_twin)).abs().cpu().numpy()
        merr = merr.reshape(-1, merr.shape[-1])
        out.update(map_median=float(np.median(merr)),
                   map_p95=float(np.percentile(merr, 95)),
                   map_max=float(merr.max()),
                   map_medians=np.median(merr, 0).tolist(),
                   map_p95s=np.percentile(merr, 95, 0).tolist(),
                   map_maxs=merr.max(0).tolist())
    return out


def write_demo_subject(subject_dir: str, scheme: Scheme, y: np.ndarray,
                       dim: tuple, s0: float = 1000.0) -> None:
    """Write voxel signals ``y`` (prod(dim), nS), scaled by ``s0``, as
    ``DWI.nii`` (float32, 2 mm voxels) and ``scheme`` as ``DWI.scheme``:
    ``VERSION: BVECTOR`` with 4 columns, or for a STEJSKALTANNER scheme
    ``VERSION: 1`` with all 7."""
    from .io import nifti
    os.makedirs(subject_dir, exist_ok=True)
    vol = (s0 * np.asarray(y)).astype(np.float32).reshape(
        tuple(dim) + (y.shape[1],))
    nifti.save(nifti.Nifti1Image(vol, np.diag([2.0, 2.0, 2.0, 1.0])),
               os.path.join(subject_dir, 'DWI.nii'))
    if scheme.version == 1:
        np.savetxt(os.path.join(subject_dir, 'DWI.scheme'), scheme.raw,
                   fmt='%.10g', header='VERSION: 1', comments='')
    else:
        np.savetxt(os.path.join(subject_dir, 'DWI.scheme'),
                   scheme.raw[:, :4], fmt='%.6f', header='VERSION: BVECTOR',
                   comments='')


def noddi_oracle_voxel(kernels, dwi_idx, y_i, lut_i, lam1=0.5, lam2=1e-3):
    """Exact per-voxel NODDI 3-stage solve with the shared native solvers
    (``ops.native``: NNLS, LARS lasso): (1) NNLS on the full
    dictionary for the CSF fraction; (2) non-negative lasso on the
    norm-scaled DWI subproblem with the iso prediction subtracted, clipped
    >= 0; (3) debias NNLS on the positive support with iso forced in.
    Returns the (NDI, ODI, FWF) vector, as ``amico_tpu.testing`` does."""
    from .ops import native
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
    exact non-negative elastic net ``ops.native.lasso(A, y,
    lambda1, lambda2)`` (LARS) on each voxel's signal and the dictionary of
    its fitted LUT direction; its maps are FiberVolume, FW (and FW_blood,
    FW_csf for Mouse), as the fit computes them."""
    from .ops import native
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
