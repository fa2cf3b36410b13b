"""Batched non-negative solvers on PyTorch (counterpart of
``amico_tpu.ops.solvers``): the stagewise ``nneg_qp_batch`` that the models'
``backend='xla'`` route runs, its helpers, and ``gram``.

Plain tensor code, like the JAX module, which XLA compiles outside any
Pallas kernel.  Every function keeps the JAX signature, broadcasting rules
and dtype handling (float32, or float64 for the oracle tests).

The JAX solver exits its ``while_loop``\\ s on conditions reduced over the
whole call (not per tile or per voxel), and so does this one.  PyTorch has
no ``while_loop``: each loop runs its trip count in Python and, once the
exit condition holds, freezes its state (every update becomes
``torch.where(done, old, new)``).  The flag is read on the host every
``_SYNC_EVERY`` iterations on a CUDA device (every iteration on the CPU) to
stop early, so the result is the JAX result whatever the reading interval.
"""
from __future__ import annotations

import torch

_SYNC_EVERY = 8     # iterations between host reads of a loop's exit flag


def gram(A: torch.Tensor) -> torch.Tensor:
    """A'A for A (..., m, n), in float32 (TF32 is off, see device.py)."""
    return torch.matmul(A.transpose(-1, -2), A)


def _mv(G: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcasting matvec: (..., n, n) @ (..., n) -> (..., n).

    A Gram shared by a tile's voxels, G (..., 1, n, n) against x (..., M,
    n), runs as one product x G' per tile, never expanded per voxel."""
    if G.dim() == 2:
        return torch.matmul(x, G.transpose(-1, -2))
    if G.shape[-3] == 1 and G.dim() == x.dim() + 1:
        return torch.matmul(x, G.squeeze(-3).transpose(-1, -2))
    return torch.matmul(G, x.unsqueeze(-1)).squeeze(-1)


def _exit_check(x: torch.Tensor, i: int) -> bool:
    """Whether loop iteration ``i`` reads its exit flag on the host."""
    return x.device.type != 'cuda' or i % _SYNC_EVERY == 0


def power_iteration_L(G: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """Largest eigenvalue of symmetric PSD G (..., n, n) -> (...,)."""
    n = G.shape[-1]
    v = torch.ones(G.shape[:-1], dtype=G.dtype, device=G.device) \
        / torch.sqrt(torch.tensor(float(n), dtype=G.dtype))
    for _ in range(iters):
        w = _mv(G, v)
        v = w / (torch.linalg.vector_norm(w, dim=-1, keepdim=True) + 1e-30)
    w = _mv(G, v)
    return (v * w).sum(-1)


def _cg_masked(G, b, m, x0, lam2, iters: int):
    """Batched conjugate gradient for (G + lam2 I) z = b restricted to the
    support mask m (off-support coordinates pinned to 0)."""
    def Aop(p):
        return (_mv(G, p) + lam2 * p) * m

    z = x0 * m
    r = (b * m) - Aop(z)
    p = r
    rs = (r * r).sum(-1, keepdim=True)
    for _ in range(int(iters)):
        Ap = Aop(p)
        denom = (p * Ap).sum(-1, keepdim=True)
        # f32 Grams can carry tiny negative eigenvalues: on negative
        # curvature freeze the step and restart the direction at r
        safe = denom > 1e-30
        alpha = torch.where(safe, rs / torch.where(safe, denom, 1.0), 0.0)
        z = z + alpha * p
        r = r - alpha * Ap
        rs_new = (r * r).sum(-1, keepdim=True)
        beta = torch.where(safe, rs_new / (rs + 1e-30), 0.0)
        p = r + beta * p
        rs = rs_new
    return torch.where(torch.isfinite(z), z, 0.0)


def nneg_qp_batch(G, b, lam1=0.0, lam2=0.0, mask=None, L=None,
                  fista_iters: int = 200, cd_sweeps: int = 40, x0=None,
                  refine_rounds: int = 0, cg_iters=32,
                  inner_passes: int = 2, m0=None, early_exit: bool = True,
                  converge=False, add_k: int = 1):
    """Solve min_x 0.5 x'Gx - b'x + lam1 1'x + 0.5 lam2 |x|^2,  x >= 0
    for a broadcastable batch of problems, as the JAX ``nneg_qp_batch``:
    FISTA with adaptive restart, a cyclic coordinate-descent polish, then
    Lawson-Hanson rounds (masked CG, ratio-test step back, prune, top-k
    adds), with ``converge`` rounds past the schedule until the working
    sets are stable.

    G broadcastable to (..., n, n) against b (..., n) (e.g. (n, n) shared,
    (B, n, n) per problem, or (T, 1, n, n) per tile); ``mask``, ``m0`` and
    ``x0`` broadcastable to b; ``L`` Lipschitz constants broadcastable to
    b's batch dims (power iteration when None).  ``cg_iters`` is an int
    (flat budget) or a per-round tuple; ``converge`` a bool or an int CG
    budget.  See the JAX docstring for each knob."""
    b = torch.as_tensor(b)
    dt, dev = b.dtype, b.device
    G = torch.as_tensor(G, dtype=dt, device=dev)
    n = b.shape[-1]
    lam1 = torch.as_tensor(lam1, dtype=dt, device=dev)
    lam2 = torch.as_tensor(lam2, dtype=dt, device=dev)

    if L is None:
        L = power_iteration_L(G)
    L = torch.as_tensor(L, dtype=dt, device=dev)
    step = 1.0 / (L[..., None] + lam2 + 1e-30) if L.dim() else \
        1.0 / (L + lam2 + 1e-30)

    if mask is not None:
        mask = torch.as_tensor(mask, dtype=dt, device=dev)

    x_init = torch.zeros_like(b) if x0 is None else \
        torch.as_tensor(x0, dtype=dt, device=dev).expand(b.shape)
    if mask is not None:
        x_init = x_init * mask

    def prox(v):
        out = torch.clamp(v, min=0.0)
        return out * mask if mask is not None else out

    def fista_body(x, z, t):
        grad = _mv(G, z) - b + lam2 * z
        x_new = prox(z - step * (grad + lam1))
        # adaptive gradient restart (per problem)
        restart = ((z - x_new) * (x_new - x)).sum(-1) > 0.0
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        t_eff = torch.where(restart, 1.0, t_new)
        beta = torch.where(restart, 0.0, (t - 1.0) / t_new)[..., None]
        return x_new, x_new + beta * (x_new - x), t_eff

    x, z = x_init, x_init
    t = torch.ones(b.shape[:-1], dtype=dt, device=dev)
    if fista_iters > 0 and m0 is None:
        if early_exit:
            # the JAX while_loop: run while i < fista_iters and (i < 2 or
            # some coordinate of the batch moved by > ftol * max|b|)
            bscale = b.abs().amax() + 1e-30
            ftol = 1e-4 if dt == torch.float32 else 1e-6
            run = torch.ones((), dtype=torch.bool, device=dev)
            for i in range(fista_iters):
                if _exit_check(b, i) and not bool(run):
                    break
                xn, zn, tn = fista_body(x, z, t)
                moved = (xn - x).abs().amax() > ftol * bscale
                x = torch.where(run, xn, x)
                z = torch.where(run, zn, z)
                t = torch.where(run, tn, t)
                if i >= 1:          # the counter is i + 1 >= 2 from here
                    run = run & moved
        else:
            for _ in range(fista_iters):
                x, z, t = fista_body(x, z, t)

    # ---- coordinate-descent polish (exact coordinate minimization) ----
    if cd_sweeps > 0 and m0 is None:
        Gdiag = torch.diagonal(G, dim1=-2, dim2=-1)         # (..., n)
        l1v = lam1.expand(b.shape) if lam1.dim() else lam1
        l2v = lam2.expand(b.shape) if lam2.dim() else lam2
        maskv = mask.expand(b.shape) if mask is not None else None
        x = x.clone()
        q = _mv(G, x)
        for _ in range(cd_sweeps):
            for j in range(n):
                xj = x[..., j]
                gjj = Gdiag[..., j]
                l1 = l1v[..., j] if lam1.dim() else l1v
                l2 = l2v[..., j] if lam2.dim() else l2v
                rj = b[..., j] - (q[..., j] - gjj * xj) - l1
                xj_new = torch.clamp(rj / (gjj + l2 + 1e-30), min=0.0)
                if maskv is not None:
                    xj_new = xj_new * maskv[..., j]
                delta = xj_new - xj
                # row j of G broadcasts against the batch dims of delta
                q = q + delta[..., None] * G[..., j, :]
                x[..., j] = xj_new

    # ---- active-set polish: batched Lawson-Hanson rounds ----
    if refine_rounds > 0:
        cg_schedule = tuple(cg_iters) if isinstance(cg_iters, (tuple, list)) \
            else None
        cg_cap = max(cg_schedule) if cg_schedule else int(cg_iters)
        b_eff = b - lam1
        scale = b_eff.abs().amax(-1, keepdim=True) + 1e-30
        tol = 3e-6 if dt == torch.float32 else 1e-10
        big = torch.finfo(dt).max
        allowed_mask = mask if mask is not None else 1.0

        def inner_solve(x, m, iters):
            z = _cg_masked(G, b_eff, m, x, lam2, iters)
            # classic LH ratio test: only coords with x > 0 bound the step
            # (an entering atom would freeze the step at alpha = 0)
            neg = (z <= 0.0) & (m > 0.0) & (x > 0.0)
            ratio = torch.where(neg, x / (x - z + 1e-30), big)
            alpha = ratio.amin(-1, keepdim=True).clamp(0.0, 1.0)
            x = (x + alpha * (z - x)) * m
            m = m * (x > tol * scale).to(dt)
            return x * m, m

        def as_round(x, m, iters):
            """One round; also whether the whole batch is stable (0-dim)."""
            m_before = m
            for _ in range(inner_passes):
                x, m = inner_solve(x, m, iters)
            # addition step: best violated atom outside the working set;
            # max() takes the first index among equal maxima, as jnp.argmax
            w = b_eff - _mv(G, x) - lam2 * x
            w_cand = torch.where((1.0 - m) * allowed_mask > 0.0, w, -big)
            wmax, jstar = w_cand.max(-1, keepdim=True)
            add = (wmax > tol * scale).to(dt)
            onehot = torch.zeros_like(w_cand).scatter_(-1, jstar, 1.0)
            m_new = torch.clamp(m + add * onehot, max=1.0)
            for _k in range(1, add_k):
                # next most-violated atom under the same tol gate;
                # stability keys on the first add
                w_cand = torch.where(onehot > 0.0, -big, w_cand)
                wk, jstar = w_cand.max(-1, keepdim=True)
                addk = (wk > tol * scale).to(dt)
                onehot = torch.zeros_like(w_cand).scatter_(-1, jstar, 1.0)
                m_new = torch.clamp(m_new + addk * onehot, max=1.0)
            stable = (add.amax() <= 0.0) & \
                ((m_new - m_before).abs().amax() <= 0.0)
            return x, m_new, stable

        def frozen_rounds(x, m, done, count, iters, xtol=None):
            """Up to ``count`` rounds while not ``done`` (a 0-dim flag):
            the JAX while_loops of the flat schedule and of ``converge``.
            ``xtol`` adds converge's second criterion: a round that moves
            no coordinate of the batch by more than ``xtol``."""
            for i in range(count):
                if _exit_check(b, i) and bool(done):
                    break
                xn, mn, st = as_round(x, m, iters)
                if xtol is not None:
                    st = st | ((xn - x).abs().amax() <= xtol)
                x = torch.where(done, x, xn)
                m = torch.where(done, m, mn)
                done = done | st
            return x, m, done

        if m0 is not None:
            m = torch.as_tensor(m0, dtype=dt, device=dev).expand(b.shape)
        else:
            m = (x > 0.0).to(dt)
        if mask is not None:
            m = m * mask
        false = torch.zeros((), dtype=torch.bool, device=dev)
        if cg_schedule is not None:
            # per-round budgets, cut to refine_rounds and extended at the
            # last budget; every round runs (no exit), as in JAX
            sched = [int(it) for it in cg_schedule[:refine_rounds]]
            if sched and len(sched) < refine_rounds:
                sched += [sched[-1]] * (refine_rounds - len(sched))
            stable0 = false
            for it in sched:
                x, m, stable0 = as_round(x, m, it)
        elif early_exit:
            x, m, stable0 = frozen_rounds(x, m, false, refine_rounds, cg_cap)
        else:
            stable0 = false
            for _ in range(refine_rounds):
                x, m, stable0 = as_round(x, m, cg_cap)
        if converge:
            # rounds at a full-width CG budget until the batch's working
            # sets are stable or no round moves x (cap 3n rounds)
            cont_it = max(cg_cap, n) if isinstance(converge, bool) \
                else max(cg_cap, int(converge))
            x, m, _ = frozen_rounds(x, m, stable0, 3 * n, cont_it,
                                    xtol=tol * scale.amax())
            x, m = inner_solve(x, m, cont_it)
        else:
            x, m = inner_solve(x, m, cg_cap)
        x = torch.clamp(x, min=0.0)
    return x


def nneg_lasso_from_A(A, y, lam1=0.0, lam2=0.0, **kw):
    """Reference ``lasso`` semantics from (A, y) directly.
    A: (m, n) shared or (B, m, n); y: (B, m)."""
    A = torch.as_tensor(A)
    y = torch.as_tensor(y, dtype=A.dtype, device=A.device)
    G = gram(A)
    if A.dim() == 2:
        b = torch.matmul(y, A)
    else:
        b = torch.matmul(A.transpose(-1, -2), y.unsqueeze(-1)).squeeze(-1)
    return nneg_qp_batch(G, b, lam1=lam1, lam2=lam2, **kw)


def nnls_from_A(A, y, **kw):
    """Reference ``nnls`` semantics (lam1 = lam2 = 0) from (A, y)."""
    return nneg_lasso_from_A(A, y, 0.0, 0.0, **kw)


def noddi_stage2_tiebreak(G2, b2, x2, lam1, lam2, nb_minus, nb_plus,
                          cg_iters: int = 8):
    """Degenerate-vertex objective tie-break for the NODDI stage-2 lasso,
    as the JAX ``noddi_stage2_tiebreak``: per voxel, swap the dominant WM
    atom to each same-ICVF adjacent-kappa neighbour (``nb_minus`` /
    ``nb_plus``, -1 at the grid edge), re-solve a short masked CG on the
    swapped support, and keep the lowest QP objective.

    G2 (C, n, n), b2/x2 (C, M, n); returns the tie-broken x2."""
    n = x2.shape[-1]
    dev = x2.device
    idx = torch.arange(n, device=dev)
    nbm = torch.as_tensor(nb_minus, dtype=torch.int64, device=dev)
    nbp = torch.as_tensor(nb_plus, dtype=torch.int64, device=dev)
    Gt = G2[:, None]                     # one Gram per tile, as _mv takes it

    def obj(x):
        q = _mv(Gt, x) + lam2 * x
        return 0.5 * (x * q).sum(-1) - (b2 * x).sum(-1) + lam1 * x.sum(-1)

    sup = (x2 > 0.0).to(x2.dtype)
    dom = torch.argmax(x2, dim=-1)                            # (C, M)
    oh_dom = (idx == dom[..., None]).to(x2.dtype)
    F_best = obj(x2)
    x_best = x2
    for nbt in (nbm, nbp):
        nbv = nbt[dom]                                        # (C, M)
        valid = nbv >= 0
        oh_nb = ((idx == nbv[..., None]) & valid[..., None]).to(x2.dtype)
        m_c = torch.clamp(sup * (1.0 - oh_dom) + oh_nb, 0.0, 1.0)
        z = _cg_masked(Gt, b2 - lam1, m_c, x2 * (1.0 - oh_dom), lam2,
                       cg_iters)
        x_c = torch.clamp(z, min=0.0) * m_c
        F_c = obj(x_c)
        take = valid & (F_c < F_best)
        x_best = torch.where(take[..., None], x_c, x_best)
        F_best = torch.where(take, F_c, F_best)
    return x_best
