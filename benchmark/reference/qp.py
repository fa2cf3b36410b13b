"""Exact non-negative solves for the reference (SciPy's Lawson-Hanson)."""
from __future__ import annotations

import numpy as np
from scipy.optimize import nnls


def nonneg_lsq(A: np.ndarray, y: np.ndarray) -> np.ndarray:
    """argmin |y - A x|^2 over x >= 0."""
    return nnls(A, y, maxiter=50 * A.shape[1])[0]


def nonneg_elastic_net(A: np.ndarray, y: np.ndarray, lam1: float,
                       lam2: float) -> np.ndarray:
    """argmin 1/2 |y - A x|^2 + lam1 sum(x) + lam2/2 |x|^2 over x >= 0
    (SPAMS' lasso, mode 2, pos=True), as a Lawson-Hanson solve on the
    Cholesky factor R of A'A + lam2 I: 1/2 |R x - R^-T (A'y - lam1)|^2 has
    the same minimiser."""
    G = A.T @ A + lam2 * np.eye(A.shape[1])
    R = np.linalg.cholesky(G).T
    c = np.linalg.solve(R.T, A.T @ y - lam1)
    return nnls(R, c, maxiter=50 * A.shape[1])[0]
