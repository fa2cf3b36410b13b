"""Copy of ``amico_tpu/ops/special.py`` for the port, which imports nothing of
``amico_tpu``.

Special-function helpers for signal synthesis.

The reference hard-codes 60-entry root tables for the GPD approximation
(reference amico/synthesis.py:269-290 sphere, 405-426 cylinder).  We
compute the same mathematical constants programmatically:

* cylinder: roots of ``J_1'(x) = 0`` (first-derivative zeros of the Bessel
  function of the first kind, order 1) -- scipy ``jnp_zeros``;
* sphere: roots of ``j_1'(x) = 0`` (derivative of the *spherical* Bessel
  function of order 1), found by bracketing + brentq.

(The reference's sphere table duplicates one root and skips another around
x=160 -- a transcription artifact; those high roots contribute < 1e-20 to
the GPD sum, so parity is unaffected either way.)
"""
from __future__ import annotations

import functools

import numpy as np
from scipy.optimize import brentq
from scipy.special import jnp_zeros, spherical_jn


@functools.lru_cache(maxsize=None)
def cylinder_gpd_roots(n: int = 60) -> np.ndarray:
    """First n roots of J_1'(x)=0; reference table synthesis.py:405-426."""
    return jnp_zeros(1, n)


def _j1p(x: float) -> float:
    return spherical_jn(1, x, derivative=True)


@functools.lru_cache(maxsize=None)
def sphere_gpd_roots(n: int = 60) -> np.ndarray:
    """First n roots of j_1'(x)=0; reference table synthesis.py:269-290.

    Roots are spaced ~pi apart starting near 2.08; bracket on a fine grid.
    """
    roots = []
    x0, step = 1.0, 0.05
    x = x0
    f_prev = _j1p(x)
    while len(roots) < n:
        x_next = x + step
        f_next = _j1p(x_next)
        if f_prev == 0.0:
            roots.append(x)
        elif f_prev * f_next < 0:
            roots.append(brentq(_j1p, x, x_next, xtol=1e-14))
        x, f_prev = x_next, f_next
    return np.array(roots[:n])


def gpd_sum(am: np.ndarray, big_delta, small_delta, diff: float,
            radius: float, n: int) -> np.ndarray:
    """Vectorized GPD (Gaussian-phase-distribution) sum.

    Port of the reference scalar loop (synthesis.py:12-28) without the early
    break: the sum over all 60 roots differs by < _REQUIRED_PRECISION.
    ``big_delta``/``small_delta`` may be arrays (broadcast against roots).

    nom  = 2*dam*delta - 2 + 2 e^{-dam delta} + 2 e^{-dam Delta}
           - e^{-dam(Delta-delta)} - e^{-dam(Delta+delta)}
    den  = dam^2 * am^2 * (R^2 am^2 - n)
    """
    am = np.asarray(am, np.float64)[:, None]
    big_delta = np.atleast_1d(np.asarray(big_delta, np.float64))[None, :]
    small_delta = np.atleast_1d(np.asarray(small_delta, np.float64))[None, :]
    dam = diff * am * am
    e1 = np.exp(-dam * small_delta)
    e2 = np.exp(-dam * big_delta)
    e3 = np.exp(-dam * (big_delta - small_delta))
    e4 = np.exp(-dam * (big_delta + small_delta))
    nom = 2 * dam * small_delta - 2 + 2 * e1 + 2 * e2 - e3 - e4
    denom = dam * dam * am * am * (radius * radius * am * am - n)
    return np.sum(nom / denom, axis=0)
