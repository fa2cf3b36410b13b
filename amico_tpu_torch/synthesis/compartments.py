"""Copy of ``amico_tpu/synthesis/compartments.py`` for the port, which imports nothing of
``amico_tpu``.

Analytic compartment signal generators.

Vectorized float64 re-implementation of the reference synthesis layer
(reference amico/synthesis.py).  These run only during one-time kernel
(LUT) generation on the host, so NumPy/SciPy is the right tool: the fit hot
path never touches this module.

Conventions follow the reference exactly:

* tensor family evaluates ``exp(-b g^T D g)`` with axis-aligned eigenvectors
  (synthesis.py:122-143);
* GPD (Gaussian phase distribution) restricted compartments use Neuman root
  sums (synthesis.py:12-28, root tables 269-290/405-426 -- we compute the
  roots, see ops.special);
* the NODDI Watson-distribution machinery is the published NODDI toolbox
  math (synthesis.py:495-845): Watson SH coefficients in three kappa
  regimes, Legendre-Gaussian integrals, hindered-diffusion tensor.
"""
from __future__ import annotations

import numpy as np
from scipy.special import dawsn, erf

from ..io.scheme import GAMMA, Scheme
from ..ops.sh import _assoc_legendre_all
from ..ops.special import cylinder_gpd_roots, gpd_sum, sphere_gpd_roots
from ..utils.logging import ERROR

_GAMMA = GAMMA  # reference synthesis.py:10


# --------------------------------------------------------------------------
# Gaussian (tensor-family) compartments -- reference synthesis.py:94-257
# --------------------------------------------------------------------------
class BaseTensor:
    def __init__(self, scheme: Scheme):
        self.scheme = scheme

    def _get_signal(self, evals) -> np.ndarray:
        """exp(-b g^T diag(evals) g), vectorized over samples
        (reference loop at synthesis.py:136-143)."""
        g = self.scheme.raw[:, :3]
        b = self.scheme.b
        quad = (g * g) @ np.asarray(evals, np.float64)
        return np.exp(-b * quad)


class Tensor(BaseTensor):
    def get_signal(self, diff_par, diff_perp1, diff_perp2):
        return self._get_signal([diff_perp1, diff_perp2, diff_par])


class Stick(BaseTensor):
    def get_signal(self, diff):
        return self._get_signal([0.0, 0.0, diff])


class Zeppelin(BaseTensor):
    def get_signal(self, diff_par, diff_perp):
        return self._get_signal([diff_perp, diff_perp, diff_par])


class Ball(BaseTensor):
    def get_signal(self, diff):
        return self._get_signal([diff, diff, diff])


# --------------------------------------------------------------------------
# GPD restricted compartments -- reference synthesis.py:260-492
# --------------------------------------------------------------------------
class SphereGPD:
    """Sphere of given radius, GPD approximation (synthesis.py:260-345).
    Requires a version-1 (STEJSKALTANNER) scheme."""

    def __init__(self, scheme: Scheme):
        self.scheme = scheme

    def get_signal(self, diff, radius):
        diff = diff * 1e-6
        raw = self.scheme.raw
        g_dir, G = raw[:, :3], raw[:, 3]
        big_delta, small_delta = raw[:, 4], raw[:, 5]
        am = sphere_gpd_roots() / radius
        s = gpd_sum(am, big_delta, small_delta, diff, radius, 2)
        g_mod = np.linalg.norm(g_dir, axis=1) * G
        signal = np.exp(-2.0 * _GAMMA * _GAMMA * g_mod * g_mod * s)
        signal = np.where((g_dir == 0).all(axis=1), 1.0, signal)
        return signal


class Astrosticks:
    """Sticks uniformly distributed over orientations (synthesis.py:348-393).

    The closed form reduces to ``sqrt(pi) erf(sqrt(b d)) / (2 sqrt(b d))``
    (the gradient strength cancels), matching the reference formula at
    synthesis.py:390-392.
    """

    def __init__(self, scheme: Scheme):
        self.scheme = scheme

    def get_signal(self, diff):
        raw = self.scheme.raw
        g_dir = raw[:, :3]
        b = self.scheme.b
        bd = np.maximum(b * diff, 1e-300)
        sq = np.sqrt(bd)
        signal = np.sqrt(np.pi) * erf(sq) / (2.0 * sq)
        signal = np.where((g_dir == 0).all(axis=1), 1.0, signal)
        return signal


class CylinderGPD:
    """Cylinder of given radius, GPD approximation (synthesis.py:396-492)."""

    def __init__(self, scheme: Scheme):
        self.scheme = scheme

    def get_signal(self, diff, radius, theta=0.0, phi=0.0):
        diff = diff * 1e-6
        raw = self.scheme.raw
        g_dir, G = raw[:, :3], raw[:, 3]
        big_delta, small_delta = raw[:, 4], raw[:, 5]
        n = np.array([np.cos(phi) * np.sin(theta),
                      np.sin(phi) * np.sin(theta),
                      np.cos(theta)])
        am = cylinder_gpd_roots() / radius
        s = gpd_sum(am, big_delta, small_delta, diff, radius, 1)

        g_mods = g_dir * G[:, None]
        g_mod = np.linalg.norm(g_mods, axis=1)
        gn = g_mods @ n
        unit_gn = np.divide(gn, g_mod, out=np.zeros_like(gn), where=g_mod != 0)
        omega = np.arccos(np.clip(unit_gn, -1.0, 1.0))
        sin2 = np.sin(omega) ** 2
        cosw = np.cos(omega)
        sr_perp = np.exp(-2.0 * _GAMMA * _GAMMA * g_mod * g_mod * sin2 * s)
        t = big_delta - small_delta / 3.0
        q_par = _GAMMA * small_delta * g_mod * cosw
        sr_par = np.exp(-t * q_par * q_par * diff)
        signal = sr_perp * sr_par
        signal = np.where((g_dir == 0).all(axis=1), 1.0, signal)
        return signal


# --------------------------------------------------------------------------
# NODDI Watson-distribution machinery -- reference synthesis.py:30-91,495-845
# --------------------------------------------------------------------------
def scheme2noddi(scheme: Scheme) -> dict:
    """Derive a NODDI 'protocol' from a scheme (reference synthesis.py:30-91):
    per-shell G/Delta/delta synthesized from b assuming Gmax=40 mT/m."""
    bval = scheme.b.copy()
    protocol = {'pulseseq': 'PGSE'}
    b0_idx = np.nonzero(bval == 0)[0]
    B = np.unique(bval[bval > 0])
    maxB = np.max(B)
    Gmax = 0.04
    tmp = np.power(3 * maxB * 1e6 / (2 * _GAMMA * _GAMMA * Gmax * Gmax), 1.0 / 3.0)
    delta = np.zeros(bval.shape)
    smalldel = np.zeros(bval.shape)
    gradient_strength = np.zeros(bval.shape)
    for b in B:
        sel = bval == b
        delta[sel] = tmp
        smalldel[sel] = tmp
        gradient_strength[sel] = np.sqrt(b / maxB) * Gmax
    grad_dirs = scheme.raw[:, 0:3].copy()
    grad_dirs[b0_idx, :] = [1.0, 0.0, 0.0]
    grad_dirs /= np.linalg.norm(grad_dirs, axis=1, keepdims=True)
    protocol.update(delta=delta, smalldel=smalldel,
                    gradient_strength=gradient_strength, grad_dirs=grad_dirs)
    return protocol


def legendre_gaussian_integral(Lpmp: np.ndarray, n: int = 6) -> np.ndarray:
    """L_i(x) = int_0^1 exp(-x t^2) P_{2i}(t) dt scaled; two-regime evaluation
    (reference synthesis.py:600-656), vectorized with np.where."""
    if n > 6:
        ERROR('The maximum value for n is 6, which corresponds to the 12th order Legendre polynomial')
    x = np.asarray(Lpmp, np.float64)
    exact = x > 0.05
    xs = np.where(exact, x, 1.0)  # safe values for the exact branch

    mn = n + 1
    I = np.zeros(x.shape + (mn,))
    sqrtx = np.sqrt(xs)
    I[..., 0] = np.sqrt(np.pi) * erf(sqrtx) / sqrtx
    dx = 1.0 / xs
    emx = -np.exp(-xs)
    for i in range(1, mn):
        I[..., i] = (emx + (i - 0.5) * I[..., i - 1]) * dx

    L_exact = np.zeros(x.shape + (mn,))
    c = [
        [1.0],
        [-0.5, 1.5],
        [0.375, -3.75, 4.375],
        [-0.3125, 6.5625, -19.6875, 14.4375],
        [0.2734375, -9.84375, 54.140625, -93.84375, 50.2734375],
        [-63. / 256., 3465. / 256., -30030. / 256., 90090. / 256.,
         -109395. / 256., 46189. / 256.],
        [231. / 1024., -18018. / 1024., 225225. / 1024., -1021020. / 1024.,
         2078505. / 1024., -1939938. / 1024., 676039. / 1024.],
    ]
    for i in range(mn):
        L_exact[..., i] = sum(c[i][j] * I[..., j] for j in range(i + 1))

    x2 = x * x
    x3 = x2 * x
    x4 = x3 * x
    x5 = x4 * x
    x6 = x5 * x
    L_approx = np.zeros(x.shape + (mn,))
    L_approx[..., 0] = 2 - 2 * x / 3 + x2 / 5 - x3 / 21 + x4 / 108
    if n >= 1:
        L_approx[..., 1] = -4 * x / 15 + 4 * x2 / 35 - 2 * x3 / 63 + 2 * x4 / 297
    if n >= 2:
        L_approx[..., 2] = 8 * x2 / 315 - 8 * x3 / 693 + 4 * x4 / 1287
    if n >= 3:
        L_approx[..., 3] = -16 * x3 / 9009 + 16 * x4 / 19305
    if n >= 4:
        L_approx[..., 4] = 32 * x4 / 328185
    if n >= 5:
        L_approx[..., 5] = -64 * x5 / 14549535
    if n >= 6:
        L_approx[..., 6] = 128 * x6 / 760543875
    return np.where(exact[..., None], L_exact, L_approx)


def watson_SH_coeff(kappa: float) -> np.ndarray:
    """Even-order SH coefficients (l=0..12) of the Watson distribution with
    concentration kappa; three published regimes (reference synthesis.py:658-759)."""
    if isinstance(kappa, np.ndarray) and kappa.ndim > 0:
        ERROR('"watson_SH_coeff()" not implemented for multiple kappa input yet')
    kappa = float(kappa)
    n = 6
    C = np.zeros(n + 1)
    C[0] = 2 * np.sqrt(np.pi)

    sk = np.sqrt(kappa)
    sk2, sk3 = sk * kappa, sk * kappa * kappa
    sk4, sk5, sk6 = sk3 * kappa, sk3 * kappa * kappa, sk3 * kappa ** 3
    k2, k3, k4, k5, k6 = kappa ** 2, kappa ** 3, kappa ** 4, kappa ** 5, kappa ** 6

    # dawsn(x) = 0.5 sqrt(pi) e^{-x^2} erfi(x): stable form of the
    # reference's erfi/exp combination (synthesis.py:684-687), which
    # overflows for kappa > ~700
    dawsonk = dawsn(sk)
    ek_ierfik = 0.5 * np.sqrt(np.pi) / dawsonk if dawsonk != 0 else np.inf

    if 0.1 < kappa <= 30:
        C[1] = np.sqrt(5) * (3 * sk - (3 + 2 * kappa) * dawsonk) * ek_ierfik / kappa
        C[2] = 0.375 * ((105 + 60 * kappa + 12 * k2) * dawsonk
                        - 105 * sk + 10 * sk2) * ek_ierfik / k2
        C[3] = ((-3465 - 1890 * kappa - 420 * k2 - 40 * k3) * dawsonk
                + 3465 * sk - 420 * sk2 + 84 * sk3) \
            * np.sqrt(13 * np.pi) / 64 / k3 / dawsonk
        C[4] = ((675675 + 360360 * kappa + 83160 * k2 + 10080 * k3 + 560 * k4) * dawsonk
                - 675675 * sk + 90090 * sk2 - 23100 * sk3 + 744 * sk4) \
            * np.sqrt(17) * ek_ierfik / 512 / k4
        C[5] = ((-43648605 - 22972950 * kappa - 5405400 * k2 - 720720 * k3
                 - 55440 * k4 - 2016 * k5) * dawsonk
                + 43648605 * sk - 6126120 * sk2 + 1729728 * sk3
                - 82368 * sk4 + 5104 * sk5) \
            * np.sqrt(21 * np.pi) / 4096 / k5 / dawsonk
        C[6] = ((7027425405 + 3666482820 * kappa + 872972100 * k2
                 + 122522400 * k3 + 10810800 * k4 + 576576 * k5 + 14784 * k6) * dawsonk
                - 7027425405 * sk + 1018467450 * sk2 - 302630328 * sk3
                + 17153136 * sk4 - 1553552 * sk5 + 25376 * sk6) \
            * 5 * ek_ierfik / 16384 / k6

    if kappa > 30:
        # very-large-kappa log-polynomial fit (synthesis.py:728-740)
        lnkd = np.log(kappa) - np.log(30)
        p = np.array([lnkd ** i for i in range(7)])
        C[1] = p @ [7.52308, 0.411538, -0.214588, 0.0784091, -0.023981, 0.00731537, -0.0026467]
        C[2] = p @ [8.93718, 1.62147, -0.733421, 0.191568, -0.0202906, -0.00779095, 0.00574847]
        C[3] = p @ [8.87905, 3.35689, -1.15935, 0.0673053, 0.121857, -0.066642, 0.0180215]
        C[4] = p @ [7.84352, 5.03178, -1.0193, -0.426362, 0.328816, -0.0688176, -0.0229398]
        C[5] = p @ [6.30113, 6.09914, -0.16088, -1.05578, 0.338069, 0.0937157, -0.106935]
        C[6] = p @ [4.65678, 6.30069, 1.13754, -1.38393, -0.0134758, 0.331686, -0.105954]

    if kappa <= 0.1:
        # small-kappa series (synthesis.py:742-758)
        C[1] = (4 / 3 * kappa + 8 / 63 * k2) * np.sqrt(np.pi / 5)
        C[2] = (8 / 21 * k2 + 32 / 693 * k3) * (np.sqrt(np.pi) * 0.2)
        C[3] = (16 / 693 * k3 + 32 / 10395 * k4) * np.sqrt(np.pi / 13)
        C[4] = (32 / 19305 * k4) * np.sqrt(np.pi / 17)
        C[5] = 64 * np.sqrt(np.pi / 21) * k5 / 692835
        C[6] = 128 * np.sqrt(np.pi) * k6 / 152108775
    return C


def _zonal_sh_at(cos_theta: np.ndarray, n: int = 6) -> np.ndarray:
    """sqrt((4i+1)/(4 pi)) P_{2i}(cos theta) for i=0..n, vectorized
    (the shMatrix of reference synthesis.py:550-561)."""
    ct = np.clip(np.asarray(cos_theta, np.float64), -1.0, 1.0)
    P = _assoc_legendre_all(2 * n, ct)
    cols = [np.sqrt((i + 1 - 0.75) / np.pi) * P[2 * i, 0] for i in range(n + 1)]
    return np.stack(cols, axis=-1)


class NODDIIntraCellular:
    """Watson-dispersed sticks (reference synthesis.py:495-759)."""

    def __init__(self, scheme: Scheme):
        self.scheme = scheme
        self.protocol_hr = scheme2noddi(scheme)

    def get_signal(self, diff_par, kappa):
        d = diff_par * 1e-6
        p = self.protocol_hr
        G, delta, smalldel = p['gradient_strength'], p['delta'], p['smalldel']
        grad_dirs = p['grad_dirs']
        fibredir = np.array([0.0, 0.0, 1.0])

        modQ = _GAMMA * smalldel * G
        LePar = -modQ * modQ * (delta - smalldel / 3.0) * d  # synthesis.py:571-590
        LePerp = np.zeros_like(G)                            # R=0, synthesis.py:592-598
        ePerp = np.exp(LePerp)

        lgi = legendre_gaussian_integral(LePerp - LePar, 6)
        coeff = watson_SH_coeff(kappa)

        cosTheta = grad_dirs @ fibredir
        sh = _zonal_sh_at(cosTheta, 6)

        E = np.sum(lgi * coeff[None, :] * sh, axis=1)
        # SH truncation can produce nonpositive values; clamp like the
        # reference (synthesis.py:564-567)
        pos_min = np.min(E[E > 0]) if (E > 0).any() else 1.0
        E = np.where(E <= 0, pos_min * 0.1, E)
        return 0.5 * E * ePerp


class NODDIExtraCellular:
    """Watson-hindered tensor (reference synthesis.py:761-826)."""

    def __init__(self, scheme: Scheme):
        self.scheme = scheme
        self.protocol_hr = scheme2noddi(scheme)

    def get_signal(self, diff_par, kappa, vol_ic):
        dPar = diff_par * 1e-6
        dPerp = dPar * (1 - vol_ic)
        p = self.protocol_hr
        G, delta, smalldel = p['gradient_strength'], p['delta'], p['smalldel']
        grad_dirs = p['grad_dirs']
        fibredir = np.array([0.0, 0.0, 1.0])

        dw_par, dw_perp = self._watson_hindered_diffusion_coeff(dPar, dPerp, kappa)

        modQ = _GAMMA * smalldel * G
        bval = (delta - smalldel / 3.0) * modQ * modQ
        cosTheta = grad_dirs @ fibredir
        cos2 = cosTheta * cosTheta
        return np.exp(-bval * ((dw_par - dw_perp) * cos2 + dw_perp))

    @staticmethod
    def _watson_hindered_diffusion_coeff(dPar, dPerp, kappa):
        """Orientation-averaged tensor of a Watson-dispersed zeppelin
        (reference synthesis.py:791-806)."""
        dParMdPerp = dPar - dPerp
        if kappa < 1e-5:
            dParP2dPerp = dPar + 2 * dPerp
            k2 = kappa * kappa
            dw0 = dParP2dPerp / 3.0 + 4.0 * dParMdPerp * kappa / 45.0 \
                + 8.0 * dParMdPerp * k2 / 945.0
            dw1 = dParP2dPerp / 3.0 - 2.0 * dParMdPerp * kappa / 45.0 \
                - 4.0 * dParMdPerp * k2 / 945.0
        else:
            sk = np.sqrt(kappa)
            dawsonf = dawsn(sk)  # stable: = 0.5 e^{-k} sqrt(pi) erfi(sk)
            factor = sk / dawsonf
            dw0 = (-dParMdPerp + 2.0 * dPerp * kappa + dParMdPerp * factor) / (2.0 * kappa)
            dw1 = (dParMdPerp + 2.0 * (dPar + dPerp) * kappa - dParMdPerp * factor) / (4.0 * kappa)
        return dw0, dw1


class NODDIIsotropic:
    """Isotropic GPD compartment (reference synthesis.py:828-845)."""

    def __init__(self, scheme: Scheme):
        self.scheme = scheme
        self.protocol_hr = scheme2noddi(scheme)

    def get_signal(self, diff_iso):
        d = diff_iso * 1e-6
        p = self.protocol_hr
        modQ = _GAMMA * p['smalldel'] * p['gradient_strength']
        difftime = p['delta'] - p['smalldel'] / 3.0
        return np.exp(-difftime * modQ * modQ * d)
