"""The comparison that decides ``correct``.

A sample of the masked voxels, drawn from the seed, is fitted again by the
plain reference (``reference/``) from the raw signal the benchmark made;
the program's answers for those voxels (the maps, and the corrected DWI
where the traffic asks for it) are held against the reference's.  Each
number compared has its limit in the configuration's ``check.limits``, set
from the readings in PERF.md.  A missing or non-finite answer counts as an
infinite error.
"""
from __future__ import annotations

import numpy as np


def sample(n_voxels: int, k: int, seed: int) -> np.ndarray:
    """``k`` distinct voxel indices of ``n_voxels``, drawn from ``seed``."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), 0x5EED])
    return np.sort(rng.choice(n_voxels, size=min(k, n_voxels),
                              replace=False))


def median_error(a: np.ndarray, b: np.ndarray) -> float:
    """The median over voxels (rows) of each voxel's largest absolute
    error: a fault that spoils some of a voxel's answers spoils the voxel,
    so faults on a sizeable share of the voxels move the median."""
    e = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    e[~np.isfinite(e)] = np.inf
    return float(np.median(e.max(1)))


def compare(config: dict, prog: dict, ref: dict) -> dict:
    """{number: (value, limit)}: ``map_median``, the median over the
    checked voxels of the largest absolute error of a voxel's maps, and
    with a corrected DWI ``dwi_median``, that of its samples in units of
    the voxel's mean b0."""
    limits = config['check']['limits']
    out = {'map_median': (median_error(prog['maps'], ref['maps']),
                          limits.get('map_median'))}
    if ref.get('dwi') is not None:
        dwi = np.asarray(prog['dwi'], np.float64) / ref['b0'][:, None]
        out['dwi_median'] = (median_error(dwi, ref['dwi']),
                             limits.get('dwi_median'))
    return out


def verdict(numbers: dict) -> bool:
    """True when every number is within its limit (a number without a limit
    fails: it has not been set)."""
    return all(lim is not None and np.isfinite(v) and v <= lim
               for v, lim in numbers.values())
