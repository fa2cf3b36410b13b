"""The port's CylinderZeppelinBall (ACTIVEAX) through its facade against the
benchmark's plain reference (``benchmark/reference/czb.py``: NumPy and
SciPy in float64, exact Lawson-Hanson solves), on a small protocol of the
benchmark configuration's shape (``activeax_cdmd``): 4 b0 and 16 timed
shells of 6 directions, 8 at Delta 19 ms and 8 at Delta 49 ms, delta 8 ms,
b from 50 to 17,800 s/mm^2.  All 26 atoms (21 cylinders, 4 zeppelins, a
ball); 512 seeded voxels (a sparse mixture of the reference's own atoms at
one of 4 LUT directions, S0 1000, Rician noise at b0 SNR 25); lambda2 2, 4
and 8; both routes of the CPU: ``'auto'`` (the stagewise solver) and
``'pallas'`` (K2's twin).  Also the reference's cylinder against its
closed forms.  No JAX."""
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'benchmark')
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from reference import czb, dictionary, pipeline  # noqa: E402

torch.set_num_threads(2)

GAMMA = dictionary.GAMMA
SHELLS = [(b, 0.019) for b in (50, 350, 800, 1500, 2400, 3450, 4750, 6000)] \
    + [(b, 0.049) for b in (200, 950, 2300, 4250, 6750, 9850, 13500, 17800)]
SMALL_DELTA, TE = 0.008, 0.077
PARAMS = {'d_par': 1.7e-3,
          'Rs': (np.concatenate(([0.01], np.linspace(0.5, 8.0, 20)))
                 * 1e-6).tolist(),
          'd_perps': [1.19e-3, 0.85e-3, 0.51e-3, 0.17e-3], 'd_isos': [3e-3]}
CONFIG = {'name': 'czb_small', 'reference': 'czb', 'model_params': PARAMS,
          'lut': {'ndirs': 500, 'lmax': 12}}
DIM = (8, 8, 8)
LAMBDA2S = (2.0, 4.0, 8.0)
# Bounds on the median and the 90th percentile over the voxels of each
# voxel's largest map error (the a map's, in um, throughout), at twice
# the largest reading of either route.  On these voxels the exact solve of
# the port's own float32 dictionary and normalised signal reads a median
# of 2.0e-7 / 1.7e-7 / 1.2e-7 at lambda2 2 / 4 / 8; the port, whose Gram
# and A'y are summed in float64 and whose solve runs in float32, reads
# medians 7.7e-6 / 4.7e-6 / 2.8e-6 ('auto') and 8.1e-6 / 4.3e-6 / 2.9e-6
# ('pallas'), 90th percentiles 1.9e-5 / 1.2e-5 / 6.9e-6: the float32
# solve at a condition number of A'A + lambda2 I that falls as lambda2
# grows.  With both sums in float32 it read medians 2.0e-5 / 1.3e-5 /
# 7.5e-6, above each bound.
BOUNDS = {2.0: (1.6e-5, 4e-5), 4.0: (1e-5, 2.5e-5), 8.0: (6e-6, 1.4e-5)}


def hemisphere(n, turn):
    i = np.arange(n) + 0.5
    z = i / n
    phi = 2 * np.pi * i / ((1 + 5 ** 0.5) / 2) + turn
    r = np.sqrt(1 - z * z)
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], 1)


def scheme_table():
    """(nS, 7) STEJSKALTANNER rows: x, y, z, G, Delta, delta, TE; the b0s
    take the first shell's timing."""
    rows = [[0, 0, 0, 0, SHELLS[0][1], SMALL_DELTA, TE]] * 4
    for k, (b, Delta) in enumerate(SHELLS):
        G = np.sqrt(b * 1e6 / (GAMMA ** 2 * SMALL_DELTA ** 2
                               * (Delta - SMALL_DELTA / 3)))
        rows += [[*g, G, Delta, SMALL_DELTA, TE]
                 for g in hemisphere(6, 0.7 * k)]
    return np.array(rows, np.float64)


@pytest.fixture(scope='module')
def subject(tmp_path_factory):
    """The written subject, the reference's dictionary on its protocol and
    the voxels' raw signals in the facade's (C) voxel order."""
    from amico_tpu_torch.io.scheme import Scheme
    d = tmp_path_factory.mktemp('czb_ref')
    os.environ['AMICO_TPU_HOME'] = str(d / 'home')
    table = scheme_table()
    scheme = Scheme(table)
    bvals, bvecs = scheme.b, table[:, :3]
    D = dictionary.build(CONFIG, bvals, bvecs, table[:, 3:])
    rng = np.random.default_rng(17)
    n = int(np.prod(DIM))
    na = D['aniso'].shape[2] + D['iso'].shape[1]
    W = rng.random((n, na)) * (rng.random((n, na)) < 0.3)
    W[np.arange(n), rng.integers(na, size=n)] += 0.5
    W /= W.sum(1, keepdims=True)
    dirs = rng.choice(500, 4, replace=False)[rng.integers(4, size=n)]
    y = np.einsum('vsa,va->vs', D['aniso'][dirs], W[:, :-1]) \
        + W[:, -1:] * D['iso'][:, 0]
    sigma = 1.0 / 25.0
    raw = 1000.0 * np.hypot(y + sigma * rng.standard_normal(y.shape),
                            sigma * rng.standard_normal(y.shape))
    study = d / 'study' / 'subj'
    study.mkdir(parents=True)
    from amico_tpu_torch.io import nifti
    nifti.save(nifti.Nifti1Image(raw.reshape(DIM + (-1,)).astype(np.float32),
                                 np.diag([2.0, 2.0, 2.0, 1.0])),
               str(study / 'DWI.nii'))
    np.savetxt(study / 'DWI.scheme', table, fmt='%.17g',
               header='VERSION: STEJSKALTANNER', comments='')
    # the reference reads the written float32 signal, as the facade does
    return (str(d / 'study'), D, raw.astype(np.float32).astype(np.float64),
            bvals, bvecs)


@pytest.fixture(scope='module')
def reference_maps(subject):
    _, D, raw, bvals, bvecs = subject
    return {lam2: pipeline.solve_voxels(
        CONFIG, D, raw, bvals, bvecs, np.tile([0.0, lam2], (len(raw), 1)),
        False)['maps'] for lam2 in LAMBDA2S}


@pytest.fixture(scope='module')
def evaluation(subject):
    from amico_tpu_torch.core import Evaluation
    study = subject[0]
    ev = Evaluation(study, 'subj', device='cpu')
    ev.load_data('DWI.nii', 'DWI.scheme')
    assert ev.scheme.version == 1 and len(ev.scheme.shells) == 16
    ev.set_model('CylinderZeppelinBall')
    ev.model.set(**PARAMS)
    ev.generate_kernels(ndirs=500, lmax=12)
    ev.load_kernels()
    return ev


@pytest.mark.parametrize('backend', ['auto', 'pallas'])
@pytest.mark.parametrize('lam2', LAMBDA2S)
def test_port_meets_the_reference(evaluation, reference_maps, backend, lam2):
    ev = evaluation
    ev.set_solver(lambda1=0.0, lambda2=lam2, backend=backend)
    ev.fit()
    got = ev.RESULTS['MAPs'].reshape(-1, 3)     # C order: the voxels' own
    err = np.abs(got - reference_maps[lam2]).max(1)
    median, p90 = BOUNDS[lam2]
    assert np.median(err) < median, np.median(err)
    assert np.percentile(err, 90) < p90, np.percentile(err, 90)
    assert np.isfinite(got).all() and (got[:, 0] >= 0).all() \
        and (got[:, 0] <= 1).all()


def test_reference_cylinder_closed_forms():
    """A vanishing radius leaves the stick (nothing attenuates across it);
    b = 0 leaves every atom at 1; across a cylinder the attenuation grows
    with the radius, the gradient and the diffusion time."""
    G = np.array([0.0, 0.1, 0.29])
    perp = czb.cylinder_perp(G, 0.049, 0.008, 1.7e-3, 1e-10)
    assert np.all(perp >= 0) and perp.max() < 1e-12
    assert czb.cylinder_perp(G, 0.049, 0.008, 1.7e-3, 4e-6)[0] == 0.0
    radii = [czb.cylinder_perp(0.29, 0.049, 0.008, 1.7e-3, R)
             for R in (1e-6, 2e-6, 4e-6)]
    assert radii[0] < radii[1] < radii[2]
    assert czb.cylinder_perp(0.1, 0.019, 0.008, 1.7e-3, 4e-6) \
        < czb.cylinder_perp(0.1, 0.049, 0.008, 1.7e-3, 4e-6)
    grad = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.6, 0.0, 0.8]])
    shells = [{'b': 0.0, 'G': 0.0, 'Delta': 0.019, 'delta': 0.008,
               'TE': TE},
              {'b': (GAMMA * 0.15 * 0.008) ** 2 * (0.049 - 0.008 / 3) * 1e-6,
               'G': 0.15, 'Delta': 0.049, 'delta': 0.008, 'TE': TE}]
    params = dict(PARAMS, Rs=[1e-12, 4e-6])
    aniso, iso, _ = czb.atoms(params, shells, grad)
    assert np.all(aniso[:, :3] == 1) and np.all(iso[:, :3] == 1)
    stick = np.exp(-shells[1]['b'] * 1.7e-3 * grad[:, 2] ** 2)
    np.testing.assert_allclose(aniso[0, 3:], stick, rtol=1e-12)
    # along the axis a cylinder is the stick, whatever its radius
    assert aniso[1, 3] == pytest.approx(stick[0], rel=1e-12)
    assert aniso[1, 4] < stick[1] and aniso[1, 5] < stick[2]
