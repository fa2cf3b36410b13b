"""The least-work count on tiny shapes, worked by hand, and on the
benchmark's configurations as counted before a configuration could state
facade settings."""
import pytest

from portbench import registry, work


def _config(ref, n_maps, **mp):
    return {'reference': ref, 'model_params': mp, 'lut': {'ndirs': 2},
            'maps': ['m'] * n_maps,
            'protocol': {'b0': 1, 'shells': [[1000.0, 2], [2000.0, 1]]}}


def test_noddi_counts_two_stages():
    c = _config('noddi', 3, IC_ODs=[0.1, 0.2], IC_VFs=[0.5])   # 2 + 1 atoms
    flops, nbytes = work.least_work(c, n_voxels=5, n_fits=2,
                                    corrected_dwi=False)
    # stage 1: 2 (nS 4 x 3 atoms + 3^2); stage 2: 2 (3 DWI x 2 + 2^2)
    assert flops == 2 * 5 * (2 * (4 * 3 + 9) + 2 * (3 * 2 + 4))
    # per fit: (signal 4 + 3 maps) a voxel, the dictionary 2 x 4 x 3
    assert nbytes == 2 * 4 * (5 * (4 + 3) + 2 * 4 * 3)


def test_freewater_with_corrected_dwi():
    c = _config('freewater', 2, d_perps=[1e-4, 2e-4], d_isos=[3e-3])
    flops, nbytes = work.least_work(c, 10, 1, corrected_dwi=True)
    assert flops == 10 * 2 * (4 * 3 + 9)
    assert nbytes == 4 * (10 * (4 + 2 + 4) + 2 * 4 * 3)


def test_least_time_names_its_bound():
    t, by = work.least_time(67e12, 1.0)
    assert (t, by) == (pytest.approx(1.0), 'operations')
    t, by = work.least_time(1.0, 3.35e12)
    assert (t, by) == (pytest.approx(1.0), 'bytes')


# (operations, bytes) of 3 fits of 186,872 voxels, without and with the
# corrected DWI
TODAY = {'noddi_ukb': ((80040267552.0, 333536112.0),
                       (80040267552.0, 568994832.0)),
         'freewater_human': ((814014432.0, 131450448.0),
                             (814014432.0, 254785968.0)),
         'activeax_cdmd': ((25537180032.0, 2045421792.0),
                           (25537180032.0, 3951516192.0))}


@pytest.mark.parametrize('name', sorted(TODAY))
@pytest.mark.parametrize('corrected_dwi', [False, True])
def test_the_configurations_count_as_before(name, corrected_dwi):
    c = registry.config(name)
    assert 'evaluation' not in c
    assert work.least_work(c, 186872, 3, corrected_dwi) == \
        TODAY[name][corrected_dwi]
