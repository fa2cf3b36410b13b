"""ActiveAx on the MGH CDMD protocol (``configs/activeax_cdmd.json``,
``reference/czb.py``) and its cell ``czb.refit``: found by name, its
least work, its 850-sample STEJSKALTANNER scheme as the program reads it
back, small passes on the CPU that are correct and that a fault or the
control makes not correct, and ``k2_support.refit``, which reads the
program's K2 support counters and nothing where there are none."""
import time

import numpy as np
import pytest
import torch

from conftest import small_bench
from portbench import cells, judge, main, registry, synth, work
from portbench.cells import Run
from reference import dictionary

from amico_tpu_torch import trace

CELL = 'czb.refit'
SEED = 2 ** 31 + 71


def test_configuration_and_cell_are_found():
    bench = registry.benchmark()
    w = registry.cell(bench, CELL)
    assert (w['config'], w['traffic'], w['chips']) == ('activeax_cdmd',
                                                       'refit', 1)
    entry = [c for c in bench['configs'] if c['name'] == 'activeax_cdmd']
    assert entry and entry[0]['reduced'] == ['protocol.matrix']
    c = registry.config('activeax_cdmd')
    assert (c['model'], c['reference']) == ('CylinderZeppelinBall', 'czb')
    assert c['maps'] == ['v', 'a', 'd'] and c['reduced'] == entry[0]['reduced']
    assert len(c['model_params']['Rs']) == 21
    assert int(synth.mask(c).sum()) == 186872
    names = [m['name'] for m in registry.metrics_of(bench, CELL, True)]
    assert 'k2_support.refit' in names and 'k2_rounds.refit' in names
    assert 'solve_roofline_pct.refit' in names


def test_least_work():
    """One stage of 26 atoms on 850 samples: 2 (850 x 26 + 26^2) = 45,552
    operations a voxel; a fit reads the signal and writes three maps a
    voxel, and reads the dictionary at 500 directions."""
    c = registry.config('activeax_cdmd')
    s = work.shapes(c)
    assert (s['nS'], s['n_dwi'], s['n_aniso'], s['n_iso']) == (850, 800, 25,
                                                               1)
    flops, nbytes = work.least_work(c, n_voxels=1, n_fits=1,
                                    corrected_dwi=False)
    assert flops == 45552
    flops, nbytes = work.least_work(c, n_voxels=186872, n_fits=3,
                                    corrected_dwi=False)
    assert flops == 3 * 186872 * 45552
    assert nbytes == 3 * 4 * (186872 * (850 + 3) + 500 * 850 * 26)


def test_scheme_read_back_by_the_program(tmp_path):
    """16 shells keyed by b and timing (b = 2300 at 49 ms and 2400 at
    19 ms are two shells), 50 b0 at the first shell's timing."""
    from amico_tpu_torch.io.scheme import Scheme
    c = registry.config('activeax_cdmd')
    c['protocol']['matrix'] = [4, 4, 2]
    c['mask']['semi_axes'] = [2.0, 2.0, 1.0]
    b, g, P = synth.protocol(c)
    assert b.size == 850 and P.shape == (850, 4)
    cells.write_subject(str(tmp_path), c, torch.zeros((850, 2, 4, 4)), b, g,
                        synth.mask(c), P)
    with open(tmp_path / 'DWI.scheme') as f:
        assert f.readline().strip() == 'VERSION: STEJSKALTANNER'
    s = Scheme(str(tmp_path / 'DWI.scheme'))
    assert (s.version, s.b0_count, s.dwi_count) == (1, 50, 800)
    assert np.allclose(s.b, b, rtol=1e-12, atol=0)
    assert np.all(P[b == 0, 1] == 0.019)
    want = [(float(sh[0]), sh[1], sh[2]['Delta'])
            for sh in c['protocol']['shells']]
    got = [(sh['b'], sh['idx'].size, sh['Delta']) for sh in s.shells]
    assert len(got) == 16
    for (bw, nw, Dw), (bg, ng, Dg) in zip(want, got):
        assert bg == pytest.approx(bw, rel=1e-12) and (ng, Dg) == (nw, Dw)
    for (rec, rows), sh in zip(dictionary.shells(b, P), s.shells):
        assert np.array_equal(rows, sh['idx'])
        assert (rec['G'], rec['Delta'], rec['delta'], rec['TE']) == (
            sh['G'], sh['Delta'], sh['delta'], sh['TE'])


@pytest.fixture(scope='module')
def tiny_czb(tmp_path_factory):
    """(BENCHMARK.json, folder) of the small benchmark (12x12x8, 256
    voxels checked), with the program's tables under the module's
    temporary directory."""
    import os
    import tempfile
    d = tmp_path_factory.mktemp('czb_bench')
    mp = pytest.MonkeyPatch()
    mp.setenv('AMICO_TPU_HOME', str(d / 'amico_home'))
    mp.setenv('TMPDIR', str(d / 'tmp'))
    os.makedirs(d / 'tmp')
    mp.setattr(tempfile, 'tempdir', None)
    yield small_bench(str(d / 'bench')), str(d / 'bench')
    mp.undo()


def _run(tiny, seed=SEED):
    bench, d = tiny
    # a window long enough that each lambda of the grid is answered: on
    # the CPU the stagewise solver takes ~4 s a fit of this subject, and
    # twice that on a loaded machine
    r = main.run(bench, CELL, seed, 25.0, False, 'cpu', d)
    assert r['attempted'] >= 3
    return r


def test_cpu_pass_is_correct(tiny_czb):
    r = _run(tiny_czb)
    assert r['correct'], r['compared']
    assert {'setup_s', 'refit_voxels_per_s', 'refit_p90_s'} <= set(
        r['metrics'])


@pytest.mark.parametrize('how', ['half', 'altered'])
def test_broken_outputs_are_not_correct(tiny_czb, monkeypatch, how):
    from amico_tpu_torch.models.base import BaseModel
    orig = BaseModel._run_tiled_fit

    def broken(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        for k, v in out.items():
            v = np.array(v)
            if how == 'half':
                v[: v.shape[0] // 2] = 0.0
            else:
                v += 0.05
            out[k] = v
        return out
    monkeypatch.setattr(BaseModel, '_run_tiled_fit', broken)
    r = _run(tiny_czb, SEED + 1)
    assert not r['correct'], r['compared']


def test_control_fails(tmp_path):
    d = str(tmp_path / 'bench')
    small_bench(d)
    cell = cells.Cell(registry.config('activeax_cdmd_tiny', d),
                      registry.traffic('refit', d), SEED + 2, 'cpu',
                      str(tmp_path / 'work'))
    cell.inputs(write=False)
    numbers = cell.check('tf32')
    assert not judge.verdict(numbers), numbers


@pytest.fixture
def fresh_log():
    trace.clear()
    trace.enable()
    yield
    trace.disable()
    trace.clear()


def _window(run, body):
    t0 = time.perf_counter()
    body()
    run.window = (t0, time.perf_counter())


def test_k2_support_reads_the_counters(fresh_log):
    run = Run('refit')

    def body():
        for support, voxels in ((250, 10), (96, 4)):
            with trace.span('fit'):
                trace.count('k2.tiles', 2)
                trace.count('k2.rounds', 1)
                trace.count('k2.support', support)
                trace.count('k2.voxels', voxels)
    _window(run, body)
    run.count = 2
    assert registry.metric_reader('k2_support.refit')(run) == \
        pytest.approx(346 / 14)


def test_k2_support_reads_nothing_without_its_counters(fresh_log):
    """A fit with K2 tiles but no support counters (a program before
    them), a fit without K2, an empty window and a window whose spans
    were dropped read nothing."""
    read = registry.metric_reader('k2_support.refit')
    run = Run('refit')

    def k2_without_support():
        with trace.span('fit'):
            trace.count('k2.tiles', 3)
            trace.count('k2.rounds', 2)
    _window(run, k2_without_support)
    run.count = 1
    assert read(run) is None
    assert registry.metric_reader('k2_rounds.refit')(run) == \
        pytest.approx(2 / 3)

    def no_k2():
        with trace.span('fit'):
            pass
    _window(run, no_k2)
    assert read(run) is None
    _window(run, lambda: None)
    assert read(run) is None
    trace.clear(bound=2)

    def overflow():
        for _ in range(4):
            with trace.span('fit'):
                trace.count('k2.support', 25)
                trace.count('k2.voxels', 1)
    _window(run, overflow)
    assert trace.spans(*run.window, 'fit') and read(run) is None


def test_k2_support_counted_by_the_program(fresh_log):
    """The port's ``solve_tiles`` counts, while traced, the atoms with
    x > 0 of the valid voxels and those voxels, and untraced returns the
    same x."""
    from amico_tpu_torch.models._fitops import solve_tiles
    gen = torch.Generator().manual_seed(3)
    A = torch.rand((2, 40, 6), generator=gen)
    G = A.transpose(1, 2) @ A
    b = torch.rand((2, 5, 6), generator=gen) @ G
    valid = torch.ones((2, 5), dtype=torch.bool)
    valid[1, 3:] = False
    kw = dict(solver_kw={'fista_iters': 0, 'refine_rounds': 12,
                         'cg_iters': 12, 'converge': True})
    with trace.span('fit') as sp:
        x = solve_tiles(G, b, None, 0.0, 1e-3, valid=valid, **kw)
    assert sp.counts['k2.voxels'] == 8
    assert sp.counts['k2.support'] == int(((x > 0) & valid[..., None]).sum())
    assert sp.counts['k2.tiles'] == 2
    trace.disable()
    with trace.span('fit') as sp:
        x_off = solve_tiles(G, b, None, 0.0, 1e-3, valid=valid, **kw)
    assert sp.counts == {} and torch.equal(x, x_off)
