"""``k2_capped.refit``: the tiles of K2 held to the ``converge`` round cap
per 1,000 tiles.  It reads the program's K2 exit counters, and nothing
where there are none or where the log dropped spans; the port's
``solve_tiles`` counts those exits as the tile QP takes them."""
import time

import numpy as np
import pytest
import torch

from portbench import registry
from portbench.cells import Run

from amico_tpu_torch import trace


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


def test_k2_capped_is_declared():
    bench = registry.benchmark()
    m = [m for m in bench['per_layer'] if m['name'] == 'k2_capped.refit']
    assert m and (m[0]['layer'], m[0]['moves']) == ('solve',
                                                   'refit_voxels_per_s')
    for cell in m[0]['workloads']:
        names = [x['name'] for x in registry.metrics_of(bench, cell, True)]
        assert 'k2_capped.refit' in names
def test_k2_capped_reads_the_counters(fresh_log):
    run = Run('refit')

    def body():
        for tiles, capped in ((600, 1), (400, 0)):
            with trace.span('fit'):
                trace.count('k2.tiles', tiles)
                trace.count('k2.rounds', 3)
                trace.count('k2.stalled', 5)
                trace.count('k2.capped', capped)
    _window(run, body)
    run.count = 2
    assert registry.metric_reader('k2_capped.refit')(run) == \
        pytest.approx(1.0)


def test_k2_capped_reads_nothing_without_its_counters(fresh_log):
    """A fit with K2 tiles but no exit counters (a program before them),
    a fit without K2, an empty window and a window whose spans were
    dropped read nothing."""
    read = registry.metric_reader('k2_capped.refit')
    run = Run('refit')

    def k2_without_exits():
        with trace.span('fit'):
            trace.count('k2.tiles', 3)
            trace.count('k2.rounds', 2)
    _window(run, k2_without_exits)
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
                trace.count('k2.tiles', 2)
                trace.count('k2.capped', 1)
    _window(run, overflow)
    assert trace.spans(*run.window, 'fit') and read(run) is None


def test_k2_exits_counted_by_the_program(fresh_log):
    """The port's ``solve_tiles`` counts, while traced, the tiles whose
    continuation stalled and those held to the round cap, as the tile
    QP's exits say, and untraced returns the same x.  The tiles: atoms in
    near-collinear pairs under two CG steps a round, on which one tile
    stalls and five run to the cap."""
    from amico_tpu_torch.models._fitops import solve_tiles
    from amico_tpu_torch.testing import TAIL_EXITS, qp_tail
    rng = np.random.RandomState(0)
    base = np.abs(rng.randn(8, 60, 6))
    A = np.concatenate([base, base[:, :, :5] + 1e-2 * rng.randn(8, 60, 5)],
                       -1)
    y = np.einsum('cmk,cvk->cvm', A, rng.rand(8, 128, 11) ** 3) \
        + 0.01 * rng.randn(8, 128, 60)
    G = torch.from_numpy(np.einsum('cmi,cmj->cij', A, A).astype(np.float32))
    b = torch.from_numpy(np.einsum('cmi,cvm->cvi', A, y).astype(np.float32))
    kw = {'fista_iters': 0, 'refine_rounds': 1, 'cg_iters': 2,
          'converge': 2}
    with trace.span('fit') as sp:
        x = solve_tiles(G, b, None, 0.0, 1e-3, solver_kw=kw)
    x_t, tail = qp_tail(G, b, None, 0.0, 1e-3, **kw)
    assert torch.equal(x, x_t)
    for counter, exit in (('k2.stalled', 'stalled'), ('k2.capped', 'cap')):
        assert sp.counts[counter] == \
            int((tail['exit'] == TAIL_EXITS.index(exit)).sum()) > 0
    assert sp.counts['k2.tiles'] == 8
    trace.disable()
    with trace.span('fit') as sp:
        x_off = solve_tiles(G, b, None, 0.0, 1e-3, solver_kw=kw)
    assert sp.counts == {} and torch.equal(x, x_off)
