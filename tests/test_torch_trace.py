"""The port's spans and counters (amico_tpu_torch.trace) on the CPU: a span
times on perf_counter and nests; tracing off leaves no log entry and no
profiler range; under ``torch.profiler`` a fit's spans are ranges beside
the program's ``fit`` range; the sweep's prefetch thread logs under its
subject's request id; the log's bound counts what it drops; the facade's
and the tile driver's timer dicts and the sweep's seconds come from the
spans; and K2's continuation rounds, counted by the twin, equal
``testing.qp_tail``'s.  The last test needs a CUDA card: the kernel's
per-tile round counts against the twin's, and its maps with the counter on
and off.  The module imports no JAX."""
import os
import threading
import time

import numpy as np
import pytest
import torch

import amico_tpu_torch
from amico_tpu_torch import trace
from amico_tpu_torch.models.base import DEFAULT_AS_SOLVER_KW
from amico_tpu_torch.ops.cuda_qp import nneg_qp_tiles, nneg_qp_tiles_torch
from amico_tpu_torch.sweep import SubjectSweep
from amico_tpu_torch.testing import TAIL_EXITS, qp_tail
from test_torch_k2_tail import INEXACT, collinear_problems

torch.set_num_threads(1)

CPU = {'tile_size': 32, 'voxels_per_chunk': 2048, 'device': 'cpu'}
DIM = (8, 8, 4)


@pytest.fixture(autouse=True)
def fresh_log():
    """Each test starts with an empty log and tracing off."""
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


@pytest.fixture(scope='module')
def study(tmp_path_factory):
    """Two 256-voxel FreeWater subjects (``s1``, ``s2``) of a small
    protocol, written as NIfTI."""
    d = tmp_path_factory.mktemp('torch_trace')
    os.environ['AMICO_TPU_HOME'] = str(d / 'home')
    amico_tpu_torch.set_verbose(0)
    from amico_tpu_torch.testing import (demo_freewater, demo_scheme,
                                         freewater_voxels,
                                         write_demo_subject)
    scheme = demo_scheme()
    _, kernels, htable = demo_freewater(scheme, 'Human', str(d / 'k'))
    for i, name in enumerate(('s1', 's2')):
        y = freewater_voxels(int(np.prod(DIM)), kernels, htable, seed=i)[0]
        write_demo_subject(str(d / name), scheme, y, DIM)
    return str(d)


def evaluation(study, subject='s1', **cfg):
    ev = amico_tpu_torch.Evaluation(study, subject, device='cpu')
    for k, v in dict(CPU, **cfg).items():
        ev.set_config(k, v)
    ev.load_data('DWI.nii', 'DWI.scheme')
    ev.set_model('FreeWater')
    ev.generate_kernels(ndirs=500)
    ev.load_kernels()
    return ev


def test_span_times_on_perf_counter_and_nests():
    trace.enable()
    before = time.perf_counter()
    with trace.span('outer', tag=1) as outer:
        with trace.span('inner') as inner:
            time.sleep(0.01)
            trace.count('things', 3)
        with trace.span('inner'):
            trace.count('things', 2)
    after = time.perf_counter()
    assert before <= outer.t0 <= inner.t0 < inner.t1 <= outer.t1 <= after
    assert inner.elapsed >= 0.01
    assert outer.seconds['outer'] == pytest.approx(outer.elapsed)
    assert outer.seconds['inner'] >= inner.elapsed
    assert outer.counts == {'things': 5} and inner.counts == {'things': 3}
    recs = trace.spans(before, after)
    assert [r['name'] for r in recs] == ['inner', 'inner', 'outer']
    out = recs[-1]
    assert out['parent'] is None and out['attrs'] == {'tag': 1}
    assert out['thread'] == threading.current_thread().name
    assert all(r['parent'] == out['id'] and r['req'] == out['req']
               for r in recs[:2])
    assert recs[0]['t0'] == inner.t0 and recs[0]['t1'] == inner.t1
    # a second outermost span is a new request
    with trace.span('again') as again:
        pass
    assert again.req != out['req']
    assert trace.spans(after, None, 'again')[0]['req'] == again.req


def test_tracing_off_logs_nothing_and_opens_no_range():
    assert not trace.on()
    with trace.span('quiet') as sp:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            torch.ones(4).sum()
    with trace.span('quiet_too'):
        torch.ones(4).sum()
    assert sp.elapsed > 0
    assert trace.spans() == []
    assert not any(e.key.startswith('amico.')
                   for e in prof.key_averages())


def test_profiler_turns_tracing_on():
    """``torch.profiler.profile`` sets the flag :func:`trace.profiling`
    reads, in this thread and in others, for as long as it records."""
    seen = {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        seen['main'] = trace.on()
        t = threading.Thread(target=lambda: seen.update(other=trace.on()))
        t.start()
        t.join(10)
    assert not t.is_alive()
    assert seen == {'main': True, 'other': True}
    assert not trace.on()
    trace.enable()
    assert trace.on() and not trace.profiling()


def test_fit_spans_are_profiler_ranges(study):
    ev = evaluation(study)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ev.fit()
    keys = {e.key for e in prof.key_averages()}
    for name in ('fit', 'amico.fit', 'amico.stage_voxels',
                 'amico.directions', 'amico.plan', 'amico.dispatch',
                 'amico.chunk', 'amico.device_wait', 'amico.pull',
                 'amico.scatter', 'amico.scatter_maps'):
        assert name in keys, name
    names = {r['name'] for r in trace.spans()}
    assert {'fit', 'model_fit', 'quantize', 'tile_plan', 'stage_inputs',
            'chunk'} <= names
    assert 'untile' not in names                # gathered: no host untile
    stage = trace.spans(name='stage_voxels')[0]
    assert stage['attrs'] == {'cached': False, 'uploaded': True}


def test_last_fit_timers_come_from_the_spans(study):
    """The facade's and the tile driver's dicts keep their keys, read the
    fit's spans, and equal ``last_fit_timers()``; a re-fit reads its
    caches as hits; ``ev.timers`` holds each stage once."""
    ev = evaluation(study, doSaveCorrectedDWI=True)
    trace.enable()
    ev.fit()
    first = ev.timers.times['fit']
    ev.fit()
    got = ev.last_fit_timers()
    assert got == {'facade': ev._last_fit_facade_timers,
                   'engine': ev.model._last_fit_timers}
    tf, te = got['facade'], got['engine']
    assert set(tf) == {'stage_voxels_s', 'directions_s', 'model_fit_s',
                       'gather_s', 'scatter_s', 'total_s', 'unattributed_s'}
    assert {'setup_s', 'dispatch_s', 'device_s', 'pull_s', 'untile_s',
            'n_chunks', 'streamed', 'staged_shared', 'tile_size',
            'chunk_tiles'} <= set(te)
    fit = trace.spans(name='fit')[-1]
    last = [r for r in trace.spans() if r['req'] == fit['req']]
    dur = {r['name']: r['t1'] - r['t0'] for r in last}
    assert tf['stage_voxels_s'] == dur['stage_voxels']
    assert tf['scatter_s'] == dur['scatter']
    assert tf['model_fit_s'] == dur['model_fit']
    assert tf['total_s'] == dur['fit']
    assert te['setup_s'] == dur['plan']
    assert te['dispatch_s'] == dur['dispatch']
    assert te['device_s'] == dur['device_wait']
    n_tiles = ev.model._plans.value.by_width[32].n_tiles
    assert te['untile_s'] == 0.0 and te['n_chunks'] == -(-n_tiles // 64) > 1
    assert dur['reinstate_dwi'] + dur['scatter_maps'] <= dur['scatter']
    by = {r['name']: r['attrs'] for r in last}
    assert by['stage_voxels']['cached'] and by['directions']['cached']
    assert by['quantize']['cached'] and by['tile_plan']['cached']
    assert by['stage_inputs'] == {'cached': True, 'shared': 1}
    assert [r['attrs']['start'] for r in last if r['name'] == 'chunk'] \
        == list(range(0, n_tiles, 64))
    assert ev.timers.times['fit'] == pytest.approx(first + tf['model_fit_s'])
    assert ev.get_config('fit_time') == tf['model_fit_s']
    # the streamed path untiles on the host, in its own span
    ev.set_config('max_device_bytes', 1)
    ev.fit()
    assert ev.model._last_fit_timers['untile_s'] \
        == trace.spans(name='untile')[-1]['t1'] \
        - trace.spans(name='untile')[-1]['t0']


def test_k2_rounds_counted_in_a_fit(study, monkeypatch):
    """Traced, a FreeWater fit counts K2's tiles and continuation rounds
    (the twin's, on the CPU; under a schedule short enough that tiles
    continue) on its ``fit`` span, as each launch's rounds sum, and the
    tiles whose continuation stalled or was capped, as each launch's exits
    say; the maps are those of an untraced fit."""
    from amico_tpu_torch.models import _fitops, base
    monkeypatch.setattr(base, 'DEFAULT_AS_SOLVER_KW', INEXACT)
    launched = []

    def counted(*a, **kw):
        x = nneg_qp_tiles(*a, **kw)
        if kw.get('tile_rounds') is not None:
            exits = kw['tile_exits']
            launched.append((a[1].shape[0], int(kw['tile_rounds'].sum()),
                             *(int((exits == TAIL_EXITS.index(e)).sum())
                               for e in ('stalled', 'cap'))))
        return x
    monkeypatch.setattr(_fitops, 'nneg_qp_tiles', counted)
    ev = evaluation(study)
    ev.fit()
    maps = ev.RESULTS['MAPs'].copy()
    assert launched == []
    trace.enable()
    ev.fit()
    np.testing.assert_array_equal(ev.RESULTS['MAPs'], maps)
    counts = trace.spans(name='fit')[-1]['counts']
    n_tiles = ev.model._plans.value.by_width[32].n_tiles
    assert len(launched) == ev.model._last_fit_timers['n_chunks']
    assert counts['k2.tiles'] == sum(c[0] for c in launched) == n_tiles
    assert counts['k2.rounds'] == sum(c[1] for c in launched) > 0
    assert counts['k2.stalled'] == sum(c[2] for c in launched)
    assert counts['k2.capped'] == sum(c[3] for c in launched)
    # K2's counts are the model fit's; the scatter's volumes are counted
    # after it, on the host route here
    assert trace.spans(name='model_fit')[-1]['counts'] == {
        k: v for k, v in counts.items() if k.startswith('k2.')}
    assert counts['scatter.host'] == len(ev.RESULTS)


@pytest.mark.parametrize('n,lockstep', [(16, False), (17, True), (32, True),
                                        (33, False)])
def test_k2_lockstep_counted_from_n(n, lockstep):
    """Traced, ``solve_tiles`` counts a launch's tiles as ``k2.lockstep``
    where n sends them down K2's lockstep path (17 <= n <= 32) and 0
    elsewhere, beside ``k2.tiles``: the count is the host's, from n (the
    twin solves here); the solution is an untraced solve's."""
    from amico_tpu_torch.models._fitops import solve_tiles
    from amico_tpu_torch.testing import random_qp_problems
    G, b = (torch.from_numpy(a) for a in random_qp_problems(3, n, M=4,
                                                            seed=n))
    kw = dict(fista_iters=10, refine_rounds=2, cg_iters=4, converge=True)
    x = solve_tiles(G, b, None, 0.0, 1e-3, solver_kw=kw)
    assert trace.spans() == []
    trace.enable()
    with trace.span('fit'):
        x_traced = solve_tiles(G, b, None, 0.0, 1e-3, solver_kw=kw)
    assert torch.equal(x_traced, x)
    counts = trace.spans(name='fit')[-1]['counts']
    assert counts['k2.tiles'] == 3
    assert counts['k2.lockstep'] == (3 if lockstep else 0)


def test_sweep_spans_and_seconds(study, tmp_path):
    """Each fitted subject is a request: its ``subject``, ``prefetch_wait``
    and fit spans, and the prefetched ``load_data`` of the second subject
    on the prefetch thread, share its id; ``seconds`` holds every fitted
    subject's ``subject`` span."""
    trace.enable()
    sw = SubjectSweep(study, ['s1', 's2'], 'FreeWater',
                      config=dict(CPU, OUTPUT_path=str(tmp_path)))
    sw.run(resume=False)
    subj = trace.spans(name='subject')
    assert len(subj) == 2 and set(sw.seconds) == {'s1', 's2'}
    assert [r['t1'] - r['t0'] for r in subj] == [sw.seconds['s1'],
                                                 sw.seconds['s2']]
    loads = trace.spans(name='load_data')
    pre = [r for r in loads if r['thread'].startswith('sweep-prefetch')]
    assert len(pre) == 2 and all(r['parent'] is None for r in pre)
    assert {r['req'] for r in pre} == {r['req'] for r in subj}
    for s in subj:
        names = {r['name'] for r in trace.spans() if r['req'] == s['req']}
        assert {'subject', 'prefetch_wait', 'load_data', 'nifti_read',
                'preprocess', 'fit', 'scatter', 'save_results'} <= names
    # the first subject resamples the LUT, the second reuses it
    lk = trace.spans(name='load_kernels')
    assert len(lk) == 1 and lk[0]['req'] == subj[0]['req']
    assert {r['name'] for r in trace.spans() if r['parent'] == lk[0]['id']} \
        == {'resample_aux', 'hash_table', 'model_resample'}


def test_log_bound_counts_drops():
    trace.clear(bound=4)
    trace.enable()
    t_start = time.perf_counter()
    for i in range(6):
        with trace.span('s', i=i):
            pass
    t_mid = time.perf_counter()
    assert trace.dropped() == 2
    assert [r['attrs']['i'] for r in trace.spans()] == [2, 3, 4, 5]
    # a window from t_start lost spans; one from the oldest kept did not
    assert trace.dropped(t_start) == 2
    assert trace.dropped(trace.spans()[0]['t0']) == 0
    assert trace.dropped(t_mid) == 0
    trace.clear()
    assert trace.dropped() == 0 and trace.spans() == []


def test_spans_from_threads_all_land():
    """Spans closed on many threads at once each land in the log once."""
    import sys
    trace.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(200):
                with trace.span('w', k=k, i=i):
                    trace.count('n', 1)
        ts = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    recs = trace.spans(name='w')
    assert len(recs) == 16 * 200 and trace.dropped() == 0
    assert len({(r['attrs']['k'], r['attrs']['i']) for r in recs}) == 3200
    assert all(r['counts'] == {'n': 1} for r in recs)


@pytest.mark.parametrize('tiles,lam2,kw', [
    (lambda: collinear_problems(8, 11), 1e-3, INEXACT),
    (lambda: collinear_problems(2, 11), 1e-3, DEFAULT_AS_SOLVER_KW),
    (lambda: collinear_problems(2, 11), 1e-3,
     dict(DEFAULT_AS_SOLVER_KW, converge=False)),
], ids=['inexact', 'default', 'no-converge'])
def test_twin_tile_rounds_equal_qp_tail(tiles, lam2, kw):
    """The twin's own counters against qp_tail's reading of its rounds,
    which decides each exit anew from the round's state."""
    G, b = tiles()
    x, tail = qp_tail(G, b, None, 0.0, lam2, **kw)
    rounds, exits = torch.full((2, b.shape[0]), -1, dtype=torch.int32)
    x_c = nneg_qp_tiles(G, b, None, 0.0, lam2, tile_rounds=rounds,
                        tile_exits=exits, **kw)
    assert torch.equal(x_c, x)
    assert rounds.tolist() == tail['rounds'].tolist()
    assert exits.tolist() == tail['exit'].tolist()
    for name in ('tile_rounds', 'tile_exits'):
        with pytest.raises(ValueError, match=name):
            nneg_qp_tiles_torch(G, b, None, 0.0, lam2, **kw,
                                **{name: torch.zeros(b.shape[0])})


@pytest.mark.cuda
def test_kernel_tile_rounds_against_the_twins(monkeypatch):
    """On the card: K2's per-tile continuation rounds and exits against
    qp_tail's (the twin on the same tiles, on the card), and the maps bit
    for bit those of a launch without the counters.  Where a tile's rounds
    are set by the support each round adds, the counts are equal tile by
    tile.  On the churning tiles of test_torch_k2_tail they are not: the
    kernel orders its float reductions unlike the twin, so a tile whose
    working set churns between near-collinear atoms passes its exit test
    in another round (a quarter of the tiles here); there the mean count
    agrees within 5% and each bin of ``tail_histogram`` (rounds and exits)
    within a tenth of the tiles.  Under FreeWater's schedule these tiles
    run with the stall test off on both (cuda_qp.STALL = -inf, which the
    kernel takes at launch), the rule these bounds were set for;
    test_kernel_stalls_churning_tiles_as_the_twin holds them with it on."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (torch.cuda.is_available() is false)')
    from test_torch_k2_tail import dense_solution_problems
    from amico_tpu_torch.ops import cuda_qp
    from amico_tpu_torch.testing import tail_histogram
    G, b, _ = dense_solution_problems(C=8, M=128)
    # (tiles, lam2, schedule, counts equal tile by tile, stall test on)
    cases = [(G, b, 0.0, dict(fista_iters=0, refine_rounds=2, cg_iters=16,
                              converge=True), True, True)]
    cases += [(*collinear_problems(64, 11, seed=s), 1e-3, kw, False, stall)
              for s, kw, stall in ((0, INEXACT, True),
                                   (1, DEFAULT_AS_SOLVER_KW, False))]
    for G, b, lam2, kw, exact, stall in cases:
        G, b = G.cuda(), b.cuda()
        with monkeypatch.context() as mp:
            if not stall:
                mp.setattr(cuda_qp, 'STALL', float('-inf'))
            _, tail = qp_tail(G, b, None, 0.0, lam2, **kw)
            rounds, exits = torch.full((2, b.shape[0]), -1,
                                       dtype=torch.int32, device='cuda')
            x_on = nneg_qp_tiles(G, b, None, 0.0, lam2, tile_rounds=rounds,
                                 tile_exits=exits, **kw)
            x_off = nneg_qp_tiles(G, b, None, 0.0, lam2, **kw)
            torch.cuda.synchronize()
        assert torch.equal(x_on, x_off)
        k = {'rounds': rounds.long().cpu(), 'exit': exits.long().cpu()}
        t = {key: tail[key].cpu() for key in k}
        if exact:
            assert k['rounds'].tolist() == t['rounds'].tolist(), kw
            assert k['exit'].tolist() == t['exit'].tolist(), kw
            continue
        assert bool(((k['rounds'] >= 0) & (k['rounds'] <= tail['cap'])).all())
        assert abs(float(k['rounds'].float().mean())
                   / float(t['rounds'].float().mean()) - 1) < 0.05, (k, t)
        hk = tail_histogram(dict(tail, **k))
        ht = tail_histogram(dict(tail, **t))
        assert all(abs(hk[h][key] - ht[h][key]) <= 0.1 * b.shape[0]
                   for h in ht for key in ht[h]), (hk, ht)


@pytest.mark.cuda
def test_kernel_stalls_churning_tiles_as_the_twin(monkeypatch):
    """On the card, the churning tiles of test_torch_k2_tail under
    FreeWater's schedule (64 tiles, seed 1), where every voxel's working
    set cycles between near-collinear atoms: without the stall test K2
    runs every tile to the cap, 48 rounds; with it K2 and its twin (on the
    card) end every tile by 'stalled' or 'stable' within a quarter of the
    cap.  Which round a tile stalls in is set by float32 rounding (the
    stall test reads an objective to about 2 ulps, and the kernel orders
    its reductions unlike the twin), so the rounds are held by bins: each
    bin of ``tail_histogram`` within a tenth of the tiles.  Each voxel's
    objective (float64, from x) is within 1e-5 relative of the capped
    kernel's and of the twin's: x wanders along the near-collinear pair
    at a cost near float32's resolution, so where it stops moves the
    objective by a few of its ulps (the kernel against its capped self or
    the twin: up to 1.7e-6 on an H100; the twin against its capped self:
    1.2e-7 on the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (torch.cuda.is_available() is false)')
    from test_torch_k2_tail import objective
    from amico_tpu_torch.ops import cuda_qp
    from amico_tpu_torch.testing import tail_histogram
    G, b = (t.cuda() for t in collinear_problems(64, 11, seed=1))
    C, kw, lam2 = G.shape[0], DEFAULT_AS_SOLVER_KW, 1e-3

    def kernel():
        rounds, exits = torch.full((2, C), -1, dtype=torch.int32,
                                   device='cuda')
        x = nneg_qp_tiles(G, b, None, 0.0, lam2, tile_rounds=rounds,
                          tile_exits=exits, **kw)
        return x, {'rounds': rounds.long().cpu(), 'exit': exits.long().cpu()}
    x_k, k = kernel()
    x_t, tail = qp_tail(G, b, None, 0.0, lam2, **kw)
    t = {key: tail[key].cpu() for key in k}
    with monkeypatch.context() as mp:
        mp.setattr(cuda_qp, 'STALL', float('-inf'))
        x_cap, capped = kernel()
    report = (tail_histogram(dict(tail, **k)), tail_histogram(dict(tail, **t)),
              k, t)
    assert capped['rounds'].tolist() == [tail['cap']] * C, capped
    ends = torch.tensor([TAIL_EXITS.index(e) for e in ('stable', 'stalled')])
    for r in (k, t):
        assert bool(torch.isin(r['exit'], ends).all()), report
        assert int(r['rounds'].max()) <= tail['cap'] // 4, report
    hk, ht = report[:2]
    assert all(abs(hk[h][key] - ht[h][key]) <= 0.1 * C
               for h in ht for key in ht[h]), report
    o_k = objective(G, b, lam2, x_k)
    gaps = [float(((o_k - o).abs() / o.abs()).max())
            for o in (objective(G, b, lam2, x_cap),
                      objective(G, b, lam2, x_t))]
    assert max(gaps) < 1e-5, (gaps, report)
