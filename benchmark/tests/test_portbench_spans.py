"""The per-layer metrics that read the program's own spans and counters
(``amico_tpu_torch.trace``): each reads the spans logged in the run's
window, over the run's fits or subjects, and reads nothing from an empty
log or from a window whose spans the log's bound dropped."""
import time

import pytest

from portbench import registry
from portbench.cells import Run

from amico_tpu_torch import trace

NAMES = ('load_kernels_s.study', 'prefetch_wait_s.study',
         'reinstate_dwi_s.refit', 'k2_rounds.refit')


@pytest.fixture(autouse=True)
def fresh_log():
    trace.clear()
    trace.enable()
    yield
    trace.disable()
    trace.clear()


def hold(name, seconds, **counts):
    """A span ``name`` of at least ``seconds``, counting ``counts``."""
    with trace.span(name) as sp:
        for k, v in counts.items():
            trace.count(k, v)
        t = time.perf_counter() + seconds
        while time.perf_counter() < t:
            pass
    return sp.elapsed


def window(run, body):
    t0 = time.perf_counter()
    body()
    run.window = (t0, time.perf_counter())


def test_study_spans_over_subjects_written():
    run = Run('study')
    hold('load_kernels', 0.002)                 # before the window
    out = {}

    def body():
        with trace.span('subject'):
            out['w0'] = hold('prefetch_wait', 0.004)
            out['lk'] = hold('load_kernels', 0.003)
        with trace.span('subject'):
            out['w1'] = hold('prefetch_wait', 0.001)
    window(run, body)
    run.count = 2
    read = {n: registry.metric_reader(n) for n in NAMES}
    assert read['load_kernels_s.study'](run) == pytest.approx(out['lk'] / 2)
    assert read['prefetch_wait_s.study'](run) == pytest.approx(
        (out['w0'] + out['w1']) / 2)
    assert read['reinstate_dwi_s.refit'](run) is None
    assert read['k2_rounds.refit'](run) is None


def test_refit_spans_and_counters_over_fits():
    run = Run('refit')
    out = []

    def body():
        for rounds in (3, 9):
            with trace.span('fit'):
                with trace.span('scatter'):
                    out.append(hold('reinstate_dwi', 0.002))
                trace.count('k2.rounds', rounds)
                trace.count('k2.tiles', 4)
    window(run, body)
    run.count = 2
    read = {n: registry.metric_reader(n) for n in NAMES}
    assert read['reinstate_dwi_s.refit'](run) == pytest.approx(sum(out) / 2)
    assert read['k2_rounds.refit'](run) == pytest.approx(12 / 8)
    assert read['load_kernels_s.study'](run) is None


@pytest.mark.parametrize('name', NAMES)
def test_nothing_read_from_an_empty_log(name):
    run = Run('refit')
    window(run, lambda: None)
    run.count = 3
    assert registry.metric_reader(name)(run) is None


@pytest.mark.parametrize('name', NAMES)
def test_nothing_read_after_an_overflow(name):
    """A window whose spans the bound dropped reads nothing, though the
    log still holds some of its spans."""
    trace.clear(bound=2)
    run = Run('refit')

    def body():
        for _ in range(4):
            with trace.span('fit'):
                trace.count('k2.rounds', 1)
                trace.count('k2.tiles', 1)
                hold('reinstate_dwi', 0.0)
                hold('load_kernels', 0.0)
                hold('prefetch_wait', 0.0)
    window(run, body)
    run.count = 4
    assert trace.dropped(run.window[0]) > 0 and trace.spans(*run.window)
    assert registry.metric_reader(name)(run) is None
