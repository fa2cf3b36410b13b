"""The metric arithmetic and the reduction of a device trace, on fixed
timelines."""
import pytest

from portbench import arith, trace


def test_rate_percentile_spread():
    assert arith.rate(300.0, 10.0, 13.0) == 100.0
    assert arith.percentile(range(11), 90) == pytest.approx(9.0)
    assert arith.percentile([1.0, 2.0], 90) == pytest.approx(1.9)
    # quartiles 1.5 and 3.5 (statistics' exclusive method) of 1..4 over 2.5
    assert arith.spread([1.0, 2.0, 3.0, 4.0]) == pytest.approx(
        (3.75 - 1.25) / 2.5)


def test_union_busy_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (9.0, 12.0)]
    assert arith.union(iv, 0.0, 10.0) == [(0.0, 2.0), (3.0, 4.0),
                                          (9.0, 10.0)]
    assert arith.busy(iv, 0.5, 10.0) == pytest.approx(1.5 + 1.0 + 1.0)
    assert arith.gaps(iv, 0.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    assert arith.busy([], 0.0, 1.0) == 0


def test_summarize_a_trace():
    def x(cat, name, ts, dur, corr=None):
        e = {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}
        if corr is not None:
            e['args'] = {'correlation': corr}
        return e
    events = [
        x('user_annotation', trace.WINDOW, 0, 100),
        x('user_annotation', 'portbench.fit', 10, 60),
        x('user_annotation', 'fit', 20, 30),
        x('cuda_runtime', 'cudaLaunchKernel', 21, 1, 1),
        x('cuda_runtime', 'cudaLaunchKernel', 75, 1, 2),
        x('kernel', 'solve', 22, 20, 1),           # launched in 'fit'
        x('kernel', 'scatter', 76, 4, 2),          # launched outside it
        x('gpu_memcpy', 'Memcpy DtoH', 40, 10),    # overlaps the solve
        x('kernel', 'late', 150, 10),              # after the window
        {'ph': 'i', 'name': 'marker', 'ts': 5},
    ]
    s = trace.summarize(events)
    assert s['window_s'] == pytest.approx(100e-6)
    assert s['busy_s'] == pytest.approx(32e-6)     # 22-50 and 76-80
    assert s['fit_kernel_s'] == pytest.approx(20e-6)
    assert s['device_ops'][0] == ['solve', pytest.approx(20e-6)]
    gaps = dict((round(v * 1e6), k) for k, v in s['idle_gaps'])
    assert gaps == {22: 'portbench.fit', 26: 'portbench.fit', 20: 'window'}
