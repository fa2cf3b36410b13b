"""The device timeline of a traced window, from ``torch.profiler``.

The window runs under a profiler of host and device activity and inside a
``portbench.window`` range; its Chrome trace is read back and reduced to:
the union of device activity (kernels, copies, sets) within the window,
the device time of the kernels launched inside the program's ``fit``
ranges (its model fit; copies excluded), the kernels that took most time,
and the longest idle stretches, each named by the innermost host range
open at its middle (the benchmark's ``portbench.*`` spans and the
program's own ranges).
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict

from . import arith

WINDOW = 'portbench.window'
_DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


@contextlib.contextmanager
def profiled(enabled: bool):
    """Profile the body (host and device) when ``enabled`` and a card is
    there; yields a holder whose ``summary`` is set after the body.  Off a
    card nothing is traced, so no device metric is read from a CPU run."""
    import torch
    holder = type('Traced', (), {'summary': None})()
    if not (enabled and torch.cuda.is_available()):
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        with record_function(WINDOW):
            yield holder
    fd, path = tempfile.mkstemp(suffix='.json', prefix='portbench_trace_')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    finally:
        os.remove(path)
    holder.summary = summarize(events)


def summarize(events: list[dict]) -> dict:
    """The reduction of a Chrome trace's events (times in seconds)."""
    dev, ranges, launches = [], [], {}
    for e in events:
        if e.get('ph') != 'X':
            continue
        cat = e.get('cat', '')
        ts, dur = float(e['ts']) * 1e-6, float(e.get('dur', 0)) * 1e-6
        if cat in _DEVICE_CATS:
            dev.append((ts, ts + dur, cat, e.get('name', ''),
                        (e.get('args') or {}).get('correlation')))
        elif cat == 'user_annotation':
            ranges.append((ts, ts + dur, e.get('name', '')))
        elif cat == 'cuda_runtime':
            corr = (e.get('args') or {}).get('correlation')
            if corr is not None:
                launches[corr] = ts
    win = [r for r in ranges if r[2] == WINDOW]
    if not win:
        return {}
    lo, hi = win[0][0], win[0][1]
    busy_iv = [(s, e) for s, e, *_ in dev]
    busy_s = arith.busy(busy_iv, lo, hi)

    fits = sorted((s, e) for s, e, n in ranges if n == 'fit')
    starts = [s for s, _ in fits]

    def in_fit(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= fits[i][1]

    fit_kernel_s = 0.0
    by_name = defaultdict(float)
    for s, e, cat, name, corr in dev:
        if e < lo or s > hi:
            continue
        by_name[name] += e - s
        if cat == 'kernel' and corr in launches and in_fit(launches[corr]):
            fit_kernel_s += e - s
    named = [r for r in ranges if r[2] != WINDOW]

    def label(t):
        inner = [r for r in named if r[0] <= t <= r[1]]
        return min(inner, key=lambda r: r[1] - r[0])[2] if inner else 'window'

    idle = sorted(arith.gaps(busy_iv, lo, hi), key=lambda g: g[0] - g[1])
    return {
        'window_s': hi - lo, 'busy_s': busy_s, 'fit_kernel_s': fit_kernel_s,
        'device_ops': sorted(([n, v] for n, v in by_name.items()),
                             key=lambda x: -x[1])[:10],
        'idle_gaps': [[label(0.5 * (s + e)), e - s] for s, e in idle[:10]],
    }
