"""The share of the traced window, in percent, in which no kernel, copy or
set ran on the device (the union of the profiler's device activity)."""


def read(run):
    s = run.summary
    if not s or not s.get('window_s'):
        return None
    return 100.0 * (1.0 - s['busy_s'] / s['window_s'])
