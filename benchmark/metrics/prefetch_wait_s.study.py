"""Seconds a subject written waits for its input (the sweep's wait on the
load prefetched while the previous subject fitted, or the load itself
where none was), from the program's ``prefetch_wait`` spans
(``amico_tpu_torch.trace``) that started in the traced window.  None when
the program logs no such span or its log dropped spans of the window."""


def read(run):
    try:
        from amico_tpu_torch import trace
    except ImportError:                     # a program without spans
        return None
    lo, hi = run.window
    spans = trace.spans(lo, hi, 'prefetch_wait')
    if not spans or not run.count or trace.dropped(lo):
        return None
    return sum(s['t1'] - s['t0'] for s in spans) / run.count
