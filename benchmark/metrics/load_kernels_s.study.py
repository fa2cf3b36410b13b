"""Seconds of the LUT resample a subject written (``Evaluation.load_kernels``:
the resample's auxiliary structures, the hash table and the model's
resample; a sweep pays one), from the program's ``load_kernels`` spans
(``amico_tpu_torch.trace``) that started in the traced window.  None when
the program logs no such span or its log dropped spans of the window."""


def read(run):
    try:
        from amico_tpu_torch import trace
    except ImportError:                     # a program without spans
        return None
    lo, hi = run.window
    spans = trace.spans(lo, hi, 'load_kernels')
    if not spans or not run.count or trace.dropped(lo):
        return None
    return sum(s['t1'] - s['t0'] for s in spans) / run.count
