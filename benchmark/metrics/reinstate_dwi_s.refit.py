"""Seconds a fit spends reinstating the corrected DWI (the host's
``reinstate_corrected_dwi`` and the 4D scatter of its volume, a part of
``scatter_s.refit``), from the program's ``reinstate_dwi`` spans
(``amico_tpu_torch.trace``) that started in the traced window, over the
fits.  None when the program logs no such span or its log dropped spans of
the window."""


def read(run):
    try:
        from amico_tpu_torch import trace
    except ImportError:                     # a program without spans
        return None
    lo, hi = run.window
    spans = trace.spans(lo, hi, 'reinstate_dwi')
    if not spans or not run.count or trace.dropped(lo):
        return None
    return sum(s['t1'] - s['t0'] for s in spans) / run.count
