"""Seconds of ``Evaluation.load_data`` a subject (NIfTI read and the
native preprocess, on the sweep's prefetch thread), from the benchmark's
span around it: the traced window's total over the subjects written."""


def read(run):
    spans = run.in_window('load_data')
    return sum(s['t1'] - s['t0'] for s in spans) / run.count \
        if spans and run.count else None
