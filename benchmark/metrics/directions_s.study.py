"""Seconds of the DTI direction fit a subject, from the facade's
``directions_s`` timer: the traced window's total over the subjects
written."""


def read(run):
    fits = run.in_window('fit')
    return sum(f['facade']['directions_s'] for f in fits) / run.count \
        if fits and run.count else None
