"""Seconds the tile driver's loop takes to dispatch a fit's chunks, from
its ``dispatch_s`` timer: the traced window's total over the fits."""


def read(run):
    fits = run.in_window('fit')
    return sum(f['engine']['dispatch_s'] for f in fits) / run.count \
        if fits and run.count else None
