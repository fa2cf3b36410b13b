"""Seconds of the facade's scatter of a fit's results into volumes (with
the corrected DWI's reinstatement where asked), from its ``scatter_s``
timer: the traced window's total over the fits."""


def read(run):
    fits = run.in_window('fit')
    return sum(f['facade']['scatter_s'] for f in fits) / run.count \
        if fits and run.count else None
