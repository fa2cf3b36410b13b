"""Seconds the host waits for the device after a fit's dispatch loop, from
the tile driver's ``device_s`` timer: the traced window's total over the
fits."""


def read(run):
    fits = run.in_window('fit')
    return sum(f['engine']['device_s'] for f in fits) / run.count \
        if fits and run.count else None
