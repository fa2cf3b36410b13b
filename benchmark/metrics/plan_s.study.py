"""Seconds of the tile driver's set-up a subject (LUT quantization, tile
plan, staged inputs), from its ``setup_s`` timer: the traced window's total
over the subjects written."""


def read(run):
    fits = run.in_window('fit')
    return sum(f['engine']['setup_s'] for f in fits) / run.count \
        if fits and run.count else None
