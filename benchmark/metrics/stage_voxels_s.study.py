"""Seconds of the facade's staging a subject (masked gather and upload),
from its ``stage_voxels_s`` timer: the traced window's total over the
subjects written."""


def read(run):
    fits = run.in_window('fit')
    return sum(f['facade']['stage_voxels_s'] for f in fits) / run.count \
        if fits and run.count else None
