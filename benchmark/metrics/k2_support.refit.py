"""The tile QP's support, in atoms a voxel: the atoms with x > 0 of each
valid voxel that K2 solved (counted on the card, ``k2.support``), over
those voxels (``k2.voxels``), summed over the program's ``fit`` spans
(``amico_tpu_torch.trace``) that started in the traced window.  None when
the program counts no K2 voxel or its log dropped spans of the window."""


def read(run):
    try:
        from amico_tpu_torch import trace
    except ImportError:                     # a program without counters
        return None
    lo, hi = run.window
    fits = trace.spans(lo, hi, 'fit')
    voxels = sum(f['counts'].get('k2.voxels', 0) for f in fits)
    if not voxels or trace.dropped(lo):
        return None
    return sum(f['counts'].get('k2.support', 0) for f in fits) / voxels
