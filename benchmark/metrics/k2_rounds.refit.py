"""K2's ``converge`` continuation rounds a tile: the rounds each tile of
the tile QP ran past its schedule (counted on the card, ``k2.rounds``),
over the tiles solved (``k2.tiles``), summed over the program's ``fit``
spans (``amico_tpu_torch.trace``) that started in the traced window.
None when the program counts no K2 tile or its log dropped spans of the
window."""


def read(run):
    try:
        from amico_tpu_torch import trace
    except ImportError:                     # a program without counters
        return None
    lo, hi = run.window
    fits = trace.spans(lo, hi, 'fit')
    tiles = sum(f['counts'].get('k2.tiles', 0) for f in fits)
    if not tiles or trace.dropped(lo):
        return None
    return sum(f['counts'].get('k2.rounds', 0) for f in fits) / tiles
