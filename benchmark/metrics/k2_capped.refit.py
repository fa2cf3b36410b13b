"""K2's tiles held to the ``converge`` round cap, per 1,000 tiles: the
tiles of the tile QP whose continuation ended at the cap (counted on the
card, ``k2.capped``), over the tiles solved (``k2.tiles``), summed over
the program's ``fit`` spans (``amico_tpu_torch.trace``) that started in
the traced window.  None when the program counts no capped tiles (a
program without the counter) or no K2 tile, or its log dropped spans of
the window."""


def read(run):
    try:
        from amico_tpu_torch import trace
    except ImportError:                     # a program without counters
        return None
    lo, hi = run.window
    fits = trace.spans(lo, hi, 'fit')
    tiles = sum(f['counts'].get('k2.tiles', 0) for f in fits)
    if not tiles or trace.dropped(lo) \
            or not any('k2.capped' in f['counts'] for f in fits):
        return None
    return 1000.0 * sum(f['counts'].get('k2.capped', 0) for f in fits) \
        / tiles
