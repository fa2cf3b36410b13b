"""Copy of ``amico_tpu/utils/progress.py`` for the port, which imports nothing of
``amico_tpu``.

Minimal progress reporting.

Replaces the reference's external ``dicelib.ui.ProgressBar`` dependency
(reference amico/core.py:19, models.pyx:11).  The reference also has a
multithread shared-counter variant (models.pyx:28-43); in the TPU build the
fit is a handful of large device dispatches, so progress is reported per
batch instead of per voxel.
"""
from __future__ import annotations

import sys
import time

from .logging import get_verbose


class ProgressBar:
    """Tiny tqdm-like bar gated on verbosity>=3 (matching the reference's
    ``disable=get_verbose()<3`` call sites, e.g. models.pyx:532)."""

    def __init__(self, total: int = 0, disable: bool | None = None, width: int = 40):
        self.total = max(int(total), 0)
        self.n = 0
        self.width = width
        self.disable = (get_verbose() < 3) if disable is None else disable
        self._t0 = time.time()

    def __enter__(self):
        self._draw()
        return self

    def __exit__(self, *exc):
        if not self.disable and self.total > 0:   # nothing was ever drawn
            self._draw()
            sys.stderr.write('\n')
            sys.stderr.flush()
        return False

    def update(self, n: int = 1):
        self.n += n
        self._draw()

    def _draw(self):
        if self.disable or self.total <= 0:
            return
        frac = min(self.n / self.total, 1.0)
        filled = int(frac * self.width)
        bar = '=' * filled + ' ' * (self.width - filled)
        dt = time.time() - self._t0
        sys.stderr.write(f'\r[{bar}] {100 * frac:5.1f}% ({self.n}/{self.total}) {dt:6.1f}s')
        sys.stderr.flush()
