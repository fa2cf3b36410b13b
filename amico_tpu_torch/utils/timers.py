"""Copy of ``amico_tpu/utils/timers.py`` for the port, which imports nothing of
``amico_tpu``, without its ``jax.profiler`` branch.

Stage timing.

The reference records coarse wall-clock stage timings into its CONFIG dict
(reference amico/core.py:127,195,374-377,449-468).  We keep the same
stage-timing dict.  The original's ``jax.profiler`` trace annotation
(``profile=True``) is not ported: it raises until the port's profiler hook
lands (ROADMAP queue 1 item 15).
"""
from __future__ import annotations

import contextlib
import time


class StageTimers:
    """Accumulates named wall-clock stage durations (seconds)."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, profile: bool = False):
        if profile:
            raise NotImplementedError(
                'profiled stages are not ported to amico_tpu_torch (ROADMAP '
                'queue 1 item 15: a torch.profiler hook)')
        t0 = time.time()
        yield
        self.times[name] = self.times.get(name, 0.0) + (time.time() - t0)

    def get(self, name: str) -> float | None:
        return self.times.get(name)
