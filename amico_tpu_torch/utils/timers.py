"""Copy of ``amico_tpu/utils/timers.py`` for the port, which imports nothing of
``amico_tpu``; its one difference is the profiler: ``profile=True`` wraps
the stage in ``torch.profiler.record_function`` where the original uses
``jax.profiler.TraceAnnotation``.

Stage timing.

The reference records coarse wall-clock stage timings into its CONFIG dict
(reference amico/core.py:127,195,374-377,449-468).  We keep the same
stage-timing dict and add a ``torch.profiler`` range when enabled, which a
running profiler (the facade's ``profile_dir``) records under the stage's
name.
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
        ctx = contextlib.nullcontext()
        if profile:
            import torch.profiler
            ctx = torch.profiler.record_function(name)
        t0 = time.time()
        with ctx:
            yield
        self.times[name] = self.times.get(name, 0.0) + (time.time() - t0)

    def get(self, name: str) -> float | None:
        return self.times.get(name)
