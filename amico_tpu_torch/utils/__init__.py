"""Copy of ``amico_tpu/utils/__init__.py`` for the port, which imports nothing of
``amico_tpu``."""
from .logging import AmicoError, ERROR, LOG, NOTE, PRINT, WARNING, get_verbose, set_verbose
from .progress import ProgressBar
from .timers import StageTimers

__all__ = [
    'AmicoError', 'ERROR', 'LOG', 'NOTE', 'PRINT', 'WARNING',
    'get_verbose', 'set_verbose', 'ProgressBar', 'StageTimers',
]
