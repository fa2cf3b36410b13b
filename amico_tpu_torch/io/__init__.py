"""Copy of ``amico_tpu/io/__init__.py`` for the port, which imports nothing of
``amico_tpu``."""
from . import nifti
from .scheme import GAMMA, Scheme, fsl2scheme, sandi2scheme

__all__ = ['nifti', 'GAMMA', 'Scheme', 'fsl2scheme', 'sandi2scheme']
