"""Copy of ``amico_tpu/scheme.py`` for the port, which imports nothing of
``amico_tpu``: the reference's ``amico.scheme`` module."""
from .io.scheme import GAMMA, Scheme

__all__ = ['GAMMA', 'Scheme']
