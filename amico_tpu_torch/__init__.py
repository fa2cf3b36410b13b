"""amico_tpu_torch — the AMICO-style microstructure fit on PyTorch and CUDA.

The port of :mod:`amico_tpu` (JAX) to one NVIDIA Hopper card.  It imports
``torch`` and never ``jax``; its host layers (NIfTI and scheme I/O, LUT,
synthesis, native preprocessing, logging) are the jax-free modules of
``amico_tpu``.  Public API: ``Evaluation``, ``setup``, ``set_verbose``,
``AmicoError``, ``Scheme`` and ``fsl2scheme``.
"""
from amico_tpu.io.scheme import Scheme, fsl2scheme
from amico_tpu.utils.logging import AmicoError, set_verbose

__version__ = '0.1.0'

__all__ = ['Evaluation', 'setup', 'set_verbose', 'AmicoError', 'Scheme',
           'fsl2scheme', '__version__']


def __getattr__(name):
    # lazy: `import amico_tpu_torch` does not import torch
    import importlib
    if name in ('Evaluation', 'setup', 'core'):
        core = importlib.import_module('.core', __name__)
        return core if name == 'core' else getattr(core, name)
    if name in ('models', 'testing', 'pipeline', 'device', 'ops'):
        return importlib.import_module(f'.{name}', __name__)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
