"""amico_tpu_torch — the AMICO-style microstructure fit on PyTorch and CUDA.

The port of :mod:`amico_tpu` (JAX) to one NVIDIA Hopper card.  It imports
``torch`` and never ``jax``, and nothing of ``amico_tpu``: its host layers
(NIfTI and scheme I/O, LUT, synthesis, native preprocessing, logging) are
its own copies of the JAX package's jax-free modules.  Public API, as the
JAX package's: ``Evaluation``, ``setup``, ``set_verbose``/``get_verbose``,
``AmicoError``, ``Scheme``, ``fsl2scheme``, ``sandi2scheme``, and the
submodules ``core``, ``models``, ``util``, ``scheme``, ``synthesis``,
``lut``, ``preproc``, ``sweep`` and ``cli`` as attributes.  The command
line is ``python -m amico_tpu_torch`` (``cli.py``).
"""
from .io.scheme import Scheme, fsl2scheme, sandi2scheme
from .utils.logging import AmicoError, get_verbose, set_verbose

__version__ = '0.1.0'

__all__ = ['Evaluation', 'setup', 'set_verbose', 'get_verbose', 'AmicoError',
           'Scheme', 'fsl2scheme', 'sandi2scheme', 'core', 'models',
           '__version__']


def __getattr__(name):
    # lazy: `import amico_tpu_torch` does not import torch
    import importlib
    if name in ('Evaluation', 'setup', 'core'):
        core = importlib.import_module('.core', __name__)
        return core if name == 'core' else getattr(core, name)
    if name in ('models', 'util', 'scheme', 'synthesis', 'lut', 'testing',
                'pipeline', 'device', 'ops', 'preproc', 'sweep', 'cli'):
        return importlib.import_module(f'.{name}', __name__)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
