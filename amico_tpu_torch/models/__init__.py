"""Model zoo of the port.  NODDI and FreeWater are ported; the other four
models of the JAX package are ROADMAP queue 1 and raise when asked for."""
from .base import BaseModel
from .free_water import FreeWater
from .noddi import NODDI

__all__ = ['BaseModel', 'FreeWater', 'NODDI']

_NOT_PORTED = {
    'CylinderZeppelinBall': 'CylinderZeppelinBall',
    'SANDI': 'SANDI',
    'StickZeppelinBall': 'StickZeppelinBall and VolumeFractions',
    'VolumeFractions': 'StickZeppelinBall and VolumeFractions',
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f'model "{name}" is not yet ported to amico_tpu_torch '
            f'(ROADMAP queue 1: {_NOT_PORTED[name]})')
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
