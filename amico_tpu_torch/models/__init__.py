"""Model zoo of the port.  NODDI is ported; the other five models of the
JAX package are ROADMAP queue 1 and raise when asked for."""
from .base import BaseModel
from .noddi import NODDI

__all__ = ['BaseModel', 'NODDI']

_NOT_PORTED = {
    'FreeWater': 'FreeWater with K2',
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
