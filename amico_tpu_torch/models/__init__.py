"""Model zoo of the port: the JAX package's six models."""
from .base import BaseModel
from .cylinder_zeppelin_ball import CylinderZeppelinBall
from .free_water import FreeWater
from .noddi import NODDI
from .sandi import SANDI
from .stick_zeppelin_ball import StickZeppelinBall
from .volume_fractions import VolumeFractions

__all__ = ['BaseModel', 'CylinderZeppelinBall', 'FreeWater', 'NODDI',
           'SANDI', 'StickZeppelinBall', 'VolumeFractions']
