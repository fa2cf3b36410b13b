"""Copy of ``amico_tpu/synthesis/__init__.py`` for the port, which imports nothing of
``amico_tpu``."""
from .compartments import (
    GAMMA,
    Astrosticks,
    Ball,
    BaseTensor,
    CylinderGPD,
    NODDIExtraCellular,
    NODDIIntraCellular,
    NODDIIsotropic,
    SphereGPD,
    Stick,
    Tensor,
    Zeppelin,
    legendre_gaussian_integral,
    scheme2noddi,
    watson_SH_coeff,
)

__all__ = [
    'GAMMA', 'Astrosticks', 'Ball', 'BaseTensor', 'CylinderGPD',
    'NODDIExtraCellular', 'NODDIIntraCellular', 'NODDIIsotropic',
    'SphereGPD', 'Stick', 'Tensor', 'Zeppelin',
    'legendre_gaussian_integral', 'scheme2noddi', 'watson_SH_coeff',
]
