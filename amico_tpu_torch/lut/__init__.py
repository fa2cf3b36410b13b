"""Copy of ``amico_tpu/lut/__init__.py`` for the port, which imports nothing of
``amico_tpu``."""
from . import refdata
from .rotation import (
    N_HIGHRES_DIRS,
    aux_structures_generate,
    aux_structures_resample,
    create_high_resolution_scheme,
    dir_to_lut_idx,
    highres_grad,
    is_valid,
    load_directions,
    load_precomputed_hash_table,
    load_precomputed_rotation_matrices,
    precompute_rotation_matrices,
    resample_kernel,
    rotate_kernel,
    valid_dirs,
)

__all__ = [
    'refdata',
    'N_HIGHRES_DIRS', 'aux_structures_generate', 'aux_structures_resample',
    'create_high_resolution_scheme', 'dir_to_lut_idx',
    'highres_grad', 'is_valid', 'load_directions',
    'load_precomputed_hash_table', 'load_precomputed_rotation_matrices',
    'precompute_rotation_matrices', 'resample_kernel', 'rotate_kernel',
    'valid_dirs',
]
