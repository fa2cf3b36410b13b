"""Device selection for the port: the ``device`` config key.

``'cuda'`` (the default) needs a card and raises :class:`AmicoError`
without one: the port never carries on on the CPU when it was asked for the
GPU.  ``'cpu'`` runs every kernel's plain PyTorch version (the tests).
"""
from __future__ import annotations

import torch

from amico_tpu.utils.logging import AmicoError

DEFAULT_DEVICE = 'cuda'


def resolve_device(name=None) -> torch.device:
    """Validate a ``device`` config value and return the torch device.

    Also fixes the float32 matmul rules: ``allow_tf32 = False`` keeps every
    float32 product (the Grams, ``A'y``, the DTI fit) in full float32, the
    arithmetic the JAX package's 'highest' precision computes.  TF32 would
    keep about three decimal digits, which the cond ~1e8 NODDI Grams do not
    survive."""
    dev = torch.device(DEFAULT_DEVICE if name is None else name)
    if dev.type not in ('cuda', 'cpu'):
        raise AmicoError(f'device must be "cuda" or "cpu", got "{name}"')
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise AmicoError('device "cuda" was requested but no CUDA card is '
                             'available; set_config("device", "cpu") runs '
                             'the plain PyTorch path')
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise AmicoError(f'device "{name}" does not exist; '
                             f'{torch.cuda.device_count()} card(s) visible')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
