"""T1, the build-cache probe's kernel: ``o = x * 2 + 1`` elementwise.

Counterpart of the Pallas kernel in ``tools/loc_experiment.py``
(``build_kernel().f``).  :func:`loc_probe` launches ``csrc/loc_probe.cu``
for a CUDA tensor and takes the twin :func:`loc_probe_torch` for a CPU
tensor; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import Launcher


def loc_probe_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of T1, on any device."""
    return x * 2.0 + 1.0


_LAUNCH = Launcher('loc_probe_launch',
                   [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong])


def loc_probe(x: torch.Tensor) -> torch.Tensor:
    """T1: the CUDA kernel for a CUDA tensor, the twin for a CPU tensor.
    The kernel takes a contiguous float32 tensor of any shape.
    ``loc_probe.launches`` counts kernel launches."""
    if x.device.type == 'cpu':
        return loc_probe_torch(x)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    if x.dtype != torch.float32:
        raise TypeError(f'the kernel takes float32, got {x.dtype}')
    if not x.is_contiguous():
        raise ValueError('x must be contiguous')
    o = torch.empty_like(x)
    if x.numel() > 0:
        _LAUNCH(x.device, x.data_ptr(), o.data_ptr(), x.numel())
        loc_probe.launches += 1
    return o


loc_probe.launches = 0
