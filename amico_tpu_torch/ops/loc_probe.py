"""T1, the build-cache probe's kernel: ``o = x * 2 + 1`` elementwise.

Counterpart of the Pallas kernel in ``tools/loc_experiment.py``
(``build_kernel().f``).  :func:`loc_probe` launches ``csrc/loc_probe.cu``
for a CUDA tensor and takes the twin :func:`loc_probe_torch` for a CPU
tensor; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import torch


def loc_probe_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of T1, on any device."""
    return x * 2.0 + 1.0


def _library():
    from .cuda_build import load_library
    lib = load_library()
    if lib.loc_probe_launch.argtypes is None:
        lib.loc_probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_longlong, ctypes.c_void_p]
        lib.loc_probe_launch.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


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
        lib = _library()
        with torch.cuda.device(x.device):
            err = lib.loc_probe_launch(
                x.data_ptr(), o.data_ptr(), x.numel(),
                torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError('loc_probe kernel launch failed: '
                               + lib.cuda_error_string(err).decode())
        loc_probe.launches += 1
    return o


loc_probe.launches = 0
