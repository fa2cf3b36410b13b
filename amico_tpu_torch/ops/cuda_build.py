"""Build the port's CUDA sources into one shared library and load it.

``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
-fPIC -c`` compiles each ``amico_tpu_torch/csrc/*.cu`` (plain C entry
points, no PyTorch headers: seconds each), one nvcc per source, all
started together; ``nvcc -shared`` then links them into
``build/amico_tpu_torch/<hash>/libamico_tpu_torch.so`` beside the package.
The hash covers the sources' and headers' bytes and the flags, so an
unchanged checkout reuses its build and any edit builds anew.  The build
runs at first use; the library is loaded with ctypes, once per process.

:class:`Launcher` is the one launch path of the kernels' wrappers: it binds
a C entry point and its ``argtypes`` once per process and, per launch,
takes the current stream's raw handle and enters a device guard only when
the tensors' card is not the current one (each piece timed on the H100 in
PERF.md).
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, 'csrc')
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), 'build',
                          'amico_tpu_torch')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC']
LIB_NAME = 'libamico_tpu_torch.so'

_lock = threading.Lock()
_lib = None
last_build_seconds = None   # wall time of this process's build; None if reused


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC, '*.cu')))
    if not srcs:
        raise RuntimeError(f'no CUDA sources under {CSRC}')
    return srcs


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, 'bin', 'nvcc')] if CUDA_HOME else []
    cand.append(shutil.which('nvcc') or '')
    for path in cand:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                       'toolkit (set CUDA_HOME or put nvcc on PATH)')


def library_path() -> str:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in _sources() + sorted(glob.glob(os.path.join(CSRC, '*.cuh'))):
        h.update(os.path.basename(path).encode())
        with open(path, 'rb') as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], LIB_NAME)


def compile_library(sources: list[str], out: str, flags: list[str]) -> str:
    """Compile ``sources`` with nvcc and ``flags`` (one process per source,
    all started together), link them into the shared library ``out`` and
    return nvcc's output.  Raises with that output when a step fails."""
    work = f'{out}.{os.getpid()}.d'
    os.makedirs(work, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in sources:
        obj = os.path.join(work, os.path.basename(src) + '.o')
        cmd = [nvcc] + flags + ['-c', src, '-o', obj]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = []
    for cmd, _, proc in jobs:
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed ({proc.returncode}): '
                               f'{" ".join(cmd)}\n{text}')
        logs.append(text)
    tmp = os.path.join(work, os.path.basename(out))
    cmd = [nvcc, '-shared', '-o', tmp] + [obj for _, obj, _ in jobs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}): '
                           f'{" ".join(cmd)}\n{proc.stderr}{proc.stdout}')
    os.replace(tmp, out)        # atomic: a concurrent loader never sees half
    shutil.rmtree(work, ignore_errors=True)
    return ''.join(logs)


def build(verbose: bool = False) -> str:
    """Compile the sources unless this hash is already built; return the
    library's path.  Raises with nvcc's output when a step fails."""
    global last_build_seconds
    out = library_path()
    if os.path.isfile(out):
        return out
    t0 = time.time()
    log = compile_library(_sources(), out, NVCC_FLAGS
                          + (['-Xptxas', '-v'] if verbose else []))
    if verbose:
        print(log, flush=True)
    last_build_seconds = time.time() - t0
    return out


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(build(verbose))
        return _lib


_bound = {}


def entry(name: str, argtypes: list, restype=ctypes.c_int):
    """The library's C function ``name``, its ``argtypes`` and ``restype``
    set once per process."""
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(load_library(), name)
        fn.argtypes, fn.restype = argtypes, restype
        _bound[name] = fn
    return fn


def error_string(err: int) -> str:
    return entry('cuda_error_string', [ctypes.c_int],
                 ctypes.c_char_p)(err).decode()


def _raw_stream(index: int) -> int:
    import torch
    get = getattr(torch._C, '_cuda_getCurrentRawStream', None)
    if get is not None:
        return get(index)
    return torch.cuda.current_stream(index).cuda_stream


class Launcher:
    """A kernel's C launch function: ``name(*args, stream)`` returning a
    ``cudaError_t``.  ``argtypes`` are those of ``args``; the stream is
    appended."""

    def __init__(self, name: str, argtypes: list):
        self.name = name
        self.argtypes = list(argtypes) + [ctypes.c_void_p]

    def __call__(self, device, *args) -> None:
        """Launch on the current stream of ``device`` (a CUDA
        ``torch.device`` with its index); raises ``RuntimeError`` when the
        C side refuses the launch."""
        import torch
        fn = entry(self.name, self.argtypes)
        index = device.index
        if index == torch.cuda.current_device():
            err = fn(*args, _raw_stream(index))
        else:
            # the C side sets function attributes and launches on the
            # current device, which must be the tensors'
            with torch.cuda.device(index):
                err = fn(*args, _raw_stream(index))
        if err != 0:
            raise RuntimeError(f'kernel launch failed ({self.name}): '
                               f'{error_string(err)}')
