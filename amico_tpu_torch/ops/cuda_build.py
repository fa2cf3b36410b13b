"""Build the port's CUDA sources into one shared library and load it.

``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
-fPIC -c`` compiles each ``amico_tpu_torch/csrc/*.cu`` (plain C entry
points, no PyTorch headers: seconds each), one nvcc per source, all
started together; ``nvcc -shared`` then links them into
``build/amico_tpu_torch/<hash>/libamico_tpu_torch.so`` beside the package.
The hash covers the sources' and headers' bytes and the flags, so an
unchanged checkout reuses its build and any edit builds anew.  The build
runs at first use; the library is loaded with ctypes, once per process.
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


def build(verbose: bool = False) -> str:
    """Compile the sources unless this hash is already built; return the
    library's path.  Raises with nvcc's output when a step fails."""
    global last_build_seconds
    out = library_path()
    if os.path.isfile(out):
        return out
    work = f'{out}.{os.getpid()}.d'
    os.makedirs(work, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    jobs = []
    for src in _sources():
        obj = os.path.join(work, os.path.basename(src) + '.o')
        cmd = [nvcc] + NVCC_FLAGS + (['-Xptxas', '-v'] if verbose else []) \
            + ['-c', src, '-o', obj]
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
    tmp = os.path.join(work, LIB_NAME)
    cmd = [nvcc, '-shared', '-o', tmp] + [obj for _, obj, _ in jobs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}): '
                           f'{" ".join(cmd)}\n{proc.stderr}{proc.stdout}')
    if verbose:
        print(''.join(logs), flush=True)
    os.replace(tmp, out)        # atomic: a concurrent loader never sees half
    shutil.rmtree(work, ignore_errors=True)
    last_build_seconds = time.time() - t0
    return out


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(build(verbose))
        return _lib
