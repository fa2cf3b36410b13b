"""Is the port's kernel build cache call-site-stable?

Counterpart of ``tools/loc_experiment.py``, which asks whether JAX's
persistent compile-cache key of a tiny Pallas kernel stays the same when
the kernel is lowered from two call sites.  The port builds its CUDA
kernels with nvcc into ``build/amico_tpu_torch/<key>/`` (``ops/
cuda_build.py``), keyed by a hash of the sources, headers and flags.  This
probe computes that key and launches the same tiny kernel (T1,
``csrc/loc_probe.cu``: ``x * 2 + 1``) from two call sites, then from a
second process started in another working directory, and reports whether
the key drifts and whether that process reused the build.  T1's output is
held to its twin bit for bit.  Needs a CUDA card::

    python -m amico_tpu_torch.tools.loc_experiment
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_kernel():
    """T1: the function that launches ``csrc/loc_probe.cu`` (its twin for a
    CPU tensor)."""
    from ..ops.loc_probe import loc_probe
    return loc_probe


def cache_key() -> str:
    """The build key: the hash directory of the library that the current
    sources build into."""
    from ..ops import cuda_build
    return os.path.basename(os.path.dirname(cuda_build.library_path()))


# two call sites on different lines
def site_one(f, x):
    return cache_key(), f(x)


def padding_to_move_line_numbers():
    pass


def site_two(f, x):
    return cache_key(), f(x)


_CHILD = (
    'import json, torch\n'
    'from amico_tpu_torch.ops import cuda_build\n'
    'from amico_tpu_torch.ops.loc_probe import loc_probe_torch\n'
    'from amico_tpu_torch.tools import loc_experiment as le\n'
    'x = torch.randn(8, 128, device="cuda")\n'
    'key, o = le.site_one(le.build_kernel(), x)\n'
    'print(json.dumps({"key": key, "build_s": cuda_build.last_build_seconds,'
    ' "bit_equal": bool(torch.equal(o, loc_probe_torch(x)))}))\n')


def other_process() -> dict:
    """Run site one in a fresh process whose working directory is a new
    temporary one; returns its key, its build time (None when it reused
    the build) and whether its T1 output equalled the twin's."""
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [_REPO] + [p for p in env.get('PYTHONPATH', '').split(os.pathsep)
                   if p])
    with tempfile.TemporaryDirectory() as cwd:
        proc = subprocess.run([sys.executable, '-c', _CHILD], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f'the second process failed:\n{proc.stderr}')
    return json.loads(proc.stdout.strip().splitlines()[-1])


def probe() -> list[dict]:
    """The candidates, in the order they ran: {'desc', 'site1', 'site2',
    'stable', 'note'}.  Raises when T1's output is not its twin's bit for
    bit, or without a CUDA card."""
    from ..ops.loc_probe import loc_probe_torch
    if not torch.cuda.is_available():
        raise SystemExit('loc_experiment needs a CUDA card '
                         '(torch.cuda.is_available() is false)')
    x = torch.from_numpy(
        np.random.RandomState(0).randn(8, 128).astype(np.float32)).cuda()
    f = build_kernel()
    h1, o1 = site_one(f, x)
    h2, o2 = site_two(f, x)
    twin = loc_probe_torch(x)
    torch.cuda.synchronize()
    if not (torch.equal(o1, twin) and torch.equal(o2, twin)):
        raise SystemExit('T1 differs from its twin')
    child = other_process()
    if not child['bit_equal']:
        raise SystemExit('T1 differs from its twin in the second process')
    reuse = 'build reused' if child['build_s'] is None \
        else f'built anew in {child["build_s"]:.2f} s'
    return [{'desc': 'in-process', 'site1': h1, 'site2': h2,
             'stable': h1 == h2, 'note': ''},
            {'desc': 'other process, other cwd', 'site1': h1,
             'site2': child['key'], 'stable': h1 == child['key'],
             'reused': child['build_s'] is None, 'note': f' ({reuse})'}]


def line(row: dict) -> str:
    """One candidate's line, as the JAX tool prints it."""
    return (f'{row["desc"]:28s} site1={row["site1"]} site2={row["site2"]} '
            f'{"STABLE" if row["stable"] else "drifts"}{row["note"]}')


def main() -> int:
    for row in probe():
        print(line(row), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
