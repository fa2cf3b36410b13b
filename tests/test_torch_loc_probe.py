"""T1, the build-cache probe's kernel (amico_tpu_torch.ops.loc_probe), and the
port's probe tool (amico_tpu_torch.tools.loc_experiment), on the CPU.

T1's twin is held to the JAX tool's Pallas kernel (``tools/
loc_experiment.py``, ``build_kernel()``) bit for bit: the test runs that
kernel in interpret mode, as the JAX package's own tests run Pallas on the
CPU, by wrapping ``pallas_call`` for the duration of the test.  The tool's
two call sites, and a second working directory, give one build key; no
nvcc is needed to compute it."""
import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from amico_tpu_torch.ops import cuda_build
from amico_tpu_torch.ops.loc_probe import loc_probe, loc_probe_torch
from amico_tpu_torch.tools import loc_experiment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


@pytest.fixture
def jax_build_kernel(monkeypatch):
    """The JAX tool's ``build_kernel``, with Pallas in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        'jax_loc_experiment', os.path.join(REPO, 'tools', 'loc_experiment.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    real = pl.pallas_call
    monkeypatch.setattr(pl, 'pallas_call',
                        lambda *a, **kw: real(*a, interpret=True, **kw))
    return mod.build_kernel


def probe_inputs():
    rng = np.random.RandomState(0)
    big = np.full((8, 128), 3.0e38, np.float32)
    big[::2] *= -1
    return {'ones': np.ones((8, 128), np.float32),
            'randn': rng.randn(8, 128).astype(np.float32),
            'wide-range': (rng.randn(8, 128)
                           * 10.0 ** rng.randint(-30, 30, (8, 128))
                           ).astype(np.float32),
            'overflow': big}


@pytest.mark.parametrize('name', list(probe_inputs()))
def test_twin_matches_jax_kernel_bit_for_bit(jax_build_kernel, name):
    x = probe_inputs()[name]
    ref = np.asarray(jax_build_kernel()(jnp.asarray(x)))
    got = loc_probe_torch(torch.from_numpy(x)).numpy()
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_wrapper_takes_the_twin_on_cpu():
    x = torch.from_numpy(probe_inputs()['randn'])
    before = loc_probe.launches
    assert torch.equal(loc_probe(x), loc_probe_torch(x))
    assert torch.equal(loc_probe(x[:3, 5:]), x[:3, 5:] * 2 + 1)
    assert loc_probe.launches == before                 # no kernel ran


def test_wrapper_raises_off_cpu_and_cuda():
    with pytest.raises(ValueError, match='device'):
        loc_probe(torch.ones(4, device='meta'))


def test_call_sites_share_the_build_key():
    """site_one and site_two compute the same key and run T1 (its twin on
    the CPU); the key is the hash directory of the library path."""
    x = torch.from_numpy(probe_inputs()['randn'])
    f = loc_experiment.build_kernel()
    assert f is loc_probe
    h1, o1 = loc_experiment.site_one(f, x)
    h2, o2 = loc_experiment.site_two(f, x)
    assert h1 == h2 == os.path.basename(
        os.path.dirname(cuda_build.library_path()))
    assert len(h1) == 16
    assert torch.equal(o1, o2) and torch.equal(o1, loc_probe_torch(x))
    row = {'desc': 'in-process', 'site1': h1, 'site2': h2,
           'stable': h1 == h2, 'note': ''}
    assert loc_experiment.line(row).endswith(f'site1={h1} site2={h2} STABLE')


def test_build_key_ignores_cwd_and_follows_the_sources(tmp_path, monkeypatch):
    """The key is the same from another working directory, and changes
    when a source changes (a copy of csrc/ with T1 edited)."""
    key = loc_experiment.cache_key()
    monkeypatch.chdir(tmp_path)
    assert loc_experiment.cache_key() == key
    csrc = tmp_path / 'csrc'
    shutil.copytree(cuda_build.CSRC, csrc)
    assert {p.name for p in csrc.iterdir()} >= {'loc_probe.cu', 'runtime.cu'}
    monkeypatch.setattr(cuda_build, 'CSRC', str(csrc))
    assert loc_experiment.cache_key() == key
    with open(csrc / 'loc_probe.cu', 'a') as f:
        f.write('\n// edited\n')
    assert loc_experiment.cache_key() != key


def test_probe_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    with pytest.raises(SystemExit, match='CUDA'):
        loc_experiment.main()
