"""Shared fixtures of the benchmark's own tests (``python -m pytest
benchmark/tests``): the harness's folder and the checkout on the path,
small copies of the configurations in a temporary benchmark folder, and
the card fixture of the tests marked ``cuda``."""
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [p for p in (BENCH, os.path.dirname(BENCH))
                if p not in sys.path]


# NODDI's atom grid cut to 3 x 3 (``noddi_grid`` keeps it whole)
GRID_CUTS = {'noddi_ukb': {'IC_VFs': [0.2, 0.5, 0.8],
                           'IC_ODs': [0.1, 0.4, 0.8]}}


def small_bench(dst: str, noddi_grid: bool = False) -> dict:
    """A copy of the benchmark folder (metrics, traffic, and every
    configuration of ``configs/`` named ``<name>_tiny``) at a size the CPU
    runs in seconds: a 12x12x8 matrix, 256 voxels checked, two-subject
    sweeps, and NODDI on a 3 x 3 grid unless ``noddi_grid``.  The limits
    are the real ones.  Returns the copy's BENCHMARK.json, whose cells use
    these configurations, with the study cell of ``fixtures/study_cell.json``
    added where BENCHMARK.json lacks it."""
    for d in ('metrics', 'traffic'):
        shutil.copytree(os.path.join(BENCH, d), os.path.join(dst, d))
    os.makedirs(os.path.join(dst, 'configs'))
    for n in sorted(f[:-len('.json')] for f in os.listdir(
            os.path.join(BENCH, 'configs')) if f.endswith('.json')):
        with open(os.path.join(BENCH, 'configs', n + '.json')) as fh:
            c = json.load(fh)
        c['protocol']['matrix'] = [12, 12, 8]
        c['mask']['semi_axes'] = [5.0, 5.0, 3.5]
        if not noddi_grid:
            c['model_params'].update(GRID_CUTS.get(n, {}))
        c['check']['voxels'] = 256
        with open(os.path.join(dst, 'configs', n + '_tiny.json'), 'w') as fh:
            json.dump(c, fh)
    tp = os.path.join(dst, 'traffic', 'study.json')
    with open(tp) as f:
        t = json.load(f)
    t.update(pool_subjects=2, sweep_subjects=2, warmup_subjects=1)
    with open(tp, 'w') as f:
        json.dump(t, f)
    with open(os.path.join(os.path.dirname(BENCH), 'BENCHMARK.json')) as f:
        b = json.load(f)
    # the study loop's cell, out of BENCHMARK.json while its host-clock
    # rate spreads wider than the largest bound (PERF.md), is still run
    with open(os.path.join(BENCH, 'tests', 'fixtures',
                           'study_cell.json')) as f:
        study = json.load(f)
    for key, entries in study.items():
        have = {e['name'] for e in b[key]}
        b[key] += [e for e in entries if e['name'] not in have]
    for w in b['workloads']:
        w['config'] += '_tiny'
    with open(os.path.join(dst, 'BENCHMARK.json'), 'w') as f:
        json.dump(b, f)
    return b


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """(BENCHMARK.json, folder) of a small benchmark; the program's tables
    and the cell's files under the test's temporary directory."""
    return _tiny(tmp_path, monkeypatch, False)


@pytest.fixture
def small(tmp_path, monkeypatch):
    """As ``tiny``, with NODDI's full atom grid."""
    return _tiny(tmp_path, monkeypatch, True)


def _tiny(tmp_path, monkeypatch, noddi_grid):
    monkeypatch.setenv('AMICO_TPU_HOME', str(tmp_path / 'amico_home'))
    monkeypatch.setenv('TMPDIR', str(tmp_path / 'tmp'))
    os.makedirs(tmp_path / 'tmp')
    import tempfile
    monkeypatch.setattr(tempfile, 'tempdir', None)
    d = str(tmp_path / 'bench')
    return small_bench(d, noddi_grid), d


@pytest.fixture
def card():
    """Skips the test without a CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (torch.cuda.is_available() is '
                    'false)')
