"""On the card, at each cell's own size: a short run of the benchmark's
command is correct and reports its end-to-end metrics, and the control
fails on three seeds.  Skips without a card."""
import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH
from portbench import judge, registry

CELLS = [w['name'] for w in registry.benchmark()['workloads']]


@pytest.mark.cuda
@pytest.mark.parametrize('workload', CELLS)
def test_short_run_is_correct(card, workload):
    p = subprocess.run(
        [sys.executable, os.path.join(BENCH, 'run.py'), '--workload',
         workload, '--seed', str(2 ** 31 + 5), '--seconds', '3',
         '--trace', '0'], cwd=os.path.dirname(BENCH), capture_output=True,
        text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r['correct'], r['compared']
    assert 'setup_s' in r['metrics'] and len(r['metrics']) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize('workload', CELLS)
def test_control_fails_at_cell_size(card, workload, monkeypatch):
    import readings
    monkeypatch.setenv('AMICO_TPU_HOME', os.path.join(
        registry.ROOT, 'build', 'bench', 'amico_home'))
    w = registry.cell(registry.benchmark(), workload)
    limits = registry.config(w['config'])['check']['limits']
    for r in readings.read(w['config'], w['traffic'], (11, 12, 2 ** 31 + 13),
                           None, True):
        assert not judge.verdict({k: (v, limits.get(k))
                                  for k, v in r['numbers'].items()}), r
