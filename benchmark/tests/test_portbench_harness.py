"""A small refit and study pass of the harness on the CPU: it runs, is
correct, and reports its end-to-end metrics and the per-layer ones read
from host spans, and no device metric."""
import pytest

from portbench import main


@pytest.mark.parametrize('workload', ['noddi.refit_up', 'noddi.study',
                                      'freewater.refit_dwi'])
def test_cpu_pass(tiny, workload):
    bench, d = tiny
    r = main.run(bench, workload, 2 ** 31 + 7, 3.0, False, 'cpu', d)
    assert r['correct'], r['compared']
    assert r['attempted'] >= 2 and r['failed'] == 0
    names = set(r['metrics'])
    assert 'setup_s' in names and len(names) >= 2
    assert list(r)[-1] == 'compared'
    t = main.run(bench, workload, 11, 3.0, True, 'cpu', d)
    assert t['correct']
    assert not any('idle' in k or 'roofline' in k for k in t['metrics'])
    assert 'busy_s' not in t['device'] and 'breakdown' not in t
    assert t['metrics'] and all(v['value'] >= 0
                                for v in t['metrics'].values())
    assert main.forbidden_modules() == []
