"""The harness finds configurations, traffic mixes and per-layer metrics
by name, so that a later change adds them as files alone; and the
repository's BENCHMARK.json names only pieces that exist."""
import json
import os

import reference
from conftest import BENCH
from portbench import registry


def test_new_pieces_are_found_as_files(tmp_path):
    d = tmp_path / 'bench'
    for sub in ('configs', 'traffic', 'metrics'):
        (d / sub).mkdir(parents=True)
    (d / 'configs' / 'hcp_like.json').write_text(json.dumps({'lut': 1}))
    (d / 'traffic' / 'burst.json').write_text(json.dumps({'kind': 'refit'}))
    (d / 'metrics' / 'fits_seen.refit.py').write_text(
        'def read(run):\n    return run.count\n')
    assert registry.config('hcp_like', str(d)) == {'lut': 1,
                                                   'name': 'hcp_like'}
    assert registry.traffic('burst', str(d))['kind'] == 'refit'
    read = registry.metric_reader('fits_seen.refit', str(d))
    assert read(type('R', (), {'count': 7})()) == 7


def test_metrics_of_a_cell():
    bench = {'end_to_end': [{'name': 'a'}, {'name': 'b', 'workloads': ['x']}],
             'per_layer': [{'name': 'c', 'workloads': ['y']}, {'name': 'd'}]}
    names = lambda ms: [m['name'] for m in ms]  # noqa: E731
    assert names(registry.metrics_of(bench, 'x', False)) == ['a', 'b']
    assert names(registry.metrics_of(bench, 'y', False)) == ['a']
    assert names(registry.metrics_of(bench, 'y', True)) == ['c', 'd']


def test_benchmark_json_names_existing_pieces():
    bench = registry.benchmark()
    root = os.path.dirname(BENCH)
    for c in bench['configs']:
        assert os.path.isfile(os.path.join(root, c['file']))
        ref = registry.config(c['name'])['reference']
        assert os.path.isfile(os.path.join(BENCH, 'reference', ref + '.py'))
        mod = reference.module(ref)
        assert all(callable(getattr(mod, f, None))
                   for f in ('atoms', 'work', 'solve'))
    for w in bench['workloads']:
        registry.config(w['config'])
        assert registry.traffic(w['traffic'])['kind'] in ('refit', 'study')
        e2e = registry.metrics_of(bench, w['name'], False)
        layer = registry.metrics_of(bench, w['name'], True)
        assert 'setup_s' in [m['name'] for m in e2e] and len(e2e) >= 2
        assert layer
        for m in layer:
            assert m['moves'] in [e['name'] for e in e2e]
    for m in bench['per_layer']:
        registry.metric_reader(m['name'])


def test_the_study_cell_of_the_tests_names_existing_pieces():
    """The study cell that the tests put back into their copy of
    BENCHMARK.json reads metrics and traffic that exist."""
    with open(os.path.join(BENCH, 'tests', 'fixtures',
                           'study_cell.json')) as f:
        study = json.load(f)
    (w,) = study['workloads']
    assert registry.traffic(w['traffic'])['kind'] == 'study'
    registry.config(w['config'])
    assert [m['name'] for m in study['end_to_end']] == ['study_voxels_per_s']
    for m in study['per_layer']:
        assert m['moves'] == 'study_voxels_per_s'
        registry.metric_reader(m['name'])
