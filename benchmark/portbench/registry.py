"""Finds the benchmark's pieces by name: ``BENCHMARK.json`` at the
checkout's root, ``configs/<name>.json``, ``traffic/<name>.json`` and
``metrics/<name>.py`` under the benchmark's folder.  A new configuration,
traffic mix or metric is a new file there and an entry in
``BENCHMARK.json``; nothing here changes."""
from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, 'BENCHMARK.json'))


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return dict(_json(os.path.join(bench_dir, 'configs', name + '.json')),
                name=name)


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return dict(_json(os.path.join(bench_dir, 'traffic', name + '.json')),
                name=name)


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location(
        'portbench_metric_' + name.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell(bench: dict, workload: str) -> dict:
    for w in bench['workloads']:
        if w['name'] == workload:
            return w
    raise KeyError(f'no workload {workload!r} in BENCHMARK.json')


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: with ``trace`` the
    per-layer ones, else the end-to-end ones; a metric with a
    ``workloads`` list only in those cells."""
    key = 'per_layer' if trace else 'end_to_end'
    return [m for m in bench[key]
            if 'workloads' not in m or workload in m['workloads']]
