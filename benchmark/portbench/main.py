"""Command line of the benchmark: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``compared``: each number held against the
reference beside its limit, which also end standard error.  Exits non-zero
without a result when the card or the cell's card count is missing, or
when a JAX module was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import registry

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'amico_tpu')


def seconds_since_start() -> float:
    """Seconds since this process started (from /proc: the kernel's start
    tick against the uptime clock, both counted from boot)."""
    with open('/proc/self/stat') as f:
        start_ticks = int(f.read().rsplit(')', 1)[1].split()[19])
    with open('/proc/uptime') as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf('SC_CLK_TCK')


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a JAX package's."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(bench: dict, workload: str, seed: int, seconds: float, traced: bool,
        device: str = 'cuda', bench_dir: str = registry.BENCH_DIR) -> dict:
    """One run of ``workload`` with the pieces under ``bench_dir``;
    returns the result object."""
    import torch

    from .cells import Cell
    w = registry.cell(bench, workload)
    cell = Cell(registry.config(w['config'], bench_dir),
                registry.traffic(w['traffic'], bench_dir), seed, device)
    try:
        cell.setup()
        setup_s = seconds_since_start()
        if device == 'cuda':
            torch.cuda.reset_peak_memory_stats()
        e2e = cell.window(seconds, traced)
        peak = (torch.cuda.max_memory_allocated() if device == 'cuda'
                else 0)
        cell.release()
        compared = cell.check()
    finally:
        cell.cleanup()
    e2e['setup_s'] = setup_s
    metrics = {}
    run_ = cell.run
    run_.least_s, bound = cell.least_time()
    for m in registry.metrics_of(bench, workload, traced):
        value = (registry.metric_reader(m['name'], bench_dir)(run_) if traced
                 else e2e.get(m['name']))
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    from .judge import verdict
    dev = {'platform': 'gpu' if device == 'cuda' else device,
           'kind': (torch.cuda.get_device_name(0) if device == 'cuda'
                    else 'cpu'),
           'count': int(w['chips']), 'memory_peak_bytes': int(peak)}
    out = {'correct': bool(verdict(compared) and cell.failed == 0),
           'attempted': int(cell.attempted), 'failed': int(cell.failed),
           'metrics': metrics, 'device': dev}
    s = run_.summary
    if traced and s:
        dev['busy_s'], dev['window_s'] = s['busy_s'], s['window_s']
        out['breakdown'] = {'device_ops': s['device_ops'],
                            'idle_gaps': s['idle_gaps']}
        out['solve_bound'] = bound
    out['compared'] = {k: {'value': v, 'limit': lim}
                       for k, (v, lim) in compared.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = registry.benchmark()
    chips = int(registry.cell(bench, args.workload)['chips'])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'portbench: the cell needs {chips} CUDA card(s); '
              f'{torch.cuda.device_count()} visible', file=sys.stderr)
        return 2
    # the program's direction and rotation tables, in the checkout
    os.environ['AMICO_TPU_HOME'] = os.path.join(registry.ROOT, 'build',
                                                'bench', 'amico_home')
    result = run(bench, args.workload, args.seed, args.seconds,
                 bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f'portbench: JAX modules loaded: {", ".join(bad)}',
              file=sys.stderr)
        return 3
    for k, c in result['compared'].items():
        print(f'compared {k} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
