"""The readings that the limits of ``correct`` are set from (PERF.md).

    python3 benchmark/readings.py --config noddi_ukb --traffic refit_up \
        --seeds 1,2,3 [--program SECONDS] [--control]

For each seed, in one process: with ``--program`` a run of the cell with a
window of SECONDS (the lower readings: the numbers the program's answers
give against the reference), with ``--control`` the control in the
program's place (the upper readings: the reference computed in TF32 against
the reference).  One JSON line a reading.  The cell need not be in
BENCHMARK.json, so a cell left out can still be read.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from portbench import main, registry  # noqa: E402
from portbench.cells import Cell  # noqa: E402


def read(config: str, traffic: str, seeds, program: float | None,
         control: bool, device: str = 'cuda'):
    bench = dict(registry.benchmark())
    name = f'{config}.{traffic}'
    bench['workloads'] = [{'name': name, 'config': config,
                           'traffic': traffic, 'chips': 1}]
    for seed in seeds:
        if program is not None:
            r = main.run(bench, name, seed, program, False, device)
            yield {'seed': seed, 'reading': 'program',
                   'correct': r['correct'], 'attempted': r['attempted'],
                   'numbers': {k: v['value']
                               for k, v in r['compared'].items()}}
        if control:
            cell = Cell(registry.config(config), registry.traffic(traffic),
                        seed, device)
            try:
                cell.inputs(write=False)
                numbers = cell.check('tf32')
            finally:
                cell.cleanup()
            yield {'seed': seed, 'reading': 'control',
                   'numbers': {k: v for k, (v, _) in numbers.items()}}


if __name__ == '__main__':
    ap = argparse.ArgumentParser()
    ap.add_argument('--config', required=True)
    ap.add_argument('--traffic', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--program', type=float, default=None)
    ap.add_argument('--control', action='store_true')
    a = ap.parse_args()
    os.environ['AMICO_TPU_HOME'] = os.path.join(registry.ROOT, 'build',
                                                'bench', 'amico_home')
    for line in read(a.config, a.traffic,
                     [int(s) for s in a.seeds.split(',')], a.program,
                     a.control):
        print(json.dumps(line), flush=True)
