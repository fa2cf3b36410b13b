"""Warm NODDI fits of two checkouts of the port, in turns, on one card.

    python -m amico_tpu_torch.tools.fit_turns TREE_A TREE_B [--reps N]
        [--out FILE]

Writes ``chip_smoke.py``'s NODDI subject once (409,600 voxels, bench.py's
reference-scale protocol, seed 7), then runs, for each checkout in the
order A B B A (``--reps`` times over), a fresh process with that checkout
first on ``sys.path``: ``Evaluation(device='cuda')``, ``load_data`` ->
``set_model('NODDI')`` -> ``generate_kernels(ndirs=500)`` ->
``load_kernels``, then three fits.  Each run prints the fits' wall times
and the tile engine's timers as one JSON line; the first fit pays the
process's one-time CUDA set-up, the other two are warm.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

CHILD = '''
import json, sys, time
sys.path.insert(0, {tree!r})
import amico_tpu_torch
amico_tpu_torch.set_verbose(1)
ev = amico_tpu_torch.Evaluation({study!r}, 'subj', device='cuda')
ev.load_data(dwi_filename='DWI.nii', scheme_filename='DWI.scheme')
ev.set_model('NODDI')
ev.generate_kernels(ndirs=500)
ev.load_kernels()
fits = []
for _ in range(3):
    t0 = time.time()
    ev.fit()
    fits.append(dict(ev.model._last_fit_timers, fit_s=time.time() - t0))
print('RESULT ' + json.dumps({{'tree': {tree!r}, 'fits': fits}}))
'''


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('trees', nargs=2)
    ap.add_argument('--reps', type=int, default=2)
    ap.add_argument('--out')
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('fit_turns needs a CUDA card')
    from amico_tpu_torch import set_verbose
    from amico_tpu_torch.testing import (demo_noddi, demo_scheme,
                                         demo_voxels, write_demo_subject)
    set_verbose(1)
    trees = [os.path.abspath(t) for t in a.trees]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        home = os.path.join(tmp, 'home')
        os.environ['AMICO_TPU_HOME'] = home
        scheme = demo_scheme(nb0=9, shells=(700.0, 2000.0), ndir=(30, 60))
        _, kernels, htable = demo_noddi(scheme, small=False,
                                        kernels_dir=os.path.join(tmp, 'k'))
        y, _, _ = demo_voxels(409_600, kernels, htable, seed=7)
        study = os.path.join(tmp, 'study')
        write_demo_subject(os.path.join(study, 'subj'), scheme, y,
                           (80, 80, 64))
        del y
        env = dict(os.environ, AMICO_TPU_HOME=home)
        for _ in range(a.reps):
            for tree in trees + trees[::-1]:
                proc = subprocess.run(
                    [sys.executable, '-c', CHILD.format(tree=tree,
                                                        study=study)],
                    cwd=tree, env=env, capture_output=True, text=True,
                    timeout=600)
                lines = [ln for ln in proc.stdout.splitlines()
                         if ln.startswith('RESULT ')]
                if proc.returncode != 0 or not lines:
                    raise SystemExit(f'{tree}: run failed\n'
                                     f'{proc.stderr[-3000:]}')
                run = json.loads(lines[0][7:])
                runs.append(run)
                print(json.dumps(run), flush=True)
    for tree in trees:
        warm = [f['fit_s'] for r in runs if r['tree'] == tree
                for f in r['fits'][1:]]
        dev = [f['device_s'] for r in runs if r['tree'] == tree
               for f in r['fits'][1:]]
        print(f'{tree}: warm fit median {np.median(warm):.3f} s '
              f'(readings {[round(w, 3) for w in warm]}); device wait '
              f'median {np.median(dev):.4f} s', flush=True)
    if a.out:
        with open(a.out, 'w') as f:
            json.dump(runs, f, indent=1)


if __name__ == '__main__':
    main()
