"""First and warm fits of two checkouts of the port, in turns, on one card.

    python -m amico_tpu_torch.tools.fit_turns TREE_A TREE_B [--reps N]
        [--model NODDI|FreeWater|CylinderZeppelinBall|SANDI] [--backend B]
        [--config KEY=VALUE]... [--config-b KEY=VALUE]... [--out FILE]

Writes ``chip_smoke.py``'s subject of the model once (409,600 voxels,
seed 7: NODDI and FreeWater Human on bench.py's reference-scale protocol,
CylinderZeppelinBall and SANDI on the JAX bench's STEJSKALTANNER one,
SANDI's direction-averaged by ``load_data``), then runs, for each checkout
in the order A B B A (``--reps`` times over), a fresh process with that
checkout first on ``sys.path``: ``Evaluation(device='cuda')``,
``load_data`` -> ``set_model`` (and ``set_solver(backend=B)`` when given)
-> ``generate_kernels(ndirs=500)`` -> ``load_kernels``, then three fits.
``--config`` sets an Evaluation config in every run before ``load_data``
(the value read as a Python literal, else as a string: ``tile_size=128``,
``voxels_per_chunk=65536``, ``doSaveCorrectedDWI=True``), ``--config-b``
in checkout B's runs only, after ``--config``: TREE_A and TREE_B may then
be the same checkout.  Each run prints the fits' wall times, the facade's
and the tile engine's timers and a digest of the maps as one JSON line;
the first fit pays the process's one-time CUDA set-up, the other two are
warm.  The summary gives each checkout's first fit, its stage_voxels_s,
its warm fit and device wait, whether every fit of both wrote the same
maps, bit for bit, and the distance of each run's maps from checkout A's
first run (median, p95 and max over the masked voxels' maps).
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

CHILD = '''
import hashlib, json, sys, time
sys.path.insert(0, {tree!r})
import numpy as np
import amico_tpu_torch
amico_tpu_torch.set_verbose(1)
ev = amico_tpu_torch.Evaluation({study!r}, 'subj', device='cuda')
ev.set_config('doDirectionalAverage', {model!r} == 'SANDI')
for k, v in {config!r}.items():
    ev.set_config(k, v)
ev.load_data(dwi_filename='DWI.nii', scheme_filename='DWI.scheme')
ev.set_model({model!r})
if {backend!r}:
    ev.set_solver(backend={backend!r})
ev.generate_kernels(ndirs=500)
ev.load_kernels()
fits = []
for _ in range(3):
    t0 = time.time()
    ev.fit()
    maps = np.ascontiguousarray(ev.RESULTS['MAPs'])
    fits.append(dict(ev.model._last_fit_timers, fit_s=time.time() - t0,
                     facade=ev._last_fit_facade_timers,
                     maps=hashlib.sha256(maps.tobytes()).hexdigest()))
np.save({maps_out!r}, ev.RESULTS['MAPs'][ev.niiMASK_img == 1])
print('RESULT ' + json.dumps({{'tree': {tree!r}, 'fits': fits}}))
'''


def parse_configs(pairs) -> dict:
    """{key: value} from KEY=VALUE strings, each value a Python literal
    where it reads as one, else the string."""
    out = {}
    for pair in pairs:
        key, _, value = pair.partition('=')
        try:
            out[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            out[key] = value
    return out


def distance(a, b) -> dict:
    """median, p95 and max of |a - b| over every map value."""
    e = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return {'median': float(np.median(e)),
            'p95': float(np.percentile(e, 95)), 'max': float(e.max())}


def write_subject(model, tmp):
    """chip_smoke.py's 409,600-voxel subject of ``model`` under tmp/study;
    returns the study directory."""
    from amico_tpu_torch.testing import (czb_scheme, czb_voxels, demo_czb,
                                         demo_freewater, demo_noddi,
                                         demo_scheme, demo_voxels,
                                         freewater_voxels, write_demo_subject)
    scheme = demo_scheme(nb0=9, shells=(700.0, 2000.0), ndir=(30, 60))
    kdir = os.path.join(tmp, 'k')
    if model == 'NODDI':
        _, kernels, htable = demo_noddi(scheme, small=False, kernels_dir=kdir)
        y = demo_voxels(409_600, kernels, htable, seed=7)[0]
    elif model == 'FreeWater':
        _, kernels, htable = demo_freewater(scheme, 'Human', kdir)
        y = freewater_voxels(409_600, kernels, htable, seed=7)[0]
    elif model == 'SANDI':
        from amico_tpu_torch.testing import demo_sandi, sandi_voxels
        scheme = czb_scheme()
        _, kernels, _ = demo_sandi(scheme, kdir)
        y = sandi_voxels(409_600, kernels, seed=7)[0]
    else:
        scheme = czb_scheme()
        _, kernels, htable = demo_czb(scheme, kdir)
        y = czb_voxels(409_600, kernels, htable, seed=7)[0]
    study = os.path.join(tmp, 'study')
    write_demo_subject(os.path.join(study, 'subj'), scheme, y, (80, 80, 64))
    return study


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('trees', nargs=2)
    ap.add_argument('--reps', type=int, default=2)
    ap.add_argument('--model', default='NODDI',
                    choices=('NODDI', 'FreeWater', 'CylinderZeppelinBall',
                             'SANDI'))
    ap.add_argument('--backend', default='')
    ap.add_argument('--config', action='append', default=[],
                    metavar='KEY=VALUE')
    ap.add_argument('--config-b', action='append', default=[],
                    metavar='KEY=VALUE')
    ap.add_argument('--out')
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('fit_turns needs a CUDA card')
    from amico_tpu_torch import set_verbose
    set_verbose(1)
    trees = [os.path.abspath(t) for t in a.trees]
    configs = [parse_configs(a.config),
               dict(parse_configs(a.config), **parse_configs(a.config_b))]
    runs, ref = [], None
    with tempfile.TemporaryDirectory() as tmp:
        home = os.path.join(tmp, 'home')
        os.environ['AMICO_TPU_HOME'] = home
        study = write_subject(a.model, tmp)
        env = dict(os.environ, AMICO_TPU_HOME=home)
        maps_out = os.path.join(tmp, 'maps.npy')
        for _ in range(a.reps):
            for label in 'ABBA':
                i = 'AB'.index(label)
                tree = trees[i]
                proc = subprocess.run(
                    [sys.executable, '-c', CHILD.format(
                        tree=tree, study=study, model=a.model,
                        backend=a.backend, config=configs[i],
                        maps_out=maps_out)],
                    cwd=tree, env=env, capture_output=True, text=True,
                    timeout=600)
                lines = [ln for ln in proc.stdout.splitlines()
                         if ln.startswith('RESULT ')]
                if proc.returncode != 0 or not lines:
                    raise SystemExit(f'{tree}: run failed\n'
                                     f'{proc.stderr[-3000:]}')
                run = dict(json.loads(lines[0][7:]), label=label,
                           config=configs[i])
                maps = np.load(maps_out)
                if ref is None:
                    ref = maps
                run['maps_vs_first_a'] = distance(maps, ref)
                runs.append(run)
                print(json.dumps(run), flush=True)
    for label, tree in zip('AB', trees):
        mine = [r for r in runs if r['label'] == label]
        first = [r['fits'][0]['fit_s'] for r in mine]
        stage = [r['fits'][0]['facade']['stage_voxels_s'] for r in mine]
        print(f'{label} {tree} {configs["AB".index(label)]}: first fit '
              f'median {np.median(first):.3f} s (readings '
              f'{[round(w, 3) for w in first]}); its stage_voxels_s '
              f'{[round(w, 4) for w in stage]}', flush=True)
        warm = [f['fit_s'] for r in mine for f in r['fits'][1:]]
        dev = [f['device_s'] for r in mine for f in r['fits'][1:]]
        print(f'{label}: warm fit median {np.median(warm):.3f} s '
              f'(readings {[round(w, 3) for w in warm]}); device wait '
              f'median {np.median(dev):.4f} s (readings '
              f'{[round(d, 4) for d in dev]})', flush=True)
    digests = {f['maps'] for r in runs for f in r['fits']}
    print(f'{a.model}: the same maps in every fit of both checkouts: '
          f'{len(digests) == 1}', flush=True)
    for label in 'AB':
        d = [r['maps_vs_first_a'] for r in runs if r['label'] == label]
        print(f'{label}: maps against A\'s first run: median '
              f'{max(x["median"] for x in d):.3g} p95 '
              f'{max(x["p95"] for x in d):.3g} max '
              f'{max(x["max"] for x in d):.3g} (the largest over its runs)',
              flush=True)
    if a.out:
        with open(a.out, 'w') as f:
            json.dump(runs, f, indent=1)


if __name__ == '__main__':
    main()
