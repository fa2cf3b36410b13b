"""K1's and K2's time by tile width on ``chip_smoke.py``'s 409,600-voxel
subjects, the per-tile overhead that fits those times, and the pull of a
fit's results to the host, on one card.

    python -m amico_tpu_torch.tools.tile_widths [--model M]... \\
        [--widths M=W1,W2,...]... [--chunks N] [--reps N] [--d2h] \\
        [--out FILE]

For each model (NODDI on K1; FreeWater Human and CylinderZeppelinBall,
``backend='pallas'``, on K2) the subject of ``tools/fit_turns.py`` is fitted
through ``Evaluation(device='cuda')`` once at each tile width of its ladder
(``tile_size`` set, the default chunking), with every launch of the kernel
kept (its arguments), then twice more for the warm fit's time and device
wait; with ``--chunks N`` each width's tiles go in N equal chunks (the
JAX driver's rule for a staged signal, at most 4 equal chunks, is N = 4 on
these subjects) in place of the default chunking.  The kept launches of
each width are then run again back to back on one stream and timed with
CUDA events, the widths in turns (the ladder, then reversed, ``--reps``
times over).  Each width's total kernel time T is
fitted by least squares to ``k (slots + c tiles)``: the padded voxel slots
and the tiles of that width's plan, c being the per-tile overhead in voxel
slots that ``engine.auto_tile_size`` takes.  The widths' maps are compared
with the 128-wide fit's (median, p95, max), and each width's maps are
audited against the exact oracle (``testing.*_oracle_audit``, 1,000
voxels).  ``--d2h`` times the final copy of a gathered fit's outputs,
(409,601, 3) and (409,601, 99) float32 on the card, into pageable memory
(``.cpu()``) and into pinned memory (``copy_`` into a ``pin_memory``
tensor of the caching host allocator, then a synchronise), in turns.
Every result is printed as one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

LADDERS = {'NODDI': tuple(range(32, 257, 32)),
           'FreeWater': (128, 256, 384, 512),
           'CylinderZeppelinBall': (64, 128, 192, 256)}
# the module attribute through which each model's fit calls its kernel
KERNEL = {'NODDI': ('amico_tpu_torch.models.noddi', 'noddi_fused_tiles'),
          'FreeWater': ('amico_tpu_torch.models._fitops', 'nneg_qp_tiles'),
          'CylinderZeppelinBall': ('amico_tpu_torch.models._fitops',
                                   'nneg_qp_tiles')}


def log(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(launches, fn):
    """ms of ``fn`` over every kept launch, back to back on one stream."""
    import torch
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    for a, kw in launches:
        fn(*a, **kw)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def dist(a, b) -> dict:
    e = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return {'median': float(np.median(e)), 'p95': float(np.percentile(e, 95)),
            'max': float(e.max()), 'share_off_5e-3': float(
                np.mean(e.reshape(e.shape[0], -1).max(-1) > 5e-3)),
            'bit_equal': bool(np.array_equal(a, b))}


def overhead_fit(slots, tiles, ms) -> dict:
    """Least squares of ms = k slots + kc tiles: k (ms a slot), c (slots a
    tile) and the relative residuals."""
    X = np.stack([np.asarray(slots, float), np.asarray(tiles, float)], 1)
    (k, kc), *_ = np.linalg.lstsq(X, np.asarray(ms, float), rcond=None)
    pred = X @ np.array([k, kc])
    return {'ms_per_slot': float(k), 'overhead_slots': float(kc / k),
            'rel_resid': [float(r) for r in (np.asarray(ms) - pred) / pred]}


def audit(ev, model) -> dict:
    from amico_tpu_torch import testing
    if model == 'NODDI':
        err = testing.noddi_oracle_audit(ev, n=1000, seed=0)
        return {'all': dist(err, 0 * err)}
    if model == 'FreeWater':
        err = testing.freewater_oracle_audit(ev, n=1000, seed=0)
        return {'all': dist(err, 0 * err)}
    err = testing.czb_oracle_audit(ev, n=1000, seed=0)
    return {k: dist(err[:, i], 0 * err[:, i]) for i, k in enumerate('va')}


def sweep(model, widths, reps, tmp, chunks=None):
    import importlib
    import torch
    import amico_tpu_torch
    from amico_tpu_torch.models.engine import auto_tile_size
    from .fit_turns import write_subject
    study = write_subject(model, os.path.join(tmp, model))
    ev = amico_tpu_torch.Evaluation(study, 'subj', device='cuda')
    ev.load_data(dwi_filename='DWI.nii', scheme_filename='DWI.scheme')
    ev.set_model(model)
    if model == 'CylinderZeppelinBall':
        ev.set_solver(backend='pallas')
    ev.generate_kernels(ndirs=500)
    ev.load_kernels()
    mask = ev.niiMASK_img == 1
    if chunks:
        from amico_tpu_torch.models.engine import build_tile_plan
        ev.fit()
        lut_idx = ev.model._plans.value.lut_idx
    mod_name, attr = KERNEL[model]
    mod = importlib.import_module(mod_name)
    kernel = getattr(mod, attr)
    kept, rows, maps = {}, {}, {}
    try:
        for M in widths:
            ev.set_config('tile_size', M)
            if chunks:
                n_tiles = build_tile_plan(lut_idx, M).n_tiles
                ev.set_config('voxels_per_chunk', -(-n_tiles // chunks) * M)
            launches = kept[M] = []

            def keeping(*a, **kw):
                launches.append((a, kw))
                return kernel(*a, **kw)
            setattr(mod, attr, keeping)
            t0 = time.time()
            ev.fit()
            first_s = time.time() - t0
            setattr(mod, attr, kernel)
            warm, dev = [], []
            for _ in range(2):
                t0 = time.time()
                ev.fit()
                warm.append(time.time() - t0)
                dev.append(ev.model._last_fit_timers['device_s'])
            plan = ev.model._plans.value.by_width[M]
            maps[M] = ev.RESULTS['MAPs'][mask].copy()
            rows[M] = {'n_tiles': int(plan.n_tiles),
                       'slots': int(plan.n_tiles * M),
                       'launches': len(launches), 'first_fit_s': first_s,
                       'warm_fit_s': warm, 'device_s': dev,
                       'engine': ev.model._last_fit_timers,
                       'audit': audit(ev, model)}
    finally:
        setattr(mod, attr, kernel)
        ev.set_config('tile_size', 'auto')
        ev.set_config('voxels_per_chunk', 'auto')
    turns = {M: [] for M in widths}
    for _ in range(reps):
        for M in list(widths) + list(widths)[::-1]:
            turns[M].append(cuda_ms(kept[M], kernel))
    for M in widths:
        rows[M]['kernel_ms'] = turns[M]
        rows[M]['kernel_ms_median'] = float(np.median(turns[M]))
        if 128 in maps and M != 128:
            rows[M]['maps_vs_128'] = dist(maps[M], maps[128])
    fit = overhead_fit([rows[M]['slots'] for M in widths],
                       [rows[M]['n_tiles'] for M in widths],
                       [rows[M]['kernel_ms_median'] for M in widths])
    counts = ev.model._plans.value.counts
    c = max(fit['overhead_slots'], 0.0)
    out = {'model': model, 'chunks': chunks,
           'widths': {str(M): rows[M] for M in widths}, 'fit': fit,
           'auto_tile_size': auto_tile_size(counts, tuple(widths), c),
           'fastest_kernel': min(widths,
                                 key=lambda M: rows[M]['kernel_ms_median']),
           'fastest_warm_fit': min(widths, key=lambda M: float(
               np.median(rows[M]['warm_fit_s']))),
           'resolved_auto': None}
    ev.fit()
    out['resolved_auto'] = ev.model._last_fit_timers['tile_size']
    del kept
    torch.cuda.empty_cache()
    return out


def d2h(reps):
    """The final copy of a gathered fit's outputs, pageable against pinned,
    in turns (host clock, ms)."""
    import torch
    res = {}
    for shape in ((409_601, 3), (409_601, 99)):
        src = torch.rand(shape, device='cuda')
        torch.cuda.synchronize()

        def pageable():
            return src[:-1].cpu().numpy()

        def pinned():
            dst = torch.empty((shape[0] - 1,) + shape[1:], pin_memory=True)
            dst.copy_(src[:-1], non_blocking=True)
            torch.cuda.synchronize()
            return dst.numpy()
        ref = pageable()
        if not np.array_equal(pinned(), ref):
            raise SystemExit('the pinned copy differs from the pageable one')
        ms = {'pageable': [], 'pinned': []}
        for _ in range(reps):
            for k in ('pageable', 'pinned', 'pinned', 'pageable'):
                t0 = time.perf_counter()
                out = pageable() if k == 'pageable' else pinned()
                ms[k].append((time.perf_counter() - t0) * 1e3)
                del out
        res[str(shape)] = {k: {'median': float(np.median(v)), 'ms': v}
                           for k, v in ms.items()}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--model', action='append',
                    choices=tuple(LADDERS))
    ap.add_argument('--widths', action='append', default=[],
                    help='MODEL=W1,W2,... in place of the model\'s ladder')
    ap.add_argument('--chunks', type=int)
    ap.add_argument('--reps', type=int, default=3)
    ap.add_argument('--d2h', action='store_true')
    ap.add_argument('--out')
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('tile_widths needs a CUDA card')
    import amico_tpu_torch
    amico_tpu_torch.set_verbose(1)
    ladders = dict(LADDERS)
    for spec in a.widths:
        name, ws = spec.split('=', 1)
        ladders[name] = tuple(int(w) for w in ws.split(','))
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        os.environ['AMICO_TPU_HOME'] = os.path.join(tmp, 'home')
        for model in a.model or ():
            results.append(sweep(model, ladders[model], a.reps, tmp,
                                 a.chunks))
            log(results[-1])
    if a.d2h:
        results.append({'d2h': d2h(a.reps * 3)})
        log(results[-1])
    if a.out:
        with open(a.out, 'w') as f:
            json.dump(results, f, indent=1)


if __name__ == '__main__':
    main()
