"""Smoke run of the PyTorch/CUDA port (amico_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile amico_tpu_torch/csrc/*.cu with nvcc into build/;
3. kernel vs twin: the fused NODDI kernel against its plain PyTorch twin,
   both on the card, on 3,200 128-voxel tiles of synthetic voxels on the
   full 145-atom grid in the main path's launches, in vivo and exvivo;
   maps by median/p95/max and coefficients by stage-3 objective (both ways
   and the share of voxels where the kernel's is worse), with both times;
4. main path: a synthetic full-brain subject (409,600 masked voxels on
   the JAX bench's reference-scale protocol, 9 b0 + 30 @ b=700 + 60 @
   b=2000) through Evaluation(device='cuda'): load_data ->
   set_model('NODDI') -> generate_kernels(ndirs=500) -> load_kernels ->
   fit -> save_results, with the kernel's launch count, the DTI directions
   against the true ones, map sanity and an exact-oracle audit of 1,000
   sampled voxels.

The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.  Nothing of JAX is imported.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

sys.modules['jax'] = None       # the port must run where JAX is absent

N_VOXELS = 409_600              # a full brain's masked voxels
VOL_DIM = (80, 80, 64)          # 80 * 80 * 64 == N_VOXELS
N_TILES = 3200                  # tiles in the kernel-vs-twin phase: 409,600
                                # voxels, about the main path's tile count
# bench.py's reference-scale protocol, on which the JAX package's oracle
# audit (PARITY.md) was measured: 9 b0 + 30 @ b=700 + 60 @ b=2000
PROTOCOL = dict(nb0=9, shells=(700.0, 2000.0), ndir=(30, 60))
# kernel vs twin (identical float32 math, different summation order): the
# stage-2 lasso's vertex is degenerate below f32 resolution on a few voxels,
# so maps are compared by distribution and coefficients by objective.  The
# p95 map bound holds in vivo only: exvivo on data without a dot compartment
# lets the dot and iso atoms trade places on ~10% of voxels (the twin moves
# its own exvivo p95 to ~1e-2 under a mere change of summation order), and
# there the objective decides: both ways (p99 of the relative gap) and one
# way (the share of voxels whose kernel objective is worse than the twin's
# by more than 1e-3 relative)
KERNEL_MAP_MEDIAN, KERNEL_MAP_P95 = 1e-5, 5e-3
KERNEL_OBJ_P99, KERNEL_OBJ_WORSE = 1e-3, 1e-3
# the card's DTI directions against the true ones: the share of voxels whose
# LUT direction agrees (1.0 on 40,000 of these voxels, port's OLS on the CPU)
DIRS_AGREE = 0.999
# oracle audit bounds (the JAX package's audit: median 1.5e-5, p95 4.7e-3,
# max 4.3e-2, the max one OD cell)
AUDIT_MEDIAN, AUDIT_P95, AUDIT_MAX = 5e-5, 5e-3, 5e-2


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f'FAILED: {msg}')


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_device():
    import torch
    check(torch.cuda.is_available(), 'no CUDA device')
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f'nvidia-smi failed: {smi.stderr}')
    log(f'device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}')
    return name, smi.stdout.strip().splitlines()[0]


def phase_build():
    from amico_tpu_torch.ops import cuda_build
    t0 = time.time()
    cuda_build.load_library()
    log(f'build: {time.time() - t0:.2f} s '
        f'(nvcc {cuda_build.last_build_seconds} s; None = reused) '
        f'-> {cuda_build.library_path()}')


def phase_kernel_vs_twin(scheme, kernels, htable):
    import torch
    from amico_tpu_torch.models import NODDI
    from amico_tpu_torch.models.base import (DEFAULT_TILE_SIZE,
                                             DEFAULT_VOXELS_PER_CHUNK)
    from amico_tpu_torch.ops.cuda_qp import (noddi_fused_tiles,
                                             noddi_fused_tiles_torch)
    from amico_tpu_torch.testing import fused_agreement, noddi_tile_inputs
    step = DEFAULT_VOXELS_PER_CHUNK // DEFAULT_TILE_SIZE

    def chunks(args):
        # the main path's launches: `step` tiles each (per-tile Grams,
        # dictionaries and signals), the LUT constants shared
        for i in range(0, N_TILES, step):
            yield [a[i:i + step] if a.dim() == 3 else a for a in args]

    def run(fn, args, exvivo):
        outs = [fn(*c, want_x=True, is_exvivo=exvivo) for c in chunks(args)]
        return tuple(torch.cat(o) for o in zip(*outs))

    worst, times = 0.0, None
    for exvivo in (False, True):
        model = NODDI()
        model.set(isExvivo=exvivo)
        model.scheme = scheme
        args = noddi_tile_inputs(model, kernels, htable, 'cuda', N_TILES,
                                 seed=1)
        out_k = run(noddi_fused_tiles, args, exvivo)
        out_t = run(noddi_fused_tiles_torch, args, exvivo)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out_k[0]).all()), 'kernel maps not finite')
        a = fused_agreement(args, out_k, out_t)
        log(f'kernel vs twin (exvivo={exvivo}, {N_TILES} tiles x 128 voxels '
            f'in launches of {step} tiles, {args[2].shape[-1]} atoms): '
            f'maps median {a["map_median"]:.3g} p95 {a["map_p95"]:.3g} max '
            f'{a["map_max"]:.3g}, voxels off > 5e-3 {a["map_share_off"]:.4g}; '
            f'stage-3 objective gap p99 {a["obj_gap_p99"]:.3g} max '
            f'{a["obj_gap_max"]:.3g}, kernel worse > 1e-3 on '
            f'{a["obj_share_worse"]:.4g} of voxels (better on '
            f'{a["obj_share_better"]:.4g}), objective > 0 on '
            f'{a["obj_above_zero"][0]} (kernel) / {a["obj_above_zero"][1]} '
            '(twin) voxels')
        check(a['map_median'] < KERNEL_MAP_MEDIAN
              and a['obj_gap_p99'] < KERNEL_OBJ_P99
              and a['obj_share_worse'] < KERNEL_OBJ_WORSE
              and (exvivo or a['map_p95'] < KERNEL_MAP_P95),
              'kernel disagrees with its twin')
        worst = max(worst, a['map_max'])
        if not exvivo:
            first = next(chunks(args))
            ms = cuda_ms(lambda: noddi_fused_tiles(*first), 5)
            plain_ms = cuda_ms(lambda: noddi_fused_tiles_torch(*first), 2)
            times = (ms, plain_ms)
            log(f'kernel {ms:.3f} ms, twin {plain_ms:.3f} ms per launch of '
                f'{step} tiles x 128 voxels (CUDA events)')
        del args, out_k, out_t
    return worst, times


def phase_main_path(study, lut_true):
    import numpy as np
    import amico_tpu_torch
    from amico_tpu_torch.ops.cuda_qp import noddi_fused_tiles
    from amico_tpu_torch.testing import (direction_agreement,
                                         noddi_oracle_audit)
    noddi_fused_tiles.launches = 0
    t0 = time.time()
    ev = amico_tpu_torch.Evaluation(study, 'subj', device='cuda')
    ev.load_data(dwi_filename='DWI.nii', scheme_filename='DWI.scheme')
    ev.set_model('NODDI')
    ev.generate_kernels(ndirs=500)
    ev.load_kernels()
    t_fit = time.time()
    ev.fit()
    fit_s = time.time() - t_fit
    ev.save_results()
    launches = noddi_fused_tiles.launches
    log(f'main path: {time.time() - t0:.2f} s end to end; launches '
        f'{launches}')
    n_vox = int(np.count_nonzero(ev.niiMASK_img == 1))
    log('stage times (s): ' + json.dumps(
        {k: round(v, 4) for k, v in ev.timers.times.items()}))
    log('fit breakdown (s): ' + json.dumps(
        {k: round(v, 4) for k, v in ev._last_fit_facade_timers.items()})
        + ' engine: ' + json.dumps(
        {k: round(v, 4) for k, v in ev.model._last_fit_timers.items()}))
    log(f'first fit: {n_vox} voxels in {fit_s:.3f} s = {n_vox / fit_s:.0f} '
        'voxels/s')
    check(launches > 0, 'the main path never launched the fused kernel')
    agree = direction_agreement(ev, lut_true)
    log(f'DTI directions (card): LUT direction of the true one on '
        f'{agree:.6f} of voxels')
    check(agree >= DIRS_AGREE, 'the DTI directions disagree with the truth')
    maps = ev.RESULTS['MAPs'][ev.niiMASK_img == 1]
    check(maps.shape == (n_vox, 3), f'maps shape {maps.shape}')
    check(bool(np.isfinite(maps).all()), 'maps not finite')
    check(bool((maps >= 0).all() and (maps <= 1).all()),
          f'maps outside [0, 1]: {maps.min()} .. {maps.max()}')
    for name in ('NDI', 'ODI', 'FWF', 'dir'):
        check(os.path.isfile(os.path.join(study, 'subj', 'AMICO', 'NODDI',
                                          f'fit_{name}.nii.gz')),
              f'fit_{name}.nii.gz not written')

    t_fit = time.time()
    ev.fit()
    warm_s = time.time() - t_fit
    log(f'second fit: {warm_s:.3f} s = {n_vox / warm_s:.0f} voxels/s; '
        'engine: ' + json.dumps(
            {k: round(v, 4) for k, v in ev.model._last_fit_timers.items()}))

    t_a = time.time()
    err = noddi_oracle_audit(ev, n=1000, seed=0)
    med, p95, mx = np.median(err), np.percentile(err, 95), err.max()
    log(f'oracle audit (1000 voxels, {time.time() - t_a:.1f} s): median '
        f'{med:.3g} p95 {p95:.3g} max {mx:.3g}; per map max '
        f'NDI {err[:, 0].max():.3g} ODI {err[:, 1].max():.3g} '
        f'FWF {err[:, 2].max():.3g}')
    check(med < AUDIT_MEDIAN and p95 < AUDIT_P95 and mx < AUDIT_MAX,
          'oracle audit outside its bounds')
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        log('FAILED: torch.cuda.is_available() is false')
        return 1
    import amico_tpu_torch
    from amico_tpu_torch.testing import (demo_noddi, demo_scheme, demo_voxels,
                                         write_demo_subject)
    amico_tpu_torch.set_verbose(1)
    torch.manual_seed(0)
    name, smi = phase_device()
    phase_build()
    root = os.path.dirname(os.path.abspath(amico_tpu_torch.__file__))
    base = os.path.join(os.path.dirname(root), 'build', 'chip_smoke')
    os.makedirs(base, exist_ok=True)
    os.environ['AMICO_TPU_HOME'] = os.path.join(base, 'home')
    scheme = demo_scheme(**PROTOCOL)
    with tempfile.TemporaryDirectory(dir=base) as tmp:
        t0 = time.time()
        _, kernels, htable = demo_noddi(scheme, small=False,
                                        kernels_dir=os.path.join(tmp, 'k'))
        log(f'full-grid kernels: {time.time() - t0:.1f} s')
        max_err, (ms, plain_ms) = phase_kernel_vs_twin(scheme, kernels,
                                                       htable)
        study = os.path.join(tmp, 'study')
        t0 = time.time()
        y, _, lut_true = demo_voxels(N_VOXELS, kernels, htable, seed=7)
        write_demo_subject(os.path.join(study, 'subj'), scheme, y, VOL_DIM)
        del y
        log(f'subject written: {time.time() - t0:.1f} s')
        launches = phase_main_path(study, lut_true)
    log(json.dumps({'kernels': [{
        'name': 'noddi_fused', 'route': 'cuda',
        'source': 'amico_tpu_torch/csrc/noddi_fused.cu',
        'replaces': 'amico_tpu/ops/pallas_qp.py:764',
        'launches': launches, 'max_abs_err': max_err,
        'ms': ms, 'plain_ms': plain_ms}]}))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
