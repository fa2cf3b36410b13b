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
   sampled voxels;
5. tile QP vs twin: the tile QP kernel against its plain PyTorch twin,
   both on the card, in the main path's launches of 512 tiles x 128
   voxels: FreeWater Human and Mouse (3,200 tiles each, the default
   active-set schedule with `converge`) by maps and objective, and
   tests/test_pallas_qp.py's random problems (n = 21, lambda2 = 4, 512
   tiles) under the dense schedule, so FISTA and the flat budget run too;
6. FreeWater main path: a 409,600-voxel FreeWater subject (same volume
   and protocol) through Evaluation(device='cuda') with
   doSaveCorrectedDWI, load_data -> save_results, with the tile QP's
   launch count, the DTI directions, map sanity, the written files and an
   exact-oracle audit of 1,000 sampled voxels.

The kernels are built in phase 2; every launch count is read from the main
path's run alone (counts set to 0 just before it).  The last two lines are
the kernels' JSON record and {"ok": true, "device": {...}}.  Nothing of JAX
is imported.
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
# tile QP vs twin (identical float32 math, different summation order).
# Medians and both objective bounds as for the fused solve; the p95 and max
# bounds come from the JAX package against itself, its XLA path against
# its Pallas kernel on the same tile inputs (64 FreeWater tiles, this
# protocol, CPU):
#   Human maps p95 1.2e-5, max 3.9e-4 (2,048 fitted voxels: 2.1e-4, 1.3e-3)
#   Mouse maps p95 7.2e-5, max 3.9e-3 (2,048 fitted voxels: 1.3e-3, 5.1e-3)
#   random problems, x: p95 7.5e-9, max 6.0e-8 (held to tests/
#   test_pallas_qp.py's 2e-4 instead)
# FreeWater is held on maps, not x: its adjacent zeppelins are
# near-collinear, so x moves between them at no cost in the objective (x max
# 0.09 in the same reading, objective gap 5e-7).  Mouse's map median sits
# above 1e-5 for any change of summation order: on these 3,200 tiles the
# twin against itself with its zeppelins in reverse order reads 1.51e-5, the
# twin on the CPU against the twin on the card 1.56e-5 (H100), and the JAX
# package's XLA path against its Pallas kernel 9.0e-5 on 2,048 fitted voxels
# (CPU); Human reads 3.58e-6 both ways.  (median, p95, max)
QP_BOUNDS = {'Human': (1e-5, 1e-3, 5e-3), 'Mouse': (3e-5, 5e-3, 2e-2),
             'dense': (1e-5, 2e-4, 2e-4)}
QP_OBJ_P99, QP_OBJ_WORSE = 1e-3, 1e-3
# FreeWater's DTI directions against the true ones, on voxels whose weight
# lies mostly (> 0.5) on the zeppelins with d_perp < d_par (the last Human
# zeppelin and the ball have no direction): 0.999864 agree on the 36,720
# such voxels of a 40,000-voxel cut of this subject, 0.989475 of all its
# voxels (port's OLS on the CPU)
FW_DIRS_AGREE = 0.999
# FreeWater oracle audit (Human) against native.lasso(A, y, 0, 1e-3): the
# JAX package read median 3.7e-5 (XLA) / 4.8e-5 (Pallas), p95 4.3e-4, max
# 1.3e-3 on 2,048 voxels of this protocol (CPU)
FW_AUDIT_MEDIAN, FW_AUDIT_P95, FW_AUDIT_MAX = 1e-4, 1e-3, 5e-3


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


def phase_qp_vs_twin(scheme, tmp):
    """The tile QP kernel against its twin; returns the worst compared
    error and the kernel's and twin's ms per launch of the main path's
    shape (FreeWater Human, 512 tiles x 128 voxels)."""
    import torch
    from amico_tpu_torch.models.base import (DEFAULT_AS_SOLVER_KW,
                                             DEFAULT_TILE_SIZE,
                                             DEFAULT_VOXELS_PER_CHUNK,
                                             DENSE_AS_SOLVER_KW)
    from amico_tpu_torch.ops.cuda_qp import nneg_qp_tiles, nneg_qp_tiles_torch
    from amico_tpu_torch.testing import (demo_freewater, freewater_tile_inputs,
                                         qp_agreement, random_qp_problems)
    step = DEFAULT_VOXELS_PER_CHUNK // DEFAULT_TILE_SIZE

    def run(fn, G, b, lam2, kw):
        return torch.cat([fn(G[i:i + step], b[i:i + step], None, 0.0, lam2,
                             **kw) for i in range(0, G.shape[0], step)])

    def cases():
        for typ in ('Human', 'Mouse'):
            model, kernels, htable = demo_freewater(
                scheme, typ, os.path.join(tmp, f'fw_{typ}'))
            yield (typ, *freewater_tile_inputs(model, kernels, htable, 'cuda',
                                               N_TILES, seed=1),
                   1e-3, DEFAULT_AS_SOLVER_KW, kernels['D'].shape[0])
        G, b = random_qp_problems(step, 21, seed=0)
        yield ('dense', torch.from_numpy(G).cuda(),
               torch.from_numpy(b).cuda(), 4.0, DENSE_AS_SOLVER_KW, None)

    worst, times = 0.0, None
    for name, G, b, lam2, kw, n_perp in cases():
        x_k = run(nneg_qp_tiles, G, b, lam2, kw)
        x_t = run(nneg_qp_tiles_torch, G, b, lam2, kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(x_k).all() and (x_k >= 0).all()),
              f'tile QP kernel output not finite and >= 0 ({name})')
        a = qp_agreement(G, b, 0.0, lam2, x_k, x_t, n_perp=n_perp)
        key = 'x' if n_perp is None else 'map'
        first = (G[:step], b[:step])
        ms = cuda_ms(lambda: nneg_qp_tiles(*first, None, 0.0, lam2, **kw), 5)
        plain_ms = cuda_ms(
            lambda: nneg_qp_tiles_torch(*first, None, 0.0, lam2, **kw), 2)
        log(f'tile QP vs twin ({name}, {G.shape[0]} tiles x {b.shape[1]} '
            f'voxels, n = {b.shape[2]}, launches of {step} tiles): {key} '
            f'median {a[key + "_median"]:.3g} p95 {a[key + "_p95"]:.3g} max '
            f'{a[key + "_max"]:.3g} (x max {a["x_max"]:.3g}); objective gap '
            f'p99 {a["obj_gap_p99"]:.3g} max {a["obj_gap_max"]:.3g}, kernel '
            f'worse > 1e-3 on {a["obj_share_worse"]:.4g} of voxels (better '
            f'on {a["obj_share_better"]:.4g}); kernel {ms:.3f} ms, twin '
            f'{plain_ms:.3f} ms per launch of {step} tiles (CUDA events)')
        med, p95, mx = QP_BOUNDS[name]
        check(a[key + '_median'] < med and a[key + '_p95'] < p95
              and a[key + '_max'] < mx and a['obj_gap_p99'] < QP_OBJ_P99
              and a['obj_share_worse'] < QP_OBJ_WORSE,
              f'tile QP kernel disagrees with its twin ({name})')
        worst = max(worst, a[key + '_max'])
        if name == 'Human':
            times = (ms, plain_ms)
        del G, b, x_k, x_t
    return worst, times


def phase_fw_main_path(study, lut_true, aniso):
    import numpy as np
    import amico_tpu_torch
    from amico_tpu_torch.ops.cuda_qp import nneg_qp_tiles, noddi_fused_tiles
    from amico_tpu_torch.testing import (direction_agreement,
                                         freewater_oracle_audit)
    nneg_qp_tiles.launches = noddi_fused_tiles.launches = 0
    t0 = time.time()
    ev = amico_tpu_torch.Evaluation(study, 'subj', device='cuda')
    ev.set_config('doSaveCorrectedDWI', True)
    ev.load_data(dwi_filename='DWI.nii', scheme_filename='DWI.scheme')
    ev.set_model('FreeWater')
    ev.generate_kernels(ndirs=500)
    ev.load_kernels()
    t_fit = time.time()
    ev.fit()
    fit_s = time.time() - t_fit
    ev.save_results()
    launches = nneg_qp_tiles.launches
    log(f'FreeWater main path: {time.time() - t0:.2f} s end to end; tile QP '
        f'launches {launches}, fused NODDI launches '
        f'{noddi_fused_tiles.launches}')
    n_vox = int(np.count_nonzero(ev.niiMASK_img == 1))
    log('stage times (s): ' + json.dumps(
        {k: round(v, 4) for k, v in ev.timers.times.items()}))
    log('fit breakdown (s): ' + json.dumps(
        {k: round(v, 4) for k, v in ev._last_fit_facade_timers.items()})
        + ' engine: ' + json.dumps(
        {k: round(v, 4) for k, v in ev.model._last_fit_timers.items()}))
    log(f'first fit: {n_vox} voxels in {fit_s:.3f} s = {n_vox / fit_s:.0f} '
        'voxels/s')
    check(launches > 0, 'the FreeWater path never launched the tile QP')
    agree_all = direction_agreement(ev, lut_true)
    agree = direction_agreement(ev, lut_true, aniso)
    log(f'DTI directions (card): LUT direction of the true one on '
        f'{agree_all:.6f} of all voxels, {agree:.6f} of the {int(aniso.sum())}'
        ' voxels mostly on anisotropic zeppelins')
    check(agree >= FW_DIRS_AGREE, 'the DTI directions disagree with the truth')
    maps = ev.RESULTS['MAPs'][ev.niiMASK_img == 1]
    check(maps.shape == (n_vox, 2), f'maps shape {maps.shape}')
    check(bool(np.isfinite(maps).all()), 'maps not finite')
    check(bool((maps >= 0).all() and (maps <= 1).all()),
          f'maps outside [0, 1]: {maps.min()} .. {maps.max()}')
    check(float(np.abs(maps.sum(1) - 1).max()) <= 1e-5,
          'FiberVolume + FW is not 1')
    dwi = ev.RESULTS['DWI_corrected']
    check(dwi.shape == VOL_DIM + (ev.scheme.nS,), f'DWI_corrected {dwi.shape}')
    check(bool(np.isfinite(dwi).all() and (dwi >= 0).all()),
          'DWI_corrected not finite and >= 0')
    for name in ('fit_FiberVolume', 'fit_FW', 'fit_dir', 'DWI_corrected'):
        check(os.path.isfile(os.path.join(study, 'subj', 'AMICO', 'FreeWater',
                                          f'{name}.nii.gz')),
              f'{name}.nii.gz not written')

    t_fit = time.time()
    ev.fit()
    warm_s = time.time() - t_fit
    log(f'second fit: {warm_s:.3f} s = {n_vox / warm_s:.0f} voxels/s; '
        'engine: ' + json.dumps(
            {k: round(v, 4) for k, v in ev.model._last_fit_timers.items()}))

    t_a = time.time()
    err = freewater_oracle_audit(ev, n=1000, seed=0)
    med, p95, mx = np.median(err), np.percentile(err, 95), err.max()
    log(f'FreeWater oracle audit (1000 voxels, {time.time() - t_a:.1f} s): '
        f'median {med:.3g} p95 {p95:.3g} max {mx:.3g}')
    check(med < FW_AUDIT_MEDIAN and p95 < FW_AUDIT_P95 and mx < FW_AUDIT_MAX,
          'FreeWater oracle audit outside its bounds')
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        log('FAILED: torch.cuda.is_available() is false')
        return 1
    import amico_tpu_torch
    from amico_tpu_torch.testing import (demo_freewater, demo_noddi,
                                         demo_scheme, demo_voxels,
                                         freewater_voxels, write_demo_subject)
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
        del lut_true
        qp_err, (qp_ms, qp_plain_ms) = phase_qp_vs_twin(scheme, tmp)
        model, fw_kernels, htable = demo_freewater(
            scheme, 'Human', os.path.join(tmp, 'fw_Human'))
        study = os.path.join(tmp, 'study_fw')
        t0 = time.time()
        y, _, lut_true, W = freewater_voxels(N_VOXELS, fw_kernels, htable,
                                             seed=7)
        n_perp = fw_kernels['D'].shape[0]
        aniso = W[:, :n_perp][:, model.d_perps < model.d_par].sum(1) > 0.5
        write_demo_subject(os.path.join(study, 'subj'), scheme, y, VOL_DIM)
        del y, W
        log(f'FreeWater subject written: {time.time() - t0:.1f} s')
        qp_launches = phase_fw_main_path(study, lut_true, aniso)
    log(json.dumps({'kernels': [{
        'name': 'noddi_fused', 'route': 'cuda',
        'source': 'amico_tpu_torch/csrc/noddi_fused.cu',
        'replaces': 'amico_tpu/ops/pallas_qp.py:764',
        'launches': launches, 'max_abs_err': max_err,
        'ms': ms, 'plain_ms': plain_ms}, {
        'name': 'nneg_qp_tiles', 'route': 'cuda',
        'source': 'amico_tpu_torch/csrc/nneg_qp.cu',
        'replaces': 'amico_tpu/ops/pallas_qp.py:432',
        'launches': qp_launches, 'max_abs_err': qp_err,
        'ms': qp_ms, 'plain_ms': qp_plain_ms}]}))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
