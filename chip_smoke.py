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
   for each, the `converge` tail (``testing.qp_tail`` on the twin's run:
   tiles by continuation rounds and by what ended them) and the kernel's
   time with and without `converge`; then the kernel against the twin at
   the kernel's lane-group edges (n = 8, 9, 16, 17 at 1, 7, 33 and 129
   voxels a tile; plain, masked and warm-started);
6. FreeWater main path: a 409,600-voxel FreeWater subject (same volume
   and protocol) through Evaluation(device='cuda') with
   doSaveCorrectedDWI, load_data -> save_results, with the tile QP's
   launch count, the DTI directions, map sanity, the written files and an
   exact-oracle audit of 1,000 sampled voxels;
7. build-cache probe (T1): ``amico_tpu_torch.tools.loc_experiment``'s
   candidates (the build key from two call sites and from a second process
   in another working directory, which must reuse the build), then T1
   against its twin, bit for bit, on (8, 128) and on an odd size, timed in
   turns with its twin and the one PyTorch call that computes the same
   function, ``torch.add(1, x, alpha=2)``;
8. CylinderZeppelinBall main path: a 409,600-voxel ACTIVEAX subject on the
   JAX bench's STEJSKALTANNER protocol (1 b0 + 30 @ b=3000 + 30 @
   b=6000, VERSION: 1 scheme; 21 radii + 4 zeppelins + 1 ball) through
   Evaluation(device='cuda'), load_data -> save_results with
   backend='auto', which is the stagewise solver: map ranges, the written
   files, the DTI directions, an exact-oracle audit of 1,000 voxels, first
   and second fit;
9. the same subject with backend='pallas' (K2 at n = 26): its launch
   count, its maps against the stagewise run's, and K2, its twin and the
   stagewise solver on 512 CZB tiles (agreement by maps and objective,
   times, the `converge` tail);
10. NODDI with backend='xla' (the stagewise solve) on phase 4's subject:
   its maps against the fused path's by distribution, and the oracle audit
   at phase 4's bounds;
11. K1a (right after phase 3, on the first 512 tiles of its in-vivo
   inputs): the fused kernel's general path against its twin under each
   route beyond the production schedule (the iteration knobs' FISTA
   schedule, stage-2 `converge` True and 24, the tie-break, the tie score,
   early_exit) at phase 3's bounds, each timed in turns with the default
   schedule;
12. SANDI main path: a 409,600-voxel subject on the bench's SANDI protocol
   (phase 8's scheme, direction-averaged to b0 + 2 shells by load_data
   with doDirectionalAverage) through Evaluation(device='cuda'),
   load_data -> save_results(save_dir_avg=True) on the stagewise solver:
   first and second fit, CUDA kernels a chunk (torch.profiler), the
   written files, an exact-oracle audit of 1,000 voxels;
13. the study path, on phase 4's subject (NODDI on K1) unless said:
   a. ``python -m amico_tpu_torch fit`` in a subprocess into another
      output path: its maps against phase 4's, bit for bit (else within
      K1's agreement bounds, with the reason logged);
   b. ``cli.main(['sweep', ...])`` in this process over phase 4's subject
      and one of seed 8: K1's launches, the per-subject times, the warm
      state reused for the second subject; a rerun skips both
      (``config.pickle`` untouched);
   c. the seed-8 subject with checkpoint_every=1, raised after its second
      chunk by a wrapper of the chunk function; the rerun resumes from
      ``done_until``, equals the uninterrupted fit bit for bit and deletes
      the checkpoint;
   d. NODDI, and FreeWater on phase 6's subject, staged and streamed beyond
      a 64 MiB ``max_device_bytes``: equal maps, times and peak device
      memory;
   e. the DTI methods (OLS, WLS, NLLS, RESTORE) on the staged signal: the
      LUT direction of the true one, their times, and the card against the
      port's CPU run on 4,096 voxels;
   f. phase 4's volume with Rician noise at SNR 20: the debias on the card
      against the CPU on 4,096 voxels, its time, then load_data with
      doDebiasSignal and a fit;
   g. a fit with ``profile_dir``: the trace names K1's kernel and ``fit``;
   h. ``python -m amico_tpu_torch warmup --study`` (beside a) exits 0.

The kernels are built in phase 2; every launch count is read from the main
path's run alone (counts set to 0 just before it).  Each kernel's bound is
the larger of its bytes (inputs read once, outputs written once) over the
card's memory rate and the operations that this run's inputs need
(``testing.solve_work`` counts the data-dependent solves on the timed
launch) over its float32 rate.  At the end the script checks that neither
JAX nor ``amico_tpu`` was imported and that the host layers ran on the
port's native library.  The last lines are the kernels' JSON record, the
card's name and power limit, and {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

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
# the tile QP at its lane-group edges against the twin on random problems:
# x as tests/test_pallas_qp.py holds the Pallas kernel to the XLA solver
# (atol 2e-4, rtol 1e-3), the objective within 1e-4 relative
QP_EDGE_ATOL, QP_EDGE_RTOL, QP_EDGE_OBJ = 2e-4, 1e-3, 1e-4
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
# T1 against its twin: bit for bit (2x is exact in float32, so the kernel's
# fma(x, 2, 1) rounds as the twin's x * 2 + 1); the odd size runs the
# grid-stride loop's ragged edge
T1_ODD = 1_000_003
# CylinderZeppelinBall (phases 8-9).  Oracle audit against native.lasso(A,
# y, 0, 4) on v and a (d = 4v/(pi a^2) is left out, as the JAX bench
# leaves it out).  The JAX package's stagewise path read v median 2.5e-7,
# p95 7.2e-7, max 2.8e-5 and a (um) 3.4e-6, 1.0e-5, 2.0e-5 on 1,000 of
# 4,096 voxels of this protocol, its Pallas kernel v 3.1e-7 / 9.9e-7 /
# 2.7e-5, a 4.5e-6 / 1.4e-5 / 3.2e-5 (CPU); the bounds sit well inside
# tests/test_solver_review.py's (v median 2e-3, p95 2e-2; a median 2e-2).
# (median, p95, max)
CZB_AUDIT = {'v': (2e-5, 2e-4, 2e-3), 'a': (2e-4, 2e-3, 2e-2)}
# backend='pallas' (K2) against backend='auto' (the stagewise solver): the
# JAX package's Pallas kernel against its XLA path read v median 3.6e-7,
# p95 1.1e-6, max 2.4e-6 and a 5.7e-6, 1.7e-5, 4.7e-5 on 4,096 fitted
# voxels (CPU): the lambda2 = 4 ridge makes the QP strongly convex, one
# vertex for both.  On 64 CZB tiles (CPU) K2's twin against the stagewise
# solver read v max 1.3e-6, a max 2.0e-5 and an objective gap of p99
# 6.0e-13, max 1.3e-12 (the JAX package's pair: 1.9e-12).  Bounds on maps
# as for the audit; the objective both ways (p99 of the relative gap) and
# one way (share of voxels where K2's is worse by > 1e-3 relative)
CZB_BACKENDS = {'v': (1e-5, 1e-4, 1e-3), 'a': (1e-4, 1e-3, 1e-2)}
CZB_OBJ_P99, CZB_OBJ_WORSE = 1e-5, 1e-3
# the DTI directions against the true ones on voxels whose weight lies
# mostly (> 0.5) on the cylinders and the zeppelins with d_perp < d_par:
# 0.999975 agree on the 39,761 such voxels of a 40,000-voxel draw of this
# subject, 0.999925 of all (port's OLS on the CPU)
CZB_DIRS_AGREE = 0.999
# NODDI with backend='xla' against the fused path (phase 4's maps) by
# distribution: the port's stagewise fit against its fused twin read
# median 0, p95 3.0e-8, max 1.2e-2 and 0.9% of voxels off by > 5e-3, the
# JAX stagewise path against the fused twin median 3.0e-5, p95 2.6e-3,
# max 3.3e-2 and 6.1% off, on 2,048 voxels of this protocol (CPU); the
# stage-2 vertex is degenerate below f32 resolution
NODDI_XLA_MEDIAN, NODDI_XLA_P95, NODDI_XLA_SHARE_OFF = 5e-5, 5e-3, 0.1
# K1's general path (the routes beyond the production schedule) against
# its twin: K1's bounds above, and for the want_tie score a median gap.
# The iteration knobs' schedule (FISTA 40, then 8 flat rounds, on the full
# grid) is itself sensitive to summation order: the Pallas kernel against
# itself with its WM atoms reordered reads maps median 1.12e-3, p95 5.5e-3
# on 2 x 128 voxels of tests/test_torch_noddi_fused.py's inputs (CPU; the
# production schedule 5.6e-6, 2.2e-3), and K1 against its twin read 9.5e-4,
# 4.95e-3, objective p99 2.4e-3, worse on 1.3% of voxels (H100).  Its
# bounds (map median, p95, objective p99, share worse), from those readings:
K1A_TIE_MEDIAN = 1e-4
K1A_KNOBS_BOUNDS = (5e-3, 2e-2, 1e-2, 5e-2)
# SANDI oracle audit (fsoma, fneurite, fextra; Rsoma in um) against
# native.lasso(A, y, 0, 5e-3) on the bench's columns 0-3: the JAX package's
# facade read fractions median 1.21e-5, p95 3.59e-5, max 7.73e-5 and Rsoma
# 1.13e-4, 4.30e-4, 1.77e-3 on 1,000 of 2,048 voxels of this protocol (CPU;
# tests/test_torch_sandi.py); bounds about ten times those.  (median, p95,
# max)
SANDI_AUDIT = {'fractions': (1e-4, 5e-4, 5e-3), 'Rsoma': (1e-3, 5e-3, 5e-2)}
# phase 13, the study path.  The streamed fits' device budget: the 409,600-
# voxel signal is 162 MB, so this streams 65,536-voxel chunks (26 MB), two
# in flight
STREAM_BUDGET = 64 << 20
# the DTI methods on the card against the port's CPU run on 4,096 voxels:
# the angle bounds (degrees, median and p99) that tests/test_torch_dti.py
# holds the port to against the JAX package on the CPU
DTI_CPU_MEDIAN, DTI_CPU_P99 = 0.05, 0.5
# the Rician debias: SNR of the noisy copy of phase 4's volume, and the card
# against the CPU as tests/test_torch_preproc.py holds the port to the JAX
# package (just above the noise floor the float32 rounding of S - floor
# sets the spread): |card - cpu| <= rtol |cpu| + atol sigma
SNR = 20.0
DEBIAS_RTOL, DEBIAS_ATOL = 1e-4, 2e-3
# the H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): HBM3
# bytes/s and float32 FLOP/s outside the tensor cores (the kernels compute
# in float32 on the CUDA cores)
PEAK_BYTES_S, PEAK_F32_FLOP_S = 3.35e12, 67e12


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


def bound(nbytes, flops):
    """(least ms, what sets it) for moving ``nbytes`` and doing ``flops``."""
    t_b, t_f = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOP_S * 1e3
    return (t_b, 'bytes') if t_b >= t_f else (t_f, 'operations')


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


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
    from amico_tpu_torch.testing import (fused_agreement, noddi_tile_inputs,
                                         solve_work)
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
            k1a_args = [a.clone() for a in first]
            ms = cuda_ms(lambda: noddi_fused_tiles(*first), 5)
            plain_ms = cuda_ms(lambda: noddi_fused_tiles_torch(*first), 2)
            _, work = solve_work(noddi_fused_tiles_torch, *first)
            C, M = first[2].shape[:2]
            n_b = nbytes(*first) + C * M * 4 * 4      # inputs, est
            b = bound(n_b, work['flops'])
            times = (ms, plain_ms) + b
            log(f'kernel {ms:.3f} ms, twin {plain_ms:.3f} ms per launch of '
                f'{step} tiles x 128 voxels (CUDA events); least work '
                f'{n_b} bytes, {work["flops"]:.4g} '
                f'FLOP ({work["matvecs"] / (C * M):.0f} matvecs a voxel, '
                f'{work["nonzeros"] / work["matvecs"]:.3g} nonzeros and '
                f'{work["rows"] / work["matvecs"]:.3g} rows each): bound '
                f'{b[0]:.4f} ms ({b[1]}), {b[0] / ms:.2%} of it reached')
        del args, out_k, out_t
    return worst, times, k1a_args


def phase_k1a(args, kernels):
    """K1's general path against its twin on the first 512 tiles of phase
    3's in-vivo inputs, one launch each, under each route the JAX kernel
    has beyond the production schedule; each route's ms a launch in turns
    with the default schedule."""
    import torch
    from amico_tpu_torch.models.noddi import _kappa_neighbours
    from amico_tpu_torch.ops.cuda_qp import (noddi_fused_tiles,
                                             noddi_fused_tiles_torch)
    from amico_tpu_torch.testing import fused_agreement
    from amico_tpu_torch.models.base import DEFAULT_NODDI_STAGE_ITERS
    nbm, nbp = _kappa_neighbours(kernels['icvf'], kernels['kappa'])
    prod1, prod2, prod3 = DEFAULT_NODDI_STAGE_ITERS
    routes = {
        'knobs (fista 40, 8 rounds, cg 12)': dict(
            stage_iters=((40, 8, 12, 2), (40, 8, 12, 2), (8, 12, 2))),
        'stage-2 converge=True': dict(
            stage_iters=(prod1, prod2[:4] + (True,) + prod2[5:], prod3)),
        'stage-2 converge=24': dict(
            stage_iters=(prod1, prod2[:4] + (24,) + prod2[5:], prod3)),
        'tiebreak_cg=8': dict(tiebreak_cg=8, nb_minus=nbm, nb_plus=nbp),
        'want_tie': dict(want_tie=True),
        'early_exit': dict(early_exit=True),
    }
    rows = {}
    for name, kw in routes.items():
        noddi_fused_tiles.launches = 0
        out_k = noddi_fused_tiles(*args, want_x=True, **kw)
        launches = noddi_fused_tiles.launches
        out_t = noddi_fused_tiles_torch(*args, want_x=True, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out_k[0]).all()),
              f'K1 maps not finite ({name})')
        a = fused_agreement(args, out_k[:2], out_t[:2])
        tie_gap = float((out_k[2] - out_t[2]).abs().median()) \
            if 'want_tie' in kw else None
        ms = {'default': [], name: []}
        for k in ('default', name, name, 'default'):
            fn = (lambda: noddi_fused_tiles(*args)) if k == 'default' \
                else (lambda: noddi_fused_tiles(*args, **kw))
            ms[k].append(cuda_ms(fn, 3))
        twin_ms = cuda_ms(lambda: noddi_fused_tiles_torch(*args, **kw), 1)
        rows[name] = (float(np.mean(ms[name])), float(np.mean(ms['default'])),
                      twin_ms)
        log(f'K1a {name} ({args[0].shape[0]} tiles x 128 voxels): kernel vs '
            f'twin maps median {a["map_median"]:.3g} p95 {a["map_p95"]:.3g} '
            f'max {a["map_max"]:.3g}; objective gap p99 '
            f'{a["obj_gap_p99"]:.3g}, worse on {a["obj_share_worse"]:.4g}'
            + ('' if tie_gap is None else
               f'; tie score median gap {tie_gap:.3g}')
            + f'; launches {launches}; {rows[name][0]:.3f} ms a launch '
            f'against the default schedule\'s {rows[name][1]:.3f} (CUDA '
            f'events, in turns: {ms}); twin {twin_ms:.3f} ms')
        check(launches == 1, f'K1a {name}: {launches} launches')
        med, p95, p99, worse = K1A_KNOBS_BOUNDS if name.startswith('knobs') \
            else (KERNEL_MAP_MEDIAN, KERNEL_MAP_P95, KERNEL_OBJ_P99,
                  KERNEL_OBJ_WORSE)
        check(a['map_median'] < med and a['map_p95'] < p95
              and a['obj_gap_p99'] < p99 and a['obj_share_worse'] < worse
              and (tie_gap is None or tie_gap < K1A_TIE_MEDIAN),
              f'K1 disagrees with its twin on the route {name}')
    return rows


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
    return launches, maps.astype(np.float64)


def log_tail(name, tails, timed):
    """Print the `converge` tail of :func:`testing.qp_tail`'s per-launch
    readings ``tails`` and the kernel's ms per launch with and without
    `converge` (``timed``: two zero-argument calls)."""
    import torch
    from amico_tpu_torch.testing import tail_histogram
    t = {k: torch.cat([x[k] for x in tails]) for k in ('rounds', 'exit',
                                                        'matvecs',
                                                        'chain_nonzeros')}
    t['cap'] = tails[0]['cap']
    h = tail_histogram(t)
    ms, ms_off = (cuda_ms(fn, 5) for fn in timed)
    mv, nz = t['matvecs'], t['chain_nonzeros']
    log(f'tile QP tail ({name}, {mv.numel()} tiles, round cap {t["cap"]}): '
        f'tiles by continuation rounds {h["rounds"]}, by exit {h["exit"]}; '
        f'longest voxel chain a tile: median {float(mv.median()):.0f} '
        f'matvecs ({float(nz.median()):.0f} nonzeros), max '
        f'{float(mv.max()):.0f} ({float(nz.max()):.0f}); kernel {ms:.3f} ms, '
        f'{ms_off:.3f} ms without `converge` per launch (tail share '
        f'{1 - ms_off / ms:.1%})')
    check(sum(h['rounds'].values()) == mv.numel(), f'tail of {name} lost tiles')


def phase_qp_edges():
    """The tile QP kernel against its twin at the kernel's lane-group edges:
    one group width's last n and the next one's first, at ragged voxel
    counts a tile, plain, masked and warm-started within the groups."""
    import torch
    from amico_tpu_torch.models.base import DEFAULT_AS_SOLVER_KW
    from amico_tpu_torch.ops.cuda_qp import nneg_qp_tiles, nneg_qp_tiles_torch
    from amico_tpu_torch.testing import qp_agreement, random_qp_problems
    warm_kw = dict(fista_iters=0, refine_rounds=3, cg_iters=(3, 5),
                   converge=True)
    worst, cases = 0.0, 0
    for n in (8, 9, 16, 17):
        for M in (1, 7, 33, 129):
            G, b = (torch.from_numpy(a).cuda() for a in random_qp_problems(
                33, n, M=M, seed=n * 1000 + M))
            rng = np.random.RandomState(n + M)
            on = lambda a: torch.from_numpy(  # noqa: E731
                a.astype(np.float32)).cuda()
            for extra, inputs, kw in (
                    ('plain', {}, DEFAULT_AS_SOLVER_KW),
                    ('mask', {'mask': on(rng.rand(*b.shape) > 0.4)},
                     DEFAULT_AS_SOLVER_KW),
                    ('warm', {'m0': on(rng.rand(*b.shape) > 0.6),
                              'x0': on(rng.rand(*b.shape) * 0.1)}, warm_kw)):
                x_k = nneg_qp_tiles(G, b, None, 0.0, 1e-3, **inputs, **kw)
                x_t = nneg_qp_tiles_torch(G, b, None, 0.0, 1e-3, **inputs,
                                          **kw)
                torch.cuda.synchronize()
                a = qp_agreement(G, b, 0.0, 1e-3, x_k, x_t)
                err = (x_k - x_t).abs() - QP_EDGE_RTOL * x_t.abs()
                check(bool(torch.isfinite(x_k).all() and (x_k >= 0).all()),
                      f'tile QP output not finite and >= 0 (n = {n}, M = {M}'
                      f', {extra})')
                check(float(err.max()) <= QP_EDGE_ATOL
                      and a['obj_gap_max'] < QP_EDGE_OBJ
                      and ('mask' not in inputs or bool(
                          (x_k[inputs['mask'] == 0] == 0).all())),
                      f'tile QP disagrees with its twin at n = {n}, M = {M} '
                      f'({extra}): {a}')
                worst = max(worst, a['x_max'])
                cases += 1
    log(f'tile QP vs twin at the lane-group edges ({cases} cases of 33 '
        f'tiles: n = 8, 9, 16, 17; 1, 7, 33, 129 voxels a tile; plain, '
        f'masked, warm-started): x max {worst:.3g}, all within atol '
        f'{QP_EDGE_ATOL} + rtol {QP_EDGE_RTOL}, objective within '
        f'{QP_EDGE_OBJ}')
    return worst


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
    from functools import partial
    from amico_tpu_torch.testing import (demo_freewater, freewater_maps,
                                         freewater_tile_inputs, qp_agreement,
                                         qp_tail, random_qp_problems,
                                         solve_work)
    step = DEFAULT_VOXELS_PER_CHUNK // DEFAULT_TILE_SIZE

    def run(fn, G, b, lam2, kw):
        return torch.cat([fn(G[i:i + step], b[i:i + step], None, 0.0, lam2,
                             **kw) for i in range(0, G.shape[0], step)])

    def run_twin(G, b, lam2, kw):
        # the twin in the main path's launches, read by qp_tail as it runs
        out = [qp_tail(G[i:i + step], b[i:i + step], None, 0.0, lam2, **kw)
               for i in range(0, G.shape[0], step)]
        return torch.cat([x for x, _ in out]), [t for _, t in out]

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
        x_t, tails = run_twin(G, b, lam2, kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(x_k).all() and (x_k >= 0).all()),
              f'tile QP kernel output not finite and >= 0 ({name})')
        a = qp_agreement(G, b, 0.0, lam2, x_k, x_t, maps=None if n_perp is None
                         else partial(freewater_maps, n_perp=n_perp))
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
        kw_off = dict(kw, converge=False)
        log_tail(name, tails, (
            lambda: nneg_qp_tiles(*first, None, 0.0, lam2, **kw),
            lambda: nneg_qp_tiles(*first, None, 0.0, lam2, **kw_off)))
        if name == 'Human':
            _, work = solve_work(nneg_qp_tiles_torch, *first, None, 0.0,
                                 lam2, **kw)
            n_b = 2 * nbytes(first[1]) + nbytes(first[0])
            bd = bound(n_b, work['flops'])
            times = (ms, plain_ms) + bd
            per_voxel = work['matvecs'] * b.shape[-1] / first[1].numel()
            log(f'tile QP (Human) least work {n_b} bytes, '
                f'{work["flops"]:.4g} FLOP ({per_voxel:.1f} matvecs a '
                f'voxel): bound {bd[0]:.4f} ms ({bd[1]}), '
                f'{bd[0] / ms:.2%} of it reached')
        del G, b, x_k, x_t
    return max(worst, phase_qp_edges()), times


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


def phase_loc_probe():
    """T1's path, the build-cache probe, then T1 against its twin; returns
    the launch count of the probe's run, the largest |kernel - twin| and,
    at (8, 128), the kernel's, twin's and torch.add's ms per call and the
    bound."""
    import torch
    from amico_tpu_torch.ops.loc_probe import loc_probe, loc_probe_torch
    from amico_tpu_torch.tools import loc_experiment
    from amico_tpu_torch.ops.cuda_qp import nneg_qp_tiles, noddi_fused_tiles
    loc_probe.launches = nneg_qp_tiles.launches = 0
    noddi_fused_tiles.launches = 0
    t0 = time.time()
    rows = loc_experiment.probe()
    launches = loc_probe.launches
    for row in rows:
        log('loc probe: ' + loc_experiment.line(row))
    log(f'loc probe: {time.time() - t0:.2f} s; T1 launches {launches}')
    check(launches > 0, 'the probe never launched T1')
    check(all(r['stable'] for r in rows), 'the build key drifts')
    check(rows[-1]['reused'], 'the second process built the kernels anew')
    gen = torch.Generator(device='cuda').manual_seed(0)
    worst, times = 0.0, {}
    for shape in ((8, 128), (T1_ODD,)):
        x = torch.randn(shape, device='cuda', generator=gen) * 1e3
        o, t = loc_probe(x), loc_probe_torch(x)
        torch.cuda.synchronize()
        check(torch.equal(o, t), f'T1 differs from its twin at {shape}')
        worst = max(worst, float((o - t).abs().max()))
        fns = {'T1': lambda: loc_probe(x),
               'library': lambda: torch.add(1, x, alpha=2),
               'twin': lambda: loc_probe_torch(x)}
        check(torch.equal(fns['library'](), t), 'torch.add differs')
        runs = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:        # in turns
            runs[k].append(cuda_ms(fns[k], 200))
        ms = {k: float(np.median(v)) for k, v in runs.items()}
        b = bound(8 * x.numel(), 2 * x.numel())
        times[shape] = (ms['T1'], ms['twin'], ms['library']) + b
        log(f'T1 vs twin {shape}: bit-equal; kernel {ms["T1"]:.4f} ms, '
            f'torch.add(1, x, alpha=2) {ms["library"]:.4f} ms, twin '
            f'{ms["twin"]:.4f} ms per call (CUDA events, in turns: '
            f'{ {k: [round(t, 4) for t in v] for k, v in runs.items()} }); '
            f'bound {b[0]:.3g} ms ({b[1]})')
    return launches, worst, times[(8, 128)]


def map_err(a, b):
    e = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(np.median(e)), float(np.percentile(e, 95)), float(e.max())


def phase_czb_main_path(study, lut_true, aniso):
    """CylinderZeppelinBall with backend='auto' (the stagewise solver);
    returns the Evaluation and its masked maps."""
    import amico_tpu_torch
    from amico_tpu_torch.ops.cuda_qp import nneg_qp_tiles, noddi_fused_tiles
    from amico_tpu_torch.ops.loc_probe import loc_probe
    from amico_tpu_torch.testing import czb_oracle_audit, direction_agreement
    nneg_qp_tiles.launches = noddi_fused_tiles.launches = 0
    loc_probe.launches = 0
    t0 = time.time()
    ev = amico_tpu_torch.Evaluation(study, 'subj', device='cuda')
    ev.load_data(dwi_filename='DWI.nii', scheme_filename='DWI.scheme')
    check(ev.scheme.version == 1, 'the scheme was not read as VERSION: 1')
    ev.set_model('CylinderZeppelinBall')
    check(ev.model._solver_backend() == 'xla',
          "backend 'auto' did not resolve to the stagewise solver")
    ev.generate_kernels(ndirs=500)
    ev.load_kernels()
    t_fit = time.time()
    ev.fit()
    fit_s = time.time() - t_fit
    ev.save_results()
    log(f'CZB main path (auto = stagewise): {time.time() - t0:.2f} s end to '
        f'end, first fit {fit_s:.3f} s; launches: tile QP '
        f'{nneg_qp_tiles.launches}, fused NODDI {noddi_fused_tiles.launches}')
    n_vox = int(np.count_nonzero(ev.niiMASK_img == 1))
    log('stage times (s): ' + json.dumps(
        {k: round(v, 4) for k, v in ev.timers.times.items()}))
    log('fit breakdown (s): ' + json.dumps(
        {k: round(v, 4) for k, v in ev._last_fit_facade_timers.items()})
        + ' engine: ' + json.dumps(
        {k: round(v, 4) for k, v in ev.model._last_fit_timers.items()}))
    log(f'CZB first fit: {n_vox} voxels in {fit_s:.3f} s = '
        f'{n_vox / fit_s:.0f} voxels/s')
    maps = ev.RESULTS['MAPs'][ev.niiMASK_img == 1].copy()
    check(maps.shape == (n_vox, 3), f'maps shape {maps.shape}')
    check(bool(np.isfinite(maps).all()), 'maps not finite')
    v, a, d = maps.T
    check(bool((v >= 0).all() and (v <= 1).all()),
          f'v outside [0, 1]: {v.min()} .. {v.max()}')
    check(bool((a >= 0).all() and (a < 20).all()),
          f'a outside [0, 20) um: {a.min()} .. {a.max()}')
    check(bool((d >= 0).all()), f'd below 0: {d.min()}')
    log(f'CZB maps: v {v.min():.4g} .. {v.max():.4g}, a {a.min():.4g} .. '
        f'{a.max():.4g} um, d {d.min():.4g} .. {d.max():.4g}')
    for name in ('v', 'a', 'd', 'dir'):
        check(os.path.isfile(os.path.join(
            study, 'subj', 'AMICO', 'CylinderZeppelinBall',
            f'fit_{name}.nii.gz')), f'fit_{name}.nii.gz not written')
    agree_all = direction_agreement(ev, lut_true)
    agree = direction_agreement(ev, lut_true, aniso)
    log(f'DTI directions (card): LUT direction of the true one on '
        f'{agree_all:.6f} of all voxels, {agree:.6f} of the {int(aniso.sum())}'
        ' voxels mostly on cylinders and prolate zeppelins')
    check(agree >= CZB_DIRS_AGREE, 'the DTI directions disagree with the truth')
    t_fit = time.time()
    ev.fit()
    warm_s = time.time() - t_fit
    log(f'CZB second fit: {warm_s:.3f} s = {n_vox / warm_s:.0f} voxels/s; '
        'engine: ' + json.dumps(
            {k: round(v, 4) for k, v in ev.model._last_fit_timers.items()}))
    t_a = time.time()
    err = czb_oracle_audit(ev, n=1000, seed=0)
    stats = {k: map_err(err[:, i], 0.0) for i, k in enumerate('va')}
    log(f'CZB oracle audit (1000 voxels, {time.time() - t_a:.1f} s): '
        + ', '.join(f'{k} median {m:.3g} p95 {p:.3g} max {x:.3g}'
                    for k, (m, p, x) in stats.items()))
    for k, got in stats.items():
        check(all(g < b for g, b in zip(got, CZB_AUDIT[k])),
              f'CZB oracle audit of {k} outside its bounds')
    return ev, maps


def phase_czb_pallas(ev, maps_auto):
    """The same subject with backend='pallas' (K2), held against the
    stagewise run; then K2, its twin and the stagewise solver on 512 CZB
    tiles.  Returns K2's launch count, the fit times and the tiles'
    agreement and times."""
    import torch
    from amico_tpu_torch.models.base import (DEFAULT_TILE_SIZE,
                                             DEFAULT_VOXELS_PER_CHUNK,
                                             DENSE_AS_SOLVER_KW)
    from amico_tpu_torch.models.cylinder_zeppelin_ball import czb_estimates
    from amico_tpu_torch.ops.cuda_qp import (nneg_qp_tiles,
                                             nneg_qp_tiles_torch,
                                             noddi_fused_tiles)
    from amico_tpu_torch.ops.loc_probe import loc_probe
    from amico_tpu_torch.ops.solvers import nneg_qp_batch
    from amico_tpu_torch.testing import czb_tile_inputs, qp_agreement, qp_tail
    n_vox = maps_auto.shape[0]
    nneg_qp_tiles.launches = noddi_fused_tiles.launches = 0
    loc_probe.launches = 0
    ev.set_solver(backend='pallas')
    check(ev.model._solver_backend() == 'pallas', 'backend is not pallas')
    t0 = time.time()
    ev.fit()
    fit_s = time.time() - t0
    launches = nneg_qp_tiles.launches
    log(f'CZB pallas first fit: {fit_s:.3f} s = {n_vox / fit_s:.0f} '
        f'voxels/s; tile QP launches {launches}; engine: ' + json.dumps(
            {k: round(v, 4) for k, v in ev.model._last_fit_timers.items()}))
    check(launches > 0, 'the CZB pallas fit never launched the tile QP')
    maps = ev.RESULTS['MAPs'][ev.niiMASK_img == 1]
    check(bool(np.isfinite(maps).all()), 'pallas maps not finite')
    for i, k in enumerate('va'):
        got = map_err(maps[:, i], maps_auto[:, i])
        log(f'CZB pallas vs stagewise, {k}: median {got[0]:.3g} p95 '
            f'{got[1]:.3g} max {got[2]:.3g}')
        check(all(g < b for g, b in zip(got, CZB_BACKENDS[k])),
              f'CZB pallas maps disagree with the stagewise run ({k})')
    t0 = time.time()
    ev.fit()
    warm_s = time.time() - t0
    log(f'CZB pallas second fit: {warm_s:.3f} s = {n_vox / warm_s:.0f} '
        'voxels/s; engine: ' + json.dumps(
            {k: round(v, 4) for k, v in ev.model._last_fit_timers.items()}))

    step = DEFAULT_VOXELS_PER_CHUNK // DEFAULT_TILE_SIZE
    G, b, L = czb_tile_inputs(ev.model, ev.KERNELS, ev.htable, 'cuda', step,
                              seed=1)
    kw = DENSE_AS_SOLVER_KW
    Rs = torch.as_tensor(ev.model.Rs, dtype=torch.float32, device='cuda')

    def czb_maps(x):
        return czb_estimates(x, Rs, len(ev.model.d_perps))[..., :2]

    def stagewise():
        return nneg_qp_batch(G[:, None], b, 0.0, 4.0, L=L[:, None], **kw)

    x_k = nneg_qp_tiles(G, b, None, 0.0, 4.0, **kw)
    x_t, tail = qp_tail(G, b, None, 0.0, 4.0, **kw)
    x_s = stagewise()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(x_k).all() and (x_k >= 0).all()),
          'tile QP output not finite and >= 0 (CZB)')
    for name, x_ref in (('stagewise', x_s), ('twin', x_t)):
        a = qp_agreement(G, b, 0.0, 4.0, x_k, x_ref, maps=czb_maps)
        log(f'K2 vs {name} (CZB, {G.shape[0]} tiles x {b.shape[1]} voxels, '
            f'n = {b.shape[2]}): v median {a["map_medians"][0]:.3g} p95 '
            f'{a["map_p95s"][0]:.3g} max {a["map_maxs"][0]:.3g}; a median '
            f'{a["map_medians"][1]:.3g} p95 {a["map_p95s"][1]:.3g} max '
            f'{a["map_maxs"][1]:.3g}; x max {a["x_max"]:.3g}; objective gap '
            f'p99 {a["obj_gap_p99"]:.3g} max {a["obj_gap_max"]:.3g}, K2 worse '
            f'> 1e-3 on {a["obj_share_worse"]:.4g} (better on '
            f'{a["obj_share_better"]:.4g}) of voxels')
        for i, k in enumerate('va'):
            got = (a['map_medians'][i], a['map_p95s'][i], a['map_maxs'][i])
            check(all(g < bd for g, bd in zip(got, CZB_BACKENDS[k])),
                  f'K2 disagrees with the {name} on CZB tiles ({k})')
        check(a['obj_gap_p99'] < CZB_OBJ_P99
              and a['obj_share_worse'] < CZB_OBJ_WORSE,
              f'K2 objective disagrees with the {name} on CZB tiles')
    times = {'k2': cuda_ms(lambda: nneg_qp_tiles(G, b, None, 0.0, 4.0, **kw),
                           5),
             'twin': cuda_ms(lambda: nneg_qp_tiles_torch(G, b, None, 0.0, 4.0,
                                                         **kw), 2),
             'stagewise': cuda_ms(stagewise, 2)}
    log(f'CZB tiles ({step} x 128 voxels, n = 26): K2 {times["k2"]:.3f} ms, '
        f'twin {times["twin"]:.3f} ms, stagewise {times["stagewise"]:.3f} ms '
        'per call (CUDA events)')
    kw_off = dict(kw, converge=False)
    log_tail('CZB', [tail], (
        lambda: nneg_qp_tiles(G, b, None, 0.0, 4.0, **kw),
        lambda: nneg_qp_tiles(G, b, None, 0.0, 4.0, **kw_off)))


def phase_sandi(study):
    """SANDI through Evaluation(device='cuda') with doDirectionalAverage:
    first and second fit, launches per chunk (torch.profiler over one
    chunk's fit), the written files and the oracle audit."""
    import torch
    import amico_tpu_torch
    from amico_tpu_torch.ops.cuda_qp import nneg_qp_tiles, noddi_fused_tiles
    from amico_tpu_torch.ops.loc_probe import loc_probe
    from amico_tpu_torch.testing import sandi_oracle_audit
    nneg_qp_tiles.launches = noddi_fused_tiles.launches = 0
    loc_probe.launches = 0
    t0 = time.time()
    ev = amico_tpu_torch.Evaluation(study, 'subj', device='cuda')
    ev.set_config('doDirectionalAverage', True)
    ev.load_data(dwi_filename='DWI.nii', scheme_filename='DWI.scheme')
    check(ev.scheme.nS == 3, f'directional average gave {ev.scheme.nS} rows')
    ev.set_model('SANDI')
    ev.generate_kernels(ndirs=500)
    ev.load_kernels()
    n_vox = int(np.count_nonzero(ev.niiMASK_img == 1))
    fits = []
    for fit in ('first', 'second'):
        t_fit = time.time()
        ev.fit()
        fits.append(time.time() - t_fit)
        log(f'SANDI {fit} fit: {n_vox} voxels in {fits[-1]:.3f} s = '
            f'{n_vox / fits[-1]:.0f} voxels/s; fit breakdown (s): '
            + json.dumps({k: round(v, 4)
                          for k, v in ev._last_fit_facade_timers.items()})
            + ' engine: ' + json.dumps(
                {k: round(v, 4) if isinstance(v, float) else v
                 for k, v in ev.model._last_fit_timers.items()}))
    ev.save_results(save_dir_avg=True)
    log(f'SANDI main path: {time.time() - t0:.2f} s end to end')
    # one chunk's fit under the profiler (which slows the host tenfold)
    from types import SimpleNamespace
    chunk = ev.model._stage_cache[0][1]
    one = SimpleNamespace(y=ev.y[:chunk], KERNELS=ev.KERNELS,
                          get_config={'device': 'cuda',
                                      'voxels_per_chunk': chunk}.get)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        ev.model.fit(one)
    n_chunks = ev.model._last_fit_timers['n_chunks']
    check(n_chunks == 1, f'the profiled fit ran {n_chunks} chunks')
    events = prof.key_averages()
    kernels = sum(e.count for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith(('Memcpy', 'Memset')))
    launch_calls = sum(e.count for e in events
                       if e.key in ('cudaLaunchKernel', 'cuLaunchKernel',
                                    'cudaLaunchKernelExC'))
    log(f'SANDI launches: {kernels} CUDA kernels on the card '
        f'({launch_calls} launch calls on the host) in one chunk of '
        f'{chunk} voxels; '
        f'K1 {noddi_fused_tiles.launches}, K2 {nneg_qp_tiles.launches}, T1 '
        f'{loc_probe.launches} (none is on this path)')
    check(kernels > 0 or launch_calls > 0, 'the SANDI fit ran nothing on '
          'the card')
    maps = ev.RESULTS['MAPs'][ev.niiMASK_img == 1]
    check(maps.shape == (n_vox, 6), f'SANDI maps shape {maps.shape}')
    check(bool(np.isfinite(maps).all()), 'SANDI maps not finite')
    check(bool((maps[:, :3] >= 0).all() and (maps[:, :3] <= 1 + 1e-6).all()),
          'SANDI fractions outside [0, 1]')
    out = os.path.join(study, 'subj', 'AMICO', 'SANDI')
    for name in ('fit_fsoma.nii.gz', 'fit_fneurite.nii.gz',
                 'fit_fextra.nii.gz', 'fit_Rsoma.nii.gz', 'fit_Din.nii.gz',
                 'fit_De.nii.gz', 'dir_avg_signal.nii.gz', 'dir_avg.scheme'):
        check(os.path.isfile(os.path.join(out, name)), f'{name} not written')
    t_a = time.time()
    err = sandi_oracle_audit(ev, n=1000, seed=0)
    for cols, key in ((slice(0, 3), 'fractions'), (slice(3, 4), 'Rsoma')):
        got = map_err(err[:, cols], 0.0)
        log(f'SANDI oracle audit (1000 voxels, {time.time() - t_a:.1f} s), '
            f'{key}: median {got[0]:.3g} p95 {got[1]:.3g} max {got[2]:.3g}')
        check(all(g < b for g, b in zip(got, SANDI_AUDIT[key])),
              f'SANDI oracle audit of {key} outside its bounds')


def phase_noddi_xla(study, maps_fused):
    """NODDI with backend='xla' on phase 4's subject, against the fused
    path's maps and the exact oracle."""
    import amico_tpu_torch
    from amico_tpu_torch.ops.cuda_qp import nneg_qp_tiles, noddi_fused_tiles
    from amico_tpu_torch.ops.loc_probe import loc_probe
    from amico_tpu_torch.testing import noddi_oracle_audit
    nneg_qp_tiles.launches = noddi_fused_tiles.launches = 0
    loc_probe.launches = 0
    ev = amico_tpu_torch.Evaluation(study, 'subj', device='cuda')
    ev.load_data(dwi_filename='DWI.nii', scheme_filename='DWI.scheme')
    ev.set_model('NODDI')
    ev.set_solver(backend='xla')
    ev.generate_kernels(ndirs=500)
    ev.load_kernels()
    n_vox = int(np.count_nonzero(ev.niiMASK_img == 1))
    for fit in ('first', 'second'):
        t0 = time.time()
        ev.fit()
        fit_s = time.time() - t0
        log(f'NODDI xla {fit} fit: {fit_s:.3f} s = {n_vox / fit_s:.0f} '
            'voxels/s; fit breakdown (s): ' + json.dumps(
                {k: round(v, 4)
                 for k, v in ev._last_fit_facade_timers.items()})
            + ' engine: ' + json.dumps(
                {k: round(v, 4)
                 for k, v in ev.model._last_fit_timers.items()}))
    log(f'NODDI xla launches: fused NODDI {noddi_fused_tiles.launches}, tile '
        f'QP {nneg_qp_tiles.launches}')
    check(noddi_fused_tiles.launches == 0, 'the xla path ran the fused kernel')
    maps = ev.RESULTS['MAPs'][ev.niiMASK_img == 1]
    check(maps.shape == maps_fused.shape and bool(np.isfinite(maps).all()),
          'NODDI xla maps malformed')
    check(bool((maps >= 0).all() and (maps <= 1).all()),
          'NODDI xla maps outside [0, 1]')
    e = np.abs(maps.astype(np.float64) - maps_fused)
    med, p95, mx = float(np.median(e)), float(np.percentile(e, 95)), \
        float(e.max())
    off = float(np.mean(e.max(-1) > 5e-3))
    log(f'NODDI xla vs fused ({n_vox} voxels): median {med:.3g} p95 '
        f'{p95:.3g} max {mx:.3g}; voxels off > 5e-3 {off:.4g}')
    check(med < NODDI_XLA_MEDIAN and p95 < NODDI_XLA_P95
          and off < NODDI_XLA_SHARE_OFF,
          'NODDI xla disagrees with the fused path')
    t_a = time.time()
    err = noddi_oracle_audit(ev, n=1000, seed=0)
    med, p95, mx = np.median(err), np.percentile(err, 95), err.max()
    log(f'NODDI xla oracle audit (1000 voxels, {time.time() - t_a:.1f} s): '
        f'median {med:.3g} p95 {p95:.3g} max {mx:.3g}')
    check(med < AUDIT_MEDIAN and p95 < AUDIT_P95 and mx < AUDIT_MAX,
          'NODDI xla oracle audit outside its bounds')


NODDI_MAPS = ('fit_NDI', 'fit_ODI', 'fit_FWF', 'fit_dir')


def load_maps(out_dir, names=NODDI_MAPS):
    from amico_tpu_torch.io import nifti
    return {n: nifti.load(os.path.join(out_dir, n + '.nii.gz'))
            .get_fdata(np.float32) for n in names}


def maps_equal_or_within_k1(got, ref, what):
    """Bit for bit, or else (logged with the reason) within K1's agreement
    bounds on every map."""
    if all(np.array_equal(got[k], ref[k]) for k in ref):
        log(f'{what}: maps equal bit for bit')
        return
    for k in ref:
        e = np.abs(got[k].astype(np.float64) - ref[k])
        log(f'{what}: {k} differs, median {np.median(e):.3g} p95 '
            f'{np.percentile(e, 95):.3g} max {e.max():.3g}')
        check(np.median(e) < KERNEL_MAP_MEDIAN
              and np.percentile(e, 95) < KERNEL_MAP_P95,
              f'{what}: {k} outside K1\'s agreement bounds')
    log(f'{what}: maps not bit-equal (the same inputs through another '
        'process); within K1\'s agreement bounds')


def run_processes(cmds, logs, timeout):
    """Run ``cmds`` side by side, each writing to its log file; fail with
    the log's tail if one exits non-zero or outlasts ``timeout`` seconds.
    Every process is ended before this returns."""
    procs = []
    try:
        for cmd, path in zip(cmds, logs):
            with open(path, 'w') as f:
                procs.append(subprocess.Popen(
                    cmd, stdout=f, stderr=subprocess.STDOUT,
                    cwd=os.path.dirname(os.path.abspath(__file__))))
        deadline = time.time() + timeout
        rcs = [p.wait(timeout=max(1.0, deadline - time.time()))
               for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    tails = []
    for rc, path, cmd in zip(rcs, logs, cmds):
        with open(path) as f:
            tail = f.read().strip().splitlines()[-12:]
        check(rc == 0, f'{" ".join(cmd[1:4])} exited {rc}: '
              + '\n'.join(tail))
        tails.append(tail)
    return tails


def phase_study_cli(study, tmp):
    """13a/13h: ``python -m amico_tpu_torch fit`` on phase 4's subject into
    another output path (its maps against phase 4's) and ``warmup
    --study`` on the same subject, two processes side by side."""
    base = [sys.executable, '-m', 'amico_tpu_torch']
    out = os.path.join(tmp, 'cli_out')
    t0 = time.time()
    fit_tail, wu_tail = run_processes(
        [base + ['fit', study, 'subj', '--model', 'NODDI', '--verbose', '1',
                 '--output-path', out],
         base + ['warmup', '--study', study, '--subject', 'subj',
                 '--model', 'NODDI', '-v', '1']],
        [os.path.join(tmp, 'cli_fit.log'), os.path.join(tmp, 'warmup.log')],
        timeout=300)
    log(f'13a/h: CLI fit and warmup --study, two processes: '
        f'{time.time() - t0:.2f} s; warmup said: {wu_tail[-1]}')
    check(wu_tail[-1].startswith('warmup: ran the NODDI fit'),
          'warmup printed no result line')
    maps_equal_or_within_k1(
        load_maps(out),
        load_maps(os.path.join(study, 'subj', 'AMICO', 'NODDI')),
        '13a: CLI fit against phase 4')


def phase_sweep(study, tmp):
    """13b: ``cli.main(['sweep', ...])`` in this process over phase 4's
    subject and the seed-8 one; then again, which must skip both."""
    from amico_tpu_torch import cli
    from amico_tpu_torch import sweep as sweep_mod
    from amico_tpu_torch.ops.cuda_qp import noddi_fused_tiles
    out = os.path.join(tmp, 'sweep_out')
    argv = ['sweep', study, '--subjects', 'subj', 'subj8', '--model',
            'NODDI', '--verbose', '1', '--config', f'OUTPUT_path={out}']
    made = []
    run = sweep_mod.SubjectSweep.run

    def recording(self, *a, **kw):
        made.append(self)
        return run(self, *a, **kw)
    sweep_mod.SubjectSweep.run = recording
    try:
        noddi_fused_tiles.launches = 0
        t0 = time.time()
        rc = cli.main(argv)
        sweep_s = time.time() - t0
        launches = noddi_fused_tiles.launches
        cfgs = [os.path.join(out, s, 'config.pickle') for s in ('subj',
                                                                 'subj8')]
        check(rc == 0 and all(map(os.path.isfile, cfgs)),
              f'the sweep failed (rc {rc}): {made[0].results}')
        mtimes = [os.path.getmtime(c) for c in cfgs]
        noddi_fused_tiles.launches = 0
        t0 = time.time()
        rc2 = cli.main(argv)
        again_s = time.time() - t0
    finally:
        sweep_mod.SubjectSweep.run = run
    first = made[0]
    log(f'13b: sweep of 2 subjects {sweep_s:.2f} s; per subject (s) '
        + json.dumps({k: round(v, 3) for k, v in first.seconds.items()})
        + f'; K1 launches {launches}; warm state reused for '
        f'{first.warm_reused}; rerun {again_s:.2f} s, K1 launches '
        f'{noddi_fused_tiles.launches}, fitted {list(made[1].seconds)}')
    check(launches > 0, 'the sweep never launched K1')
    check(first.warm_reused == ['subj8'],
          'the second subject did not reuse the warm state')
    check(rc2 == 0 and not made[1].seconds
          and noddi_fused_tiles.launches == 0
          and [os.path.getmtime(c) for c in cfgs] == mtimes,
          'the rerun did not skip both subjects')
    check(not any(os.path.exists(os.path.join(
        study, s, '.amico_tpu_ckpt_NODDI.npz')) for s in ('subj', 'subj8')),
        'a sweep checkpoint was left behind')
    maps_equal_or_within_k1(
        load_maps(os.path.join(out, 'subj')),
        load_maps(os.path.join(study, 'subj', 'AMICO', 'NODDI')),
        '13b: sweep against phase 4')
    return load_maps(os.path.join(out, 'subj8'))


def phase_crash_resume(study, tmp, sweep_maps):
    """13c: the seed-8 subject's fit with checkpoint_every=1, raised from
    its third chunk by a wrapper of the chunk function; the rerun resumes
    from done_until."""
    import amico_tpu_torch
    ck = os.path.join(tmp, 'subj8_ckpt.npz')
    ev = amico_tpu_torch.Evaluation(study, 'subj8', device='cuda')
    ev.load_data(dwi_filename='DWI.nii', scheme_filename='DWI.scheme')
    ev.set_model('NODDI')
    ev.generate_kernels(ndirs=500)
    ev.load_kernels()
    ev.fit()
    full = ev.RESULTS['MAPs'].copy()
    n_chunks = ev.model._last_fit_timers['n_chunks']
    ev.set_config('fit_checkpoint', ck)
    ev.set_config('checkpoint_every', 1)
    run = ev.model._run_tiled_fit

    def crashing(evaluation, fit_chunk_fn, *args):
        calls = []

        def chunk(*a):
            calls.append(1)
            if len(calls) > 2:
                raise RuntimeError('13c: injected crash')
            return fit_chunk_fn(*a)
        return run(evaluation, chunk, *args)
    ev.model._run_tiled_fit = crashing
    crashed = None
    try:
        ev.fit()
    except RuntimeError as e:
        crashed = str(e)
    finally:
        del ev.model._run_tiled_fit
    check(crashed == '13c: injected crash', f'the fit did not crash: {crashed}')
    with np.load(ck) as f:
        done_until = int(f['done_until'])
    t0 = time.time()
    ev.fit()
    resume_s = time.time() - t0
    resumed = ev.model._last_fit_timers['n_chunks']
    log(f'13c: crashed after 2 of {n_chunks} chunks, checkpoint at '
        f'done_until {done_until} tiles; the rerun ran {resumed} chunks in '
        f'{resume_s:.3f} s')
    from amico_tpu_torch.models.base import DEFAULT_VOXELS_PER_CHUNK
    check(done_until == 2 * (DEFAULT_VOXELS_PER_CHUNK // 128)
          and resumed == n_chunks - 2,
          'the rerun did not resume from done_until')
    check(not os.path.exists(ck), 'the checkpoint was not deleted')
    check(np.array_equal(ev.RESULTS['MAPs'], full),
          'the resumed maps differ from the uninterrupted fit')
    log('13c: resumed maps equal the uninterrupted fit bit for bit')
    maps_equal_or_within_k1(
        {'fit_NDI': full[..., 0].astype(np.float32)},
        {'fit_NDI': sweep_maps['fit_NDI']}, '13c: seed-8 fit against the sweep')


def fit_pair(ev, budget, what):
    """A staged fit and one streamed under ``budget`` bytes: (maps of
    each); prints both fits' times and peak device memory (whole fit, and
    the tile driver alone)."""
    import torch
    out = []
    for b in (None, budget):
        ev.set_config('max_device_bytes', b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        ev.fit()
        fit_s = time.time() - t0
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ev.model.fit(ev)
        torch.cuda.synchronize()
        driver_peak = torch.cuda.max_memory_allocated()
        t = ev.model._last_fit_timers
        log(f'13d: {what} {"streamed" if b else "staged"} fit {fit_s:.3f} s '
            f'(engine ' + json.dumps({k: round(v, 4) for k, v in t.items()})
            + f'); max_memory_allocated {peak / 2**20:.1f} MiB, tile driver '
            f'alone {driver_peak / 2**20:.1f} MiB')
        check(t['streamed'] == int(b is not None),
              f'{what}: the staging mode did not follow the budget')
        out.append(ev.RESULTS['MAPs'].copy())
    ev.set_config('max_device_bytes', None)
    return out


def phase_streaming(study, fw_study, noddi_maps):
    """13d: NODDI on phase 4's subject and FreeWater on phase 6's, each
    staged and streamed beyond a 64 MiB budget: equal maps."""
    import amico_tpu_torch
    from amico_tpu_torch.ops.cuda_qp import nneg_qp_tiles, noddi_fused_tiles
    ev = amico_tpu_torch.Evaluation(study, 'subj', device='cuda')
    ev.load_data(dwi_filename='DWI.nii', scheme_filename='DWI.scheme')
    ev.set_model('NODDI')
    ev.generate_kernels(ndirs=500)
    ev.load_kernels()
    noddi_fused_tiles.launches = 0
    staged, streamed = fit_pair(ev, STREAM_BUDGET, 'NODDI')
    mask = ev.niiMASK_img == 1
    check(noddi_fused_tiles.launches > 0, 'the streamed NODDI fit ran no K1')
    check(np.array_equal(staged, streamed)
          and np.array_equal(streamed[mask], noddi_maps.astype(np.float32)),
          'the streamed NODDI maps differ from the staged ones')
    fw = amico_tpu_torch.Evaluation(fw_study, 'subj', device='cuda')
    fw.load_data(dwi_filename='DWI.nii', scheme_filename='DWI.scheme')
    fw.set_model('FreeWater')
    fw.generate_kernels(ndirs=500)
    fw.load_kernels()
    nneg_qp_tiles.launches = 0
    staged, streamed = fit_pair(fw, STREAM_BUDGET, 'FreeWater')
    check(nneg_qp_tiles.launches > 0, 'the streamed FreeWater fit ran no K2')
    check(np.array_equal(staged, streamed),
          'the streamed FreeWater maps differ from the staged ones')
    log(f'13d: streamed maps equal the staged ones bit for bit (NODDI, '
        f'FreeWater; budget {STREAM_BUDGET} bytes, signal '
        f'{ev.y.size * 4} bytes)')
    ev.fit()            # staged again, for 13e and 13g
    return ev


def angles(d, ref):
    dots = np.abs(np.sum(np.asarray(d, np.float64)
                         * np.asarray(ref, np.float64), axis=1))
    return np.degrees(np.arccos(np.clip(dots, 0.0, 1.0)))


def phase_dti_methods(ev, lut_true):
    """13e: WLS, NLLS and RESTORE on phase 4's staged signal against the
    true directions, and the card against the port's CPU run on 4,096
    sampled voxels."""
    import torch
    from amico_tpu_torch import lut as _lut
    from amico_tpu_torch.pipeline import principal_directions
    y_dev = ev._staged_y_ext_dev[1][:-1]
    sel = np.random.RandomState(0).choice(y_dev.shape[0],
                                          min(4096, y_dev.shape[0]),
                                          replace=False)
    times = {}
    for method in ('OLS', 'WLS', 'NLLS', 'RESTORE'):
        torch.cuda.synchronize()
        t0 = time.time()
        dirs = principal_directions(y_dev, ev.scheme, method, False)
        times[method] = time.time() - t0
        agree = float(np.mean(_lut.dir_to_lut_idx(
            dirs.astype(np.float64), ev.htable) == lut_true))
        cpu = principal_directions(ev.y[sel], ev.scheme, method, False,
                                   device='cpu')
        ang = angles(dirs[sel], cpu)
        log(f'13e: DTI {method}: {times[method]:.3f} s on '
            f'{y_dev.shape[0]} voxels; LUT direction of the true one on '
            f'{agree:.6f}; card against CPU on 4096 voxels: angle median '
            f'{np.median(ang):.3g} p99 {np.percentile(ang, 99):.3g} max '
            f'{ang.max():.3g} deg')
        check(agree >= DIRS_AGREE, f'DTI {method} disagrees with the truth')
        check(np.median(ang) < DTI_CPU_MEDIAN
              and np.percentile(ang, 99) < DTI_CPU_P99,
              f'DTI {method}: the card disagrees with the CPU')
    return times


def phase_profiler(ev, tmp):
    """13g: one NODDI fit with profile_dir: the trace holds K1's kernel
    and the 'fit' range."""
    import glob
    prof = os.path.join(tmp, 'prof')
    ev.set_config('profile_dir', prof)
    t0 = time.time()
    ev.fit()
    ev.set_config('profile_dir', None)
    traces = glob.glob(os.path.join(prof, '*.pt.trace.json'))
    check(len(traces) == 1, f'profile_dir holds {traces}')
    with open(traces[0]) as f:
        text = f.read()
    log(f'13g: profiled fit {time.time() - t0:.3f} s; trace '
        f'{os.path.basename(traces[0])}, {len(text)} bytes')
    check('noddi_fused_kernel' in text and '"name": "fit"' in text,
          'the trace lacks K1 or the fit range')


def phase_debias(study, lut_true):
    """13f: phase 4's volume with Rician noise at SNR 20, debiased on the
    card (against the CPU on 4,096 voxels), then load_data with
    doDebiasSignal and a NODDI fit."""
    import torch
    import amico_tpu_torch
    from amico_tpu_torch.io import nifti
    from amico_tpu_torch.preproc import debias_rician_batch, debiasRician
    from amico_tpu_torch.testing import direction_agreement
    t0 = time.time()
    src = os.path.join(study, 'subj')
    img = nifti.load(os.path.join(src, 'DWI.nii'))
    vol = img.get_fdata(np.float32)
    scheme = amico_tpu_torch.Scheme(os.path.join(src, 'DWI.scheme'))
    b0 = vol[..., scheme.b0_idx].mean(-1, keepdims=True)
    rng = np.random.default_rng(20)
    sigma = b0 / SNR
    noisy = np.hypot(vol + sigma * rng.standard_normal(vol.shape, np.float32),
                     sigma * rng.standard_normal(vol.shape, np.float32))
    dst = os.path.join(study, 'subj_rician')
    os.makedirs(dst, exist_ok=True)
    nifti.save(nifti.Nifti1Image(noisy.astype(np.float32), img.affine),
               os.path.join(dst, 'DWI.nii'))
    with open(os.path.join(src, 'DWI.scheme')) as f, \
            open(os.path.join(dst, 'DWI.scheme'), 'w') as g:
        g.write(f.read())
    log(f'13f: Rician subject (SNR {SNR}) written: {time.time() - t0:.1f} s')
    mask = np.ones(vol.shape[:3], np.uint8)
    for rep in ('first', 'second'):
        t0 = time.time()
        deb = debiasRician(noisy, SNR, mask, scheme, device='cuda')
        debias_s = time.time() - t0
        log(f'13f: debiasRician on the card ({rep}): {debias_s:.3f} s')
    vox = noisy.reshape(-1, scheme.nS)
    sig = vox[:, scheme.b0_idx].mean(1, keepdims=True) / SNR
    S_dev = torch.from_numpy(vox).cuda()
    s_dev = torch.from_numpy(sig).cuda()
    batch_ms = cuda_ms(lambda: debias_rician_batch(S_dev, s_dev), 3)
    del S_dev, s_dev
    sel = np.random.RandomState(1).choice(vox.shape[0],
                                          min(4096, vox.shape[0]),
                                          replace=False)
    cpu = debias_rician_batch(torch.from_numpy(vox[sel]),
                              torch.from_numpy(sig[sel])).numpy()
    card = deb.reshape(-1, scheme.nS)[sel]
    err = np.abs(card - cpu)
    far = vox[sel] > 2 * sig[sel]
    rel = float((err[far] / cpu[far]).max())
    log(f'13f: debias_rician_batch on the card {batch_ms:.3f} ms for '
        f'{vox.size} samples (CUDA events); card against CPU on 4096 voxels: '
        f'max relative difference {rel:.3g} above 2 sigma, max |diff| / '
        f'sigma {float((err / sig[sel]).max()):.3g} overall')
    check(bool((err <= DEBIAS_RTOL * np.abs(cpu)
                + DEBIAS_ATOL * sig[sel]).all()),
          'the debias on the card disagrees with the CPU')
    ev = amico_tpu_torch.Evaluation(study, 'subj_rician', device='cuda')
    ev.set_config('doDebiasSignal', True)
    ev.set_config('DWI-SNR', SNR)
    t0 = time.time()
    ev.load_data(dwi_filename='DWI.nii', scheme_filename='DWI.scheme')
    load_s = time.time() - t0
    ev.set_model('NODDI')
    ev.generate_kernels(ndirs=500)
    ev.load_kernels()
    t0 = time.time()
    ev.fit()
    fit_s = time.time() - t0
    maps = ev.RESULTS['MAPs'][ev.niiMASK_img == 1]
    agree = direction_agreement(ev, lut_true)
    log(f'13f: load_data with doDebiasSignal {load_s:.3f} s, NODDI fit '
        f'{fit_s:.3f} s; NDI/ODI/FWF medians '
        f'{np.round(np.median(maps, 0), 4).tolist()}; DTI directions on '
        f'the true LUT direction for {agree:.4f} of voxels')
    check(bool(np.isfinite(maps).all() and (maps >= 0).all()
               and (maps <= 1).all()), 'the debiased fit\'s maps are bad')


def phase_study(study, fw_study, tmp, noddi_maps, lut_true, kernels,
                htable, scheme):
    """Phase 13, the study path."""
    from amico_tpu_torch.testing import demo_voxels, write_demo_subject
    t_phase = time.time()
    phase_study_cli(study, tmp)
    t0 = time.time()
    y8, _, _ = demo_voxels(N_VOXELS, kernels, htable, seed=8)
    write_demo_subject(os.path.join(study, 'subj8'), scheme, y8, VOL_DIM)
    del y8
    log(f'13: seed-8 subject written: {time.time() - t0:.1f} s')
    sweep_maps = phase_sweep(study, tmp)
    phase_crash_resume(study, tmp, sweep_maps)
    ev = phase_streaming(study, fw_study, noddi_maps)
    phase_dti_methods(ev, lut_true)
    phase_profiler(ev, tmp)
    del ev
    phase_debias(study, lut_true)
    log(f'13: study path {time.time() - t_phase:.1f} s')


def main():
    import torch
    if not torch.cuda.is_available():
        log('FAILED: torch.cuda.is_available() is false')
        return 1
    import amico_tpu_torch
    from amico_tpu_torch.testing import (czb_scheme, czb_voxels, demo_czb,
                                         demo_freewater, demo_noddi,
                                         demo_sandi, demo_scheme, demo_voxels,
                                         freewater_voxels, sandi_voxels,
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
        max_err, (ms, plain_ms, bound_ms, bound_by), k1a_args = \
            phase_kernel_vs_twin(scheme, kernels, htable)
        phase_k1a(k1a_args, kernels)
        del k1a_args
        study = os.path.join(tmp, 'study')
        t0 = time.time()
        y, _, lut_true = demo_voxels(N_VOXELS, kernels, htable, seed=7)
        write_demo_subject(os.path.join(study, 'subj'), scheme, y, VOL_DIM)
        del y
        log(f'subject written: {time.time() - t0:.1f} s')
        launches, noddi_maps = phase_main_path(study, lut_true)
        noddi_study, noddi_lut_true = study, lut_true
        qp_err, (qp_ms, qp_plain_ms, qp_bound_ms, qp_bound_by) = \
            phase_qp_vs_twin(scheme, tmp)
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
        fw_study = study
        t1_launches, t1_err, (t1_ms, t1_plain_ms, t1_lib_ms, t1_bound_ms,
                              t1_bound_by) = phase_loc_probe()
        t0 = time.time()
        czb_model, czb_kernels, htable = demo_czb(
            czb_scheme(), os.path.join(tmp, 'czb'))
        study = os.path.join(tmp, 'study_czb')
        y, _, lut_true, W = czb_voxels(N_VOXELS, czb_kernels, htable, seed=7)
        prolate = np.r_[np.ones(len(czb_model.Rs), bool),
                        czb_model.d_perps < czb_model.d_par,
                        np.zeros(len(czb_model.d_isos), bool)]
        aniso = W[:, prolate].sum(1) > 0.5
        write_demo_subject(os.path.join(study, 'subj'), czb_scheme(), y,
                           VOL_DIM)
        del y, W
        log(f'CZB kernels and subject written: {time.time() - t0:.1f} s')
        ev, czb_maps = phase_czb_main_path(study, lut_true, aniso)
        del lut_true
        phase_czb_pallas(ev, czb_maps)
        del ev
        phase_noddi_xla(noddi_study, noddi_maps)
        t0 = time.time()
        _, sandi_kernels, _ = demo_sandi(czb_scheme(),
                                         os.path.join(tmp, 'sandi'))
        study = os.path.join(tmp, 'study_sandi')
        y, _ = sandi_voxels(N_VOXELS, sandi_kernels, seed=7)
        write_demo_subject(os.path.join(study, 'subj'), czb_scheme(), y,
                           VOL_DIM)
        del y
        log(f'SANDI subject written: {time.time() - t0:.1f} s')
        phase_sandi(study)
        phase_study(noddi_study, fw_study, tmp, noddi_maps, noddi_lut_true,
                    kernels, htable, scheme)
    from amico_tpu_torch.ops import native
    check(native.available(), "the port's native host library did not load")
    loaded = sorted(m for m in sys.modules
                    if m.split('.')[0] in ('jax', 'amico_tpu'))
    check(not loaded, f'the port imported JAX or amico_tpu: {loaded}')
    log('standalone: no jax or amico_tpu module loaded; native host library '
        'in use')
    log(json.dumps({'kernels': [{
        'name': 'noddi_fused', 'route': 'cuda',
        'source': 'amico_tpu_torch/csrc/noddi_fused.cu',
        'replaces': 'amico_tpu/ops/pallas_qp.py:764',
        'launches': launches, 'max_abs_err': max_err,
        'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
        'bound_by': bound_by, 'library_ms': None}, {
        'name': 'nneg_qp_tiles', 'route': 'cuda',
        'source': 'amico_tpu_torch/csrc/nneg_qp.cu',
        'replaces': 'amico_tpu/ops/pallas_qp.py:432',
        'launches': qp_launches, 'max_abs_err': qp_err,
        'ms': qp_ms, 'plain_ms': qp_plain_ms, 'bound_ms': qp_bound_ms,
        'bound_by': qp_bound_by, 'library_ms': None}, {
        'name': 'loc_probe', 'route': 'cuda',
        'source': 'amico_tpu_torch/csrc/loc_probe.cu',
        'replaces': 'tools/loc_experiment.py:34',
        'launches': t1_launches, 'max_abs_err': t1_err,
        'ms': t1_ms, 'plain_ms': t1_plain_ms, 'bound_ms': t1_bound_ms,
        'bound_by': t1_bound_by, 'library_ms': t1_lib_ms}]}))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
