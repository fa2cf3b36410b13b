"""Builds of the fused NODDI kernel (K1) and the tile QP kernel (K2) side by
side on one card, and the host pieces of a ctypes launch (T1's path).

    python -m amico_tpu_torch.tools.kernel_bench \\
        [--variant LABEL=CSRC_DIR[:NVCC_FLAGS]]... [--ptxas] [--reps N] \\
        [--count] [--tail] [--t1] [--out FILE]

Each variant compiles ``noddi_fused.cu``, ``nneg_qp.cu`` and ``runtime.cu``
of CSRC_DIR (nvcc, sm_90a, plus NVCC_FLAGS, space separated, such as
``-DNWARPS=32``) into a library of its own under ``build/kernel_bench/``;
``--ptxas`` prints what ``-Xptxas -v`` says of each.  The first variant is
the reference. On ``chip_smoke.py``'s phase-3 inputs (3,200 tiles of the
full NODDI grid, in vivo and exvivo, in launches of 512 tiles) each
variant's K1 estimates and coefficients, and on its phase-5 inputs
(FreeWater Human and Mouse, 3,200 tiles; the random n = 21 problems
under the dense schedule, 512 tiles), on random n = 150 problems and n =
160 problems of 256 voxels a tile, on phase 9's 512 CylinderZeppelinBall
tiles (n = 26) and on the lane-group edges (random problems at n = 8, 9,
16, 17 and M = 1, 7, 33, 129, plain, with a mask and with a warm start)
its K2 solution, are compared with the reference's by ``torch.equal``.
K1 (the first 512-tile launch, in vivo) and K2 (the first 512-tile
launch of FreeWater Human, Mouse and CZB) are timed with CUDA events,
the variants in turns: A B ... B A, ``--reps`` times over.

K1's C entry point has changed twice; a variant's is told by words in its
``noddi_fused.cu``: ``rtab`` (this tree's: a per-round table on the
device, the tie-break's tables and the tie score), else ``scratch`` (the
stage-2 dictionary in (ndwi, n_wm) layout and a scratch buffer, with the
per-round budgets in the host schedule), else the first one (the
dictionary transposed).  Each gets the production schedule packed its
way.  K2's entry point takes a ``tile_rounds`` pointer (each tile's
continuation rounds) since the port was traced; a variant whose
``nneg_qp.cu`` has that word gets a null one, the launch that writes no
count.

``--count`` counts the work K1 and K2 need on these inputs
(:func:`amico_tpu_torch.testing.solve_work` on the first launch of each).
``--tail`` reads K2's ``converge`` tail on each K2 input
(:func:`amico_tpu_torch.testing.qp_tail`: continuation rounds and exits a
tile, the longest voxel chain) and times the variants on the same timed
launches without ``converge`` too.
``--t1`` times each host piece of a ctypes launch 10,000 times with a host
clock, and T1, ``torch.add(1, x, alpha=2)`` and T1's twin at (8, 128) and
1,000,003 floats in turns with CUDA events.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import time

import numpy as np

PROTOCOL = dict(nb0=9, shells=(700.0, 2000.0), ndir=(30, 60))
N_TILES = 3200
STEP = 512
T1_SIZES = ((8, 128), (1_000_003,))


def log(*a):
    print(*a, flush=True)


class Variant:
    def __init__(self, spec: str, ptxas: bool):
        from amico_tpu_torch.ops import cuda_build
        self.label, rest = spec.split('=', 1)
        csrc, _, flags = rest.partition(':')
        self.csrc = os.path.abspath(csrc)
        self.flags = flags.split()
        with open(os.path.join(self.csrc, 'noddi_fused.cu')) as f:
            text = f.read()
        self.rtab = 'rtab' in text
        self.scratch = self.rtab or 'scratch' in text
        with open(os.path.join(self.csrc, 'nneg_qp.cu')) as f:
            self.counted = 'tile_rounds' in f.read()
        out = os.path.join(os.path.dirname(cuda_build.BUILD_ROOT),
                           'kernel_bench', self.label, 'lib.so')
        t0 = time.time()
        text = cuda_build.compile_library(
            [os.path.join(self.csrc, f) for f in ('noddi_fused.cu',
                                                  'nneg_qp.cu',
                                                  'runtime.cu')],
            out, cuda_build.NVCC_FLAGS + self.flags
            + (['-Xptxas', '-v'] if ptxas else []))
        log(f'[{self.label}] built in {time.time() - t0:.1f} s '
            f'(flags {self.flags}, scratch ABI {self.scratch})')
        if ptxas:
            log(text)
        lib = ctypes.CDLL(out)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.noddi_fused_launch.argtypes = [vp] * (
            15 if self.rtab else 11 if self.scratch else 10) \
            + [ci] * 6 + [cf, cf, vp, vp]
        lib.noddi_fused_launch.restype = ci
        lib.nneg_qp_launch.argtypes = [vp] * (7 if self.counted else 6) \
            + [ci] * 3 + [cf, cf, vp, vp]
        lib.nneg_qp_launch.restype = ci
        self.lib = lib

    def k1(self, args, exvivo, scheds, want_x=True):
        """K1 on ``args`` under ``scheds`` (the production schedule's
        ``cuda_qp.noddi_schedules``), through this variant's entry point."""
        import torch
        from amico_tpu_torch.ops import cuda_qp
        G1, G2, b1, Y, A2T, iso, icvf, kappa = args
        C, M, na = b1.shape
        n_wm, ndwi = A2T.shape[1:]
        est = torch.empty((C, M, 4), device='cuda')
        x = torch.empty((C, M, na), device='cuda') if want_x else None
        ptrs = [G1, G2, b1, Y]
        if self.scratch:
            ptrs.append(A2T.transpose(1, 2).contiguous())
        else:
            ptrs.append(A2T)
        ptrs += [iso, icvf, kappa]
        if self.rtab:
            head, table = cuda_qp._sched_arrays(scheds, None, False)
            rtab = cuda_qp._round_table(table, b1.device)
            ptrs += [None, None, est, x, None, torch.empty(
                C * M * cuda_qp.noddi_scratch_words(na, n_wm, False),
                device='cuda'), rtab]
        else:
            head = legacy_sched(scheds)
            ptrs += [est, x]
            if self.scratch:
                ptrs.append(torch.empty(C * M * (na + 5), device='cuda'))
        err = self.lib.noddi_fused_launch(
            *[None if t is None else t.data_ptr() for t in ptrs],
            C, M, na, n_wm, ndwi, int(exvivo), 0.5, 1e-3, head.ctypes.data,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'[{self.label}] K1 launch failed: {err}')
        return est, x

    def k2(self, G, b, lam2, sched, mask=None, m0=None, x0=None):
        import torch
        C, M, n = b.shape
        x = torch.empty_like(b)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        ptrs = [G.data_ptr(), b.data_ptr(), ptr(mask), ptr(m0), ptr(x0),
                x.data_ptr()] + ([None] if self.counted else [])
        err = self.lib.nneg_qp_launch(
            *ptrs, C, M, n, 0.0, lam2, sched.ctypes.data,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'[{self.label}] K2 launch failed: {err}')
        return x


def legacy_sched(scheds, max_rounds=32):
    """The production schedule as the older entry points read it: per stage
    [rounds, add_k, polish, cg[32], inner[32]]."""
    out = np.zeros((3, 3 + 2 * max_rounds), np.int32)
    for s, sch in enumerate(scheds):
        r = len(sch.cg)
        out[s, :3] = (r, sch.add_k, sch.polish)
        out[s, 3:3 + r] = sch.cg
        out[s, 3 + max_rounds:3 + max_rounds + r] = sch.inner
    return out


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


def in_turns(fns: dict, reps: int, calls: int) -> dict:
    """ms per call of each function, timed in turns A B .. B A, `reps`
    times over; every reading is kept."""
    out = {k: [] for k in fns}
    order = list(fns)
    for r in range(reps):
        for k in order + order[::-1]:
            out[k].append(cuda_ms(fns[k], calls))
    return out


def k1_inputs(tmp):
    from amico_tpu_torch.models import NODDI
    from amico_tpu_torch.testing import demo_noddi, demo_scheme, \
        noddi_tile_inputs
    scheme = demo_scheme(**PROTOCOL)
    _, kernels, htable = demo_noddi(scheme, small=False,
                                    kernels_dir=os.path.join(tmp, 'k'))
    for exvivo in (False, True):
        model = NODDI()
        model.set(isExvivo=exvivo)
        model.scheme = scheme
        yield exvivo, noddi_tile_inputs(model, kernels, htable, 'cuda',
                                        N_TILES, seed=1)


def k2_inputs(tmp):
    """(name, G, b, lam2, solver kwargs, extra inputs) of each K2 case."""
    import torch
    from amico_tpu_torch.models.base import DEFAULT_AS_SOLVER_KW, \
        DENSE_AS_SOLVER_KW
    from amico_tpu_torch.testing import czb_scheme, czb_tile_inputs, \
        demo_czb, demo_freewater, demo_scheme, freewater_tile_inputs, \
        random_qp_problems
    scheme = demo_scheme(**PROTOCOL)
    for typ in ('Human', 'Mouse'):
        model, kernels, htable = demo_freewater(scheme, typ,
                                                os.path.join(tmp, typ))
        G, b = freewater_tile_inputs(model, kernels, htable, 'cuda', N_TILES,
                                     seed=1)
        yield typ, G, b, 1e-3, DEFAULT_AS_SOLVER_KW, {}
    # n = 150 keeps x but not b_eff in shared memory on an H100, n = 160 at
    # 256 voxels a tile neither (ops/cuda_qp.py:qp_geometry)
    for name, C, n, M in (('dense', STEP, 21, 128), ('n150', 64, 150, 128),
                          ('n160-M256', 16, 160, 256)):
        G, b = random_qp_problems(C, n, M=M, seed=0)
        yield name, torch.from_numpy(G).cuda(), torch.from_numpy(b).cuda(), \
            4.0, DENSE_AS_SOLVER_KW, {}
    model, kernels, htable = demo_czb(czb_scheme(), os.path.join(tmp, 'czb'))
    G, b, _ = czb_tile_inputs(model, kernels, htable, 'cuda', STEP, seed=1)
    yield 'czb', G, b, 4.0, DENSE_AS_SOLVER_KW, {}
    yield from edge_inputs()


EDGE_WARM = dict(fista_iters=0, refine_rounds=3, cg_iters=(3, 5),
                 converge=True)


def edge_inputs(C=33):
    """The lane groups' edges: random problems at n = 8, 9, 16, 17 (one
    group width's last n and the next one's first) and M = 1, 7, 33, 129
    voxels a tile, plain under the default schedule, with a 0/1 mask, and
    with a warm start (m0, x0) under a short schedule with `converge`."""
    import numpy as np
    import torch
    from amico_tpu_torch.models.base import DEFAULT_AS_SOLVER_KW
    from amico_tpu_torch.testing import random_qp_problems
    for n in (8, 9, 16, 17):
        for M in (1, 7, 33, 129):
            G, b = (torch.from_numpy(a).cuda() for a in random_qp_problems(
                C, n, M=M, seed=n * 1000 + M))
            rng = np.random.RandomState(n + M)
            mask = (rng.rand(*b.shape) > 0.4).astype(np.float32)
            m0 = (rng.rand(*b.shape) > 0.6).astype(np.float32)
            x0 = (rng.rand(*b.shape) * 0.1).astype(np.float32)
            on = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
            yield f'edge-n{n}-M{M}', G, b, 1e-3, DEFAULT_AS_SOLVER_KW, {}
            yield f'edge-n{n}-M{M}-mask', G, b, 1e-3, DEFAULT_AS_SOLVER_KW, \
                {'mask': on(mask)}
            yield f'edge-n{n}-M{M}-warm', G, b, 1e-3, EDGE_WARM, \
                {'m0': on(m0), 'x0': on(x0)}


def chunks(args):
    for i in range(0, args[0].shape[0], STEP):
        yield [a[i:i + STEP] if a.dim() == 3 else a for a in args]


def qp_sched(n, kw):
    from amico_tpu_torch.ops import cuda_qp
    return cuda_qp._qp_sched_array(cuda_qp.qp_schedule(n, **{
        k: v for k, v in kw.items() if k != 'cd_sweeps'}))


def bench_kernels(variants, reps, count, tail, tmp, record):
    import torch
    from amico_tpu_torch.models.base import DEFAULT_NODDI_STAGE_ITERS
    from amico_tpu_torch.ops import cuda_qp
    from amico_tpu_torch.testing import qp_tail, solve_work, tail_histogram
    ref = variants[0]
    for exvivo, args in k1_inputs(tmp):
        sched = cuda_qp.noddi_schedules(DEFAULT_NODDI_STAGE_ITERS,
                                        args[2].shape[-1], args[1].shape[-1])
        outs = {}
        for v in variants:
            res = [v.k1(c, exvivo, sched) for c in chunks(args)]
            outs[v.label] = tuple(torch.cat(o) for o in zip(*res))
        torch.cuda.synchronize()
        for v in variants[1:]:
            same = [torch.equal(a, b) for a, b in zip(outs[v.label],
                                                      outs[ref.label])]
            diff = [int((a != b).sum()) for a, b in zip(outs[v.label],
                                                        outs[ref.label])]
            log(f'K1 exvivo={exvivo}: {v.label} vs {ref.label}: est equal '
                f'{same[0]}, x equal {same[1]} (differing elements {diff})')
            record.setdefault('k1_equal', {})[
                f'{v.label}/exvivo={exvivo}'] = same
        first = next(chunks(args))
        if not exvivo:
            times = in_turns({v.label: (lambda v=v: v.k1(first, False, sched,
                                                          want_x=False))
                              for v in variants}, reps, 5)
            for k, t in times.items():
                log(f'K1 {k}: {np.median(t):.3f} ms median per 512-tile '
                    f'launch (readings {[round(x, 3) for x in t]})')
            record['k1_ms'] = times
        if count:
            _, w = solve_work(cuda_qp.noddi_fused_tiles_torch, *first,
                              is_exvivo=exvivo)
            log(f'K1 work, exvivo={exvivo}, first launch: {json.dumps(w)}')
            record[f'k1_work_exvivo={exvivo}'] = w
        del args, outs
    for name, G, b, lam2, kw, extra in k2_inputs(tmp):
        s = qp_sched(b.shape[-1], kw)
        outs = {v.label: torch.cat([v.k2(G[i:i + STEP], b[i:i + STEP], lam2,
                                         s, **{k: t[i:i + STEP]
                                               for k, t in extra.items()})
                                    for i in range(0, G.shape[0], STEP)])
                for v in variants}
        torch.cuda.synchronize()
        for v in variants[1:]:
            same = torch.equal(outs[v.label], outs[ref.label])
            log(f'K2 {name}: {v.label} vs {ref.label}: x equal {same} '
                f'(differing {int((outs[v.label] != outs[ref.label]).sum())})')
            record.setdefault('k2_equal', {})[f'{v.label}/{name}'] = same
        del outs
        if tail and not name.startswith('edge'):
            _, t = qp_tail(G, b, None, 0.0, lam2, **kw)
            h = tail_histogram(t)
            mv, nz = t['matvecs'], t['chain_nonzeros']
            log(f'K2 tail {name} ({G.shape[0]} tiles, n = {b.shape[-1]}, cap '
                f'{t["cap"]}): rounds {h["rounds"]}, exits {h["exit"]}; '
                f'chain matvecs median {float(mv.median()):.0f} max '
                f'{float(mv.max()):.0f}, chain nonzeros median '
                f'{float(nz.median()):.0f} max {float(nz.max()):.0f}')
            record[f'k2_tail_{name}'] = dict(h, chain_matvecs_max=float(
                mv.max()), chain_nonzeros_max=float(nz.max()))
        if name in ('Human', 'Mouse', 'czb'):
            first = (G[:STEP].contiguous(), b[:STEP].contiguous())
            fns = {v.label: (lambda v=v: v.k2(*first, lam2, s))
                   for v in variants}
            if tail:
                s_nc = qp_sched(b.shape[-1], dict(kw, converge=False))
                fns.update({f'{v.label} no-converge':
                            (lambda v=v: v.k2(*first, lam2, s_nc))
                            for v in variants})
            times = in_turns(fns, reps, 5)
            for k, t in times.items():
                log(f'K2 {name} {k}: {np.median(t):.3f} ms median per '
                    f'512-tile launch (readings {[round(x, 3) for x in t]})')
            record[f'k2_ms_{name}'] = times
        if count and name in ('Human', 'dense'):
            _, w = solve_work(cuda_qp.nneg_qp_tiles_torch, G[:STEP],
                              b[:STEP], None, 0.0, lam2, **kw)
            log(f'K2 work, {name}, first launch: {json.dumps(w)}')
            record[f'k2_work_{name}'] = w


def host_us(fn, n=10_000):
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def bench_t1(record):
    """Each host piece of a ctypes launch, 10,000 calls each (host clock),
    then T1, the one-call yardstick and the twin in turns."""
    import torch
    from amico_tpu_torch.ops import cuda_build
    from amico_tpu_torch.ops import loc_probe as lp
    x = torch.randn(T1_SIZES[0], device='cuda')
    dev = x.device
    fn = cuda_build.entry('loc_probe_launch', lp._LAUNCH.argtypes)
    stream = torch.cuda.current_stream(dev).cuda_stream
    pieces = {
        'checks (device type, dtype, contiguity)': lambda: (
            x.device.type == 'cuda' and x.dtype == torch.float32
            and x.is_contiguous()),
        'torch.empty_like': lambda: torch.empty_like(x),
        'x.data_ptr() and x.numel()': lambda: (x.data_ptr(), x.numel()),
        'torch.cuda.current_stream(dev).cuda_stream':
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        'torch.cuda.current_device()': torch.cuda.current_device,
        'ctypes call (launch included)': lambda: fn(x.data_ptr(),
                                                    x.data_ptr(), x.numel(),
                                                    stream),
        'Launcher call (launch included)': lambda: lp._LAUNCH(
            dev, x.data_ptr(), x.data_ptr(), x.numel()),
        'loc_probe(x), whole wrapper': lambda: lp.loc_probe(x),
        'loc_probe_torch(x), twin': lambda: lp.loc_probe_torch(x),
        'torch.add(1, x, alpha=2)': lambda: torch.add(1, x, alpha=2),
        'torch.empty_like + torch.add(1, x, alpha=2, out=o)':
            lambda: torch.add(1, x, alpha=2, out=torch.empty_like(x)),
    }
    for name in ('_cuda_getCurrentRawStream', '_cuda_getDevice'):
        f = getattr(torch._C, name, None)
        if f is not None:
            pieces[f'torch._C.{name}'] = (lambda f=f: f(dev.index))  \
                if 'Stream' in name else f

    def enter_exit():
        with torch.cuda.device(dev):
            pass
    pieces['with torch.cuda.device(dev): pass'] = enter_exit
    us = {}
    for name, f in pieces.items():
        us[name] = host_us(f)
        torch.cuda.synchronize()
        log(f'T1 host piece: {name}: {us[name]:.3f} us a call')
    record['t1_host_us'] = us
    for shape in T1_SIZES:
        x = torch.randn(shape, device='cuda')
        times = in_turns({'T1': lambda: lp.loc_probe(x),
                          'torch.add(1, x, alpha=2)':
                              lambda: torch.add(1, x, alpha=2),
                          'twin': lambda: lp.loc_probe_torch(x)}, 2, 200)
        for k, t in times.items():
            log(f'T1 {shape}: {k}: {np.median(t):.4f} ms median per call '
                f'(readings {[round(v, 4) for v in t]})')
        record[f't1_ms_{shape}'] = times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--variant', action='append', default=[])
    ap.add_argument('--ptxas', action='store_true')
    ap.add_argument('--reps', type=int, default=2)
    ap.add_argument('--count', action='store_true')
    ap.add_argument('--tail', action='store_true')
    ap.add_argument('--t1', action='store_true')
    ap.add_argument('--out')
    a = ap.parse_args(argv)
    import tempfile

    import torch
    if not torch.cuda.is_available():
        raise SystemExit('kernel_bench needs a CUDA card')
    from amico_tpu_torch.device import resolve_device
    from amico_tpu_torch import set_verbose
    resolve_device('cuda')
    set_verbose(1)
    import subprocess
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    log(f'card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}')
    record = {'card': smi}
    variants = [Variant(s, a.ptxas) for s in a.variant]
    with tempfile.TemporaryDirectory() as tmp:
        os.environ['AMICO_TPU_HOME'] = os.path.join(tmp, 'home')
        if variants:
            bench_kernels(variants, a.reps, a.count, a.tail, tmp, record)
        if a.t1:
            bench_t1(record)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, 'w') as f:
            json.dump(record, f, indent=1, default=str)


if __name__ == '__main__':
    main()
