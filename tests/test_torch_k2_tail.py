"""K2's ``converge`` tail and its launch geometry, on the CPU.

The tile QP (amico_tpu_torch.ops.cuda_qp) continues each tile's rounds until
the whole tile is done, so a tile's time is that of its slowest voxel chain.
Here: the twin's result does not depend on the order of a tile's voxels (the
kernel maps voxels to lane groups by position and relies on it),
``testing.qp_tail`` reads rounds and exits as the schedule implies, and
``cuda_qp.qp_geometry`` describes the launch that csrc/nneg_qp.cu makes."""
import os
import re

import numpy as np
import pytest
import torch

from amico_tpu_torch.models.base import (DEFAULT_AS_SOLVER_KW,
                                         DENSE_AS_SOLVER_KW)
from amico_tpu_torch.ops import cuda_qp
from amico_tpu_torch.ops.cuda_qp import nneg_qp_tiles_torch
from amico_tpu_torch.testing import (TAIL_EXITS, qp_tail, random_qp_problems,
                                     solve_work, tail_histogram)

torch.set_num_threads(1)

INEXACT = dict(fista_iters=0, refine_rounds=1, cg_iters=2, converge=2)
H100_SMEM = 232_448      # an H100's shared memory a block may opt into


def collinear_problems(C, n, M=128, eps=1e-2, seed=0):
    """Tile QPs whose atoms come in near-collinear pairs (the second half
    of the dictionary is the first half plus eps noise), as FreeWater's
    adjacent zeppelins are: working sets churn between the pair members,
    and the continuation runs long.  Returns torch float32 G (C, n, n) and
    b (C, M, n)."""
    rng = np.random.RandomState(seed)
    base = np.abs(rng.randn(C, 60, (n + 1) // 2))
    A = np.concatenate([base, base[:, :, :n // 2]
                        + eps * rng.randn(C, 60, n // 2)], -1)
    y = np.einsum('cmk,cvk->cvm', A, rng.rand(C, M, n) ** 3) \
        + 0.01 * rng.randn(C, M, 60)
    G = np.einsum('cmi,cmj->cij', A, A).astype(np.float32)
    b = np.einsum('cmi,cvm->cvi', A, y).astype(np.float32)
    return torch.from_numpy(G), torch.from_numpy(b)


def dense_solution_problems(C=2, n=11, M=16, seed=3):
    """Well-conditioned tile QPs whose solution uses every atom:
    G = A'A/40 + I, b = G x* with x* in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)
    A = rng.randn(C, 40, n)
    G = (np.einsum('cki,ckj->cij', A, A) / 40 + np.eye(n)).astype(np.float32)
    x = rng.uniform(0.5, 1.5, (C, M, n)).astype(np.float32)
    b = np.einsum('cij,cmj->cmi', G, x).astype(np.float32)
    return torch.from_numpy(G), torch.from_numpy(b), torch.from_numpy(x)


# (tiles, lam2, solver kwargs): FreeWater-like churning tiles (Human n = 11,
# Mouse n = 12) and the random problems under the dense schedule (n = 21)
PERMUTED = {
    'human-n11': (lambda: collinear_problems(2, 11), 1e-3,
                  DEFAULT_AS_SOLVER_KW),
    'mouse-n12': (lambda: collinear_problems(2, 12, seed=1), 1e-3, INEXACT),
    'dense-n21': (lambda: tuple(torch.from_numpy(a) for a in
                                random_qp_problems(3, 21, seed=0)), 4.0,
                  DENSE_AS_SOLVER_KW),
}


@pytest.mark.parametrize('case', list(PERMUTED))
def test_tile_exit_does_not_depend_on_voxel_order(case):
    """Permuting the voxels of each tile permutes the twin's x bit for bit:
    the tile-wide exit reads only order-free reductions (all, max)."""
    make, lam2, kw = PERMUTED[case]
    G, b = make()
    C, M, n = b.shape
    rng = np.random.RandomState(7)
    perm = torch.from_numpy(np.stack([rng.permutation(M) for _ in range(C)]))
    idx = perm[..., None].expand(C, M, n)
    x, tail = qp_tail(G, b, None, 0.0, lam2, **kw)
    x_p = nneg_qp_tiles_torch(G, torch.gather(b, 1, idx), None, 0.0, lam2,
                              **kw)
    assert torch.equal(x_p, torch.gather(x, 1, idx))
    if case != 'dense-n21':
        assert int(tail['rounds'].max()) > 0     # the continuation ran


def test_tail_of_a_tile_stable_after_the_schedule():
    G, b, _ = dense_solution_problems()
    kw = dict(fista_iters=0, refine_rounds=20, cg_iters=16, converge=True)
    x, tail = qp_tail(G, b, None, 0.0, 0.0, **kw)
    assert torch.equal(x, nneg_qp_tiles_torch(G, b, None, 0.0, 0.0, **kw))
    assert tail['rounds'].tolist() == [0, 0]
    assert [TAIL_EXITS[e] for e in tail['exit'].tolist()] == ['stable'] * 2
    assert tail_histogram(tail)['rounds'] == {'0': 2, '1-8': 0, '9-47': 0,
                                              'cap': 0}


def test_tail_of_a_tile_needing_more_atoms_than_rounds():
    """From an empty working set each round adds at most one atom, so a
    solution on all n atoms needs at least n - rounds continuation rounds
    after `rounds` scheduled ones."""
    G, b, x_true = dense_solution_problems()
    n, rounds = b.shape[-1], 2
    kw = dict(fista_iters=0, refine_rounds=rounds, cg_iters=16,
              converge=True)
    x, tail = qp_tail(G, b, None, 0.0, 0.0, **kw)
    assert bool((tail['rounds'] >= n - rounds).all()), tail['rounds']
    assert bool((tail['rounds'] < tail['cap']).all())
    assert [TAIL_EXITS[e] for e in tail['exit'].tolist()] == ['stable'] * 2
    assert float((x - x_true).abs().max()) < 1e-4


def test_tail_of_inexact_cg_tiles_reaches_the_cap():
    """Two CG steps a round on churning tiles: some tiles run to the round
    cap, 3 * npad = 48 at n = 11, and leave by it."""
    G, b = collinear_problems(8, 11)
    _, tail = qp_tail(G, b, None, 0.0, 1e-3, **INEXACT)
    assert tail['cap'] == 48
    capped = tail['rounds'] == 48
    assert int(capped.sum()) >= 2, tail['rounds']
    assert bool((tail['exit'][capped] == TAIL_EXITS.index('cap')).all())
    assert bool((tail['rounds'] <= 48).all())
    hist = tail_histogram(tail)
    assert hist['rounds']['cap'] == int(capped.sum())
    assert sum(hist['exit'].values()) == 8


def stall_off(monkeypatch):
    """The stall test off, the continuation's other exits as they were:
    no objective passes a tolerance of -inf."""
    monkeypatch.setattr(cuda_qp, 'STALL', float('-inf'))


def objective(G, b, lam2, x):
    G, b, x = G.double(), b.double(), x.double()
    return 0.5 * (x * (x @ G.transpose(1, 2))).sum(-1) - (b * x).sum(-1) \
        + 0.5 * lam2 * (x * x).sum(-1)


def test_tail_of_a_cycling_voxel_stalls(monkeypatch):
    """One voxel of the churning tiles, a tile of its own: x wanders at no
    cost in float32 along the near-collinear pair of atoms 0 and 6 by more
    than the tile's x tolerance, and atom 8, its optimum at the prune gate,
    is pruned and added again every round.  Without the stall test the
    tail runs to the cap, 48 rounds; with it the voxel is done after one
    round (it is back in its working set, its objective no lower), within
    1e-6 relative of the capped objective."""
    G, b = collinear_problems(2, 11)
    G, b = G[:1], b[:1, 18:19]
    x, tail = qp_tail(G, b, None, 0.0, 1e-3, **DEFAULT_AS_SOLVER_KW)
    assert (tail['rounds'].tolist(), tail['exit'].tolist()) == \
        ([1], [TAIL_EXITS.index('stalled')])
    stall_off(monkeypatch)
    x_cap, capped = qp_tail(G, b, None, 0.0, 1e-3, **DEFAULT_AS_SOLVER_KW)
    assert (capped['rounds'].tolist(), capped['exit'].tolist()) == \
        ([48], [TAIL_EXITS.index('cap')])
    o, o_cap = objective(G, b, 1e-3, x), objective(G, b, 1e-3, x_cap)
    assert float((o - o_cap).abs() / o_cap.abs()) < 1e-6


def czb_tile(name):
    """G (1, 26, 26) and b (1, 192, 26) of a CylinderZeppelinBall tile as
    K2 received it on the card in the benchmark's czb.refit (850 samples,
    26 atoms, 192 voxels), from tests/data."""
    d = np.load(os.path.join(os.path.dirname(__file__), 'data', name))
    return torch.from_numpy(d['G'])[None], torch.from_numpy(d['b'])[None]


def test_tail_of_a_period_three_cycle_stalls(monkeypatch):
    """A tile at lambda2 2 (czb_period3_tile.npz) in which one voxel prunes
    two near-collinear zeppelins in one round and adds them back one a
    round, a cycle of period 3 with its objective flat to float32's last
    bits.  With the sets of its last STALL_ROUNDS rounds the tile stalls
    in its first round; with those of the last two alone, in its third, at
    the voxel's anchor; with the stall test off it runs to the cap, 96
    rounds, within 1e-6 relative of the stalled objectives."""
    G, b = czb_tile('czb_period3_tile.npz')
    x, tail = qp_tail(G, b, None, 0.0, 2.0, **DENSE_AS_SOLVER_KW)
    assert (tail['rounds'].tolist(), tail['exit'].tolist()) == \
        ([1], [TAIL_EXITS.index('stalled')])
    with monkeypatch.context() as mp:
        mp.setattr(cuda_qp, 'STALL_ROUNDS', 2)
        x_2, two = qp_tail(G, b, None, 0.0, 2.0, **DENSE_AS_SOLVER_KW)
    assert (two['rounds'].tolist(), two['exit'].tolist()) == \
        ([3], [TAIL_EXITS.index('stalled')])
    stall_off(monkeypatch)
    x_cap, capped = qp_tail(G, b, None, 0.0, 2.0, **DENSE_AS_SOLVER_KW)
    assert (capped['rounds'].tolist(), capped['exit'].tolist()) == \
        ([96], [TAIL_EXITS.index('cap')])
    o_cap = objective(G, b, 2.0, x_cap)
    for x_s in (x, x_2):
        o = objective(G, b, 2.0, x_s)
        assert float(((o - o_cap).abs() / o_cap.abs()).max()) < 1e-6


def test_tail_of_a_period_five_cycle_stalls(monkeypatch):
    """A tile at lambda2 8 (czb_period5_tile.npz, the tile that reached the
    cap in each lambda2 = 8 fit of one czb.refit run) in which one voxel
    prunes four near-collinear cylinders in one round and adds them back
    one a round: a cycle of period 5, longer than the STALL_ROUNDS rounds
    of history.  The voxel's anchor ends it in the tile's sixth round;
    with the stall test off it runs to the cap, 96 rounds, within 1e-6
    relative of the stalled objectives (of its 180 voxels with a signal;
    the other 12 are the tile's padding, at x = 0)."""
    G, b = czb_tile('czb_period5_tile.npz')
    assert cuda_qp.STALL_ROUNDS < 5
    x, tail = qp_tail(G, b, None, 0.0, 8.0, **DENSE_AS_SOLVER_KW)
    assert (tail['rounds'].tolist(), tail['exit'].tolist()) == \
        ([6], [TAIL_EXITS.index('stalled')])
    stall_off(monkeypatch)
    x_cap, capped = qp_tail(G, b, None, 0.0, 8.0, **DENSE_AS_SOLVER_KW)
    assert (capped['rounds'].tolist(), capped['exit'].tolist()) == \
        ([96], [TAIL_EXITS.index('cap')])
    live = b.abs().amax(-1) > 0
    assert int(live.sum()) == 180
    o, o_cap = objective(G, b, 8.0, x), objective(G, b, 8.0, x_cap)
    assert float(((o - o_cap).abs() / o_cap.abs())[live].max()) < 1e-6


def test_tail_of_churning_tiles_under_both_tests(monkeypatch):
    """The churning tiles (pairs at eps 1e-2) under FreeWater's schedule:
    without the stall test every tile runs to the cap, 48 rounds; with it
    every tile stalls within 9 rounds, its objectives within 1e-6 relative
    of the capped ones."""
    G, b = collinear_problems(8, 11)
    x, tail = qp_tail(G, b, None, 0.0, 1e-3, **DEFAULT_AS_SOLVER_KW)
    assert bool((tail['rounds'] <= 9).all()), tail['rounds']
    assert tail_histogram(tail)['exit']['stalled'] == 8
    stall_off(monkeypatch)
    x_cap, capped = qp_tail(G, b, None, 0.0, 1e-3, **DEFAULT_AS_SOLVER_KW)
    assert capped['rounds'].tolist() == [48] * 8
    assert tail_histogram(capped)['exit']['cap'] == 8
    o, o_cap = objective(G, b, 1e-3, x), objective(G, b, 1e-3, x_cap)
    assert float(((o - o_cap).abs() / o_cap.abs()).max()) < 1e-6


def test_tail_exits_are_the_kernels():
    assert TAIL_EXITS == cuda_qp.TAIL_EXITS
    src = open(cuda_qp.__file__.replace('ops/cuda_qp.py',
                                        'csrc/nneg_qp.cu')).read()
    assert 'enum TailExit { ' + ', '.join(
        f'TAIL_{e.upper()}' for e in TAIL_EXITS) + ' };' in src


def test_tail_rounds_agree_with_solve_work():
    """qp_tail's rounds against testing.solve_work's running-tile matvec
    count: every voxel runs the schedule's matvecs, plus inner (1 + cont_cg)
    + 1 for each continuation round of its tile, plus 1 + polish."""
    G, b = collinear_problems(4, 11, M=32)
    kw = INEXACT
    x, tail = qp_tail(G, b, None, 0.0, 1e-3, **kw)
    out, work = solve_work(nneg_qp_tiles_torch, G, b, None, 0.0, 1e-3, **kw)
    assert torch.equal(x, out)
    s = cuda_qp.qp_schedule(11, **kw)
    sched = sum(s.inner[r] * (1 + s.cg[r]) + 1 for r in range(len(s.cg)))
    per_round = max(s.inner) * (1 + s.cont_cg) + 1
    chain = sched + tail['rounds'].double() * per_round + 1 + s.polish
    assert torch.equal(tail['matvecs'], chain)
    assert work['matvecs'] == float(chain.sum()) * b.shape[1]
    assert int(tail['rounds'].sum()) > 0


# n -> (group width, coefficients a lane, warps a block, blocks a tile,
# lane groups a tile, voxels a group solves at once, state, dynamic shared
# memory bytes a block) at 128 voxels a tile on an H100: G at 32 * per_lane
# floats a row (17 <= n <= 32, the lockstep path: 32 rows of 36 floats and
# a scratch of 6 x 32 floats a warp), 6 * per_lane + 6 words a voxel (its
# working-set and mask words, those of its 3 rounds before the last and of
# its anchor, its scale, its last 4 objectives and its anchor's), then x
# and b_eff (state 2) or x alone (state 1) as they fit
LOCKSTEP_GRAM = 32 * 36 + 16 * 6 * 32
GEOMETRY = {
    1: (8, 1, 32, 2, 256, 1, 2, (32 + 1536 + 2 * 128) * 4),
    8: (8, 1, 32, 2, 256, 1, 2, (256 + 1536 + 2 * 1024) * 4),
    9: (16, 1, 32, 2, 128, 1, 2, (288 + 1536 + 2 * 1152) * 4),
    11: (16, 1, 32, 2, 128, 1, 2, (352 + 1536 + 2 * 1408) * 4),
    16: (16, 1, 32, 2, 128, 1, 2, (512 + 1536 + 2 * 2048) * 4),
    17: (32, 1, 16, 2, 32, 6, 2, (LOCKSTEP_GRAM + 1536 + 2 * 2176) * 4),
    26: (32, 1, 16, 2, 32, 6, 2, (LOCKSTEP_GRAM + 1536 + 2 * 3328) * 4),
    32: (32, 1, 16, 2, 32, 6, 2, (LOCKSTEP_GRAM + 1536 + 2 * 4096) * 4),
    33: (32, 2, 16, 1, 16, 1, 2, (2112 + 2304 + 2 * 4224) * 4),
    160: (32, 5, 16, 1, 16, 1, 1, (25600 + 4608 + 20480) * 4),
}


@pytest.mark.parametrize('n', list(GEOMETRY))
def test_launch_geometry(n):
    g = cuda_qp.qp_geometry(n, 128, H100_SMEM)
    assert (g.width, g.per_lane, g.warps, g.cluster, g.groups, g.batch,
            g.state, g.smem) == GEOMETRY[n]
    assert g.width * g.per_lane >= n and g.smem <= H100_SMEM - 1024
    assert (g.batch > 1) == cuda_qp.qp_lockstep(n) == (17 <= n <= 32)


def test_lockstep_geometry():
    """The lockstep path (17 <= n <= 32) at CZB's widths: 192 voxels a tile
    (czb.refit's 'auto' width) fill its 2 x 16 warps x 6 voxels in flight
    exactly; its G and scratch take 4,224 floats beside 12 words a voxel,
    and x and b_eff (26 floats each a voxel) stay in shared memory up to
    838 voxels a tile, x alone up to 1,411, neither up to 4,469, on an
    H100."""
    g = cuda_qp.qp_geometry(26, 192, H100_SMEM)
    assert (g.groups * g.batch, g.state) == (192, 2)
    assert g.smem == (LOCKSTEP_GRAM + 192 * 12 + 2 * 192 * 26) * 4
    assert [cuda_qp.qp_geometry(26, M, H100_SMEM).state
            for M in (838, 839, 1411, 1412, 4469)] == [2, 1, 1, 0, 0]
    with pytest.raises(NotImplementedError, match='shared memory'):
        cuda_qp.qp_geometry(26, 4470, H100_SMEM)
    # every width of CZB's ladder gives each warp the same voxels: 64 and
    # 128 a part of one batch, 320 a full one and 4 of 6 slots of a second
    for M in (64, 128, 192, 256, 320, 384):
        g = cuda_qp.qp_geometry(26, M, H100_SMEM)
        assert (g.groups * g.batch, M % g.groups) == (192, 0)


def test_launch_constants_are_the_kernels():
    """The wrapper's copies of the launch constants match csrc."""
    csrc = os.path.join(os.path.dirname(cuda_qp.__file__), '..', 'csrc')
    src = open(os.path.join(csrc, 'nneg_qp.cu')).read() \
        + open(os.path.join(csrc, 'qp_lockstep.cuh')).read()
    for name, value in (('NWARPS', cuda_qp.QP_NWARPS),
                        ('QP_CLUSTER', cuda_qp.QP_CLUSTER),
                        ('NWARPS_WIDE', cuda_qp.QP_NWARPS_WIDE),
                        ('QP_LS_V', cuda_qp.QP_LS_V),
                        ('QP_LS_WARPS', cuda_qp.QP_LS_WARPS),
                        ('LS_LD', cuda_qp.QP_LS_LD),
                        ('QP_SMEM_RESERVE', cuda_qp.QP_SMEM_RESERVE)):
        assert re.search(rf'#define {name} {value}\b', src), name


def test_launch_geometry_edges():
    with pytest.raises(NotImplementedError, match='at most 160'):
        cuda_qp.qp_geometry(161, 128, H100_SMEM)
    with pytest.raises(ValueError, match='at least one'):
        cuda_qp.qp_geometry(0, 128, H100_SMEM)
    # 256 voxels of 160 atoms: neither x nor b_eff fits beside G
    g = cuda_qp.qp_geometry(160, 256, H100_SMEM)
    assert (g.state, g.smem) == (0, (25600 + 256 * 36) * 4)
    # G and the per-voxel words alone overflow: at 160 atoms from 897
    # voxels on an H100, at once on a card of 48 KB a block
    assert cuda_qp.qp_geometry(160, 896, H100_SMEM).state == 0
    with pytest.raises(NotImplementedError, match='shared memory'):
        cuda_qp.qp_geometry(160, 897, H100_SMEM)
    with pytest.raises(NotImplementedError, match='shared memory'):
        cuda_qp.qp_geometry(160, 128, 48 * 1024)
    assert cuda_qp.qp_geometry(11, 0, H100_SMEM).smem == 352 * 4
