// Non-negative QP per voxel with a Gram shared by the tile, for Hopper
// (sm_90a):  min 1/2 x'Gx - b'x + lam1 sum(x) + lam2/2 |x|^2,  x >= 0.
//
// Replaces the TPU kernel amico_tpu/ops/pallas_qp.py:nneg_qp_tiles_pallas
// (body _make_kernel, solver _build_as_solve).  The plain PyTorch twin is
// amico_tpu_torch/ops/cuda_qp.py:nneg_qp_tiles_torch; both compute the same
// float32 math:
//   FISTA from zero (only without a seeded working set and with
//     fista > 0): a fixed trip count, one step 1/(L + lam2) per tile with L
//     from 10 power iterations on G, adaptive restart per voxel;
//   Lawson-Hanson rounds from the working set (x > 0)*mask, or m0*mask
//     with CG warm-started from x0*mask: round r runs `inner` passes of
//     masked CG at budget cg[r] with a ratio-test step back and a prune
//     below tol*max|b_eff|, then adds the top add_k violated atoms;
//   with `converge`, continuation rounds at budget cont_cg while the tile
//     is not done (at most cont_rounds): done once each voxel of the tile
//     is stable (adds no atom and keeps its working set in a round) or
//     stalled (a round returns it to the working set of one of its last
//     QP_STALL_ROUNDS rounds, or to its anchor, the set after its last
//     round that lowered its objective by more than `stall` relative, and
//     its objective is no lower than it was then beyond `stall` relative
//     (ops/cuda_qp.py STALL, which says why; -inf: no voxel stalls):
//     Lawson-Hanson never returns to a set in exact arithmetic, so such a
//     voxel is at float32's limit; the anchor catches the cycles longer
//     than the history), or once x moves by at most tol * the tile's
//     largest max|b_eff| anywhere in the tile.
//     The last scheduled round's stability seeds the test;
//   a final masked-CG polish at budget `polish`, then x = max(x, 0).
// Zero rounds return the FISTA iterate (or the warm start) as it is.
// Optionally each tile writes the number of continuation rounds it ran (0
// without `converge`) to tile_rounds[tile] and what ended them (TailExit)
// to tile_exits[tile]: the counters of the tail, read while the port is
// traced.
//
// Layout.  A tile is a thread block cluster of QP_CLUSTER blocks, each on
// its own SM, for n <= 32, and one block above.  A voxel is solved by a
// group of W lanes (csrc/qp_warp.cuh): W = 8 for n <= 8 (four voxels a
// warp), 16 for n <= 16 (two), 32 above (one, with K = ceil(n/32)
// coefficients a lane, n <= 160); one instantiation per (W, K), and for
// 17 <= n <= 32 the lockstep path (nneg_qp_lockstep below,
// qp_lockstep.cuh): a warp takes QP_LS_V of its voxels at once and G is
// row-major, each product dense and shared by them.  Each block
// holds G transposed in dynamic shared memory, replicated across the row
// so that the groups of a warp read disjoint banks.  Group g of the tile
// (block rank r's groups are r*NG .. r*NG + NG-1) takes the tile's voxels
// g, g + NGT, ... (NGT groups a tile), so the groups of a warp hold
// neighbouring voxels.  Each voxel keeps its state on chip from its
// scheduled rounds through the continuation and the polish, in dynamic
// shared memory after G: its working-set and coefficient-mask words, the
// working sets of its QP_STALL_ROUNDS - 1 rounds before the last and its
// anchor (K words of W bits each), its scale max|b_eff| + 1e-30, its
// objective at the end of each of its last QP_STALL_ROUNDS rounds and at
// its anchor, and its x and b_eff (n floats each).  Where x and b_eff do not both fit
// beside G (large n*M; the wrapper's qp_geometry mirrors the rule), b_eff
// is recomputed from b each round, and then x too stays in the output
// tensor.  So a round reads no device memory, and x is written to the
// output once, by the polish.  The tile's voxels meet only at the
// `converge` test: each block takes __syncthreads_and over its groups'
// levels (stable, stalled) and a block max of their |dx|, and the blocks
// of a cluster exchange the two through distributed shared memory, one
// cluster barrier a round (tile_level, qp_warp.cuh).
//
// What bounds it.  Not memory: a tile reads G (n*n floats) and b once and
// writes x once.  Nor the operations the inputs need (testing.solve_work).
// Each CG step is a chain of dependent shuffles (the ballot-driven sparse
// matvec, two dot products) and ~200 warp instructions.  A straggler tile,
// one held by the `converge` continuation to its round cap while the other
// SMs sit idle, is bound by the instruction issue of the SMs it runs on
// (PERF.md).  The design answers with voxels in flight and SMs a
// tile: lane groups (the lanes past n of a whole warp did nothing), 32
// warps a block, two blocks a tile, and no device-memory round trip in a
// round.  Every float operation of a voxel is the whole-warp kernel's, in
// the same order, and the vote's AND and max are exact, so the results are
// bit-identical to one block a tile of whole warps (PERF.md has the sweeps
// that picked NWARPS, MINB and QP_CLUSTER).  A voxel of 17-32 atoms holds
// nearly all of them (CZB: 25 of 26), so the sparse matvec's ~9
// instructions a nonzero bound its tile; the lockstep path's dense product
// takes ~1.3 a multiply-add with the same floats (qp_lockstep.cuh; PERF.md
// has the sweep that picked QP_LS_V and QP_LS_WARPS).
#include <cuda_runtime.h>

#include "qp_lockstep.cuh"

#define QP_MAXK 5         // coefficients per lane: n <= 160
#define QP_MAXR 32        // per-round CG budgets; later rounds reuse the last
// the timed sweep's pick (PERF.md); -D overrides them for a sweep
#ifndef NWARPS
#define NWARPS 32         // warps per block for n <= 16
#endif
#ifndef MINB
#define MINB 1            // blocks resident on an SM (register budget)
#endif
#ifndef QP_CLUSTER
#define QP_CLUSTER 2      // blocks a tile for n <= 32 (a thread block cluster)
#endif
#define NWARPS_WIDE 16    // warps per block for n > 32 (K > 1 a lane), one
                          // block a tile
// the lockstep path (17 <= n <= 32): voxels a warp solves at once and
// warps a block (the timed sweep's pick, PERF.md; -D overrides them for a
// sweep)
#ifndef QP_LS_V
#define QP_LS_V 6
#endif
#ifndef QP_LS_WARPS
#define QP_LS_WARPS 16
#endif
#define QP_SMEM_RESERVE 1024  // bytes of a block's shared memory kept for
                              // the static arrays (ops/cuda_qp.py mirrors it)

struct QpSched {
  int fista, rounds, inner, add_k, polish, cont_cg, cont_rounds;
  int cg[QP_MAXR];
};

// what ended a tile's continuation (ops/cuda_qp.py TAIL_EXITS)
enum TailExit { TAIL_OFF, TAIL_STABLE, TAIL_STALLED, TAIL_XTOL, TAIL_CAP };

struct QpParams {
  const float* G;     // (C, n, n)
  const float* b;     // (C, M, n)
  const float* mask;  // (C, M, n) 0/1, or null
  const float* m0;    // (C, M, n) 0/1, or null: seeds the working set
  const float* x0;    // (C, M, n), or null: with m0, CG's warm start
  float* x;           // (C, M, n): the result
  int* tile_rounds;   // (C,): each tile's continuation rounds, or null
  int* tile_exits;    // (C,): what ended them (TailExit), or null
  int M, n;
  int state;          // 2: x and b_eff in shared memory; 1: x only; 0: neither
  float lam1, lam2;
  float stall;        // the stall test's tolerance, relative
  QpSched s;
};

// a tile's per-voxel state (see Layout)
struct VoxState {
  unsigned* mw;  // (M, K) working-set words
  unsigned* cw;  // (M, K) coefficient-mask words
  unsigned* hw;  // (M, QP_STALL_ROUNDS - 1, K) the working sets after the
                 // rounds before the last, the latest first
  unsigned* aw;  // (M, K) the anchor: the working set after the last round
                 // that lowered the objective by more than the tolerance
  float* sc;     // (M,) max|b_eff| + 1e-30
  float* hf;     // (M, QP_STALL_ROUNDS) the objective after each of the
                 // last rounds, the latest first (QP_BIG: none)
  float* af;     // (M,) the objective at the anchor
  float* xs;     // (M, n) x: shared memory, or the tile's rows of the output
  float* bs;     // (M, n) b_eff in shared memory, or null
};

template <int K, int W>
__device__ __forceinline__ void load_row(const float* src, int n, int lane,
                                         float (&a)[K]) {
#pragma unroll
  for (int k = 0; k < K; k++) {
    const int i = lane + W * k;
    a[k] = i < n ? src[i] : 0.f;
  }
}

template <int K, int W>
__device__ __forceinline__ void store_row(float* dst, int n, int lane,
                                          const float (&a)[K]) {
#pragma unroll
  for (int k = 0; k < K; k++) {
    const int i = lane + W * k;
    if (i < n) dst[i] = a[k];
  }
}

template <int K, int W>
__device__ __forceinline__ void store_bits(unsigned* w, unsigned m,
                                           const Lanes<W>& L) {
#pragma unroll
  for (int k = 0; k < K; k++) {
    const unsigned word = L.own(__ballot_sync(L.mask(), bit(m, k)));
    if (L.lane == 0) w[k] = word;
  }
}

template <int K, int W>
__device__ __forceinline__ unsigned load_bits(const unsigned* w,
                                              const Lanes<W>& L) {
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < K; k++) m |= ((w[k] >> L.lane) & 1u) << k;
  return m;
}

// warm start and the scheduled rounds of voxel v of the tile (vox in the
// batch), then its state on chip; returns whether its last round left it
// stable, and its scale.  The rounds' sets and objectives start the
// history of the stall test, the last one its anchor; QP_BIG matches no
// objective
template <int K, int W>
__device__ __forceinline__ bool scheduled(const QpParams& P, const float* Gs,
                                          float step, const VoxState& VS,
                                          int v, size_t vox,
                                          const Lanes<W>& L, float& scale) {
  const int n = P.n, lane = L.lane;
  const size_t off = vox * n;
  float b[K], x[K];
  unsigned cmask = 0;
#pragma unroll
  for (int k = 0; k < K; k++) {
    const int i = lane + W * k;
    const bool on = i < n && (!P.mask || P.mask[off + i] != 0.f);
    if (on) cmask |= 1u << k;
    b[k] = on ? P.b[off + i] : 0.f;
  }
  unsigned m = 0;
  if (P.m0) {
#pragma unroll
    for (int k = 0; k < K; k++) {
      const int i = lane + W * k;
      const bool on = bit(cmask, k);
      x[k] = on && P.x0 ? P.x0[off + i] : 0.f;
      if (on && P.m0[off + i] != 0.f) m |= 1u << k;
    }
  } else if (P.s.fista > 0) {
    fista<K, W>(Gs, b, cmask, P.lam1, P.lam2, step, P.s.fista, x, L);
  } else {
#pragma unroll
    for (int k = 0; k < K; k++) x[k] = 0.f;
  }
  scale = 0.f;
  if (P.s.rounds == 0) {
    store_row<K, W>(P.x + off, n, lane, x);
    return true;
  }
  if (!P.m0) {
#pragma unroll
    for (int k = 0; k < K; k++)
      if (x[k] > 0.f && bit(cmask, k)) m |= 1u << k;
  }
  Stage<K, W> S;
  stage_init<K, W>(S, Gs, P.lam1, P.lam2, b, cmask, L);
  bool stable = false;
  // the sets after the rounds before the last, the latest first, and the
  // objectives after the last rounds
  constexpr int H = QP_STALL_ROUNDS;
  unsigned hm[H - 1];
  float hf[H];
#pragma unroll
  for (int i = 0; i < H - 1; i++) hm[i] = 0u;
#pragma unroll
  for (int i = 0; i < H; i++) hf[i] = QP_BIG;
  for (int r = 0; r < P.s.rounds; r++) {
#pragma unroll
    for (int i = H - 2; i > 0; i--) hm[i] = hm[i - 1];
    hm[0] = m;
    float f;
    stable = as_round<K, W, true>(S, x, m, P.s.cg[min(r, QP_MAXR - 1)],
                                  P.s.inner, P.s.add_k, &f);
#pragma unroll
    for (int i = H - 1; i > 0; i--) hf[i] = hf[i - 1];
    hf[0] = f;
  }
  store_row<K, W>(VS.xs + (size_t)v * n, n, lane, x);
  if (VS.bs) store_row<K, W>(VS.bs + (size_t)v * n, n, lane, S.beff);
  store_bits<K, W>(VS.mw + v * K, m, L);
  store_bits<K, W>(VS.cw + v * K, cmask, L);
#pragma unroll
  for (int i = 0; i < H - 1; i++)
    store_bits<K, W>(VS.hw + ((size_t)v * (H - 1) + i) * K, hm[i], L);
  store_bits<K, W>(VS.aw + v * K, m, L);
  if (lane == 0) {
    VS.sc[v] = S.scale;
#pragma unroll
    for (int i = 0; i < H; i++) VS.hf[(size_t)v * H + i] = hf[i];
    VS.af[v] = hf[0];
  }
  scale = S.scale;
  return stable;
}

// voxel v's stage from its state: what stage_init computed, read back
template <int K, int W>
__device__ __forceinline__ void load_stage(Stage<K, W>& S, const QpParams& P,
                                           const float* Gs, const VoxState& VS,
                                           int v, size_t vox,
                                           const Lanes<W>& L) {
  S.Gs = Gs;
  S.l2 = P.lam2;
  S.L = L;
  S.cmask = load_bits<K, W>(VS.cw + v * K, L);
  if (VS.bs) {
    load_row<K, W>(VS.bs + (size_t)v * P.n, P.n, L.lane, S.beff);
  } else {
#pragma unroll
    for (int k = 0; k < K; k++) {
      const int i = L.lane + W * k;
      S.beff[k] = bit(S.cmask, k) ? P.b[vox * P.n + i] - P.lam1 : 0.f;
    }
  }
  S.scale = VS.sc[v];
  S.gate = QP_TOL * S.scale;
}

// one continuation round of voxel v; returns its level, 2 stable, 1
// stalled (back in the working set of one of its last QP_STALL_ROUNDS
// rounds or in its anchor without a lower objective), 0 neither, and the
// largest |dx| of the round in dx
template <int K, int W>
__device__ __forceinline__ int cont_round(const QpParams& P, const float* Gs,
                                          const VoxState& VS, int v,
                                          size_t vox, const Lanes<W>& L,
                                          float& dx) {
  Stage<K, W> S;
  load_stage<K, W>(S, P, Gs, VS, v, vox, L);
  float* xv = VS.xs + (size_t)v * P.n;
  float x[K], x_old[K];
  load_row<K, W>(xv, P.n, L.lane, x);
  constexpr int H = QP_STALL_ROUNDS;
  // the sets after the last H rounds, the latest first, and their
  // objectives
  unsigned hm[H];
  float hf[H];
  hm[0] = load_bits<K, W>(VS.mw + v * K, L);
#pragma unroll
  for (int i = 1; i < H; i++)
    hm[i] = load_bits<K, W>(VS.hw + ((size_t)v * (H - 1) + i - 1) * K, L);
#pragma unroll
  for (int i = 0; i < H; i++) hf[i] = VS.hf[(size_t)v * H + i];
  unsigned m = hm[0];
#pragma unroll
  for (int k = 0; k < K; k++) x_old[k] = x[k];
  float f;
  const bool stable = as_round<K, W, true>(S, x, m, P.s.cont_cg, P.s.inner,
                                           P.s.add_k, &f);
  bool stalled = false;
#pragma unroll
  for (int i = 0; i < H; i++)
    stalled |= __all_sync(L.mask(), m == hm[i]) &&
               f >= hf[i] - P.stall * fabsf(hf[i]);
  // the anchor moves where the objective falls beyond the tolerance (f is
  // the same on the group's lanes)
  const float fa = VS.af[v], floor_a = fa - P.stall * fabsf(fa);
  stalled |= __all_sync(L.mask(), m == load_bits<K, W>(VS.aw + v * K, L)) &&
             f >= floor_a;
  if (f < floor_a) {
    store_bits<K, W>(VS.aw + v * K, m, L);
    if (L.lane == 0) VS.af[v] = f;
  }
  float d = 0.f;
#pragma unroll
  for (int k = 0; k < K; k++) d = fmaxf(d, fabsf(x[k] - x_old[k]));
  dx = group_max<W>(d, L.mask());
  store_row<K, W>(xv, P.n, L.lane, x);
  store_bits<K, W>(VS.mw + v * K, m, L);
#pragma unroll
  for (int i = 0; i < H - 1; i++)
    store_bits<K, W>(VS.hw + ((size_t)v * (H - 1) + i) * K, hm[i], L);
  if (L.lane == 0) {
    VS.hf[(size_t)v * H] = f;
#pragma unroll
    for (int i = 1; i < H; i++) VS.hf[(size_t)v * H + i] = hf[i - 1];
  }
  return stable ? 2 : stalled ? 1 : 0;
}

template <int K, int W>
__device__ __forceinline__ void polish(const QpParams& P, const float* Gs,
                                       const VoxState& VS, int v, size_t vox,
                                       const Lanes<W>& L) {
  Stage<K, W> S;
  load_stage<K, W>(S, P, Gs, VS, v, vox, L);
  float x[K];
  load_row<K, W>(VS.xs + (size_t)v * P.n, P.n, L.lane, x);
  unsigned m = load_bits<K, W>(VS.mw + v * K, L);
  inner_solve<K, W>(S, x, m, P.s.polish);
#pragma unroll
  for (int k = 0; k < K; k++) x[k] = fmaxf(x[k], 0.f);
  store_row<K, W>(P.x + vox * P.n, P.n, L.lane, x);
}

// the lockstep path's scheduled(): the voxels v0 + s*ngt (s < V) of a
// batch, those below M live, from their loads to their state on chip;
// folds each live voxel's stability after its last round into g_stable
// and its scale into g_scale, as the kernel folds scheduled()'s
template <int V>
__device__ __forceinline__ void ls_scheduled(const QpParams& P,
                                             const Dense& D, float step,
                                             const VoxState& VS, int v0,
                                             int ngt, size_t base,
                                             const Lanes<32>& L,
                                             bool& g_stable, float& g_scale) {
  const int n = P.n, lane = L.lane;
  unsigned live = 0u, cm = 0u, m = 0u;
  float b[V][1], x[V][1];
#pragma unroll
  for (int s = 0; s < V; s++) {
    if (v0 + s * ngt < P.M) live |= 1u << s;
    const size_t off = (base + v0 + s * ngt) * n;
    const bool in = on(live, s) && lane < n &&
                    (!P.mask || P.mask[off + lane] != 0.f);
    if (in) cm |= 1u << s;
    b[s][0] = in ? P.b[off + lane] : 0.f;
  }
  if (P.m0) {
#pragma unroll
    for (int s = 0; s < V; s++) {
      const size_t off = (base + v0 + s * ngt) * n;
      x[s][0] = on(cm, s) && P.x0 ? P.x0[off + lane] : 0.f;
      if (on(cm, s) && P.m0[off + lane] != 0.f) m |= 1u << s;
    }
  } else if (P.s.fista > 0) {
    ls_fista<V>(D, b, cm, P.lam1, P.lam2, step, P.s.fista, x);
  } else {
#pragma unroll
    for (int s = 0; s < V; s++) x[s][0] = 0.f;
  }
  if (P.s.rounds == 0) {
#pragma unroll
    for (int s = 0; s < V; s++)
      if (on(live, s))
        store_row<1, 32>(P.x + (base + v0 + s * ngt) * n, n, lane, x[s]);
    return;
  }
  if (!P.m0) {
#pragma unroll
    for (int s = 0; s < V; s++)
      if (x[s][0] > 0.f && on(cm, s)) m |= 1u << s;
  }
  // the stage, the scale stored and folded at once; the history of the
  // stall test goes to the state on chip round by round (scheduled() keeps
  // it in registers and stores it at the end: the same words and
  // objectives), lane 0 writing it
  constexpr int H = QP_STALL_ROUNDS;
  LsStage<V> S;
  S.cm = 0u;
#pragma unroll
  for (int s = 0; s < V; s++) {
    Stage<1, 32> S1;
    float b1[1] = {b[s][0]};
    stage_init<1, 32>(S1, D.Gr, P.lam1, P.lam2, b1, on(cm, s) ? 1u : 0u, L);
    ls_take<V>(S, s, S1);
    if (!on(live, s)) continue;
    const int v = v0 + s * ngt;
    g_scale = fmaxf(g_scale, S1.scale);
    if (lane != 0) continue;
    VS.sc[v] = S1.scale;
#pragma unroll
    for (int i = 0; i < H - 1; i++) VS.hw[(size_t)v * (H - 1) + i] = 0u;
#pragma unroll
    for (int i = 0; i < H; i++) VS.hf[(size_t)v * H + i] = QP_BIG;
  }
  unsigned stable = 0u;
  for (int r = 0; r < P.s.rounds; r++) {
#pragma unroll
    for (int s = 0; s < V; s++) {
      if (!on(live, s)) continue;
      unsigned* hw = VS.hw + (size_t)(v0 + s * ngt) * (H - 1);
      const unsigned word = __ballot_sync(FULL, on(m, s));
      if (lane == 0) {
#pragma unroll
        for (int i = H - 2; i > 0; i--) hw[i] = hw[i - 1];
        hw[0] = word;
      }
    }
    float f[V];
    stable = ls_as_round<V, true>(D, S, x, m, P.s.cg[min(r, QP_MAXR - 1)],
                                  P.s.inner, P.s.add_k, f);
#pragma unroll
    for (int s = 0; s < V; s++) {
      if (!on(live, s) || lane != 0) continue;
      float* hf = VS.hf + (size_t)(v0 + s * ngt) * H;
#pragma unroll
      for (int i = H - 1; i > 0; i--) hf[i] = hf[i - 1];
      hf[0] = f[s];
    }
  }
#pragma unroll
  for (int s = 0; s < V; s++) {
    if (!on(live, s)) continue;
    g_stable &= on(stable, s);
    const int v = v0 + s * ngt;
    float bs[1] = {S.beff[s]};
    store_row<1, 32>(VS.xs + (size_t)v * n, n, lane, x[s]);
    if (VS.bs) store_row<1, 32>(VS.bs + (size_t)v * n, n, lane, bs);
    store_bits<1, 32>(VS.mw + v, on(m, s), L);
    store_bits<1, 32>(VS.cw + v, on(cm, s), L);
    store_bits<1, 32>(VS.aw + v, on(m, s), L);
    if (lane == 0) VS.af[v] = VS.hf[(size_t)v * H];
  }
}

// the stage and x of the live voxels of a batch, read back from the state
// on chip (load_stage), and their working sets; a slot past M gets no
// coefficient that may enter and x = 0
template <int V>
__device__ __forceinline__ unsigned ls_load(const QpParams& P,
                                            const Dense& D,
                                            const VoxState& VS, int v0,
                                            int ngt, size_t base,
                                            const Lanes<32>& L,
                                            LsStage<V>& S, float (&x)[V][1],
                                            unsigned& m) {
  unsigned live = 0u;
  S.l2 = P.lam2;
  S.cm = 0u;
  m = 0u;
#pragma unroll
  for (int s = 0; s < V; s++) {
    const int v = v0 + s * ngt;
    S.beff[s] = 0.f;
    S.gate[s] = 0.f;
    x[s][0] = 0.f;
    if (v >= P.M) continue;
    live |= 1u << s;
    Stage<1, 32> S1;
    load_stage<1, 32>(S1, P, D.Gr, VS, v, base + v, L);
    ls_take<V>(S, s, S1);
    load_row<1, 32>(VS.xs + (size_t)v * P.n, P.n, L.lane, x[s]);
    m |= load_bits<1, 32>(VS.mw + v, L) << s;
  }
  return live;
}

// the lockstep path's cont_round() on a batch: folds each live voxel's
// level into gl and its |dx| into gdx, as the kernel folds cont_round()'s
template <int V>
__device__ __forceinline__ void ls_cont_round(const QpParams& P,
                                              const Dense& D,
                                              const VoxState& VS, int v0,
                                              int ngt, size_t base,
                                              const Lanes<32>& L, int& gl,
                                              float& gdx) {
  constexpr int H = QP_STALL_ROUNDS;
  const int n = P.n;
  LsStage<V> S;
  float x[V][1];
  unsigned m;
  const unsigned live = ls_load<V>(P, D, VS, v0, ngt, base, L, S, x, m);
  float f[V];
  const unsigned stable = ls_as_round<V, true>(D, S, x, m, P.s.cont_cg,
                                               P.s.inner, P.s.add_k, f);
  // the round changed no state on chip yet: the history, the anchor and
  // x before the round are read from it now (cont_round() reads them
  // before the round)
#pragma unroll
  for (int s = 0; s < V; s++) {
    if (!on(live, s)) continue;
    const int v = v0 + s * ngt;
    const unsigned ms = on(m, s);
    // the sets after the last H rounds, the latest first, and their
    // objectives
    unsigned hm[H];
    float hf[H];
    hm[0] = load_bits<1, 32>(VS.mw + v, L);
#pragma unroll
    for (int i = 1; i < H; i++)
      hm[i] = load_bits<1, 32>(VS.hw + (size_t)v * (H - 1) + i - 1, L);
#pragma unroll
    for (int i = 0; i < H; i++) hf[i] = VS.hf[(size_t)v * H + i];
    bool stalled = false;
#pragma unroll
    for (int i = 0; i < H; i++)
      stalled |= __all_sync(FULL, ms == hm[i]) &&
                 f[s] >= hf[i] - P.stall * fabsf(hf[i]);
    // the anchor moves where the objective falls beyond the tolerance
    const float fa = VS.af[v], floor_a = fa - P.stall * fabsf(fa);
    stalled |= __all_sync(FULL, ms == load_bits<1, 32>(VS.aw + v, L)) &&
               f[s] >= floor_a;
    if (f[s] < floor_a) {
      store_bits<1, 32>(VS.aw + v, ms, L);
      if (L.lane == 0) VS.af[v] = f[s];
    }
    float x_old[1];
    load_row<1, 32>(VS.xs + (size_t)v * n, n, L.lane, x_old);
    float d = 0.f;
    d = fmaxf(d, fabsf(x[s][0] - x_old[0]));
    gdx = fmaxf(gdx, group_max<32>(d, FULL));
    store_row<1, 32>(VS.xs + (size_t)v * n, n, L.lane, x[s]);
    store_bits<1, 32>(VS.mw + v, ms, L);
#pragma unroll
    for (int i = 0; i < H - 1; i++)
      store_bits<1, 32>(VS.hw + (size_t)v * (H - 1) + i, hm[i], L);
    if (L.lane == 0) {
      VS.hf[(size_t)v * H] = f[s];
#pragma unroll
      for (int i = 1; i < H; i++) VS.hf[(size_t)v * H + i] = hf[i - 1];
    }
    gl = min(gl, on(stable, s) ? 2 : stalled ? 1 : 0);
  }
}

// the lockstep path's polish() on a batch
template <int V>
__device__ __forceinline__ void ls_polish(const QpParams& P, const Dense& D,
                                          const VoxState& VS, int v0,
                                          int ngt, size_t base,
                                          const Lanes<32>& L) {
  LsStage<V> S;
  float x[V][1];
  unsigned m;
  const unsigned live = ls_load<V>(P, D, VS, v0, ngt, base, L, S, x, m);
  ls_inner_solve<V>(D, S, x, m, P.s.polish);
#pragma unroll
  for (int s = 0; s < V; s++) {
    if (!on(live, s)) continue;
    x[s][0] = fmaxf(x[s][0], 0.f);
    store_row<1, 32>(P.x + (base + v0 + s * ngt) * P.n, P.n, L.lane, x[s]);
  }
}

// a tile's per-voxel state in dynamic shared memory from `at` (see Layout)
template <int K>
__device__ __forceinline__ VoxState vox_state(float* at, const QpParams& P,
                                              size_t base) {
  const int M = P.M;
  VoxState VS;
  VS.mw = reinterpret_cast<unsigned*>(at);
  VS.cw = VS.mw + M * K;
  VS.hw = VS.cw + M * K;
  VS.aw = VS.hw + M * (QP_STALL_ROUNDS - 1) * K;
  VS.sc = reinterpret_cast<float*>(VS.aw + M * K);
  VS.hf = VS.sc + M;
  VS.af = VS.hf + M * QP_STALL_ROUNDS;
  float* rows = VS.af + M;
  VS.xs = P.state >= 1 ? rows : P.x + base * P.n;
  VS.bs = P.state == 2 ? rows + (size_t)M * P.n : nullptr;
  return VS;
}

// what both kernels do after the scheduled rounds: the tile's vote on them
// (g_stable, g_scale: the AND and max over the thread's voxels), the
// continuation rounds while the tile is not done (round(gl, gdx) runs one
// on the thread's voxels, folding their least level into gl and their
// largest |dx| into gdx), the tile's counts, then polish() on its voxels
template <int NW, int CS, class Round, class Polish>
__device__ __forceinline__ void tile_tail(const QpParams& P, int c, int rank,
                                          bool g_stable, float g_scale,
                                          float* red, float* slots, int warp,
                                          int wlane, Round round,
                                          Polish polish) {
  const bool lead = threadIdx.x == 0 && rank == 0;  // writes the counts
  if (P.s.rounds == 0) {
    if (lead && P.tile_rounds) P.tile_rounds[c] = 0;
    if (lead && P.tile_exits) P.tile_exits[c] = TAIL_OFF;
    return;
  }
  float xtol = g_scale;
  bool done = tile_vote<NW, CS>(g_stable, xtol, red, slots, 0, warp, wlane);
  xtol *= QP_TOL;
  int used = 0;       // continuation rounds run (the same in every thread)
  int exit = TAIL_OFF;
  if (P.s.cont_cg > 0) {
    exit = done ? TAIL_STABLE : TAIL_CAP;
    for (; used < P.s.cont_rounds && !done; used++) {
      int gl = 2;
      float gdx = 0.f;
      round(gl, gdx);
      const int lvl = tile_level<NW, CS, 2>(gl, gdx, red, slots, used + 1,
                                            warp, wlane);
      done = lvl > 0 || gdx <= xtol;
      if (done)
        exit = lvl == 2 ? TAIL_STABLE : lvl == 1 ? TAIL_STALLED : TAIL_XTOL;
    }
  }
  if (lead && P.tile_rounds) P.tile_rounds[c] = used;
  if (lead && P.tile_exits) P.tile_exits[c] = exit;
  // no block leaves while another may still read its slots
  if (CS > 1) coop::this_cluster().sync();
  // every path above ends in a block barrier after the last state write
  polish();
}

// one tile per cluster of CS blocks (one block when CS = 1)
template <int W, int K, int NW, int CS>
__global__ void __launch_bounds__(NW * 32, MINB)
nneg_qp_kernel(const QpParams P) {
  extern __shared__ float smem[];
  __shared__ float red[NW];
  __shared__ float slots[4];
  __shared__ float s_step;
  constexpr int LDG = 32 * K;       // Gram row stride
  constexpr int GPW = 32 / W;       // groups a warp
  constexpr int NG = NW * GPW;      // groups a block
  constexpr int NGT = CS * NG;      // groups a tile
  const int n = P.n, M = P.M, c = blockIdx.x / CS, tid = threadIdx.x;
  const int warp = tid >> 5, wlane = tid & 31;
  const Lanes<W> L = lanes_of<W>(wlane);
  const int rank = CS > 1 ? (int)coop::this_cluster().block_rank() : 0;
  const int grp = rank * NG + warp * GPW + wlane / W;   // in the tile
  const size_t base = (size_t)c * M;
  float* Gs = smem;
  const VoxState VS = vox_state<K>(Gs + n * LDG, P, base);
  // transposed and replicated: Gs[j*LDG + 32k + l] = G[(l mod W) + Wk][j]
  const float* G = P.G + (size_t)c * n * n;
  for (int e = tid; e < n * LDG; e += blockDim.x) {
    const int j = e / LDG, r = e - j * LDG;
    const int i = (r & 31) % W + W * (r >> 5);
    Gs[e] = i < n ? G[(size_t)i * n + j] : 0.f;
  }
  __syncthreads();
  float step = 0.f;
  if (!P.m0 && P.s.fista > 0) {
    if (grp == rank * NG) {
      const float Lc = lipschitz<K, W>(Gs, n, L);
      if (L.lane == 0) s_step = 1.f / (Lc + P.lam2 + 1e-30f);
    }
    __syncthreads();
    step = s_step;
  }
  bool g_stable = true;
  float g_scale = 0.f;
  for (int v = grp; v < M; v += NGT) {
    float sc;
    g_stable &= scheduled<K, W>(P, Gs, step, VS, v, base + v, L, sc);
    g_scale = fmaxf(g_scale, sc);
  }
  tile_tail<NW, CS>(
      P, c, rank, g_stable, g_scale, red, slots, warp, wlane,
      [&](int& gl, float& gdx) {
        for (int v = grp; v < M; v += NGT) {
          float dx;
          gl = min(gl, cont_round<K, W>(P, Gs, VS, v, base + v, L, dx));
          gdx = fmaxf(gdx, dx);
        }
      },
      [&]() {
        for (int v = grp; v < M; v += NGT)
          polish<K, W>(P, Gs, VS, v, base + v, L);
      });
}

// the lockstep path, 17 <= n <= 32: one tile per cluster of CS blocks of NW
// warps; warp g of the tile takes its voxels g, g + NGT, ... V at a time
// (qp_lockstep.cuh).  Dynamic shared memory holds G row-major at LS_LD (32
// rows, zero past n), then each warp's scratch (V rows of 32 floats), then
// the per-voxel state as nneg_qp_kernel keeps it
template <int V, int NW, int CS>
__global__ void __launch_bounds__(NW * 32, MINB)
nneg_qp_lockstep(const QpParams P) {
  extern __shared__ __align__(16) float ls_smem[];
  __shared__ float red[NW];
  __shared__ float slots[4];
  __shared__ float s_step;
  constexpr int NGT = CS * NW;      // warps a tile
  const int n = P.n, M = P.M, c = blockIdx.x / CS, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const Lanes<32> L = lanes_of<32>(lane);
  const int rank = CS > 1 ? (int)coop::this_cluster().block_rank() : 0;
  const int grp = rank * NW + warp;   // in the tile
  const size_t base = (size_t)c * M;
  float* Gr = ls_smem;
  float* scratch = Gr + 32 * LS_LD;
  const VoxState VS = vox_state<1>(scratch + NW * V * 32, P, base);
  const float* G = P.G + (size_t)c * n * n;
  for (int e = tid; e < 32 * LS_LD; e += NW * 32) {
    const int i = e / LS_LD, j = e - i * LS_LD;
    Gr[e] = i < n && j < n ? G[(size_t)i * n + j] : 0.f;
  }
  __syncthreads();
  Dense D;
  D.Gr = Gr;
  D.scr = scratch + warp * V * 32;
  D.nb = (n + 3) >> 2;
  D.lane = lane;
  float step = 0.f;
  if (!P.m0 && P.s.fista > 0) {
    if (warp == 0) {
      const float Lc = ls_lipschitz(D, n, L);
      if (lane == 0) s_step = 1.f / (Lc + P.lam2 + 1e-30f);
    }
    __syncthreads();
    step = s_step;
  }
  bool g_stable = true;
  float g_scale = 0.f;
  for (int v0 = grp; v0 < M; v0 += V * NGT)
    ls_scheduled<V>(P, D, step, VS, v0, NGT, base, L, g_stable, g_scale);
  tile_tail<NW, CS>(
      P, c, rank, g_stable, g_scale, red, slots, warp, lane,
      [&](int& gl, float& gdx) {
        for (int v0 = grp; v0 < M; v0 += V * NGT)
          ls_cont_round<V>(P, D, VS, v0, NGT, base, L, gl, gdx);
      },
      [&]() {
        for (int v0 = grp; v0 < M; v0 += V * NGT)
          ls_polish<V>(P, D, VS, v0, NGT, base, L);
      });
}

template <class Kernel>
static int launch_tiles(Kernel kernel, int threads, int cs,
                        const QpParams& P, int C, size_t smem,
                        cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (cs == 1) {
    kernel<<<C, threads, smem, st>>>(P);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * cs);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, P);
}

template <int W, int K, int NW, int CS = 1>
static int launch(const QpParams& P, int C, size_t smem, cudaStream_t st) {
  return launch_tiles(nneg_qp_kernel<W, K, NW, CS>, NW * 32, CS, P, C, smem,
                      st);
}

extern "C" {

// sched: [fista, rounds, inner, add_k, polish, cont_cg, cont_rounds,
// cg[QP_MAXR]] (host); round r runs cg[min(r, QP_MAXR - 1)].  tile_rounds,
// tile_exits: (C,) int32 on the device for each tile's continuation rounds
// and what ended them (TailExit), or null.  stall: the stall test's
// tolerance
int nneg_qp_launch(const void* G, const void* b, const void* mask,
                   const void* m0, const void* x0, void* x,
                   void* tile_rounds, void* tile_exits, int C, int M, int n,
                   float lam1, float lam2, float stall, const void* sched,
                   void* stream) {
  if (n < 1 || n > 32 * QP_MAXK) return (int)cudaErrorInvalidValue;
  QpParams P;
  P.G = (const float*)G;
  P.b = (const float*)b;
  P.mask = (const float*)mask;
  P.m0 = (const float*)m0;
  P.x0 = (const float*)x0;
  P.x = (float*)x;
  P.tile_rounds = (int*)tile_rounds;
  P.tile_exits = (int*)tile_exits;
  P.M = M;
  P.n = n;
  P.lam1 = lam1;
  P.lam2 = lam2;
  P.stall = stall;
  const int* s = (const int*)sched;
  P.s.fista = s[0];
  P.s.rounds = s[1];
  P.s.inner = s[2];
  P.s.add_k = s[3];
  P.s.polish = s[4];
  P.s.cont_cg = s[5];
  P.s.cont_rounds = s[6];
  for (int r = 0; r < QP_MAXR; r++) P.s.cg[r] = s[7 + r];
  if (P.s.fista < 0 || P.s.rounds < 0 || P.s.inner < 0 || P.s.add_k < 1)
    return (int)cudaErrorInvalidValue;
  if (C == 0 || M == 0) return 0;
  // group width and coefficients a lane; G (on the lockstep path, 17 <= n
  // <= 32: G row-major and each warp's scratch), then M voxels' sets of
  // words (working set, mask, history, anchor), scale and objectives, then
  // (as they fit) their x and b_eff
  const int W = n <= 8 ? 8 : n <= 16 ? 16 : 32;
  const int K = (n + W - 1) / W;
  const bool lockstep = W == 32 && K == 1;
  const size_t words =
      (lockstep ? (size_t)32 * LS_LD + (size_t)QP_LS_WARPS * QP_LS_V * 32
                : (size_t)n * 32 * K) +
      (size_t)M * ((QP_STALL_ROUNDS + 2) * K + QP_STALL_ROUNDS + 2);
  const size_t rows = (size_t)M * n;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t avail = optin > QP_SMEM_RESERVE
                           ? (size_t)(optin - QP_SMEM_RESERVE) / sizeof(float)
                           : 0;
  P.state = words + 2 * rows <= avail ? 2 : words + rows <= avail ? 1 : 0;
  const size_t smem = (words + P.state * rows) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (W == 8) return launch<8, 1, NWARPS, QP_CLUSTER>(P, C, smem, st);
  if (W == 16) return launch<16, 1, NWARPS, QP_CLUSTER>(P, C, smem, st);
  if (lockstep)
    return launch_tiles(nneg_qp_lockstep<QP_LS_V, QP_LS_WARPS, QP_CLUSTER>,
                        QP_LS_WARPS * 32, QP_CLUSTER, P, C, smem, st);
  switch (K) {
    case 2: return launch<32, 2, NWARPS_WIDE>(P, C, smem, st);
    case 3: return launch<32, 3, NWARPS_WIDE>(P, C, smem, st);
    case 4: return launch<32, 4, NWARPS_WIDE>(P, C, smem, st);
    default: return launch<32, 5, NWARPS_WIDE>(P, C, smem, st);
  }
}

}  // extern "C"
