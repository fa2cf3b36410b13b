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
//     is not done (at most cont_rounds): done once no voxel of the tile
//     adds an atom or changes its working set in a round, or once x moves
//     by at most tol * the tile's largest max|b_eff| anywhere in the tile.
//     The last scheduled round's stability seeds the test;
//   a final masked-CG polish at budget `polish`, then x = max(x, 0).
// Zero rounds return the FISTA iterate (or the warm start) as it is.
// Optionally (tile_rounds not null) each tile writes the number of
// continuation rounds it ran (0 without `converge`) to tile_rounds[tile]:
// the counter of the tail, read while the port is traced.
//
// Layout.  A tile is a thread block cluster of QP_CLUSTER blocks, each on
// its own SM, for n <= 32, and one block above.  A voxel is solved by a
// group of W lanes (csrc/qp_warp.cuh): W = 8 for n <= 8 (four voxels a
// warp), 16 for n <= 16 (two), 32 above (one, with K = ceil(n/32)
// coefficients a lane, n <= 160); one instantiation per (W, K).  Each block
// holds G transposed in dynamic shared memory, replicated across the row
// so that the groups of a warp read disjoint banks.  Group g of the tile
// (block rank r's groups are r*NG .. r*NG + NG-1) takes the tile's voxels
// g, g + NGT, ... (NGT groups a tile), so the groups of a warp hold
// neighbouring voxels.  Each voxel keeps its state on chip from its
// scheduled rounds through the continuation and the polish, in dynamic
// shared memory after G: its working-set and coefficient-mask words (K
// words of W bits each), its scale max|b_eff| + 1e-30, and its x and b_eff
// (n floats each).  Where x and b_eff do not both fit beside G (large n*M;
// the wrapper's qp_geometry mirrors the rule), b_eff is recomputed from b
// each round, and then x too stays in the output tensor.  So a round reads
// no device memory, and x is written to the output once, by the polish.
// The tile's voxels meet only at the `converge` test: each block takes a
// __syncthreads_and over its groups' stability and a block max of their
// |dx|, and the blocks of a cluster exchange the two through distributed
// shared memory, one cluster barrier a round (tile_vote, qp_warp.cuh).
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
// that picked NWARPS, MINB and QP_CLUSTER).
#include <cuda_runtime.h>

#include "qp_warp.cuh"

#define QP_MAXK 5         // coefficients per lane: n <= 160
#define QP_MAXR 32        // per-round CG budgets; later rounds reuse the last
// the timed sweep's pick (PERF.md); -D overrides them for a sweep
#ifndef NWARPS
#define NWARPS 32         // warps per block for n <= 32
#endif
#ifndef MINB
#define MINB 1            // blocks resident on an SM (register budget)
#endif
#ifndef QP_CLUSTER
#define QP_CLUSTER 2      // blocks a tile for n <= 32 (a thread block cluster)
#endif
#define NWARPS_WIDE 16    // warps per block for n > 32 (K > 1 a lane), one
                          // block a tile
#define QP_SMEM_RESERVE 1024  // bytes of a block's shared memory kept for
                              // the static arrays (ops/cuda_qp.py mirrors it)

struct QpSched {
  int fista, rounds, inner, add_k, polish, cont_cg, cont_rounds;
  int cg[QP_MAXR];
};

struct QpParams {
  const float* G;     // (C, n, n)
  const float* b;     // (C, M, n)
  const float* mask;  // (C, M, n) 0/1, or null
  const float* m0;    // (C, M, n) 0/1, or null: seeds the working set
  const float* x0;    // (C, M, n), or null: with m0, CG's warm start
  float* x;           // (C, M, n): the result
  int* tile_rounds;   // (C,): each tile's continuation rounds, or null
  int M, n;
  int state;          // 2: x and b_eff in shared memory; 1: x only; 0: neither
  float lam1, lam2;
  QpSched s;
};

// a tile's per-voxel state (see Layout)
struct VoxState {
  unsigned* mw;  // (M, K) working-set words
  unsigned* cw;  // (M, K) coefficient-mask words
  float* sc;     // (M,) max|b_eff| + 1e-30
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
// stable, and its scale
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
  for (int r = 0; r < P.s.rounds; r++)
    stable = as_round<K, W>(S, x, m, P.s.cg[min(r, QP_MAXR - 1)], P.s.inner,
                            P.s.add_k);
  store_row<K, W>(VS.xs + (size_t)v * n, n, lane, x);
  if (VS.bs) store_row<K, W>(VS.bs + (size_t)v * n, n, lane, S.beff);
  store_bits<K, W>(VS.mw + v * K, m, L);
  store_bits<K, W>(VS.cw + v * K, cmask, L);
  if (lane == 0) VS.sc[v] = S.scale;
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

// one continuation round of voxel v; returns its stability, and the
// largest |dx| of the round in dx
template <int K, int W>
__device__ __forceinline__ bool cont_round(const QpParams& P, const float* Gs,
                                           const VoxState& VS, int v,
                                           size_t vox, const Lanes<W>& L,
                                           float& dx) {
  Stage<K, W> S;
  load_stage<K, W>(S, P, Gs, VS, v, vox, L);
  float* xv = VS.xs + (size_t)v * P.n;
  float x[K], x_old[K];
  load_row<K, W>(xv, P.n, L.lane, x);
  unsigned m = load_bits<K, W>(VS.mw + v * K, L);
#pragma unroll
  for (int k = 0; k < K; k++) x_old[k] = x[k];
  const bool stable = as_round<K, W>(S, x, m, P.s.cont_cg, P.s.inner,
                                     P.s.add_k);
  float d = 0.f;
#pragma unroll
  for (int k = 0; k < K; k++) d = fmaxf(d, fabsf(x[k] - x_old[k]));
  dx = group_max<W>(d, L.mask());
  store_row<K, W>(xv, P.n, L.lane, x);
  store_bits<K, W>(VS.mw + v * K, m, L);
  return stable;
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
  VoxState VS;
  VS.mw = reinterpret_cast<unsigned*>(Gs + n * LDG);
  VS.cw = VS.mw + M * K;
  VS.sc = reinterpret_cast<float*>(VS.cw + M * K);
  VS.xs = P.state >= 1 ? VS.sc + M : P.x + base * n;
  VS.bs = P.state == 2 ? VS.sc + M + (size_t)M * n : nullptr;
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
  const bool counted = P.tile_rounds && tid == 0 && rank == 0;
  if (P.s.rounds == 0) {
    if (counted) P.tile_rounds[c] = 0;
    return;
  }
  float xtol = g_scale;
  bool done = tile_vote<NW, CS>(g_stable, xtol, red, slots, 0, warp, wlane);
  xtol *= QP_TOL;
  int used = 0;       // continuation rounds run (the same in every thread)
  if (P.s.cont_cg > 0) {
    for (; used < P.s.cont_rounds && !done; used++) {
      bool gs = true;
      float gdx = 0.f;
      for (int v = grp; v < M; v += NGT) {
        float dx;
        gs &= cont_round<K, W>(P, Gs, VS, v, base + v, L, dx);
        gdx = fmaxf(gdx, dx);
      }
      const bool st = tile_vote<NW, CS>(gs, gdx, red, slots, used + 1, warp,
                                        wlane);
      done = st || gdx <= xtol;
    }
  }
  if (counted) P.tile_rounds[c] = used;
  // no block leaves while another may still read its slots
  if (CS > 1) coop::this_cluster().sync();
  // every path above ends in a block barrier after the last state write
  for (int v = grp; v < M; v += NGT)
    polish<K, W>(P, Gs, VS, v, base + v, L);
}

template <int W, int K, int NW, int CS = 1>
static int launch(const QpParams& P, int C, size_t smem, cudaStream_t st) {
  auto kernel = nneg_qp_kernel<W, K, NW, CS>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (CS == 1) {
    kernel<<<C, NW * 32, smem, st>>>(P);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * CS);
  cfg.blockDim = dim3(NW * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CS;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, P);
}

extern "C" {

// sched: [fista, rounds, inner, add_k, polish, cont_cg, cont_rounds,
// cg[QP_MAXR]] (host); round r runs cg[min(r, QP_MAXR - 1)].  tile_rounds:
// (C,) int32 on the device for each tile's continuation rounds, or null
int nneg_qp_launch(const void* G, const void* b, const void* mask,
                   const void* m0, const void* x0, void* x,
                   void* tile_rounds, int C, int M, int n, float lam1,
                   float lam2, const void* sched, void* stream) {
  if (n < 1 || n > 32 * QP_MAXK) return (int)cudaErrorInvalidValue;
  QpParams P;
  P.G = (const float*)G;
  P.b = (const float*)b;
  P.mask = (const float*)mask;
  P.m0 = (const float*)m0;
  P.x0 = (const float*)x0;
  P.x = (float*)x;
  P.tile_rounds = (int*)tile_rounds;
  P.M = M;
  P.n = n;
  P.lam1 = lam1;
  P.lam2 = lam2;
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
  // group width and coefficients a lane; G, then M voxels' words and
  // scale, then (as they fit) their x and b_eff
  const int W = n <= 8 ? 8 : n <= 16 ? 16 : 32;
  const int K = (n + W - 1) / W;
  const size_t words = (size_t)n * 32 * K + (size_t)M * (2 * K + 1);
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
  switch (K) {
    case 1: return launch<32, 1, NWARPS, QP_CLUSTER>(P, C, smem, st);
    case 2: return launch<32, 2, NWARPS_WIDE>(P, C, smem, st);
    case 3: return launch<32, 3, NWARPS_WIDE>(P, C, smem, st);
    case 4: return launch<32, 4, NWARPS_WIDE>(P, C, smem, st);
    default: return launch<32, 5, NWARPS_WIDE>(P, C, smem, st);
  }
}

}  // extern "C"
