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
//
// Layout.  One block of QP_NWARPS warps per tile, one warp per voxel,
// looping over the tile's voxels; K = ceil(n/32) coefficients per lane
// (n <= 160), one instantiation per K.  G lives transposed in dynamic
// shared memory (csrc/qp_warp.cuh).  The tile's voxels meet only at the
// `converge` test, so every voxel's working set is kept in shared memory
// (K ballot words) and its iterate in the output tensor (each lane touches
// only its own entries) between the block-wide rounds; "done" is a
// __syncthreads_and over the warps' stability and a shared max of their
// |dx|.
//
// What bounds it.  Not memory: a tile reads G (n*n floats) and b once and
// writes x once.  FreeWater's n = 11 leaves G at 1.4 KB of shared memory,
// and each CG step is a chain of dependent warp shuffles (the ballot-driven
// sparse matvec, two dot products), so a warp waits on shuffle latency and
// uses 11 of its 32 lanes.  The design answers with occupancy: small
// blocks of 16 warps, several resident per SM, so other warps' chains fill
// the wait.
#include <cuda_runtime.h>

#include "qp_warp.cuh"

#define QP_MAXK 5         // coefficients per lane: n <= 160
#define QP_MAXR 32        // per-round CG budgets; later rounds reuse the last
#define QP_NWARPS 16      // warps per block (voxels in flight per tile)

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
  float* x;           // (C, M, n): the result, and each voxel's iterate
  int M, n;
  float lam1, lam2;
  QpSched s;
};

template <int K>
__device__ __forceinline__ void load_voxel(const QpParams& P, size_t vox,
                                           int lane, float (&b)[K],
                                           unsigned& cmask) {
  cmask = 0;
#pragma unroll
  for (int k = 0; k < K; k++) {
    const int i = lane + 32 * k;
    const bool on = i < P.n && (!P.mask || P.mask[vox * P.n + i] != 0.f);
    if (on) cmask |= 1u << k;
    b[k] = on ? P.b[vox * P.n + i] : 0.f;
  }
}

template <int K>
__device__ __forceinline__ void load_x(const QpParams& P, size_t vox,
                                       int lane, float (&x)[K]) {
#pragma unroll
  for (int k = 0; k < K; k++) {
    const int i = lane + 32 * k;
    x[k] = i < P.n ? P.x[vox * P.n + i] : 0.f;
  }
}

template <int K>
__device__ __forceinline__ void store_x(const QpParams& P, size_t vox,
                                        int lane, const float (&x)[K]) {
#pragma unroll
  for (int k = 0; k < K; k++) {
    const int i = lane + 32 * k;
    if (i < P.n) P.x[vox * P.n + i] = x[k];
  }
}

template <int K>
__device__ __forceinline__ void store_m(unsigned* mw, unsigned m, int lane) {
#pragma unroll
  for (int k = 0; k < K; k++) {
    const unsigned w = __ballot_sync(FULL, bit(m, k));
    if (lane == 0) mw[k] = w;
  }
}

template <int K>
__device__ __forceinline__ unsigned load_m(const unsigned* mw, int lane) {
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < K; k++) m |= ((mw[k] >> lane) & 1u) << k;
  return m;
}

// L = v'Gv * 1.01 + 1e-30 after 10 power iterations from ones (one warp)
template <int K>
__device__ __forceinline__ float lipschitz(const float* Gs, int n, int lane) {
  float v[K], w[K];
#pragma unroll
  for (int k = 0; k < K; k++) v[k] = lane + 32 * k < n ? 1.f : 0.f;
  for (int it = 0; it < 10; it++) {
    gmv<K>(Gs, v, w, lane);
    const float nrm = sqrtf(vdot<K>(w, w)) + 1e-30f;
#pragma unroll
    for (int k = 0; k < K; k++) v[k] = w[k] / nrm;
  }
  gmv<K>(Gs, v, w, lane);
  return vdot<K>(v, w) * 1.01f + 1e-30f;
}

// FISTA from zero with adaptive restart; b is zero outside cmask
template <int K>
__device__ __forceinline__ void fista(const float* Gs, const float (&b)[K],
                                      unsigned cmask, float l1, float l2,
                                      float step, int iters, float (&x)[K],
                                      int lane) {
  float z[K], Gz[K], xn[K];
#pragma unroll
  for (int k = 0; k < K; k++) x[k] = z[k] = 0.f;
  float t = 1.f;
  for (int it = 0; it < iters; it++) {
    gmv<K>(Gs, z, Gz, lane);
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < K; k++) {
      const float grad = Gz[k] - b[k] + l2 * z[k];
      xn[k] = bit(cmask, k) ? fmaxf(z[k] - step * (grad + l1), 0.f) : 0.f;
      part += (z[k] - xn[k]) * (xn[k] - x[k]);
    }
    const bool restart = warp_sum(part) > 0.f;
    const float t_new = 0.5f * (1.f + sqrtf(1.f + 4.f * t * t));
    const float beta = restart ? 0.f : (t - 1.f) / t_new;
    t = restart ? 1.f : t_new;
#pragma unroll
    for (int k = 0; k < K; k++) {
      z[k] = xn[k] + beta * (xn[k] - x[k]);
      x[k] = xn[k];
    }
  }
}

// warm start and the scheduled rounds of one voxel; returns whether its
// last round left it stable, and its scale (max|b_eff| + 1e-30)
template <int K>
__device__ __forceinline__ bool scheduled(const QpParams& P, const float* Gs,
                                          float step, size_t vox, int lane,
                                          unsigned* mw, float& scale) {
  float b[K], x[K];
  unsigned cmask;
  load_voxel<K>(P, vox, lane, b, cmask);
  unsigned m = 0;
  if (P.m0) {
#pragma unroll
    for (int k = 0; k < K; k++) {
      const int i = lane + 32 * k;
      const bool on = bit(cmask, k);
      x[k] = on && P.x0 ? P.x0[vox * P.n + i] : 0.f;
      if (on && P.m0[vox * P.n + i] != 0.f) m |= 1u << k;
    }
  } else if (P.s.fista > 0) {
    fista<K>(Gs, b, cmask, P.lam1, P.lam2, step, P.s.fista, x, lane);
  } else {
#pragma unroll
    for (int k = 0; k < K; k++) x[k] = 0.f;
  }
  scale = 0.f;
  if (P.s.rounds == 0) {
    store_x<K>(P, vox, lane, x);
    return true;
  }
  if (!P.m0) {
#pragma unroll
    for (int k = 0; k < K; k++)
      if (x[k] > 0.f && bit(cmask, k)) m |= 1u << k;
  }
  Stage<K> S;
  stage_init<K>(S, Gs, P.lam1, P.lam2, b, cmask);
  bool stable = false;
  for (int r = 0; r < P.s.rounds; r++)
    stable = as_round<K>(S, x, m, P.s.cg[min(r, QP_MAXR - 1)], P.s.inner,
                         P.s.add_k, lane);
  store_x<K>(P, vox, lane, x);
  store_m<K>(mw, m, lane);
  scale = S.scale;
  return stable;
}

// one continuation round of one voxel; returns its stability, and the
// largest |dx| of the round in dx
template <int K>
__device__ __forceinline__ bool cont_round(const QpParams& P, const float* Gs,
                                           size_t vox, int lane, unsigned* mw,
                                           float& dx) {
  float b[K], x[K], x_old[K];
  unsigned cmask;
  load_voxel<K>(P, vox, lane, b, cmask);
  Stage<K> S;
  stage_init<K>(S, Gs, P.lam1, P.lam2, b, cmask);
  load_x<K>(P, vox, lane, x);
  unsigned m = load_m<K>(mw, lane);
#pragma unroll
  for (int k = 0; k < K; k++) x_old[k] = x[k];
  const bool stable = as_round<K>(S, x, m, P.s.cont_cg, P.s.inner, P.s.add_k,
                                  lane);
  float d = 0.f;
#pragma unroll
  for (int k = 0; k < K; k++) d = fmaxf(d, fabsf(x[k] - x_old[k]));
  dx = warp_max(d);
  store_x<K>(P, vox, lane, x);
  store_m<K>(mw, m, lane);
  return stable;
}

template <int K>
__device__ __forceinline__ void polish(const QpParams& P, const float* Gs,
                                       size_t vox, int lane,
                                       const unsigned* mw) {
  float b[K], x[K];
  unsigned cmask;
  load_voxel<K>(P, vox, lane, b, cmask);
  Stage<K> S;
  stage_init<K>(S, Gs, P.lam1, P.lam2, b, cmask);
  load_x<K>(P, vox, lane, x);
  unsigned m = load_m<K>(mw, lane);
  inner_solve<K>(S, x, m, P.s.polish, lane);
#pragma unroll
  for (int k = 0; k < K; k++) x[k] = fmaxf(x[k], 0.f);
  store_x<K>(P, vox, lane, x);
}

// max of a warp-uniform value over the block (every thread must call it)
__device__ __forceinline__ float block_max(float v, float* red, int warp,
                                           int lane) {
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < QP_NWARPS; w++) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

template <int K>
__global__ void __launch_bounds__(QP_NWARPS * 32)
nneg_qp_kernel(const QpParams P) {
  extern __shared__ float smem[];
  __shared__ float red[QP_NWARPS];
  __shared__ float s_step;
  constexpr int LDG = 32 * K;
  float* Gs = smem;
  unsigned* mw = reinterpret_cast<unsigned*>(smem + P.n * LDG);
  const int c = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // transpose into shared memory: Gs[j*LDG + i] = G[i][j], zero for i >= n
  const float* G = P.G + (size_t)c * P.n * P.n;
  for (int e = tid; e < P.n * LDG; e += blockDim.x) {
    const int j = e / LDG, i = e - j * LDG;
    Gs[e] = i < P.n ? G[(size_t)i * P.n + j] : 0.f;
  }
  __syncthreads();
  float step = 0.f;
  if (!P.m0 && P.s.fista > 0) {
    if (warp == 0) {
      const float L = lipschitz<K>(Gs, P.n, lane);
      if (lane == 0) s_step = 1.f / (L + P.lam2 + 1e-30f);
    }
    __syncthreads();
    step = s_step;
  }
  const size_t base = (size_t)c * P.M;
  bool w_stable = true;
  float w_scale = 0.f;
  for (int v = warp; v < P.M; v += QP_NWARPS) {
    float sc;
    w_stable &= scheduled<K>(P, Gs, step, base + v, lane, mw + v * K, sc);
    w_scale = fmaxf(w_scale, sc);
  }
  if (P.s.rounds == 0) return;
  bool done = __syncthreads_and(w_stable);
  if (P.s.cont_cg > 0) {
    const float xtol = QP_TOL * block_max(w_scale, red, warp, lane);
    for (int i = 0; i < P.s.cont_rounds && !done; i++) {
      bool ws = true;
      float wdx = 0.f;
      for (int v = warp; v < P.M; v += QP_NWARPS) {
        float dx;
        ws &= cont_round<K>(P, Gs, base + v, lane, mw + v * K, dx);
        wdx = fmaxf(wdx, dx);
      }
      const bool st = __syncthreads_and(ws);
      done = st || block_max(wdx, red, warp, lane) <= xtol;
    }
  }
  __syncthreads();
  for (int v = warp; v < P.M; v += QP_NWARPS)
    polish<K>(P, Gs, base + v, lane, mw + v * K);
}

template <int K>
static int launch(const QpParams& P, int C, size_t smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      nneg_qp_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  nneg_qp_kernel<K><<<C, QP_NWARPS * 32, smem, st>>>(P);
  return (int)cudaGetLastError();
}

extern "C" {

// sched: [fista, rounds, inner, add_k, polish, cont_cg, cont_rounds,
// cg[QP_MAXR]] (host); round r runs cg[min(r, QP_MAXR - 1)]
int nneg_qp_launch(const void* G, const void* b, const void* mask,
                   const void* m0, const void* x0, void* x, int C, int M,
                   int n, float lam1, float lam2, const void* sched,
                   void* stream) {
  if (n < 1 || n > 32 * QP_MAXK) return (int)cudaErrorInvalidValue;
  QpParams P;
  P.G = (const float*)G;
  P.b = (const float*)b;
  P.mask = (const float*)mask;
  P.m0 = (const float*)m0;
  P.x0 = (const float*)x0;
  P.x = (float*)x;
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
  const int K = (n + 31) / 32;
  const size_t smem = ((size_t)n * 32 * K + (size_t)M * K) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 1: return launch<1>(P, C, smem, st);
    case 2: return launch<2>(P, C, smem, st);
    case 3: return launch<3>(P, C, smem, st);
    case 4: return launch<4>(P, C, smem, st);
    default: return launch<5>(P, C, smem, st);
  }
}

}  // extern "C"
