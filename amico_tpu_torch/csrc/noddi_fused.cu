// Fused 3-stage NODDI solve per tile, for Hopper (sm_90a).
//
// Replaces the TPU kernel amico_tpu/ops/pallas_qp.py:noddi_fused_tiles_pallas
// (body _make_noddi_kernel, solver _build_as_solve).  The plain PyTorch twin
// is amico_tpu_torch/ops/cuda_qp.py:noddi_fused_tiles_torch; both compute the
// same float32 math:
//   stage 1  NNLS on the full Gram G1 from an empty working set;
//   stage 2  Y2 = max(Y_dwi - iso*x_iso [- x_dot], 0), b2 = A2' Y2, then a
//            non-negative elastic net (lam1, lam2) on G2;
//   stage 3  debias NNLS on G1 restricted to supp(x2) + {iso[, dot]}, working
//            set seeded by that mask, CG warm-started from x1.
// Each stage runs Lawson-Hanson rounds (masked CG, ratio-test step back,
// prune below tol*max|b_eff|, top-k adds), then a CG polish at the stage's
// largest budget.  The schedule arrives as kernel arguments, so one build
// serves any schedule of that form.  The per-voxel solver pieces (masked
// CG, step back and prune, adds, one round) are csrc/qp_warp.cuh, shared
// with the tile QP kernel csrc/nneg_qp.cu.
//
// Layout.  One block per tile, one warp per voxel, looping over the tile's
// voxels; lane l owns coefficients l, l+32, ..., l+128 in registers.  Dot
// products, max, min and argmax are warp shuffles.  The tile's solve runs
// in three block-wide phases, each with one Gram in dynamic shared memory
// (transposed, row stride LD = 160 floats: 92,800 bytes for the full
// 145-atom grid): G1 for stage 1, then G2 over it for stage 2, then G1
// again for stage 3.  Between phases each voxel keeps, in a scratch buffer
// in device memory, stage 1's x (na floats) and stage 2's support (KMAX
// ballot words).  The stage-2 dictionary arrives as A2 (ndwi, n_wm), so the
// lanes of a warp read neighbouring words.
//
// What bounds it.  Not memory (~175 MB a 512-tile launch, ~52 us at the
// card's rate) and not the FLOPs the inputs need (~4.3 GFLOP, ~65 us at
// 67 TFLOP/s f32; testing.solve_work counts them): each CG step of a voxel
// is a chain of dependent warp shuffles and shared-memory reads (the
// ballot-driven sparse matvec over a working set of a few atoms, two dot
// products, two divisions), so a warp waits on latency, and the SM needs
// many warps in flight to fill the waits.  With both Grams resident
// (185 KB) one 16-warp block fit on an SM; measured on the H100, 32 warps
// in that one block ran 1.42x faster (with register spills), and reading
// only the CG working set's 32-row slots of G (half the shared-memory
// reads) ran 1.24x slower: latency, not the shared-memory pipe, sets the
// pace (PERF.md).  The phase split halves the shared memory a block needs
// and the registers each phase holds live; a sweep on the H100 (PERF.md)
// then picked one block of 32 warps an SM (64 registers, 60 bytes of
// spills) over two blocks of 16 (7.3 ms against 8.1 ms a 512-tile launch;
// the one-phase kernel read 14.0).  Every float operation of a voxel is
// the one-phase kernel's, in the same order: the results are bit-identical
// to it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "qp_warp.cuh"

#define KMAX 5                 // coefficients per lane: n <= 160
#define LD (32 * KMAX)         // row stride of a Gram in shared memory
#define MAXR 32                // rounds per stage
// the timed sweep's pick (PERF.md); -D overrides them for a sweep
#ifndef NWARPS
#define NWARPS 32              // warps per block (voxels in flight per tile)
#endif
#ifndef MINB
#define MINB 1                 // blocks resident on an SM (register budget)
#endif

struct StageSched {
  int rounds, add_k, polish;
  int cg[MAXR];
  int inner[MAXR];
};

struct Params {
  const float* G1;      // (C, na, na)
  const float* G2;      // (C, n_wm, n_wm)
  const float* b1;      // (C, M, na)
  const float* Ydwi;    // (C, M, ndwi)
  const float* A2;      // (C, ndwi, n_wm)
  const float* iso_dwi; // (ndwi,)
  const float* icvf;    // (n_wm,)
  const float* kappa;   // (n_wm,)
  float* est;           // (C, M, 4): NDI, k1, FWF, dot
  float* xout;          // (C, M, na) or null
  float* x1;            // (C, M, na) scratch: stage 1's x
  unsigned* sup;        // (C, M, KMAX) scratch: stage 2's support words
  int M, na, n_wm, ndwi, exvivo;
  float lam1, lam2;
  StageSched s[3];
};

typedef float Vec[KMAX];

// one stage for one voxel: x holds the warm start on entry (zero for a cold
// start) and the solution on exit
__device__ __forceinline__ void as_solve(const float* Gs, const StageSched& sc, float l1,
                         float l2, const Vec& b, unsigned cmask, bool seed_m0,
                         Vec& x, int lane) {
  Stage<KMAX> S;
  stage_init<KMAX>(S, Gs, l1, l2, b, cmask, lanes_of<32>(lane));
  unsigned m = 0;
  if (seed_m0) {
    m = cmask;
  } else {
#pragma unroll
    for (int k = 0; k < KMAX; k++)
      if (x[k] > 0.f && bit(cmask, k)) m |= 1u << k;
  }
  for (int r = 0; r < sc.rounds; r++)
    as_round<KMAX>(S, x, m, sc.cg[r], sc.inner[r], sc.add_k);
  inner_solve<KMAX>(S, x, m, sc.polish);
#pragma unroll
  for (int k = 0; k < KMAX; k++) x[k] = fmaxf(x[k], 0.f);
}

// the block's Gram: Gs[j*LD + i] = G[i][j], zero for i >= n
__device__ __forceinline__ void load_gram(float* Gs, const float* G, int n) {
  for (int e = threadIdx.x; e < n * LD; e += blockDim.x) {
    int j = e / LD, i = e - j * LD;
    Gs[e] = i < n ? G[(size_t)i * n + j] : 0.f;
  }
}

__device__ __forceinline__ void load_b1(const Params& P, size_t vox, int lane,
                                        Vec& b) {
#pragma unroll
  for (int k = 0; k < KMAX; k++) {
    int i = lane + 32 * k;
    b[k] = i < P.na ? P.b1[vox * P.na + i] : 0.f;
  }
}

__device__ __forceinline__ void stage1(const Params& P, const float* G1s,
                                       size_t vox, int lane) {
  Vec b, x1;
  unsigned pad1 = 0;
  load_b1(P, vox, lane, b);
#pragma unroll
  for (int k = 0; k < KMAX; k++) {
    if (lane + 32 * k < P.na) pad1 |= 1u << k;
    x1[k] = 0.f;
  }
  as_solve(G1s, P.s[0], 0.f, 0.f, b, pad1, false, x1, lane);
#pragma unroll
  for (int k = 0; k < KMAX; k++) {
    int i = lane + 32 * k;
    if (i < P.na) P.x1[vox * P.na + i] = x1[k];
  }
}

__device__ __forceinline__ void stage2(const Params& P, const float* G2s,
                                       int c, size_t vox, int lane) {
  const int na = P.na, n_wm = P.n_wm, ndwi = P.ndwi;
  const float x_iso = P.x1[vox * na + na - 1];
  const float x_dot = P.exvivo ? P.x1[vox * na + na - 2] : 0.f;
  Vec b2, x2;
  unsigned pad2 = 0;
#pragma unroll
  for (int k = 0; k < KMAX; k++) {
    if (lane + 32 * k < n_wm) pad2 |= 1u << k;
    b2[k] = 0.f;
    x2[k] = 0.f;
  }
  const float* Y = P.Ydwi + vox * ndwi;
  const float* A2 = P.A2 + (size_t)c * ndwi * n_wm;
  for (int s = 0; s < ndwi; s++) {
    float y2 = Y[s] - P.iso_dwi[s] * x_iso;
    if (P.exvivo) y2 -= x_dot;
    y2 = fmaxf(y2, 0.f);
    const float* a = A2 + (size_t)s * n_wm + lane;
#pragma unroll
    for (int k = 0; k < KMAX; k++)
      if (lane + 32 * k < n_wm) b2[k] = fmaf(__ldg(a + 32 * k), y2, b2[k]);
  }
  as_solve(G2s, P.s[1], P.lam1, P.lam2, b2, pad2, false, x2, lane);
#pragma unroll
  for (int k = 0; k < KMAX; k++) {
    const unsigned w = __ballot_sync(FULL, lane + 32 * k < n_wm && x2[k] > 0.f);
    if (lane == 0) P.sup[vox * KMAX + k] = w;
  }
}

__device__ __forceinline__ void stage3(const Params& P, const float* G1s,
                                       size_t vox, int lane) {
  const int na = P.na, n_wm = P.n_wm;
  Vec b, x;
  load_b1(P, vox, lane, b);
  // positive stage-2 support, trailing dot/iso rows forced on
  unsigned mask3 = 0;
#pragma unroll
  for (int k = 0; k < KMAX; k++) {
    int i = lane + 32 * k;
    if (((P.sup[vox * KMAX + k] >> lane) & 1u) || (i >= n_wm && i < na))
      mask3 |= 1u << k;
    x[k] = bit(mask3, k) ? P.x1[vox * na + i] : 0.f;
  }
  as_solve(G1s, P.s[2], 0.f, 0.f, b, mask3, true, x, lane);

  // estimates
  float s_all = 0.f;
#pragma unroll
  for (int k = 0; k < KMAX; k++) s_all += x[k];
  const float sum_atoms = warp_sum(s_all) + 1e-16f;
  float s_wm = 0.f, s_f1 = 0.f, s_f2 = 0.f, s_k1 = 0.f;
#pragma unroll
  for (int k = 0; k < KMAX; k++) {
    int i = lane + 32 * k;
    if (i < n_wm) {
      float xn = x[k] / sum_atoms;
      float fi = P.icvf[i];
      s_wm += xn;
      s_f1 += fi * xn;
      s_f2 += (1.f - fi) * xn;
      s_k1 += P.kappa[i] * xn;
    }
  }
  const float sum_wm = warp_sum(s_wm) + 1e-16f;
  const float f1 = warp_sum(s_f1) / sum_wm;
  const float f2 = warp_sum(s_f2) / sum_wm;
  const float k1 = warp_sum(s_k1) / sum_wm;
  const float fwf = get_row<KMAX>(x, na - 1) / sum_atoms;
  const float dot = P.exvivo ? get_row<KMAX>(x, na - 2) / sum_atoms : 0.f;
  if (lane == 0) {
    float* e = P.est + vox * 4;
    e[0] = f1 / (f1 + f2 + 1e-16f);
    e[1] = k1;
    e[2] = fwf;
    e[3] = dot;
  }
  if (P.xout) {
#pragma unroll
    for (int k = 0; k < KMAX; k++) {
      int i = lane + 32 * k;
      if (i < na) P.xout[vox * na + i] = x[k];
    }
  }
}

__global__ void __launch_bounds__(NWARPS * 32, MINB)
noddi_fused_kernel(const Params P) {
  extern __shared__ float Gs[];
  const int c = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (size_t)c * P.M;
  const float* G1 = P.G1 + (size_t)c * P.na * P.na;
  load_gram(Gs, G1, P.na);
  __syncthreads();
  for (int v = warp; v < P.M; v += NWARPS) stage1(P, Gs, base + v, lane);
  __syncthreads();   // also publishes x1 to the block
  load_gram(Gs, P.G2 + (size_t)c * P.n_wm * P.n_wm, P.n_wm);
  __syncthreads();
  for (int v = warp; v < P.M; v += NWARPS) stage2(P, Gs, c, base + v, lane);
  __syncthreads();   // also publishes the support words
  load_gram(Gs, G1, P.na);
  __syncthreads();
  for (int v = warp; v < P.M; v += NWARPS) stage3(P, Gs, base + v, lane);
}

extern "C" {

// sched: 3 stages x [rounds, add_k, polish, cg[MAXR], inner[MAXR]] (host);
// scratch: C*M*(na + KMAX) floats of device memory
int noddi_fused_launch(const void* G1, const void* G2, const void* b1,
                       const void* Ydwi, const void* A2, const void* iso_dwi,
                       const void* icvf, const void* kappa, void* est,
                       void* xout, void* scratch, int C, int M, int na,
                       int n_wm, int ndwi, int exvivo, float lam1, float lam2,
                       const void* sched, void* stream) {
  if (na > LD || n_wm > LD || n_wm >= na) return (int)cudaErrorInvalidValue;
  Params P;
  P.G1 = (const float*)G1;
  P.G2 = (const float*)G2;
  P.b1 = (const float*)b1;
  P.Ydwi = (const float*)Ydwi;
  P.A2 = (const float*)A2;
  P.iso_dwi = (const float*)iso_dwi;
  P.icvf = (const float*)icvf;
  P.kappa = (const float*)kappa;
  P.est = (float*)est;
  P.xout = (float*)xout;
  P.x1 = (float*)scratch;
  P.sup = (unsigned*)((float*)scratch + (size_t)C * M * na);
  P.M = M;
  P.na = na;
  P.n_wm = n_wm;
  P.ndwi = ndwi;
  P.exvivo = exvivo;
  P.lam1 = lam1;
  P.lam2 = lam2;
  const int* s = (const int*)sched;
  for (int st = 0; st < 3; st++, s += 3 + 2 * MAXR) {
    P.s[st].rounds = s[0];
    P.s[st].add_k = s[1];
    P.s[st].polish = s[2];
    if (s[0] < 1 || s[0] > MAXR) return (int)cudaErrorInvalidValue;
    for (int r = 0; r < MAXR; r++) {
      P.s[st].cg[r] = s[3 + r];
      P.s[st].inner[r] = s[3 + MAXR + r];
    }
  }
  if (C == 0 || M == 0) return 0;
  size_t smem = (size_t)na * LD * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      noddi_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  noddi_fused_kernel<<<C, NWARPS * 32, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

}  // extern "C"
