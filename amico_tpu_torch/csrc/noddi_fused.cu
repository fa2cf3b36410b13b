// Fused 3-stage NODDI solve per tile, for Hopper (sm_90a).
//
// Replaces the TPU kernel amico_tpu/ops/pallas_qp.py:noddi_fused_tiles_pallas
// (body _make_noddi_kernel, solver _build_as_solve).  The plain PyTorch twin
// is amico_tpu_torch/ops/cuda_qp.py:noddi_fused_tiles_torch; both compute the
// same float32 math:
//   stage 1  NNLS on the full Gram G1 from an empty working set;
//   stage 2  Y2 = max(Y_dwi - iso*x_iso [- x_dot], 0), b2 = A2T Y2, then a
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
// Layout.  One block per tile; the tile's two Grams live in dynamic shared
// memory for the whole solve, G1 and G2 at a row stride of LD = 160 floats
// (185 KB for the full 145/144-atom grid, of the 227 KB a block may take).
// One warp per voxel, looping over the tile's voxels; lane l owns
// coefficients l, l+32, ..., l+128 in registers.  Dot products, max, min and
// argmax are warp shuffles.  A2T is read from global memory (L1/L2): it does
// not fit in shared memory beside both Grams.
//
// What bounds it.  The matvecs read G from shared memory.  Every vector a
// matvec sees (CG direction, iterate) is zero outside the voxel's working
// set, so a matvec walks only the nonzero coefficients (a warp ballot lists
// them) and reads one G row per nonzero: |S| * 160 shared-memory reads
// instead of 145 * 160, with |S| the working-set size (a few atoms to a few
// tens).  The per-iteration warp reductions and the ballots are the rest.
#include <cuda_runtime.h>
#include <stdint.h>

#include "qp_warp.cuh"

#define KMAX 5                 // coefficients per lane: n <= 160
#define LD (32 * KMAX)         // row stride of a Gram in shared memory
#define MAXR 32                // rounds per stage
#define NWARPS 16              // warps per block (voxels in flight per tile)

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
  const float* A2T;     // (C, n_wm, ndwi)
  const float* iso_dwi; // (ndwi,)
  const float* icvf;    // (n_wm,)
  const float* kappa;   // (n_wm,)
  float* est;           // (C, M, 4): NDI, k1, FWF, dot
  float* xout;          // (C, M, na) or null
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
  stage_init<KMAX>(S, Gs, l1, l2, b, cmask);
  unsigned m = 0;
  if (seed_m0) {
    m = cmask;
  } else {
#pragma unroll
    for (int k = 0; k < KMAX; k++)
      if (x[k] > 0.f && bit(cmask, k)) m |= 1u << k;
  }
  for (int r = 0; r < sc.rounds; r++)
    as_round<KMAX>(S, x, m, sc.cg[r], sc.inner[r], sc.add_k, lane);
  inner_solve<KMAX>(S, x, m, sc.polish, lane);
#pragma unroll
  for (int k = 0; k < KMAX; k++) x[k] = fmaxf(x[k], 0.f);
}

__device__ __forceinline__ void solve_voxel(const Params& P, const float* G1s, const float* G2s,
                            int c, int v, int lane) {
  const int na = P.na, n_wm = P.n_wm, ndwi = P.ndwi;
  const size_t vox = (size_t)c * P.M + v;
  Vec b, x1, x2, x;
  unsigned pad1 = 0, pad2 = 0;
#pragma unroll
  for (int k = 0; k < KMAX; k++) {
    int i = lane + 32 * k;
    b[k] = i < na ? P.b1[vox * na + i] : 0.f;
    if (i < na) pad1 |= 1u << k;
    if (i < n_wm) pad2 |= 1u << k;
    x1[k] = 0.f;
    x2[k] = 0.f;
  }
  // stage 1
  as_solve(G1s, P.s[0], 0.f, 0.f, b, pad1, false, x1, lane);

  // stage 2 right-hand side
  const float x_iso = get_row<KMAX>(x1, na - 1);
  const float x_dot = P.exvivo ? get_row<KMAX>(x1, na - 2) : 0.f;
  Vec b2;
#pragma unroll
  for (int k = 0; k < KMAX; k++) b2[k] = 0.f;
  const float* Y = P.Ydwi + vox * ndwi;
  const float* A2T = P.A2T + (size_t)c * n_wm * ndwi;
  for (int s = 0; s < ndwi; s++) {
    float y2 = Y[s] - P.iso_dwi[s] * x_iso;
    if (P.exvivo) y2 -= x_dot;
    y2 = fmaxf(y2, 0.f);
#pragma unroll
    for (int k = 0; k < KMAX; k++) {
      int i = lane + 32 * k;
      if (i < n_wm) b2[k] = fmaf(__ldg(A2T + (size_t)i * ndwi + s), y2, b2[k]);
    }
  }
  as_solve(G2s, P.s[1], P.lam1, P.lam2, b2, pad2, false, x2, lane);

  // stage 3: positive stage-2 support, trailing dot/iso rows forced on
  unsigned mask3 = 0;
#pragma unroll
  for (int k = 0; k < KMAX; k++) {
    int i = lane + 32 * k;
    if ((i < n_wm && x2[k] > 0.f) || (i >= n_wm && i < na)) mask3 |= 1u << k;
    x[k] = bit(mask3, k) ? x1[k] : 0.f;
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

__global__ void __launch_bounds__(NWARPS * 32, 1)
noddi_fused_kernel(const Params P) {
  extern __shared__ float smem[];
  float* G1s = smem;
  float* G2s = smem + P.na * LD;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  // transpose into shared memory: Gs[j*LD + i] = G[i][j], zero for i >= n
  const float* G1 = P.G1 + (size_t)c * P.na * P.na;
  for (int e = tid; e < P.na * LD; e += blockDim.x) {
    int j = e / LD, i = e - j * LD;
    G1s[e] = i < P.na ? G1[(size_t)i * P.na + j] : 0.f;
  }
  const float* G2 = P.G2 + (size_t)c * P.n_wm * P.n_wm;
  for (int e = tid; e < P.n_wm * LD; e += blockDim.x) {
    int j = e / LD, i = e - j * LD;
    G2s[e] = i < P.n_wm ? G2[(size_t)i * P.n_wm + j] : 0.f;
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  for (int v = warp; v < P.M; v += NWARPS) solve_voxel(P, G1s, G2s, c, v, lane);
}

extern "C" {

// sched: 3 stages x [rounds, add_k, polish, cg[MAXR], inner[MAXR]] (host)
int noddi_fused_launch(const void* G1, const void* G2, const void* b1,
                       const void* Ydwi, const void* A2T, const void* iso_dwi,
                       const void* icvf, const void* kappa, void* est,
                       void* xout, int C, int M, int na, int n_wm, int ndwi,
                       int exvivo, float lam1, float lam2, const void* sched,
                       void* stream) {
  if (na > LD || n_wm > LD || n_wm >= na) return (int)cudaErrorInvalidValue;
  Params P;
  P.G1 = (const float*)G1;
  P.G2 = (const float*)G2;
  P.b1 = (const float*)b1;
  P.Ydwi = (const float*)Ydwi;
  P.A2T = (const float*)A2T;
  P.iso_dwi = (const float*)iso_dwi;
  P.icvf = (const float*)icvf;
  P.kappa = (const float*)kappa;
  P.est = (float*)est;
  P.xout = (float*)xout;
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
  size_t smem = (size_t)(na + n_wm) * LD * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      noddi_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  noddi_fused_kernel<<<C, NWARPS * 32, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

}  // extern "C"
