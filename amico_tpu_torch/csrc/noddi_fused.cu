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
// largest budget.  The schedule arrives as kernel arguments (per-round
// budgets in a small device table), so one build serves any schedule of
// that form.  The per-voxel solver pieces (masked CG, step back and prune,
// adds, one round, FISTA, the tile's vote) are csrc/qp_warp.cuh, shared with
// the tile QP kernel csrc/nneg_qp.cu.
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
// Two instantiations, picked on the host from the schedule.  The default
// one (GEN = false) runs each voxel's whole stage in registers: the
// production schedule needs nothing else.  The general one (GEN = true)
// adds what the JAX kernel's other schedules do: FISTA on stages 1-2 (one
// step 1/(L + lam2) a tile, L from 10 power iterations), the `converge`
// continuation, `early_exit`, stages without rounds (FISTA's x or the warm
// start, as it is), stage 2's tie-break against the kappa neighbours and
// the tie score.  `converge` and `early_exit` are decided per tile by a vote
// of all its voxels after each round (or FISTA step), so there a stage runs
// round by round: the rounds outside, the tile's voxels inside, a block vote
// between.  Between rounds each voxel's x (and FISTA's z and t), its
// working-set word a lane and stage 2's b2 (ndwi x n_wm operations to
// recompute) live in the scratch buffer, ~1.2 KB a voxel: too much beside
// a Gram in shared memory, and the ~132 tiles in flight keep it in L2.
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
#define SCHED_STAGE 8          // header ints a stage (ops/cuda_qp.py)
#define FTOL 1e-4f             // FISTA's early exit, relative to max|b|
// the timed sweep's pick (PERF.md); -D overrides them for a sweep
#ifndef NWARPS
#define NWARPS 32              // warps per block (voxels in flight per tile)
#endif
#ifndef MINB
#define MINB 1                 // blocks resident on an SM (register budget)
#endif

struct StageSched {
  int rounds, add_k, polish;
  int fista;                   // FISTA iterations (stages 1-2), 0: none
  int cont_cg, cont_rounds;    // `converge`: CG budget (0: off), round cap
  int cont_inner;              // the continuation's inner passes
  int off;                     // the stage's first (cg, inner) pair in rtab
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
  const int* nbm;       // (n_wm,) same-ICVF lower-kappa atom, -1: none
  const int* nbp;       // (n_wm,) ... higher-kappa atom
  const int* rtab;      // (cg, inner) of each round, the stages in turn
  float* est;           // (C, M, 4): NDI, k1, FWF, dot
  float* xout;          // (C, M, na) or null
  float* tie;           // (C, M) or null: the tie score
  float* x1;            // (C, M, na) scratch: stage 1's x
  unsigned* sup;        // (C, M, KMAX) scratch: stage 2's support words
  // the general path's scratch: a voxel's state between rounds
  float* xs;            // (C, M, na) x
  float* zs;            // (C, M, na) FISTA's z
  float* ts;            // (C, M) FISTA's t
  float* b2s;           // (C, M, n_wm) stage 2's b2
  unsigned* ms;         // (C, M, 32) working-set word of each lane
  int M, na, n_wm, ndwi, exvivo;
  int early_exit, tiebreak;  // tiebreak: CG budget a candidate, 0: off
  float lam1, lam2;
  StageSched s[3];
};

typedef float Vec[KMAX];

// one stage for one voxel: x holds the warm start on entry (zero for a cold
// start) and the solution on exit
__device__ __forceinline__ void as_solve(const float* Gs, const StageSched& sc,
                         const int* rtab, float l1, float l2, const Vec& b,
                         unsigned cmask, bool seed_m0, Vec& x, int lane) {
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
  const int* rt = rtab + 2 * sc.off;
  for (int r = 0; r < sc.rounds; r++)
    as_round<KMAX>(S, x, m, rt[2 * r], rt[2 * r + 1], sc.add_k);
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

// bit k set where row lane + 32k < n
__device__ __forceinline__ unsigned pad_bits(int n, int lane) {
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < KMAX; k++)
    if (lane + 32 * k < n) m |= 1u << k;
  return m;
}

// b2 = A2' max(Y_dwi - iso*x_iso [- x_dot], 0) from stage 1's x
__device__ __forceinline__ void stage2_b(const Params& P, int c, size_t vox,
                                         int lane, Vec& b2) {
  const int na = P.na, n_wm = P.n_wm, ndwi = P.ndwi;
  const float x_iso = P.x1[vox * na + na - 1];
  const float x_dot = P.exvivo ? P.x1[vox * na + na - 2] : 0.f;
#pragma unroll
  for (int k = 0; k < KMAX; k++) b2[k] = 0.f;
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
}

// stage 3's mask: stage 2's positive support, trailing dot/iso rows forced on
__device__ __forceinline__ unsigned stage3_mask(const Params& P, size_t vox,
                                                int lane) {
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < KMAX; k++) {
    int i = lane + 32 * k;
    if (((P.sup[vox * KMAX + k] >> lane) & 1u) || (i >= P.n_wm && i < P.na))
      m |= 1u << k;
  }
  return m;
}

__device__ __forceinline__ void store_support(const Params& P, size_t vox,
                                              int lane, const Vec& x2) {
#pragma unroll
  for (int k = 0; k < KMAX; k++) {
    const unsigned w = __ballot_sync(FULL, lane + 32 * k < P.n_wm && x2[k] > 0.f);
    if (lane == 0) P.sup[vox * KMAX + k] = w;
  }
}

// NDI, k1, FWF, dot (and x) from the debiased x
__device__ __forceinline__ void emit(const Params& P, size_t vox, int lane,
                                     const Vec& x) {
  const int na = P.na, n_wm = P.n_wm;
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

// ---------------------------------------------------------- default path
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
  as_solve(G1s, P.s[0], P.rtab, 0.f, 0.f, b, pad1, false, x1, lane);
#pragma unroll
  for (int k = 0; k < KMAX; k++) {
    int i = lane + 32 * k;
    if (i < P.na) P.x1[vox * P.na + i] = x1[k];
  }
}

__device__ __forceinline__ void stage2(const Params& P, const float* G2s,
                                       int c, size_t vox, int lane) {
  Vec b2, x2;
  unsigned pad2 = 0;
#pragma unroll
  for (int k = 0; k < KMAX; k++) {
    if (lane + 32 * k < P.n_wm) pad2 |= 1u << k;
    x2[k] = 0.f;
  }
  stage2_b(P, c, vox, lane, b2);
  as_solve(G2s, P.s[1], P.rtab, P.lam1, P.lam2, b2, pad2, false, x2, lane);
  store_support(P, vox, lane, x2);
}

__device__ __forceinline__ void stage3(const Params& P, const float* G1s,
                                       size_t vox, int lane) {
  const int na = P.na;
  Vec b, x;
  load_b1(P, vox, lane, b);
  const unsigned mask3 = stage3_mask(P, vox, lane);
#pragma unroll
  for (int k = 0; k < KMAX; k++)
    x[k] = bit(mask3, k) ? P.x1[vox * na + lane + 32 * k] : 0.f;
  as_solve(G1s, P.s[2], P.rtab, 0.f, 0.f, b, mask3, true, x, lane);
  emit(P, vox, lane, x);
}

// ---------------------------------------------------------- general path
__device__ __forceinline__ void load_vec(const float* src, int n, int lane,
                                         Vec& a) {
#pragma unroll
  for (int k = 0; k < KMAX; k++) {
    const int i = lane + 32 * k;
    a[k] = i < n ? src[i] : 0.f;
  }
}

__device__ __forceinline__ void store_vec(float* dst, int n, int lane,
                                          const Vec& a) {
#pragma unroll
  for (int k = 0; k < KMAX; k++) {
    const int i = lane + 32 * k;
    if (i < n) dst[i] = a[k];
  }
}

// stage s's b (zero past its atoms) and coefficient mask for one voxel;
// stage 2's b2 comes from the scratch the stage's first phase filled
__device__ __forceinline__ unsigned stage_b(const Params& P, int s,
                                            size_t vox, int lane, Vec& b) {
  if (s == 1) {
    load_vec(P.b2s + vox * P.n_wm, P.n_wm, lane, b);
    return pad_bits(P.n_wm, lane);
  }
  load_b1(P, vox, lane, b);
  return s == 0 ? pad_bits(P.na, lane) : stage3_mask(P, vox, lane);
}

// 1/2 x'(G2 + lam2) x - b2'x + lam1 sum(x): stage 2's objective
__device__ __forceinline__ float objective(const Stage<KMAX>& S, const Vec& b,
                                           float l1, const Vec& x) {
  Vec q;
  gmv<KMAX, 32>(S.Gs, x, q, S.L);
  float xq = 0.f, bx = 0.f, sx = 0.f;
#pragma unroll
  for (int k = 0; k < KMAX; k++) {
    xq += x[k] * (q[k] + S.l2 * x[k]);
    bx += b[k] * x[k];
    sx += x[k];
  }
  return 0.5f * warp_sum(xq) - warp_sum(bx) + l1 * warp_sum(sx);
}

// stage 2's tie-break (the JAX kernel's, pallas_qp.py:620-693): the voxel's
// dominant atom swapped for each same-ICVF kappa neighbour, `tiebreak`
// masked CG steps on the swapped support from x2 without that atom, and the
// lowest objective kept
__device__ __forceinline__ void tiebreak(const Params& P,
                                         const Stage<KMAX>& S, const Vec& b,
                                         Vec& x, int lane) {
  float best = x[0];
  int dom = lane;
#pragma unroll
  for (int k = 1; k < KMAX; k++)
    if (x[k] > best) { best = x[k]; dom = lane + 32 * k; }
  group_argmax<32>(best, dom, FULL);
  const int dl = dom & 31, dk = dom >> 5;
  unsigned sup = 0;
  Vec xb, z0;
#pragma unroll
  for (int k = 0; k < KMAX; k++) {
    if (x[k] > 0.f && bit(S.cmask, k)) sup |= 1u << k;
    xb[k] = x[k];
    z0[k] = lane == dl && k == dk ? 0.f : x[k];
  }
  if (lane == dl) sup &= ~(1u << dk);
  float f_best = objective(S, b, P.lam1, x);
  for (int t = 0; t < 2; t++) {
    const int nb = (t ? P.nbp : P.nbm)[dom];
    unsigned mc = sup;
    if (nb >= 0 && lane == (nb & 31)) mc |= 1u << (nb >> 5);
    mc &= S.cmask;
    Vec z;
    cg<KMAX, 32>(S, mc, z0, P.tiebreak, z);
#pragma unroll
    for (int k = 0; k < KMAX; k++) z[k] = bit(mc, k) ? fmaxf(z[k], 0.f) : 0.f;
    const float f = objective(S, b, P.lam1, z);
    if (nb >= 0 && f < f_best) {
      f_best = f;
#pragma unroll
      for (int k = 0; k < KMAX; k++) xb[k] = z[k];
    }
  }
#pragma unroll
  for (int k = 0; k < KMAX; k++) x[k] = xb[k];
}

// the largest (b_eff - (G2 + lam2) x2)/scale over the atoms outside
// supp(x2), -QP_BIG without any: near 0 where a tied vertex exists
__device__ __forceinline__ float tie_score(const Stage<KMAX>& S, const Vec& x) {
  Vec w;
  gmv<KMAX, 32>(S.Gs, x, w, S.L);
  float v = -QP_BIG;
#pragma unroll
  for (int k = 0; k < KMAX; k++)
    if (bit(S.cmask, k) && !(x[k] > 0.f))
      v = fmaxf(v, (S.beff[k] - (w[k] + S.l2 * x[k])) / S.scale);
  return warp_max(v);
}

// stage s of the tile's voxels on the general path; Gs holds its Gram
__device__ void general_stage(const Params& P, int s,
                                           const float* Gs, int c,
                                           size_t base, int warp, int lane,
                                           float* red, float* s_step) {
  const StageSched& sc = P.s[s];
  const int* rt = P.rtab + 2 * sc.off;
  const int na = P.na, n = s == 1 ? P.n_wm : na;
  const float l1 = s == 1 ? P.lam1 : 0.f, l2 = s == 1 ? P.lam2 : 0.f;
  const Lanes<32> L = lanes_of<32>(lane);
  const bool fista_on = sc.fista > 0, ee = P.early_exit != 0;
  float step = 0.f;
  if (fista_on) {
    if (warp == 0) {
      const float Lc = lipschitz<KMAX, 32>(Gs, n, L);
      if (lane == 0) *s_step = 1.f / (Lc + l2 + 1e-30f);
    }
    __syncthreads();
    step = *s_step;
  }
  // inputs and warm start; FISTA in one go without early_exit
  float gb = 0.f;
  for (int v = warp; v < P.M; v += NWARPS) {
    const size_t vox = base + v;
    Vec b, x;
    unsigned cmask;
    if (s == 1) {
      stage2_b(P, c, vox, lane, b);
      store_vec(P.b2s + vox * P.n_wm, P.n_wm, lane, b);
      cmask = pad_bits(P.n_wm, lane);
    } else {
      cmask = stage_b(P, s, vox, lane, b);
    }
#pragma unroll
    for (int k = 0; k < KMAX; k++)
      x[k] = s == 2 && bit(cmask, k) ? P.x1[vox * na + lane + 32 * k] : 0.f;
    if (fista_on && !ee)
      fista<KMAX, 32>(Gs, b, cmask, l1, l2, step, sc.fista, x, L);
    store_vec(P.xs + vox * na, n, lane, x);
    if (fista_on && ee) {
      store_vec(P.zs + vox * na, n, lane, x);
      if (lane == 0) P.ts[vox] = 1.f;
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < KMAX; k++) a = fmaxf(a, fabsf(b[k]));
      gb = fmaxf(gb, warp_max(a));
    }
  }
  // FISTA step by step, until no coefficient of the tile moves by more than
  // FTOL * the tile's max|b|
  if (fista_on && ee) {
    const float btol = FTOL * (block_max<NWARPS>(gb, red, warp, lane) + 1e-30f);
    bool done = false;
    for (int it = 0; it < sc.fista && !done; it++) {
      float gdx = 0.f;
      for (int v = warp; v < P.M; v += NWARPS) {
        const size_t vox = base + v;
        Vec b, x, z, x0;
        const unsigned cmask = stage_b(P, s, vox, lane, b);
        load_vec(P.xs + vox * na, n, lane, x);
        load_vec(P.zs + vox * na, n, lane, z);
        float t = P.ts[vox];
#pragma unroll
        for (int k = 0; k < KMAX; k++) x0[k] = x[k];
        fista_step<KMAX, 32>(Gs, b, cmask, l1, l2, step, x, z, t, L);
        float d = 0.f;
#pragma unroll
        for (int k = 0; k < KMAX; k++) d = fmaxf(d, fabsf(x[k] - x0[k]));
        gdx = fmaxf(gdx, warp_max(d));
        store_vec(P.xs + vox * na, n, lane, x);
        store_vec(P.zs + vox * na, n, lane, z);
        if (lane == 0) P.ts[vox] = t;
      }
      done = block_max<NWARPS>(gdx, red, warp, lane) <= btol;
    }
  }
  // the scheduled rounds: all in registers, or with early_exit round by
  // round until a round leaves the tile stable
  bool stable = false;
  float gscale = 0.f;
  if (sc.rounds > 0) {
    const int passes = ee ? sc.rounds : 1;
    for (int r = 0; r < passes && !stable; r++) {
      bool gs = true;
      for (int v = warp; v < P.M; v += NWARPS) {
        const size_t vox = base + v;
        Vec b, x;
        Stage<KMAX> S;
        const unsigned cmask = stage_b(P, s, vox, lane, b);
        stage_init<KMAX>(S, Gs, l1, l2, b, cmask, L);
        load_vec(P.xs + vox * na, n, lane, x);
        unsigned m = 0;
        if (r > 0) {
          m = P.ms[vox * 32 + lane];
        } else if (s == 2) {
          m = S.cmask;
        } else {
#pragma unroll
          for (int k = 0; k < KMAX; k++)
            if (x[k] > 0.f && bit(S.cmask, k)) m |= 1u << k;
        }
        bool st = false;
        for (int q = ee ? r : 0; q < (ee ? r + 1 : sc.rounds); q++)
          st = as_round<KMAX>(S, x, m, rt[2 * q], rt[2 * q + 1], sc.add_k);
        gs = gs && st;
        gscale = fmaxf(gscale, S.scale);
        store_vec(P.xs + vox * na, n, lane, x);
        P.ms[vox * 32 + lane] = m;
      }
      stable = __syncthreads_and(gs);
    }
  }
  // `converge`: rounds at the continuation budget until the tile is stable
  // or no coefficient of it moves by more than tol * its largest scale
  if (sc.rounds > 0 && sc.cont_cg > 0 && !stable) {
    const float xtol = QP_TOL * block_max<NWARPS>(gscale, red, warp, lane);
    bool done = false;
    for (int i = 0; i < sc.cont_rounds && !done; i++) {
      bool gs = true;
      float gdx = 0.f;
      for (int v = warp; v < P.M; v += NWARPS) {
        const size_t vox = base + v;
        Vec b, x, x0;
        Stage<KMAX> S;
        const unsigned cmask = stage_b(P, s, vox, lane, b);
        stage_init<KMAX>(S, Gs, l1, l2, b, cmask, L);
        load_vec(P.xs + vox * na, n, lane, x);
        unsigned m = P.ms[vox * 32 + lane];
#pragma unroll
        for (int k = 0; k < KMAX; k++) x0[k] = x[k];
        gs = as_round<KMAX>(S, x, m, sc.cont_cg, sc.cont_inner, sc.add_k) &&
             gs;
        float d = 0.f;
#pragma unroll
        for (int k = 0; k < KMAX; k++) d = fmaxf(d, fabsf(x[k] - x0[k]));
        gdx = fmaxf(gdx, warp_max(d));
        store_vec(P.xs + vox * na, n, lane, x);
        P.ms[vox * 32 + lane] = m;
      }
      const bool st = tile_vote<NWARPS, 1>(gs, gdx, red, nullptr, 0, warp,
                                           lane);
      done = st || gdx <= xtol;
    }
  }
  // the polish (a stage without rounds keeps its x as it is), then the
  // stage's output
  for (int v = warp; v < P.M; v += NWARPS) {
    const size_t vox = base + v;
    Vec b, x;
    Stage<KMAX> S;
    const unsigned cmask = stage_b(P, s, vox, lane, b);
    stage_init<KMAX>(S, Gs, l1, l2, b, cmask, L);
    load_vec(P.xs + vox * na, n, lane, x);
    if (sc.rounds > 0) {
      unsigned m = P.ms[vox * 32 + lane];
      inner_solve<KMAX>(S, x, m, sc.polish);
#pragma unroll
      for (int k = 0; k < KMAX; k++) x[k] = fmaxf(x[k], 0.f);
    }
    if (s == 0) {
      store_vec(P.x1 + vox * na, na, lane, x);
    } else if (s == 1) {
      if (P.tiebreak > 0) tiebreak(P, S, b, x, lane);
      if (P.tie) {
        const float t = tie_score(S, x);
        if (lane == 0) P.tie[vox] = t;
      }
      store_support(P, vox, lane, x);
    } else {
      emit(P, vox, lane, x);
    }
  }
}

template <bool GEN>
__global__ void __launch_bounds__(NWARPS * 32, MINB)
noddi_fused_kernel(const Params P) {
  extern __shared__ float Gs[];
  const int c = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (size_t)c * P.M;
  const float* G1 = P.G1 + (size_t)c * P.na * P.na;
  const float* G2 = P.G2 + (size_t)c * P.n_wm * P.n_wm;
  if constexpr (!GEN) {
    load_gram(Gs, G1, P.na);
    __syncthreads();
    for (int v = warp; v < P.M; v += NWARPS) stage1(P, Gs, base + v, lane);
    __syncthreads();   // also publishes x1 to the block
    load_gram(Gs, G2, P.n_wm);
    __syncthreads();
    for (int v = warp; v < P.M; v += NWARPS) stage2(P, Gs, c, base + v, lane);
    __syncthreads();   // also publishes the support words
    load_gram(Gs, G1, P.na);
    __syncthreads();
    for (int v = warp; v < P.M; v += NWARPS) stage3(P, Gs, base + v, lane);
  } else {
    __shared__ float red[NWARPS];
    __shared__ float s_step;
    for (int s = 0; s < 3; s++) {
      load_gram(Gs, s == 1 ? G2 : G1, s == 1 ? P.n_wm : P.na);
      __syncthreads();
      general_stage(P, s, Gs, c, base, warp, lane, red, &s_step);
      __syncthreads();   // publishes the stage's output; frees Gs
    }
  }
}

template <bool GEN>
static int launch(const Params& P, int C, size_t smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      noddi_fused_kernel<GEN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  noddi_fused_kernel<GEN><<<C, NWARPS * 32, smem, st>>>(P);
  return (int)cudaGetLastError();
}

extern "C" {

// sched (host): per stage [rounds, add_k, polish, fista, cont_cg,
// cont_rounds, cont_inner, off], then [early_exit, tiebreak, general];
// rtab (device): (cg, inner) pairs; scratch: C*M floats times na + KMAX,
// plus 2*na + 1 + n_wm + 32 on the general path (ops/cuda_qp.py
// noddi_scratch_words)
int noddi_fused_launch(const void* G1, const void* G2, const void* b1,
                       const void* Ydwi, const void* A2, const void* iso_dwi,
                       const void* icvf, const void* kappa, const void* nbm,
                       const void* nbp, void* est, void* xout, void* tie,
                       void* scratch, const void* rtab, int C, int M, int na,
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
  P.nbm = (const int*)nbm;
  P.nbp = (const int*)nbp;
  P.rtab = (const int*)rtab;
  P.est = (float*)est;
  P.xout = (float*)xout;
  P.tie = (float*)tie;
  P.M = M;
  P.na = na;
  P.n_wm = n_wm;
  P.ndwi = ndwi;
  P.exvivo = exvivo;
  P.lam1 = lam1;
  P.lam2 = lam2;
  const int* s = (const int*)sched;
  for (int st = 0; st < 3; st++, s += SCHED_STAGE) {
    StageSched& q = P.s[st];
    q.rounds = s[0];
    q.add_k = s[1];
    q.polish = s[2];
    q.fista = st < 2 ? s[3] : 0;
    q.cont_cg = s[4];
    q.cont_rounds = s[5];
    q.cont_inner = s[6];
    q.off = s[7];
    if (q.rounds < 0 || q.add_k < 1 || q.fista < 0 || q.off < 0)
      return (int)cudaErrorInvalidValue;
  }
  P.early_exit = s[0];
  P.tiebreak = s[1];
  const bool general = s[2] != 0;
  if ((P.tiebreak > 0 && (!nbm || !nbp)) ||
      (!general && (P.tiebreak > 0 || tie || P.early_exit)))
    return (int)cudaErrorInvalidValue;
  for (int st = 0; st < 3 && !general; st++)
    if (P.s[st].rounds < 1 || P.s[st].fista > 0 || P.s[st].cont_cg > 0)
      return (int)cudaErrorInvalidValue;
  if (C == 0 || M == 0) return 0;
  const size_t cm = (size_t)C * M;
  float* f = (float*)scratch;
  P.x1 = f;
  P.sup = (unsigned*)(f + cm * na);
  f += cm * (na + KMAX);
  P.xs = general ? f : nullptr;
  P.zs = general ? f + cm * na : nullptr;
  P.ts = general ? f + 2 * cm * na : nullptr;
  P.b2s = general ? f + cm * (2 * na + 1) : nullptr;
  P.ms = general ? (unsigned*)(f + cm * (2 * na + 1 + n_wm)) : nullptr;
  const size_t smem = (size_t)na * LD * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  return general ? launch<true>(P, C, smem, st) : launch<false>(P, C, smem, st);
}

}  // extern "C"
