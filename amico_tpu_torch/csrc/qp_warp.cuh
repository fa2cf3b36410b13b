// Lane-group Lawson-Hanson solver pieces shared by the tile QP kernels
// (noddi_fused.cu, nneg_qp.cu), as amico_tpu/ops/pallas_qp.py's kernels
// share _build_as_solve.
//
// One group of W consecutive lanes of a warp solves one voxel (W = 8, 16 or
// 32: 32/W voxels a warp; the fused NODDI kernel takes whole warps).  Lane l
// of the group owns coefficients l, l+W, ..., l+W(K-1) in registers (K =
// coefficients per lane, a template argument; n <= W*K).  A working set or
// coefficient mask is a per-lane word whose bit k stands for row l+Wk.  Dot
// products, max, min and argmax are shuffles within the group (a butterfly
// over its W lanes), so every scalar below is the same on all its lanes.
//
// A Gram lives in shared memory transposed, at a row stride of 32K floats,
// with its column replicated 32/W times across the row:
// Gs[j*32K + 32k + l] = G[(l mod W) + Wk][j], zero for rows >= n.  Warp lane
// l then reads Gs[j*32K + 32k + l]: consecutive lanes, consecutive words, so
// the groups of a warp, each on its own row j, touch disjoint banks.
//
// At W = 32 every piece is the whole-warp code it was before groups came
// in.  A narrower group gives the same floats, bit for bit: on a whole warp
// the lanes past n hold the identity of each reduction (exact zeros in the
// sums and the |b_eff| max, QP_BIG in the ratio min, -QP_BIG at higher
// indices in the argmax), so a 32-lane butterfly's first steps change
// nothing and its last are the W-lane butterfly's, in the same order; the
// matvec walks the nonzeros in ascending index either way.
//
// Every helper is force-inlined: the per-lane arrays then stay in registers
// (a call would pass them through local memory).
//
// Besides the rounds: FISTA with its Lipschitz estimate, which warm-starts
// a solve without a seeded working set, and the tile's vote (block and
// cluster reductions), which the per-tile exits of both kernels take.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace coop = cooperative_groups;

#define FULL 0xffffffffu
#define QP_TOL 3e-6f     // prune / add gate, relative to max|b_eff| per voxel
// K2's stall test (nneg_qp.cu): the rounds of history it keeps, each
// voxel's working set and objective after each; ops/cuda_qp.py mirrors it
// (STALL_ROUNDS) and passes the test's tolerance (STALL)
#define QP_STALL_ROUNDS 4
#define QP_BIG 3.0e38f

// the lanes of one group: W consecutive lanes of a warp
template <int W>
struct Lanes {
  static constexpr unsigned BITS = W == 32 ? FULL : (1u << (W % 32)) - 1u;
  unsigned gmask;  // the group's lanes in the warp
  int lane;        // this thread's lane in the group
  int wlane;       // ... in the warp
  __device__ __forceinline__ unsigned mask() const {
    return W == 32 ? FULL : gmask;
  }
  __device__ __forceinline__ int warp_lane() const {
    return W == 32 ? lane : wlane;
  }
  // the group's bits of a warp ballot, bit l for group lane l
  __device__ __forceinline__ unsigned own(unsigned ballot) const {
    return W == 32 ? ballot : (ballot >> (wlane - lane)) & BITS;
  }
};

template <int W>
__device__ __forceinline__ Lanes<W> lanes_of(int wlane) {
  const int lane = wlane & (W - 1);
  return {Lanes<W>::BITS << (W == 32 ? 0 : wlane - lane), lane, wlane};
}

template <int W>
__device__ __forceinline__ float group_sum(float v, unsigned gm) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(gm, v, o);
  return v;
}

template <int W>
__device__ __forceinline__ float group_max(float v, unsigned gm) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(gm, v, o));
  return v;
}

template <int W>
__device__ __forceinline__ float group_min(float v, unsigned gm) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(gm, v, o));
  return v;
}

// argmax over the group; among equal maxima the lowest row index wins
// (jnp.argmax and torch.argmax break ties the same way)
template <int W>
__device__ __forceinline__ void group_argmax(float& v, int& i, unsigned gm) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(gm, v, o);
    int oi = __shfl_xor_sync(gm, i, o);
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  return group_sum<32>(v, FULL);
}

__device__ __forceinline__ float warp_max(float v) {
  return group_max<32>(v, FULL);
}

template <int K, int W>
__device__ __forceinline__ float vdot(const float (&a)[K], const float (&b)[K],
                                      const Lanes<W>& L) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; k++) s += a[k] * b[k];
  return group_sum<W>(s, L.mask());
}

// value of row idx of a warp-distributed vector, on every lane
template <int K>
__device__ __forceinline__ float get_row(const float (&a)[K], int idx) {
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < K; k++)
    if (k == (idx >> 5)) v = a[k];
  return __shfl_sync(FULL, v, idx & 31);
}

__device__ __forceinline__ bool bit(unsigned m, int k) { return (m >> k) & 1u; }

// out = G v, walking only the nonzero entries of v (a ballot lists them):
// one G row read per nonzero
template <int K, int W>
__device__ __forceinline__ void gmv(const float* __restrict__ Gs,
                                    const float (&v)[K], float (&out)[K],
                                    const Lanes<W>& L) {
#pragma unroll
  for (int k = 0; k < K; k++) out[k] = 0.f;
#pragma unroll
  for (int kk = 0; kk < K; kk++) {
    unsigned nz = L.own(__ballot_sync(L.mask(), v[kk] != 0.f));
    while (nz) {
      int src = __ffs(nz) - 1;
      nz &= nz - 1;
      float vj = __shfl_sync(L.mask(), v[kk], src, W);
      const float* g = Gs + (src + W * kk) * (32 * K) + L.warp_lane();
#pragma unroll
      for (int k = 0; k < K; k++) out[k] = fmaf(g[32 * k], vj, out[k]);
    }
  }
}

template <int K, int W = 32>
struct Stage {
  const float* Gs;
  float l2;
  float beff[K];   // (b*cmask - l1)*cmask
  unsigned cmask;  // bit k: row lane+Wk may enter the working set
  float scale;     // max|b_eff| + 1e-30
  float gate;      // tol * scale
  Lanes<W> L;
};

template <int K, int W>
__device__ __forceinline__ void stage_init(Stage<K, W>& S, const float* Gs,
                                           float l1, float l2,
                                           const float (&b)[K],
                                           unsigned cmask, const Lanes<W>& L) {
  S.Gs = Gs;
  S.l2 = l2;
  S.cmask = cmask;
  S.L = L;
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < K; k++) {
    S.beff[k] = bit(cmask, k) ? b[k] - l1 : 0.f;
    amax = fmaxf(amax, fabsf(S.beff[k]));
  }
  S.scale = group_max<W>(amax, L.mask()) + 1e-30f;
  S.gate = QP_TOL * S.scale;
}

// masked CG from z0 on the working set m
template <int K, int W>
__device__ __forceinline__ void cg(const Stage<K, W>& S, unsigned m,
                                   const float (&z0)[K], int iters,
                                   float (&z)[K]) {
  float r[K], p[K], Ap[K];
#pragma unroll
  for (int k = 0; k < K; k++) z[k] = bit(m, k) ? z0[k] : 0.f;
  gmv<K, W>(S.Gs, z, Ap, S.L);
#pragma unroll
  for (int k = 0; k < K; k++) {
    r[k] = bit(m, k) ? S.beff[k] - (Ap[k] + S.l2 * z[k]) : 0.f;
    p[k] = r[k];
  }
  float rs = vdot<K, W>(r, r, S.L);
  for (int it = 0; it < iters; it++) {
    gmv<K, W>(S.Gs, p, Ap, S.L);
#pragma unroll
    for (int k = 0; k < K; k++)
      Ap[k] = bit(m, k) ? Ap[k] + S.l2 * p[k] : 0.f;
    float denom = vdot<K, W>(p, Ap, S.L);
    // f32 Grams can carry tiny negative eigenvalues
    bool safe = denom > 1e-30f;
    float alpha = safe ? rs / denom : 0.f;
#pragma unroll
    for (int k = 0; k < K; k++) {
      z[k] += alpha * p[k];
      r[k] -= alpha * Ap[k];
    }
    float rs_new = vdot<K, W>(r, r, S.L);
    float beta = safe ? rs_new / (rs + 1e-30f) : 0.f;
#pragma unroll
    for (int k = 0; k < K; k++) p[k] = r[k] + beta * p[k];
    rs = rs_new;
  }
#pragma unroll
  for (int k = 0; k < K; k++)
    if (!isfinite(z[k])) z[k] = 0.f;
}

// CG on the working set, ratio-test step back, prune
template <int K, int W>
__device__ __forceinline__ void inner_solve(const Stage<K, W>& S,
                                            float (&x)[K], unsigned& m,
                                            int iters) {
  float z[K];
  cg<K, W>(S, m, x, iters, z);
  // only coordinates with x > 0 bound the step back
  float rmin = QP_BIG;
#pragma unroll
  for (int k = 0; k < K; k++)
    if (z[k] <= 0.f && bit(m, k) && x[k] > 0.f)
      rmin = fminf(rmin, x[k] / (x[k] - z[k] + 1e-30f));
  float alpha = fminf(fmaxf(group_min<W>(rmin, S.L.mask()), 0.f), 1.f);
#pragma unroll
  for (int k = 0; k < K; k++) {
    float xk = bit(m, k) ? x[k] + alpha * (z[k] - x[k]) : 0.f;
    if (!(xk > S.gate)) m &= ~(1u << k);
    x[k] = bit(m, k) ? xk : 0.f;
  }
}

// add the most violated atom outside the working set, then up to add_k-1
// more, each under the same gate; returns whether the first passed it.
// With OBJ, *f is the objective 1/2 x'Gx - b_eff'x + l2/2 |x|^2 at x,
// -1/2 x'(b_eff + w) from the same G x (K1 takes none)
template <int K, int W, bool OBJ = false>
__device__ __forceinline__ bool add_atoms(const Stage<K, W>& S,
                                          const float (&x)[K], unsigned& m,
                                          int add_k, float* f = nullptr) {
  const int lane = S.L.lane;
  float w[K];
  gmv<K, W>(S.Gs, x, w, S.L);
  const unsigned allowed = S.cmask & ~m;
  float part = 0.f;
#pragma unroll
  for (int k = 0; k < K; k++) {
    const float wk = S.beff[k] - w[k] - S.l2 * x[k];
    if (OBJ) part += x[k] * (S.beff[k] + wk);
    w[k] = bit(allowed, k) ? wk : -QP_BIG;
  }
  if (OBJ) *f = -0.5f * group_sum<W>(part, S.L.mask());
  bool added = false;
  for (int a = 0; a < add_k; a++) {
    float best = -QP_BIG;
    int bi = lane;
    bool first = true;
#pragma unroll
    for (int k = 0; k < K; k++)
      if (first || w[k] > best) { best = w[k]; bi = lane + W * k; first = false; }
    group_argmax<W>(best, bi, S.L.mask());
    if (a == 0) added = best > S.gate;
    if (best > S.gate && (bi & (W - 1)) == lane) m |= 1u << (bi / W);
#pragma unroll
    for (int k = 0; k < K; k++)
      if (bi == lane + W * k) w[k] = -QP_BIG;
  }
  return added;
}

// one Lawson-Hanson round: inner solve-and-prune passes, then the adds.
// Returns whether the voxel is stable: its first add failed the gate and
// its working set is where the round found it.  With OBJ, *f is its
// objective at the round's end (add_atoms)
template <int K, int W, bool OBJ = false>
__device__ __forceinline__ bool as_round(const Stage<K, W>& S, float (&x)[K],
                                         unsigned& m, int iters, int inner,
                                         int add_k, float* f = nullptr) {
  const unsigned m_before = m;
  for (int i = 0; i < inner; i++) inner_solve<K, W>(S, x, m, iters);
  const bool added = add_atoms<K, W, OBJ>(S, x, m, add_k, f);
  return !added && __all_sync(S.L.mask(), m == m_before);
}

// L = v'Gv * 1.01 + 1e-30 after 10 power iterations from ones (one group)
template <int K, int W>
__device__ __forceinline__ float lipschitz(const float* Gs, int n,
                                           const Lanes<W>& L) {
  float v[K], w[K];
#pragma unroll
  for (int k = 0; k < K; k++) v[k] = L.lane + W * k < n ? 1.f : 0.f;
  for (int it = 0; it < 10; it++) {
    gmv<K, W>(Gs, v, w, L);
    const float nrm = sqrtf(vdot<K, W>(w, w, L)) + 1e-30f;
#pragma unroll
    for (int k = 0; k < K; k++) v[k] = w[k] / nrm;
  }
  gmv<K, W>(Gs, v, w, L);
  return vdot<K, W>(v, w, L) * 1.01f + 1e-30f;
}

// one FISTA step from (x, z, t) with adaptive restart; b is zero outside
// cmask
template <int K, int W>
__device__ __forceinline__ void fista_step(const float* Gs,
                                           const float (&b)[K],
                                           unsigned cmask, float l1,
                                           float l2, float step,
                                           float (&x)[K], float (&z)[K],
                                           float& t, const Lanes<W>& L) {
  float Gz[K], xn[K];
  gmv<K, W>(Gs, z, Gz, L);
  float part = 0.f;
#pragma unroll
  for (int k = 0; k < K; k++) {
    const float grad = Gz[k] - b[k] + l2 * z[k];
    xn[k] = bit(cmask, k) ? fmaxf(z[k] - step * (grad + l1), 0.f) : 0.f;
    part += (z[k] - xn[k]) * (xn[k] - x[k]);
  }
  const bool restart = group_sum<W>(part, L.mask()) > 0.f;
  const float t_new = 0.5f * (1.f + sqrtf(1.f + 4.f * t * t));
  const float beta = restart ? 0.f : (t - 1.f) / t_new;
  t = restart ? 1.f : t_new;
#pragma unroll
  for (int k = 0; k < K; k++) {
    z[k] = xn[k] + beta * (xn[k] - x[k]);
    x[k] = xn[k];
  }
}

// FISTA from zero, a fixed trip count
template <int K, int W>
__device__ __forceinline__ void fista(const float* Gs, const float (&b)[K],
                                      unsigned cmask, float l1, float l2,
                                      float step, int iters, float (&x)[K],
                                      const Lanes<W>& L) {
  float z[K];
#pragma unroll
  for (int k = 0; k < K; k++) x[k] = z[k] = 0.f;
  float t = 1.f;
  for (int it = 0; it < iters; it++)
    fista_step<K, W>(Gs, b, cmask, l1, l2, step, x, z, t, L);
}

// max over the block of a value that is the same on each group's lanes
// (every thread must call it)
template <int NW>
__device__ __forceinline__ float block_max(float v, float* red, int warp,
                                           int wlane) {
  v = warp_max(v);
  if (wlane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < NW; w++) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

// the tile's vote: the least of the threads' `level`s (each in 0..LEVELS)
// and the max of v over the tile's groups, over the block and then (CS > 1)
// over the blocks of its cluster through distributed shared memory (every
// thread must call it).  One block barrier a level: the least level is the
// number of levels l at which every thread has level >= l.  The slots
// alternate with `turn`, so a block still reading one turn's slots never
// meets the next turn's writes: a cluster barrier lies between.
template <int NW, int CS, int LEVELS = 1>
__device__ __forceinline__ int tile_level(int level, float& v, float* red,
                                          float* slots, int turn, int warp,
                                          int wlane) {
  int least = 0;
#pragma unroll
  for (int l = 1; l <= LEVELS; l++) least += __syncthreads_and(level >= l);
  v = block_max<NW>(v, red, warp, wlane);
  if (CS > 1) {
    coop::cluster_group cl = coop::this_cluster();
    float* mine = slots + 2 * (turn & 1);
    if (threadIdx.x == 0) {
      mine[0] = (float)least;
      mine[1] = v;
    }
    cl.sync();
#pragma unroll
    for (int r = 0; r < CS; r++) {
      const float* theirs = cl.map_shared_rank(mine, r);
      least = min(least, (int)theirs[0]);
      v = fmaxf(v, theirs[1]);
    }
  }
  return least;
}

// the tile's vote on one flag: the AND of `stable`, and the max of v
template <int NW, int CS>
__device__ __forceinline__ bool tile_vote(bool stable, float& v, float* red,
                                          float* slots, int turn, int warp,
                                          int wlane) {
  return tile_level<NW, CS>(stable, v, red, slots, turn, warp, wlane) > 0;
}
