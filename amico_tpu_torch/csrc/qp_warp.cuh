// Warp-level Lawson-Hanson solver pieces shared by the tile QP kernels
// (noddi_fused.cu, nneg_qp.cu), as amico_tpu/ops/pallas_qp.py's kernels
// share _build_as_solve.
//
// One warp solves one voxel.  Lane l owns coefficients l, l+32, ...,
// l+32(K-1) in registers (K = coefficients per lane, a template argument;
// n <= 32K).  A working set or coefficient mask is a per-lane word whose
// bit k stands for row lane+32k.  Dot products, max, min and argmax are warp
// shuffles, so every scalar below is the same on all lanes.
//
// A Gram lives in shared memory transposed, at a row stride of 32K floats:
// Gs[j*32K + i] = G[i][j], zero for i >= n.  Lane l then reads
// Gs[j*32K + l + 32k]: consecutive lanes, consecutive words, no bank
// conflicts.
//
// Every helper is force-inlined: the per-lane arrays then stay in registers
// (a call would pass them through local memory).
#pragma once
#include <cuda_runtime.h>

#define FULL 0xffffffffu
#define QP_TOL 3e-6f     // prune / add gate, relative to max|b_eff| per voxel
#define QP_BIG 3.0e38f

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// warp argmax; among equal maxima the lowest row index wins (jnp.argmax and
// torch.argmax break ties the same way)
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(FULL, v, o);
    int oi = __shfl_xor_sync(FULL, i, o);
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

template <int K>
__device__ __forceinline__ float vdot(const float (&a)[K], const float (&b)[K]) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; k++) s += a[k] * b[k];
  return warp_sum(s);
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

// out = G v, walking only the nonzero entries of v (a warp ballot lists
// them): one G row read per nonzero
template <int K>
__device__ __forceinline__ void gmv(const float* __restrict__ Gs,
                                    const float (&v)[K], float (&out)[K],
                                    int lane) {
#pragma unroll
  for (int k = 0; k < K; k++) out[k] = 0.f;
#pragma unroll
  for (int kk = 0; kk < K; kk++) {
    unsigned nz = __ballot_sync(FULL, v[kk] != 0.f);
    while (nz) {
      int src = __ffs(nz) - 1;
      nz &= nz - 1;
      float vj = __shfl_sync(FULL, v[kk], src);
      const float* g = Gs + (src + 32 * kk) * (32 * K) + lane;
#pragma unroll
      for (int k = 0; k < K; k++) out[k] = fmaf(g[32 * k], vj, out[k]);
    }
  }
}

template <int K>
struct Stage {
  const float* Gs;
  float l2;
  float beff[K];   // (b*cmask - l1)*cmask
  unsigned cmask;  // bit k: row lane+32k may enter the working set
  float scale;     // max|b_eff| + 1e-30
  float gate;      // tol * scale
};

template <int K>
__device__ __forceinline__ void stage_init(Stage<K>& S, const float* Gs,
                                           float l1, float l2,
                                           const float (&b)[K],
                                           unsigned cmask) {
  S.Gs = Gs;
  S.l2 = l2;
  S.cmask = cmask;
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < K; k++) {
    S.beff[k] = bit(cmask, k) ? b[k] - l1 : 0.f;
    amax = fmaxf(amax, fabsf(S.beff[k]));
  }
  S.scale = warp_max(amax) + 1e-30f;
  S.gate = QP_TOL * S.scale;
}

// masked CG from z0 on the working set m
template <int K>
__device__ __forceinline__ void cg(const Stage<K>& S, unsigned m,
                                   const float (&z0)[K], int iters,
                                   float (&z)[K], int lane) {
  float r[K], p[K], Ap[K];
#pragma unroll
  for (int k = 0; k < K; k++) z[k] = bit(m, k) ? z0[k] : 0.f;
  gmv<K>(S.Gs, z, Ap, lane);
#pragma unroll
  for (int k = 0; k < K; k++) {
    r[k] = bit(m, k) ? S.beff[k] - (Ap[k] + S.l2 * z[k]) : 0.f;
    p[k] = r[k];
  }
  float rs = vdot<K>(r, r);
  for (int it = 0; it < iters; it++) {
    gmv<K>(S.Gs, p, Ap, lane);
#pragma unroll
    for (int k = 0; k < K; k++)
      Ap[k] = bit(m, k) ? Ap[k] + S.l2 * p[k] : 0.f;
    float denom = vdot<K>(p, Ap);
    // f32 Grams can carry tiny negative eigenvalues
    bool safe = denom > 1e-30f;
    float alpha = safe ? rs / denom : 0.f;
#pragma unroll
    for (int k = 0; k < K; k++) {
      z[k] += alpha * p[k];
      r[k] -= alpha * Ap[k];
    }
    float rs_new = vdot<K>(r, r);
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
template <int K>
__device__ __forceinline__ void inner_solve(const Stage<K>& S, float (&x)[K],
                                            unsigned& m, int iters, int lane) {
  float z[K];
  cg<K>(S, m, x, iters, z, lane);
  // only coordinates with x > 0 bound the step back
  float rmin = QP_BIG;
#pragma unroll
  for (int k = 0; k < K; k++)
    if (z[k] <= 0.f && bit(m, k) && x[k] > 0.f)
      rmin = fminf(rmin, x[k] / (x[k] - z[k] + 1e-30f));
  float alpha = fminf(fmaxf(warp_min(rmin), 0.f), 1.f);
#pragma unroll
  for (int k = 0; k < K; k++) {
    float xk = bit(m, k) ? x[k] + alpha * (z[k] - x[k]) : 0.f;
    if (!(xk > S.gate)) m &= ~(1u << k);
    x[k] = bit(m, k) ? xk : 0.f;
  }
}

// add the most violated atom outside the working set, then up to add_k-1
// more, each under the same gate; returns whether the first passed it
template <int K>
__device__ __forceinline__ bool add_atoms(const Stage<K>& S,
                                          const float (&x)[K], unsigned& m,
                                          int add_k, int lane) {
  float w[K];
  gmv<K>(S.Gs, x, w, lane);
  const unsigned allowed = S.cmask & ~m;
#pragma unroll
  for (int k = 0; k < K; k++)
    w[k] = bit(allowed, k) ? S.beff[k] - w[k] - S.l2 * x[k] : -QP_BIG;
  bool added = false;
  for (int a = 0; a < add_k; a++) {
    float best = -QP_BIG;
    int bi = lane;
    bool first = true;
#pragma unroll
    for (int k = 0; k < K; k++)
      if (first || w[k] > best) { best = w[k]; bi = lane + 32 * k; first = false; }
    warp_argmax(best, bi);
    if (a == 0) added = best > S.gate;
    if (best > S.gate && (bi & 31) == lane) m |= 1u << (bi >> 5);
#pragma unroll
    for (int k = 0; k < K; k++)
      if (bi == lane + 32 * k) w[k] = -QP_BIG;
  }
  return added;
}

// one Lawson-Hanson round: inner solve-and-prune passes, then the adds.
// Returns whether the voxel is stable: its first add failed the gate and
// its working set is where the round found it.
template <int K>
__device__ __forceinline__ bool as_round(const Stage<K>& S, float (&x)[K],
                                         unsigned& m, int iters, int inner,
                                         int add_k, int lane) {
  const unsigned m_before = m;
  for (int i = 0; i < inner; i++) inner_solve<K>(S, x, m, iters, lane);
  const bool added = add_atoms<K>(S, x, m, add_k, lane);
  return !added && __all_sync(FULL, m == m_before);
}
