// K2's lockstep solver pieces for 17 <= n <= 32 atoms (nneg_qp.cu): one
// warp solves V voxels of a tile at once, lane l holding coefficient l of
// each (qp_warp.cuh's W = 32, K = 1 layout, a voxel's per-lane arrays as
// float[1]).  The voxels of a tile share G, and under a schedule every
// voxel runs the same trip counts (FISTA steps, rounds, inner passes, CG
// steps, continuation rounds, polish), so the batch runs each phase
// together and each Gram-vector product serves all V voxels:
//
//   dense_mv: every lane writes its coefficient of each voxel's vector to
//   the warp's scratch, then reads the vectors back as 16-byte broadcasts
//   and sums out_v[l] = sum_j G[l][j] v_v[j] over ascending j in one fmaf
//   chain a voxel, G's row l read once a column block for all V voxels.
//   No shuffle and no ballot walk: ~1.3 instructions a multiply-add,
//   against ~9 for each nonzero in qp_warp.cuh's gmv.
//
// The floats are gmv's, bit for bit: gmv's chain is the same chain over
// the nonzeros alone, and a zero of v adds fmaf(g, +-0, out) = out exactly
// (G is finite; out starts at +0 and a sum never turns it to -0); G is
// zero past n.  Everything else of a voxel (dot products, ratio test,
// prune, argmax, objective, FISTA's restart) is qp_warp.cuh's code for
// K = 1, in the same order, once a voxel of the batch.
//
// Every helper is force-inlined, so the batch's arrays stay in registers.
#pragma once
#include "qp_warp.cuh"

#define LS_LD 36   // row stride of the row-major Gram (floats): 16-byte
                   // rows, and the 8 lanes of a quarter warp on 8 bank quads

// what a warp's products read: G row-major at LS_LD (zero past n), its
// scratch of V rows of 32 floats, the column blocks of 4 that hold the n
// columns, and the lane
struct Dense {
  const float* Gr;
  float* scr;
  int nb;
  int lane;
};

// out[s] = G v[s] for each voxel s of the batch
template <int V>
__device__ __forceinline__ void dense_mv(const Dense& D,
                                         const float (&v)[V][1],
                                         float (&out)[V][1]) {
  __syncwarp();
#pragma unroll
  for (int s = 0; s < V; s++) D.scr[32 * s + D.lane] = v[s][0];
  __syncwarp();
#pragma unroll
  for (int s = 0; s < V; s++) out[s][0] = 0.f;
  const float4* p = reinterpret_cast<const float4*>(D.scr);
  const float4* g = reinterpret_cast<const float4*>(D.Gr + D.lane * LS_LD);
  // not unrolled: more loads in flight than the registers of nneg_qp.cu's
  // QP_LS_V voxels hold spill (the timed sweep, PERF.md)
#pragma unroll 1
  for (int jb = 0; jb < D.nb; jb++) {
    const float4 gj = g[jb];
#pragma unroll
    for (int s = 0; s < V; s++) {
      const float4 pj = p[8 * s + jb];
      out[s][0] = fmaf(gj.x, pj.x, out[s][0]);
      out[s][0] = fmaf(gj.y, pj.y, out[s][0]);
      out[s][0] = fmaf(gj.z, pj.z, out[s][0]);
      out[s][0] = fmaf(gj.w, pj.w, out[s][0]);
    }
  }
}

// qp_warp.cuh's group_sum, group_min and group_argmax over the whole warp,
// once a voxel of the batch: the same butterfly for each, its levels
// interleaved across the voxels
template <int V>
__device__ __forceinline__ void batch_sum(float (&v)[V]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int s = 0; s < V; s++) v[s] += __shfl_xor_sync(FULL, v[s], o);
}

template <int V>
__device__ __forceinline__ void batch_min(float (&v)[V]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int s = 0; s < V; s++)
      v[s] = fminf(v[s], __shfl_xor_sync(FULL, v[s], o));
}

template <int V>
__device__ __forceinline__ void batch_argmax(float (&v)[V], int (&i)[V]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int s = 0; s < V; s++) {
      const float ov = __shfl_xor_sync(FULL, v[s], o);
      const int oi = __shfl_xor_sync(FULL, i[s], o);
      if (ov > v[s] || (ov == v[s] && oi < i[s])) {
        v[s] = ov;
        i[s] = oi;
      }
    }
}

// a batch's solver constants, qp_warp.cuh's Stage for K = 1 without the
// scale (read once, where the state is stored): each voxel's b_eff and
// gate, and bit s of cm for voxel s's coefficient mask.  A batch's working
// sets are one word the same way: bit s of m is voxel s's bit of this
// lane's row
template <int V>
struct LsStage {
  float l2;
  float beff[V];
  float gate[V];
  unsigned cm;
};

__device__ __forceinline__ bool on(unsigned m, int s) { return (m >> s) & 1u; }

// voxel s of the batch takes what stage_init or load_stage set in S1 (cm
// starts at 0)
template <int V>
__device__ __forceinline__ void ls_take(LsStage<V>& S, int s,
                                        const Stage<1, 32>& S1) {
  S.l2 = S1.l2;
  S.beff[s] = S1.beff[0];
  S.gate[s] = S1.gate;
  S.cm |= (S1.cmask & 1u) << s;
}

// masked CG from z0 on each voxel's working set (qp_warp.cuh cg)
template <int V>
__device__ __forceinline__ void ls_cg(const Dense& D, const LsStage<V>& S,
                                      unsigned m, const float (&z0)[V][1],
                                      int iters, float (&z)[V][1]) {
  float r[V][1], p[V][1], Ap[V][1], rs[V], d[V];
#pragma unroll
  for (int s = 0; s < V; s++) z[s][0] = on(m, s) ? z0[s][0] : 0.f;
  dense_mv<V>(D, z, Ap);
#pragma unroll
  for (int s = 0; s < V; s++) {
    r[s][0] = on(m, s) ? S.beff[s] - (Ap[s][0] + S.l2 * z[s][0]) : 0.f;
    p[s][0] = r[s][0];
    rs[s] = 0.f;
    rs[s] += r[s][0] * r[s][0];
  }
  batch_sum<V>(rs);
  for (int it = 0; it < iters; it++) {
    dense_mv<V>(D, p, Ap);
#pragma unroll
    for (int s = 0; s < V; s++) {
      Ap[s][0] = on(m, s) ? Ap[s][0] + S.l2 * p[s][0] : 0.f;
      d[s] = 0.f;
      d[s] += p[s][0] * Ap[s][0];
    }
    batch_sum<V>(d);   // denom
    bool safe[V];
    float rs_new[V];
#pragma unroll
    for (int s = 0; s < V; s++) {
      // f32 Grams can carry tiny negative eigenvalues
      safe[s] = d[s] > 1e-30f;
      const float alpha = safe[s] ? rs[s] / d[s] : 0.f;
      z[s][0] += alpha * p[s][0];
      r[s][0] -= alpha * Ap[s][0];
      rs_new[s] = 0.f;
      rs_new[s] += r[s][0] * r[s][0];
    }
    batch_sum<V>(rs_new);
#pragma unroll
    for (int s = 0; s < V; s++) {
      const float beta = safe[s] ? rs_new[s] / (rs[s] + 1e-30f) : 0.f;
      p[s][0] = r[s][0] + beta * p[s][0];
      rs[s] = rs_new[s];
    }
  }
#pragma unroll
  for (int s = 0; s < V; s++)
    if (!isfinite(z[s][0])) z[s][0] = 0.f;
}

// CG, ratio-test step back and prune of each voxel (qp_warp.cuh
// inner_solve)
template <int V>
__device__ __forceinline__ void ls_inner_solve(const Dense& D,
                                               const LsStage<V>& S,
                                               float (&x)[V][1], unsigned& m,
                                               int iters) {
  float z[V][1], rmin[V];
  ls_cg<V>(D, S, m, x, iters, z);
#pragma unroll
  for (int s = 0; s < V; s++) {
    // only coordinates with x > 0 bound the step back
    rmin[s] = QP_BIG;
    if (z[s][0] <= 0.f && on(m, s) && x[s][0] > 0.f)
      rmin[s] = fminf(rmin[s], x[s][0] / (x[s][0] - z[s][0] + 1e-30f));
  }
  batch_min<V>(rmin);
#pragma unroll
  for (int s = 0; s < V; s++) {
    const float alpha = fminf(fmaxf(rmin[s], 0.f), 1.f);
    const float xk = on(m, s) ? x[s][0] + alpha * (z[s][0] - x[s][0]) : 0.f;
    if (!(xk > S.gate[s])) m &= ~(1u << s);
    x[s][0] = on(m, s) ? xk : 0.f;
  }
}

// the adds of each voxel and, with OBJ, its objective (qp_warp.cuh
// add_atoms): bit s of the result says whether voxel s's first add passed
// the gate
template <int V, bool OBJ>
__device__ __forceinline__ unsigned ls_add_atoms(const Dense& D,
                                                 const LsStage<V>& S,
                                                 const float (&x)[V][1],
                                                 unsigned& m, int add_k,
                                                 float (&f)[V]) {
  const int lane = D.lane;
  const unsigned allowed = S.cm & ~m;
  float w[V][1], part[V];
  dense_mv<V>(D, x, w);
#pragma unroll
  for (int s = 0; s < V; s++) {
    part[s] = 0.f;
    const float wk = S.beff[s] - w[s][0] - S.l2 * x[s][0];
    if (OBJ) part[s] += x[s][0] * (S.beff[s] + wk);
    w[s][0] = on(allowed, s) ? wk : -QP_BIG;
  }
  if (OBJ) {
    batch_sum<V>(part);
#pragma unroll
    for (int s = 0; s < V; s++) f[s] = -0.5f * part[s];
  }
  unsigned added = 0u;
  for (int a = 0; a < add_k; a++) {
    float best[V];
    int bi[V];
#pragma unroll
    for (int s = 0; s < V; s++) {
      best[s] = w[s][0];
      bi[s] = lane;
    }
    batch_argmax<V>(best, bi);
#pragma unroll
    for (int s = 0; s < V; s++) {
      if (a == 0 && best[s] > S.gate[s]) added |= 1u << s;
      if (best[s] > S.gate[s] && bi[s] == lane) m |= 1u << s;
      if (bi[s] == lane) w[s][0] = -QP_BIG;
    }
  }
  return added;
}

// one Lawson-Hanson round of each voxel (qp_warp.cuh as_round): bit s of
// the result says whether voxel s is stable (added no atom and kept its
// working set); with OBJ, f[s] is its objective at the round's end
template <int V, bool OBJ>
__device__ __forceinline__ unsigned ls_as_round(const Dense& D,
                                                const LsStage<V>& S,
                                                float (&x)[V][1],
                                                unsigned& m, int iters,
                                                int inner, int add_k,
                                                float (&f)[V]) {
  const unsigned m_before = m;
  for (int i = 0; i < inner; i++) ls_inner_solve<V>(D, S, x, m, iters);
  const unsigned added = ls_add_atoms<V, OBJ>(D, S, x, m, add_k, f);
  unsigned stable = 0u;
#pragma unroll
  for (int s = 0; s < V; s++)
    if (!on(added, s) && __all_sync(FULL, on(m, s) == on(m_before, s)))
      stable |= 1u << s;
  return stable;
}

// qp_warp.cuh lipschitz on the dense product (one warp)
__device__ __forceinline__ float ls_lipschitz(const Dense& D, int n,
                                              const Lanes<32>& L) {
  float v[1][1], w[1][1];
  v[0][0] = L.lane < n ? 1.f : 0.f;
  for (int it = 0; it < 10; it++) {
    dense_mv<1>(D, v, w);
    const float nrm = sqrtf(vdot<1, 32>(w[0], w[0], L)) + 1e-30f;
    v[0][0] = w[0][0] / nrm;
  }
  dense_mv<1>(D, v, w);
  return vdot<1, 32>(v[0], w[0], L) * 1.01f + 1e-30f;
}

// qp_warp.cuh fista from zero, a fixed trip count, each voxel its own
// restarts; b is zero outside each voxel's mask (bit s of cm)
template <int V>
__device__ __forceinline__ void ls_fista(const Dense& D,
                                         const float (&b)[V][1], unsigned cm,
                                         float l1, float l2, float step,
                                         int iters, float (&x)[V][1]) {
  float z[V][1], t[V];
#pragma unroll
  for (int s = 0; s < V; s++) {
    x[s][0] = z[s][0] = 0.f;
    t[s] = 1.f;
  }
  for (int it = 0; it < iters; it++) {
    float Gz[V][1], xn[V], part[V];
    dense_mv<V>(D, z, Gz);
#pragma unroll
    for (int s = 0; s < V; s++) {
      part[s] = 0.f;
      const float grad = Gz[s][0] - b[s][0] + l2 * z[s][0];
      xn[s] = on(cm, s) ? fmaxf(z[s][0] - step * (grad + l1), 0.f) : 0.f;
      part[s] += (z[s][0] - xn[s]) * (xn[s] - x[s][0]);
    }
    batch_sum<V>(part);
#pragma unroll
    for (int s = 0; s < V; s++) {
      const bool restart = part[s] > 0.f;
      const float t_new = 0.5f * (1.f + sqrtf(1.f + 4.f * t[s] * t[s]));
      const float beta = restart ? 0.f : (t[s] - 1.f) / t_new;
      t[s] = restart ? 1.f : t_new;
      z[s][0] = xn[s] + beta * (xn[s] - x[s][0]);
      x[s][0] = xn[s];
    }
  }
}
