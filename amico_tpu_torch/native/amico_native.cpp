// amico_native: exact host-side solvers for the TPU-native AMICO framework.
//
// The reference framework's only numerical solvers are SPAMS' C++ `nnls`
// (active-set non-negative least squares) and `lasso` (non-negative
// elastic net), called per voxel from Cython
// (reference amico/models.pyx:18,615,911,926,940,1238,1569).
// This library provides the TPU build's native counterpart: an exact
// active-set solver for the generic strictly-convex non-negative QP
//     min_x 0.5 x'Gx - b'x   s.t. x >= 0
// which covers every reference solver call after the normal-equation
// reduction (SURVEY.md section 2.3):
//   * nnls(A, y):             G = A'A,          b = A'y
//   * lasso(A, y, l1, l2):    G = A'A + l2 I,   b = A'y - l1
// Used as (a) the correctness oracle for the batched TPU solvers and
// (b) a CPU fallback path. Exported with a plain C ABI for ctypes.
//
// Copy of native/amico_native.cpp for amico_tpu_torch, which imports
// nothing of amico_tpu: amico_tpu_torch/ops/native.py builds it with g++.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// In-place Cholesky of the k x k row-major matrix M.  Returns false if the
// factorization breaks down (singular submatrix).  Sizes are tiny (<= ~200).
bool chol_factor(std::vector<double>& M, int k) {
  for (int i = 0; i < k; ++i) {
    for (int j = 0; j <= i; ++j) {
      double s = M[i * k + j];
      for (int p = 0; p < j; ++p) s -= M[i * k + p] * M[j * k + p];
      if (i == j) {
        if (s <= 0.0) return false;
        M[i * k + i] = std::sqrt(s);
      } else {
        M[i * k + j] = s / M[j * k + j];
      }
    }
  }
  return true;
}

// Solve (L L') z = z in place given the factored M from chol_factor.
void chol_apply(const std::vector<double>& M, std::vector<double>& z, int k) {
  for (int i = 0; i < k; ++i) {
    double s = z[i];
    for (int p = 0; p < i; ++p) s -= M[i * k + p] * z[p];
    z[i] = s / M[i * k + i];
  }
  for (int i = k - 1; i >= 0; --i) {
    double s = z[i];
    for (int p = i + 1; p < k; ++p) s -= M[p * k + i] * z[p];
    z[i] = s / M[i * k + i];
  }
}

// Solve the symmetric positive-definite system M z = r via Cholesky.
bool chol_solve(std::vector<double>& M, std::vector<double>& z, int k) {
  if (!chol_factor(M, k)) return false;
  chol_apply(M, z, k);
  return true;
}

}  // namespace

extern "C" {

// Exact non-negative QP: min 0.5 x'Gx - b'x, x >= 0.
// G: n x n symmetric PSD (row-major), b: n, x: n (output).
// Active-set iteration in the style of Lawson-Hanson NNLS.
// Returns the number of outer iterations used, or -1 on failure.
int amico_qp_nonneg(const double* G, const double* b, int n, double* x) {
  std::vector<char> in_P(n, 0);
  std::vector<int> P;
  std::vector<double> w(n), z, M;
  std::fill(x, x + n, 0.0);

  const double tol = 1e-12;
  int outer = 0;
  const int max_outer = 30 * n + 100;

  while (outer++ < max_outer) {
    // w = b - Gx (negative gradient)
    double wmax = -1.0;
    int jmax = -1;
    for (int i = 0; i < n; ++i) {
      double wi = b[i];
      for (int j = 0; j < n; ++j) wi -= G[i * n + j] * x[j];
      w[i] = wi;
      if (!in_P[i] && wi > wmax) { wmax = wi; jmax = i; }
    }
    // scale-aware stopping: |w| relative to |b|
    double bscale = 0.0;
    for (int i = 0; i < n; ++i) bscale = std::max(bscale, std::fabs(b[i]));
    if (jmax < 0 || wmax <= tol * std::max(1.0, bscale)) return outer;

    in_P[jmax] = 1;
    P.push_back(jmax);

    // inner loop: solve the unconstrained problem on P, step back if any
    // component would go nonpositive
    while (true) {
      int k = static_cast<int>(P.size());
      M.assign(k * k, 0.0);
      z.assign(k, 0.0);
      for (int a = 0; a < k; ++a) {
        z[a] = b[P[a]];
        for (int c = 0; c < k; ++c) M[a * k + c] = G[P[a] * n + P[c]];
        // tiny ridge for numerical safety on nearly-collinear atoms
        M[a * k + a] += 1e-13 * (M[a * k + a] + 1.0);
      }
      if (!chol_solve(M, z, k)) return -1;

      bool all_pos = true;
      double alpha = 1.0;
      for (int a = 0; a < k; ++a) {
        if (z[a] <= 0.0) {
          all_pos = false;
          double xa = x[P[a]];
          double denom = xa - z[a];
          if (denom > 0.0) alpha = std::min(alpha, xa / denom);
        }
      }
      if (all_pos) {
        for (int a = 0; a < k; ++a) x[P[a]] = z[a];
        break;
      }
      // move x toward z by alpha, drop zeroed coordinates from P
      for (int a = 0; a < k; ++a) x[P[a]] += alpha * (z[a] - x[P[a]]);
      std::vector<int> P_new;
      for (int a = 0; a < k; ++a) {
        if (x[P[a]] > tol) {
          P_new.push_back(P[a]);
        } else {
          x[P[a]] = 0.0;
          in_P[P[a]] = 0;
        }
      }
      P.swap(P_new);
      if (P.empty()) break;
    }
  }
  return -1;  // did not converge
}

// NNLS on (A: m x n column-major like the reference's Fortran buffers,
// models.pyx:570-576): min ||y - Ax||_2, x >= 0.  r_norm receives the
// residual 2-norm (the SPAMS nnls out-param, models.pyx:911).
int amico_nnls(const double* A, const double* y, int m, int n, double* x,
               double* r_norm) {
  std::vector<double> G(n * n), b(n);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      double s = 0.0;
      for (int k = 0; k < m; ++k) s += A[i * m + k] * A[j * m + k];
      G[i * n + j] = s;
      G[j * n + i] = s;
    }
    double s = 0.0;
    for (int k = 0; k < m; ++k) s += A[i * m + k] * y[k];
    b[i] = s;
  }
  int it = amico_qp_nonneg(G.data(), b.data(), n, x);
  if (r_norm) {
    double rr = 0.0;
    for (int k = 0; k < m; ++k) {
      double r = y[k];
      for (int i = 0; i < n; ++i) r -= A[i * m + k] * x[i];
      rr += r * r;
    }
    *r_norm = std::sqrt(rr);
  }
  return it;
}

// Non-negative elastic net with SPAMS mode=2/pos semantics
// (models.pyx:615,926):  min 0.5||y - Ax||^2 + l1 1'x + 0.5 l2 ||x||^2, x>=0.
// A is m x n column-major.  Solved by Lawson-Hanson active set on the
// normal equations (most-violated-first pivoting).
int amico_lasso(const double* A, const double* y, int m, int n, double* x,
                double lambda1, double lambda2) {
  std::vector<double> G(n * n), b(n);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      double s = 0.0;
      for (int k = 0; k < m; ++k) s += A[i * m + k] * A[j * m + k];
      G[i * n + j] = s;
      G[j * n + i] = s;
    }
    G[i * n + i] += lambda2;
    double s = 0.0;
    for (int k = 0; k < m; ++k) s += A[i * m + k] * y[k];
    b[i] = s - lambda1;
  }
  return amico_qp_nonneg(G.data(), b.data(), n, x);
}

// LARS/homotopy solver for the same non-negative elastic net, replicating
// the algorithm the reference actually runs: SPAMS' lasso is LARS-homotopy
// (coreLARS2, mode=2 penalty formulation, pos=true) -- see the call sites
// at reference amico/models.pyx:615,926,1238,1569 via cyspams.
//
// Inputs are the ridge-folded normal equations: G = A'A + l2 I, b = A'y
// (NOT shifted by l1 -- the homotopy runs the l1 path itself).
//
// Path semantics.  KKT for  min 0.5 x'Gx - b'x + lam * 1'x, x >= 0:
//   active i (x_i > 0):   c_i := b_i - (Gx)_i = lam
//   inactive i (x_i = 0): c_i <= lam
// Start at lam = max_i b_i with x = 0 (KKT-satisfying); decrease lam.  On
// the segment with active set P:  x_P(lam) = G_PP^{-1} (b_P - lam 1), a
// linear path.  The next event as lam decreases is the largest lam' < lam
// at which either (a) an inactive correlation catches up, c_i(lam') = lam'
//   => lam'_i = (b_i - q_i) / (1 - p_i), with p = G_{.,P} u, q = G_{.,P} v,
//      u = G_PP^{-1} 1, v = G_PP^{-1} b_P  (only p_i < 1 can cross), or
// (b) an active coefficient hits zero: lam'_a = v_a / u_a.
// Stop when lam reaches lambda1 (the requested penalty) and return
// x_P(lambda1).  With l2 > 0 the objective is strictly convex, so the
// path endpoint is the unique optimum; what LARS pins down -- and what
// most-violated-first active-set pivoting does not -- is WHICH vertex is
// reported on near-degenerate dictionaries (duplicate atoms), where the
// optimizer is numerically flat across neighboring supports.
// Returns the number of path events, or -1 if the event cap is exceeded.
int amico_qp_lars_nonneg(const double* G, const double* b, int n,
                         double lambda1, double* x) {
  std::fill(x, x + n, 0.0);
  double lam = 0.0;
  int j0 = -1;
  for (int i = 0; i < n; ++i) {
    if (b[i] > lam) { lam = b[i]; j0 = i; }
  }
  const double scale = std::max(1.0, lam);
  const double tol = 1e-12 * scale;
  if (j0 < 0 || lam <= lambda1 + tol) return 0;  // x = 0 is optimal

  std::vector<char> in_P(n, 0);
  std::vector<int> P;
  P.reserve(n);
  P.push_back(j0);
  in_P[j0] = 1;

  std::vector<double> M, u, v, lam_enter(n);
  const int max_events = 8 * n + 50;
  for (int ev = 0; ev < max_events; ++ev) {
    const int k = static_cast<int>(P.size());
    // factor G_PP once, solve for u (rhs = 1) and v (rhs = b_P)
    M.assign(k * k, 0.0);
    u.assign(k, 1.0);
    v.assign(k, 0.0);
    for (int a = 0; a < k; ++a) {
      v[a] = b[P[a]];
      for (int c = 0; c < k; ++c) M[a * k + c] = G[P[a] * n + P[c]];
      M[a * k + a] += 1e-13 * (M[a * k + a] + 1.0);
    }
    if (!chol_factor(M, k)) return -1;
    chol_apply(M, u, k);
    chol_apply(M, v, k);

    // entering events: lam'_i = (b_i - q_i) / (1 - p_i), p_i < 1
    double lam_in = -1.0;
    int j_in = -1;
    for (int i = 0; i < n; ++i) {
      if (in_P[i]) continue;
      double p = 0.0, q = 0.0;
      for (int a = 0; a < k; ++a) {
        const double g = G[i * n + P[a]];
        p += g * u[a];
        q += g * v[a];
      }
      const double denom = 1.0 - p;
      if (denom <= 1e-12) continue;  // correlation can't catch the path
      const double li = (b[i] - q) / denom;
      // strict decrease guards against an atom dropped at this lam
      // re-entering forever (degenerate-dictionary cycling)
      if (li < lam - tol && li > lam_in) { lam_in = li; j_in = i; }
    }
    // leaving events: lam'_a = v_a / u_a crossing zero from above
    double lam_out = -1.0;
    int a_out = -1;
    for (int a = 0; a < k; ++a) {
      // x_a(lam) = v_a - lam u_a >= 0 now; with u_a > 0 the crossing
      // v_a/u_a sits at or above lam, and x_a grows as lam decreases --
      // only u_a < 0 can zero a coefficient further down the path.
      if (u[a] >= 0.0) continue;
      const double la = v[a] / u[a];
      if (la < lam - tol && la > lam_out) { lam_out = la; a_out = a; }
    }

    const double lam_next = std::max(lam_in, lam_out);
    if (lam_next <= lambda1) {
      // path endpoint: x_P(lambda1)
      for (int a = 0; a < k; ++a) {
        const double xa = v[a] - lambda1 * u[a];
        x[P[a]] = xa > 0.0 ? xa : 0.0;
      }
      return ev + 1;
    }
    if (lam_out >= lam_in) {
      // drop the zeroed coordinate, keep the rest on-path at lam_next
      for (int a = 0; a < k; ++a) x[P[a]] = v[a] - lam_next * u[a];
      const int drop = P[a_out];
      x[drop] = 0.0;
      in_P[drop] = 0;
      P.erase(P.begin() + a_out);
      if (P.empty()) {
        // restart: pick the most correlated atom at lam_next (x = 0 here).
        // The atom just dropped at lam_next is excluded -- re-adding it at
        // the same lambda cycles drop/re-add until the event cap on
        // degenerate inputs (same strict-decrease rationale as entering
        // events above)
        int jr = -1;
        double br = lam_next;
        for (int i = 0; i < n; ++i) {
          if (i == drop) continue;
          if (b[i] > br) { br = b[i]; jr = i; }
        }
        if (jr < 0) return ev + 1;  // KKT holds at x = 0 below lam_next
        P.push_back(jr);
        in_P[jr] = 1;
      }
    } else {
      for (int a = 0; a < k; ++a) x[P[a]] = v[a] - lam_next * u[a];
      P.push_back(j_in);
      in_P[j_in] = 1;
    }
    lam = lam_next;
  }
  return -1;  // event cap exceeded (pathological degeneracy)
}

// Non-negative elastic net via the LARS/homotopy path -- the algorithm
// SPAMS runs for the reference's lasso calls.  A is m x n column-major.
int amico_lasso_lars(const double* A, const double* y, int m, int n,
                     double* x, double lambda1, double lambda2) {
  std::vector<double> G(n * n), b(n);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      double s = 0.0;
      for (int k = 0; k < m; ++k) s += A[i * m + k] * A[j * m + k];
      G[i * n + j] = s;
      G[j * n + i] = s;
    }
    G[i * n + i] += lambda2;
    double s = 0.0;
    for (int k = 0; k < m; ++k) s += A[i * m + k] * y[k];
    b[i] = s;
  }
  return amico_qp_lars_nonneg(G.data(), b.data(), n, lambda1, x);
}

// Fused DWI load-time preprocessing: intensity rescale + non-finite
// handling + b0 normalization + output stats, in ONE threaded read+write
// pass over the volume (plus one small pass over the b0 volumes).
//
// The staged NumPy pipeline (amico_tpu/pipeline.py: intensity_rescale ->
// ensure_finite -> b0_normalize -> min/mean/max prints -> ensure_finite)
// walks the full 4-D volume six times with three full-size temporaries;
// on a full-brain DWI that is ~1.4s of a 3.9s subject pipeline.  This
// native stage mirrors the reference's load semantics
// (reference amico/core.py:146-158,209-223) at memory-bandwidth
// speed.  It is a host *runtime* component, not a compute kernel: the
// solves stay on the TPU (SURVEY.md section 2.3 note on native layers).
//
// Layout: `raw` and `out` hold nS volumes of nvox floats each, volume-
// major -- exactly the NIfTI on-disk order, so `raw` can be the mmap of
// the file's data section (zero host copies before this pass).
//
//   rescale:      0 = identity; 1 = val*slope + inter first
//   fill_enabled: 0 = only count non-finite values; 1 = substitute `fill`
//                 (the pipeline's replace_bad_voxels option)
//   normalize:    0 = copy/rescale only; 1 = divide by the voxelwise mean
//                 of the b0 volumes listed in b0_idx, zeroing voxels whose
//                 mean b0 is <= b0_min_signal * mean(positive mean b0)
//
// Outputs: `out` (preprocessed volume), `mean_b0` (nvox, written only
// when normalize), `stats` = {min, max, sum} of the final `out`, and the
// two non-finite counters (raw values after rescale / final outputs).
// Returns 0; -1 on invalid arguments.
int amico_preprocess_dwi(const float* raw, long long nvox, int nS,
                         const int* b0_idx, int n_b0,
                         float slope, float inter, int rescale,
                         double b0_min_signal,
                         int fill_enabled, float fill,
                         int normalize,
                         float* out, float* mean_b0, double* stats,
                         long long* raw_bad, long long* out_bad,
                         int nthreads) {
  if (nvox <= 0 || nS <= 0 || (normalize && n_b0 <= 0)) return -1;
  if (nthreads < 1) nthreads = 1;
  const int nt = std::min<long long>(nthreads, nvox);

  std::vector<float> inv;
  if (normalize) {
    inv.resize(nvox);
    // pass A: voxelwise mean of the b0 volumes (rescaled + filled, so the
    // mean sees the same values the staged ensure_finite(raw) would have
    // produced), then the positive-mean floor reduction
    std::vector<double> pos_sum(nt, 0.0);
    std::vector<long long> pos_cnt(nt, 0);
    std::vector<std::thread> ths;
    const long long step = (nvox + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      ths.emplace_back([&, t]() {
        const long long v0 = t * step;
        const long long v1 = std::min(nvox, v0 + step);
        double ps = 0.0;
        long long pc = 0;
        for (long long v = v0; v < v1; ++v) {
          double s = 0.0;
          for (int k = 0; k < n_b0; ++k) {
            float val = raw[(long long)b0_idx[k] * nvox + v];
            if (rescale) val = val * slope + inter;
            if (fill_enabled && !std::isfinite(val)) val = fill;
            s += val;
          }
          const float m = (float)(s / n_b0);
          mean_b0[v] = m;
          if (m > 0.0f) { ps += m; ++pc; }
        }
        pos_sum[t] = ps;
        pos_cnt[t] = pc;
      });
    }
    for (auto& th : ths) th.join();
    double ps = 0.0;
    long long pc = 0;
    for (int t = 0; t < nt; ++t) { ps += pos_sum[t]; pc += pos_cnt[t]; }
    const double floor_ = b0_min_signal * (pc ? ps / pc : 0.0);
    for (long long v = 0; v < nvox; ++v) {
      const float m = mean_b0[v];
      inv[v] = ((double)m <= floor_) ? 0.0f : 1.0f / m;
    }
  }

  // pass B: rescale + fill + normalize + output stats, threaded over
  // volumes (each volume is a contiguous nvox-float block)
  std::vector<double> mins(nt, HUGE_VAL), maxs(nt, -HUGE_VAL),
      sums(nt, 0.0);
  std::vector<long long> rbad(nt, 0), obad(nt, 0);
  {
    std::atomic<int> next(0);
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t) {
      ths.emplace_back([&, t]() {
        double mn = HUGE_VAL, mx = -HUGE_VAL, sm = 0.0;
        long long rb = 0, ob = 0;
        int s;
        while ((s = next.fetch_add(1)) < nS) {
          const float* src = raw + (long long)s * nvox;
          float* dst = out + (long long)s * nvox;
          for (long long v = 0; v < nvox; ++v) {
            float val = src[v];
            if (rescale) val = val * slope + inter;
            if (!std::isfinite(val)) {
              ++rb;
              if (fill_enabled) val = fill;
            }
            if (normalize) val *= inv[v];
            if (!std::isfinite(val)) {
              ++ob;
              if (fill_enabled) val = fill;
            }
            dst[v] = val;
            if (val < mn) mn = val;
            if (val > mx) mx = val;
            sm += val;
          }
        }
        mins[t] = mn; maxs[t] = mx; sums[t] = sm;
        rbad[t] = rb; obad[t] = ob;
      });
    }
    for (auto& th : ths) th.join();
  }
  double mn = HUGE_VAL, mx = -HUGE_VAL, sm = 0.0;
  long long rb = 0, ob = 0;
  for (int t = 0; t < nt; ++t) {
    mn = std::min(mn, mins[t]);
    mx = std::max(mx, maxs[t]);
    sm += sums[t];
    rb += rbad[t];
    ob += obad[t];
  }
  stats[0] = mn; stats[1] = mx; stats[2] = sm;
  *raw_bad = rb; *out_bad = ob;
  return 0;
}

// Masked voxel extraction fused with negative clipping and zero pad rows
// (the tile engine's gather layout).  ``vol`` is the F-contiguous 4-D
// volume as stored on disk / by amico_preprocess_dwi: element (v, s) at
// vol[(long long)s * nvox + v] where v is the F-order linear voxel index.
// ``vidx`` lists the masked voxels' F-order indices in the row order the
// caller wants (the facade passes C-order mask enumeration to match
// numpy's boolean indexing, pipeline.masked_voxels / scatter).  Writes
// ``out`` (n + pad_rows, nS) row-major float32: row r is the clipped
// signal of voxel vidx[r]; the last pad_rows rows are zeroed.  Replaces
// three full-volume NumPy passes (transpose-gather + clip + pad concat).
int amico_masked_gather(const float* vol, long long nvox, int nS,
                        const long long* vidx, long long n,
                        float* out, int pad_rows, int clip, int nthreads) {
  if (nvox <= 0 || nS <= 0 || n < 0 || pad_rows < 0) return -1;
  if (nthreads < 1) nthreads = 1;
  const int nt = (int)std::min<long long>(nthreads, n > 0 ? n : 1);
  std::vector<std::thread> ths;
  const long long step = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    ths.emplace_back([&, t]() {
      const long long r0 = t * step;
      const long long r1 = std::min(n, r0 + step);
      // cache-blocked transpose: a row block's output (~800KB) stays in
      // L2 while each sample volume contributes a short sequential read
      // run; the naive row-major loop touched a distinct page per sample
      // per row (measured 0.9s vs ~0.25s blocked for a full brain)
      const long long RB = 2048;
      for (long long rb = r0; rb < r1; rb += RB) {
        const long long re = std::min(r1, rb + RB);
        for (int s = 0; s < nS; ++s) {
          const float* src = vol + (long long)s * nvox;
          for (long long r = rb; r < re; ++r) {
            float val = src[vidx[r]];
            if (clip && val < 0.0f) val = 0.0f;
            out[r * nS + s] = val;
          }
        }
      }
    });
  }
  for (auto& th : ths) th.join();
  if (pad_rows > 0)
    std::fill(out + n * nS, out + (n + pad_rows) * nS, 0.0f);
  return 0;
}

}  // extern "C"
