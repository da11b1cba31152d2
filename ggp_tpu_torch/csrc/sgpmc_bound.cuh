// Whitened JointHMC (SGPMC) potential of the Scale(RBF-ARD) x Gaussian x
// Zero-mean model: value and analytic gradient over the state row
// [log_lengthscale (d), log_outputscale, log_noise, v (m)], in one
// block-wide device function, the "sgpmc" core of the sampler kernels and
// of the warm start (sgpmc_warm.cu).
//
// Replaces: ggp_tpu/ops/fused_bound.py `_sgpmc_neg_logpost_vg` (the core the
// fused Pallas kernels run with target="sgpmc", and `make_fused_sgpmc_warm`
// with want_z_grad), and its chain-batched twin
// ggp_tpu/ops/fused_multichain.py `_sgpmc_batched_vg`. Plain twin:
// ggp_tpu_torch/ops/sgpmc_bound.py (its docstring has the adjoint).
// The (128,128) permutation that moves v into lanes in the JAX core is a
// Mosaic layout workaround and has no counterpart here: v is read from the
// state row where it lies.
//
// What bounds it on the card: the same as vfe_bound.cuh. One block runs a
// dependent chain: one M-step Cholesky with a barrier per pivot, then
// triangular solves against the factor with N + M + M right-hand sides
// (one thread per right-hand side, M sequential rows each) and O(N M^2)
// products, all reading a global scratch area that stays in L2 (3 N M + 6
// M^2 values, 1 MB in f32 at N=404, M=100). Latency, not FLOPs or HBM.
//
// What the design does about it: no explicit inverse is formed (A = L^-1
// Kms, Kms_b = L^-T Abar and Kmm_b = -L^-T S L^-1 / 2 are substitutions
// against U = L^T), the solves of independent right-hand sides run in one
// pass over the block, and every symmetric result (S, Kmm_b, Pmm) is
// formed once per pair. Pivot policy as vfe_bound.cuh: floor <= 0 gives
// NaN on a non-positive pivot (sampler divergence), floor > 0 the trainers'
// modified Cholesky, relative to max(sf2, 1).
#pragma once

#include "vfe_bound.cuh"

namespace ggp {

// Global-memory work matrices of one evaluation; m x n matrices are stored
// row-major with n contiguous (row a at a*n), so the thread-per-column
// solves read consecutive addresses across a warp.
template <typename T>
struct SgpmcWork {
  T *Kms, *A, *Ab;                          // m x n (Ab: Abar -> Kms_b -> Pms)
  T *Kmm, *W, *U, *S, *Y, *Kb;              // m x m (W: jittered Kmm -> Pmm)
  T *xn, *e, *msk, *cs_ms;                  // n
  T *zn, *gv, *rs_mm, *rs_ms, *spare;       // m
  T *PmmZs, *PmsXs;                         // m x d
};

__host__ __device__ inline long sgpmc_work_elems(int n, int m, int d) {
  return 3L * n * m + 6L * m * m + 4L * n + 5L * m + 2L * m * d;
}

template <typename T>
__device__ SgpmcWork<T> make_sgpmc_work(T* s, int n, int m, int d) {
  SgpmcWork<T> w;
  const long nm = (long)n * m, mm = (long)m * m;
  w.Kms = s; s += nm; w.A = s; s += nm; w.Ab = s; s += nm;
  w.Kmm = s; s += mm; w.W = s; s += mm; w.U = s; s += mm; w.S = s; s += mm;
  w.Y = s; s += mm; w.Kb = s; s += mm;
  w.xn = s; s += n; w.e = s; s += n; w.msk = s; s += n; w.cs_ms = s; s += n;
  w.zn = s; s += m; w.gv = s; s += m; w.rs_mm = s; s += m; w.rs_ms = s; s += m;
  w.spare = s; s += m;
  w.PmmZs = s; s += (long)m * d; w.PmsXs = s;
  return w;
}

// U_out = -(log posterior), g_out = dU/dstate (d+2+m entries), dZ_out =
// dU/dZ (m x d) when cf.want_z. cf.want_prior adds the Gamma(2,1) priors on
// the d+2 hypers (the N(0, I) term on v is always in). st must be visible
// to all threads on entry; the outputs are visible to all threads on
// return. U_out is written by thread 0.
template <typename T>
__device__ void sgpmc_bound(const BoundCfg& cf, const T* st, const T* X,
                            const T* y, const T* Z, const SgpmcWork<T>& w,
                            BoundShared<T>& sh, T* U_out, T* g_out, T* dZ_out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = cf.n, m = cf.m, d = cf.d;
  const T jitter = T(cf.jitter);
  const bool floored = cf.floor > 0.0;
  const T fl = T(cf.floor);
  const T pr = cf.want_prior ? T(1) : T(0);
  const T* v = st + d + 2;
  T* il = sh.inv_ls;

  // capped inverse lengthscale: min(exp(-log_ls), 1024 / max(1e-3, |X|, |Z|))
  T mx = T(0);
  for (int i = tid; i < n * d; i += nt) mx = jmax(mx, gabs(X[i]));
  for (int i = tid; i < m * d; i += nt) mx = jmax(mx, gabs(Z[i]));
  mx = jmax(block_max(mx, sh.red), T(1e-3));
  const T cap = T(1024) / mx;
  for (int k = tid; k < d; k += nt) il[k] = jmin(gexp(-st[k]), cap);
  const T sf2 = gexp(st[d]);
  const T s2 = gexp(st[d + 1]);
  const T jit_scale = jmax(sf2, T(1));
  __syncthreads();

  for (int i = tid; i < n; i += nt) {
    T s = T(0);
    for (int k = 0; k < d; ++k) { const T a = X[i * d + k] * il[k]; s += a * a; }
    w.xn[i] = s;
  }
  for (int a = tid; a < m; a += nt) {
    T s = T(0);
    for (int k = 0; k < d; ++k) { const T b = Z[a * d + k] * il[k]; s += b * b; }
    w.zn[a] = s;
  }
  __syncthreads();

  // grams by norm expansion, clamped at 0; W = Kmm + relative jitter
  for (int idx = tid; idx < m * n; idx += nt) {
    const int a = idx / n, i = idx % n;
    T dot = T(0);
    for (int k = 0; k < d; ++k) dot += (Z[a * d + k] * il[k]) * (X[i * d + k] * il[k]);
    const T r2 = jmax(w.zn[a] + w.xn[i] - T(2) * dot, T(0));
    w.Kms[idx] = sf2 * gexp(T(-0.5) * r2);
  }
  for (int idx = tid; idx < m * m; idx += nt) {
    const int a = idx / m, b = idx % m;
    T dot = T(0);
    for (int k = 0; k < d; ++k) dot += (Z[a * d + k] * il[k]) * (Z[b * d + k] * il[k]);
    const T r2 = jmax(w.zn[a] + w.zn[b] - T(2) * dot, T(0));
    const T kab = sf2 * gexp(T(-0.5) * r2);
    w.Kmm[idx] = kab;
    w.W[idx] = kab + (a == b ? jitter * jit_scale : T(0));
  }
  __syncthreads();
  chol_upper(w.W, w.U, m, fl * jit_scale, floored);   // U = L^T

  // A = L^-1 Kms, one thread per column i (forward substitution with U^T),
  // and the whitened conditional at x_i: mean A_i^T v, var sf2 - ||A_i||^2
  T p_see = T(0), p_svar = T(0), p_msk = T(0), p_vv = T(0);
  for (int i = tid; i < n; i += nt) {
    T mean = T(0), aa = T(0);
    for (int a = 0; a < m; ++a) {
      T s = w.Kms[a * n + i];
      for (int l = 0; l < a; ++l) s -= w.U[l * m + a] * w.A[l * n + i];
      const T ai = s / w.U[a * m + a];
      w.A[a * n + i] = ai;
      mean += v[a] * ai;
      aa += ai * ai;
    }
    const T e = y[i] - mean;
    const T var_raw = sf2 - aa;
    const T mk = var_raw > T(1e-12) ? T(1) : T(0);
    w.e[i] = e;
    w.msk[i] = mk;
    p_see += e * e;
    p_svar += jmax(var_raw, T(1e-12));
    p_msk += mk;
  }
  for (int a = tid; a < m; a += nt) p_vv += v[a] * v[a];
  const T see = block_sum(p_see, sh.red);
  const T svar = block_sum(p_svar, sh.red);
  const T nmsk = block_sum(p_msk, sh.red);
  const T vv = block_sum(p_vv, sh.red);

  // dF/dv = A e / s2 - v ; Abar = (v e^T + A o msk) / s2
  for (int a = tid; a < m; a += nt) {
    T s = T(0);
    for (int i = 0; i < n; ++i) s += w.A[a * n + i] * w.e[i];
    w.gv[a] = s / s2 - v[a];
  }
  for (int idx = tid; idx < m * n; idx += nt) {
    const int a = idx / n, i = idx % n;
    w.Ab[idx] = (v[a] * w.e[i] + w.A[idx] * w.msk[i]) / s2;
  }
  __syncthreads();

  // S = tril(Abar A^T) + tril(Abar A^T, -1)^T, one entry per pair
  for (int idx = tid; idx < m * m; idx += nt) {
    const int a = idx / m, b = idx % m;
    if (a < b) continue;
    T s = T(0);
    for (int i = 0; i < n; ++i) s += w.Ab[a * n + i] * w.A[b * n + i];
    w.S[a * m + b] = s;
    w.S[b * m + a] = s;
  }
  __syncthreads();

  // columns 0..n-1: Kms_b = L^-T Abar in place, then Pms = Kms_b o Kms and
  // its column sums; columns n..n+m-1: Y = L^-T S (back substitution)
  for (int col = tid; col < n + m; col += nt) {
    if (col < n) {
      const int i = col;
      for (int a = m - 1; a >= 0; --a) {
        T s = w.Ab[a * n + i];
        for (int l = a + 1; l < m; ++l) s -= w.U[a * m + l] * w.Ab[l * n + i];
        w.Ab[a * n + i] = s / w.U[a * m + a];
      }
      T cs = T(0);
      for (int a = 0; a < m; ++a) {
        const T p = w.Ab[a * n + i] * w.Kms[a * n + i];
        w.Ab[a * n + i] = p;
        cs += p;
      }
      w.cs_ms[i] = cs;
    } else {
      const int c = col - n;
      for (int a = m - 1; a >= 0; --a) {
        T s = w.S[a * m + c];
        for (int l = a + 1; l < m; ++l) s -= w.U[a * m + l] * w.Y[l * m + c];
        w.Y[a * m + c] = s / w.U[a * m + a];
      }
    }
  }
  __syncthreads();

  // Kmm_b = -(1/2) L^-T S L^-1 = -(1/2) U^-1 Y^T, one thread per column c
  for (int c = tid; c < m; c += nt) {
    for (int a = m - 1; a >= 0; --a) {
      T s = T(-0.5) * w.Y[c * m + a];
      for (int l = a + 1; l < m; ++l) s -= w.U[a * m + l] * w.Kb[l * m + c];
      w.Kb[a * m + c] = s / w.U[a * m + a];
    }
  }
  __syncthreads();

  // symmetrise Kmm_b pairwise; Pmm = Kmm_b o Kmm (into W), its sum and tr
  T p_mm = T(0), p_tr = T(0);
  for (int idx = tid; idx < m * m; idx += nt) {
    const int a = idx / m, b = idx % m;
    if (a < b) continue;
    const T t = T(0.5) * (w.Kb[a * m + b] + w.Kb[b * m + a]);
    const T p = t * w.Kmm[a * m + b];
    w.W[a * m + b] = p;
    w.W[b * m + a] = p;
    if (a == b) { p_mm += p; p_tr += t; }
    else p_mm += T(2) * p;
  }
  __syncthreads();

  // row sums (Pmm is symmetric: its column sums are its row sums) and the
  // products with the scaled inputs
  T p_ms = T(0);
  for (int i = tid; i < n; i += nt) p_ms += w.cs_ms[i];
  for (int a = tid; a < m; a += nt) {
    T r1 = T(0), r2 = T(0);
    for (int b = 0; b < m; ++b) r1 += w.W[a * m + b];
    for (int i = 0; i < n; ++i) r2 += w.Ab[a * n + i];
    w.rs_mm[a] = r1;
    w.rs_ms[a] = r2;
  }
  for (int idx = tid; idx < m * d; idx += nt) {
    const int a = idx / d, k = idx % d;
    T s1 = T(0), s2b = T(0);
    for (int b = 0; b < m; ++b) s1 += w.W[a * m + b] * (Z[b * d + k] * il[k]);
    for (int i = 0; i < n; ++i) s2b += w.Ab[a * n + i] * (X[i * d + k] * il[k]);
    w.PmmZs[idx] = s1;
    w.PmsXs[idx] = s2b;
  }
  const T S_mm = block_sum(p_mm, sh.red);
  const T S_ms = block_sum(p_ms, sh.red);
  const T tr_Kb = block_sum(p_tr, sh.red);

  // RBF-ARD chain rule to the log-lengthscales, plus the prior
  for (int k = tid; k < d; k += nt) {
    T t = T(0);
    for (int a = 0; a < m; ++a) {
      const T zs = Z[a * d + k] * il[k];
      t += (T(2) * w.rs_mm[a] + w.rs_ms[a]) * zs * zs
           - T(2) * zs * (w.PmmZs[a * d + k] + w.PmsXs[a * d + k]);
    }
    for (int i = 0; i < n; ++i) {
      const T xs = X[i * d + k] * il[k];
      t += w.cs_ms[i] * xs * xs;
    }
    g_out[k] = -(t + pr * (T(2) - gexp(st[k])));
  }
  for (int a = tid; a < m; a += nt) g_out[d + 2 + a] = -w.gv[a];
  if (tid == 0) {
    const T nT = T(n);
    T F = T(-0.5) * nT * glog(T(6.283185307179586) * s2)
          - T(0.5) * (see + svar) / s2 - T(0.5) * vv;
    if (cf.want_prior) {
      T lp = T(0);
      for (int k = 0; k < d + 2; ++k) lp += T(2) * st[k] - gexp(st[k]);
      F += lp;
    }
    const T dF_ds2 = T(-0.5) * nT / s2 + T(0.5) * (see + svar) / (s2 * s2);
    const T dlog_os = S_mm + S_ms + jitter * sf2 * (sf2 > T(1) ? T(1) : T(0)) * tr_Kb
                      - T(0.5) * nmsk * sf2 / s2 + pr * (T(2) - sf2);
    g_out[d] = -dlog_os;
    g_out[d + 1] = -(dF_ds2 * s2 + pr * (T(2) - s2));
    *U_out = -F;
  }
  if (cf.want_z && dZ_out != nullptr) {
    for (int idx = tid; idx < m * d; idx += nt) {
      const int a = idx / d, k = idx % d;
      const T zs = Z[idx] * il[k];
      const T dzs = T(-2) * (w.rs_mm[a] * zs - w.PmmZs[idx])
                    - (w.rs_ms[a] * zs - w.PmsXs[idx]);
      dZ_out[idx] = -(dzs * il[k]);
    }
  }
  __syncthreads();
}

// The "sgpmc" core as the sampler kernels take it (see VfeCore).
template <typename T>
struct SgpmcCore {
  using WorkT = SgpmcWork<T>;
  static __host__ __device__ int dim(const BoundCfg& cf) { return cf.d + 2 + cf.m; }
  static __host__ __device__ long elems(const BoundCfg& cf) {
    return sgpmc_work_elems(cf.n, cf.m, cf.d);
  }
  static __device__ WorkT work(T* s, const BoundCfg& cf) {
    return make_sgpmc_work(s, cf.n, cf.m, cf.d);
  }
  static __device__ void eval(const BoundCfg& cf, const T* z, const T* X,
                              const T* y, const T* Z, const WorkT& w,
                              BoundShared<T>& sh, T* U, T* g, T* dZ) {
    sgpmc_bound(cf, z, X, y, Z, w, sh, U, g, dZ);
  }
};

}  // namespace ggp
