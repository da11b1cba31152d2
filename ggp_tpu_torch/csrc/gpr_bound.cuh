// Dense GP marginal potential of the Scale(RBF-ARD) x Gaussian model (the
// GPR_HMC target): value and analytic gradient over the state row
// [log_lengthscale (d), log_outputscale, log_noise], in one block-wide
// device function, the "gpr" core of the sampler kernels.
//
// Replaces: ggp_tpu/ops/fused_bound.py `_gpr_neg_logpost_vg` (the core the
// fused Pallas kernels of ggp_tpu/ops/fused_nuts.py run with target="gpr":
// the potential call and the NUTS warm and sample chunks). Plain twin:
// ggp_tpu_torch/ops/gpr_bound.py (its docstring has the adjoint). The JAX
// core pads rows to a multiple of 128 for the TPU's lanes; here n is the
// data's own row count.
//
// What bounds it on the card: the N x N factorisation, not FLOPs or HBM.
// One block runs a dependent chain over three N x N matrices in a global
// scratch area that stays in L2 (3 N^2 values: 1.96 MB in f32 at N=404):
// an N-step Cholesky with a barrier per pivot (chol_upper of vfe_bound.cuh,
// floor 0, so a non-positive pivot gives NaN, the samplers' divergence),
// the triangular inverse V = U^-1 (ut_inv, an N-step right-looking
// update), two N-step substitutions, and K^-1 = V V^T (N^3/6
// multiply-adds over 256 threads reading L2). The least work of one
// evaluation is ~N^3 operations (7e7 at N=404), ~1 us at the float32 peak;
// this simple core is bound by latency and instruction throughput far
// above that (chip_smoke.py's parts line times its parts).
//
// What the design does about it: the routines of vfe_bound.cuh, unchanged;
// the strict lower triangle of the factorised matrix W (which chol_upper
// neither reads as data nor writes) holds Kcore, so the adjoint needs no
// fourth N x N area; K^-1 is never stored: each symmetric pair (a, b) forms
// its entry of V V^T, then P = Kbar o Kcore, once per pair, into W. The
// solves run against the factor U, as the JAX core's do. cf.stages (> 0)
// stops after that many of the six parts below, so that a caller can time
// the prefixes of one evaluation (chip_smoke.py); 0 runs them all.
#pragma once

#include "vfe_bound.cuh"

namespace ggp {

constexpr int kGprStages = 6;

// Global-memory work of one evaluation: W (Kcore below the diagonal, K on
// and above it, then P = Kbar o Kcore), U = chol(K)^T, V = U^-1.
template <typename T>
struct GprWork {
  T *W, *U, *V;                          // n x n
  T *xn, *t, *a, *acc, *kd, *rs;         // n
  T *PXs;                                // n x d
};

__host__ __device__ inline long gpr_work_elems(int n, int d) {
  return 3L * n * n + 6L * n + 1L * n * d;
}

template <typename T>
__device__ GprWork<T> make_gpr_work(T* s, int n, int d) {
  GprWork<T> w;
  const long nn = (long)n * n;
  w.W = s; s += nn; w.U = s; s += nn; w.V = s; s += nn;
  w.xn = s; s += n; w.t = s; s += n; w.a = s; s += n; w.acc = s; s += n;
  w.kd = s; s += n; w.rs = s; s += n;
  w.PXs = s;
  return w;
}

// U_out = -(log marginal + log prior), g_out = dU/dtheta (d+2 entries).
// theta must be visible to all threads on entry; the outputs are visible to
// all threads on return. U_out is written by thread 0.
template <typename T>
__device__ void gpr_bound(const BoundCfg& cf, const T* theta, const T* X,
                          const T* y, const GprWork<T>& w, BoundShared<T>& sh,
                          T* U_out, T* g_out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = cf.n, d = cf.d;
  const int stages = cf.stages > 0 ? cf.stages : kGprStages;
  T* il = sh.inv_ls;

  // ---- 1. grams: capped inverse lengthscale min(exp(-theta), 1024 /
  // max(1e-3, max|X|)); Kcore by norm expansion clamped at 0; W = K above
  // and on the diagonal, Kcore below it, the diagonal of Kcore in kd
  T mx = T(0);
  for (int i = tid; i < n * d; i += nt) mx = jmax(mx, gabs(X[i]));
  mx = jmax(block_max(mx, sh.red), T(1e-3));
  const T cap = T(1024) / mx;
  for (int k = tid; k < d; k += nt) il[k] = jmin(gexp(-theta[k]), cap);
  const T sf2 = gexp(theta[d]);
  const T s2 = gexp(theta[d + 1]);
  const T diag_add = s2 + T(cf.jitter);                 // absolute jitter
  __syncthreads();
  for (int i = tid; i < n; i += nt) {
    T s = T(0);
    for (int k = 0; k < d; ++k) { const T xs = X[i * d + k] * il[k]; s += xs * xs; }
    w.xn[i] = s;
  }
  __syncthreads();
  for (int idx = tid; idx < n * n; idx += nt) {
    const int a = idx / n, b = idx % n;
    if (a > b) continue;
    T dot = T(0);
    for (int k = 0; k < d; ++k) dot += (X[a * d + k] * il[k]) * (X[b * d + k] * il[k]);
    const T r2 = jmax(w.xn[a] + w.xn[b] - T(2) * dot, T(0));
    const T kab = sf2 * gexp(T(-0.5) * r2);
    if (a == b) {
      w.W[idx] = kab + diag_add;
      w.kd[a] = kab;
    } else {
      w.W[idx] = kab;
      w.W[b * n + a] = kab;
    }
  }
  __syncthreads();
  if (stages < 2) return;

  // ---- 2. U = chol(K)^T; NaN on a non-positive pivot
  chol_upper(w.W, w.U, n, T(0), false);
  if (stages < 3) return;

  // ---- 3. V = U^-1
  ut_inv(w.U, w.V, n);
  if (stages < 4) return;

  // ---- 4. t = U^-T y, a = U^-1 t = K^-1 y; the value
  ut_t_solve(w.U, y, w.t, w.acc, n);
  ut_solve(w.U, w.t, w.a, w.acc, n);
  T p_ld = T(0), p_q = T(0);
  for (int i = tid; i < n; i += nt) {
    p_ld += glog(w.U[i * n + i]);
    p_q += w.t[i] * w.t[i];
  }
  const T logdet = T(2) * block_sum(p_ld, sh.red);
  const T quad = block_sum(p_q, sh.red);
  if (stages < 5) return;

  // ---- 5. per pair a <= b: (V V^T)_ab = K^-1_ab, Kbar_ab = (a_a a_b -
  // K^-1_ab) / 2, P_ab = Kbar_ab Kcore_ab into W (both triangles)
  T p_tr = T(0), p_sum = T(0);
  for (int idx = tid; idx < n * n; idx += nt) {
    const int a = idx / n, b = idx % n;
    if (a > b) continue;
    T kinv = T(0);
    for (int k = b; k < n; ++k) kinv += w.V[a * n + k] * w.V[b * n + k];
    const T kbar = T(0.5) * (w.a[a] * w.a[b] - kinv);
    if (a == b) {
      const T p = kbar * w.kd[a];
      w.W[idx] = p;
      p_tr += kbar;
      p_sum += p;
    } else {
      const T p = kbar * w.W[b * n + a];
      w.W[idx] = p;
      w.W[b * n + a] = p;
      p_sum += T(2) * p;
    }
  }
  const T tr_kbar = block_sum(p_tr, sh.red);
  const T S_P = block_sum(p_sum, sh.red);
  if (stages < 6) return;

  // ---- 6. row sums of P (= its column sums) and P Xs; the RBF-ARD chain
  // rule to the log-lengthscales; the priors
  for (int i = tid; i < n; i += nt) {
    T s = T(0);
    for (int j = 0; j < n; ++j) s += w.W[i * n + j];
    w.rs[i] = s;
  }
  for (int idx = tid; idx < n * d; idx += nt) {
    const int i = idx / d, k = idx % d;
    T s = T(0);
    for (int j = 0; j < n; ++j) s += w.W[i * n + j] * (X[j * d + k] * il[k]);
    w.PXs[idx] = s;
  }
  __syncthreads();
  for (int k = tid; k < d; k += nt) {
    T t2 = T(0), t3 = T(0);
    for (int i = 0; i < n; ++i) {
      const T xs = X[i * d + k] * il[k];
      t2 += w.rs[i] * xs * xs;
      t3 += xs * w.PXs[i * d + k];
    }
    T lp, gp;
    prior_leaf(cf.leaf[0], theta[k], &lp, &gp);
    g_out[k] = -(T(2) * t2 - T(2) * t3 + gp);
  }
  if (tid == 0) {
    const T F = T(-0.5) * (quad + logdet + T(n) * glog(T(6.283185307179586)));
    T lp_ls = T(0), lp, gp;
    for (int k = 0; k < d; ++k) { prior_leaf(cf.leaf[0], theta[k], &lp, &gp); lp_ls += lp; }
    T lp_os, gp_os, lp_n, gp_n;
    prior_leaf(cf.leaf[1], theta[d], &lp_os, &gp_os);
    prior_leaf(cf.leaf[2], theta[d + 1], &lp_n, &gp_n);
    g_out[d] = -(S_P + gp_os);
    g_out[d + 1] = -(s2 * tr_kbar + gp_n);
    *U_out = -(F + lp_ls + lp_os + lp_n);
  }
  __syncthreads();
}

// The "gpr" core as the sampler kernels take it (see VfeCore). Z and dZ
// are not read: the dense target has no inducing points.
template <typename T>
struct GprCore {
  using WorkT = GprWork<T>;
  static __host__ __device__ int dim(const BoundCfg& cf) { return cf.d + 2; }
  static __host__ __device__ long elems(const BoundCfg& cf) {
    return gpr_work_elems(cf.n, cf.d);
  }
  static __device__ WorkT work(T* s, const BoundCfg& cf) {
    return make_gpr_work(s, cf.n, cf.d);
  }
  static __device__ void eval(const BoundCfg& cf, const T* z, const T* X,
                              const T* y, const T*, const WorkT& w,
                              BoundShared<T>& sh, T* U, T* g, T*) {
    gpr_bound(cf, z, X, y, w, sh, U, g);
  }
};

}  // namespace ggp
