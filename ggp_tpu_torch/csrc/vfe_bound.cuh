// Collapsed Titsias (VFE) bound of the Scale(RBF-ARD) x Gaussian model:
// value and analytic gradient in one block-wide device function, shared by
// every kernel of the port.
//
// Replaces: ggp_tpu/ops/fused_bound.py `_rbf_vfe_neg_logpost_vg` (the core
// every fused Pallas kernel of BayesianSGPR_HMC inlines), with its blocked
// Cholesky + inverse (`chol_u_inv_inplace`), blocked substitutions
// (`ut_t_solve_vec` / `ut_solve_vec`), the lengthscale cap (`capped_inv_ls`)
// and the closed-form priors (`_prior_lane_terms`).
//
// What bounds it on the card: one thread block walks a dependent chain of
// O(N M^2) products and two M x M factorisations with data-dependent
// pivots (M sequential pivot steps, each a block barrier). At the slice
// shape (N=404, M=100) the matrices are a few hundred KB, far above what
// 227 KB of shared memory holds in f64 at M up to 512, so they live in a
// global-memory scratch the wrapper allocates; they stay resident in the
// 50 MB L2. The time is barrier latency and L2 latency, not FLOPs or HBM.
//
// What the design does about it: one block per chain or trainer (a chain
// is sequential; C chains are C blocks, each with its own scratch area of
// work_elems(n, m, d) values), every loop strided over the block's threads, every
// branch decided from values all threads read after a barrier, so control
// flow is uniform and each __syncthreads is reached by the whole block.
// Triangular solves are column-oriented (one barrier per row) and run
// against the factors, not the formed inverses (better at small noise,
// where cond(B) ~ 1/sigma^2). Faster layouts (shared-memory tiles, wgmma,
// several blocks per factorisation) are later work.
//
// Pivot policy: `floor <= 0` gives NaN on a non-positive pivot (sampler
// divergence semantics); `floor > 0` is the trainers' modified Cholesky: a
// pivot below the floor becomes a sqrt(floor) e_i row and its elimination
// is skipped (the semantics of `block_chol_u(..., pivot_floor=...)`).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ggp {

constexpr int kThreads = 256;   // threads of the single block; multiple of 32
constexpr int kMaxDim = 128;    // state length (d + 2, or d + 2 + m) <= kMaxDim
constexpr int kMaxDepth = 10;   // NUTS tree depth bound (checkpoint slots)
static_assert(kThreads >= kMaxDim, "the sampler kernels give each entry of a "
              "state row its own thread");

// Layout of the `cfg` double array every launcher takes (mirrored by
// ggp_tpu_torch/ops/_build.py).
enum CfgIndex {
  C_N = 0, C_M, C_D, C_JITTER, C_FLOOR, C_WANT_PRIOR, C_WANT_ZGRAD,
  C_PRIOR = 7,                       // 3 leaves x (kind, p1, p2, const)
  C_DIM = 19, C_MAX_DEPTH, C_K, C_ADAPT, C_TARGET, C_ADAPT_MASS,
  C_LR, C_CLIP, C_MIN_NOISE, C_T0, C_S_ACT, C_EPS, C_CHAINS, C_LEAPFROG,
  C_STAGES, C_NB, C_NUM_DATA, C_LIK, C_LATENTS, C_NHALF, C_PRIOR_VAR,
  C_QUAD = 40,                       // 20 Gauss-Hermite nodes, then 20 weights
  C_LEN = 80
};

enum PriorKind { P_GAMMA = 0, P_HC_STD, P_HC, P_HALF_NORMAL, P_LOGNORMAL, P_FLAT };

struct PriorLeaf { int kind; double p1, p2, c; };

struct BoundCfg {
  int n, m, d, want_prior, want_z;
  int stages;                        // gpr core: stop after this part (0: all)
  double jitter, floor;
  PriorLeaf leaf[3];                 // lengthscales, outputscale, noise
};

inline BoundCfg bound_cfg(const double* cfg) {
  BoundCfg b;
  b.n = (int)cfg[C_N];
  b.m = (int)cfg[C_M];
  b.d = (int)cfg[C_D];
  b.jitter = cfg[C_JITTER];
  b.floor = cfg[C_FLOOR];
  b.want_prior = (int)cfg[C_WANT_PRIOR];
  b.want_z = (int)cfg[C_WANT_ZGRAD];
  b.stages = (int)cfg[C_STAGES];
  for (int l = 0; l < 3; ++l) {
    const double* p = cfg + C_PRIOR + 4 * l;
    b.leaf[l].kind = (int)p[0];
    b.leaf[l].p1 = p[1];
    b.leaf[l].p2 = p[2];
    b.leaf[l].c = p[3];
  }
  return b;
}

// ---- full-precision math for both types (no fast-math intrinsics) ----
__device__ __forceinline__ float gexp(float x) { return expf(x); }
__device__ __forceinline__ double gexp(double x) { return exp(x); }
__device__ __forceinline__ float glog(float x) { return logf(x); }
__device__ __forceinline__ double glog(double x) { return log(x); }
__device__ __forceinline__ float glog1p(float x) { return log1pf(x); }
__device__ __forceinline__ double glog1p(double x) { return log1p(x); }
__device__ __forceinline__ float gsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double gsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float grsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double grsqrt(double x) { return rsqrt(x); }
__device__ __forceinline__ float gabs(float x) { return fabsf(x); }
__device__ __forceinline__ double gabs(double x) { return fabs(x); }

template <typename T> __device__ __forceinline__ bool gisnan(T x) { return x != x; }
// jnp.maximum / jnp.minimum: NaN in either operand gives NaN
template <typename T> __device__ __forceinline__ T jmax(T a, T b) {
  return gisnan(a) ? a : (gisnan(b) ? b : (a > b ? a : b));
}
template <typename T> __device__ __forceinline__ T jmin(T a, T b) {
  return gisnan(a) ? a : (gisnan(b) ? b : (a < b ? a : b));
}
template <typename T> __device__ __forceinline__ T ginf() { return (T)INFINITY; }
template <typename T> __device__ __forceinline__ T gnan() { return (T)NAN; }

// Sum over the block, returned to every thread. All threads must call it;
// the reduction order is fixed, so every thread gets the same bits.
template <typename T>
__device__ T block_sum(T v, T* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T tot = T(0);
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) tot += red[i];
  __syncthreads();
  return tot;
}

template <typename T>
__device__ T block_max(T v, T* red) {
  for (int off = 16; off > 0; off >>= 1) {
    T o = __shfl_down_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T tot = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) tot = red[i] > tot ? red[i] : tot;
  __syncthreads();
  return tot;
}

// Shared-memory state of one bound evaluation.
template <typename T>
struct BoundShared {
  T inv_ls[kMaxDim];
  T red[32];
};

// Global-memory work matrices of one bound evaluation.
template <typename T>
struct Work {
  T *Knm, *An, *Pnm;                                   // n x m
  T *Kmm, *W, *U, *V, *B, *UB, *VB, *Binv, *Y1, *VT0, *Pmm;  // m x m
  T *xn, *alpha, *rs_nm;                               // n
  T *zn, *u, *c, *v, *w, *acc, *rs_mm, *cs_mm, *cs_nm, *dkdiag;  // m
  T *PmmZs, *PnmTXs;                                   // m x d
  T *PnmZs;                                            // n x d
};

__host__ __device__ inline long work_elems(int n, int m, int d) {
  return 3L * n * m + 11L * m * m + 3L * n + 10L * m + 2L * m * d + 1L * n * d;
}

template <typename T>
__device__ Work<T> make_work(T* s, int n, int m, int d) {
  Work<T> w;
  const long nm = (long)n * m, mm = (long)m * m;
  w.Knm = s; s += nm; w.An = s; s += nm; w.Pnm = s; s += nm;
  w.Kmm = s; s += mm; w.W = s; s += mm; w.U = s; s += mm; w.V = s; s += mm;
  w.B = s; s += mm; w.UB = s; s += mm; w.VB = s; s += mm; w.Binv = s; s += mm;
  w.Y1 = s; s += mm; w.VT0 = s; s += mm; w.Pmm = s; s += mm;
  w.xn = s; s += n; w.alpha = s; s += n; w.rs_nm = s; s += n;
  w.zn = s; s += m; w.u = s; s += m; w.c = s; s += m; w.v = s; s += m;
  w.w = s; s += m; w.acc = s; s += m; w.rs_mm = s; s += m; w.cs_mm = s; s += m;
  w.cs_nm = s; s += m; w.dkdiag = s; s += m;
  w.PmmZs = s; s += (long)m * d; w.PnmTXs = s; s += (long)m * d;
  w.PnmZs = s;
  return w;
}

// U = chol(W)^T (upper, row-oriented, right-looking). W is destroyed.
template <typename T>
__device__ void chol_upper(T* W, T* U, int m, T floor, bool floored) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const T sf = floored ? gsqrt(floor) : T(0);
  for (int i = 0; i < m; ++i) {
    const T dp = W[i * m + i];
    bool good;
    T dis;
    if (floored) {
      good = dp >= floor;
      dis = grsqrt(jmax(dp, floor));
    } else {
      good = true;
      dis = dp > T(0) ? grsqrt(dp) : gnan<T>();
    }
    for (int c = tid; c < m; c += nt) {
      T val;
      if (good) val = W[i * m + c] * dis * (c >= i ? T(1) : T(0));
      else val = (c == i) ? sf : T(0);
      U[i * m + c] = val;
    }
    __syncthreads();
    if (good) {
      const int r0 = i + 1, len = m - r0;
      for (int idx = tid; idx < len * len; idx += nt) {
        const int r = r0 + idx / len, c = r0 + idx % len;
        if (c >= r) W[r * m + c] -= U[i * m + r] * U[i * m + c];
      }
    }
    __syncthreads();
  }
}

// V = U^-1 for upper-triangular U: one thread per column, back substitution.
template <typename T>
__device__ void ut_inv(const T* U, T* V, int m) {
  for (int c = threadIdx.x; c < m; c += blockDim.x) {
    for (int k = m - 1; k > c; --k) V[k * m + c] = T(0);
    V[c * m + c] = T(1) / U[c * m + c];
    for (int k = c - 1; k >= 0; --k) {
      T s = T(0);
      for (int l = k + 1; l <= c; ++l) s += U[k * m + l] * V[l * m + c];
      V[k * m + c] = -s / U[k * m + k];
    }
  }
  __syncthreads();
}

// Solve U^T x = b (forward substitution, column-oriented).
template <typename T>
__device__ void ut_t_solve(const T* U, const T* b, T* x, T* acc, int m) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int j = tid; j < m; j += nt) acc[j] = T(0);
  __syncthreads();
  for (int i = 0; i < m; ++i) {
    const T xi = (b[i] - acc[i]) / U[i * m + i];
    for (int j = i + 1 + tid; j < m; j += nt) acc[j] += U[i * m + j] * xi;
    if (tid == 0) x[i] = xi;
    __syncthreads();
  }
}

// Solve U x = b (back substitution, column-oriented).
template <typename T>
__device__ void ut_solve(const T* U, const T* b, T* x, T* acc, int m) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int j = tid; j < m; j += nt) acc[j] = T(0);
  __syncthreads();
  for (int i = m - 1; i >= 0; --i) {
    const T xi = (b[i] - acc[i]) / U[i * m + i];
    for (int j = tid; j < i; j += nt) acc[j] += U[j * m + i] * xi;
    if (tid == 0) x[i] = xi;
    __syncthreads();
  }
}

// (log density, d/du) of one prior leaf at unconstrained u (priors.py
// closed forms; host-side constants in p1, p2, c).
template <typename T>
__device__ void prior_leaf(const PriorLeaf& p, T u, T* lp, T* g) {
  switch (p.kind) {
    case P_GAMMA: {          // p1 = alpha, p2 = beta
      const T eu = gexp(u);
      *lp = T(p.c) + T(p.p1) * u - T(p.p2) * eu;
      *g = T(p.p1) - T(p.p2) * eu;
      break;
    }
    case P_HC_STD: {         // p1 = 2 log(scale)
      const T t = u - T(p.p1);
      *lp = T(p.c) + T(0.5) * u - glog1p(gexp(t));
      *g = T(0.5) - T(1) / (T(1) + gexp(-t));
      break;
    }
    case P_HC: {             // p1 = log(scale)
      const T t = T(2) * (u - T(p.p1));
      *lp = T(p.c) + u - glog1p(gexp(t));
      *g = T(1) - T(2) / (T(1) + gexp(-t));
      break;
    }
    case P_HALF_NORMAL: {    // p1 = scale^2
      const T e2u = gexp(T(2) * u) / T(p.p1);
      *lp = T(p.c) + u - T(0.5) * e2u;
      *g = T(1) - e2u;
      break;
    }
    case P_LOGNORMAL: {      // p1 = mu, p2 = sigma
      const T z = (u - T(p.p1)) / T(p.p2);
      *lp = T(p.c) - T(0.5) * z * z;
      *g = -z / T(p.p2);
      break;
    }
    default:
      *lp = T(0);
      *g = T(0);
  }
}

// U_out = -(ELBO [+ log prior]), g_out = dU/dtheta (d+2 entries, ravel order
// [log_lengthscale (d), log_outputscale, log_noise]), dZ_out = dU/dZ (m x d)
// when cf.want_z. theta must be visible to all threads on entry; the outputs
// are visible to all threads on return. U_out is written by thread 0.
template <typename T>
__device__ void vfe_bound(const BoundCfg& cf, const T* theta, const T* X,
                          const T* y, const T* Z, const Work<T>& w,
                          BoundShared<T>& sh, T* U_out, T* g_out, T* dZ_out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = cf.n, m = cf.m, d = cf.d;
  const T jitter = T(cf.jitter);
  const bool floored = cf.floor > 0.0;
  const T fl = T(cf.floor);
  T* il = sh.inv_ls;

  // capped inverse lengthscale: min(exp(-theta), 1024 / max(1e-3, |X|, |Z|))
  T mx = T(0);
  for (int i = tid; i < n * d; i += nt) mx = jmax(mx, gabs(X[i]));
  for (int i = tid; i < m * d; i += nt) mx = jmax(mx, gabs(Z[i]));
  mx = jmax(block_max(mx, sh.red), T(1e-3));
  const T cap = T(1024) / mx;
  for (int k = tid; k < d; k += nt) il[k] = jmin(gexp(-theta[k]), cap);
  const T sf2 = gexp(theta[d]);
  const T s2 = gexp(theta[d + 1]);
  const T sigma = gsqrt(s2);
  const T jit_scale = jmax(sf2, T(1));
  __syncthreads();

  // squared norms of the scaled inputs
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
  for (int idx = tid; idx < n * m; idx += nt) {
    const int i = idx / m, j = idx % m;
    T dot = T(0);
    for (int k = 0; k < d; ++k) dot += (X[i * d + k] * il[k]) * (Z[j * d + k] * il[k]);
    const T r2 = jmax(w.xn[i] + w.zn[j] - T(2) * dot, T(0));
    w.Knm[idx] = sf2 * gexp(T(-0.5) * r2);
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
  ut_inv(w.U, w.V, m);                                 // V = L^-T

  // An = Knm L^-T / sigma  (A^T of the reference derivation)
  for (int idx = tid; idx < n * m; idx += nt) {
    const int i = idx / m, j = idx % m;
    T s = T(0);
    for (int k = 0; k <= j; ++k) s += w.Knm[i * m + k] * w.V[k * m + j];
    w.An[idx] = s / sigma;
  }
  __syncthreads();
  // B = An^T An + I
  for (int idx = tid; idx < m * m; idx += nt) {
    const int a = idx / m, b = idx % m;
    T s = T(0);
    for (int i = 0; i < n; ++i) s += w.An[i * m + a] * w.An[i * m + b];
    s += (a == b ? T(1) : T(0));
    w.B[idx] = s;
    w.W[idx] = s;
  }
  __syncthreads();
  chol_upper(w.W, w.UB, m, fl, floored);
  ut_inv(w.UB, w.VB, m);

  // B^-1 = VB VB^T ; u = An^T y
  for (int idx = tid; idx < m * m; idx += nt) {
    const int a = idx / m, b = idx % m;
    T s = T(0);
    for (int k = (a > b ? a : b); k < m; ++k) s += w.VB[a * m + k] * w.VB[b * m + k];
    w.Binv[idx] = s;
  }
  for (int a = tid; a < m; a += nt) {
    T s = T(0);
    for (int i = 0; i < n; ++i) s += w.An[i * m + a] * y[i];
    w.u[a] = s;
  }
  __syncthreads();

  // c = UB^-T u, v = UB^-1 c, w = U^-1 v (substitution against the factors)
  ut_t_solve(w.UB, w.u, w.c, w.acc, m);
  ut_solve(w.UB, w.c, w.v, w.acc, m);
  ut_solve(w.U, w.v, w.w, w.acc, m);

  for (int i = tid; i < n; i += nt) {
    T s = T(0);
    for (int a = 0; a < m; ++a) s += w.An[i * m + a] * w.v[a];
    w.alpha[i] = (y[i] - s) / s2;
  }
  __syncthreads();

  T p_ld = T(0), p_uv = T(0), p_yy = T(0), p_trB = T(0), p_trBi = T(0), p_aa = T(0);
  for (int a = tid; a < m; a += nt) {
    p_ld += glog(w.UB[a * m + a]);
    p_uv += w.c[a] * w.c[a];
    p_trB += w.B[a * m + a];
    p_trBi += w.Binv[a * m + a];
  }
  for (int i = tid; i < n; i += nt) {
    p_yy += y[i] * y[i];
    p_aa += w.alpha[i] * w.alpha[i];
  }
  const T logdetB = T(2) * block_sum(p_ld, sh.red);
  const T uv = block_sum(p_uv, sh.red);
  const T yy = block_sum(p_yy, sh.red);
  const T trB = block_sum(p_trB, sh.red);
  const T trBinv = block_sum(p_trBi, sh.red);
  const T aa = block_sum(p_aa, sh.red);
  const T nT = T(n), mT = T(m);
  const T t_term = nT * sf2 - s2 * (trB - mT);
  const T two_pi = T(6.283185307179586);
  const T F = T(-0.5) * nT * glog(two_pi * s2) - T(0.5) * logdetB
              - T(0.5) * (yy - uv) / s2 - T(0.5) * t_term / s2;

  // adjoints: Y1 = (I - B^-1) L^-1, VT0 = L^-T (2I - B - B^-1)
  for (int idx = tid; idx < m * m; idx += nt) {
    const int a = idx / m, b = idx % m;
    T s = T(0);
    for (int k = b; k < m; ++k) s += w.Binv[a * m + k] * w.V[b * m + k];
    w.Y1[idx] = w.V[b * m + a] - s;
    T t = T(0);
    for (int k = a; k < m; ++k) {
      const T t0 = (k == b ? T(2) : T(0)) - w.B[k * m + b] - w.Binv[k * m + b];
      t += w.V[a * m + k] * t0;
    }
    w.VT0[idx] = t;
  }
  __syncthreads();
  // dKmm = -w w^T / (2 s2) + L^-T T0 L^-1 / 2 ; Pmm = dKmm o Kmm
  for (int idx = tid; idx < m * m; idx += nt) {
    const int a = idx / m, b = idx % m;
    T s = T(0);
    for (int k = b; k < m; ++k) s += w.VT0[a * m + k] * w.V[b * m + k];
    const T dk = -(w.w[a] * w.w[b]) / (T(2) * s2) + T(0.5) * s;
    w.Pmm[idx] = dk * w.Kmm[idx];
    if (a == b) w.dkdiag[a] = dk;
  }
  // dKnm = (An Y1 + alpha w^T) / sigma ; Pnm = dKnm o Knm
  for (int idx = tid; idx < n * m; idx += nt) {
    const int i = idx / m, b = idx % m;
    T s = T(0);
    for (int a = 0; a < m; ++a) s += w.An[i * m + a] * w.Y1[a * m + b];
    w.Pnm[idx] = (s + w.alpha[i] * w.w[b]) / sigma * w.Knm[idx];
  }
  __syncthreads();

  T p_mm = T(0), p_nm = T(0), p_dk = T(0);
  for (int idx = tid; idx < m * m; idx += nt) p_mm += w.Pmm[idx];
  for (int idx = tid; idx < n * m; idx += nt) p_nm += w.Pnm[idx];
  for (int a = tid; a < m; a += nt) p_dk += w.dkdiag[a];
  const T S_mm = block_sum(p_mm, sh.red);
  const T S_nm = block_sum(p_nm, sh.red);
  const T tr_dK = block_sum(p_dk, sh.red);

  for (int a = tid; a < m; a += nt) {
    T rs = T(0), cs = T(0), cn = T(0);
    for (int b = 0; b < m; ++b) { rs += w.Pmm[a * m + b]; cs += w.Pmm[b * m + a]; }
    for (int i = 0; i < n; ++i) cn += w.Pnm[i * m + a];
    w.rs_mm[a] = rs;
    w.cs_mm[a] = cs;
    w.cs_nm[a] = cn;
  }
  for (int i = tid; i < n; i += nt) {
    T rs = T(0);
    for (int b = 0; b < m; ++b) rs += w.Pnm[i * m + b];
    w.rs_nm[i] = rs;
  }
  for (int idx = tid; idx < m * d; idx += nt) {
    const int a = idx / d, k = idx % d;
    T s = T(0);
    for (int b = 0; b < m; ++b) s += w.Pmm[a * m + b] * (Z[b * d + k] * il[k]);
    w.PmmZs[idx] = s;
    if (cf.want_z) {
      T t = T(0);
      for (int i = 0; i < n; ++i) t += w.Pnm[i * m + a] * (X[i * d + k] * il[k]);
      w.PnmTXs[idx] = t;
    }
  }
  for (int idx = tid; idx < n * d; idx += nt) {
    const int i = idx / d, k = idx % d;
    T s = T(0);
    for (int b = 0; b < m; ++b) s += w.Pnm[i * m + b] * (Z[b * d + k] * il[k]);
    w.PnmZs[idx] = s;
  }
  __syncthreads();

  // RBF-ARD chain rule to the log-lengthscales, plus the prior
  for (int k = tid; k < d; k += nt) {
    T t1 = T(0), t2 = T(0), t3 = T(0), t4 = T(0), t5 = T(0), t6 = T(0);
    for (int a = 0; a < m; ++a) {
      const T zs = Z[a * d + k] * il[k], zs2 = zs * zs;
      t1 += w.rs_mm[a] * zs2;
      t2 += w.cs_mm[a] * zs2;
      t3 += zs * w.PmmZs[a * d + k];
      t5 += w.cs_nm[a] * zs2;
    }
    for (int i = 0; i < n; ++i) {
      const T xs = X[i * d + k] * il[k];
      t4 += w.rs_nm[i] * xs * xs;
      t6 += xs * w.PnmZs[i * d + k];
    }
    T gk = t1 + t2 - T(2) * t3 + t4 + t5 - T(2) * t6;
    if (cf.want_prior) {
      T lp, gp;
      prior_leaf(cf.leaf[0], theta[k], &lp, &gp);
      gk += gp;
    }
    g_out[k] = -gk;
  }
  if (tid == 0) {
    const T dlog_os = S_mm + S_nm + jitter * sf2 * (sf2 > T(1) ? T(1) : T(0)) * tr_dK
                      - nT * sf2 / (T(2) * s2);
    const T trW = (nT - mT + trBinv) / s2;
    const T dF_ds2 = T(0.5) * aa - T(0.5) * trW + t_term / (T(2) * s2 * s2);
    T g_os = dlog_os, g_noise = dF_ds2 * s2, Ftot = F;
    if (cf.want_prior) {
      T lp, gp, lp_ls = T(0);
      for (int k = 0; k < d; ++k) { prior_leaf(cf.leaf[0], theta[k], &lp, &gp); lp_ls += lp; }
      T lp_os, gp_os, lp_n, gp_n;
      prior_leaf(cf.leaf[1], theta[d], &lp_os, &gp_os);
      prior_leaf(cf.leaf[2], theta[d + 1], &lp_n, &gp_n);
      Ftot = F + (lp_ls + lp_os + lp_n);
      g_os += gp_os;
      g_noise += gp_n;
    }
    g_out[d] = -g_os;
    g_out[d + 1] = -g_noise;
    *U_out = -Ftot;
  }
  if (cf.want_z && dZ_out != nullptr) {
    for (int idx = tid; idx < m * d; idx += nt) {
      const int a = idx / d, k = idx % d;
      const T zs = Z[idx] * il[k];
      const T dzs = T(-2) * (w.rs_mm[a] * zs - w.PmmZs[idx])
                    - (w.cs_nm[a] * zs - w.PnmTXs[idx]);
      dZ_out[idx] = -(dzs * il[k]);
    }
  }
  __syncthreads();
}

// A potential core as the sampler kernels take it (template parameter
// `Core` of vfe_potential.cu, nuts_chunk.cu, mc_hmc_chunk.cu): the length
// of a state row, the global scratch of one evaluation, and the block-wide
// evaluation of U, dU/dz (and dU/dZ). This one is the collapsed bound over
// the d+2 log-hypers; SgpmcCore (sgpmc_bound.cuh) the whitened JointHMC
// target.
template <typename T>
struct VfeCore {
  using WorkT = Work<T>;
  static __host__ __device__ int dim(const BoundCfg& cf) { return cf.d + 2; }
  static __host__ __device__ long elems(const BoundCfg& cf) {
    return work_elems(cf.n, cf.m, cf.d);
  }
  static __device__ WorkT work(T* s, const BoundCfg& cf) {
    return make_work(s, cf.n, cf.m, cf.d);
  }
  static __device__ void eval(const BoundCfg& cf, const T* z, const T* X,
                              const T* y, const T* Z, const WorkT& w,
                              BoundShared<T>& sh, T* U, T* g, T* dZ) {
    vfe_bound(cf, z, X, y, Z, w, sh, U, g, dZ);
  }
};

}  // namespace ggp
