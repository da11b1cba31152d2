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
// where cond(B) ~ 1/sigma^2). The Cholesky's trailing update and the
// triangular inverse are right-looking, a warp per row, one barrier per
// step; the bound's seven O(N M^2) and O(M^3) products run through
// shared-memory tiles (block_gemm), each output keeping the serial sum
// order. wgmma and several blocks per factorisation are later work.
//
// Sums over the n rows (B = An^T An, An^T y, and the gradient's row sums)
// accumulate in double for both types: a float32 running sum over
// thousands of rows loses digits the plain version's blocked reductions
// keep, and Adam's normalised steps carry them into every coordinate.
// They are not what bounds the core.
//
// The factorisations, solves, value and adjoints dF/dKnm, dF/dKmm do not
// depend on the kernel: they are `collapsed_bound`, which the co2 cores
// (co2_bound.cuh) share; `vfe_bound` adds the RBF grams and chain rule.
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

// Threads of the block a sampler kernel runs the potential core `Core` on:
// kThreads, unless the core sets its own (co2_bound.cuh). Every device
// function of the cores strides over blockDim.x.
template <template <typename> class Core>
struct CoreThreads {
  static constexpr int value = kThreads;
};

// Bound on the length of a state row of `Core`, which sizes the sampler
// kernels' per-entry shared arrays: kMaxDim, unless the core sets its own.
template <template <typename> class Core>
struct CoreDim {
  static constexpr int value = kMaxDim;
};

// Layout of the `cfg` double array every launcher takes (mirrored by
// ggp_tpu_torch/ops/_build.py).
enum CfgIndex {
  C_N = 0, C_M, C_D, C_JITTER, C_FLOOR, C_WANT_PRIOR, C_WANT_ZGRAD,
  C_PRIOR = 7,                       // 3 leaves x (kind, p1, p2, const)
  C_DIM = 19, C_MAX_DEPTH, C_K, C_ADAPT, C_TARGET, C_ADAPT_MASS,
  C_LR, C_CLIP, C_MIN_NOISE, C_T0, C_S_ACT, C_EPS, C_CHAINS, C_LEAPFROG,
  C_STAGES, C_NB, C_NUM_DATA, C_LIK, C_LATENTS, C_NHALF, C_PRIOR_VAR,
  C_QUAD = 40,                       // 20 Gauss-Hermite nodes, then 20 weights
  C_LANE_PRIOR = 80,                 // co2 core: 11 lanes x (kind, p1, p2, const)
  C_LEN = 124
};

enum PriorKind { P_GAMMA = 0, P_HC_STD, P_HC, P_HALF_NORMAL, P_LOGNORMAL, P_FLAT };

struct PriorLeaf { int kind; double p1, p2, c; };

struct BoundCfg {
  int n, m, d, want_prior, want_z;
  int stages;                        // gpr core: stop after this part (0: all)
  double jitter, floor;
  PriorLeaf leaf[3];                 // lengthscales, outputscale, noise
  PriorLeaf lane[11];                // co2 core (co2_bound.cuh): one per hyper
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
  for (int l = 0; l < 14; ++l) {
    const double* p = l < 3 ? cfg + C_PRIOR + 4 * l : cfg + C_LANE_PRIOR + 4 * (l - 3);
    PriorLeaf& q = l < 3 ? b.leaf[l] : b.lane[l - 3];
    q.kind = (int)p[0];
    q.p1 = p[1];
    q.p2 = p[2];
    q.c = p[3];
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
  T *xn, *alpha;                                       // n
  T *zn, *u, *c, *v, *w, *acc, *dkdiag;                // m
  T *GmmZ, *QmmZ, *GnmZ;                               // m x d
  T *QnmX;                                             // n x d
};

__host__ __device__ inline long work_elems(int n, int m, int d) {
  return 3L * n * m + 11L * m * m + 2L * n + 7L * m + 3L * m * d + 1L * n * d;
}

template <typename T>
__device__ Work<T> make_work(T* s, int n, int m, int d) {
  Work<T> w;
  const long nm = (long)n * m, mm = (long)m * m;
  w.Knm = s; s += nm; w.An = s; s += nm; w.Pnm = s; s += nm;
  w.Kmm = s; s += mm; w.W = s; s += mm; w.U = s; s += mm; w.V = s; s += mm;
  w.B = s; s += mm; w.UB = s; s += mm; w.VB = s; s += mm; w.Binv = s; s += mm;
  w.Y1 = s; s += mm; w.VT0 = s; s += mm; w.Pmm = s; s += mm;
  w.xn = s; s += n; w.alpha = s; s += n;
  w.zn = s; s += m; w.u = s; s += m; w.c = s; s += m; w.v = s; s += m;
  w.w = s; s += m; w.acc = s; s += m; w.dkdiag = s; s += m;
  w.GmmZ = s; s += (long)m * d; w.QmmZ = s; s += (long)m * d;
  w.GnmZ = s; s += (long)m * d;
  w.QnmX = s;
  return w;
}

// U = chol(W)^T (upper, row-oriented, right-looking). W is destroyed.
template <typename T>
__device__ void chol_upper(T* W, T* U, int m, T floor, bool floored) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
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
    if (good) {                     // trailing update of the upper triangle: a warp per row
      for (int r = i + 1 + warp; r < m; r += nwarps) {
        const T ur = U[i * m + r];
        for (int c = r + lane; c < m; c += 32) W[r * m + c] -= ur * U[i * m + c];
      }
    }
    __syncthreads();
  }
}

// V = U^-1 for upper-triangular U, right-looking: the rows of V from the
// bottom up, each final once the rows below it have added U[k][l] V[l][c]
// into the partial sums S[k][c] that V's entries above them hold (a warp
// per row of the update, one barrier per row). Each step's work spreads
// over the block; a thread per column would run column c as c^2/2
// dependent steps of one thread, most of an evaluation at m=480.
template <typename T>
__device__ void ut_inv(const T* U, T* V, int m) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  for (int idx = tid; idx < m * m; idx += nt) V[idx] = T(0);
  __syncthreads();
  for (int l = m - 1; l >= 0; --l) {
    const T inv = T(1) / U[l * m + l];
    for (int c = l + tid; c < m; c += nt)
      V[l * m + c] = ((c == l ? T(1) : T(0)) - V[l * m + c]) * inv;
    __syncthreads();
    for (int k = warp; k < l; k += nwarps) {
      const T ukl = U[k * m + l];
      for (int c = l + lane; c < m; c += 32) V[k * m + c] += ukl * V[l * m + c];
    }
    __syncthreads();
  }
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

// sum_{k0 <= k < k1} a[k sa] b[k sb] in Acc, in four independent chains, so
// that the loads of four terms are in flight at once
template <typename Acc, typename T>
__device__ __forceinline__ Acc dot_acc(const T* a, int sa, const T* b, int sb, int k0,
                                       int k1) {
  Acc s0 = Acc(0), s1 = Acc(0), s2 = Acc(0), s3 = Acc(0);
  int k = k0;
  for (; k + 3 < k1; k += 4) {
    s0 += Acc(a[k * sa]) * Acc(b[k * sb]);
    s1 += Acc(a[(k + 1) * sa]) * Acc(b[(k + 1) * sb]);
    s2 += Acc(a[(k + 2) * sa]) * Acc(b[(k + 2) * sb]);
    s3 += Acc(a[(k + 3) * sa]) * Acc(b[(k + 3) * sb]);
  }
  for (; k < k1; ++k) s0 += Acc(a[k * sa]) * Acc(b[k * sb]);
  return (s0 + s1) + (s2 + s3);
}

// Zero structure a tiled product may skip: A(r, k) = 0 for k < r
// (K_FROM_R), B(k, c) = 0 for k < c (K_FROM_C) or for k > c (K_TO_C); and
// SYM_UPPER: only the tiles on and above the diagonal are formed (the
// epilogue mirrors them).
enum GemmSkip { K_FULL = 0, K_FROM_R = 1, K_FROM_C = 2, K_TO_C = 4, SYM_UPPER = 8 };

// The block-wide product C(r, c) = sum_k A(r, k) B(k, c) for r < R, c < Cn,
// k < K, with A(r, k) = A[r ar + k ak] and B(k, c) = B[k bk + c bc] (one of
// each pair of strides 1), through shared memory, by a block of NT threads:
// the block forms TR x TC output tiles, each thread 2 TR TC / NT of them in
// registers (two columns, TC / 2 apart, and rows strided), from chunks of
// KC terms that all threads load together and every output of the tile
// then reads. Each output sums its terms in ascending k in one Acc
// accumulator (the order of a serial loop), and goes to epi(r, c, sum) from
// the thread that formed it. The chunks live in the caller's shared tiles
// sA[KC][TR + 1] and sB[KC][TC + 1] (declared once per kernel: a static
// array here would be one per epilogue). Ends with a barrier.
template <typename Acc, int TR, int TC, int KC, int NT, typename T, typename Epi>
__device__ void block_gemm(int R, int Cn, int K, const T* A, int ar, int ak, const T* B,
                           int bk, int bc, int skip, T (*sA)[TR + 1], T (*sB)[TC + 1],
                           Epi epi) {
  constexpr int kHalf = TC / 2, kStep = NT / kHalf, kPer = TR / kStep;
  static_assert(TC % 2 == 0 && NT % kHalf == 0 && TR % kStep == 0,
                "tile does not fit the block");
  const int tid = threadIdx.x;
  const int col = tid % kHalf, row0 = tid / kHalf;
  for (int tr = 0; tr < R; tr += TR) {
    for (int tc = 0; tc < Cn; tc += TC) {
      if ((skip & SYM_UPPER) && tc + TC <= tr) continue;
      int k_lo = 0, k_hi = K;
      if (skip & K_FROM_R) k_lo = tr;
      if ((skip & K_FROM_C) && tc > k_lo) k_lo = tc;
      if ((skip & K_TO_C) && tc + TC < k_hi) k_hi = tc + TC;
      Acc acc[kPer][2];
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[j][0] = acc[j][1] = Acc(0);
      for (int k0 = k_lo; k0 < k_hi; k0 += KC) {
        for (int e = tid; e < KC * TR; e += NT) {
          int r, kk;
          if (ak == 1) { r = e / KC; kk = e % KC; } else { kk = e / TR; r = e % TR; }
          const int rg = tr + r, kg = k0 + kk;
          sA[kk][r] = (rg < R && kg < k_hi) ? A[rg * ar + kg * ak] : T(0);
        }
        for (int e = tid; e < KC * TC; e += NT) {
          int c, kk;
          if (bc == 1) { kk = e / TC; c = e % TC; } else { c = e / KC; kk = e % KC; }
          const int cg = tc + c, kg = k0 + kk;
          sB[kk][c] = (cg < Cn && kg < k_hi) ? B[kg * bk + cg * bc] : T(0);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          const Acc b0 = Acc(sB[kk][col]), b1 = Acc(sB[kk][col + kHalf]);
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const Acc a = Acc(sA[kk][row0 + j * kStep]);
            acc[j][0] += a * b0;
            acc[j][1] += a * b1;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int r = tr + row0 + j * kStep;
        if (r < R && tc + col < Cn) epi(r, tc + col, acc[j][0]);
        if (r < R && tc + col + kHalf < Cn) epi(r, tc + col + kHalf, acc[j][1]);
      }
    }
  }
  __syncthreads();
}

// What collapsed_bound returns to every thread: the bound F, the scalars
// its noise gradient reads, tr(dF/dKmm); and, when the adjoints were
// multiplied by the grams, this thread's partial sums of Pmm and Pnm.
template <typename T>
struct Collapsed {
  T F, t_term, trBinv, aa, tr_dK, p_mm, p_nm;
};

// What collapsed_mm returns to every thread: log det B, u^T B^-1 u, tr B
// and tr B^-1.
template <typename T>
struct CollapsedMM {
  T logdetB, uv, trB, trBinv;
};

// The M x M part of the collapsed bound, shared by collapsed_bound and the
// streamed Z trainer (z_adam_stream.cu, which forms B and u over row
// blocks). On entry w.U = L^T and w.V = L^-T hold Kmm's factor and its
// inverse, w.Kmm the gram, w.B and w.W both B = I + An^T An, and w.u =
// An^T y, all visible to the block. It factorises B (w.UB, w.VB), solves c =
// UB^-T u, v = UB^-1 c, w = U^-1 v against the factors (w.c, w.v, w.w),
// forms B^-1 (w.Binv), Y1 = (I - B^-1) L^-1 (w.Y1), and dF/dKmm (times Kmm
// with `times_k`) in w.Pmm and its diagonal in w.dkdiag; w.W ends as T0 =
// 2I - B - B^-1. The products go through block_gemm in the caller's tiles,
// over the full range of k or whole tiles of it (the triangular factors
// hold explicit zeros, so each output keeps the serial sum of the
// triangular loop).
template <typename Acc, int TR, int TC, int KC, int NT, typename T>
__device__ CollapsedMM<T> collapsed_mm(const BoundCfg& cf, const Work<T>& w,
                                       BoundShared<T>& sh, T s2, bool times_k,
                                       T (*sA)[TR + 1], T (*sB)[TC + 1]) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m = cf.m;
  chol_upper(w.W, w.UB, m, T(cf.floor), cf.floor > 0.0);
  ut_inv(w.UB, w.VB, m);
  T p_ld = T(0);                                  // this thread's part of log det B
  for (int a = tid; a < m; a += nt) p_ld += glog(w.UB[a * m + a]);
  __syncthreads();

  // c = UB^-T u, v = UB^-1 c, w = U^-1 v (substitution against the factors)
  ut_t_solve(w.UB, w.u, w.c, w.acc, m);
  ut_solve(w.UB, w.c, w.v, w.acc, m);
  ut_solve(w.U, w.v, w.w, w.acc, m);

  // B^-1 = VB VB^T: VB(a, k) = 0 for k < a, VB^T(k, b) = 0 for k < b
  block_gemm<Acc, TR, TC, KC, NT>(m, m, m, w.VB, m, 1, w.VB, 1, m, K_FROM_R | K_FROM_C, sA, sB,
                              [&](int a, int b, Acc s) { w.Binv[a * m + b] = T(s); });
  // W = T0 = 2I - B - B^-1 (W is free again)
  for (int idx = tid; idx < m * m; idx += nt) {
    const int a = idx / m, b = idx % m;
    w.W[idx] = (a == b ? T(2) : T(0)) - w.B[idx] - w.Binv[idx];
  }
  T p_uv = T(0), p_trB = T(0), p_trBi = T(0);
  for (int a = tid; a < m; a += nt) {
    p_uv += w.c[a] * w.c[a];
    p_trB += w.B[a * m + a];
    p_trBi += w.Binv[a * m + a];
  }
  CollapsedMM<T> out;
  out.logdetB = T(2) * block_sum(p_ld, sh.red);
  out.uv = block_sum(p_uv, sh.red);
  out.trB = block_sum(p_trB, sh.red);
  out.trBinv = block_sum(p_trBi, sh.red);

  // adjoints: Y1 = (I - B^-1) L^-1 = V^T - B^-1 V^T (V^T(k, b) = 0 for
  // k < b), VT0 = L^-T (2I - B - B^-1) (V(a, k) = 0 for k < a)
  block_gemm<Acc, TR, TC, KC, NT>(m, m, m, w.Binv, m, 1, w.V, 1, m, K_FROM_C, sA, sB,
                              [&](int a, int b, Acc s) {
                                w.Y1[a * m + b] = w.V[b * m + a] - T(s);
                              });
  block_gemm<Acc, TR, TC, KC, NT>(m, m, m, w.V, m, 1, w.W, m, 1, K_FROM_R, sA, sB,
                              [&](int a, int b, Acc s) { w.VT0[a * m + b] = T(s); });
  // dKmm = -w w^T / (2 s2) + L^-T T0 L^-1 / 2 ; Pmm = dKmm (o Kmm)
  block_gemm<Acc, TR, TC, KC, NT>(m, m, m, w.VT0, m, 1, w.V, 1, m, K_FROM_C, sA, sB,
                              [&](int a, int b, Acc s) {
                                const T dk = -(w.w[a] * w.w[b]) / (T(2) * s2) + T(0.5) * T(s);
                                w.Pmm[a * m + b] = times_k ? dk * w.Kmm[a * m + b] : dk;
                                if (a == b) w.dkdiag[a] = dk;
                              });
  return out;
}

// The kernel-agnostic part of the collapsed bound, shared by the cores over
// inducing points (VfeCore below, the co2 cores of co2_bound.cuh). On entry
// w.Knm (n x m), w.Kmm and w.W = Kmm + jitter * jit_scale * I hold the
// grams, and kdiag_sum = sum_i k(x_i, x_i). It factorises Kmm and B = I +
// A A^T, solves against the factors, and leaves the adjoints dF/dKmm and
// dF/dKnm in w.Pmm and w.Pnm (multiplied elementwise by Kmm and Knm with
// `times_k`, all the RBF chain rule reads), and diag(dF/dKmm) in w.dkdiag.
//
// The seven O(n m^2) and O(m^3) products go through block_gemm in TR x TC
// tiles and chunks of KC terms, on a block of NT threads. Every product runs over the full range of
// k, or over whole tiles of it: the triangular factors V = L^-T and VB =
// UB^-1 hold explicit zeros, so the extra terms are exact zeros and each
// output keeps the serial sum of the triangular loop. The sums accumulate
// in Acc (B's and An^T y's always in double): the vfe core keeps T, the co2
// cores take double, since at M=480 a float32 sum of 480 terms loses the
// digits the plain version's blocked products keep.
template <typename Acc, int TR, int TC, int KC, int NT, typename T>
__device__ Collapsed<T> collapsed_bound(const BoundCfg& cf, const T* y, const Work<T>& w,
                                        BoundShared<T>& sh, T s2, T kdiag_sum,
                                        T jit_scale, bool times_k) {
  __shared__ T sA[KC][TR + 1];
  __shared__ T sB[KC][TC + 1];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = cf.n, m = cf.m;
  const bool floored = cf.floor > 0.0;
  const T fl = T(cf.floor);
  const T sigma = gsqrt(s2);

  chol_upper(w.W, w.U, m, fl * jit_scale, floored);   // U = L^T
  ut_inv(w.U, w.V, m);                            // V = L^-T

  // An = Knm L^-T / sigma  (A^T of the reference derivation); V(k, j) = 0
  // for k > j
  block_gemm<Acc, TR, TC, KC, NT>(n, m, m, w.Knm, m, 1, w.V, m, 1, K_TO_C, sA, sB,
                              [&](int i, int j, Acc s) { w.An[i * m + j] = T(s) / sigma; });
  // B = An^T An + I: the upper tiles, mirrored, summed in double
  block_gemm<double, TR, TC, KC, NT>(
      m, m, n, w.An, 1, m, w.An, m, 1, SYM_UPPER, sA, sB, [&](int a, int b, double s) {
        if (a > b) return;
        const T v = T(s) + (a == b ? T(1) : T(0));
        w.B[a * m + b] = v;
        w.W[a * m + b] = v;
        w.B[b * m + a] = v;
        w.W[b * m + a] = v;
      });
  // u = An^T y
  for (int a = tid; a < m; a += nt) w.u[a] = T(dot_acc<double>(w.An + a, m, y, 1, 0, n));
  __syncthreads();
  const CollapsedMM<T> mm = collapsed_mm<Acc, TR, TC, KC, NT>(cf, w, sh, s2, times_k, sA, sB);

  for (int i = tid; i < n; i += nt)
    w.alpha[i] = (y[i] - T(dot_acc<Acc>(w.An + i * m, 1, w.v, 1, 0, m))) / s2;
  T p_yy = T(0), p_aa = T(0);
  for (int i = tid; i < n; i += nt) {
    p_yy += y[i] * y[i];
    p_aa += w.alpha[i] * w.alpha[i];
  }
  Collapsed<T> out;
  const T yy = block_sum(p_yy, sh.red);
  out.trBinv = mm.trBinv;
  out.aa = block_sum(p_aa, sh.red);
  const T nT = T(n), mT = T(m);
  out.t_term = kdiag_sum - s2 * (mm.trB - mT);
  const T two_pi = T(6.283185307179586);
  out.F = T(-0.5) * nT * glog(two_pi * s2) - T(0.5) * mm.logdetB
          - T(0.5) * (yy - mm.uv) / s2 - T(0.5) * out.t_term / s2;

  // dKnm = (An Y1 + alpha w^T) / sigma ; Pnm = dKnm (o Knm)
  block_gemm<Acc, TR, TC, KC, NT>(n, m, m, w.An, m, 1, w.Y1, m, 1, K_FULL, sA, sB,
                              [&](int i, int b, Acc s) {
                                const T dk = (T(s) + w.alpha[i] * w.w[b]) / sigma;
                                w.Pnm[i * m + b] = times_k ? dk * w.Knm[i * m + b] : dk;
                              });

  T p_mm = T(0), p_dk = T(0);
  double p_nm = 0.0;
  if (times_k) {
    for (int idx = tid; idx < m * m; idx += nt) p_mm += w.Pmm[idx];
    for (int idx = tid; idx < n * m; idx += nt) p_nm += double(w.Pnm[idx]);
  }
  for (int a = tid; a < m; a += nt) p_dk += w.dkdiag[a];
  out.p_mm = p_mm;
  out.p_nm = T(p_nm);
  out.tr_dK = block_sum(p_dk, sh.red);
  return out;
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

  const Collapsed<T> cb =
      collapsed_bound<T, 32, 32, 8, kThreads>(cf, y, w, sh, s2, T(n) * sf2, jit_scale,
                                             true);
  const T S_mm = block_sum(cb.p_mm, sh.red);
  const T S_nm = block_sum(cb.p_nm, sh.red);
  const T nT = T(n), mT = T(m);

  // The gradient's sums over pairs, in difference form (the expanded form,
  // zs_a sum_i P - sum_i P xs_i, cancels, and in float32 loses more digits
  // of the Z gradient the more rows it sums). Per dimension k, with
  // xs = x il, zs = z il,
  //   GmmZ[a] = sum_b Pmm[a,b] (zs_a - zs_b),  QmmZ[a] = sum_b Pmm[a,b] (zs_a - zs_b)^2,
  //   GnmZ[a] = sum_i Pnm[i,a] (zs_a - xs_i),  QnmX[i] = sum_a Pnm[i,a] (xs_i - zs_a)^2.
  for (int idx = tid; idx < m * d; idx += nt) {
    const int a = idx / d, k = idx % d;
    const T za = Z[idx] * il[k];
    T g = T(0), q = T(0);
    for (int b = 0; b < m; ++b) {
      const T df = za - Z[b * d + k] * il[k], p = w.Pmm[a * m + b];
      g += p * df;
      q += p * df * df;
    }
    w.GmmZ[idx] = g;
    w.QmmZ[idx] = q;
    if (cf.want_z) {
      double acc = 0.0;
      for (int i = 0; i < n; ++i)
        acc += double(w.Pnm[i * m + a]) * double(za - X[i * d + k] * il[k]);
      w.GnmZ[idx] = T(acc);
    }
  }
  for (int idx = tid; idx < n * d; idx += nt) {
    const int i = idx / d, k = idx % d;
    const T xs = X[idx] * il[k];
    T q = T(0);
    for (int b = 0; b < m; ++b) {
      const T df = xs - Z[b * d + k] * il[k];
      q += w.Pnm[i * m + b] * df * df;
    }
    w.QnmX[idx] = q;
  }
  __syncthreads();

  // RBF-ARD chain rule to the log-lengthscales, plus the prior:
  // dF/dlog_ls_k = sum over pairs of P (xs_k - zs_k)^2
  for (int k = tid; k < d; k += nt) {
    double acc = 0.0;
    for (int i = 0; i < n; ++i) acc += double(w.QnmX[i * d + k]);
    T gk = T(acc);
    for (int a = 0; a < m; ++a) gk += w.QmmZ[a * d + k];
    if (cf.want_prior) {
      T lp, gp;
      prior_leaf(cf.leaf[0], theta[k], &lp, &gp);
      gk += gp;
    }
    g_out[k] = -gk;
  }
  if (tid == 0) {
    const T dlog_os = S_mm + S_nm + jitter * sf2 * (sf2 > T(1) ? T(1) : T(0)) * cb.tr_dK
                      - nT * sf2 / (T(2) * s2);
    const T trW = (nT - mT + cb.trBinv) / s2;
    const T dF_ds2 = T(0.5) * cb.aa - T(0.5) * trW + cb.t_term / (T(2) * s2 * s2);
    T g_os = dlog_os, g_noise = dF_ds2 * s2, Ftot = cb.F;
    if (cf.want_prior) {
      T lp, gp, lp_ls = T(0);
      for (int k = 0; k < d; ++k) { prior_leaf(cf.leaf[0], theta[k], &lp, &gp); lp_ls += lp; }
      T lp_os, gp_os, lp_n, gp_n;
      prior_leaf(cf.leaf[1], theta[d], &lp_os, &gp_os);
      prior_leaf(cf.leaf[2], theta[d + 1], &lp_n, &gp_n);
      Ftot = cb.F + (lp_ls + lp_os + lp_n);
      g_os += gp_os;
      g_noise += gp_n;
    }
    g_out[d] = -g_os;
    g_out[d + 1] = -g_noise;
    *U_out = -Ftot;
  }
  if (cf.want_z && dZ_out != nullptr) {
    for (int idx = tid; idx < m * d; idx += nt) {
      dZ_out[idx] = (T(2) * w.GmmZ[idx] + w.GnmZ[idx]) * il[idx % d];
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
