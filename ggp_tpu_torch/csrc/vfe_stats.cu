// Kernels 10 and 11: the sufficient statistics of the collapsed VFE bound
// over a row set, and their backward pass, for C chains at once.
//
// Kernel 10, `stats_fwd_kernel`, replaces ggp_tpu/ops/pallas_vfe.py
// `_fwd_kernel` (the pallas_call at pallas_vfe.py:152): for each chain c,
//     S_kk = Kmn Knm (M x M),  S_ky = Kmn y (M),
// with k(x, z) = os_c * f(|x / ls_c - z / ls_c|^2) for the stationary family
// f (RBF, Matern-1/2, -3/2, -5/2) over the n rows of X, or over the rows
// idx[c, :] of X when an index array is given (the minibatch is gathered in
// the kernel; X[idx] is never formed). Optional bf16: the inputs of the S_kk
// product are rounded to bfloat16 (accumulation in T), as the TPU kernel's
// single-pass MXU option; S_ky keeps the unrounded k.
// Kernel 11, `stats_bwd_kernel`, replaces `_bwd_kernel` (pallas_vfe.py:238):
// given g = dS_kk + dS_kk^T (C, M, M) and dS_ky (C, M) it recomputes each
// row tile's k and forms dk = y dS_ky^T + k g, w = (dk / d d2) * dk, and
//     dzs  = -2 sum_r w_rm (xs_r - zs_m)            (M x D),
//     term =    sum_rm w_rm (xs_r - zs_m)^2         (D),
//     dos  =    sum_rm k_rm dk_rm / os              (1),
// the scaled-coordinate cotangents; the chain rules to (Z, log_ls, log_os)
// are the wrapper's (ops/vfe_stats.py). The Matern gradient is zero at
// d2 == 0, as the TPU kernel's (`_dk_dd2`).
//
// Inputs: X (N, D) and y (N) shared by the chains; Zs = Z / ls (C, M, D),
// inv_ls = 1 / ls (C, D), os (C); idx (C, n) int64 or null (then n = N).
// Rows are scaled by inv_ls in the kernel, so X / ls is never formed; d2 is
// the sum of squared differences of the scaled coordinates.
//
// Design: a grid of G blocks per chain (and, forward, per 128 x 128 tile of
// S_kk) strides over row tiles; each block keeps its tile's k in shared
// memory and accumulates into its own partial, so Knm never reaches global
// memory and the work space is O(C G M^2). A second, deterministic stage sums
// the G partials in a fixed order: there are no float atomics, so a call's
// result does not depend on scheduling. What bounds the forward: the
// k-tile product (2 n M^2 operations a chain), one 8 x 8 register tile of
// S_kk per thread; the backward: the (tile x M)(M x M) product k g, g read
// through L1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ggp {
namespace stats {

constexpr int kThreads = 256;
constexpr int kTile = 128;      // S_kk tile edge: 16 x 16 threads, 8 x 8 entries each
constexpr int kRowsFwd = 32;    // rows per forward tile
constexpr int kRowsBwd = 16;    // rows per backward tile

enum Family { kRbf = 0, kMatern12 = 1, kMatern32 = 2, kMatern52 = 3 };

struct Args {
  long long N;    // rows of X
  long long n;    // rows per chain (idx columns, or N)
  int M, D, C, G, T;
  bool has_idx;
};

__device__ __forceinline__ float sexp(float x) { return expf(x); }
__device__ __forceinline__ double sexp(double x) { return exp(x); }
__device__ __forceinline__ float ssqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double ssqrt(double x) { return sqrt(x); }

template <typename T, int FAM>
__device__ __forceinline__ T k_of_d2(T d2, T os) {
  if (FAM == kRbf) return os * sexp(T(-0.5) * d2);
  const T r = ssqrt(d2);
  if (FAM == kMatern12) return os * sexp(-r);
  if (FAM == kMatern32) {
    const T s = T(1.7320508075688772) * r;
    return os * (T(1) + s) * sexp(-s);
  }
  const T s = T(2.23606797749979) * r;
  return os * (T(1) + s + T(5.0 / 3.0) * d2) * sexp(-s);
}

template <typename T, int FAM>
__device__ __forceinline__ T dk_dd2(T d2, T k, T os) {
  if (FAM == kRbf) return T(-0.5) * k;
  if (!(d2 > T(0))) return T(0);
  const T r = ssqrt(d2);
  if (FAM == kMatern12) return -os * sexp(-r) / (T(2) * (r > T(1e-12) ? r : T(1e-12)));
  if (FAM == kMatern32) return T(-1.5) * os * sexp(T(-1.7320508075688772) * r);
  const T s = T(2.23606797749979) * r;
  return T(-5.0 / 6.0) * os * (T(1) + s) * sexp(-s);
}

template <typename T>
__device__ __forceinline__ T bf16_round(T x) {
  return T(__bfloat162float(__float2bfloat16(float(x))));
}

// Rows r0 .. r0 + R - 1 of chain c, scaled by inv_ls, into xs (R x D), with
// y into ys; rows past n are zero.
template <typename T>
__device__ void load_rows(const Args& a, int c, long long r0, int R, const T* X,
                          const T* y, const long long* idx, const T* il, T* xs, T* ys) {
  const int tid = threadIdx.x, D = a.D;
  for (int e = tid; e < R * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const long long gr = r0 + r;
    T v = T(0);
    if (gr < a.n) {
      const long long row = a.has_idx ? idx[(long long)c * a.n + gr] : gr;
      v = X[row * D + d] * il[d];
    }
    xs[e] = v;
  }
  if (tid < R) {
    const long long gr = r0 + tid;
    T v = T(0);
    if (gr < a.n) v = y[a.has_idx ? idx[(long long)c * a.n + gr] : gr];
    ys[tid] = v;
  }
  __syncthreads();
}

// d2 of a scaled row and an inducing column as the sum of squared
// differences: exactly 0 at coincident points (the norm expansion of the
// TPU kernel leaves roundoff there, which the Matern-1/2 square root
// amplifies to ~1e-3 of k in float32).
template <typename T>
__device__ __forceinline__ T sq_dist(const T* xr, const T* zm, int D) {
  T d2 = T(0);
  for (int d = 0; d < D; ++d) {
    const T u = xr[d] - zm[d];
    d2 += u * u;
  }
  return d2;
}

template <typename T, int FAM, bool BF16>
__global__ void __launch_bounds__(kThreads)
stats_fwd_kernel(Args a, const T* X, const T* y, const T* Zs, const T* inv_ls,
                 const T* os_, const long long* idx, T* part) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int g = blockIdx.x, c = blockIdx.y, tp = blockIdx.z;
  const int ti = tp / a.T, tj = tp % a.T;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const bool diag = ti == tj;
  const int D = a.D, M = a.M, tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  T* xs = sm;                        // kRowsFwd x D
  T* ys = xs + kRowsFwd * D;         // kRowsFwd
  T* kI = ys + kRowsFwd;             // kRowsFwd x kTile
  T* kJ = diag ? kI : kI + kRowsFwd * kTile;
  const T* zs = Zs + (long long)c * M * D;
  const T* il = inv_ls + (long long)c * D;
  const T os = os_[c];

  T acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = T(0);
  T sky = T(0);
  const long long ntiles = (a.n + kRowsFwd - 1) / kRowsFwd;
  for (long long t = g; t < ntiles; t += a.G) {
    const long long r0 = t * kRowsFwd;
    load_rows(a, c, r0, kRowsFwd, X, y, idx, il, xs, ys);
    for (int e = tid; e < kRowsFwd * kTile; e += kThreads) {
      const int r = e / kTile, mm = e % kTile;
      T kv = T(0), kw = T(0);
      if (r0 + r < a.n) {
        if (i0 + mm < M) kv = k_of_d2<T, FAM>(sq_dist(xs + r * D, zs + (i0 + mm) * D, D), os);
        if (!diag && j0 + mm < M)
          kw = k_of_d2<T, FAM>(sq_dist(xs + r * D, zs + (j0 + mm) * D, D), os);
      }
      kI[e] = kv;
      if (!diag) kJ[e] = kw;
    }
    __syncthreads();
    for (int r = 0; r < kRowsFwd; ++r) {
      T av[8], bv[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        av[p] = kI[r * kTile + ty + 16 * p];
        bv[p] = kJ[r * kTile + tx + 16 * p];
        if (BF16) {
          av[p] = bf16_round(av[p]);
          bv[p] = bf16_round(bv[p]);
        }
      }
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[p][q] += av[p] * bv[q];
    }
    if (diag && tid < kTile)
      for (int r = 0; r < kRowsFwd; ++r) sky += kI[r * kTile + tid] * ys[r];
    __syncthreads();
  }
  T* P = part + (long long)(c * a.G + g) * (M * M + M);
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = i0 + ty + 16 * p, j = j0 + tx + 16 * q;
      if (i < M && j < M) P[i * M + j] = acc[p][q];
    }
  if (diag && tid < kTile && i0 + tid < M) P[M * M + i0 + tid] = sky;
}

// out = the sum over g = 0 .. G-1, in that order, of the partials.
template <typename T>
__global__ void stats_fwd_reduce(Args a, const T* part, T* Skk, T* Sky) {
  const int per = a.M * a.M + a.M;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)a.C * per) return;
  const int c = e / per, q = e % per;
  T s = T(0);
  for (int g = 0; g < a.G; ++g) s += part[(long long)(c * a.G + g) * per + q];
  if (q < a.M * a.M)
    Skk[(long long)c * a.M * a.M + q] = s;
  else
    Sky[(long long)c * a.M + q - a.M * a.M] = s;
}

template <typename T, int FAM>
__global__ void __launch_bounds__(kThreads)
stats_bwd_kernel(Args a, const T* X, const T* y, const T* Zs, const T* inv_ls,
                 const T* os_, const long long* idx, const T* gsym,
                 const T* dsky, T* part) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  __shared__ T red[kThreads / 32];
  const int g = blockIdx.x, c = blockIdx.y;
  const int D = a.D, M = a.M, tid = threadIdx.x;
  T* xs = sm;                        // kRowsBwd x D
  T* ys = xs + kRowsBwd * D;         // kRowsBwd
  T* kk = ys + kRowsBwd;             // kRowsBwd x M
  T* ww = kk + kRowsBwd * M;         // kRowsBwd x M: d2, then w
  const T* zs = Zs + (long long)c * M * D;
  const T* il = inv_ls + (long long)c * D;
  const T* gc = gsym + (long long)c * M * M;
  const T* dy = dsky + (long long)c * M;
  const T os = os_[c];
  const int MD = M * D;
  // this block's partial: dzs terms (M x D), w (xs - zs)^2 by (m, d), dos,
  // then the latter summed over m (D)
  T* P = part + (long long)(c * a.G + g) * (2 * MD + 1 + D);
  for (int e = tid; e < 2 * MD; e += kThreads) P[e] = T(0);
  T dos = T(0);
  const long long ntiles = (a.n + kRowsBwd - 1) / kRowsBwd;
  for (long long t = g; t < ntiles; t += a.G) {
    const long long r0 = t * kRowsBwd;
    load_rows(a, c, r0, kRowsBwd, X, y, idx, il, xs, ys);
    for (int e = tid; e < kRowsBwd * M; e += kThreads) {
      const int r = e / M, m = e % M;
      const T d2 = sq_dist(xs + r * D, zs + m * D, D);
      kk[e] = r0 + r < a.n ? k_of_d2<T, FAM>(d2, os) : T(0);
      ww[e] = d2;
    }
    __syncthreads();
    for (int e = tid; e < kRowsBwd * M; e += kThreads) {
      const int r = e / M, m = e % M;
      T w = T(0);
      if (r0 + r < a.n) {
        T dk = ys[r] * dy[m];
        const T* kr = kk + r * M;
        for (int j = 0; j < M; ++j) dk += kr[j] * __ldg(gc + j * M + m);
        dos += kk[e] * dk;
        w = dk_dd2<T, FAM>(ww[e], kk[e], os) * dk;
      }
      ww[e] = w;
    }
    __syncthreads();
    for (int e = tid; e < MD; e += kThreads) {
      const int m = e / D, d = e % D;
      const T zv = zs[e];
      T s1 = T(0), s2 = T(0);
      for (int r = 0; r < kRowsBwd; ++r) {
        const T diff = xs[r * D + d] - zv;
        const T wd = ww[r * M + m] * diff;
        s1 += wd;
        s2 += wd * diff;
      }
      P[e] += s1;
      P[MD + e] += s2;
    }
    __syncthreads();
  }
  // block sum of dos in a fixed order: warp shuffles, then warp 0
  for (int o = 16; o > 0; o >>= 1) dos += __shfl_down_sync(0xffffffffu, dos, o);
  if (tid % 32 == 0) red[tid / 32] = dos;
  __syncthreads();
  if (tid == 0) {
    T s = T(0);
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
    P[2 * MD] = s;
  }
  for (int d = tid; d < D; d += kThreads) {
    T s = T(0);
    for (int m = 0; m < M; ++m) s += P[MD + m * D + d];
    P[2 * MD + 1 + d] = s;
  }
}

// dzs = -2 sum_g, term = sum_g (of the blocks' sums over m), dos = sum_g / os,
// in fixed orders.
template <typename T>
__global__ void stats_bwd_reduce(Args a, const T* part, const T* os_, T* dzs,
                                 T* term, T* dos) {
  const int MD = a.M * a.D, per = 2 * MD + 1 + a.D, outs = MD + a.D + 1;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)a.C * outs) return;
  const int c = e / outs, q = e % outs;
  const T* base = part + (long long)c * a.G * per;
  T s = T(0);
  if (q < MD) {
    for (int g = 0; g < a.G; ++g) s += base[(long long)g * per + q];
    dzs[(long long)c * MD + q] = T(-2) * s;
  } else if (q < MD + a.D) {
    const int d = q - MD;
    for (int g = 0; g < a.G; ++g) s += base[(long long)g * per + 2 * MD + 1 + d];
    term[(long long)c * a.D + d] = s;
  } else {
    for (int g = 0; g < a.G; ++g) s += base[(long long)g * per + 2 * MD];
    dos[c] = s / os_[c];
  }
}

inline Args make_args(const long long* cfg) {
  Args a;
  a.N = cfg[0];
  a.n = cfg[1];
  a.M = (int)cfg[2];
  a.D = (int)cfg[3];
  a.C = (int)cfg[4];
  a.G = (int)cfg[5];
  a.T = (int)cfg[8];
  a.has_idx = cfg[7] != 0;
  return a;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T, int FAM, bool BF16>
int fwd_fam(const Args& a, const T* X, const T* y, const T* Zs, const T* il,
            const T* os, const long long* idx, T* part, cudaStream_t s) {
  const size_t smem = sizeof(T) * (kRowsFwd * a.D + kRowsFwd + 2 * kRowsFwd * kTile);
  auto kern = stats_fwd_kernel<T, FAM, BF16>;
  if (int err = set_smem(kern, smem)) return err;
  kern<<<dim3(a.G, a.C, a.T * a.T), kThreads, smem, s>>>(a, X, y, Zs, il, os, idx, part);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const long long* cfg, const void* X, const void* y, const void* Zs,
               const void* il, const void* os, const void* idx, void* part,
               void* Skk, void* Sky, void* stream) {
  const Args a = make_args(cfg);
  const int fam = (int)cfg[6], bf16 = (int)cfg[9];
  const cudaStream_t s = (cudaStream_t)stream;
  const T *Xp = (const T*)X, *yp = (const T*)y, *Zp = (const T*)Zs, *ip = (const T*)il,
          *op = (const T*)os;
  const long long* ix = (const long long*)idx;
  T* pp = (T*)part;
  int err;
#define GGP_FWD(F)                                                              \
  err = bf16 ? fwd_fam<T, F, true>(a, Xp, yp, Zp, ip, op, ix, pp, s)           \
             : fwd_fam<T, F, false>(a, Xp, yp, Zp, ip, op, ix, pp, s)
  switch (fam) {
    case kRbf: GGP_FWD(kRbf); break;
    case kMatern12: GGP_FWD(kMatern12); break;
    case kMatern32: GGP_FWD(kMatern32); break;
    case kMatern52: GGP_FWD(kMatern52); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef GGP_FWD
  if (err) return err;
  const long long outs = (long long)a.C * (a.M * a.M + a.M);
  stats_fwd_reduce<T><<<(unsigned)((outs + 255) / 256), 256, 0, s>>>(a, pp, (T*)Skk, (T*)Sky);
  return (int)cudaGetLastError();
}

template <typename T, int FAM>
int bwd_fam(const Args& a, const T* X, const T* y, const T* Zs, const T* il,
            const T* os, const long long* idx, const T* gs, const T* dy, T* part,
            cudaStream_t s) {
  const size_t smem = sizeof(T) * (kRowsBwd * a.D + kRowsBwd + 2 * kRowsBwd * a.M);
  auto kern = stats_bwd_kernel<T, FAM>;
  if (int err = set_smem(kern, smem)) return err;
  kern<<<dim3(a.G, a.C), kThreads, smem, s>>>(a, X, y, Zs, il, os, idx, gs, dy, part);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const long long* cfg, const void* X, const void* y, const void* Zs,
               const void* il, const void* os, const void* idx, const void* gsym,
               const void* dsky, void* part, void* dzs, void* term, void* dos,
               void* stream) {
  const Args a = make_args(cfg);
  const int fam = (int)cfg[6];
  const cudaStream_t s = (cudaStream_t)stream;
  const T *Xp = (const T*)X, *yp = (const T*)y, *Zp = (const T*)Zs, *ip = (const T*)il,
          *op = (const T*)os, *gp = (const T*)gsym, *dp = (const T*)dsky;
  const long long* ix = (const long long*)idx;
  T* pp = (T*)part;
  int err;
  switch (fam) {
    case kRbf: err = bwd_fam<T, kRbf>(a, Xp, yp, Zp, ip, op, ix, gp, dp, pp, s); break;
    case kMatern12: err = bwd_fam<T, kMatern12>(a, Xp, yp, Zp, ip, op, ix, gp, dp, pp, s); break;
    case kMatern32: err = bwd_fam<T, kMatern32>(a, Xp, yp, Zp, ip, op, ix, gp, dp, pp, s); break;
    case kMatern52: err = bwd_fam<T, kMatern52>(a, Xp, yp, Zp, ip, op, ix, gp, dp, pp, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  const long long outs = (long long)a.C * (a.M * a.D + a.D + 1);
  stats_bwd_reduce<T><<<(unsigned)((outs + 255) / 256), 256, 0, s>>>(a, pp, op, (T*)dzs,
                                                                       (T*)term, (T*)dos);
  return (int)cudaGetLastError();
}

}  // namespace stats
}  // namespace ggp

#define GGP_SFWD_ARGS                                                              \
  const long long *cfg, const void *X, const void *y, const void *Zs, const void *il, \
      const void *os, const void *idx, void *part, void *Skk, void *Sky, void *stream
#define GGP_SFWD_PASS cfg, X, y, Zs, il, os, idx, part, Skk, Sky, stream
#define GGP_SBWD_ARGS                                                              \
  const long long *cfg, const void *X, const void *y, const void *Zs, const void *il, \
      const void *os, const void *idx, const void *gsym, const void *dsky, void *part, \
      void *dzs, void *term, void *dos, void *stream
#define GGP_SBWD_PASS cfg, X, y, Zs, il, os, idx, gsym, dsky, part, dzs, term, dos, stream

extern "C" {
int ggp_vfe_stats_fwd_f32(GGP_SFWD_ARGS) {
  return ggp::stats::launch_fwd<float>(GGP_SFWD_PASS);
}
int ggp_vfe_stats_fwd_f64(GGP_SFWD_ARGS) {
  return ggp::stats::launch_fwd<double>(GGP_SFWD_PASS);
}
int ggp_vfe_stats_bwd_f32(GGP_SBWD_ARGS) {
  return ggp::stats::launch_bwd<float>(GGP_SBWD_PASS);
}
int ggp_vfe_stats_bwd_f64(GGP_SBWD_ARGS) {
  return ggp::stats::launch_bwd<double>(GGP_SBWD_PASS);
}
}
