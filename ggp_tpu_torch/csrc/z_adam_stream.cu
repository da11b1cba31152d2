// Kernel 12: the streamed chunk of Adam steps on Z over a hyper trace.
//
// Replaces ggp_tpu/ops/fused_sgpr.py `_zadam_chunk_body` in both its forms,
// streamed (the pallas_call at fused_sgpr.py:338, n > 2048) and resident
// (:352, site 7; the port runs this kernel at every n): K Adam steps on Z
// only, each step the mean over the S rows theta_s of the hyper trace of
// -ELBO(theta_s, Z) and of its Z gradient, non-finite entries of the mean
// gradient zeroed, then the optax Adam update with bias correction from t0.
// No clip and no box. The trainers' pivot policy: modified Cholesky with
// floor 1e-6 max(sf2, 1) on Kmm and 1e-6 on B (cfg FLOOR).
//
// The math is the JAX streamed core's (fused_bound.py
// `_rbf_vfe_neg_logpost_vg_streaming`): the resident collapsed bound
// reorganised into two additive passes over row blocks of NB rows, with
// the M x M epilogue between. Each step is five launches:
//   prep   (grid S):      the lengthscale cap from max|X| and max|Z|, Kmm,
//                         its floored factor U = L^T and V = L^-T;
//   pass 1 (grid P x S):  per row block Knm_b and An_b = Knm_b V / sigma,
//                         the block's partials of B - I = sum An_b^T An_b,
//                         u = sum An_b^T y_b and yy;
//   epi    (grid S):      the partials summed, then the M x M part of the
//                         bound (collapsed_mm of vfe_bound.cuh): F, v, w, Y1
//                         and dF/dKmm, and the Kmm half of the Z adjoint;
//   pass 2 (grid P x S):  Knm_b and An_b recomputed (as the JAX body does,
//                         rather than kept: n x M per theta), Pnm_b = dF/dKnm
//                         o Knm_b, and the block's partial of the Knm half of
//                         the Z adjoint, sum_i Pnm[i, a] (zs_a - xs_i);
//   finish (one block):   the partials summed over row blocks, then over the
//                         trace rows, in a fixed order; the Adam update; the
//                         step's loss.
// Block (p, s) of a pass takes the row blocks p, p + P, p + 2P, ... of
// theta_s and accumulates into its own partial, so the work space is
// O(P S (NB M + M^2)) for any n, and the partials are summed in a fixed
// order: no float atomics, so a call's result does not depend on
// scheduling. P = min(row blocks, max(1, kStreamBlocks / S)), fixed by the
// shapes.
//
// Sums over rows (B, u, yy and the Z adjoint's Knm half) accumulate in
// double in both types, the adjoint in difference form, as vfe_bound.cuh
// does: at thousands of rows a float32 running sum, or the expanded form
// zs_a sum_i P - sum_i P xs_i, loses the digits Adam's normalised steps
// carry into every coordinate.
//
// What bounds it on the card: the O(n M^2) products of the passes (An_b,
// B's partial, dF/dKnm), which spread over P S blocks, and the epilogue's
// two factorisations and inverses on one block per trace row, a chain of
// M barrier steps each. What the design does about it: trace rows and row
// blocks are independent, so a step fills the card with P S blocks (the
// port's first kernel for site 7 ran the S rows one after another on one
// block).
// One launch per phase per step; the step loop runs on the host inside one
// call, with cudaGetLastError checked after every launch. The products are
// block_gemm's shared-memory tiles; wgmma is later work.
#include "adam.cuh"
#include "row_blocks.cuh"

namespace ggp {
namespace zstream {

constexpr int kStreamBlocks = 264;   // blocks a pass aims at: two per SM of an H100
constexpr int TR = kRowTR, TC = kRowTC, KC = kRowKC;

struct Shape {
  int n, m, d, S, NB, R, P;
};

inline Shape shape(int n, int m, int d, int S, int NB) {
  Shape sh{n, m, d, S, NB, (n + NB - 1) / NB, 0};
  const int want = kStreamBlocks / S;
  sh.P = want < 1 ? 1 : (want > sh.R ? sh.R : want);
  return sh;
}

// Per trace row, in the T work space: one bound's M x M work (Work, n = 0:
// Kmm, U, V, B, W, UB, VB, Binv, Y1, VT0, Pmm, the m-vectors and GmmZ),
// then the capped inverse lengthscales (kMaxDim) and the scalars [F, sf2,
// s2, pad].
__host__ __device__ inline long theta_elems(const Shape& s) {
  return work_elems(0, s.m, s.d) + kMaxDim + 4;
}
// Per pass block, in the T work space: Knm_b and An_b (NB x M) and a row
// vector (NB).
__host__ __device__ inline long block_elems(const Shape& s) {
  return 2L * s.NB * s.m + s.NB;
}
// Per pass block, in the double partials: B's upper triangle (M x M), u
// (M), yy (1, padded to 2), the Z adjoint's Knm half (M x D).
__host__ __device__ inline long partial_elems(const Shape& s) {
  return (long)s.m * s.m + s.m + 2 + (long)s.m * s.d;
}

inline long work_total(const Shape& s) {
  return s.S * theta_elems(s) + (long)s.P * s.S * block_elems(s);
}
inline long partial_total(const Shape& s) { return (long)s.P * s.S * partial_elems(s); }

template <typename T>
struct ThetaArea {
  Work<T> w;
  T* il;       // capped inverse lengthscales (d)
  T* scal;     // [F, sf2, s2]
};

template <typename T>
__device__ ThetaArea<T> theta_area(T* work, const Shape& s, int th) {
  T* base = work + th * theta_elems(s);
  ThetaArea<T> a;
  a.w = make_work(base, 0, s.m, s.d);
  a.il = base + work_elems(0, s.m, s.d);
  a.scal = a.il + kMaxDim;
  return a;
}

template <typename T>
__device__ T* block_area(T* work, const Shape& s, int th, int p) {
  return work + s.S * theta_elems(s) + (long)(th * s.P + p) * block_elems(s);
}

template <typename D>
__device__ D* partial_area(D* part, const Shape& s, int th, int p) {
  return part + (long)(th * s.P + p) * partial_elems(s);
}

// prep, block th: the cap, Kmm and its floored factor
template <typename T>
__global__ void __launch_bounds__(kThreads)
prep_kernel(BoundCfg cf, Shape s, const T* thetas, const T* Z, const T* X, T* work) {
  __shared__ T red[32];
  const int tid = threadIdx.x, nt = blockDim.x, th = blockIdx.x;
  const int n = s.n, m = s.m, d = s.d;
  const T* theta = thetas + th * (d + 2);
  ThetaArea<T> a = theta_area(work, s, th);
  const Work<T>& w = a.w;

  // capped inverse lengthscale: min(exp(-theta), 1024 / max(1e-3, |X|, |Z|))
  T mx = T(0);
  for (long i = tid; i < (long)n * d; i += nt) mx = jmax(mx, gabs(X[i]));
  for (int i = tid; i < m * d; i += nt) mx = jmax(mx, gabs(Z[i]));
  mx = jmax(block_max(mx, red), T(1e-3));
  const T cap = T(1024) / mx;
  const T sf2 = gexp(theta[d]), jit_scale = jmax(sf2, T(1));
  for (int k = tid; k < d; k += nt) a.il[k] = jmin(gexp(-theta[k]), cap);
  if (tid == 0) {
    a.scal[1] = sf2;
    a.scal[2] = gexp(theta[d + 1]);
  }
  __syncthreads();
  for (int j = tid; j < m; j += nt) {
    T q = T(0);
    for (int k = 0; k < d; ++k) { const T b = Z[j * d + k] * a.il[k]; q += b * b; }
    w.zn[j] = q;
  }
  __syncthreads();
  const T jitter = T(cf.jitter);
  for (int idx = tid; idx < m * m; idx += nt) {
    const int i = idx / m, j = idx % m;
    T dot = T(0);
    for (int k = 0; k < d; ++k) dot += (Z[i * d + k] * a.il[k]) * (Z[j * d + k] * a.il[k]);
    const T r2 = jmax(w.zn[i] + w.zn[j] - T(2) * dot, T(0));
    const T kab = sf2 * gexp(T(-0.5) * r2);
    w.Kmm[idx] = kab;
    w.W[idx] = kab + (i == j ? jitter * jit_scale : T(0));
  }
  __syncthreads();
  chol_upper(w.W, w.U, m, T(cf.floor) * jit_scale, cf.floor > 0.0);   // U = L^T
  ut_inv(w.U, w.V, m);                                                  // V = L^-T
}

// Knm_b and An_b = Knm_b V / sigma of the nr rows from row0 (both passes)
template <typename T>
__device__ void block_grams(const Shape& s, const ThetaArea<T>& a, const T* X, const T* Z,
                            int row0, int nr, T* Knm, T* An, T* xn, const T* il,
                            T (*sA)[TR + 1], T (*sB)[TC + 1]) {
  block_knm(s.m, s.d, X, Z, a.w.zn, il, a.scal[1], row0, nr, Knm, xn);
  block_an(s.m, nr, Knm, a.w.V, gsqrt(a.scal[2]), An, sA, sB);
}

// pass 1, block (p, th): partials of B - I (upper triangle), u and yy
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
pass1_kernel(Shape s, const T* Z, const T* X, const T* y, T* work, double* part) {
  __shared__ T sA[KC][TR + 1];
  __shared__ T sB[KC][TC + 1];
  __shared__ T il[kMaxDim];
  __shared__ double red[32];
  const int tid = threadIdx.x, nt = blockDim.x, p = blockIdx.x, th = blockIdx.y;
  const int m = s.m;
  const ThetaArea<T> a = theta_area(work, s, th);
  T* Knm = block_area(work, s, th, p);
  T* An = Knm + (long)s.NB * m;
  T* xn = An + (long)s.NB * m;
  double* Bp = partial_area(part, s, th, p);
  double* up = Bp + (long)m * m;
  double* yyp = up + m;
  for (int k = tid; k < s.d; k += nt) il[k] = a.il[k];
  for (int idx = tid; idx < m * m; idx += nt) Bp[idx] = 0.0;
  for (int j = tid; j < m; j += nt) up[j] = 0.0;
  double yy = 0.0;
  __syncthreads();
  for (int t = p; t < s.R; t += s.P) {
    const int row0 = t * s.NB, nr = min(s.NB, s.n - row0);
    block_grams(s, a, X, Z, row0, nr, Knm, An, xn, il, sA, sB);
    block_gemm<double, TR, TC, KC, kThreads>(
        m, m, nr, An, 1, m, An, m, 1, SYM_UPPER, sA, sB, [&](int i, int j, double v) {
          if (i <= j) Bp[i * m + j] += v;
        });
    for (int j = tid; j < m; j += nt) up[j] += dot_acc<double>(An + j, m, y + row0, 1, 0, nr);
    for (int i = tid; i < nr; i += nt) yy += double(y[row0 + i]) * double(y[row0 + i]);
    __syncthreads();
  }
  yy = block_sum(yy, red);
  if (tid == 0) yyp[0] = yy;
}

// epilogue, block th: B, u, yy from the partials, the M x M part of the
// bound, F and the Kmm half of the Z adjoint (GmmZ)
template <typename T>
__global__ void __launch_bounds__(kThreads)
epi_kernel(BoundCfg cf, Shape s, const T* Z, T* work, const double* part) {
  __shared__ T sA[KC][TR + 1];
  __shared__ T sB[KC][TC + 1];
  __shared__ BoundShared<T> sh;
  __shared__ double red[32];
  const int tid = threadIdx.x, nt = blockDim.x, th = blockIdx.x;
  const int m = s.m, d = s.d;
  const ThetaArea<T> a = theta_area(work, s, th);
  const Work<T>& w = a.w;
  const long pe = partial_elems(s);
  const double* P0 = partial_area(part, s, th, 0);
  for (int idx = tid; idx < m * m; idx += nt) {
    const int i = idx / m, j = idx % m;
    const int lo = i < j ? i : j, hi = i < j ? j : i;
    const T v = T(sum_partials(P0, pe, s.P, (long)lo * m + hi)) + (i == j ? T(1) : T(0));
    w.B[idx] = v;
    w.W[idx] = v;
  }
  for (int j = tid; j < m; j += nt) w.u[j] = T(sum_partials(P0, pe, s.P, (long)m * m + j));
  if (tid == 0) red[0] = sum_partials(P0, pe, s.P, (long)m * m + m);
  __syncthreads();
  const T yy = T(red[0]);
  const T sf2 = a.scal[1], s2 = a.scal[2];
  const CollapsedMM<T> mm = collapsed_mm<T, TR, TC, KC, kThreads>(cf, w, sh, s2, true, sA, sB);
  const T nT = T(s.n), mT = T(m);
  const T t_term = nT * sf2 - s2 * (mm.trB - mT);
  const T two_pi = T(6.283185307179586);
  if (tid == 0)
    a.scal[0] = T(-0.5) * nT * glog(two_pi * s2) - T(0.5) * mm.logdetB
                - T(0.5) * (yy - mm.uv) / s2 - T(0.5) * t_term / s2;
  // GmmZ[a, k] = sum_b Pmm[a, b] (zs_a - zs_b), in difference form
  for (int idx = tid; idx < m * d; idx += nt) {
    const int i = idx / d, k = idx % d;
    const T za = Z[idx] * a.il[k];
    T g = T(0);
    for (int b = 0; b < m; ++b) g += w.Pmm[i * m + b] * (za - Z[b * d + k] * a.il[k]);
    w.GmmZ[idx] = g;
  }
}

// pass 2, block (p, th): Pnm_b = dF/dKnm o Knm_b and the partial of the Knm
// half of the Z adjoint, sum_i Pnm[i, a] (zs_a - xs_i), in double
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
pass2_kernel(Shape s, const T* Z, const T* X, const T* y, T* work, double* part) {
  __shared__ T sA[KC][TR + 1];
  __shared__ T sB[KC][TC + 1];
  __shared__ T il[kMaxDim];
  const int tid = threadIdx.x, nt = blockDim.x, p = blockIdx.x, th = blockIdx.y;
  const int m = s.m, d = s.d;
  const ThetaArea<T> a = theta_area(work, s, th);
  const Work<T>& w = a.w;
  T* Knm = block_area(work, s, th, p);
  T* An = Knm + (long)s.NB * m;
  T* xn = An + (long)s.NB * m;
  double* Gp = partial_area(part, s, th, p) + (long)m * m + m + 2;
  const T s2 = a.scal[2], sigma = gsqrt(s2);
  for (int k = tid; k < d; k += nt) il[k] = a.il[k];
  for (int idx = tid; idx < m * d; idx += nt) Gp[idx] = 0.0;
  __syncthreads();
  for (int t = p; t < s.R; t += s.P) {
    const int row0 = t * s.NB, nr = min(s.NB, s.n - row0);
    block_grams(s, a, X, Z, row0, nr, Knm, An, xn, il, sA, sB);
    T* alpha = xn;                                 // xn is free once Knm_b is formed
    for (int i = tid; i < nr; i += nt)
      alpha[i] = (y[row0 + i] - dot_acc<T>(An + i * m, 1, w.v, 1, 0, m)) / s2;
    __syncthreads();
    // dKnm = (An Y1 + alpha w^T) / sigma ; Pnm = dKnm o Knm, in Knm's place
    block_gemm<T, TR, TC, KC, kThreads>(nr, m, m, An, m, 1, w.Y1, m, 1, K_FULL, sA, sB,
                                        [&](int i, int b, T v) {
                                          Knm[i * m + b] *= (v + alpha[i] * w.w[b]) / sigma;
                                        });
    for (int idx = tid; idx < m * d; idx += nt) {
      const int j = idx / d, k = idx % d;
      const T za = Z[idx] * il[k];
      double acc = 0.0;
      for (int i = 0; i < nr; ++i)
        acc += double(Knm[i * m + j]) * double(za - X[(long)(row0 + i) * d + k] * il[k]);
      Gp[idx] += acc;
    }
    __syncthreads();
  }
}

// finish, one block: the mean over the trace rows of U and dU/dZ, the Adam
// update of Z (in place, with its moments), the step's loss
template <typename T>
__global__ void __launch_bounds__(kThreads)
finish_kernel(Shape s, TrainCfg tc, int t, T* Z, T* m_z, T* v_z, T* losses, T* work,
              const double* part) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m = s.m, d = s.d, md = m * d;
  const T inv_s = T(1) / T(s.S), lr = T(tc.lr);
  const T ta = T(tc.t0) + T(t) + T(1);
  const long pe = partial_elems(s), off = (long)m * m + m + 2;
  for (int idx = tid; idx < md; idx += nt) {
    const int k = idx % d;
    T g = T(0);
    for (int th = 0; th < s.S; ++th) {
      const ThetaArea<T> a = theta_area(work, s, th);
      const double acc = sum_partials(partial_area(part, s, th, 0) + off, pe, s.P, idx);
      // dU/dZ = -(dF/dZ) = (2 GmmZ + GnmZ) il
      g = g + inv_s * ((T(2) * a.w.GmmZ[idx] + T(acc)) * a.il[k]);
    }
    T pz = Z[idx], mm = m_z[idx], vv = v_z[idx];
    adam_update(pz, g, mm, vv, ta, lr);
    Z[idx] = pz;
    m_z[idx] = mm;
    v_z[idx] = vv;
  }
  if (tid == 0) {
    T loss = T(0);
    for (int th = 0; th < s.S; ++th) loss = loss + inv_s * (-theta_area(work, s, th).scal[0]);
    losses[t] = loss;
  }
}

template <typename T>
int launch(const double* cfg, const void* thetas, void* Z, void* m_z, void* v_z,
           const void* X, const void* y, void* losses, void* work, void* part,
           void* stream) {
  const BoundCfg cf = bound_cfg(cfg);
  const TrainCfg tc = train_cfg(cfg);
  const Shape s = shape(cf.n, cf.m, cf.d, tc.s_act, (int)cfg[C_NB]);
  cudaStream_t st = (cudaStream_t)stream;
  T* w = (T*)work;
  double* pa = (double*)part;
  const T* th = (const T*)thetas;
  const T* Xp = (const T*)X;
  const T* yp = (const T*)y;
  T* Zp = (T*)Z;
  const dim3 grid(s.P, s.S);
  for (int t = 0; t < tc.K; ++t) {
    prep_kernel<T><<<s.S, kThreads, 0, st>>>(cf, s, th, Zp, Xp, w);
    int err = (int)cudaGetLastError();
    if (err) return err;
    pass1_kernel<T><<<grid, kThreads, 0, st>>>(s, Zp, Xp, yp, w, pa);
    if ((err = (int)cudaGetLastError())) return err;
    epi_kernel<T><<<s.S, kThreads, 0, st>>>(cf, s, Zp, w, pa);
    if ((err = (int)cudaGetLastError())) return err;
    pass2_kernel<T><<<grid, kThreads, 0, st>>>(s, Zp, Xp, yp, w, pa);
    if ((err = (int)cudaGetLastError())) return err;
    finish_kernel<T><<<1, kThreads, 0, st>>>(s, tc, t, Zp, (T*)m_z, (T*)v_z, (T*)losses, w,
                                             pa);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return 0;
}

}  // namespace zstream
}  // namespace ggp

extern "C" {

// elements of the T work space (which = 0) and of the double partials
// (which = 1) of one call at (n, m, d) over S trace rows in row blocks of NB
long ggp_z_adam_stream_elems(int n, int m, int d, int S, int NB, int which) {
  const ggp::zstream::Shape s = ggp::zstream::shape(n, m, d, S, NB);
  return which == 0 ? ggp::zstream::work_total(s) : ggp::zstream::partial_total(s);
}

int ggp_z_adam_stream_f32(const double* cfg, const void* thetas, void* Z, void* m_z,
                          void* v_z, const void* X, const void* y, void* losses, void* work,
                          void* part, void* stream) {
  return ggp::zstream::launch<float>(cfg, thetas, Z, m_z, v_z, X, y, losses, work, part,
                                     stream);
}

int ggp_z_adam_stream_f64(const double* cfg, const void* thetas, void* Z, void* m_z,
                          void* v_z, const void* X, const void* y, void* losses, void* work,
                          void* part, void* stream) {
  return ggp::zstream::launch<double>(cfg, thetas, Z, m_z, v_z, X, y, losses, work, part,
                                      stream);
}

}  // extern "C"
