// One minibatch of the uncollapsed SVGP ELBO of the Scale(RBF-ARD) kernel
// with C latent functions: loss and hand-written adjoint in one block-wide
// device function, shared by the three SVI kernels of svi_chunk.cu.
//
// Replaces: ggp_tpu/ops/fused_svi.py `svgp_loss_vg` (the core of
// `_svi_chunk_body`: Gaussian, Bernoulli-probit and Poisson data terms) and
// `svgp_softmax_loss_vg` (the core of `_svi_softmax_chunk_body`: C latents
// sharing Kmm's factor and A = Lk^-1 Kms, antithetic Monte Carlo softmax
// data term). The math, per minibatch of nb rows gathered by index:
//   Lk = chol(Kmm + jitter max(sf2, 1) I)   (modified: pivot floor 1e-6 max(sf2, 1))
//   A = Lk^-1 Kms ; mean_c = A^T q_mu_c ; SA_c = qL_c^T A
//   var_c = max(sf2 - colsum A^2 + colsum SA_c^2, 1e-12)  (the clamp masks the adjoint)
//   ELBO = (N / nb) sum_i E_q[log p(y_i | f_i)] - sum_c KL(q(v_c) || N(0, I))
// and its adjoint: G = dELBO/dA, Kms_b = Lk^-T G, Kmm_b = -sym(Lk^-T Phi(G A^T) Lk^-1),
// then the RBF-ARD chain rules to the log-lengthscales, log-outputscale and Z.
//
// What bounds it on the card: one thread block walks a dependent chain of
// O(m^2 nb) products, an m x m factorisation and its inverse (m barrier
// steps each), and two multi-column triangular solves (m barrier steps
// each). At the paths' shapes (m <= 100, nb <= 256) that is barrier and L2
// latency, not FLOPs or HBM bytes. What the design does about it: the
// matrices live in a global scratch area that stays in the 50 MB L2, every
// loop is strided over the block's threads with one barrier per dependent
// step, and the triangular solves run on the factor (one barrier per row)
// rather than on the formed inverse, as the JAX core does for stability.
// Shared-memory tiles, wgmma and several blocks per step are later work.
#pragma once

#include "adam.cuh"

namespace ggp {

enum SviLik { L_GAUSS = 0, L_PROBIT = 1, L_POISSON = 2, L_SOFTMAX = 3 };
constexpr int kQuad = 20;          // Gauss-Hermite nodes (likelihoods.gauss_hermite)
constexpr int kMaxLatents = 16;    // softmax classes
constexpr int kMaxDraws = 8;       // BayesianSVGP hyper draws per step

struct SviCfg {
  int n, m, d, nb, K, lik, C, nhalf, S;
  double jitter, num_data, lr, t0, prior_var;
  double qx[kQuad], qw[kQuad];
};

inline SviCfg svi_cfg(const double* cfg) {
  SviCfg c;
  c.n = (int)cfg[C_N];
  c.m = (int)cfg[C_M];
  c.d = (int)cfg[C_D];
  c.nb = (int)cfg[C_NB];
  c.K = (int)cfg[C_K];
  c.lik = (int)cfg[C_LIK];
  c.C = (int)cfg[C_LATENTS];
  c.nhalf = (int)cfg[C_NHALF];
  c.S = (int)cfg[C_S_ACT];
  c.jitter = cfg[C_JITTER];
  c.num_data = cfg[C_NUM_DATA];
  c.lr = cfg[C_LR];
  c.t0 = cfg[C_T0];
  c.prior_var = cfg[C_PRIOR_VAR];
  for (int q = 0; q < kQuad; ++q) {
    c.qx[q] = cfg[C_QUAD + q];
    c.qw[q] = cfg[C_QUAD + kQuad + q];
  }
  return c;
}

__device__ __forceinline__ float glgamma(float x) { return lgammaf(x); }
__device__ __forceinline__ double glgamma(double x) { return lgamma(x); }
__device__ __forceinline__ float gerfc(float x) { return erfcf(x); }
__device__ __forceinline__ double gerfc(double x) { return erfc(x); }
__device__ __forceinline__ float gerfcx(float x) { return erfcxf(x); }
__device__ __forceinline__ double gerfcx(double x) { return erfcx(x); }

// (log Phi(z), phi(z) / Phi(z)), stable in both tails: below z = -1 through
// erfcx (Phi(z) = erfcx(-z/sqrt2) exp(-z^2/2) / 2, whose exp factor cancels
// in the ratio), above it Phi = 1 - erfc(z/sqrt2) / 2 directly.
template <typename T>
__device__ __forceinline__ void log_ndtr_ratio(T z, T* lp, T* r) {
  const T inv_sqrt2 = T(0.7071067811865476), inv_sqrt2pi = T(0.3989422804014327);
  if (z < T(-1)) {
    const T ex = gerfcx(-z * inv_sqrt2);
    *lp = glog(T(0.5) * ex) - T(0.5) * z * z;
    *r = T(2) * inv_sqrt2pi / ex;
  } else {
    const T q = T(0.5) * gerfc(z * inv_sqrt2);         // 1 - Phi(z)
    *lp = glog1p(-q);
    *r = inv_sqrt2pi * gexp(T(-0.5) * z * z) / (T(1) - q);
  }
}

template <typename T>
struct SviShared {
  T il[kMaxDim];                   // exp(-log_lengthscale)
  T red[32];
  T hyp[kMaxDim];                  // the kernel row of the current evaluation
  T g[kMaxDim];                    // d loss / d hyp
  T loss;
};

// Global-memory work of one evaluation (m inducing points, nb rows, C latents).
template <typename T>
struct SviWork {
  T *Zs, *Xs, *yb, *zn, *xn, *csA2, *dq;              // m d, nb d, nb, m, nb, nb, C m
  T *Kmm, *W, *U, *V, *Sg, *Kmmb;                     // m x m
  T *Kms, *A, *G;                                     // m x nb (G becomes Kms_b)
  T *SA;                                              // C x m x nb
  T *mean, *var, *clampv, *alpha, *bv;                // C x nb
  T *rs_mm, *rs_ms, *cs_ms, *PmmZs, *PmsXs;           // m, m, nb, m d, m d
  T *gZ, *gqmu, *gqraw;                               // m d, m C, C m m
};

__host__ __device__ inline long svi_work_elems(int m, int nb, int d, int C) {
  const long mm = (long)m * m, mn = (long)m * nb, md = (long)m * d;
  return 4L * md + (long)nb * d + 3L * nb + 3L * m + (long)C * m + 6L * mm + 3L * mn
         + (long)C * mn + 5L * C * nb + nb + (long)m * C + (long)C * mm;
}

template <typename T>
__device__ SviWork<T> make_svi_work(T* s, int m, int nb, int d, int C) {
  SviWork<T> w;
  const long mm = (long)m * m, mn = (long)m * nb, md = (long)m * d;
  w.Zs = s; s += md; w.Xs = s; s += (long)nb * d; w.yb = s; s += nb;
  w.zn = s; s += m; w.xn = s; s += nb; w.csA2 = s; s += nb; w.dq = s; s += (long)C * m;
  w.Kmm = s; s += mm; w.W = s; s += mm; w.U = s; s += mm; w.V = s; s += mm;
  w.Sg = s; s += mm; w.Kmmb = s; s += mm;
  w.Kms = s; s += mn; w.A = s; s += mn; w.G = s; s += mn;
  w.SA = s; s += (long)C * mn;
  w.mean = s; s += (long)C * nb; w.var = s; s += (long)C * nb;
  w.clampv = s; s += (long)C * nb; w.alpha = s; s += (long)C * nb; w.bv = s; s += (long)C * nb;
  w.rs_mm = s; s += m; w.rs_ms = s; s += m; w.cs_ms = s; s += nb;
  w.PmmZs = s; s += md; w.PmsXs = s; s += md;
  w.gZ = s; s += md; w.gqmu = s; s += (long)m * C; w.gqraw = s;
  return w;
}

// B := U^-T B for upper-triangular U (m x m), B (m x nc) in place: forward
// substitution, one barrier per row.
template <typename T>
__device__ void trsm_ut_t(const T* U, T* B, int m, int nc) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = 0; i < m; ++i) {
    const T inv = T(1) / U[i * m + i];
    const int len = (m - 1 - i) * nc;
    for (int idx = tid; idx < len; idx += nt) {
      const int j = i + 1 + idx / nc, k = idx % nc;
      B[j * nc + k] -= U[i * m + j] * (B[i * nc + k] * inv);
    }
    __syncthreads();
  }
  for (int idx = tid; idx < m * nc; idx += nt) B[idx] = B[idx] / U[(idx / nc) * (m + 1)];
  __syncthreads();
}

// B := U^-1 B (back substitution), in place, one barrier per row.
template <typename T>
__device__ void trsm_u(const T* U, T* B, int m, int nc) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = m - 1; i > 0; --i) {
    const T inv = T(1) / U[i * m + i];
    const int len = i * nc;
    for (int idx = tid; idx < len; idx += nt) {
      const int j = idx / nc, k = idx % nc;
      B[j * nc + k] -= U[j * m + i] * (B[i * nc + k] * inv);
    }
    __syncthreads();
  }
  for (int idx = tid; idx < m * nc; idx += nt) B[idx] = B[idx] / U[(idx / nc) * (m + 1)];
  __syncthreads();
}

// entry (a, b) of qL_c = tril(q_raw_c, -1) + diag(exp(diag q_raw_c)); dq holds the diagonal
template <typename T>
__device__ __forceinline__ T qL_at(const T* qraw_c, const T* dq_c, int m, int a, int b) {
  return a > b ? qraw_c[a * m + b] : (a == b ? dq_c[a] : T(0));
}

// One minibatch: the loss into sh.loss, d loss / d hyp into sh.g (d + 1
// entries, d + 2 with the Gaussian noise), and `weight` times d loss / d
// (Z, q_mu, q_raw) added into w.gZ, w.gqmu, w.gqraw. sh.hyp ([log_ls (d),
// log_os(, log_noise)]) must be visible to all threads on entry; the
// outputs are visible to all threads on return. idx_t: the nb row indices
// of this step; eps_t: (nhalf, nb, C) draws of the softmax term.
template <typename T>
__device__ void svgp_core(const SviCfg& cf, const T* Z, const T* qmu, const T* qraw,
                          const T* X, const T* y, const int* idx_t, const T* eps_t,
                          const SviWork<T>& w, SviShared<T>& sh, T weight) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m = cf.m, nb = cf.nb, d = cf.d, C = cf.C, lik = cf.lik;
  const T jitter = T(cf.jitter);
  const T scale = T(cf.num_data / double(nb));
  T* il = sh.il;

  for (int k = tid; k < d; k += nt) il[k] = gexp(-sh.hyp[k]);
  const T sf2 = gexp(sh.hyp[d]);
  const T s2 = lik == L_GAUSS ? gexp(sh.hyp[d + 1]) : T(1);
  const T jit_scale = jmax(sf2, T(1));
  __syncthreads();

  // gather the minibatch and scale the inputs
  for (int e = tid; e < nb * d; e += nt) {
    const int i = e / d, k = e % d;
    w.Xs[e] = X[(long)idx_t[i] * d + k] * il[k];
  }
  for (int i = tid; i < nb; i += nt) w.yb[i] = y[idx_t[i]];
  for (int e = tid; e < m * d; e += nt) w.Zs[e] = Z[e] * il[e % d];
  for (int e = tid; e < C * m; e += nt) {
    const int c = e / m, a = e % m;
    w.dq[e] = gexp(qraw[(long)c * m * m + (long)a * m + a]);
  }
  __syncthreads();
  for (int i = tid; i < nb; i += nt) {
    T s = T(0);
    for (int k = 0; k < d; ++k) s += w.Xs[i * d + k] * w.Xs[i * d + k];
    w.xn[i] = s;
  }
  for (int a = tid; a < m; a += nt) {
    T s = T(0);
    for (int k = 0; k < d; ++k) s += w.Zs[a * d + k] * w.Zs[a * d + k];
    w.zn[a] = s;
  }
  __syncthreads();

  // grams by norm expansion, clamped at 0; W = Kmm + relative jitter; A := Kms
  for (int e = tid; e < m * m; e += nt) {
    const int a = e / m, b = e % m;
    T dot = T(0);
    for (int k = 0; k < d; ++k) dot += w.Zs[a * d + k] * w.Zs[b * d + k];
    const T kab = sf2 * gexp(T(-0.5) * jmax(w.zn[a] + w.zn[b] - T(2) * dot, T(0)));
    w.Kmm[e] = kab;
    w.W[e] = kab + (a == b ? jitter * jit_scale : T(0));
  }
  for (int e = tid; e < m * nb; e += nt) {
    const int a = e / nb, i = e % nb;
    T dot = T(0);
    for (int k = 0; k < d; ++k) dot += w.Zs[a * d + k] * w.Xs[i * d + k];
    const T kai = sf2 * gexp(T(-0.5) * jmax(w.zn[a] + w.xn[i] - T(2) * dot, T(0)));
    w.Kms[e] = kai;
    w.A[e] = kai;
  }
  __syncthreads();
  chol_upper(w.W, w.U, m, T(1e-6) * jit_scale, true);     // U = Lk^T, modified
  ut_inv(w.U, w.V, m);                                     // V = Lk^-T
  trsm_ut_t(w.U, w.A, m, nb);                              // A = Lk^-1 Kms

  // q(f) moments per latent
  for (int i = tid; i < nb; i += nt) {
    T s = T(0);
    for (int a = 0; a < m; ++a) s += w.A[a * nb + i] * w.A[a * nb + i];
    w.csA2[i] = s;
  }
  for (int e = tid; e < C * nb; e += nt) {
    const int c = e / nb, i = e % nb;
    T s = T(0);
    for (int a = 0; a < m; ++a) s += w.A[a * nb + i] * qmu[a * C + c];
    w.mean[e] = s;
  }
  for (long e = tid; e < (long)C * m * nb; e += nt) {
    const int c = (int)(e / ((long)m * nb)), r = (int)(e % ((long)m * nb));
    const int a = r / nb, i = r % nb;
    const T* qc = qraw + (long)c * m * m;
    const T* dc = w.dq + c * m;
    T s = dc[a] * w.A[a * nb + i];
    for (int b = a + 1; b < m; ++b) s += qc[b * m + a] * w.A[b * nb + i];
    w.SA[e] = s;                                         // (qL_c^T A)[a, i]
  }
  __syncthreads();
  for (int e = tid; e < C * nb; e += nt) {
    const int c = e / nb, i = e % nb;
    const T* sa = w.SA + (long)c * m * nb;
    T s = T(0);
    for (int a = 0; a < m; ++a) s += sa[a * nb + i] * sa[a * nb + i];
    const T vr = sf2 - w.csA2[i] + s;
    w.clampv[e] = vr > T(1e-12) ? T(1) : T(0);
    w.var[e] = jmax(vr, T(1e-12));
  }
  __syncthreads();

  // data term: alpha = scale dve/dmean, bv = scale dve/dvar (clamp-masked)
  T p_ve = T(0), p_see = T(0), p_svar = T(0);
  for (int i = tid; i < nb; i += nt) {
    const T yi = w.yb[i];
    if (lik == L_GAUSS) {
      const T e = yi - w.mean[i];
      p_see += e * e;
      p_svar += w.var[i];
      w.alpha[i] = scale * e / s2;
      w.bv[i] = (T(-0.5) * scale / s2) * w.clampv[i];
    } else if (lik == L_PROBIT) {
      const T sg = T(2) * yi - T(1), sig = gsqrt(w.var[i]), mu = w.mean[i];
      T ve = T(0), dmu = T(0), dvr = T(0);
      for (int q = 0; q < kQuad; ++q) {
        const T x = T(cf.qx[q]), wq = T(cf.qw[q]);
        T lp, r;
        log_ndtr_ratio(sg * (mu + x * sig), &lp, &r);
        ve += wq * lp;
        dmu += wq * r;
        dvr += wq * x * r;
      }
      p_ve += ve;
      w.alpha[i] = scale * (sg * dmu);
      w.bv[i] = scale * (sg * dvr / (T(2) * sig)) * w.clampv[i];
    } else if (lik == L_POISSON) {
      const T mu = w.mean[i], rate = gexp(mu + T(0.5) * w.var[i]);
      p_ve += yi * mu - rate - glgamma(yi + T(1));
      w.alpha[i] = scale * (yi - rate);
      w.bv[i] = scale * (T(-0.5) * rate) * w.clampv[i];
    } else {                                            // softmax over C latents
      const int label = (int)yi;
      T mu[kMaxLatents], sg[kMaxLatents], f[kMaxLatents], dmu[kMaxLatents], dvr[kMaxLatents];
      for (int c = 0; c < C; ++c) {
        mu[c] = w.mean[c * nb + i];
        sg[c] = gsqrt(w.var[c * nb + i]);
        dmu[c] = T(0);
        dvr[c] = T(0);
      }
      for (int half = 0; half < 2; ++half) {
        const T sign = half == 0 ? T(1) : T(-1);
        for (int s = 0; s < cf.nhalf; ++s) {
          const T* es = eps_t + ((long)s * nb + i) * C;
          T mx = -ginf<T>();
          for (int c = 0; c < C; ++c) {
            f[c] = mu[c] + sg[c] * (sign * es[c]);
            mx = jmax(mx, f[c]);
          }
          T se = T(0), fy = T(0);
          for (int c = 0; c < C; ++c) {
            se += gexp(f[c] - mx);
            if (c == label) fy = f[c];
          }
          p_ve += fy - (mx + glog(se));
          const T inv_se = T(1) / se;
          for (int c = 0; c < C; ++c) {
            const T gy = (c == label ? T(1) : T(0)) - gexp(f[c] - mx) * inv_se;
            dmu[c] += gy;
            dvr[c] += gy * (sign * es[c]);
          }
        }
      }
      const T S = T(2 * cf.nhalf);
      for (int c = 0; c < C; ++c) {
        w.alpha[c * nb + i] = scale * (dmu[c] / S);
        w.bv[c * nb + i] = scale * (dvr[c] / S) / (T(2) * sg[c]) * w.clampv[c * nb + i];
      }
    }
  }
  const T ve_part = block_sum(p_ve, sh.red);
  T ve_sum, g_noise = T(0);
  if (lik == L_GAUSS) {
    const T see = block_sum(p_see, sh.red), svar = block_sum(p_svar, sh.red);
    const T nbT = T(nb);
    ve_sum = T(-0.5) * nbT * glog(T(6.283185307179586) * s2) - T(0.5) * (see + svar) / s2;
    g_noise = scale * (T(-0.5) * nbT / s2 + T(0.5) * (see + svar) / (s2 * s2)) * s2;
  } else {
    ve_sum = lik == L_SOFTMAX ? ve_part / T(2 * cf.nhalf) : ve_part;
  }

  // KL of q(v) against N(0, I), summed over the latents
  T p_tr = T(0), p_ld = T(0), p_mu = T(0);
  for (long e = tid; e < (long)C * m * m; e += nt) {
    const int c = (int)(e / ((long)m * m)), r = (int)(e % ((long)m * m));
    const int a = r / m, b = r % m;
    const T q = qL_at(qraw + (long)c * m * m, w.dq + c * m, m, a, b);
    p_tr += q * q;
  }
  for (int e = tid; e < C * m; e += nt) {
    p_ld += glog(w.dq[e]);
    p_mu += qmu[e] * qmu[e];
  }
  const T tr = block_sum(p_tr, sh.red), ld = block_sum(p_ld, sh.red);
  const T mu2 = block_sum(p_mu, sh.red);
  const T klq = T(0.5) * (tr + mu2 - T(m * C) - T(2) * ld);

  // G = dELBO/dA
  for (int e = tid; e < m * nb; e += nt) {
    const int a = e / nb, i = e % nb;
    T g = T(0), sbv = T(0);
    for (int c = 0; c < C; ++c) {
      const T* qc = qraw + (long)c * m * m;
      const T* sa = w.SA + (long)c * m * nb;
      T s = w.dq[c * m + a] * sa[a * nb + i];
      for (int b = 0; b < a; ++b) s += qc[a * m + b] * sa[b * nb + i];
      const T bvc = w.bv[c * nb + i];
      g += qmu[a * C + c] * w.alpha[c * nb + i] + T(2) * s * bvc;
      sbv += bvc;
    }
    w.G[e] = g - T(2) * w.A[e] * sbv;
  }
  __syncthreads();
  // d loss / d q_mu = -(A alpha - q_mu)
  for (int e = tid; e < m * C; e += nt) {
    const int a = e / C, c = e % C;
    T s = T(0);
    for (int i = 0; i < nb; ++i) s += w.A[a * nb + i] * w.alpha[c * nb + i];
    w.gqmu[e] += weight * -(s - qmu[e]);
  }
  // d loss / d q_raw: strict lower triangle direct, diagonal through exp
  for (long e = tid; e < (long)C * m * m; e += nt) {
    const int c = (int)(e / ((long)m * m)), r = (int)(e % ((long)m * m));
    const int a = r / m, b = r % m;
    if (b > a) continue;
    const T* sa = w.SA + (long)c * m * nb;
    const T* bvc = w.bv + c * nb;
    T s = T(0);
    for (int i = 0; i < nb; ++i) s += w.A[a * nb + i] * sa[b * nb + i] * bvc[i];
    const T dqa = w.dq[c * m + a];
    T gl = T(2) * s - qL_at(qraw + (long)c * m * m, w.dq + c * m, m, a, b);
    if (a == b) gl = (gl + T(1) / dqa) * dqa;
    w.gqraw[e] += weight * -gl;
  }
  // Sg = Phi + Phi^T of T = G A^T (lower triangle of T, mirrored)
  for (int e = tid; e < m * m; e += nt) {
    const int a = e / m, b = e % m;
    if (b > a) continue;
    T s = T(0);
    for (int i = 0; i < nb; ++i) s += w.G[a * nb + i] * w.A[b * nb + i];
    w.Sg[a * m + b] = s;
    w.Sg[b * m + a] = s;
  }
  __syncthreads();
  trsm_u(w.U, w.G, m, nb);                                // G := Kms_b = Lk^-T G
  for (int e = tid; e < m * m; e += nt) {                 // W := V Sg
    const int a = e / m, b = e % m;
    T s = T(0);
    for (int k = a; k < m; ++k) s += w.V[a * m + k] * w.Sg[k * m + b];
    w.W[e] = s;
  }
  __syncthreads();
  for (int e = tid; e < m * m; e += nt) {                 // Kmm_b = -(V Sg V^T) / 2
    const int a = e / m, b = e % m;
    if (b > a) continue;
    T s = T(0);
    for (int k = b; k < m; ++k) s += w.W[a * m + k] * w.V[b * m + k];
    w.Kmmb[a * m + b] = T(-0.5) * s;
    w.Kmmb[b * m + a] = T(-0.5) * s;
  }
  __syncthreads();

  // chain rules: Pmm = Kmm_b o Kmm, Pms = Kms_b o Kms
  T p_os = T(0), p_dk = T(0), p_bv = T(0);
  for (int a = tid; a < m; a += nt) {
    T rs = T(0), rn = T(0);
    for (int b = 0; b < m; ++b) rs += w.Kmmb[a * m + b] * w.Kmm[a * m + b];
    for (int i = 0; i < nb; ++i) rn += w.G[a * nb + i] * w.Kms[a * nb + i];
    w.rs_mm[a] = rs;
    w.rs_ms[a] = rn;
    p_os += rs + rn;
    p_dk += w.Kmmb[a * m + a];
  }
  for (int i = tid; i < nb; i += nt) {
    T cs = T(0);
    for (int a = 0; a < m; ++a) cs += w.G[a * nb + i] * w.Kms[a * nb + i];
    w.cs_ms[i] = cs;
  }
  for (int e = tid; e < C * nb; e += nt) p_bv += w.bv[e];
  for (int e = tid; e < m * d; e += nt) {
    const int a = e / d, k = e % d;
    T s = T(0), t = T(0);
    for (int b = 0; b < m; ++b) s += w.Kmmb[a * m + b] * w.Kmm[a * m + b] * w.Zs[b * d + k];
    for (int i = 0; i < nb; ++i) t += w.G[a * nb + i] * w.Kms[a * nb + i] * w.Xs[i * d + k];
    w.PmmZs[e] = s;
    w.PmsXs[e] = t;
  }
  const T S_os = block_sum(p_os, sh.red), tr_dK = block_sum(p_dk, sh.red);
  const T S_bv = block_sum(p_bv, sh.red);                 // its barriers publish the above
  for (int k = tid; k < d; k += nt) {
    T t = T(0);
    for (int a = 0; a < m; ++a) {
      const T zs = w.Zs[a * d + k];
      t += (T(2) * w.rs_mm[a] + w.rs_ms[a]) * zs * zs
           - T(2) * zs * (w.PmmZs[a * d + k] + w.PmsXs[a * d + k]);
    }
    for (int i = 0; i < nb; ++i) t += w.cs_ms[i] * w.Xs[i * d + k] * w.Xs[i * d + k];
    sh.g[k] = -t;
  }
  for (int e = tid; e < m * d; e += nt) {
    const int a = e / d, k = e % d;
    const T zs = w.Zs[e];
    const T dzs = T(-2) * (w.rs_mm[a] * zs - w.PmmZs[e]) - (w.rs_ms[a] * zs - w.PmsXs[e]);
    w.gZ[e] += weight * -(dzs * il[k]);
  }
  if (tid == 0) {
    const T g_os = S_os + jitter * sf2 * (sf2 > T(1) ? T(1) : T(0)) * tr_dK + S_bv * sf2;
    sh.g[d] = -g_os;
    if (lik == L_GAUSS) sh.g[d + 1] = -g_noise;
    sh.loss = -(scale * ve_sum - klq);
  }
  __syncthreads();
}

}  // namespace ggp
