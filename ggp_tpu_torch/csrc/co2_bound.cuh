// Collapsed VFE bound of the Mauna Loa CO2 composite target: value and
// analytic gradient over its 11 log-hypers in one block-wide device
// function, the potential core `Co2M32Core` / `Co2RbfCore` of the sampler
// kernels (vfe_potential.cu, nuts_chunk.cu).
//
// Replaces: ggp_tpu/ops/fused_bound.py `_co2_vfe_neg_logpost_vg`, the core
// the fused Pallas sampler kernels inline for target="co2_m32" /
// "co2_rbf" (ggp_tpu/ops/fused_nuts.py `_CORES`). The kernel is the 1-D Sum
//
//   K = s1 Periodic(p=1, lp) RBF(ld) + s2 RBF(lt) + s3 RQ(lm, alpha)
//       + s4 Matern32(ln)   [or s4 RBF(ln)]
//
// over lanes [log lp, log ld, log s1, log lt, log s2, log alpha, log lm,
// log s3, log ln, log s4, log noise] (ravel order of
// kernels/composite.py co2_kernel's tree; every s_i a log-variance).
//
// What bounds it on the card and what the design does about it: the
// factorisations, solves and adjoints dF/dKnm, dF/dKmm are the collapsed
// bound's own (collapsed_bound, vfe_bound.cuh), one block walking a chain
// of O(N M^2) products and two M x M factorisations through the global
// scratch. Only the gram synthesis and the ten kernel-hyper contractions
// sum(Kbar o dK/dtheta_i) differ, both elementwise in the pairwise
// difference delta = x - z, formed directly (no norm expansion and so no
// lengthscale cap: a huge inverse lengthscale underflows exp to zeros).
// The components are recomputed from delta in the contraction pass rather
// than kept: four more n x m arrays would cost more L2 traffic than the
// arithmetic. sin takes arguments up to pi * 45 on the CO2 axis, so the
// full-range sinf / sin are used, never the fast intrinsics. The
// contractions sum over pairs in double for both types, as the vfe core
// does its row sums.
#pragma once

#include "vfe_bound.cuh"

namespace ggp {

// Threads of the co2 cores' block: at M=480 twice the warps of kThreads hide
// more of the latency of the products' chunk loads, and 512 threads leave
// each 128 registers (the co2 potential kernel uses 128 in double).
constexpr int kCo2Threads = 512;

__device__ __forceinline__ float gsin(float x) { return sinf(x); }
__device__ __forceinline__ double gsin(double x) { return sin(x); }

// The kernel hypers in the form the grams read them.
template <typename T>
struct Co2Hypers {
  T ilp2, ild2, s1, ilt2, s2v, al, ilm2, s3, iln, s4;
};

// Component grams and the elementwise factors the contractions share, at
// one pair.
template <typename T>
struct Co2Pair {
  T K1, K2, K3, K4, r2, sin2, q, lnB, d4;
};

template <typename T, bool M32>
__device__ __forceinline__ Co2Pair<T> co2_pair(const Co2Hypers<T>& h, T delta) {
  Co2Pair<T> p;
  p.r2 = delta * delta;
  const T sn = gsin(T(3.141592653589793) * delta);
  p.sin2 = sn * sn;
  p.K1 = h.s1 * gexp(T(-2) * p.sin2 * h.ilp2 - T(0.5) * p.r2 * h.ild2);
  p.K2 = h.s2v * gexp(T(-0.5) * p.r2 * h.ilt2);
  p.q = p.r2 * h.ilm2 / (T(2) * h.al);
  p.lnB = glog1p(p.q);
  p.K3 = h.s3 * gexp(-h.al * p.lnB);
  if (M32) {
    const T t = gsqrt(T(3)) * gabs(delta) * h.iln;
    const T e = gexp(-t);
    p.K4 = h.s4 * (T(1) + t) * e;
    p.d4 = h.s4 * t * t * e;                       // dK4 / dlog ln
  } else {
    p.K4 = h.s4 * gexp(T(-0.5) * p.r2 * h.iln * h.iln);
    p.d4 = p.K4 * p.r2 * h.iln * h.iln;
  }
  return p;
}

// acc[i] += kbar * dK/dtheta_i at one pair, lanes 0..9.
template <typename T>
__device__ __forceinline__ void co2_contract(const Co2Hypers<T>& h, T kbar,
                                             const Co2Pair<T>& p, double* acc) {
  const T Bq = T(1) + p.q;
  acc[0] += double(kbar * p.K1 * T(4) * p.sin2 * h.ilp2);           // log lp
  acc[1] += double(kbar * p.K1 * p.r2 * h.ild2);                    // log ld
  acc[2] += double(kbar * p.K1);                                    // log s1
  acc[3] += double(kbar * p.K2 * p.r2 * h.ilt2);                    // log lt
  acc[4] += double(kbar * p.K2);                                    // log s2
  acc[5] += double(kbar * p.K3 * (-h.al * p.lnB + h.al * p.q / Bq));  // log alpha
  acc[6] += double(kbar * p.K3 * T(2) * h.al * p.q / Bq);           // log lm
  acc[7] += double(kbar * p.K3);                                    // log s3
  acc[8] += double(kbar * p.d4);                                    // log ln
  acc[9] += double(kbar * p.K4);                                    // log s4
}

// U_out = -(ELBO [+ log prior]) and g_out = dU/dtheta (11 lanes) at the
// state row th (visible to all threads on entry). Outputs are visible to
// all threads on return; U_out is written by thread 0.
template <typename T, bool M32>
__device__ void co2_bound(const BoundCfg& cf, const T* th, const T* X, const T* y,
                          const T* Z, const Work<T>& w, BoundShared<T>& sh, T* U_out,
                          T* g_out) {
  __shared__ double red_d[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = cf.n, m = cf.m;
  const T jitter = T(cf.jitter);
  Co2Hypers<T> h;
  h.ilp2 = gexp(T(-2) * th[0]);
  h.ild2 = gexp(T(-2) * th[1]);
  h.s1 = gexp(th[2]);
  h.ilt2 = gexp(T(-2) * th[3]);
  h.s2v = gexp(th[4]);
  h.al = gexp(th[5]);
  h.ilm2 = gexp(T(-2) * th[6]);
  h.s3 = gexp(th[7]);
  h.iln = gexp(-th[8]);
  h.s4 = gexp(th[9]);
  const T s2 = gexp(th[10]);                          // noise variance
  const T svar = h.s1 + h.s2v + h.s3 + h.s4;          // the mean diagonal
  const T jit_scale = jmax(svar, T(1));

  // grams from the pairwise differences; W = Kmm + relative jitter
  for (int idx = tid; idx < n * m; idx += nt) {
    const Co2Pair<T> p = co2_pair<T, M32>(h, X[idx / m] - Z[idx % m]);
    w.Knm[idx] = p.K1 + p.K2 + p.K3 + p.K4;
  }
  for (int idx = tid; idx < m * m; idx += nt) {
    const int a = idx / m, b = idx % m;
    const Co2Pair<T> p = co2_pair<T, M32>(h, Z[a] - Z[b]);
    const T kab = p.K1 + p.K2 + p.K3 + p.K4;
    w.Kmm[idx] = kab;
    w.W[idx] = kab + (a == b ? jitter * jit_scale : T(0));
  }
  __syncthreads();

  const Collapsed<T> cb =
      collapsed_bound<double, 64, 64, 32, kCo2Threads>(cf, y, w, sh, s2, T(n) * svar,
                                                       jit_scale, false);

  // the ten kernel-hyper contractions over the nm and mm pairs
  double acc[10];
  for (int l = 0; l < 10; ++l) acc[l] = 0.0;
  for (int idx = tid; idx < n * m; idx += nt)
    co2_contract(h, w.Pnm[idx], co2_pair<T, M32>(h, X[idx / m] - Z[idx % m]), acc);
  for (int idx = tid; idx < m * m; idx += nt)
    co2_contract(h, w.Pmm[idx], co2_pair<T, M32>(h, Z[idx / m] - Z[idx % m]), acc);
  double gk[10];
  for (int l = 0; l < 10; ++l) gk[l] = block_sum(acc[l], red_d);

  // the variance lanes also see the relative-jitter scale and the kdiag
  // trace term; the noise lane is the bound's own
  const T nT = T(n), mT = T(m);
  const T jit_gate = jitter * (svar > T(1) ? T(1) : T(0)) * cb.tr_dK;
  const T tail = jit_gate - nT / (T(2) * s2);
  const T trW = (nT - mT + cb.trBinv) / s2;
  const T dF_ds2 = T(0.5) * cb.aa - T(0.5) * trW + cb.t_term / (T(2) * s2 * s2);
  if (int k = tid; k < 11) {
    T gi;
    if (k == 10) {
      gi = dF_ds2 * s2;
    } else {
      gi = T(gk[k]);
      if (k == 2) gi += h.s1 * tail;
      if (k == 4) gi += h.s2v * tail;
      if (k == 7) gi += h.s3 * tail;
      if (k == 9) gi += h.s4 * tail;
    }
    if (cf.want_prior) {
      T lp, gp;
      prior_leaf(cf.lane[k], th[k], &lp, &gp);
      gi += gp;
    }
    g_out[k] = -gi;
  }
  if (tid == 0) {
    T lp_sum = T(0);
    if (cf.want_prior) {
      for (int k = 0; k < 11; ++k) {
        T lp, gp;
        prior_leaf(cf.lane[k], th[k], &lp, &gp);
        lp_sum += lp;
      }
    }
    *U_out = -(cb.F + lp_sum);
  }
  __syncthreads();
}

// The co2 potential cores (the `Core` template parameter of the sampler
// kernels, interface of VfeCore): 11 lanes, the collapsed bound's scratch at
// d = 1; no inducing-location gradient.
template <typename T, bool M32>
struct Co2Core {
  using WorkT = Work<T>;
  static __host__ __device__ int dim(const BoundCfg&) { return 11; }
  static __host__ __device__ long elems(const BoundCfg& cf) {
    return work_elems(cf.n, cf.m, 1);
  }
  static __device__ WorkT work(T* s, const BoundCfg& cf) {
    return make_work(s, cf.n, cf.m, 1);
  }
  static __device__ void eval(const BoundCfg& cf, const T* z, const T* X, const T* y,
                              const T* Z, const WorkT& w, BoundShared<T>& sh, T* U, T* g,
                              T* /*dZ*/) {
    co2_bound<T, M32>(cf, z, X, y, Z, w, sh, U, g);
  }
};

// noise component Matern32 (the experiment's) and RBF
template <typename T>
struct Co2M32Core : Co2Core<T, true> {};
template <typename T>
struct Co2RbfCore : Co2Core<T, false> {};

template <>
struct CoreThreads<Co2M32Core> {
  static constexpr int value = kCo2Threads;
};
template <>
struct CoreThreads<Co2RbfCore> {
  static constexpr int value = kCo2Threads;
};
// 11 lanes: the NUTS kernels' tree state fits in a few KB, which leaves
// shared memory to the tiled products of collapsed_bound.
template <>
struct CoreDim<Co2M32Core> {
  static constexpr int value = 16;
};
template <>
struct CoreDim<Co2RbfCore> {
  static constexpr int value = 16;
};

}  // namespace ggp
