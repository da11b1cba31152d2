// Chain-state helpers shared by the sampler kernels (nuts_chunk.cu,
// mc_hmc_chunk.cu): the layout of the per-chain scalar state, small
// dim-length vector operations, and Stan's warmup adaptation after one
// transition.
//
// Replaces: the adaptation block of ggp_tpu/ops/fused_nuts.py
// `_warm_chunk_kernel_body` (`_da_update_scalars` plus the Welford window)
// and its chain-batched form ggp_tpu/ops/fused_multichain.py
// `_stan_adapt_rows` / `_da_update_rows`, both mirroring
// ggp_tpu/inference/hmc.py `da_update` and `welford_*`.
#pragma once

#include "sgpmc_bound.cuh"

namespace ggp {

// Per-chain scalar state, one row of S_LEN values per chain (mirrored by
// ggp_tpu_torch/ops/nuts_chunk.py and ops/multichain.py).
enum StateIndex {
  S_U = 0, S_LE, S_LEA, S_H, S_MU, S_TDA, S_WFC, S_NACT, S_EPS, S_ACC, S_DIV, S_LEN
};

// One thread per entry of a state row: kThreads >= kMaxDim (static_assert in
// vfe_bound.cuh), so thread k covers entry k of a row of any length up to
// kMaxDim. (A loop strided over the block costs the f32 chunk kernels
// registers they spill inside the core, ~20 % of NUTS time.)
template <typename T>
__device__ __forceinline__ void vcopy(T* dst, const T* src, int dim) {
  if (int k = threadIdx.x; k < dim) dst[k] = src[k];
}

// 0.5 r^T diag(im) r; every thread sums in the same order, so every thread
// gets the same bits.
template <typename T>
__device__ T kinetic(const T* im, const T* r, int dim) {
  T s = T(0);
  for (int k = 0; k < dim; ++k) s += im[k] * r[k] * r[k];
  return T(0.5) * s;
}

// Dual-averaging state and the Welford count that lives with it.
template <typename T>
struct Adapt {
  T le, lea, h, mu, tda, wfc;
};

template <typename T>
__device__ __forceinline__ Adapt<T> load_adapt(const T* state) {
  return Adapt<T>{state[S_LE], state[S_LEA], state[S_H], state[S_MU],
                  state[S_TDA], state[S_WFC]};
}

// One adaptation step after a transition that accepted `accept` and left
// the chain at zp: dual averaging of log eps, and with adapt_mass the
// Welford window (in_w: add zp; w_end: new inverse mass from the window,
// fresh window, dual averaging restarted at the current eps). Every thread
// calls it with the same scalars and gets the same `a`; thread k < dim
// updates entry k of im, wm and wm2 from zp[k]. No barrier inside: the
// caller synchronises before any thread reads another's entry.
template <typename T>
__device__ void stan_adapt(Adapt<T>& a, T accept, T target, bool adapt_mass,
                           bool in_w, bool w_end, const T* zp, T* im, T* wm,
                           T* wm2, int dim) {
  const T t1 = a.tda + T(1);
  const T h1 = (T(1) - T(1) / (t1 + T(10))) * a.h + (target - accept) / (t1 + T(10));
  const T le1 = a.mu - gsqrt(t1) / T(0.05) * h1;
  const T wgt = gexp(T(-0.75) * glog(t1));
  T lea1 = wgt * le1 + (T(1) - wgt) * a.lea;
  T mu1 = a.mu, hh = h1, tda1 = t1;
  if (adapt_mass) {
    const T cnt1 = a.wfc + T(1);
    T wfc1 = in_w ? cnt1 : a.wfc;
    if (int k = threadIdx.x; k < dim) {
      const T z = zp[k];
      const T delta = z - wm[k];
      const T mean1 = wm[k] + delta / cnt1;
      const T m21 = wm2[k] + delta * (z - mean1);
      T wm1 = in_w ? mean1 : wm[k];
      T wm21 = in_w ? m21 : wm2[k];
      if (w_end) {
        T var = wm21 / jmax(wfc1 - T(1), T(1));
        var = (wfc1 / (wfc1 + T(5))) * var + T(1e-3) * (T(5) / (wfc1 + T(5)));
        im[k] = var;
        wm1 = T(0);
        wm21 = T(0);
      }
      wm[k] = wm1;
      wm2[k] = wm21;
    }
    if (w_end) {
      wfc1 = T(0);
      lea1 = le1;
      mu1 = glog(T(10)) + le1;
      hh = T(0);
      tda1 = T(0);
    }
    a.wfc = wfc1;
  }
  a.le = le1;
  a.lea = lea1;
  a.h = hh;
  a.mu = mu1;
  a.tda = tda1;
}

template <typename T>
__device__ __forceinline__ void store_state(T* state, const Adapt<T>& a, T U,
                                            T acc_sum, T div_sum) {
  state[S_U] = U;
  state[S_LE] = a.le;
  state[S_LEA] = a.lea;
  state[S_H] = a.h;
  state[S_MU] = a.mu;
  state[S_TDA] = a.tda;
  state[S_WFC] = a.wfc;
  state[S_ACC] = acc_sum;
  state[S_DIV] = div_sum;
}

}  // namespace ggp
