// The trainers' shared pieces: the cfg entries of a chunk of Adam steps and
// the optax Adam update, used by sgpr_adam.cu (the collapsed bound's
// trainers) and sgpmc_warm.cu (the JointHMC warm start).
//
// Replaces: ggp_tpu/ops/fused_svi.py `_adam_update`, which every fused
// trainer of the JAX package inlines.
#pragma once

#include "vfe_bound.cuh"

namespace ggp {

struct TrainCfg {
  int K, s_act;
  double lr, clip, min_noise, t0;
};

inline TrainCfg train_cfg(const double* cfg) {
  TrainCfg tc;
  tc.K = (int)cfg[C_K];
  tc.s_act = (int)cfg[C_S_ACT];
  tc.lr = cfg[C_LR];
  tc.clip = cfg[C_CLIP];
  tc.min_noise = cfg[C_MIN_NOISE];
  tc.t0 = cfg[C_T0];
  return tc;
}

// optax.adam defaults (b1=0.9, b2=0.999, eps=1e-8, eps_root=0) with
// non-finite gradient entries zeroed first (zero_nans extended to inf).
template <typename T>
__device__ __forceinline__ void adam_update(T& p, T g, T& mm, T& vv, T ta, T lr) {
  if (!(gabs(g) <= T(3.0e38))) g = T(0);
  mm = T(0.9) * mm + (T(1) - T(0.9)) * g;
  vv = T(0.999) * vv + (T(1) - T(0.999)) * g * g;
  const T bc1 = T(1) - gexp(ta * glog(T(0.9)));
  const T bc2 = T(1) - gexp(ta * glog(T(0.999)));
  p = p - lr * (mm / bc1) / (gsqrt(vv / bc2) + T(1e-8));
}

}  // namespace ggp
