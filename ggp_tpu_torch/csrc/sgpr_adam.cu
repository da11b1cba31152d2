// Kernels 3 and 4: whole chunks of Adam steps on the collapsed bound.
//
// Kernel 3, `sgpr_adam_chunk_kernel`, replaces ggp_tpu/ops/fused_sgpr.py
// `_sgpr_chunk_body` (the resident pallas_call of `make_fused_sgpr`): K
// full-batch Adam steps on (theta, Z) of -ELBO (no prior), with the
// per-element non-finite mask, clip-by-global-norm over (theta, Z), the
// optax Adam update (bias correction continues from t0), the +-15 box on
// the log-hypers and the noise floor. BayesianSGPR_HMC's warm start runs it
// with clip 10.
//
// Kernel 4, `z_adam_chunk_kernel`, replaces `_zadam_chunk_body` (the
// resident pallas_call of `make_fused_z_adam`): k_act Adam steps on Z only,
// each step averaging -ELBO(theta_s, Z) and its Z-gradient over the s_act
// rows of the current hyper trace. No clip and no box.
//
// Both use the trainers' pivot policy (modified Cholesky, floor 1e-6
// relative to max(sf2, 1) on Kmm and 1e-6 on B), so a transiently
// indefinite factorisation cannot poison the Adam state.
//
// What bounds them on the card: each step is one (kernel 3) or s_act
// (kernel 4) sequential evaluations of the bound, a latency chain of block
// barriers and L2 reads (vfe_bound.cuh); the Adam update is O((m + 1) d).
// What the design does about it: the whole chunk is one launch with the
// parameters and moments updated in place in global memory, so there is
// no host round trip per step.
#include "adam.cuh"

namespace ggp {

template <typename T>
__global__ void __launch_bounds__(kThreads)
sgpr_adam_chunk_kernel(BoundCfg cf, TrainCfg tc, T* theta, T* Z, T* m_th,
                       T* v_th, T* m_z, T* v_z, const T* X, const T* y,
                       T* losses, T* scratch) {
  __shared__ BoundShared<T> sh;
  __shared__ T s_theta[kMaxDim];
  __shared__ T s_g[kMaxDim];
  __shared__ T s_U;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int d = cf.d, dim = d + 2, md = cf.m * d;
  const Work<T> w = make_work(scratch, cf.n, cf.m, d);
  T* dZ = scratch + work_elems(cf.n, cf.m, d);
  const T lr = T(tc.lr), log_floor = glog(T(tc.min_noise));
  if (tid < dim) s_theta[tid] = theta[tid];
  __syncthreads();

  for (int t = 0; t < tc.K; ++t) {
    vfe_bound(cf, s_theta, X, y, Z, w, sh, &s_U, s_g, dZ);
    // global norm over (theta, Z) of the masked gradient
    T part = T(0);
    for (int idx = tid; idx < md; idx += nt) {
      const T gz = dZ[idx];
      if (gabs(gz) <= T(3.0e38)) part += gz * gz;
    }
    T gn2 = block_sum(part, sh.red);
    for (int k = 0; k < dim; ++k) {
      const T gk = s_g[k];
      if (gabs(gk) <= T(3.0e38)) gn2 += gk * gk;
    }
    const T sc = jmin(T(1), T(tc.clip) / gsqrt(gn2));
    const T ta = T(tc.t0) + T(t) + T(1);
    if (tid < dim) {
      T gk = s_g[tid];
      gk = (gabs(gk) <= T(3.0e38) ? gk : T(0)) * sc;
      T p = s_theta[tid], mm = m_th[tid], vv = v_th[tid];
      adam_update(p, gk, mm, vv, ta, lr);
      p = jmin(jmax(p, T(-15)), T(15));
      if (tid == d + 1) p = jmax(p, log_floor);
      s_theta[tid] = p;
      m_th[tid] = mm;
      v_th[tid] = vv;
    }
    for (int idx = tid; idx < md; idx += nt) {
      T gz = dZ[idx];
      gz = (gabs(gz) <= T(3.0e38) ? gz : T(0)) * sc;
      T p = Z[idx], mm = m_z[idx], vv = v_z[idx];
      adam_update(p, gz, mm, vv, ta, lr);
      Z[idx] = p;
      m_z[idx] = mm;
      v_z[idx] = vv;
    }
    if (tid == 0) losses[t] = s_U;
    __syncthreads();
  }
  if (tid < dim) theta[tid] = s_theta[tid];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
z_adam_chunk_kernel(BoundCfg cf, TrainCfg tc, const T* thetas, T* Z, T* m_z,
                    T* v_z, const T* X, const T* y, T* losses, T* scratch) {
  __shared__ BoundShared<T> sh;
  __shared__ T s_theta[kMaxDim];
  __shared__ T s_g[kMaxDim];
  __shared__ T s_U;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int d = cf.d, dim = d + 2, md = cf.m * d;
  const Work<T> w = make_work(scratch, cf.n, cf.m, d);
  T* dZ = scratch + work_elems(cf.n, cf.m, d);
  T* gacc = dZ + md;
  const T lr = T(tc.lr), inv_s = T(1) / T(tc.s_act);

  for (int t = 0; t < tc.K; ++t) {
    for (int idx = tid; idx < md; idx += nt) gacc[idx] = T(0);
    T lacc = T(0);
    for (int s = 0; s < tc.s_act; ++s) {
      if (tid < dim) s_theta[tid] = thetas[s * dim + tid];
      __syncthreads();
      vfe_bound(cf, s_theta, X, y, Z, w, sh, &s_U, s_g, dZ);
      lacc = lacc + inv_s * s_U;
      for (int idx = tid; idx < md; idx += nt) gacc[idx] = gacc[idx] + inv_s * dZ[idx];
      __syncthreads();
    }
    const T ta = T(tc.t0) + T(t) + T(1);
    for (int idx = tid; idx < md; idx += nt) {
      T p = Z[idx], mm = m_z[idx], vv = v_z[idx];
      adam_update(p, gacc[idx], mm, vv, ta, lr);
      Z[idx] = p;
      m_z[idx] = mm;
      v_z[idx] = vv;
    }
    if (tid == 0) losses[t] = lacc;
    __syncthreads();
  }
}

template <typename T>
int launch_sgpr_adam(const double* cfg, void* theta, void* Z, void* m_th,
                     void* v_th, void* m_z, void* v_z, const void* X,
                     const void* y, void* losses, void* scratch, void* stream) {
  sgpr_adam_chunk_kernel<T><<<1, kThreads, 0, (cudaStream_t)stream>>>(
      bound_cfg(cfg), train_cfg(cfg), (T*)theta, (T*)Z, (T*)m_th, (T*)v_th,
      (T*)m_z, (T*)v_z, (const T*)X, (const T*)y, (T*)losses, (T*)scratch);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_z_adam(const double* cfg, const void* thetas, void* Z, void* m_z,
                  void* v_z, const void* X, const void* y, void* losses,
                  void* scratch, void* stream) {
  z_adam_chunk_kernel<T><<<1, kThreads, 0, (cudaStream_t)stream>>>(
      bound_cfg(cfg), train_cfg(cfg), (const T*)thetas, (T*)Z, (T*)m_z,
      (T*)v_z, (const T*)X, (const T*)y, (T*)losses, (T*)scratch);
  return (int)cudaGetLastError();
}

}  // namespace ggp

extern "C" {

int ggp_sgpr_adam_f32(const double* cfg, void* theta, void* Z, void* m_th,
                      void* v_th, void* m_z, void* v_z, const void* X,
                      const void* y, void* losses, void* scratch, void* stream) {
  return ggp::launch_sgpr_adam<float>(cfg, theta, Z, m_th, v_th, m_z, v_z, X, y,
                                      losses, scratch, stream);
}

int ggp_sgpr_adam_f64(const double* cfg, void* theta, void* Z, void* m_th,
                      void* v_th, void* m_z, void* v_z, const void* X,
                      const void* y, void* losses, void* scratch, void* stream) {
  return ggp::launch_sgpr_adam<double>(cfg, theta, Z, m_th, v_th, m_z, v_z, X, y,
                                       losses, scratch, stream);
}

int ggp_z_adam_f32(const double* cfg, const void* thetas, void* Z, void* m_z,
                   void* v_z, const void* X, const void* y, void* losses,
                   void* scratch, void* stream) {
  return ggp::launch_z_adam<float>(cfg, thetas, Z, m_z, v_z, X, y, losses,
                                   scratch, stream);
}

int ggp_z_adam_f64(const double* cfg, const void* thetas, void* Z, void* m_z,
                   void* v_z, const void* X, const void* y, void* losses,
                   void* scratch, void* stream) {
  return ggp::launch_z_adam<double>(cfg, thetas, Z, m_z, v_z, X, y, losses,
                                    scratch, stream);
}

}  // extern "C"
