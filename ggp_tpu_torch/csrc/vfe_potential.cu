// Kernel 1: one evaluation of the collapsed-bound potential and its
// gradient (and, on request, the inducing-location gradient).
//
// Replaces: ggp_tpu/ops/fused_nuts.py `_potential_kernel_body` (the
// `pot_call` pallas_call of `make_fused_nuts`), which serves the sampler's
// initial U/g and `find_reasonable_step_size`.
//
// What bounds it on the card and what the design does about it: see
// vfe_bound.cuh; this kernel is one block running that device function
// once, so its time is the bound's latency chain (barriers and L2 reads),
// not bandwidth or FLOPs.
#include "vfe_bound.cuh"

namespace ggp {

template <typename T>
__global__ void __launch_bounds__(kThreads)
vfe_potential_kernel(BoundCfg cf, const T* theta, const T* X, const T* y,
                     const T* Z, T* out, T* dZ, T* scratch) {
  __shared__ BoundShared<T> sh;
  __shared__ T s_theta[kMaxDim];
  __shared__ T s_g[kMaxDim];
  __shared__ T s_U;
  const int dim = cf.d + 2;
  if ((int)threadIdx.x < dim) s_theta[threadIdx.x] = theta[threadIdx.x];
  __syncthreads();
  const Work<T> w = make_work(scratch, cf.n, cf.m, cf.d);
  vfe_bound(cf, s_theta, X, y, Z, w, sh, &s_U, s_g, dZ);
  if (threadIdx.x == 0) out[0] = s_U;
  if ((int)threadIdx.x < dim) out[1 + threadIdx.x] = s_g[threadIdx.x];
}

template <typename T>
int launch_potential(const double* cfg, const void* theta, const void* X,
                     const void* y, const void* Z, void* out, void* dZ,
                     void* scratch, void* stream) {
  const BoundCfg cf = bound_cfg(cfg);
  vfe_potential_kernel<T><<<1, kThreads, 0, (cudaStream_t)stream>>>(
      cf, (const T*)theta, (const T*)X, (const T*)y, (const T*)Z, (T*)out,
      (T*)dZ, (T*)scratch);
  return (int)cudaGetLastError();
}

}  // namespace ggp

extern "C" {

long ggp_scratch_elems(int n, int m, int d) { return ggp::work_elems(n, m, d); }

int ggp_vfe_potential_f32(const double* cfg, const void* theta, const void* X,
                          const void* y, const void* Z, void* out, void* dZ,
                          void* scratch, void* stream) {
  return ggp::launch_potential<float>(cfg, theta, X, y, Z, out, dZ, scratch, stream);
}

int ggp_vfe_potential_f64(const double* cfg, const void* theta, const void* X,
                          const void* y, const void* Z, void* out, void* dZ,
                          void* scratch, void* stream) {
  return ggp::launch_potential<double>(cfg, theta, X, y, Z, out, dZ, scratch, stream);
}

}  // extern "C"
