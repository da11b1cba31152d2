// Kernel 1: one evaluation of the collapsed-bound potential and its
// gradient (and, on request, the inducing-location gradient) for each of
// gridDim.x hyper rows, one row per block.
//
// Replaces: ggp_tpu/ops/fused_nuts.py `_potential_kernel_body` (the
// `pot_call` pallas_call of `make_fused_nuts`; entry ggp_vfe_potential_*,
// grid 1), which serves the sampler's initial U/g and
// `find_reasonable_step_size`; and ggp_tpu/ops/fused_multichain.py
// `_mc_potential_body` (the `pot_call` of `make_fused_hmc_multichain`,
// "vfe" core; entry ggp_mc_potential_*, grid C), which serves the C-chain
// initial U/g and the batched step-size search.
//
// What bounds it on the card and what the design does about it: see
// vfe_bound.cuh; each block runs that device function once on its own row
// and its own scratch area, so a call's time is one bound's latency chain
// (barriers and L2 reads), not bandwidth or FLOPs, as long as the C blocks
// fit on the 132 SMs and their scratch areas in L2.
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
  const int c = blockIdx.x;                            // this block's row
  theta += c * dim;
  out += c * (dim + 1);
  if (dZ != nullptr) dZ += (long)c * cf.m * cf.d;
  if ((int)threadIdx.x < dim) s_theta[threadIdx.x] = theta[threadIdx.x];
  __syncthreads();
  const Work<T> w = make_work(scratch + (long)c * work_elems(cf.n, cf.m, cf.d),
                              cf.n, cf.m, cf.d);
  vfe_bound(cf, s_theta, X, y, Z, w, sh, &s_U, s_g, dZ);
  if (threadIdx.x == 0) out[0] = s_U;
  if ((int)threadIdx.x < dim) out[1 + threadIdx.x] = s_g[threadIdx.x];
}

template <typename T>
int launch_potential(int rows, const double* cfg, const void* theta,
                     const void* X, const void* y, const void* Z, void* out,
                     void* dZ, void* scratch, void* stream) {
  const BoundCfg cf = bound_cfg(cfg);
  vfe_potential_kernel<T><<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      cf, (const T*)theta, (const T*)X, (const T*)y, (const T*)Z, (T*)out,
      (T*)dZ, (T*)scratch);
  return (int)cudaGetLastError();
}

}  // namespace ggp

#define GGP_POT_ARGS                                                         \
  const double *cfg, const void *theta, const void *X, const void *y,        \
      const void *Z, void *out, void *dZ, void *scratch, void *stream
#define GGP_POT_PASS cfg, theta, X, y, Z, out, dZ, scratch, stream

extern "C" {

long ggp_scratch_elems(int n, int m, int d) { return ggp::work_elems(n, m, d); }

// one row (grid 1)
int ggp_vfe_potential_f32(GGP_POT_ARGS) { return ggp::launch_potential<float>(1, GGP_POT_PASS); }
int ggp_vfe_potential_f64(GGP_POT_ARGS) { return ggp::launch_potential<double>(1, GGP_POT_PASS); }
// cfg[C_CHAINS] rows, one block each
int ggp_mc_potential_f32(GGP_POT_ARGS) {
  return ggp::launch_potential<float>((int)cfg[ggp::C_CHAINS], GGP_POT_PASS);
}
int ggp_mc_potential_f64(GGP_POT_ARGS) {
  return ggp::launch_potential<double>((int)cfg[ggp::C_CHAINS], GGP_POT_PASS);
}

}  // extern "C"
