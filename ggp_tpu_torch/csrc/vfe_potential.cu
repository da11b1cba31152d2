// Kernel 1: one evaluation of a sampler potential and its gradient (and,
// on request, the inducing-location gradient) for each of gridDim.x =
// cfg[C_CHAINS] state rows, one row per block. The potential is the
// template parameter `Core`: the collapsed bound (VfeCore, vfe_bound.cuh),
// the whitened JointHMC target (SgpmcCore, sgpmc_bound.cuh) or the dense
// GP marginal (GprGroupCore, gpr_bound.cuh).
//
// Replaces: ggp_tpu/ops/fused_nuts.py `_potential_kernel_body` (the
// `pot_call` pallas_call of `make_fused_nuts`, grid 1), which serves the
// sampler's initial U/g and `find_reasonable_step_size`; and
// ggp_tpu/ops/fused_multichain.py `_mc_potential_body` (the `pot_call` of
// `make_fused_hmc_multichain`, grid C), which serves the C-chain initial
// U/g and the batched step-size search; each for targets "vfe" and
// "sgpmc" (entries ggp_potential_{vfe,sgpmc}_{f32,f64}); and the same
// single-row call with target="gpr" (ggp_potential_gpr_{f32,f64}), which
// the port also runs at grid C for C chains of GPR_HMC (the JAX package
// samples those with its XLA sampler); and the single-row call with
// target="co2_m32" / "co2_rbf" (ggp_potential_co2_{m32,rbf}_{f32,f64}), the
// Mauna Loa CO2 composite (co2_bound.cuh).
//
// What bounds it on the card and what the design does about it: see
// vfe_bound.cuh, sgpmc_bound.cuh, gpr_bound.cuh and co2_bound.cuh; each block runs the
// core's device function once on its own row and its own scratch area (a
// grouped core, vfe_group.cuh or gpr_bound.cuh: G blocks per row, launched
// cooperatively), so a call's time is one evaluation's latency chain
// (barriers and L2 reads), not bandwidth or FLOPs, as long as the blocks
// fit on the 132 SMs and their scratch areas in L2.
#include "co2_bound.cuh"
#include "gpr_bound.cuh"
#include "sgpmc_bound.cuh"
#include "vfe_group.cuh"

namespace ggp {

template <template <typename> class Core, typename T>
__global__ void __launch_bounds__(CoreThreads<Core>::value)
potential_kernel(BoundCfg cf, const T* theta, const T* X, const T* y,
                 const T* Z, T* out, T* dZ, T* scratch) {
  __shared__ BoundShared<T> sh;
  __shared__ T s_theta[kMaxDim];
  __shared__ T s_g[kMaxDim];
  __shared__ T s_U;
  const int dim = Core<T>::dim(cf);
  const int G = CoreGroup<Core>::value ? cf.group : 1;   // blocks per row
  const int c = blockIdx.x / G;                          // this block's row
  const bool lead = blockIdx.x % G == 0;
  theta += c * dim;
  out += c * (dim + 1);
  if (dZ != nullptr) dZ += (long)c * cf.m * cf.d;
  if (int k = threadIdx.x; k < dim) s_theta[k] = theta[k];
  __syncthreads();
  const typename Core<T>::WorkT w = core_work<Core, T>(scratch, cf, X, Z, sh, c);
  Core<T>::eval(cf, s_theta, X, y, Z, w, sh, &s_U, s_g, dZ);
  if (!lead) return;
  if (threadIdx.x == 0) out[0] = s_U;
  if (int k = threadIdx.x; k < dim) out[1 + k] = s_g[k];
}

template <template <typename> class Core, typename T>
int launch_potential(const double* cfg, const void* theta, const void* X,
                     const void* y, const void* Z, void* out, void* dZ,
                     void* scratch, void* stream) {
  const BoundCfg cf = bound_cfg(cfg);
  const int grid = (int)cfg[C_CHAINS] * (CoreGroup<Core>::value ? cf.group : 1);
  return launch_grid<CoreGroup<Core>::value>(
      potential_kernel<Core, T>, grid, CoreThreads<Core>::value, stream, cf,
      (const T*)theta, (const T*)X, (const T*)y, (const T*)Z, (T*)out, (T*)dZ, (T*)scratch);
}

// Blocks of the grouped potential kernel of `Core` one SM holds at once,
// or a negative cudaError_t.
template <template <typename> class Core, typename T>
int potential_group_blocks_per_sm() {
  int nb = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, potential_kernel<Core, T>, CoreThreads<Core>::value, 0);
  return err == cudaSuccess ? nb : -(int)err;
}

}  // namespace ggp

#define GGP_POT_ARGS                                                         \
  const double *cfg, const void *theta, const void *X, const void *y,        \
      const void *Z, void *out, void *dZ, void *scratch, void *stream
#define GGP_POT_PASS cfg, theta, X, y, Z, out, dZ, scratch, stream

extern "C" {

// elements of one evaluation's scratch area of a one-block core; core 0 =
// vfe, 1 = sgpmc, 3 = co2_m32, 4 = co2_rbf (ggp_tpu_torch/ops/_build.py
// _CORE_ID; the grouped cores size theirs by ggp_group_scratch_elems and
// ggp_gpr_scratch_elems)
long ggp_scratch_elems(int core, int n, int m, int d) {
  if (core >= 3) return ggp::work_elems(n, m, 1);
  return core == 1 ? ggp::sgpmc_work_elems(n, m, d) : ggp::work_elems(n, m, d);
}

// cfg[C_CHAINS] rows, one block each
int ggp_potential_vfe_f32(GGP_POT_ARGS) {
  return ggp::launch_potential<ggp::VfeCore, float>(GGP_POT_PASS);
}
int ggp_potential_vfe_f64(GGP_POT_ARGS) {
  return ggp::launch_potential<ggp::VfeCore, double>(GGP_POT_PASS);
}
// cfg[C_CHAINS] rows of cfg[C_GROUP] blocks each, one cooperative launch
int ggp_potential_vfe_group_f32(GGP_POT_ARGS) {
  return ggp::launch_potential<ggp::VfeGroupCore, float>(GGP_POT_PASS);
}
int ggp_potential_vfe_group_f64(GGP_POT_ARGS) {
  return ggp::launch_potential<ggp::VfeGroupCore, double>(GGP_POT_PASS);
}
int ggp_potential_vfe_group_occupancy(int f64) {
  return f64 ? ggp::potential_group_blocks_per_sm<ggp::VfeGroupCore, double>()
             : ggp::potential_group_blocks_per_sm<ggp::VfeGroupCore, float>();
}
// elements of T of the grouped core's scratch for C chains of G blocks
long ggp_group_scratch_elems(int n, int m, int d, int C, int G, int f64) {
  return f64 ? ggp::group_scratch_elems<double>(n, m, d, C, G)
             : ggp::group_scratch_elems<float>(n, m, d, C, G);
}
int ggp_potential_sgpmc_f32(GGP_POT_ARGS) {
  return ggp::launch_potential<ggp::SgpmcCore, float>(GGP_POT_PASS);
}
int ggp_potential_sgpmc_f64(GGP_POT_ARGS) {
  return ggp::launch_potential<ggp::SgpmcCore, double>(GGP_POT_PASS);
}
// cfg[C_CHAINS] rows of cfg[C_GROUP] blocks each, one cooperative launch
int ggp_potential_gpr_f32(GGP_POT_ARGS) {
  return ggp::launch_potential<ggp::GprGroupCore, float>(GGP_POT_PASS);
}
int ggp_potential_gpr_f64(GGP_POT_ARGS) {
  return ggp::launch_potential<ggp::GprGroupCore, double>(GGP_POT_PASS);
}
int ggp_potential_gpr_occupancy(int f64) {
  return f64 ? ggp::potential_group_blocks_per_sm<ggp::GprGroupCore, double>()
             : ggp::potential_group_blocks_per_sm<ggp::GprGroupCore, float>();
}
// elements of T of the gpr core's scratch for C chains of G blocks
long ggp_gpr_scratch_elems(int n, int d, int C, int G, int f64) {
  return f64 ? ggp::gpr_scratch_elems<double>(n, d, C, G)
             : ggp::gpr_scratch_elems<float>(n, d, C, G);
}
int ggp_potential_co2_m32_f32(GGP_POT_ARGS) {
  return ggp::launch_potential<ggp::Co2M32Core, float>(GGP_POT_PASS);
}
int ggp_potential_co2_m32_f64(GGP_POT_ARGS) {
  return ggp::launch_potential<ggp::Co2M32Core, double>(GGP_POT_PASS);
}
int ggp_potential_co2_rbf_f32(GGP_POT_ARGS) {
  return ggp::launch_potential<ggp::Co2RbfCore, float>(GGP_POT_PASS);
}
int ggp_potential_co2_rbf_f64(GGP_POT_ARGS) {
  return ggp::launch_potential<ggp::Co2RbfCore, double>(GGP_POT_PASS);
}

}  // extern "C"
