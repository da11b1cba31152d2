// The grouped sgpmc core (sgpmc_group.cuh, SgpmcGroupCore) under the
// potential kernel (kernel 1, potential_kernel.cuh), the NUTS chunk kernel
// (kernel 2, nuts_chunk.cuh) and the HMC chunk kernel (kernel 5,
// hmc_chunk.cuh): cfg[C_CHAINS] chains of cfg[C_GROUP] blocks each, one
// cooperative launch. They replace the sites the JAX package runs on its
// sgpmc core, resident or streamed, at every n: sites 1-3
// (fused_nuts.py:807/780/792) for one chain and sites 10-14
// (fused_multichain.py:1933/1954/1966/1985/1997) for C chains. A
// translation unit of its own, so that
// nvcc compiles it beside nuts_chunk.cu, the longest of the parallel builds.
#include "sgpmc_group.cuh"
#include "potential_kernel.cuh"
#include "nuts_chunk.cuh"
#include "hmc_chunk.cuh"

extern "C" {

// elements of T of the grouped sgpmc core's scratch for C chains of G blocks
long ggp_sgpmc_group_scratch_elems(int n, int m, int d, int C, int G, int f64) {
  return f64 ? ggp::sgpmc_group_scratch_elems<double>(n, m, d, C, G)
             : ggp::sgpmc_group_scratch_elems<float>(n, m, d, C, G);
}

int ggp_potential_sgpmc_group_f32(GGP_POT_ARGS) {
  return ggp::launch_potential<ggp::SgpmcGroupCore, float>(GGP_POT_PASS);
}
int ggp_potential_sgpmc_group_f64(GGP_POT_ARGS) {
  return ggp::launch_potential<ggp::SgpmcGroupCore, double>(GGP_POT_PASS);
}
int ggp_potential_sgpmc_group_occupancy(int f64) {
  return f64 ? ggp::potential_group_blocks_per_sm<ggp::SgpmcGroupCore, double>()
             : ggp::potential_group_blocks_per_sm<ggp::SgpmcGroupCore, float>();
}

int ggp_nuts_chunk_sgpmc_group_f32(GGP_NUTS_ARGS) {
  return ggp::launch_nuts<ggp::SgpmcGroupCore, float>(GGP_NUTS_PASS);
}
int ggp_nuts_chunk_sgpmc_group_f64(GGP_NUTS_ARGS) {
  return ggp::launch_nuts<ggp::SgpmcGroupCore, double>(GGP_NUTS_PASS);
}
int ggp_nuts_chunk_sgpmc_group_occupancy(int f64) {
  return f64 ? ggp::chunk_group_blocks_per_sm<ggp::SgpmcGroupCore, double>()
             : ggp::chunk_group_blocks_per_sm<ggp::SgpmcGroupCore, float>();
}

int ggp_hmc_chunk_sgpmc_group_f32(GGP_HMC_ARGS) {
  return ggp::launch_hmc<ggp::SgpmcGroupCore, float>(GGP_HMC_PASS);
}
int ggp_hmc_chunk_sgpmc_group_f64(GGP_HMC_ARGS) {
  return ggp::launch_hmc<ggp::SgpmcGroupCore, double>(GGP_HMC_PASS);
}
int ggp_hmc_chunk_sgpmc_group_occupancy(int f64) {
  return f64 ? ggp::hmc_group_blocks_per_sm<ggp::SgpmcGroupCore, double>()
             : ggp::hmc_group_blocks_per_sm<ggp::SgpmcGroupCore, float>();
}

}  // extern "C"
