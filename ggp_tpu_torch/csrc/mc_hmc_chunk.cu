// The HMC chunk kernel (kernel 5) of hmc_chunk.cuh, instantiated for the
// cores VfeCore and VfeGroupCore; the grouped sgpmc core's instantiations
// are in sgpmc_group.cu.
#include "vfe_group.cuh"
#include "hmc_chunk.cuh"

extern "C" {
// cfg[C_CHAINS] chains, one block each
int ggp_hmc_chunk_vfe_f32(GGP_HMC_ARGS) {
  return ggp::launch_hmc<ggp::VfeCore, float>(GGP_HMC_PASS);
}
int ggp_hmc_chunk_vfe_f64(GGP_HMC_ARGS) {
  return ggp::launch_hmc<ggp::VfeCore, double>(GGP_HMC_PASS);
}
// cfg[C_CHAINS] chains of cfg[C_GROUP] blocks each, one cooperative launch
int ggp_hmc_chunk_vfe_group_f32(GGP_HMC_ARGS) {
  return ggp::launch_hmc<ggp::VfeGroupCore, float>(GGP_HMC_PASS);
}
int ggp_hmc_chunk_vfe_group_f64(GGP_HMC_ARGS) {
  return ggp::launch_hmc<ggp::VfeGroupCore, double>(GGP_HMC_PASS);
}
int ggp_hmc_chunk_vfe_group_occupancy(int f64) {
  return f64 ? ggp::hmc_group_blocks_per_sm<ggp::VfeGroupCore, double>()
             : ggp::hmc_group_blocks_per_sm<ggp::VfeGroupCore, float>();
}
}
