// The NUTS chunk kernel (kernel 2) and the one-transition kernel (kernel
// 2b) of nuts_chunk.cuh, instantiated for the cores VfeCore, VfeGroupCore,
// GprGroupCore, Co2M32Core and Co2RbfCore; the grouped sgpmc core's
// instantiations are in sgpmc_group.cu.
#include "co2_bound.cuh"
#include "gpr_bound.cuh"
#include "vfe_group.cuh"
#include "nuts_chunk.cuh"

extern "C" {
// cfg[C_CHAINS] chains, one block each
int ggp_nuts_chunk_vfe_f32(GGP_NUTS_ARGS) {
  return ggp::launch_nuts<ggp::VfeCore, float>(GGP_NUTS_PASS);
}
int ggp_nuts_chunk_vfe_f64(GGP_NUTS_ARGS) {
  return ggp::launch_nuts<ggp::VfeCore, double>(GGP_NUTS_PASS);
}
// cfg[C_CHAINS] chains of cfg[C_GROUP] blocks each, one cooperative launch
int ggp_nuts_chunk_vfe_group_f32(GGP_NUTS_ARGS) {
  return ggp::launch_nuts<ggp::VfeGroupCore, float>(GGP_NUTS_PASS);
}
int ggp_nuts_chunk_vfe_group_f64(GGP_NUTS_ARGS) {
  return ggp::launch_nuts<ggp::VfeGroupCore, double>(GGP_NUTS_PASS);
}
int ggp_nuts_chunk_vfe_group_occupancy(int f64) {
  return f64 ? ggp::chunk_group_blocks_per_sm<ggp::VfeGroupCore, double>()
             : ggp::chunk_group_blocks_per_sm<ggp::VfeGroupCore, float>();
}
// cfg[C_CHAINS] chains of cfg[C_GROUP] blocks each, one cooperative launch
int ggp_nuts_chunk_gpr_f32(GGP_NUTS_ARGS) {
  return ggp::launch_nuts<ggp::GprGroupCore, float>(GGP_NUTS_PASS);
}
int ggp_nuts_chunk_gpr_f64(GGP_NUTS_ARGS) {
  return ggp::launch_nuts<ggp::GprGroupCore, double>(GGP_NUTS_PASS);
}
int ggp_nuts_chunk_gpr_occupancy(int f64) {
  return f64 ? ggp::chunk_group_blocks_per_sm<ggp::GprGroupCore, double>()
             : ggp::chunk_group_blocks_per_sm<ggp::GprGroupCore, float>();
}
int ggp_nuts_chunk_co2_m32_f32(GGP_NUTS_ARGS) {
  return ggp::launch_nuts<ggp::Co2M32Core, float>(GGP_NUTS_PASS);
}
int ggp_nuts_chunk_co2_m32_f64(GGP_NUTS_ARGS) {
  return ggp::launch_nuts<ggp::Co2M32Core, double>(GGP_NUTS_PASS);
}
int ggp_nuts_chunk_co2_rbf_f32(GGP_NUTS_ARGS) {
  return ggp::launch_nuts<ggp::Co2RbfCore, float>(GGP_NUTS_PASS);
}
int ggp_nuts_chunk_co2_rbf_f64(GGP_NUTS_ARGS) {
  return ggp::launch_nuts<ggp::Co2RbfCore, double>(GGP_NUTS_PASS);
}

// one transition, grid 1
int ggp_nuts_transition_vfe_f32(GGP_TRANS_ARGS) {
  return ggp::launch_transition<ggp::VfeCore, float>(GGP_TRANS_PASS);
}
int ggp_nuts_transition_vfe_f64(GGP_TRANS_ARGS) {
  return ggp::launch_transition<ggp::VfeCore, double>(GGP_TRANS_PASS);
}
int ggp_nuts_transition_co2_m32_f32(GGP_TRANS_ARGS) {
  return ggp::launch_transition<ggp::Co2M32Core, float>(GGP_TRANS_PASS);
}
int ggp_nuts_transition_co2_m32_f64(GGP_TRANS_ARGS) {
  return ggp::launch_transition<ggp::Co2M32Core, double>(GGP_TRANS_PASS);
}
int ggp_nuts_transition_co2_rbf_f32(GGP_TRANS_ARGS) {
  return ggp::launch_transition<ggp::Co2RbfCore, float>(GGP_TRANS_PASS);
}
int ggp_nuts_transition_co2_rbf_f64(GGP_TRANS_ARGS) {
  return ggp::launch_transition<ggp::Co2RbfCore, double>(GGP_TRANS_PASS);
}
}
