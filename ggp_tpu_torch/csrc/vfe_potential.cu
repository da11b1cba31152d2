// The potential kernel (kernel 1) of potential_kernel.cuh, instantiated
// for the cores VfeCore, VfeGroupCore, GprGroupCore, Co2M32Core and
// Co2RbfCore; the grouped sgpmc core's instantiations are in
// sgpmc_group.cu.
#include "co2_bound.cuh"
#include "gpr_bound.cuh"
#include "vfe_group.cuh"
#include "potential_kernel.cuh"

extern "C" {

// elements of one evaluation's scratch area of a one-block core; core 0 =
// vfe, 3 = co2_m32, 4 = co2_rbf (ggp_tpu_torch/ops/_build.py _CORE_ID; the
// grouped cores size theirs by ggp_group_scratch_elems,
// ggp_sgpmc_group_scratch_elems and ggp_gpr_scratch_elems)
long ggp_scratch_elems(int core, int n, int m, int d) {
  return core >= 3 ? ggp::work_elems(n, m, 1) : ggp::work_elems(n, m, d);
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
