// Kernel 5: K fixed-leapfrog HMC transitions of C = cfg[C_CHAINS] chains,
// one chain per block or, for a grouped core (CoreGroup), per group of
// cfg[C_GROUP] blocks of one cooperative launch, over a sampler potential
// (template parameter `Core`: the collapsed bound of BayesianSGPR_HMC over
// its d+2 log-hypers, VfeCore or VfeGroupCore, or the whitened JointHMC
// target over d+2+m, SgpmcGroupCore), with per-chain Stan
// warmup adaptation in-kernel (adapt=1) or at a fixed per-chain step size
// (adapt=0).
//
// Replaces: ggp_tpu/ops/fused_multichain.py `_mc_warm_chunk_body` (the HMC
// `warm_call` of `make_fused_hmc_multichain`) and `_mc_sample_chunk_body`
// (`sample_call`), both built on `_hmc_transition_batched` and, for warmup,
// `_stan_adapt_rows` (grid C); and, at grid 1, the fixed-leapfrog HMC
// chunks of ggp_tpu/ops/fused_nuts.py `_warm_chunk_kernel_body` /
// `_sample_chunk_kernel_body` with algorithm="hmc"
// (`_hmc_transition_inkernel`); each for targets "vfe" and "sgpmc": the
// vfe core on one block per chain (ggp_hmc_chunk_vfe_{f32,f64}) and on its
// group where the JAX package streams it, past 1024 rows for C >= 2 chains
// (fused_multichain.py:1458-1463), past 2048 for one
// (ggp_hmc_chunk_vfe_group_{f32,f64}); the sgpmc core on its group at
// every n (ggp_hmc_chunk_sgpmc_group_{f32,f64}).
//
// What bounds it on the card: each chain is a latency chain of num_leapfrog
// core evaluations per transition (barriers and L2 reads in one block,
// ~2.3 ms each for the bound at N=404, M=100; the grouped cores spread it
// over G blocks per chain); the leapfrog and Metropolis
// arithmetic between them is a few dim-length vector operations. FLOPs and
// device-memory bytes are far below what the card offers.
//
// What the design does about it: one launch per chunk; block c runs chain c
// alone on row c of every state array, rows t*C+c of the momentum slab and
// of the outputs, entry t*C+c of the Metropolis uniforms, and its own scratch
// area `scratch + c*Core::elems`. So C chains take C SMs and never
// wait on one another inside the launch, and the C scratch areas stay in
// the 50 MB L2 while C*Core::elems*sizeof(T) is below it. Every decision
// (accept, divergence, adaptation) is computed identically by every thread
// of a block from shared values, so no __syncthreads sits in a branch that
// splits a block. On a grouped core every block of a chain's group runs the
// same leapfrogs, Metropolis decision (from the shared `mh` uniform) and
// adaptation on its own copy of the chain state: the core returns the same
// bits to all of them, so they take the same branches; only the group's
// block 0 (`lead`) writes draws, stats and the chain's state. The per-step
// outputs use the NUTS kernel's layout (depth 0, n_leapfrog = L), so one
// sampler loop reads both.
#pragma once

#include "stan_adapt.cuh"

namespace ggp {

struct HmcCfg {
  int dim, K, adapt, adapt_mass, num_leapfrog;
  double target;
};

template <typename T>
struct HmcShared {
  T z[kMaxDim], r[kMaxDim], g[kMaxDim];                   // trajectory
  T pz[kMaxDim], pg[kMaxDim];                             // chain state
  T im[kMaxDim], wm[kMaxDim], wm2[kMaxDim];               // mass, Welford
  T U;
};

template <template <typename> class Core, typename T>
__global__ void __launch_bounds__(CoreThreads<Core>::value)
mc_hmc_chunk_kernel(BoundCfg cf, HmcCfg hc, T* state, T* zio, T* gio,
                    T* imio, T* wmio, T* wm2io, const int* flags,
                    const T* mom, const T* mh, const T* X, const T* y,
                    const T* Z, T* draws, T* stats, T* scratch) {
  __shared__ BoundShared<T> sh;
  __shared__ HmcShared<T> s;
  const int tid = threadIdx.x;
  const int G = CoreGroup<Core>::value ? cf.group : 1;
  const int c = blockIdx.x / G, C = gridDim.x / G;    // this block's chain
  const bool lead = blockIdx.x % G == 0;
  const int dim = hc.dim, K = hc.K, L = hc.num_leapfrog;
  const typename Core<T>::WorkT w = core_work<Core, T>(scratch, cf, X, Z, sh, c);
  state += c * S_LEN;
  zio += c * dim;
  gio += c * dim;
  imio += c * dim;
  wmio += c * dim;
  wm2io += c * dim;

  vcopy(s.pz, zio, dim);
  vcopy(s.pg, gio, dim);
  vcopy(s.im, imio, dim);
  vcopy(s.wm, wmio, dim);
  vcopy(s.wm2, wm2io, dim);
  T Up = state[S_U];
  Adapt<T> a = load_adapt(state);
  const int n_active = (int)state[S_NACT];
  const T eps_fixed = state[S_EPS];
  T acc_sum = T(0), div_sum = T(0);
  __syncthreads();

  for (int t = 0; t < K; ++t) {
    const long row = (long)t * C + c;                 // slab and output row
    if (t >= n_active) {
      if (int k = tid; lead && k < dim) draws[row * dim + k] = T(0);
      if (lead && tid < 6) stats[row * 6 + tid] = T(0);
      continue;
    }
    const T eps = hc.adapt ? gexp(a.le) : eps_fixed;

    // ---- L leapfrog steps from (pz, Up, pg) ----
    if (int k = tid; k < dim) {
      s.r[k] = mom[row * dim + k] / gsqrt(s.im[k]);
      s.z[k] = s.pz[k];
      s.g[k] = s.pg[k];
    }
    __syncthreads();
    const T H0 = Up + kinetic(s.im, s.r, dim);
    T U = Up;
    for (int l = 0; l < L; ++l) {
      if (int k = tid; k < dim) {
        const T rh = s.r[k] - T(0.5) * eps * s.g[k];
        s.r[k] = rh;
        s.z[k] = s.z[k] + eps * s.im[k] * rh;
      }
      __syncthreads();
      Core<T>::eval(cf, s.z, X, y, Z, w, sh, &s.U, s.g, (T*)nullptr);
      U = s.U;
      if (int k = tid; k < dim) s.r[k] = s.r[k] - T(0.5) * eps * s.g[k];
      __syncthreads();
    }

    // ---- Metropolis correction: accept iff u < min(1, exp(-dH)) ----
    const T H1 = U + kinetic(s.im, s.r, dim);
    const T delta = gisnan(H1) ? ginf<T>() : H1 - H0;
    const T accept = jmin(T(1), gexp(-delta));
    const bool diverging = delta > T(1000);
    if (mh[row] < accept) {
      vcopy(s.pz, s.z, dim);
      vcopy(s.pg, s.g, dim);
      Up = U;
    }
    if (hc.adapt)
      stan_adapt(a, accept, T(hc.target), hc.adapt_mass != 0, flags[t] > 0,
                 flags[K + t] > 0, s.pz, s.im, s.wm, s.wm2, dim);
    acc_sum += accept;
    div_sum += diverging ? T(1) : T(0);
    if (int k = tid; lead && k < dim) draws[row * dim + k] = s.pz[k];
    if (lead && tid == 0) {
      T* st = stats + row * 6;
      st[0] = Up;
      st[1] = accept;
      st[2] = diverging ? T(1) : T(0);
      st[3] = T(0);
      st[4] = T(L);
      st[5] = H0;
    }
    __syncthreads();
  }

  if (!lead) return;
  vcopy(zio, s.pz, dim);
  vcopy(gio, s.pg, dim);
  vcopy(imio, s.im, dim);
  vcopy(wmio, s.wm, dim);
  vcopy(wm2io, s.wm2, dim);
  if (tid == 0) store_state(state, a, Up, acc_sum, div_sum);
}

template <template <typename> class Core, typename T>
int launch_hmc(const double* cfg, void* state, void* z, void* g, void* im,
               void* wm, void* wm2, const void* flags, const void* mom,
               const void* mh, const void* X, const void* y, const void* Z,
               void* draws, void* stats, void* scratch, void* stream) {
  const BoundCfg cf = bound_cfg(cfg);
  HmcCfg hc;
  hc.dim = (int)cfg[C_DIM];
  hc.K = (int)cfg[C_K];
  hc.adapt = (int)cfg[C_ADAPT];
  hc.adapt_mass = (int)cfg[C_ADAPT_MASS];
  hc.num_leapfrog = (int)cfg[C_LEAPFROG];
  hc.target = cfg[C_TARGET];
  const int grid = (int)cfg[C_CHAINS] * (CoreGroup<Core>::value ? cf.group : 1);
  return launch_grid<CoreGroup<Core>::value>(
      mc_hmc_chunk_kernel<Core, T>, grid, CoreThreads<Core>::value, stream, cf, hc, (T*)state,
      (T*)z, (T*)g, (T*)im, (T*)wm, (T*)wm2, (const int*)flags, (const T*)mom, (const T*)mh,
      (const T*)X, (const T*)y, (const T*)Z, (T*)draws, (T*)stats, (T*)scratch);
}

// Blocks of the grouped HMC chunk kernel of `Core` one SM holds at once (the
// occupancy the cooperative launch is sized by), or a negative cudaError_t.
template <template <typename> class Core, typename T>
int hmc_group_blocks_per_sm() {
  int nb = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, mc_hmc_chunk_kernel<Core, T>, CoreThreads<Core>::value, 0);
  return err == cudaSuccess ? nb : -(int)err;
}

}  // namespace ggp

// The argument lists of the C entries (mc_hmc_chunk.cu, sgpmc_group.cu).
#define GGP_HMC_ARGS                                                         \
  const double *cfg, void *state, void *z, void *g, void *im, void *wm,      \
      void *wm2, const void *flags, const void *mom, const void *mh,         \
      const void *X, const void *y, const void *Z, void *draws, void *stats, \
      void *scratch, void *stream
#define GGP_HMC_PASS                                                         \
  cfg, state, z, g, im, wm, wm2, flags, mom, mh, X, y, Z, draws, stats,      \
      scratch, stream
