// Kernel 5: K fixed-leapfrog HMC transitions of C = cfg[C_CHAINS] chains,
// one chain per block, over a sampler potential (template parameter `Core`:
// the collapsed bound of BayesianSGPR_HMC over its d+2 log-hypers, VfeCore,
// or the whitened JointHMC target over d+2+m, SgpmcCore), with per-chain
// Stan warmup adaptation in-kernel (adapt=1) or at a fixed per-chain step
// size (adapt=0).
//
// Replaces: ggp_tpu/ops/fused_multichain.py `_mc_warm_chunk_body` (the HMC
// `warm_call` of `make_fused_hmc_multichain`) and `_mc_sample_chunk_body`
// (`sample_call`), both built on `_hmc_transition_batched` and, for warmup,
// `_stan_adapt_rows` (grid C); and, at grid 1, the fixed-leapfrog HMC
// chunks of ggp_tpu/ops/fused_nuts.py `_warm_chunk_kernel_body` /
// `_sample_chunk_kernel_body` with algorithm="hmc"
// (`_hmc_transition_inkernel`); each for targets "vfe" and "sgpmc"
// (entries ggp_hmc_chunk_{vfe,sgpmc}_{f32,f64}).
//
// What bounds it on the card: each chain is a latency chain of num_leapfrog
// core evaluations per transition (barriers and L2 reads in one block,
// ~2.3 ms each for the bound at N=404, M=100); the leapfrog and Metropolis
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
// splits a block. The per-step outputs use the NUTS kernel's layout (depth
// 0, n_leapfrog = L), so one sampler loop reads both.
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
__global__ void __launch_bounds__(kThreads)
mc_hmc_chunk_kernel(BoundCfg cf, HmcCfg hc, T* state, T* zio, T* gio,
                    T* imio, T* wmio, T* wm2io, const int* flags,
                    const T* mom, const T* mh, const T* X, const T* y,
                    const T* Z, T* draws, T* stats, T* scratch) {
  __shared__ BoundShared<T> sh;
  __shared__ HmcShared<T> s;
  const int tid = threadIdx.x;
  const int c = blockIdx.x, C = gridDim.x;            // this block's chain
  const int dim = hc.dim, K = hc.K, L = hc.num_leapfrog;
  const typename Core<T>::WorkT w =
      Core<T>::work(scratch + (long)c * Core<T>::elems(cf), cf);
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
      if (int k = tid; k < dim) draws[row * dim + k] = T(0);
      if (tid < 6) stats[row * 6 + tid] = T(0);
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
    if (int k = tid; k < dim) draws[row * dim + k] = s.pz[k];
    if (tid == 0) {
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
  mc_hmc_chunk_kernel<Core, T><<<(int)cfg[C_CHAINS], kThreads, 0, (cudaStream_t)stream>>>(
      cf, hc, (T*)state, (T*)z, (T*)g, (T*)im, (T*)wm, (T*)wm2,
      (const int*)flags, (const T*)mom, (const T*)mh, (const T*)X,
      (const T*)y, (const T*)Z, (T*)draws, (T*)stats, (T*)scratch);
  return (int)cudaGetLastError();
}

}  // namespace ggp

#define GGP_HMC_ARGS                                                         \
  const double *cfg, void *state, void *z, void *g, void *im, void *wm,      \
      void *wm2, const void *flags, const void *mom, const void *mh,         \
      const void *X, const void *y, const void *Z, void *draws, void *stats, \
      void *scratch, void *stream
#define GGP_HMC_PASS                                                         \
  cfg, state, z, g, im, wm, wm2, flags, mom, mh, X, y, Z, draws, stats,      \
      scratch, stream

extern "C" {
// cfg[C_CHAINS] chains, one block each
int ggp_hmc_chunk_vfe_f32(GGP_HMC_ARGS) {
  return ggp::launch_hmc<ggp::VfeCore, float>(GGP_HMC_PASS);
}
int ggp_hmc_chunk_vfe_f64(GGP_HMC_ARGS) {
  return ggp::launch_hmc<ggp::VfeCore, double>(GGP_HMC_PASS);
}
int ggp_hmc_chunk_sgpmc_f32(GGP_HMC_ARGS) {
  return ggp::launch_hmc<ggp::SgpmcCore, float>(GGP_HMC_PASS);
}
int ggp_hmc_chunk_sgpmc_f64(GGP_HMC_ARGS) {
  return ggp::launch_hmc<ggp::SgpmcCore, double>(GGP_HMC_PASS);
}
}
