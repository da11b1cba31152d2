// Kernel 5: K fixed-leapfrog HMC transitions of C chains, one chain per
// block, over the (log-lengthscales, log-outputscale, log-noise) posterior
// of BayesianSGPR_HMC, with per-chain Stan warmup adaptation in-kernel
// (adapt=1) or at a fixed per-chain step size (adapt=0).
//
// Replaces: ggp_tpu/ops/fused_multichain.py `_mc_warm_chunk_body` (the HMC
// `warm_call` of `make_fused_hmc_multichain`) and `_mc_sample_chunk_body`
// (`sample_call`), both built on `_hmc_transition_batched` and, for warmup,
// `_stan_adapt_rows`, for the "vfe" core.
//
// What bounds it on the card: each chain is a latency chain of num_leapfrog
// bound evaluations per transition (vfe_bound.cuh: barriers and L2 reads in
// one block, ~2.3 ms each at N=404, M=100); the leapfrog and Metropolis
// arithmetic between them is a few dim-length vector operations. FLOPs and
// device-memory bytes are far below what the card offers.
//
// What the design does about it: one launch per chunk; block c runs chain c
// alone on row c of every state array, rows t*C+c of the momentum slab and
// of the outputs, entry t*C+c of the Metropolis uniforms, and its own scratch
// area `scratch + c*work_elems(n, m, d)`. So C chains take C SMs and never
// wait on one another inside the launch, and the C scratch areas stay in
// the 50 MB L2 while C*work_elems*sizeof(T) is below it. Every decision
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

template <typename T>
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
  const Work<T> w = make_work(scratch + (long)c * work_elems(cf.n, cf.m, cf.d),
                              cf.n, cf.m, cf.d);
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
      if (tid < dim) draws[row * dim + tid] = T(0);
      if (tid < 6) stats[row * 6 + tid] = T(0);
      continue;
    }
    const T eps = hc.adapt ? gexp(a.le) : eps_fixed;

    // ---- L leapfrog steps from (pz, Up, pg) ----
    if (tid < dim) {
      s.r[tid] = mom[row * dim + tid] / gsqrt(s.im[tid]);
      s.z[tid] = s.pz[tid];
      s.g[tid] = s.pg[tid];
    }
    __syncthreads();
    const T H0 = Up + kinetic(s.im, s.r, dim);
    T U = Up;
    for (int l = 0; l < L; ++l) {
      if (tid < dim) {
        const T rh = s.r[tid] - T(0.5) * eps * s.g[tid];
        s.r[tid] = rh;
        s.z[tid] = s.z[tid] + eps * s.im[tid] * rh;
      }
      __syncthreads();
      vfe_bound(cf, s.z, X, y, Z, w, sh, &s.U, s.g, (T*)nullptr);
      U = s.U;
      if (tid < dim) s.r[tid] = s.r[tid] - T(0.5) * eps * s.g[tid];
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
    if (tid < dim) draws[row * dim + tid] = s.pz[tid];
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

template <typename T>
int launch_mc_hmc(const double* cfg, void* state, void* z, void* g, void* im,
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
  mc_hmc_chunk_kernel<T><<<(int)cfg[C_CHAINS], kThreads, 0, (cudaStream_t)stream>>>(
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
int ggp_mc_hmc_chunk_f32(GGP_HMC_ARGS) { return ggp::launch_mc_hmc<float>(GGP_HMC_PASS); }
int ggp_mc_hmc_chunk_f64(GGP_HMC_ARGS) { return ggp::launch_mc_hmc<double>(GGP_HMC_PASS); }
}
