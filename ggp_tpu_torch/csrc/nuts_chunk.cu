// Kernel 2: K transitions of iterative multinomial NUTS over a sampler
// potential (template parameter `Core`: the collapsed bound of
// BayesianSGPR_HMC over its d+2 log-hypers, VfeCore; the whitened
// JointHMC target over d+2+m, SgpmcCore; or the dense GP marginal of
// GPR_HMC over d+2, GprGroupCore), with Stan warmup adaptation
// in-kernel (adapt=1) or at a fixed step size with per-draw outputs
// (adapt=0), for one chain per block and cfg[C_CHAINS] chains per launch.
//
// Replaces: ggp_tpu/ops/fused_nuts.py `_warm_chunk_kernel_body` (the
// `warm_call` pallas_call) and `_sample_chunk_kernel_body` (`sample_call`),
// both built on `_transition_inkernel` and `_da_update_scalars` (grid 1);
// and ggp_tpu/ops/fused_multichain.py `_mc_nuts_warm_chunk_body` and
// `_mc_nuts_sample_chunk_body` (the NUTS `warm_call`/`sample_call` of
// `make_fused_hmc_multichain`, built on `_nuts_transition_batched`; grid
// C); each for targets "vfe" and "sgpmc" (entries
// ggp_nuts_chunk_{vfe,sgpmc}_{f32,f64}); and the grid-1 chunks with
// target="gpr" (ggp_nuts_chunk_gpr_{f32,f64}, a group of blocks per chain),
// which the port also runs for C chains of GPR_HMC; and the grid-1 chunks with targets
// "co2_m32" / "co2_rbf" (Co2M32Core / Co2RbfCore, co2_bound.cuh; entries
// ggp_nuts_chunk_co2_{m32,rbf}_{f32,f64}).
//
// Kernel 2b, nuts_transition_kernel, replaces ggp_tpu/ops/fused_nuts.py
// `_nuts_kernel_body` (the `trans_call` pallas_call, site 4): one
// transition from (z, U, g) at a given step size and inverse mass, for the
// cores "vfe" and "co2_*" (entries ggp_nuts_transition_{vfe,co2_m32,
// co2_rbf}_{f32,f64}). It runs the chunk kernel's own device function
// `nuts_transition` once and does nothing else: no adaptation, no state
// row.
//
// What bounds it on the card: each chain is sequential. Every leapfrog is
// one evaluation of the core (a latency chain of barriers and L2 reads in
// one block, ~2.4 ms for the bound at N=404, M=100; the grouped cores spread
// it over G blocks per chain), and the tree logic
// between evaluations is a handful of dim-length vector operations. C
// chains take C SMs of 132; a launch ends when its longest tree does.
//
// What the design does about it: the whole chunk stays in one launch (no
// host round trip per transition or leapfrog), and block c runs chain c
// alone: row c of every state array, rows t*C+c of every random slab and
// output, and its own scratch area `scratch + c*Core::elems`, so the
// chains never wait on one another inside the launch (the TPU kernel's
// lock-step masking is not needed). C scratch areas stay in the 50 MB L2
// for C*Core::elems*sizeof(T) below it (8 chains at N=404, M=100 in f32:
// 7.5 MB). The tree state and the checkpoint slots live in shared memory,
// and every scalar decision (tree direction, multinomial take, U-turn,
// divergence, adaptation) is computed identically by every thread of the
// block from shared values after a barrier, so a block never splits at a
// __syncthreads. Randomness comes in as slabs with the JAX kernels'
// per-step indexing (momentum row t*C+c; tree uniforms at (t*C+c, depth);
// leaf uniforms at (t*C+c, global leaf index)), which makes the kernel
// deterministic and comparable draw for draw with its plain version.
#include "co2_bound.cuh"
#include "gpr_bound.cuh"
#include "stan_adapt.cuh"
#include "vfe_group.cuh"

namespace ggp {

struct NutsCfg {
  int dim, max_depth, K, adapt, adapt_mass;
  double target;
};

// The tree state of one chain, for state rows of up to D entries
// (CoreDim<Core>::value: kMaxDim, or the core's own bound).
template <typename T, int D>
struct NutsShared {
  T z[D], r[D], g[D], v[D];                               // current leaf
  T lz[D], lr[D], lg[D];                                  // left end
  T rz[D], rr[D], rg[D];                                  // right end
  T pz[D], pg[D];                                         // chain state / proposal
  T qz[D], qg[D];                                         // subtree proposal
  T im[D], wm[D], wm2[D];                                 // mass, Welford
  T zc[(kMaxDepth + 1) * D], vc[(kMaxDepth + 1) * D];
  T U;
};

template <typename T>
__device__ __forceinline__ T lae(T a, T b) {
  const T mx = jmax(a, b);
  return mx + glog1p(gexp(-gabs(a - b)));
}

template <typename T>
__device__ __forceinline__ T log_unif(T u) { return glog(jmax(u, T(1e-12))); }

__device__ __forceinline__ int trailing_ones(int x) {
  const unsigned xp1 = (unsigned)(x + 1);
  const unsigned low = xp1 & (0u - xp1);
  return __popc(low - 1u);
}

// What one transition reports besides the new state (s.pz, s.pg, Up).
template <typename T>
struct TransOut {
  T accept, H0;
  bool diverging;
  int depth, nl;
};

// One NUTS transition at step size eps from the state (s.pz, Up, s.pg)
// under the inverse mass s.im, with the random slabs' row `row`; every
// thread of the block calls it and returns with the same values, the new
// state in s.pz, s.pg and Up.
template <template <typename> class Core, typename T, int D>
__device__ __forceinline__ TransOut<T> nuts_transition(
    const BoundCfg& cf, int dim, int max_depth, T eps, long row, const T* mom,
    const T* treeu, const T* leafu, const T* X, const T* y, const T* Z,
    const typename Core<T>::WorkT& w, BoundShared<T>& sh, NutsShared<T, D>& s, T& Up) {
  const int tid = threadIdx.x;
  const int leaf_cols = 1 << max_depth;
  if (int k = tid; k < dim) {
    const T r0 = mom[row * dim + k] / gsqrt(s.im[k]);
    s.lr[k] = r0;
    s.rr[k] = r0;
    s.lz[k] = s.pz[k];
    s.rz[k] = s.pz[k];
    s.lg[k] = s.pg[k];
    s.rg[k] = s.pg[k];
  }
  __syncthreads();
  const T H0 = Up + kinetic(s.im, s.lr, dim);
  T lU = Up, rU = Up, logw = T(0), acc = T(0);
  int depth = 0, nl = 0;
  bool turning = false, diverging = false;

  while (!turning && !diverging && depth < max_depth) {
    const T u_dir = treeu[(row * max_depth + depth) * 2];
    const T u_swap = treeu[(row * max_depth + depth) * 2 + 1];
    const T dirf = u_dir < T(0.5) ? T(1) : T(-1);
    const bool fwd = dirf > T(0);
    if (int k = tid; k < dim) {
      s.z[k] = fwd ? s.rz[k] : s.lz[k];
      s.r[k] = fwd ? s.rr[k] : s.lr[k];
      s.g[k] = fwd ? s.rg[k] : s.lg[k];
      s.qz[k] = s.z[k];
      s.qg[k] = s.g[k];
    }
    T cU = fwd ? rU : lU, qU = cU;
    __syncthreads();

    // ---- subtree of 2^depth leaves in direction dirf ----
    const int num_leaves = 1 << depth;
    const T eps_s = dirf * eps;
    int i = 0;
    T slogw = -ginf<T>(), sacc = T(0);
    bool sturn = false, sdiv = false;
    while (i < num_leaves && !sturn && !sdiv) {
      if (int k = tid; k < dim) {
        const T rh = s.r[k] - T(0.5) * eps_s * s.g[k];
        s.r[k] = rh;
        s.z[k] = s.z[k] + eps_s * s.im[k] * rh;
      }
      __syncthreads();
      Core<T>::eval(cf, s.z, X, y, Z, w, sh, &s.U, s.g, (T*)nullptr);
      cU = s.U;
      if (int k = tid; k < dim) {
        s.r[k] = s.r[k] - T(0.5) * eps_s * s.g[k];
        s.v[k] = s.im[k] * s.r[k];
      }
      __syncthreads();
      T delta = cU + kinetic(s.im, s.r, dim) - H0;
      if (gisnan(delta)) delta = ginf<T>();
      sdiv = delta > T(1000);
      const T lwl = -delta;
      sacc += jmin(T(1), gexp(-delta));
      const T lwn = lae(slogw, lwl);
      const bool take = log_unif(leafu[row * leaf_cols + nl + i]) < (lwl - lwn);
      if (take) {
        vcopy(s.qz, s.z, dim);
        vcopy(s.qg, s.g, dim);
        qU = cU;
      }
      if ((i & 1) == 0) {
        const int slot = __popc(i);
        if (int k = tid; k < dim) {
          s.zc[slot * D + k] = s.z[k];
          s.vc[slot * D + k] = s.v[k];
        }
      } else {
        const int hi = min(trailing_ones(i), max_depth) + 1;
        for (int mm = 1; mm < hi; ++mm) {
          const int sj = __popc(i - (1 << mm) + 1);
          const T* zcj = s.zc + sj * D;
          const T* vcj = s.vc + sj * D;
          T d1 = T(0), d2 = T(0);
          for (int k = 0; k < dim; ++k) {
            const T dz = dirf * (s.z[k] - zcj[k]);
            d1 += dz * vcj[k];
            d2 += dz * s.v[k];
          }
          if (d1 < T(0) || d2 < T(0)) sturn = true;
        }
      }
      __syncthreads();
      slogw = lwn;
      ++i;
    }

    // ---- merge the subtree into the tree ----
    const bool ok = !sturn && !sdiv;
    const bool take = (log_unif(u_swap) < (slogw - logw)) && ok;
    if (take) {
      vcopy(s.pz, s.qz, dim);
      vcopy(s.pg, s.qg, dim);
      Up = qU;
    }
    if (ok) logw = lae(logw, slogw);
    if (ok && !fwd) {
      vcopy(s.lz, s.z, dim);
      vcopy(s.lr, s.r, dim);
      vcopy(s.lg, s.g, dim);
      lU = cU;
    }
    if (ok && fwd) {
      vcopy(s.rz, s.z, dim);
      vcopy(s.rr, s.r, dim);
      vcopy(s.rg, s.g, dim);
      rU = cU;
    }
    __syncthreads();
    T f1 = T(0), f2 = T(0);
    for (int k = 0; k < dim; ++k) {
      const T dz = s.rz[k] - s.lz[k];
      f1 += dz * s.im[k] * s.lr[k];
      f2 += dz * s.im[k] * s.rr[k];
    }
    turning = sturn || (ok && (f1 < T(0) || f2 < T(0)));
    diverging = sdiv;
    acc += sacc;
    nl += i;
    ++depth;
  }
  TransOut<T> out;
  out.accept = acc / jmax(T(nl), T(1));
  out.H0 = H0;
  out.diverging = diverging;
  out.depth = depth;
  out.nl = nl;
  return out;
}

template <typename T>
__device__ __forceinline__ void write_stats(T* st, T U, const TransOut<T>& tr) {
  st[0] = U;
  st[1] = tr.accept;
  st[2] = tr.diverging ? T(1) : T(0);
  st[3] = T(tr.depth);
  st[4] = T(tr.nl);
  st[5] = tr.H0;
}

// A grouped core (CoreGroup) runs each chain on G = cf.group blocks: every
// block of the group runs the same transitions on its own copy of the tree
// state (the core returns identical bits to all of them), and only the
// group's block 0 (`lead`) writes draws, stats and the chain's state.
template <template <typename> class Core, typename T>
__global__ void __launch_bounds__(CoreThreads<Core>::value)
nuts_chunk_kernel(BoundCfg cf, NutsCfg nc, T* state, T* zio, T* gio, T* imio,
                  T* wmio, T* wm2io, const int* flags, const T* mom,
                  const T* treeu, const T* leafu, const T* X, const T* y,
                  const T* Z, T* draws, T* stats, T* scratch) {
  __shared__ BoundShared<T> sh;
  __shared__ NutsShared<T, CoreDim<Core>::value> s;
  const int tid = threadIdx.x;
  const int G = CoreGroup<Core>::value ? cf.group : 1;
  const int c = blockIdx.x / G, C = gridDim.x / G;    // this block's chain
  const bool lead = blockIdx.x % G == 0;
  const int dim = nc.dim, max_depth = nc.max_depth, K = nc.K;
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
    const T eps = nc.adapt ? gexp(a.le) : eps_fixed;

    const TransOut<T> tr = nuts_transition<Core, T, CoreDim<Core>::value>(cf, dim, max_depth, eps, row, mom, treeu,
                                                    leafu, X, y, Z, w, sh, s, Up);

    if (nc.adapt)
      stan_adapt(a, tr.accept, T(nc.target), nc.adapt_mass != 0, flags[t] > 0,
                 flags[K + t] > 0, s.pz, s.im, s.wm, s.wm2, dim);
    acc_sum += tr.accept;
    div_sum += tr.diverging ? T(1) : T(0);
    if (int k = tid; lead && k < dim) draws[row * dim + k] = s.pz[k];
    if (lead && tid == 0) write_stats(stats + row * 6, Up, tr);
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
int launch_nuts(const double* cfg, void* state, void* z, void* g,
                void* im, void* wm, void* wm2, const void* flags,
                const void* mom, const void* treeu, const void* leafu,
                const void* X, const void* y, const void* Z, void* draws,
                void* stats, void* scratch, void* stream) {
  const BoundCfg cf = bound_cfg(cfg);
  NutsCfg nc;
  nc.dim = (int)cfg[C_DIM];
  nc.max_depth = (int)cfg[C_MAX_DEPTH];
  nc.K = (int)cfg[C_K];
  nc.adapt = (int)cfg[C_ADAPT];
  nc.adapt_mass = (int)cfg[C_ADAPT_MASS];
  nc.target = cfg[C_TARGET];
  const int grid = (int)cfg[C_CHAINS] * (CoreGroup<Core>::value ? cf.group : 1);
  return launch_grid<CoreGroup<Core>::value>(
      nuts_chunk_kernel<Core, T>, grid, CoreThreads<Core>::value, stream, cf, nc, (T*)state,
      (T*)z, (T*)g, (T*)im, (T*)wm, (T*)wm2, (const int*)flags, (const T*)mom,
      (const T*)treeu, (const T*)leafu, (const T*)X, (const T*)y, (const T*)Z, (T*)draws,
      (T*)stats, (T*)scratch);
}

// Blocks of the grouped chunk kernel of `Core` one SM holds at once (the
// occupancy the cooperative launch is sized by), or a negative cudaError_t.
template <template <typename> class Core, typename T>
int chunk_group_blocks_per_sm() {
  int nb = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, nuts_chunk_kernel<Core, T>, CoreThreads<Core>::value, 0);
  return err == cudaSuccess ? nb : -(int)err;
}

// Kernel 2b: one NUTS transition at a given step size and inverse mass
// (site 4), grid 1. The chunked sampler driver (inference/hmc.py
// build_sampler_chunked) launches it once per transition and adapts
// between launches. scal = (eps, U at z); stats as a chunk row.
template <template <typename> class Core, typename T>
__global__ void __launch_bounds__(CoreThreads<Core>::value)
nuts_transition_kernel(BoundCfg cf, NutsCfg nc, const T* scal, const T* zin,
                       const T* gin, const T* imin, const T* mom, const T* treeu,
                       const T* leafu, const T* X, const T* y, const T* Z, T* zout,
                       T* gout, T* stats, T* scratch) {
  __shared__ BoundShared<T> sh;
  __shared__ NutsShared<T, CoreDim<Core>::value> s;
  const int dim = nc.dim;
  const typename Core<T>::WorkT w = Core<T>::work(scratch, cf);
  vcopy(s.pz, zin, dim);
  vcopy(s.pg, gin, dim);
  vcopy(s.im, imin, dim);
  T Up = scal[1];
  __syncthreads();
  const TransOut<T> tr = nuts_transition<Core, T, CoreDim<Core>::value>(cf, dim, nc.max_depth, scal[0], 0, mom,
                                                  treeu, leafu, X, y, Z, w, sh, s, Up);
  vcopy(zout, s.pz, dim);
  vcopy(gout, s.pg, dim);
  if (threadIdx.x == 0) write_stats(stats, Up, tr);
}

template <template <typename> class Core, typename T>
int launch_transition(const double* cfg, const void* scal, const void* z, const void* g,
                      const void* im, const void* mom, const void* treeu, const void* leafu,
                      const void* X, const void* y, const void* Z, void* zout, void* gout,
                      void* stats, void* scratch, void* stream) {
  const BoundCfg cf = bound_cfg(cfg);
  NutsCfg nc;
  nc.dim = (int)cfg[C_DIM];
  nc.max_depth = (int)cfg[C_MAX_DEPTH];
  nc.K = 1;
  nc.adapt = 0;
  nc.adapt_mass = 0;
  nc.target = 0.0;
  nuts_transition_kernel<Core, T><<<1, CoreThreads<Core>::value, 0,
                                      (cudaStream_t)stream>>>(
      cf, nc, (const T*)scal, (const T*)z, (const T*)g, (const T*)im, (const T*)mom,
      (const T*)treeu, (const T*)leafu, (const T*)X, (const T*)y, (const T*)Z, (T*)zout,
      (T*)gout, (T*)stats, (T*)scratch);
  return (int)cudaGetLastError();
}

}  // namespace ggp

#define GGP_NUTS_ARGS                                                        \
  const double *cfg, void *state, void *z, void *g, void *im, void *wm,      \
      void *wm2, const void *flags, const void *mom, const void *treeu,      \
      const void *leafu, const void *X, const void *y, const void *Z,        \
      void *draws, void *stats, void *scratch, void *stream
#define GGP_NUTS_PASS                                                        \
  cfg, state, z, g, im, wm, wm2, flags, mom, treeu, leafu, X, y, Z, draws,   \
      stats, scratch, stream
#define GGP_TRANS_ARGS                                                       \
  const double *cfg, const void *scal, const void *z, const void *g,         \
      const void *im, const void *mom, const void *treeu, const void *leafu, \
      const void *X, const void *y, const void *Z, void *zout, void *gout,   \
      void *stats, void *scratch, void *stream
#define GGP_TRANS_PASS                                                       \
  cfg, scal, z, g, im, mom, treeu, leafu, X, y, Z, zout, gout, stats,        \
      scratch, stream

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
int ggp_nuts_chunk_sgpmc_f32(GGP_NUTS_ARGS) {
  return ggp::launch_nuts<ggp::SgpmcCore, float>(GGP_NUTS_PASS);
}
int ggp_nuts_chunk_sgpmc_f64(GGP_NUTS_ARGS) {
  return ggp::launch_nuts<ggp::SgpmcCore, double>(GGP_NUTS_PASS);
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
