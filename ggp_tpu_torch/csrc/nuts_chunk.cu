// Kernel 2: K transitions of iterative multinomial NUTS over the
// (log-lengthscales, log-outputscale, log-noise) posterior of
// BayesianSGPR_HMC, with Stan warmup adaptation in-kernel (adapt=1) or at a
// fixed step size with per-draw outputs (adapt=0), for one chain per block.
//
// Replaces: ggp_tpu/ops/fused_nuts.py `_warm_chunk_kernel_body` (the
// `warm_call` pallas_call) and `_sample_chunk_kernel_body` (`sample_call`),
// both built on `_transition_inkernel` and `_da_update_scalars` (entry
// ggp_nuts_chunk_*, grid 1); and ggp_tpu/ops/fused_multichain.py
// `_mc_nuts_warm_chunk_body` and `_mc_nuts_sample_chunk_body` (the NUTS
// `warm_call`/`sample_call` of `make_fused_hmc_multichain`, built on
// `_nuts_transition_batched`) for the "vfe" core (entry ggp_mc_nuts_chunk_*,
// grid C).
//
// What bounds it on the card: each chain is sequential. Every leapfrog is
// one evaluation of the bound (vfe_bound.cuh: a latency chain of barriers
// and L2 reads in one block, ~2.3 ms at N=404, M=100), and the tree logic
// between evaluations is a handful of dim-length vector operations. C
// chains take C SMs of 132; a launch ends when its longest tree does.
//
// What the design does about it: the whole chunk stays in one launch (no
// host round trip per transition or leapfrog), and block c runs chain c
// alone: row c of every state array, rows t*C+c of every random slab and
// output, and its own scratch area `scratch + c*work_elems(n, m, d)`, so the
// chains never wait on one another inside the launch (the TPU kernel's
// lock-step masking is not needed). C scratch areas stay in the 50 MB L2
// for C*work_elems*sizeof(T) below it (8 chains at N=404, M=100 in f32:
// 7.5 MB). The tree state and the checkpoint slots live in shared memory,
// and every scalar decision (tree direction, multinomial take, U-turn,
// divergence, adaptation) is computed identically by every thread of the
// block from shared values after a barrier, so a block never splits at a
// __syncthreads. Randomness comes in as slabs with the JAX kernels'
// per-step indexing (momentum row t*C+c; tree uniforms at (t*C+c, depth);
// leaf uniforms at (t*C+c, global leaf index)), which makes the kernel
// deterministic and comparable draw for draw with its plain version.
#include "stan_adapt.cuh"

namespace ggp {

struct NutsCfg {
  int dim, max_depth, K, adapt, adapt_mass;
  double target;
};

template <typename T>
struct NutsShared {
  T z[kMaxDim], r[kMaxDim], g[kMaxDim], v[kMaxDim];      // current leaf
  T lz[kMaxDim], lr[kMaxDim], lg[kMaxDim];                // left end
  T rz[kMaxDim], rr[kMaxDim], rg[kMaxDim];                // right end
  T pz[kMaxDim], pg[kMaxDim];                             // chain state / proposal
  T qz[kMaxDim], qg[kMaxDim];                             // subtree proposal
  T im[kMaxDim], wm[kMaxDim], wm2[kMaxDim];               // mass, Welford
  T zc[(kMaxDepth + 1) * kMaxDim], vc[(kMaxDepth + 1) * kMaxDim];
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
nuts_chunk_kernel(BoundCfg cf, NutsCfg nc, T* state, T* zio, T* gio, T* imio,
                  T* wmio, T* wm2io, const int* flags, const T* mom,
                  const T* treeu, const T* leafu, const T* X, const T* y,
                  const T* Z, T* draws, T* stats, T* scratch) {
  __shared__ BoundShared<T> sh;
  __shared__ NutsShared<T> s;
  const int tid = threadIdx.x;
  const int c = blockIdx.x, C = gridDim.x;            // this block's chain
  const int dim = nc.dim, max_depth = nc.max_depth, K = nc.K;
  const int leaf_cols = 1 << max_depth;
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
    const T eps = nc.adapt ? gexp(a.le) : eps_fixed;

    // ---- one NUTS transition from (pz, Up, pg) ----
    if (tid < dim) {
      const T r0 = mom[row * dim + tid] / gsqrt(s.im[tid]);
      s.lr[tid] = r0;
      s.rr[tid] = r0;
      s.lz[tid] = s.pz[tid];
      s.rz[tid] = s.pz[tid];
      s.lg[tid] = s.pg[tid];
      s.rg[tid] = s.pg[tid];
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
      if (tid < dim) {
        s.z[tid] = fwd ? s.rz[tid] : s.lz[tid];
        s.r[tid] = fwd ? s.rr[tid] : s.lr[tid];
        s.g[tid] = fwd ? s.rg[tid] : s.lg[tid];
        s.qz[tid] = s.z[tid];
        s.qg[tid] = s.g[tid];
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
        if (tid < dim) {
          const T rh = s.r[tid] - T(0.5) * eps_s * s.g[tid];
          s.r[tid] = rh;
          s.z[tid] = s.z[tid] + eps_s * s.im[tid] * rh;
        }
        __syncthreads();
        vfe_bound(cf, s.z, X, y, Z, w, sh, &s.U, s.g, (T*)nullptr);
        cU = s.U;
        if (tid < dim) {
          s.r[tid] = s.r[tid] - T(0.5) * eps_s * s.g[tid];
          s.v[tid] = s.im[tid] * s.r[tid];
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
          if (tid < dim) {
            s.zc[slot * kMaxDim + tid] = s.z[tid];
            s.vc[slot * kMaxDim + tid] = s.v[tid];
          }
        } else {
          const int hi = min(trailing_ones(i), max_depth) + 1;
          for (int mm = 1; mm < hi; ++mm) {
            const int sj = __popc(i - (1 << mm) + 1);
            const T* zcj = s.zc + sj * kMaxDim;
            const T* vcj = s.vc + sj * kMaxDim;
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
    const T accept = acc / jmax(T(nl), T(1));

    if (nc.adapt)
      stan_adapt(a, accept, T(nc.target), nc.adapt_mass != 0, flags[t] > 0,
                 flags[K + t] > 0, s.pz, s.im, s.wm, s.wm2, dim);
    acc_sum += accept;
    div_sum += diverging ? T(1) : T(0);
    if (tid < dim) draws[row * dim + tid] = s.pz[tid];
    if (tid == 0) {
      T* st = stats + row * 6;
      st[0] = Up;
      st[1] = accept;
      st[2] = diverging ? T(1) : T(0);
      st[3] = T(depth);
      st[4] = T(nl);
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
int launch_nuts(int chains, const double* cfg, void* state, void* z, void* g,
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
  nuts_chunk_kernel<T><<<chains, kThreads, 0, (cudaStream_t)stream>>>(
      cf, nc, (T*)state, (T*)z, (T*)g, (T*)im, (T*)wm, (T*)wm2,
      (const int*)flags, (const T*)mom, (const T*)treeu, (const T*)leafu,
      (const T*)X, (const T*)y, (const T*)Z, (T*)draws, (T*)stats, (T*)scratch);
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

extern "C" {
// one chain (grid 1)
int ggp_nuts_chunk_f32(GGP_NUTS_ARGS) { return ggp::launch_nuts<float>(1, GGP_NUTS_PASS); }
int ggp_nuts_chunk_f64(GGP_NUTS_ARGS) { return ggp::launch_nuts<double>(1, GGP_NUTS_PASS); }
// cfg[C_CHAINS] chains, one block each
int ggp_mc_nuts_chunk_f32(GGP_NUTS_ARGS) {
  return ggp::launch_nuts<float>((int)cfg[ggp::C_CHAINS], GGP_NUTS_PASS);
}
int ggp_mc_nuts_chunk_f64(GGP_NUTS_ARGS) {
  return ggp::launch_nuts<double>((int)cfg[ggp::C_CHAINS], GGP_NUTS_PASS);
}
}
