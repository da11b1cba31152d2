// Kernel 2: K transitions of iterative multinomial NUTS over the
// (log-lengthscales, log-outputscale, log-noise) posterior of
// BayesianSGPR_HMC, with Stan warmup adaptation in-kernel (adapt=1) or at a
// fixed step size with per-draw outputs (adapt=0).
//
// Replaces: ggp_tpu/ops/fused_nuts.py `_warm_chunk_kernel_body` (the
// `warm_call` pallas_call) and `_sample_chunk_kernel_body` (`sample_call`),
// both built on `_transition_inkernel` and `_da_update_scalars`.
//
// What bounds it on the card: the chain is sequential. Every leapfrog is
// one evaluation of the bound (vfe_bound.cuh: a latency chain of barriers
// and L2 reads in one block), and the tree logic between evaluations is a
// handful of dim-length vector operations. The card's parallelism beyond
// one block is idle for a single chain.
//
// What the design does about it: the whole chunk stays in one launch (no
// host round trip per transition or leapfrog), the tree state and the
// checkpoint slots live in shared memory, and every scalar decision (tree
// direction, multinomial take, U-turn, divergence, adaptation) is computed
// identically by every thread from shared values after a barrier, so the
// block never splits at a __syncthreads. Randomness comes in as slabs with
// the JAX kernel's per-step indexing (momentum row t; tree uniforms at
// (t, depth); leaf uniforms at (t, global leaf index)), which makes the
// kernel deterministic and comparable draw for draw with its plain version.
#include "vfe_bound.cuh"

namespace ggp {

enum StateIndex {
  S_U = 0, S_LE, S_LEA, S_H, S_MU, S_TDA, S_WFC, S_NACT, S_EPS, S_ACC, S_DIV, S_LEN
};

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
__device__ __forceinline__ void vcopy(T* dst, const T* src, int dim) {
  if ((int)threadIdx.x < dim) dst[threadIdx.x] = src[threadIdx.x];
}

template <typename T>
__device__ T kinetic(const T* im, const T* r, int dim) {
  T s = T(0);
  for (int k = 0; k < dim; ++k) s += im[k] * r[k] * r[k];
  return T(0.5) * s;
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
  const int dim = nc.dim, max_depth = nc.max_depth, K = nc.K;
  const int leaf_cols = 1 << max_depth;
  const Work<T> w = make_work(scratch, cf.n, cf.m, cf.d);

  vcopy(s.pz, zio, dim);
  vcopy(s.pg, gio, dim);
  vcopy(s.im, imio, dim);
  vcopy(s.wm, wmio, dim);
  vcopy(s.wm2, wm2io, dim);
  T Up = state[S_U], le = state[S_LE], lea = state[S_LEA], h = state[S_H];
  T mu = state[S_MU], tda = state[S_TDA], wfc = state[S_WFC];
  const int n_active = (int)state[S_NACT];
  const T eps_fixed = state[S_EPS];
  T acc_sum = T(0), div_sum = T(0);
  __syncthreads();

  for (int t = 0; t < K; ++t) {
    if (t >= n_active) {
      if (tid < dim) draws[t * dim + tid] = T(0);
      if (tid < 6) stats[t * 6 + tid] = T(0);
      continue;
    }
    const T eps = nc.adapt ? gexp(le) : eps_fixed;

    // ---- one NUTS transition from (pz, Up, pg) ----
    if (tid < dim) {
      const T r0 = mom[t * dim + tid] / gsqrt(s.im[tid]);
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
      const T u_dir = treeu[(t * max_depth + depth) * 2];
      const T u_swap = treeu[(t * max_depth + depth) * 2 + 1];
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
        const bool take = log_unif(leafu[t * leaf_cols + nl + i]) < (lwl - lwn);
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

    // ---- warmup adaptation (hmc.py da_update + Welford windows) ----
    if (nc.adapt) {
      const T t1 = tda + T(1);
      const T h1 = (T(1) - T(1) / (t1 + T(10))) * h + (T(nc.target) - accept) / (t1 + T(10));
      const T le1 = mu - gsqrt(t1) / T(0.05) * h1;
      const T wgt = gexp(T(-0.75) * glog(t1));
      T lea1 = wgt * le1 + (T(1) - wgt) * lea;
      T mu1 = mu, hh = h1, tda1 = t1;
      if (nc.adapt_mass) {
        const bool in_w = flags[t] > 0, w_end = flags[K + t] > 0;
        const T cnt1 = wfc + T(1);
        T wfc1 = in_w ? cnt1 : wfc;
        if (tid < dim) {
          const T zp = s.pz[tid];
          const T delta = zp - s.wm[tid];
          const T mean1 = s.wm[tid] + delta / cnt1;
          const T m21 = s.wm2[tid] + delta * (zp - mean1);
          T wm1 = in_w ? mean1 : s.wm[tid];
          T wm21 = in_w ? m21 : s.wm2[tid];
          if (w_end) {
            T var = wm21 / jmax(wfc1 - T(1), T(1));
            var = (wfc1 / (wfc1 + T(5))) * var + T(1e-3) * (T(5) / (wfc1 + T(5)));
            s.im[tid] = var;
            wm1 = T(0);
            wm21 = T(0);
          }
          s.wm[tid] = wm1;
          s.wm2[tid] = wm21;
        }
        if (w_end) {
          wfc1 = T(0);
          lea1 = le1;
          mu1 = glog(T(10)) + le1;
          hh = T(0);
          tda1 = T(0);
        }
        wfc = wfc1;
      }
      le = le1;
      lea = lea1;
      h = hh;
      mu = mu1;
      tda = tda1;
    }
    acc_sum += accept;
    div_sum += diverging ? T(1) : T(0);
    if (tid < dim) draws[t * dim + tid] = s.pz[tid];
    if (tid == 0) {
      T* st = stats + t * 6;
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
  if (tid == 0) {
    state[S_U] = Up;
    state[S_LE] = le;
    state[S_LEA] = lea;
    state[S_H] = h;
    state[S_MU] = mu;
    state[S_TDA] = tda;
    state[S_WFC] = wfc;
    state[S_ACC] = acc_sum;
    state[S_DIV] = div_sum;
  }
}

template <typename T>
int launch_nuts(const double* cfg, void* state, void* z, void* g, void* im,
                void* wm, void* wm2, const void* flags, const void* mom,
                const void* treeu, const void* leafu, const void* X,
                const void* y, const void* Z, void* draws, void* stats,
                void* scratch, void* stream) {
  const BoundCfg cf = bound_cfg(cfg);
  NutsCfg nc;
  nc.dim = (int)cfg[C_DIM];
  nc.max_depth = (int)cfg[C_MAX_DEPTH];
  nc.K = (int)cfg[C_K];
  nc.adapt = (int)cfg[C_ADAPT];
  nc.adapt_mass = (int)cfg[C_ADAPT_MASS];
  nc.target = cfg[C_TARGET];
  nuts_chunk_kernel<T><<<1, kThreads, 0, (cudaStream_t)stream>>>(
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
int ggp_nuts_chunk_f32(GGP_NUTS_ARGS) { return ggp::launch_nuts<float>(GGP_NUTS_PASS); }
int ggp_nuts_chunk_f64(GGP_NUTS_ARGS) { return ggp::launch_nuts<double>(GGP_NUTS_PASS); }
}
