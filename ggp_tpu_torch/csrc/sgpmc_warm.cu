// Kernel 6: the JointHMC (SGPMC) warm start, K Adam steps on (state, Z) in
// one cooperative launch, each evaluation on the grouped sgpmc core
// (sgpmc_group.cuh) over G blocks; state = [log_lengthscale (d),
// log_outputscale, log_noise, v (m)].
//
// Replaces: ggp_tpu/ops/fused_sgpmc.py `_warm_chunk_body` (the pallas_call
// of `make_fused_sgpmc_warm`), which replicates the optax chain of
// `SGPMC.warm_start`, and the XLA scan that `SGPMC.warm_start` runs past
// the fused envelope. Each step evaluates the loss -(loglik - ||v||^2 /
// 2), with no hyperprior, and its gradient in (state, Z) (the grouped core
// with want_z, want_prior=0 and the trainers' pivot floor); zeroes the
// non-finite gradient entries one by one; scales the whole (state, Z)
// gradient by min(1, clip / ||g||) (one global norm); and takes the optax
// Adam step at t = t0 + step + 1. There is no box on the log-hypers and no
// noise floor (unlike sgpr_adam.cu). Plain model of its order:
// ops/sgpmc_warm.py `sgpmc_warm_group_chunk_plain`.
//
// What bounds it on the card: each step is one evaluation, whose O(n M^2)
// row products one block walks in ~46 ms at n = 13,279, M = 100; the Adam
// update is O((m + 1) d) and the norm one block reduction.
//
// The design: the whole chunk is one launch, so there is no host round trip
// per step, and the rows are spread over the G blocks of the grouped core.
// A step is one `sgpmc_group_bound` with dU/dZ: block 0 writes U, g and
// dU/dZ to the chain's area before the evaluation's last barrier, and every
// block reads them through L2. Then every block takes the same step itself:
// the masked squares of dU/dZ (a block sum in double) and of g (thread 0,
// in order), the clip factor, and the Adam step on the state (in shared
// memory) and on its own copy of (Z, m_z, v_z) in the scratch. Identical
// inputs in one order give identical bits in every block, so the step adds
// no barrier to the evaluation's four; the next evaluation reads the
// block's own Z and forms the lengthscale cap anew (group_cap: Z moves
// inside the launch). Only block 0 writes the losses and, at the end,
// (state, Z) and their moments; the Z it returns is the contiguous (m, d)
// array the sampler launches read. No float atomics.
#include "adam.cuh"
#include "sgpmc_group.cuh"

namespace ggp {

// Bytes of the grouped warm start's scratch before its own areas: the
// grouped sgpmc core's scratch of one chain, rounded to 16 bytes.
template <typename T>
__host__ __device__ inline long warm_core_bytes(int n, int m, int d, int G) {
  return (sgpmc_group_scratch_elems<T>(n, m, d, 1, G) * (long)sizeof(T) + 15) / 16 * 16;
}

// Elements of T of the grouped warm start's scratch: the grouped core's,
// then dU/dZ (m d, block 0 writes it) and each block's (Z, m_z, v_z) (3 m d).
template <typename T>
__host__ __device__ inline long warm_group_scratch_elems(int n, int m, int d, int G) {
  const long bytes = warm_core_bytes<T>(n, m, d, G) + (long)m * d * (1 + 3L * G) * sizeof(T);
  return (bytes + (long)sizeof(T) - 1) / (long)sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sgpmc_warm_group_kernel(BoundCfg cf, TrainCfg tc, T* st, T* Z, T* m_st, T* v_st, T* m_z,
                        T* v_z, const T* X, const T* y, T* losses, T* scratch) {
  __shared__ BoundShared<T> sh;
  __shared__ T s_st[kMaxDim], s_m[kMaxDim], s_v[kMaxDim];
  __shared__ T s_g[kMaxDim];
  __shared__ T s_U;
  __shared__ double dred[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int dim = cf.d + 2 + cf.m, md = cf.m * cf.d;
  const int G = cf.group, p = blockIdx.x;
  T* dZ = (T*)((char*)scratch + warm_core_bytes<T>(cf.n, cf.m, cf.d, G));
  T* Zb = dZ + md + 3L * p * md;                      // this block's Z, m_z, v_z
  T* mzb = Zb + md;
  T* vzb = mzb + md;
  for (int i = tid; i < md; i += nt) {
    Zb[i] = Z[i];
    mzb[i] = m_z[i];
    vzb[i] = v_z[i];
  }
  if (tid < dim) {
    s_st[tid] = st[tid];
    s_m[tid] = m_st[tid];
    s_v[tid] = v_st[tid];
  }
  __syncthreads();
  SgpmcGroupWork<T> gw = SgpmcGroupCore<T>::work(scratch, cf, X, Zb, sh);
  const T lr = T(tc.lr);

  for (int t = 0; t < tc.K; ++t) {
    if (t > 0) group_cap(gw, Zb, md, sh);           // Z moved: its cap anew
    sgpmc_group_bound(cf, s_st, X, y, Zb, gw, sh, &s_U, s_g, dZ);
    // one global norm over (state, Z) of the masked gradient, in double: dU/dZ
    // by a block sum, then the state's entries in order by thread 0
    double part = 0.0;
    for (int i = tid; i < md; i += nt) {
      const T gz = __ldcg(dZ + i);
      if (gabs(gz) <= T(3.0e38)) part += double(gz) * double(gz);
    }
    part = block_sum(part, dred);
    if (tid == 0) {
      double gn2 = part;
      for (int k = 0; k < dim; ++k) {
        const double gk = double(s_g[k]);
        if (gabs(s_g[k]) <= T(3.0e38)) gn2 += gk * gk;
      }
      dred[0] = gn2;
    }
    __syncthreads();
    const T sc = jmin(T(1), T(tc.clip) / T(sqrt(dred[0])));
    const T ta = T(tc.t0) + T(t) + T(1);
    if (tid < dim) {
      T g = s_g[tid];
      g = (gabs(g) <= T(3.0e38) ? g : T(0)) * sc;
      T pv = s_st[tid], mm = s_m[tid], vv = s_v[tid];
      adam_update(pv, g, mm, vv, ta, lr);
      s_st[tid] = pv;
      s_m[tid] = mm;
      s_v[tid] = vv;
    }
    for (int idx = tid; idx < md; idx += nt) {
      T gz = __ldcg(dZ + idx);
      gz = (gabs(gz) <= T(3.0e38) ? gz : T(0)) * sc;
      T pv = Zb[idx], mm = mzb[idx], vv = vzb[idx];
      adam_update(pv, gz, mm, vv, ta, lr);
      Zb[idx] = pv;
      mzb[idx] = mm;
      vzb[idx] = vv;
    }
    if (p == 0 && tid == 0) losses[t] = s_U;
    __syncthreads();
  }
  if (p != 0) return;
  if (tid < dim) {
    st[tid] = s_st[tid];
    m_st[tid] = s_m[tid];
    v_st[tid] = s_v[tid];
  }
  for (int i = tid; i < md; i += nt) {
    Z[i] = Zb[i];
    m_z[i] = mzb[i];
    v_z[i] = vzb[i];
  }
}

template <typename T>
int launch_sgpmc_warm_group(const double* cfg, void* st, void* Z, void* m_st, void* v_st,
                            void* m_z, void* v_z, const void* X, const void* y, void* losses,
                            void* scratch, void* stream) {
  const BoundCfg cf = bound_cfg(cfg);
  return launch_grid<true>(sgpmc_warm_group_kernel<T>, cf.group, kThreads, stream, cf,
                           train_cfg(cfg), (T*)st, (T*)Z, (T*)m_st, (T*)v_st, (T*)m_z,
                           (T*)v_z, (const T*)X, (const T*)y, (T*)losses, (T*)scratch);
}

template <typename T>
int warm_group_blocks_per_sm() {
  int nb = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, sgpmc_warm_group_kernel<T>, kThreads, 0);
  return err == cudaSuccess ? nb : -(int)err;
}

}  // namespace ggp

#define GGP_WARM_ARGS                                                        \
  const double *cfg, void *st, void *Z, void *m_st, void *v_st, void *m_z,   \
      void *v_z, const void *X, const void *y, void *losses, void *scratch,  \
      void *stream
#define GGP_WARM_PASS \
  cfg, st, Z, m_st, v_st, m_z, v_z, X, y, losses, scratch, stream

extern "C" {

// the grouped warm start: cfg[C_GROUP] blocks, one cooperative launch
int ggp_sgpmc_warm_group_f32(GGP_WARM_ARGS) {
  return ggp::launch_sgpmc_warm_group<float>(GGP_WARM_PASS);
}
int ggp_sgpmc_warm_group_f64(GGP_WARM_ARGS) {
  return ggp::launch_sgpmc_warm_group<double>(GGP_WARM_PASS);
}
int ggp_sgpmc_warm_sgpmc_group_occupancy(int f64) {
  return f64 ? ggp::warm_group_blocks_per_sm<double>() : ggp::warm_group_blocks_per_sm<float>();
}

// elements of T of the grouped warm start's scratch at (n, m, d) on G blocks
long ggp_sgpmc_warm_group_elems(int n, int m, int d, int G, int f64) {
  return f64 ? ggp::warm_group_scratch_elems<double>(n, m, d, G)
             : ggp::warm_group_scratch_elems<float>(n, m, d, G);
}
}
