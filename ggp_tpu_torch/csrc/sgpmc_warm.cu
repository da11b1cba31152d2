// Kernel 6: the JointHMC (SGPMC) warm start, K Adam steps on (state, Z) in
// one launch, state = [log_lengthscale (d), log_outputscale, log_noise,
// v (m)].
//
// Replaces: ggp_tpu/ops/fused_sgpmc.py `_warm_chunk_body` (the pallas_call
// of `make_fused_sgpmc_warm`), which replicates the optax chain of
// `SGPMC.warm_start`. Each step evaluates the loss -(loglik - ||v||^2 / 2),
// with no hyperprior, and its gradient in (state, Z) (sgpmc_bound.cuh with
// want_z, want_prior=0 and the trainers' pivot floor); zeroes the
// non-finite gradient entries one by one; scales the whole (state, Z)
// gradient by min(1, clip / ||g||) (one global norm); and takes the optax
// Adam step at t = t0 + step + 1. There is no box on the log-hypers and no
// noise floor (unlike sgpr_adam.cu).
//
// What bounds it on the card: each step is one evaluation of the sgpmc
// core, a latency chain of block barriers and L2 reads (sgpmc_bound.cuh);
// the Adam update is O((m + 1) d) and the norm one block reduction. What
// the design does about it: the whole chunk is one launch with state, Z and
// both Adam moments updated in place in global memory (state also in
// shared memory), so there is no host round trip per step; the Z the
// launch returns is the contiguous (m, d) array the sampler launches read.
#include "adam.cuh"
#include "sgpmc_bound.cuh"

namespace ggp {

template <typename T>
__global__ void __launch_bounds__(kThreads)
sgpmc_warm_kernel(BoundCfg cf, TrainCfg tc, T* st, T* Z, T* m_st, T* v_st,
                  T* m_z, T* v_z, const T* X, const T* y, T* losses,
                  T* scratch) {
  __shared__ BoundShared<T> sh;
  __shared__ T s_st[kMaxDim];
  __shared__ T s_g[kMaxDim];
  __shared__ T s_U;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int dim = cf.d + 2 + cf.m, md = cf.m * cf.d;
  const SgpmcWork<T> w = make_sgpmc_work(scratch, cf.n, cf.m, cf.d);
  T* dZ = scratch + sgpmc_work_elems(cf.n, cf.m, cf.d);
  const T lr = T(tc.lr);
  if (int k = tid; k < dim) s_st[k] = st[k];
  __syncthreads();

  for (int t = 0; t < tc.K; ++t) {
    sgpmc_bound(cf, s_st, X, y, Z, w, sh, &s_U, s_g, dZ);
    // one global norm over (state, Z) of the masked gradient
    T part = T(0);
    if (int k = tid; k < dim) {
      const T g = s_g[k];
      if (gabs(g) <= T(3.0e38)) part += g * g;
    }
    for (int idx = tid; idx < md; idx += nt) {
      const T g = dZ[idx];
      if (gabs(g) <= T(3.0e38)) part += g * g;
    }
    const T gn = gsqrt(block_sum(part, sh.red));
    const T sc = jmin(T(1), T(tc.clip) / gn);
    const T ta = T(tc.t0) + T(t) + T(1);
    if (int k = tid; k < dim) {
      T g = s_g[k];
      g = (gabs(g) <= T(3.0e38) ? g : T(0)) * sc;
      T p = s_st[k], mm = m_st[k], vv = v_st[k];
      adam_update(p, g, mm, vv, ta, lr);
      s_st[k] = p;
      m_st[k] = mm;
      v_st[k] = vv;
    }
    for (int idx = tid; idx < md; idx += nt) {
      T g = dZ[idx];
      g = (gabs(g) <= T(3.0e38) ? g : T(0)) * sc;
      T p = Z[idx], mm = m_z[idx], vv = v_z[idx];
      adam_update(p, g, mm, vv, ta, lr);
      Z[idx] = p;
      m_z[idx] = mm;
      v_z[idx] = vv;
    }
    if (tid == 0) losses[t] = s_U;
    __syncthreads();
  }
  if (int k = tid; k < dim) st[k] = s_st[k];
}

template <typename T>
int launch_sgpmc_warm(const double* cfg, void* st, void* Z, void* m_st,
                      void* v_st, void* m_z, void* v_z, const void* X,
                      const void* y, void* losses, void* scratch, void* stream) {
  sgpmc_warm_kernel<T><<<1, kThreads, 0, (cudaStream_t)stream>>>(
      bound_cfg(cfg), train_cfg(cfg), (T*)st, (T*)Z, (T*)m_st, (T*)v_st,
      (T*)m_z, (T*)v_z, (const T*)X, (const T*)y, (T*)losses, (T*)scratch);
  return (int)cudaGetLastError();
}

}  // namespace ggp

#define GGP_WARM_ARGS                                                        \
  const double *cfg, void *st, void *Z, void *m_st, void *v_st, void *m_z,   \
      void *v_z, const void *X, const void *y, void *losses, void *scratch,  \
      void *stream
#define GGP_WARM_PASS \
  cfg, st, Z, m_st, v_st, m_z, v_z, X, y, losses, scratch, stream

extern "C" {
int ggp_sgpmc_warm_f32(GGP_WARM_ARGS) {
  return ggp::launch_sgpmc_warm<float>(GGP_WARM_PASS);
}
int ggp_sgpmc_warm_f64(GGP_WARM_ARGS) {
  return ggp::launch_sgpmc_warm<double>(GGP_WARM_PASS);
}
}
