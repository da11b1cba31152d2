// Kernels 7-9: whole chunks of SVGP / BayesianSVGP minibatch Adam steps,
// K steps per launch, each step's gradient (svgp_core.cuh) and optax Adam
// update (adam.cuh) inside the kernel.
//
// Kernel 7, `svi_chunk_kernel` with a single latent, replaces
// ggp_tpu/ops/fused_svi.py `_svi_chunk_body` (the pallas_call of
// `make_fused_svi`, fused_svi.py:1012): Gaussian, Bernoulli-probit (20-node
// Gauss-Hermite, log Phi and the Mills ratio from erfcx/erfc) and Poisson
// (lgamma(y + 1) in the kernel) data terms, chosen by cfg[C_LIK].
// Kernel 8, the same kernel with C >= 2 latents and the softmax term,
// replaces `_svi_softmax_chunk_body` (fused_svi.py:660): the C latents share
// Kmm's factor and A; the data term averages over 2 n_half signed copies of
// each step's eps rows (K, n_half, nb, C).
// Kernel 9, `bsvgp_chunk_kernel`, replaces `_bsvgp_chunk_body`
// (fused_svi.py:873): per step, S <= 8 hyper draws theta_s = mu + L eps_s
// (eps (K, S, h), h = d + 2, layout [log_os, log_ls (d), log_noise_std]),
// the Gaussian core per draw with hyp = [theta[1:d+1], theta[0],
// 2 theta[d+1]], the reparameterisation chain and KL(q(theta) || N(0, pv I)).
//
// The minibatch is gathered in the kernel from the resident X and y by an
// index array of K nb entries, one row per step. Parameters and moments are
// updated in place (hypers also in shared memory); the wrapper passes copies.
//
// What bounds them on the card: each step is one (kernels 7, 8) or S
// (kernel 9) sequential evaluations of the core, a latency chain of block
// barriers and L2 reads; the Adam update is O(m^2 C + m d). What the design
// does about it: the whole chunk, at least one epoch, is one launch, so
// there is no host round trip per step.
#include "svgp_core.cuh"

namespace ggp {

template <typename T>
__device__ void zero_grads(const SviWork<T>& w, int m, int d, int C) {
  for (int e = threadIdx.x; e < m * d; e += blockDim.x) w.gZ[e] = T(0);
  for (int e = threadIdx.x; e < m * C; e += blockDim.x) w.gqmu[e] = T(0);
  for (long e = threadIdx.x; e < (long)C * m * m; e += blockDim.x) w.gqraw[e] = T(0);
  __syncthreads();
}

// Adam on Z, q_mu and q_raw from the gradients in w
template <typename T>
__device__ void adam_inducing(const SviWork<T>& w, int m, int d, int C, T* Z, T* qmu,
                              T* qraw, T* mz, T* vz, T* mq, T* vq, T* mr, T* vr, T ta, T lr) {
  for (int e = threadIdx.x; e < m * d; e += blockDim.x)
    adam_update(Z[e], w.gZ[e], mz[e], vz[e], ta, lr);
  for (int e = threadIdx.x; e < m * C; e += blockDim.x)
    adam_update(qmu[e], w.gqmu[e], mq[e], vq[e], ta, lr);
  for (long e = threadIdx.x; e < (long)C * m * m; e += blockDim.x)
    adam_update(qraw[e], w.gqraw[e], mr[e], vr[e], ta, lr);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
svi_chunk_kernel(SviCfg cf, T* hyp, T* Z, T* qmu, T* qraw, T* mh, T* mz, T* mq, T* mr,
                 T* vh, T* vz, T* vq, T* vr, const T* X, const T* y, const int* idx,
                 const T* eps, T* losses, T* scratch) {
  __shared__ SviShared<T> sh;
  const int tid = threadIdx.x;
  const int m = cf.m, d = cf.d, C = cf.C, nb = cf.nb;
  const int hdim = cf.lik == L_GAUSS ? d + 2 : d + 1;
  const SviWork<T> w = make_svi_work(scratch, m, nb, d, C);
  const T lr = T(cf.lr);
  if (tid < hdim) sh.hyp[tid] = hyp[tid];
  for (int t = 0; t < cf.K; ++t) {
    zero_grads(w, m, d, C);
    const T* eps_t = eps == nullptr ? nullptr : eps + (long)t * cf.nhalf * nb * C;
    svgp_core(cf, Z, qmu, qraw, X, y, idx + (long)t * nb, eps_t, w, sh, T(1));
    const T ta = T(cf.t0) + T(t) + T(1);
    if (tid < hdim) adam_update(sh.hyp[tid], sh.g[tid], mh[tid], vh[tid], ta, lr);
    adam_inducing(w, m, d, C, Z, qmu, qraw, mz, vz, mq, vq, mr, vr, ta, lr);
    if (tid == 0) losses[t] = sh.loss;
    __syncthreads();
  }
  if (tid < hdim) hyp[tid] = sh.hyp[tid];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bsvgp_chunk_kernel(SviCfg cf, T* hmu, T* Lraw, T* Z, T* qmu, T* qraw, T* m_hmu, T* m_L,
                   T* mz, T* mq, T* mr, T* v_hmu, T* v_L, T* vz, T* vq, T* vr,
                   const T* X, const T* y, const int* idx, const T* eps, T* losses,
                   T* scratch) {
  __shared__ SviShared<T> sh;
  __shared__ T s_hmu[kMaxDim];
  __shared__ T s_th[kMaxDraws * kMaxDim];   // theta_s = hmu + L_h eps_s
  __shared__ T s_G[kMaxDraws * kMaxDim];    // d loss_s / d theta_s
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m = cf.m, d = cf.d, nb = cf.nb, S = cf.S, h = d + 2;
  const SviWork<T> w = make_svi_work(scratch, m, nb, d, 1);
  const T lr = T(cf.lr), inv_s = T(1.0 / S), pv = T(cf.prior_var);
  if (tid < h) s_hmu[tid] = hmu[tid];
  for (int t = 0; t < cf.K; ++t) {
    zero_grads(w, m, d, 1);
    const T* eps_t = eps + (long)t * S * h;
    for (int e = tid; e < S * h; e += nt) {
      const int s = e / h, j = e % h;
      T th = s_hmu[j] + gexp(Lraw[j * h + j]) * eps_t[s * h + j];
      for (int l = 0; l < j; ++l) th += Lraw[j * h + l] * eps_t[s * h + l];
      s_th[e] = th;
    }
    __syncthreads();
    T lacc = T(0);
    for (int s = 0; s < S; ++s) {
      const T* th = s_th + s * h;
      if (tid < d) sh.hyp[tid] = th[tid + 1];
      else if (tid == d) sh.hyp[d] = th[0];
      else if (tid == d + 1) sh.hyp[d + 1] = T(2) * th[d + 1];
      __syncthreads();
      svgp_core(cf, Z, qmu, qraw, X, y, idx + (long)t * nb, (const T*)nullptr, w, sh, inv_s);
      lacc = lacc + inv_s * sh.loss;
      if (tid < h) s_G[s * h + tid] = tid == 0 ? sh.g[d] : (tid <= d ? sh.g[tid - 1]
                                                                    : T(2) * sh.g[d + 1]);
      __syncthreads();
    }
    // KL(N(hmu, L_h L_h^T) || N(0, pv I))
    T p_L = T(0), p_mu = T(0), p_dr = T(0);
    for (int e = tid; e < h * h; e += nt) {
      const int j = e / h, l = e % h;
      if (l > j) continue;
      const T v = l == j ? gexp(Lraw[e]) : Lraw[e];
      p_L += v * v;
    }
    for (int j = tid; j < h; j += nt) {
      p_mu += s_hmu[j] * s_hmu[j];
      p_dr += Lraw[j * h + j];
    }
    const T L2 = block_sum(p_L, sh.red), mu2 = block_sum(p_mu, sh.red);
    const T dr = block_sum(p_dr, sh.red);
    const T klh = T(0.5) * (L2 / pv + mu2 / pv - T(h) - T(2) * dr + T(h) * glog(pv));
    const T ta = T(cf.t0) + T(t) + T(1);
    // the reparameterisation chain: dtheta_s/dhmu = I, dtheta_s/dL = eps_s
    if (tid < h) {
      T g = T(0);
      for (int s = 0; s < S; ++s) g += s_G[s * h + tid];
      adam_update(s_hmu[tid], inv_s * g + s_hmu[tid] / pv, m_hmu[tid], v_hmu[tid], ta, lr);
    }
    for (int e = tid; e < h * h; e += nt) {
      const int j = e / h, l = e % h;
      T g = T(0);
      if (l <= j) {
        T ge = T(0);
        for (int s = 0; s < S; ++s) ge += s_G[s * h + j] * eps_t[s * h + l];
        const T Ljl = l == j ? gexp(Lraw[e]) : Lraw[e];
        g = inv_s * ge + Ljl / pv;
        if (l == j) g = g * Ljl - T(1);                   // through exp, with the logdet term
      }
      adam_update(Lraw[e], g, m_L[e], v_L[e], ta, lr);
    }
    adam_inducing(w, m, d, 1, Z, qmu, qraw, mz, vz, mq, vq, mr, vr, ta, lr);
    if (tid == 0) losses[t] = lacc + klh;
    __syncthreads();
  }
  if (tid < h) hmu[tid] = s_hmu[tid];
}

}  // namespace ggp

#define GGP_SVI_ARGS                                                               \
  const double *cfg, void *hyp, void *Z, void *qmu, void *qraw, void *mh, void *mz, \
      void *mq, void *mr, void *vh, void *vz, void *vq, void *vr, const void *X,    \
      const void *y, const void *idx
#define GGP_SVI_LAUNCH(T, EPS)                                                        \
  ggp::svi_chunk_kernel<T><<<1, ggp::kThreads, 0, (cudaStream_t)stream>>>(            \
      ggp::svi_cfg(cfg), (T *)hyp, (T *)Z, (T *)qmu, (T *)qraw, (T *)mh, (T *)mz,     \
      (T *)mq, (T *)mr, (T *)vh, (T *)vz, (T *)vq, (T *)vr, (const T *)X,             \
      (const T *)y, (const int *)idx, (const T *)(EPS), (T *)losses, (T *)scratch);   \
  return (int)cudaGetLastError()
#define GGP_BSVGP_ARGS                                                               \
  const double *cfg, void *hmu, void *Lraw, void *Z, void *qmu, void *qraw,          \
      void *m_hmu, void *m_L, void *mz, void *mq, void *mr, void *v_hmu, void *v_L,  \
      void *vz, void *vq, void *vr, const void *X, const void *y, const void *idx,   \
      const void *eps, void *losses, void *scratch, void *stream
#define GGP_BSVGP_LAUNCH(T)                                                           \
  ggp::bsvgp_chunk_kernel<T><<<1, ggp::kThreads, 0, (cudaStream_t)stream>>>(          \
      ggp::svi_cfg(cfg), (T *)hmu, (T *)Lraw, (T *)Z, (T *)qmu, (T *)qraw,            \
      (T *)m_hmu, (T *)m_L, (T *)mz, (T *)mq, (T *)mr, (T *)v_hmu, (T *)v_L,          \
      (T *)vz, (T *)vq, (T *)vr, (const T *)X, (const T *)y, (const int *)idx,        \
      (const T *)eps, (T *)losses, (T *)scratch);                                      \
  return (int)cudaGetLastError()

extern "C" {
int ggp_svi_chunk_f32(GGP_SVI_ARGS, void *losses, void *scratch, void *stream) {
  GGP_SVI_LAUNCH(float, nullptr);
}
int ggp_svi_chunk_f64(GGP_SVI_ARGS, void *losses, void *scratch, void *stream) {
  GGP_SVI_LAUNCH(double, nullptr);
}
int ggp_svi_softmax_chunk_f32(GGP_SVI_ARGS, const void *eps, void *losses, void *scratch,
                              void *stream) {
  GGP_SVI_LAUNCH(float, eps);
}
int ggp_svi_softmax_chunk_f64(GGP_SVI_ARGS, const void *eps, void *losses, void *scratch,
                              void *stream) {
  GGP_SVI_LAUNCH(double, eps);
}
int ggp_bsvgp_chunk_f32(GGP_BSVGP_ARGS) { GGP_BSVGP_LAUNCH(float); }
int ggp_bsvgp_chunk_f64(GGP_BSVGP_ARGS) { GGP_BSVGP_LAUNCH(double); }
long ggp_svi_scratch_elems(int m, int nb, int d, int C) {
  return ggp::svi_work_elems(m, nb, d, C);
}
}
