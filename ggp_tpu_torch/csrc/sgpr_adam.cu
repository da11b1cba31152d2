// Kernel 3: whole chunks of Adam steps on the collapsed bound.
//
// Kernel 3, `sgpr_adam_chunk_kernel`, replaces ggp_tpu/ops/fused_sgpr.py
// `_sgpr_chunk_body` (:434, the resident pallas_call of `make_fused_sgpr`): K
// full-batch Adam steps on (theta, Z) of -ELBO (no prior), with the
// per-element non-finite mask, clip-by-global-norm over (theta, Z), the
// optax Adam update (bias correction continues from t0), the +-15 box on
// the log-hypers and the noise floor. BayesianSGPR_HMC's warm start runs it
// with clip 10. (The Z-only trainer of the same file, `_zadam_chunk_body`,
// runs on kernel 12, z_adam_stream.cu, at every n.)
//
// It uses the trainers' pivot policy (modified Cholesky, floor 1e-6
// relative to max(sf2, 1) on Kmm and 1e-6 on B), so a transiently
// indefinite factorisation cannot poison the Adam state.
//
// What bounds it on the card: each step is one evaluation of the bound, a
// latency chain of block barriers and L2 reads (vfe_bound.cuh); the Adam
// update is O((m + 1) d).
// What the design does about it: the whole chunk is one launch with the
// parameters and moments updated in place in global memory, so there is
// no host round trip per step.
//
// Kernel 3g, `sgpr_adam_group_kernel`, replaces ggp_tpu/ops/fused_sgpr.py
// `_sgpr_stream_chunk_body` (:420, the streamed pallas_call that
// `make_fused_sgpr` takes past 2048 rows, on the streamed core
// `_rbf_vfe_neg_logpost_vg_streaming`): the same K steps of the same
// trainer, each evaluation on the grouped vfe core (vfe_group.cuh) over G
// blocks of one cooperative launch, where one block walks every row of
// every step (~45 ms a step at n=13,279). A step is one `vfe_group_bound`
// with dU/dZ and the trainers' pivot floor, then: each block sums its slice
// of dU/dZ's partials (m d / G entries, in the order p = 0 .. G-1) and the
// masked squares of that slice; after the group's barrier every block sums
// the G squares in that order and adds theta's, so the clip factor is the
// same bits everywhere; every block takes the same Adam step on theta (in
// shared memory; block 0 writes it at the end) and its own slice of (Z,
// m_z, v_z) in place; after another barrier each block copies the new Z
// through L2 into its own area, from which the next evaluation reads it
// (and forms the lengthscale cap anew, group_cap: Z changes in the launch).
#include "adam.cuh"
#include "vfe_group.cuh"

namespace ggp {

template <typename T>
__global__ void __launch_bounds__(kThreads)
sgpr_adam_chunk_kernel(BoundCfg cf, TrainCfg tc, T* theta, T* Z, T* m_th,
                       T* v_th, T* m_z, T* v_z, const T* X, const T* y,
                       T* losses, T* scratch) {
  __shared__ BoundShared<T> sh;
  __shared__ T s_theta[kMaxDim];
  __shared__ T s_g[kMaxDim];
  __shared__ T s_U;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int d = cf.d, dim = d + 2, md = cf.m * d;
  const Work<T> w = make_work(scratch, cf.n, cf.m, d);
  T* dZ = scratch + work_elems(cf.n, cf.m, d);
  const T lr = T(tc.lr), log_floor = glog(T(tc.min_noise));
  if (tid < dim) s_theta[tid] = theta[tid];
  __syncthreads();

  for (int t = 0; t < tc.K; ++t) {
    vfe_bound(cf, s_theta, X, y, Z, w, sh, &s_U, s_g, dZ);
    // global norm over (theta, Z) of the masked gradient
    T part = T(0);
    for (int idx = tid; idx < md; idx += nt) {
      const T gz = dZ[idx];
      if (gabs(gz) <= T(3.0e38)) part += gz * gz;
    }
    T gn2 = block_sum(part, sh.red);
    for (int k = 0; k < dim; ++k) {
      const T gk = s_g[k];
      if (gabs(gk) <= T(3.0e38)) gn2 += gk * gk;
    }
    const T sc = jmin(T(1), T(tc.clip) / gsqrt(gn2));
    const T ta = T(tc.t0) + T(t) + T(1);
    if (tid < dim) {
      T gk = s_g[tid];
      gk = (gabs(gk) <= T(3.0e38) ? gk : T(0)) * sc;
      T p = s_theta[tid], mm = m_th[tid], vv = v_th[tid];
      adam_update(p, gk, mm, vv, ta, lr);
      p = jmin(jmax(p, T(-15)), T(15));
      if (tid == d + 1) p = jmax(p, log_floor);
      s_theta[tid] = p;
      m_th[tid] = mm;
      v_th[tid] = vv;
    }
    for (int idx = tid; idx < md; idx += nt) {
      T gz = dZ[idx];
      gz = (gabs(gz) <= T(3.0e38) ? gz : T(0)) * sc;
      T p = Z[idx], mm = m_z[idx], vv = v_z[idx];
      adam_update(p, gz, mm, vv, ta, lr);
      Z[idx] = p;
      m_z[idx] = mm;
      v_z[idx] = vv;
    }
    if (tid == 0) losses[t] = s_U;
    __syncthreads();
  }
  if (tid < dim) theta[tid] = s_theta[tid];
}

// Bytes of the grouped trainer's scratch before its own areas: the grouped
// core's scratch of one chain, rounded to 16 bytes.
template <typename T>
__host__ __device__ inline long trainer_core_bytes(int n, int m, int d, int G) {
  return (group_scratch_elems<T>(n, m, d, 1, G) * (long)sizeof(T) + 15) / 16 * 16;
}

// Elements of T of the grouped trainer's scratch: the grouped core's, then
// the G squared-norm partials (double), dU/dZ (m d) and each block's copy of
// Z (G m d).
template <typename T>
__host__ __device__ inline long trainer_scratch_elems(int n, int m, int d, int G) {
  const long bytes = trainer_core_bytes<T>(n, m, d, G) + (long)G * 8
                     + (long)m * d * (1 + G) * (long)sizeof(T);
  return (bytes + (long)sizeof(T) - 1) / (long)sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sgpr_adam_group_kernel(BoundCfg cf, TrainCfg tc, T* theta, T* Z, T* m_th, T* v_th, T* m_z,
                       T* v_z, const T* X, const T* y, T* losses, T* scratch) {
  __shared__ BoundShared<T> sh;
  __shared__ T s_theta[kMaxDim], s_m[kMaxDim], s_v[kMaxDim];
  __shared__ T s_g[kMaxDim];
  __shared__ T s_U;
  __shared__ double dred[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int d = cf.d, dim = d + 2, md = cf.m * d;
  const int G = cf.group, p = blockIdx.x;
  char* ex = (char*)scratch + trainer_core_bytes<T>(cf.n, cf.m, d, G);
  double* nrm = (double*)ex;
  T* dZ = (T*)(nrm + G);
  T* Zb = dZ + md + (long)p * md;                    // this block's copy of Z
  const long z0 = (long)md * p / G, z1 = (long)md * (p + 1) / G;
  for (int i = tid; i < md; i += nt) Zb[i] = Z[i];
  if (tid < dim) {
    s_theta[tid] = theta[tid];
    s_m[tid] = m_th[tid];
    s_v[tid] = v_th[tid];
  }
  __syncthreads();
  GroupWork<T> gw = VfeGroupCore<T>::work(scratch, cf, X, Zb, sh);
  const T lr = T(tc.lr), log_floor = glog(T(tc.min_noise));

  for (int t = 0; t < tc.K; ++t) {
    if (t > 0) {                // the Z the slices' owners wrote, and its cap
      for (int i = tid; i < md; i += nt) Zb[i] = __ldcg(Z + i);
      __syncthreads();
      group_cap(gw, Zb, md, sh);
    }
    vfe_group_bound(cf, s_theta, X, y, Zb, gw, sh, &s_U, s_g, dZ);
    // global norm over (theta, Z) of the masked gradient: this block's slice
    double part = 0.0;
    for (long i = z0 + tid; i < z1; i += nt) {
      const T gz = dZ[i];
      if (gabs(gz) <= T(3.0e38)) part += double(gz) * double(gz);
    }
    part = block_sum(part, dred);
    if (tid == 0) nrm[p] = part;
    group_sync(gw.bar, G, p);
    if (tid == 0) {
      double gn2 = sum_partials(nrm, 1, G, 0);
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
      T gk = s_g[tid];
      gk = (gabs(gk) <= T(3.0e38) ? gk : T(0)) * sc;
      T pv = s_theta[tid], mm = s_m[tid], vv = s_v[tid];
      adam_update(pv, gk, mm, vv, ta, lr);
      pv = jmin(jmax(pv, T(-15)), T(15));
      if (tid == d + 1) pv = jmax(pv, log_floor);
      s_theta[tid] = pv;
      s_m[tid] = mm;
      s_v[tid] = vv;
    }
    for (long idx = z0 + tid; idx < z1; idx += nt) {
      T gz = dZ[idx];
      gz = (gabs(gz) <= T(3.0e38) ? gz : T(0)) * sc;
      T pv = Zb[idx], mm = m_z[idx], vv = v_z[idx];
      adam_update(pv, gz, mm, vv, ta, lr);
      Z[idx] = pv;
      m_z[idx] = mm;
      v_z[idx] = vv;
    }
    if (p == 0 && tid == 0) losses[t] = s_U;
    group_sync(gw.bar, G, p);
  }
  if (p == 0 && tid < dim) {
    theta[tid] = s_theta[tid];
    m_th[tid] = s_m[tid];
    v_th[tid] = s_v[tid];
  }
}

template <typename T>
int launch_sgpr_adam(const double* cfg, void* theta, void* Z, void* m_th,
                     void* v_th, void* m_z, void* v_z, const void* X,
                     const void* y, void* losses, void* scratch, void* stream) {
  sgpr_adam_chunk_kernel<T><<<1, kThreads, 0, (cudaStream_t)stream>>>(
      bound_cfg(cfg), train_cfg(cfg), (T*)theta, (T*)Z, (T*)m_th, (T*)v_th,
      (T*)m_z, (T*)v_z, (const T*)X, (const T*)y, (T*)losses, (T*)scratch);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sgpr_adam_group(const double* cfg, void* theta, void* Z, void* m_th, void* v_th,
                           void* m_z, void* v_z, const void* X, const void* y, void* losses,
                           void* scratch, void* stream) {
  const BoundCfg cf = bound_cfg(cfg);
  return launch_grid<true>(sgpr_adam_group_kernel<T>, cf.group, kThreads, stream, cf,
                           train_cfg(cfg), (T*)theta, (T*)Z, (T*)m_th, (T*)v_th, (T*)m_z,
                           (T*)v_z, (const T*)X, (const T*)y, (T*)losses, (T*)scratch);
}

template <typename T>
int trainer_group_blocks_per_sm() {
  int nb = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, sgpr_adam_group_kernel<T>, kThreads, 0);
  return err == cudaSuccess ? nb : -(int)err;
}

}  // namespace ggp

extern "C" {

int ggp_sgpr_adam_f32(const double* cfg, void* theta, void* Z, void* m_th,
                      void* v_th, void* m_z, void* v_z, const void* X,
                      const void* y, void* losses, void* scratch, void* stream) {
  return ggp::launch_sgpr_adam<float>(cfg, theta, Z, m_th, v_th, m_z, v_z, X, y,
                                      losses, scratch, stream);
}

int ggp_sgpr_adam_f64(const double* cfg, void* theta, void* Z, void* m_th,
                      void* v_th, void* m_z, void* v_z, const void* X,
                      const void* y, void* losses, void* scratch, void* stream) {
  return ggp::launch_sgpr_adam<double>(cfg, theta, Z, m_th, v_th, m_z, v_z, X, y,
                                       losses, scratch, stream);
}

// the grouped trainer: cfg[C_GROUP] blocks, one cooperative launch
int ggp_sgpr_adam_group_f32(const double* cfg, void* theta, void* Z, void* m_th,
                            void* v_th, void* m_z, void* v_z, const void* X,
                            const void* y, void* losses, void* scratch, void* stream) {
  return ggp::launch_sgpr_adam_group<float>(cfg, theta, Z, m_th, v_th, m_z, v_z, X, y,
                                            losses, scratch, stream);
}

int ggp_sgpr_adam_group_f64(const double* cfg, void* theta, void* Z, void* m_th,
                            void* v_th, void* m_z, void* v_z, const void* X,
                            const void* y, void* losses, void* scratch, void* stream) {
  return ggp::launch_sgpr_adam_group<double>(cfg, theta, Z, m_th, v_th, m_z, v_z, X, y,
                                             losses, scratch, stream);
}

int ggp_sgpr_adam_vfe_group_occupancy(int f64) {
  return f64 ? ggp::trainer_group_blocks_per_sm<double>()
             : ggp::trainer_group_blocks_per_sm<float>();
}

// elements of T of the grouped trainer's scratch at (n, m, d) on G blocks
long ggp_sgpr_adam_group_elems(int n, int m, int d, int G, int f64) {
  return f64 ? ggp::trainer_scratch_elems<double>(n, m, d, G)
             : ggp::trainer_scratch_elems<float>(n, m, d, G);
}

}  // extern "C"
