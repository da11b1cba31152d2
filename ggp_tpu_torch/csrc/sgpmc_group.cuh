// The whitened JointHMC (SGPMC) potential of the Scale(RBF-ARD) x Gaussian
// x Zero-mean model, value and analytic gradient over the state row
// [log_lengthscale (d), log_outputscale, log_noise, v (m)], spread over a
// group of G thread blocks per chain: the core `SgpmcGroupCore` that the
// potential kernel, the NUTS chunk kernel and the HMC chunk kernel take as
// their `Core` at every n (instantiations in sgpmc_group.cu), and that the
// warm start (sgpmc_warm.cu) evaluates with dU/dZ.
//
// Replaces: ggp_tpu/ops/fused_bound.py `_sgpmc_neg_logpost_vg` (:1435), the
// core of fused_nuts.py's pot/warm/sample calls (sites 1-3) with
// target="sgpmc" and of fused_sgpmc.py's warm start (site 9, with
// want_z_grad), and its streamed form `_sgpmc_neg_logpost_vg_streaming`
// (:1577) past MAX_N_RESIDENT = 2048 rows; ggp_tpu/ops/fused_multichain.py
// `_sgpmc_batched_vg` and `_sgpmc_batched_vg_streaming` (:907), the cores of
// sites 10-14. The function's plain twin is ops/sgpmc_bound.py (its
// docstring has the adjoint); the plain model of this kernel's order of
// summation is ops/vfe_group.py
// `sgpmc_group_neg_logpost_vg`. With cf.want_z block 0 also forms dU/dZ in
// step D (the warm start's gradient, `_sgpmc_neg_logpost_vg` with
// want_z_grad): for RBF it needs only sums the evaluation already forms,
// the column sums of Pms^T and Pms Xs (step B) and Pmm's row sums and Pmm
// Zs (step D), so it adds no pass over the rows.
//
// What bounds it on the card: at n = 13,279, M = 100, D = 18 an evaluation
// is ~0.6 GFLOP of O(n M^2) row products (At = Knm V, (L^-T Abar)^T =
// Abar^T V^T, T = Abar A^T), which one block walks in ~39 ms (1.5 ms at
// n = 404); and the M x M part (one factorisation and inverse of Kmm, two
// M^3 products), a chain of ~2M barrier steps on one block, which sets the
// floor once the rows are spread.
//
// The design: the potential is block-additive (fused_bound.py:1587-1604):
// given V = L^-T and v, every data-coupled quantity of the gradient is a sum
// over rows. So one pass over the rows suffices, and an evaluation is four
// steps, each ended by the chain's barrier (`group_sync`, vfe_group.cuh):
//   A (all)      il, zn, Knm_b of the block's rows; block 0 also Kmm, U =
//                L^T and V = L^-T;
//   B (all)      At_b = Knm_b V; e_b = y_b - At_b v; var_b, clamped at
//                1e-12, and its mask; Abar_b^T = (e_b v^T + At_b o msk_b) /
//                s2; Pms_b^T = (Abar_b^T V^T) o Knm_b in Knm_b's place; the
//                block's partials in double: see, svar, sum msk, sum Pms,
//                A e (M), T = Abar A^T (a full M x M matrix), the column
//                sums of Pms^T (M), cs_ms^T Xs^2 (d) and Pms Xs (M x d);
//   C (all)      each block sums a slice of those entries over the G
//                partials, p = 0 .. G-1, into the chain's sums;
//   D (block 0)  the M x M epilogue: Phi = T o (strict lower + I / 2),
//                Kmm_b = -V Phi V^T symmetrised, Pmm = Kmm_b o Kmm and the
//                d + 2 + M gradient; it writes U and g to the chain's area,
//                and with cf.want_z dU/dZ to the caller's dZ;
// then every block reads U and g from there (and dZ, through L2, if it
// needs it: the grouped warm start, sgpmc_warm.cu). Every block of a chain thus
// returns the same bits, so the sampler's tree logic, which every block of
// the group runs on its own copy, takes the same decisions everywhere; only
// block 0 of a group writes the sampler's outputs. No float atomics: the M x
// M partial T is summed in slices (step C), in a fixed order. The
// lengthscale cap's max |X| is formed once per launch (`group_xmax`), its max
// |Z| once per launch from the Z the caller passes (`group_cap`).
//
// Data one block writes and another reads (V, the partials, the sums, U and
// g) is read from L2 with ld.global.cg: L1 is not coherent across SMs.
// Float32: the sums over rows run in double; the epilogue in T.
// Pivot policy: floor <= 0 gives NaN on a non-positive pivot (sampler
// divergence), floor > 0 the trainers' modified Cholesky, relative to
// max(sf2, 1).
#pragma once

#include "vfe_group.cuh"

namespace ggp {

// Sizes of one chain's work at (n, m, d) on G blocks (the count
// ggp_sgpmc_group_scratch_elems of sgpmc_group.cu; ops/vfe_group.py sizes
// a launch's scratch by it).
struct SgpmcGroupShape {
  int nb;        // rows of the largest block, ceil(n / G)
  long E;        // entries summed over the blocks: see, svar, sum msk, sum Pms,
                 // A e (m), T (m x m), colsum Pms^T (m), cs^T Xs^2 (d), Pms Xs (m x d)
  long pe;       // a block's double partials: the E entries, then its max |X|
  long t_block;  // a block's area: Knm_b / Pms_b^T, At_b, Abar_b^T (nb x m); xn,
                 // e, msk, cs (nb); zn (m)
  long t_chain;  // a chain's area: Kmm, W, U, V, T1, Kb (m x m), rs_mm (m),
                 // Pmm Zs (m x d), the E sums, U and g (1 + kMaxDim), the G
                 // block areas
};

__host__ __device__ inline SgpmcGroupShape sgpmc_group_shape(int n, int m, int d, int G) {
  SgpmcGroupShape s;
  s.nb = (n + G - 1) / G;
  s.E = 4 + 2L * m + (long)m * m + d + (long)m * d;
  s.pe = s.E + 1;
  s.t_block = 3L * s.nb * m + 4L * s.nb + m;
  s.t_chain = 6L * m * m + m + (long)m * d + s.E + 1 + kMaxDim + (long)G * s.t_block;
  return s;
}

// Bytes of one chain: its G blocks' double partials, then its T area,
// rounded to 16 bytes.
template <typename T>
__host__ __device__ inline long sgpmc_group_chain_bytes(const SgpmcGroupShape& s, int G) {
  return (long)G * s.pe * 8 + (s.t_chain * (long)sizeof(T) + 15) / 16 * 16;
}

// Elements of T of a launch's scratch for C chains: the C barriers, then the
// C chains.
template <typename T>
__host__ __device__ inline long sgpmc_group_scratch_elems(int n, int m, int d, int C, int G) {
  const long bytes = (long)C * (kBarWords * 4 +
                                sgpmc_group_chain_bytes<T>(sgpmc_group_shape(n, m, d, G), G));
  return (bytes + (long)sizeof(T) - 1) / (long)sizeof(T);
}

// What one block of a group works on.
template <typename T>
struct SgpmcGroupWork {
  T *Kmm, *W, *U, *V, *T1, *Kb;        // the chain's m x m work (block 0)
  T *rs, *pz;                          // block 0: Pmm's row sums (m), Pmm Zs (m x d)
  T *S;                                // the chain's sums of the E partial entries
  T *out;                              // the chain's U, then g (block 0 writes)
  T *Knm, *At, *Ab, *xn, *e, *msk, *cs, *zn;   // this block's rows
  double* part;                        // block 0's partials; block q's at part + q pe
  unsigned* bar;                       // the chain's barrier
  long pe;
  int p, G, row0, nr;
  T xmax;                              // max |X|
  T cap;                               // 1024 / max(1e-3, |X|, |Z|)
};

// Offsets of the E summed entries (in the partials and in the sums).
enum SgpmcSum { SG_SEE = 0, SG_SVAR, SG_SMSK, SG_SPMS, SG_AE };

// U_out = -(log posterior) and g_out = dU/dstate (d + 2 + m entries) of one
// state row st, and with cf.want_z dZ_out = dU/dZ (m x d, written by block 0
// before the group's last barrier, when dZ_out is not null): the whitened
// JointHMC potential on the chain's group. Every block of the group calls
// it with the same st (visible to all its threads) and the same dZ_out; U_out
// and g_out are visible to all threads on return. U_out is written by
// thread 0.
template <typename T>
__device__ void sgpmc_group_bound(const BoundCfg& cf, const T* st, const T* X, const T* y,
                                  const T* Z, const SgpmcGroupWork<T>& gw, BoundShared<T>& sh,
                                  T* U_out, T* g_out, T* dZ_out) {
  __shared__ T sA[kRowKC][kRowTR + 1];
  __shared__ T sB[kRowKC][kRowTC + 1];
  __shared__ double dred[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = cf.n, m = cf.m, d = cf.d, dim = d + 2 + m;
  const int G = gw.G, p = gw.p, nr = gw.nr, row0 = gw.row0;
  const bool head = p == 0;
  const long oT = SG_AE + m, oR = oT + (long)m * m, oC = oR + m, oP = oC + d, E = oP + (long)m * d;
  double* mine = gw.part + (long)p * gw.pe;        // this block's partials
  const T jitter = T(cf.jitter);
  const T* v = st + d + 2;
  T* il = sh.inv_ls;

  // A: the capped inverse lengthscales, the grams of this block's rows;
  // block 0 also Kmm and its factor
  for (int k = tid; k < d; k += nt) il[k] = jmin(gexp(-st[k]), gw.cap);
  const T sf2 = gexp(st[d]), s2 = gexp(st[d + 1]);
  const T jit_scale = jmax(sf2, T(1));
  __syncthreads();
  for (int a = tid; a < m; a += nt) {
    T q = T(0);
    for (int k = 0; k < d; ++k) { const T b = Z[a * d + k] * il[k]; q += b * b; }
    gw.zn[a] = q;
  }
  __syncthreads();
  block_knm(m, d, X, Z, gw.zn, il, sf2, row0, nr, gw.Knm, gw.xn);
  if (head) {
    for (int idx = tid; idx < m * m; idx += nt) {
      const int a = idx / m, b = idx % m;
      T dot = T(0);
      for (int k = 0; k < d; ++k) dot += (Z[a * d + k] * il[k]) * (Z[b * d + k] * il[k]);
      const T r2 = jmax(gw.zn[a] + gw.zn[b] - T(2) * dot, T(0));
      const T kab = sf2 * gexp(T(-0.5) * r2);
      gw.Kmm[idx] = kab;
      gw.W[idx] = kab + (a == b ? jitter * jit_scale : T(0));
    }
    __syncthreads();
    chol_upper(gw.W, gw.U, m, T(cf.floor) * jit_scale, cf.floor > 0.0);   // U = L^T
    ut_inv(gw.U, gw.V, m);                                                  // V = L^-T
  }
  group_sync(gw.bar, G, p);

  // B: At_b = Knm_b V (V upper: k <= j); the conditional's residual and
  // clamped variance per row; Abar_b^T; then the partials
  block_gemm<T, kRowTR, kRowTC, kRowKC, kThreads>(
      nr, m, m, gw.Knm, m, 1, gw.V, m, 1, K_TO_C, sA, sB,
      [&](int i, int j, T val) { gw.At[i * m + j] = val; }, L2Load{});
  double p_see = 0.0, p_svar = 0.0, p_msk = 0.0;
  for (int i = tid; i < nr; i += nt) {
    const T* a = gw.At + (long)i * m;
    const T mean = dot_acc<T>(a, 1, v, 1, 0, m);
    const T aa = dot_acc<T>(a, 1, a, 1, 0, m);
    const T e = y[row0 + i] - mean;
    const T var_raw = sf2 - aa;
    const T mk = var_raw > T(1e-12) ? T(1) : T(0);
    gw.e[i] = e;
    gw.msk[i] = mk;
    p_see += double(e) * double(e);
    p_svar += double(jmax(var_raw, T(1e-12)));
    p_msk += double(mk);
  }
  p_see = block_sum(p_see, dred);
  p_svar = block_sum(p_svar, dred);
  p_msk = block_sum(p_msk, dred);
  for (int idx = tid; idx < nr * m; idx += nt) {
    const int i = idx / m, a = idx % m;
    gw.Ab[idx] = (gw.e[i] * v[a] + gw.At[idx] * gw.msk[i]) / s2;
  }
  for (int a = tid; a < m; a += nt)                       // A e
    mine[SG_AE + a] = dot_acc<double>(gw.At + a, m, gw.e, 1, 0, nr);
  __syncthreads();
  // T = Abar A^T: T[a, b] = sum_i Abar^T[i, a] At[i, b], in double
  block_gemm<double, kRowTR, kRowTC, kRowKC, kThreads>(
      m, m, nr, gw.Ab, 1, m, gw.At, m, 1, K_FULL, sA, sB,
      [&](int a, int b, double val) { mine[oT + (long)a * m + b] = val; });
  // Pms^T = (Abar^T V^T) o Knm in Knm's place (V^T(k, c) = V[c, k] = 0 for k < c)
  block_gemm<T, kRowTR, kRowTC, kRowKC, kThreads>(
      nr, m, m, gw.Ab, m, 1, gw.V, 1, m, K_FROM_C, sA, sB,
      [&](int i, int a, T val) { gw.Knm[i * m + a] = val * gw.Knm[i * m + a]; }, L2Load{});
  double p_pms = 0.0;
  for (int i = tid; i < nr; i += nt) {                    // cs_ms of each row
    T c = T(0);
    for (int a = 0; a < m; ++a) c += gw.Knm[i * m + a];
    gw.cs[i] = c;
    p_pms += double(c);
  }
  p_pms = block_sum(p_pms, dred);
  for (int a = tid; a < m; a += nt) {                     // colsum Pms^T
    double acc = 0.0;
    for (int i = 0; i < nr; ++i) acc += double(gw.Knm[i * m + a]);
    mine[oR + a] = acc;
  }
  for (int k = tid; k < d; k += nt) {                     // cs^T Xs^2
    double acc = 0.0;
    for (int i = 0; i < nr; ++i) {
      const double xs = double(X[(long)(row0 + i) * d + k] * il[k]);
      acc += double(gw.cs[i]) * xs * xs;
    }
    mine[oC + k] = acc;
  }
  for (int idx = tid; idx < m * d; idx += nt) {           // Pms Xs
    const int a = idx / d, k = idx % d;
    double acc = 0.0;
    for (int i = 0; i < nr; ++i)
      acc += double(gw.Knm[i * m + a]) * double(X[(long)(row0 + i) * d + k] * il[k]);
    mine[oP + idx] = acc;
  }
  if (tid == 0) {
    mine[SG_SEE] = p_see;
    mine[SG_SVAR] = p_svar;
    mine[SG_SMSK] = p_msk;
    mine[SG_SPMS] = p_pms;
  }
  group_sync(gw.bar, G, p);

  // C: this block's slice of the sums over the G partials
  {
    const long e0 = E * p / G, e1 = E * (p + 1) / G;
    for (long e = e0 + tid; e < e1; e += nt) gw.S[e] = T(sum_partials(gw.part, gw.pe, G, e));
  }
  group_sync(gw.bar, G, p);

  // D: block 0: the M x M epilogue and the gradient
  if (head) {
    const T* S = gw.S;
    for (int idx = tid; idx < m * m; idx += nt) {         // Phi into W
      const int a = idx / m, b = idx % m;
      const T t = __ldcg(S + oT + idx);
      gw.W[idx] = a > b ? t : (a == b ? T(0.5) * t : T(0));
    }
    __syncthreads();
    // T1 = V Phi (V(a, k) = 0 for k < a; Phi(k, b) = 0 for k < b)
    block_gemm<T, kRowTR, kRowTC, kRowKC, kThreads>(
        m, m, m, gw.V, m, 1, gw.W, m, 1, K_FROM_R | K_FROM_C, sA, sB,
        [&](int a, int b, T val) { gw.T1[a * m + b] = val; });
    // Kb = -T1 V^T (V^T(k, c) = V[c, k] = 0 for k < c)
    block_gemm<T, kRowTR, kRowTC, kRowKC, kThreads>(
        m, m, m, gw.T1, m, 1, gw.V, 1, m, K_FROM_C, sA, sB,
        [&](int a, int b, T val) { gw.Kb[a * m + b] = -val; });
    // Kmm_b = (Kb + Kb^T) / 2; Pmm = Kmm_b o Kmm into W, its sum and tr Kmm_b
    T p_mm = T(0), p_tr = T(0), p_vv = T(0);
    for (int idx = tid; idx < m * m; idx += nt) {
      const int a = idx / m, b = idx % m;
      const T t = T(0.5) * (gw.Kb[a * m + b] + gw.Kb[b * m + a]);
      const T pv = t * gw.Kmm[idx];
      gw.W[idx] = pv;
      p_mm += pv;
      if (a == b) p_tr += t;
    }
    for (int a = tid; a < m; a += nt) p_vv += v[a] * v[a];
    const T S_mm = block_sum(p_mm, sh.red);
    const T tr_Kb = block_sum(p_tr, sh.red);
    const T vv = block_sum(p_vv, sh.red);
    for (int a = tid; a < m; a += nt) {                   // Pmm's row sums
      T r = T(0);
      for (int b = 0; b < m; ++b) r += gw.W[a * m + b];
      gw.rs[a] = r;
    }
    for (int idx = tid; idx < m * d; idx += nt) {         // Pmm Zs
      const int a = idx / d, k = idx % d;
      T s = T(0);
      for (int b = 0; b < m; ++b) s += gw.W[a * m + b] * (Z[b * d + k] * il[k]);
      gw.pz[idx] = s;
    }
    __syncthreads();
    const T pr = cf.want_prior ? T(1) : T(0);
    T* out = gw.out;
    // RBF-ARD chain rule to the log-lengthscales, plus the prior
    for (int k = tid; k < d; k += nt) {
      T t = __ldcg(S + oC + k);
      for (int a = 0; a < m; ++a) {
        const T zs = Z[a * d + k] * il[k];
        t += (T(2) * gw.rs[a] + __ldcg(S + oR + a)) * zs * zs
             - T(2) * zs * (gw.pz[a * d + k] + __ldcg(S + oP + a * d + k));
      }
      out[1 + k] = -(t + pr * (T(2) - gexp(st[k])));
    }
    for (int a = tid; a < m; a += nt) out[1 + d + 2 + a] = -(__ldcg(S + SG_AE + a) / s2 - v[a]);
    if (cf.want_z && dZ_out != nullptr) {                 // dU/dZ
      for (int idx = tid; idx < m * d; idx += nt) {
        const int a = idx / d, k = idx % d;
        const T zs = Z[idx] * il[k];
        const T dzs = T(-2) * (gw.rs[a] * zs - gw.pz[idx])
                      - (__ldcg(S + oR + a) * zs - __ldcg(S + oP + idx));
        dZ_out[idx] = -(dzs * il[k]);
      }
    }
    if (tid == 0) {
      const T nT = T(n);
      const T see = __ldcg(S + SG_SEE), svar = __ldcg(S + SG_SVAR);
      const T smsk = __ldcg(S + SG_SMSK), spms = __ldcg(S + SG_SPMS);
      T F = T(-0.5) * nT * glog(T(6.283185307179586) * s2) - T(0.5) * (see + svar) / s2
            - T(0.5) * vv;
      if (cf.want_prior) {
        T lp = T(0);
        for (int k = 0; k < d + 2; ++k) lp += T(2) * st[k] - gexp(st[k]);
        F += lp;
      }
      const T dF_ds2 = T(-0.5) * nT / s2 + T(0.5) * (see + svar) / (s2 * s2);
      const T dlog_os = S_mm + spms + jitter * sf2 * (sf2 > T(1) ? T(1) : T(0)) * tr_Kb
                        - T(0.5) * smsk * sf2 / s2 + pr * (T(2) - sf2);
      out[1 + d] = -dlog_os;
      out[1 + d + 1] = -(dF_ds2 * s2 + pr * (T(2) - s2));
      out[0] = -F;
    }
  }
  group_sync(gw.bar, G, p);

  // every block: U and g as block 0 wrote them
  if (tid == 0) *U_out = __ldcg(gw.out);
  for (int k = tid; k < dim; k += nt) g_out[k] = __ldcg(gw.out + 1 + k);
  __syncthreads();
}

// The grouped sgpmc core as the sampler kernels take it (see CoreGroup): the
// state row is [log_lengthscale (d), log_outputscale, log_noise, v (m)].
template <typename T>
struct SgpmcGroupCore {
  using WorkT = SgpmcGroupWork<T>;
  static __host__ __device__ int dim(const BoundCfg& cf) { return cf.d + 2 + cf.m; }

  // The work of block blockIdx.x (chain blockIdx.x / G, place p =
  // blockIdx.x % G) in the launch's scratch, and the lengthscale cap, formed
  // once per launch (group_xmax, then group_cap).
  static __device__ WorkT work(T* scratch, const BoundCfg& cf, const T* X, const T* Z,
                               BoundShared<T>& sh) {
    const int G = cf.group, C = gridDim.x / G, c = blockIdx.x / G, p = blockIdx.x % G;
    const int n = cf.n, m = cf.m, d = cf.d;
    const SgpmcGroupShape s = sgpmc_group_shape(n, m, d, G);
    const long mm = (long)m * m;
    char* base = (char*)scratch;
    char* chain = base + (long)C * kBarWords * 4 + (long)c * sgpmc_group_chain_bytes<T>(s, G);
    WorkT gw;
    gw.bar = (unsigned*)base + (long)c * kBarWords;
    gw.part = (double*)chain;
    T* t = (T*)(chain + (long)G * s.pe * 8);
    gw.Kmm = t; t += mm;
    gw.W = t; t += mm;
    gw.U = t; t += mm;
    gw.V = t; t += mm;
    gw.T1 = t; t += mm;
    gw.Kb = t; t += mm;
    gw.rs = t; t += m;
    gw.pz = t; t += (long)m * d;
    gw.S = t; t += s.E;
    gw.out = t; t += 1 + kMaxDim;
    t += (long)p * s.t_block;
    gw.Knm = t; t += (long)s.nb * m;
    gw.At = t; t += (long)s.nb * m;
    gw.Ab = t; t += (long)s.nb * m;
    gw.xn = t; t += s.nb;
    gw.e = t; t += s.nb;
    gw.msk = t; t += s.nb;
    gw.cs = t; t += s.nb;
    gw.zn = t;
    gw.pe = s.pe;
    gw.p = p;
    gw.G = G;
    gw.row0 = row_begin(n, G, p);
    gw.nr = row_begin(n, G, p + 1) - gw.row0;
    gw.xmax = group_xmax(X, d, gw.row0, gw.nr, gw.part + s.E, s.pe, gw.bar, G, p, sh);
    group_cap(gw, Z, m * d, sh);
    return gw;
  }

  static __device__ void eval(const BoundCfg& cf, const T* z, const T* X, const T* y,
                              const T* Z, const WorkT& w, BoundShared<T>& sh, T* U, T* g,
                              T* dZ) {
    sgpmc_group_bound(cf, z, X, y, Z, w, sh, U, g, dZ);
  }
};

template <>
struct CoreGroup<SgpmcGroupCore> {
  static constexpr bool value = true;
};

}  // namespace ggp
