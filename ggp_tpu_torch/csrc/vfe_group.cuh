// The collapsed bound of vfe_bound.cuh spread over a group of G thread
// blocks per chain: the core `VfeGroupCore` that the potential kernel
// (vfe_potential.cu) and the NUTS chunk kernel (nuts_chunk.cu) take as their
// `Core` where the JAX package streams the vfe core.
//
// Replaces: ggp_tpu/ops/fused_bound.py `_rbf_vfe_neg_logpost_vg_streaming`
// (:1090), the core of fused_nuts.py's pot/warm/sample calls (sites 1-3)
// past MAX_N_RESIDENT = 2048 rows, and ggp_tpu/ops/fused_multichain.py
// `_rbf_vfe_batched_vg_streaming` (:572), the core of sites 10-12 past
// MAX_N_MULTICHAIN = 1024 rows. Those stream X through VMEM in row blocks;
// the function is the resident core's, `vfe_bound`'s here.
//
// What bounds it on the card: at n = 13,279, M = 100, D = 18 an evaluation
// is ~0.8 GFLOP of O(n M^2) products over rows (the grams Knm, An = Knm
// L^-T / sigma, B = An^T An + I, dF/dKnm), which one block walks in ~39 ms;
// and the M x M part (two factorisations and inverses, three substitutions,
// four M^3 products), a chain of ~M barrier steps that only one block can
// take and that sets the floor (~2 ms at M = 100).
//
// The design: chain c runs on blocks c G .. c G + G - 1 of one cooperative
// launch (every block co-resident, so a block may wait on another). Block p
// of the group owns the rows row_begin(n, G, p) .. row_begin(n, G, p + 1)
// and keeps their Knm_b and An_b in its area. One evaluation is five steps,
// each ended by the chain's own barrier (`group_sync`; chains never wait on
// each other, whose trees differ in length):
//   A (all)       il, zn, Knm_b; block 0 also Kmm, U = L^T and V = L^-T;
//   B (all)       An_b = Knm_b V / sigma; the block's partials of B - I
//                 (packed upper triangle), u = An^T y and y^T y, in double;
//   C (all)       each block sums a slice of the entries over the G
//                 partials, p = 0 .. G-1, into the chain's B, u and yy;
//   D (block 0)   collapsed_mm (F, v, w, Y1, dF/dKmm) and the M x M terms of
//                 the gradient;
//   E (all)       alpha_b, Pnm_b = dF/dKnm_b o Knm_b and the partials of
//                 |alpha|^2, sum Pnm, the d column sums of QnmX and (want_z)
//                 GnmZ, in double;
// then every block sums the pass-2 partials in the order p = 0 .. G-1 and
// forms U and g itself. Identical inputs summed in one order give identical
// bits in every block, so the sampler's tree logic, which every block of the
// group runs on its own copy, takes the same decisions everywhere: no
// decision is broadcast, and every block reaches every barrier. Only block 0
// writes U and g; dU/dZ (want_z) is reduced in slices, block p summing the
// G partials of entries m d p / G .. m d (p + 1) / G - 1 and writing them.
// The lengthscale cap's max |X| is formed once per launch (X does not change
// inside one), its max |Z| by `group_cap` from the Z the caller passes: once
// per launch in the sampler kernels, every step in the grouped trainer
// (sgpr_adam.cu), whose Z changes inside the launch.
//
// Data one block writes and another reads inside the launch (V, Y1, v, w,
// the chain's scalars and every partial) is read from L2 with ld.global.cg
// (L2Load, sum_partials): L1 is not coherent across SMs. Block 0 copies B
// and u in through L2 before collapsed_mm reads them with plain loads.
//
// Float32: as vfe_bound, sums over rows in double and the gradient's pair
// sums in difference form.
#pragma once

#include <cstdio>

#include "row_blocks.cuh"

namespace ggp {

constexpr int kBarWords = 32;       // one 128-byte line per chain's barrier
constexpr int kGroupScal = 8;       // chain scalars before QmmZ's d column sums
enum GroupScalar { G_F = 0, G_TRBINV, G_TTERM, G_SMM, G_TRDK, G_YY };
// a block that waits longer than this at a barrier traps
constexpr unsigned long long kSpinNs = 10ull * 1000 * 1000 * 1000;

// Sizes of one chain's work at (n, m, d) on G blocks (mirrored by
// ggp_tpu_torch/ops/vfe_group.py scratch_elems).
struct GroupShape {
  int nb;        // rows of the largest block, ceil(n / G)
  long p1;       // a block's pass-1 partials: B - I packed, u, yy
  long pe;       // a block's partials: pass 1, its max |X|, pass 2 (|alpha|^2,
                 // sum Pnm, QnmX's d column sums, GnmZ m x d)
  long t_block;  // a block's area: Knm_b, An_b (nb x m), xn / alpha (nb), zn
                 // (m), QnmX (nb x d)
  long t_chain;  // a chain's T area: Work (n = 0), scalars, the G block areas
};

__host__ __device__ inline GroupShape group_shape(int n, int m, int d, int G) {
  GroupShape s;
  s.nb = (n + G - 1) / G;
  s.p1 = (long)m * (m + 1) / 2 + m + 1;
  s.pe = s.p1 + 1 + 2 + d + (long)m * d;
  s.t_block = 2L * s.nb * m + s.nb + m + (long)s.nb * d;
  s.t_chain = work_elems(0, m, d) + kGroupScal + kMaxDim + (long)G * s.t_block;
  return s;
}

// Bytes of one chain: its G blocks' double partials, then its T area,
// rounded to 16 bytes.
template <typename T>
__host__ __device__ inline long group_chain_bytes(const GroupShape& s, int G) {
  return (long)G * s.pe * 8 + (s.t_chain * (long)sizeof(T) + 15) / 16 * 16;
}

// Elements of T of a launch's scratch for C chains: the C barriers, then the
// C chains.
template <typename T>
__host__ __device__ inline long group_scratch_elems(int n, int m, int d, int C, int G) {
  const long bytes =
      (long)C * (kBarWords * 4 + group_chain_bytes<T>(group_shape(n, m, d, G), G));
  return (bytes + (long)sizeof(T) - 1) / (long)sizeof(T);
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The barrier of one chain's G blocks: a 32-bit word, zeroed by the wrapper
// before the launch, to which block 0 adds 2^31 - (G - 1) and every other
// block 1, so that bit 31 flips exactly when all G have arrived (the scheme
// of cooperative_groups' grid barrier, per chain). Thread 0 fences, arrives
// and spins on a volatile load; the block then passes. A wait beyond kSpinNs
// traps with a message instead of hanging the launch.
__device__ inline void group_sync(unsigned* bar, int G, int p) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = p == 0 ? 0x80000000u - (unsigned)(G - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(bar, add);
    const volatile unsigned* vb = bar;
    const unsigned long long t0 = global_ns();
    while (((old ^ *vb) & 0x80000000u) == 0) {
      __nanosleep(128);
      if (global_ns() - t0 > kSpinNs) {
        printf("group_sync: block %d of a group of %d waited over %llu ns at a barrier\n", p,
               G, kSpinNs);
        __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// max |X| over the n rows of a chain, formed once per launch by its G
// blocks: block p takes the max over its nr rows from row0 and writes it to
// slot[p * stride] (a double of its partials area); after the chain's
// barrier every block reduces the G values (a max is exact in any order, so
// every block gets the same bits). Every thread calls it; returns to all.
template <typename T>
__device__ T group_xmax(const T* X, int d, int row0, int nr, double* slot, long stride,
                        unsigned* bar, int G, int p, BoundShared<T>& sh) {
  const int tid = threadIdx.x, nt = blockDim.x;
  T mx = T(0);
  for (long i = tid; i < (long)nr * d; i += nt) mx = jmax(mx, gabs(X[(long)row0 * d + i]));
  mx = block_max(mx, sh.red);
  if (tid == 0) slot[(long)p * stride] = double(mx);
  group_sync(bar, G, p);
  if (tid == 0) {
    T top = T(0);
    for (int q = 0; q < G; ++q) {
      const T v = T(__ldcg(slot + (long)q * stride));
      top = v > top ? v : top;
    }
    sh.red[0] = top;
  }
  __syncthreads();
  const T out = sh.red[0];
  __syncthreads();
  return out;
}

// What one block of a group works on.
template <typename T>
struct GroupWork {
  Work<T> w;                   // the chain's M x M work (Work with n = 0)
  T* sc;                       // the chain's scalars (GroupScalar), then QmmZ's
                               // d column sums
  T *Knm, *An, *xn, *zn, *Q;   // this block's rows
  double* part;                // block 0's partials; block q's at part + q pe
  unsigned* bar;               // the chain's barrier
  long pe, p1;
  int p, G, row0, nr;
  T xmax;                      // max |X|
  T cap;                       // 1024 / max(1e-3, |X|, |Z|)
};

// gw.cap from gw.xmax and the max of |Z| (md entries, read by every block
// itself: a max is exact in any order, so every block gets the same cap), for
// the work of any grouped core (GroupWork, SgpmcGroupWork). Every thread
// calls it.
template <typename GW, typename T>
__device__ void group_cap(GW& gw, const T* Z, int md, BoundShared<T>& sh) {
  T mz = T(0);
  for (int i = threadIdx.x; i < md; i += blockDim.x) mz = jmax(mz, gabs(Z[i]));
  mz = block_max(mz, sh.red);
  gw.cap = T(1024) / jmax(mz > gw.xmax ? mz : gw.xmax, T(1e-3));
}

// U_out = -(ELBO [+ log prior]) and g_out = dU/dtheta (d + 2 entries) of one
// state row theta, and dZ_out = dU/dZ when cf.want_z (each block writes its
// slice): vfe_bound's function on the chain's group. Every block of the group calls
// it with the same theta (visible to all its threads); its outputs are
// visible to all threads on return. U_out is written by thread 0.
template <typename T>
__device__ void vfe_group_bound(const BoundCfg& cf, const T* theta, const T* X, const T* y,
                                const T* Z, const GroupWork<T>& gw, BoundShared<T>& sh,
                                T* U_out, T* g_out, T* dZ_out) {
  __shared__ T sA[kRowKC][kRowTR + 1];
  __shared__ T sB[kRowKC][kRowTC + 1];
  __shared__ double dred[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = cf.n, m = cf.m, d = cf.d;
  const int G = gw.G, p = gw.p, nr = gw.nr, row0 = gw.row0;
  const bool head = p == 0;
  const Work<T>& w = gw.w;
  const long pe = gw.pe, nup = (long)m * (m + 1) / 2;
  double* mine = gw.part + (long)p * pe;          // this block's partials
  double* two = mine + gw.p1 + 1;                 // its pass-2 partials
  const double* two0 = gw.part + gw.p1 + 1;       // block 0's pass-2 partials
  const T jitter = T(cf.jitter);
  T* il = sh.inv_ls;

  // A: the capped inverse lengthscales, the grams of this block's rows;
  // block 0 also Kmm and its factor
  for (int k = tid; k < d; k += nt) il[k] = jmin(gexp(-theta[k]), gw.cap);
  const T sf2 = gexp(theta[d]), s2 = gexp(theta[d + 1]), sigma = gsqrt(s2);
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
      w.Kmm[idx] = kab;
      w.W[idx] = kab + (a == b ? jitter * jit_scale : T(0));
    }
    __syncthreads();
    chol_upper(w.W, w.U, m, T(cf.floor) * jit_scale, cf.floor > 0.0);   // U = L^T
    ut_inv(w.U, w.V, m);                                                  // V = L^-T
  }
  group_sync(gw.bar, G, p);

  // B: An_b = Knm_b V / sigma; partials of B - I (packed upper), u, yy
  block_an(m, nr, gw.Knm, w.V, sigma, gw.An, sA, sB, L2Load{});
  block_gemm<double, kRowTR, kRowTC, kRowKC, kThreads>(
      m, m, nr, gw.An, 1, m, gw.An, m, 1, SYM_UPPER, sA, sB, [&](int a, int b, double v) {
        if (a <= b) mine[upper_index(m, a, b)] = v;
      });
  for (int a = tid; a < m; a += nt)
    mine[nup + a] = dot_acc<double>(gw.An + a, m, y + row0, 1, 0, nr);
  double yy = 0.0;
  for (int i = tid; i < nr; i += nt) yy += double(y[row0 + i]) * double(y[row0 + i]);
  yy = block_sum(yy, dred);
  if (tid == 0) mine[nup + m] = yy;
  group_sync(gw.bar, G, p);

  // C: this block's slice of the sums over the G partials: B (staged in VT0,
  // which collapsed_mm forms later), u (staged in c) and yy
  {
    const long mm2 = (long)m * m, E = mm2 + m + 1;
    const long e0 = E * p / G, e1 = E * (p + 1) / G;
    for (long e = e0 + tid; e < e1; e += nt) {
      if (e < mm2) {
        const int a = (int)(e / m), b = (int)(e % m);
        const long at = a < b ? upper_index(m, a, b) : upper_index(m, b, a);
        w.VT0[e] = T(sum_partials(gw.part, pe, G, at)) + (a == b ? T(1) : T(0));
      } else if (e < mm2 + m) {
        w.c[e - mm2] = T(sum_partials(gw.part, pe, G, nup + (e - mm2)));
      } else {
        gw.sc[G_YY] = T(sum_partials(gw.part, pe, G, nup + m));
      }
    }
  }
  group_sync(gw.bar, G, p);

  // D: block 0: the M x M part of the bound and of its gradient
  if (head) {
    for (int idx = tid; idx < m * m; idx += nt) {
      const T v = __ldcg(w.VT0 + idx);
      w.B[idx] = v;
      w.W[idx] = v;
    }
    for (int a = tid; a < m; a += nt) w.u[a] = __ldcg(w.c + a);
    __syncthreads();
    const CollapsedMM<T> mm =
        collapsed_mm<T, kRowTR, kRowTC, kRowKC, kThreads>(cf, w, sh, s2, true, sA, sB);
    const T nT = T(n), mT = T(m);
    const T yyT = __ldcg(gw.sc + G_YY);
    const T t_term = nT * sf2 - s2 * (mm.trB - mT);
    const T F = T(-0.5) * nT * glog(T(6.283185307179586) * s2) - T(0.5) * mm.logdetB
                - T(0.5) * (yyT - mm.uv) / s2 - T(0.5) * t_term / s2;
    T p_mm = T(0), p_dk = T(0);
    for (int idx = tid; idx < m * m; idx += nt) p_mm += w.Pmm[idx];
    for (int a = tid; a < m; a += nt) p_dk += w.dkdiag[a];
    const T S_mm = block_sum(p_mm, sh.red);
    const T tr_dK = block_sum(p_dk, sh.red);
    // GmmZ[a] = sum_b Pmm[a,b] (zs_a - zs_b), QmmZ[a] = sum_b Pmm[a,b] (zs_a - zs_b)^2
    for (int idx = tid; idx < m * d; idx += nt) {
      const int a = idx / d, k = idx % d;
      const T za = Z[idx] * il[k];
      T g = T(0), q = T(0);
      for (int b = 0; b < m; ++b) {
        const T df = za - Z[b * d + k] * il[k], pv = w.Pmm[a * m + b];
        g += pv * df;
        q += pv * df * df;
      }
      w.GmmZ[idx] = g;
      w.QmmZ[idx] = q;
    }
    __syncthreads();
    for (int k = tid; k < d; k += nt) {
      T q = T(0);
      for (int a = 0; a < m; ++a) q += w.QmmZ[a * d + k];
      gw.sc[kGroupScal + k] = q;
    }
    if (tid == 0) {
      gw.sc[G_F] = F;
      gw.sc[G_TRBINV] = mm.trBinv;
      gw.sc[G_TTERM] = t_term;
      gw.sc[G_SMM] = S_mm;
      gw.sc[G_TRDK] = tr_dK;
    }
  }
  group_sync(gw.bar, G, p);

  // E: alpha_b = (y_b - An_b v) / s2; Pnm_b = (An_b Y1 + alpha w^T) / sigma o
  // Knm_b in Knm_b's place; the pass-2 partials
  T* alpha = gw.xn;                               // xn is free once Knm_b is formed
  for (int i = tid; i < nr; i += nt)
    alpha[i] = (y[row0 + i] - dot_acc<T>(gw.An + (long)i * m, 1, w.v, 1, 0, m, L2Load{})) / s2;
  __syncthreads();
  block_gemm<T, kRowTR, kRowTC, kRowKC, kThreads>(
      nr, m, m, gw.An, m, 1, w.Y1, m, 1, K_FULL, sA, sB,
      [&](int i, int b, T s) {
        const T dk = (s + alpha[i] * __ldcg(w.w + b)) / sigma;
        gw.Knm[i * m + b] = dk * gw.Knm[i * m + b];
      },
      L2Load{});
  double pa = 0.0, pn = 0.0;
  for (int i = tid; i < nr; i += nt) pa += double(alpha[i]) * double(alpha[i]);
  for (int idx = tid; idx < nr * m; idx += nt) pn += double(gw.Knm[idx]);
  pa = block_sum(pa, dred);
  pn = block_sum(pn, dred);
  // QnmX[i, k] = sum_b Pnm[i, b] (xs_ik - zs_bk)^2, summed over rows in double
  for (int idx = tid; idx < nr * d; idx += nt) {
    const int i = idx / d, k = idx % d;
    const T xs = X[(long)(row0 + i) * d + k] * il[k];
    T q = T(0);
    for (int b = 0; b < m; ++b) {
      const T df = xs - Z[b * d + k] * il[k];
      q += gw.Knm[i * m + b] * df * df;
    }
    gw.Q[idx] = q;
  }
  __syncthreads();
  if (tid == 0) {
    two[0] = pa;
    two[1] = pn;
  }
  for (int k = tid; k < d; k += nt) {
    double acc = 0.0;
    for (int i = 0; i < nr; ++i) acc += double(gw.Q[i * d + k]);
    two[2 + k] = acc;
  }
  if (cf.want_z) {           // GnmZ[a] = sum_i Pnm[i, a] (zs_a - xs_i)
    for (int idx = tid; idx < m * d; idx += nt) {
      const int a = idx / d, k = idx % d;
      const T za = Z[idx] * il[k];
      double acc = 0.0;
      for (int i = 0; i < nr; ++i)
        acc += double(gw.Knm[i * m + a]) * double(za - X[(long)(row0 + i) * d + k] * il[k]);
      two[2 + d + idx] = acc;
    }
  }
  group_sync(gw.bar, G, p);

  // every block: the pass-2 sums, p = 0 .. G-1, and the RBF-ARD chain rule
  // to the log-hypers plus the prior, as vfe_bound
  for (int k = tid; k < d; k += nt) {
    T gk = T(sum_partials(two0, pe, G, 2 + k)) + __ldcg(gw.sc + kGroupScal + k);
    if (cf.want_prior) {
      T lp, gp;
      prior_leaf(cf.leaf[0], theta[k], &lp, &gp);
      gk += gp;
    }
    g_out[k] = -gk;
  }
  if (tid == 0) {
    const T nT = T(n), mT = T(m);
    const T aa = T(sum_partials(two0, pe, G, 0));
    const T S_nm = T(sum_partials(two0, pe, G, 1));
    const T F = __ldcg(gw.sc + G_F), trBinv = __ldcg(gw.sc + G_TRBINV);
    const T t_term = __ldcg(gw.sc + G_TTERM), S_mm = __ldcg(gw.sc + G_SMM);
    const T tr_dK = __ldcg(gw.sc + G_TRDK);
    const T dlog_os = S_mm + S_nm + jitter * sf2 * (sf2 > T(1) ? T(1) : T(0)) * tr_dK
                      - nT * sf2 / (T(2) * s2);
    const T trW = (nT - mT + trBinv) / s2;
    const T dF_ds2 = T(0.5) * aa - T(0.5) * trW + t_term / (T(2) * s2 * s2);
    T g_os = dlog_os, g_noise = dF_ds2 * s2, Ftot = F;
    if (cf.want_prior) {
      T lp, gp, lp_ls = T(0);
      for (int k = 0; k < d; ++k) { prior_leaf(cf.leaf[0], theta[k], &lp, &gp); lp_ls += lp; }
      T lp_os, gp_os, lp_n, gp_n;
      prior_leaf(cf.leaf[1], theta[d], &lp_os, &gp_os);
      prior_leaf(cf.leaf[2], theta[d + 1], &lp_n, &gp_n);
      Ftot = F + (lp_ls + lp_os + lp_n);
      g_os += gp_os;
      g_noise += gp_n;
    }
    g_out[d] = -g_os;
    g_out[d + 1] = -g_noise;
    *U_out = -Ftot;
  }
  if (cf.want_z && dZ_out != nullptr) {       // this block's slice of dU/dZ
    const long md = (long)m * d, z0 = md * p / G, z1 = md * (p + 1) / G;
    for (long idx = z0 + tid; idx < z1; idx += nt)
      dZ_out[idx] = (T(2) * __ldcg(w.GmmZ + idx) + T(sum_partials(two0, pe, G, 2 + d + idx)))
                    * il[idx % d];
  }
  __syncthreads();
}

// The grouped vfe core as the sampler kernels take it (see CoreGroup): the
// state row is the d+2 log-hypers, as VfeCore's.
template <typename T>
struct VfeGroupCore {
  using WorkT = GroupWork<T>;
  static __host__ __device__ int dim(const BoundCfg& cf) { return cf.d + 2; }

  // The work of block blockIdx.x (chain blockIdx.x / G, place p =
  // blockIdx.x % G) in the launch's scratch; and the lengthscale cap, formed
  // once per launch: each block takes the max of |X| over its rows, and
  // after the chain's barrier every block reduces the G maxima (a max is
  // exact in any order), then takes |Z| in (group_cap).
  static __device__ WorkT work(T* scratch, const BoundCfg& cf, const T* X, const T* Z,
                               BoundShared<T>& sh) {
    const int G = cf.group, C = gridDim.x / G, c = blockIdx.x / G, p = blockIdx.x % G;
    const int n = cf.n, m = cf.m, d = cf.d;
    const GroupShape s = group_shape(n, m, d, G);
    char* base = (char*)scratch;
    char* chain = base + (long)C * kBarWords * 4 + (long)c * group_chain_bytes<T>(s, G);
    WorkT gw;
    gw.bar = (unsigned*)base + (long)c * kBarWords;
    gw.part = (double*)chain;
    T* t = (T*)(chain + (long)G * s.pe * 8);
    gw.w = make_work(t, 0, m, d);
    gw.sc = t + work_elems(0, m, d);
    gw.Knm = gw.sc + kGroupScal + kMaxDim + (long)p * s.t_block;
    gw.An = gw.Knm + (long)s.nb * m;
    gw.xn = gw.An + (long)s.nb * m;
    gw.zn = gw.xn + s.nb;
    gw.Q = gw.zn + m;
    gw.pe = s.pe;
    gw.p1 = s.p1;
    gw.p = p;
    gw.G = G;
    gw.row0 = row_begin(n, G, p);
    gw.nr = row_begin(n, G, p + 1) - gw.row0;

    gw.xmax = group_xmax(X, d, gw.row0, gw.nr, gw.part + s.p1, s.pe, gw.bar, G, p, sh);
    group_cap(gw, Z, m * d, sh);
    return gw;
  }

  static __device__ void eval(const BoundCfg& cf, const T* z, const T* X, const T* y,
                              const T* Z, const WorkT& w, BoundShared<T>& sh, T* U, T* g,
                              T* dZ) {
    vfe_group_bound(cf, z, X, y, Z, w, sh, U, g, dZ);
  }
};

template <>
struct CoreGroup<VfeGroupCore> {
  static constexpr bool value = true;
};

}  // namespace ggp
