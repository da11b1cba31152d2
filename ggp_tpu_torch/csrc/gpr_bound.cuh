// Dense GP marginal potential of the Scale(RBF-ARD) x Gaussian model (the
// GPR_HMC target): value and analytic gradient over the state row
// [log_lengthscale (d), log_outputscale, log_noise], spread over a group of
// G thread blocks per chain: the "gpr" core (`GprGroupCore`) of the
// potential kernel (vfe_potential.cu) and the NUTS chunk kernel
// (nuts_chunk.cu), for one chain or C chains, at every n.
//
// Replaces: ggp_tpu/ops/fused_bound.py `_gpr_neg_logpost_vg` (:1359), the
// core the fused Pallas kernels of ggp_tpu/ops/fused_nuts.py run with
// target="gpr" (the potential call and the NUTS warm and sample chunks).
// The JAX package runs it for one chain up to MAX_N_DENSE = 512 rows and
// leaves C chains and larger n to XLA; the port runs this core at any n and
// C. Plain twin: ggp_tpu_torch/ops/gpr_bound.py `gpr_neg_logpost_vg` (its
// docstring has the adjoint); `gpr_group_neg_logpost_vg` there is a plain
// model of this file's algorithm (tiles, steps, storage and sum order).
//
// The function: K = Kcore + (s2 + jitter) I with an absolute jitter and the
// capped inverse lengthscale min(exp(-theta), 1024 / max(1e-3, max|X|));
// K = L L^T (a non-positive pivot gives NaN, the samplers' divergence);
// Linv = L^-1, t = Linv y, a = Linv^T t = K^-1 y, K^-1 = Linv^T Linv;
// U = -(log marginal + log prior); with Kbar = (a a^T - K^-1) / 2 and P =
// Kbar o Kcore: dF/dlog_noise = s2 tr Kbar, dF/dlog_os = sum P, dF/dlog_ls_k
// = -sum_ij P_ij (xs_ik - xs_jk)^2 (the difference form).
//
// What bounds it on the card: the N x N factorisation and inverse, N^3/3
// multiply-adds each, and K^-1 another N^3/3: ~7e7 operations at N=404,
// ~1 us at the float32 peak. One block walking N pivot steps (the design
// before this one) is bound by ~N block barriers and L2 latency (18 ms an
// evaluation at N=404, 900 ms at N=1279). Here the matrix is cut into
// b x b tiles (b = kGT = 32) and every step is a set of independent tile
// tasks spread over the chain's G blocks, so the chain of dependent steps
// is ~N/b long instead of N, and each step's tile products run on all the
// group's SMs at once.
//
// The design, on the machinery of vfe_group.cuh (one cooperative launch,
// chain c on blocks c G .. c G + G - 1, the per-chain barrier `group_sync`,
// data written by another block read through L2 with ld.global.cg, every
// block running the sampler's tree logic on identical bits, block 0 the
// only writer of outputs). One evaluation is these phases, each ended by
// the chain's barrier; task q of a phase runs on block q mod G:
//   grams      the lower tiles of K, padded to np = nt b with the identity
//              (its factor and inverse are the identity there);
//   steps s = 0 .. nt, each one barrier: a right-looking blocked Cholesky
//              fused with a right-looking blocked inverse. Step s factors
//              column s (every block with a task in it forms the updated
//              diagonal tile and factors and inverts it itself, one warp in
//              registers, from the same bits; the panel tiles are A(i, s) -
//              L(i, s-1) L(s, s-1)^T times Lss^-T), updates the trailing
//              tiles with column s-1, and applies the inverse's step k =
//              s-1: row k of Linv is final (Linv(k, j) = Linv(k, k) W(k,
//              j)), and rows i > k take W(i, j) -= L(i, k) Linv(k, j). No
//              task reads what another task of its step writes: W lives in
//              the columns of A already consumed, Linv(k, j) overwrites
//              L(k, j), whose column was consumed, and the diagonal slots of
//              L hold Linv(s, s) (L(s, s) itself is only kept as log diag);
//   solves     t = Linv y, then (another barrier) a = Linv^T t, by tile
//              rows, each sum in double;
//   pairs      per lower tile (I, J): K^-1(I, J) = sum_{K >= I} Linv(K, I)^T
//              Linv(K, J), Kbar and P entry by entry (Kcore formed again
//              from X), and the tile's d + 2 partials of sum P, tr Kbar and
//              the lengthscale sums, in double;
//   gradient   every block sums the tile partials in tile order and forms U
//              and g itself.
// Every sum runs in a fixed order over tiles (never over blocks), and each
// tile task runs the same code on whichever block takes it, so the result
// does not depend on G: a chain of a C-chain launch gives the bits of a
// one-chain launch. Tile products (tile_mac) load both 32 x 32 operands
// with one L2 round trip and stage them in shared memory in chunks of 32 x
// 8; each output sums its terms in one register in ascending order.
//
// cf.stages (> 0) stops after that many of the six parts (grams; the
// factorisation; the fused inverse, which the steps then also run; the
// solves and value; the pairs; the gradient), so that a caller can time
// the prefixes of one evaluation (chip_smoke.py); 0 runs them all.
#pragma once

#include "vfe_group.cuh"

namespace ggp {

constexpr int kGprStages = 6;
constexpr int kGT = 32;      // tile edge b
constexpr int kGKC = 8;      // terms of one staged chunk of a tile product
constexpr int kGWarps = kThreads / 32;
static_assert(kThreads == 256, "tile_mac gives each thread 4 outputs of a 32 x 32 tile");

// Sizes of one chain's work at (n, d).
struct GprShape {
  int nt;      // tiles per side, ceil(n / b)
  int np;      // padded side nt b
  long ntl;    // lower tiles nt (nt + 1) / 2
  int nv;      // partials per tile: sum P, tr Kbar, d lengthscale sums
  int nw;      // a block's per-warp sums: 8 x max(nv, 32)
};

__host__ __device__ inline GprShape gpr_shape(int n, int d) {
  GprShape s;
  s.nt = (n + kGT - 1) / kGT;
  s.np = s.nt * kGT;
  s.ntl = (long)s.nt * (s.nt + 1) / 2;
  s.nv = d + 2;
  s.nw = kGWarps * (s.nv > 32 ? s.nv : 32);
  return s;
}

// Bytes of one chain: doubles (the tile partials, the G blocks' per-warp
// sums, the G maxima of |X|), then T (A and L, np x np; t, a and the log
// diagonal, np; the G blocks' three b x b tiles), rounded to 16 bytes.
template <typename T>
__host__ __device__ inline long gpr_chain_bytes(const GprShape& s, int G) {
  const long dbl = s.ntl * s.nv + (long)G * s.nw + G;
  const long tt = 2L * s.np * s.np + 3L * s.np + 3L * G * kGT * kGT;
  return (dbl * 8 + tt * (long)sizeof(T) + 15) / 16 * 16;
}

// Elements of T of a launch's scratch for C chains of G blocks: the C
// barriers (kBarWords each), then the C chains.
template <typename T>
__host__ __device__ inline long gpr_scratch_elems(int n, int d, int C, int G) {
  const long bytes = (long)C * (kBarWords * 4 + gpr_chain_bytes<T>(gpr_shape(n, d), G));
  return (bytes + (long)sizeof(T) - 1) / (long)sizeof(T);
}

// What one block of a group works on.
template <typename T>
struct GprWork {
  double* part;              // the chain's tile partials, ntl x nv
  double* wsum;              // this block's per-warp sums (nw)
  double* xmax;              // the G blocks' max |X|
  T *A, *L;                  // the chain's np x np matrices (lower tiles)
  T *t, *a, *ld;             // t = Linv y, a = K^-1 y, log diag L (np)
  T *Lf, *Li, *Tt;           // this block's tiles: a factor, its inverse, a product
  unsigned* bar;
  GprShape s;
  int p, G;
  T cap;                     // 1024 / max(1e-3, max|X|)
};

// acc[q] += sum_{kk < b} A(r_q, kk) B(kk, c) for this thread's four
// outputs of a b x b tile (rows r_q = tid / 32 + 8 q, column c = tid % 32),
// A(r, kk) = A[r ar + kk ak], B(kk, c) = B[kk bk + c bc] (one of each pair
// of strides 1), read through L2 (ld.global.cg). Every thread issues its
// loads of all four chunks of kGKC terms at once (one L2 round trip a
// product), then the chunks are staged in sA and sB in turn; each output
// sums its terms in ascending kk. Ends with a barrier.
template <typename T, typename Acc>
__device__ __forceinline__ void tile_mac(Acc (&acc)[4], const T* A, long ar, long ak,
                                         const T* B, long bk, long bc,
                                         T (*sA)[kGT + 1], T (*sB)[kGT + 1]) {
  const int tid = threadIdx.x;
  int ra, ka, kb, cb;
  if (ak == 1) { ra = tid >> 3; ka = tid & 7; } else { ka = tid >> 5; ra = tid & 31; }
  if (bc == 1) { kb = tid >> 5; cb = tid & 31; } else { cb = tid >> 3; kb = tid & 7; }
  const int c = tid & 31, r0 = tid >> 5;
  constexpr int kChunks = kGT / kGKC;
  const T* pa = A + ra * ar + ka * ak;
  const T* pb = B + kb * bk + cb * bc;
  T va[kChunks], vb[kChunks];
#pragma unroll
  for (int h = 0; h < kChunks; ++h) {
    va[h] = __ldcg(pa + h * kGKC * ak);
    vb[h] = __ldcg(pb + h * kGKC * bk);
  }
#pragma unroll
  for (int h = 0; h < kChunks; ++h) {
    sA[ka][ra] = va[h];
    sB[kb][cb] = vb[h];
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGKC; ++kk) {
      const Acc bv = Acc(sB[kk][c]);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += Acc(sA[kk][r0 + 8 * q]) * bv;
    }
    __syncthreads();
  }
}

// Row and column of this thread's output q of a tile.
__device__ __forceinline__ int tile_row(int q) { return (threadIdx.x >> 5) + 8 * q; }
__device__ __forceinline__ int tile_col() { return threadIdx.x & 31; }

// (ii, jj), jj <= ii, of index q of the lower triangle enumerated by rows:
// q = ii (ii + 1) / 2 + jj.
__device__ __forceinline__ void tri_decode(long q, int* ii, int* jj) {
  int i = (int)((sqrt(8.0 * (double)q + 1.0) - 1.0) * 0.5);
  while ((long)i * (i + 1) / 2 > q) --i;
  while ((long)(i + 1) * (i + 2) / 2 <= q) ++i;
  *ii = i;
  *jj = (int)(q - (long)i * (i + 1) / 2);
}

// Kcore(i, j) = sf2 exp(-r2 / 2), r2 by norm expansion clamped at 0 (the
// old core's and the plain version's formula), from X and the capped
// inverse lengthscales il.
template <typename T>
__device__ __forceinline__ T gpr_gram(const T* X, const T* il, int d, int i, int j, T sf2) {
  T xi = T(0), xj = T(0), dot = T(0);
  for (int k = 0; k < d; ++k) {
    const T a = X[(long)i * d + k] * il[k], b = X[(long)j * d + k] * il[k];
    xi += a * a;
    xj += b * b;
    dot += a * b;
  }
  return sf2 * gexp(T(-0.5) * jmax(xi + xj - T(2) * dot, T(0)));
}

// The block's diagonal tile: Lf holds the (updated) b x b tile D on entry
// (lower triangle). Warp 0 factors D = Lss Lss^T (lane r keeps row r in
// registers; a non-positive pivot gives NaN) into Lf (lower, zeros above)
// and inverts it into Li (lane c forms column c, right-looking). Every
// thread calls it; it ends with a barrier.
template <typename T>
__device__ void factor_diag_tile(T* Lf, T* Li) {
  if (threadIdx.x < 32) {
    const int r = threadIdx.x;
    T a[kGT];
#pragma unroll
    for (int c = 0; c < kGT; ++c) a[c] = c <= r ? Lf[r * kGT + c] : T(0);
#pragma unroll
    for (int j = 0; j < kGT; ++j) {
      const T piv = __shfl_sync(0xffffffffu, a[j], j);
      const T dis = piv > T(0) ? grsqrt(piv) : gnan<T>();
      const T l = r >= j ? a[j] * dis : T(0);
      a[j] = l;
#pragma unroll
      for (int c = j + 1; c < kGT; ++c) a[c] -= l * __shfl_sync(0xffffffffu, l, c);
    }
#pragma unroll
    for (int c = 0; c < kGT; ++c) Lf[r * kGT + c] = c <= r ? a[c] : T(0);
    __syncwarp();
    const int c = r;
    T x[kGT];
#pragma unroll
    for (int i = 0; i < kGT; ++i) x[i] = i == c ? T(1) : T(0);
#pragma unroll
    for (int i = 0; i < kGT; ++i) {
      x[i] = x[i] * (T(1) / Lf[i * kGT + i]);
#pragma unroll
      for (int i2 = i + 1; i2 < kGT; ++i2) x[i2] -= Lf[i2 * kGT + i] * x[i];
    }
#pragma unroll
    for (int i = 0; i < kGT; ++i) Li[i * kGT + c] = x[i];
  }
  __syncthreads();
}

// Warp-wide sum in a fixed order (a shuffle tree), returned to lane 0.
__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// U_out = -(log marginal + log prior), g_out = dU/dtheta (d+2 entries), on
// the chain's group: every block of the group calls it with the same theta
// (visible to all its threads); its outputs are visible to all threads on
// return. U_out is written by thread 0.
template <typename T>
__device__ void gpr_group_bound(const BoundCfg& cf, const T* theta, const T* X, const T* y,
                                const GprWork<T>& gw, BoundShared<T>& sh, T* U_out,
                                T* g_out) {
  __shared__ T sA[kGKC][kGT + 1];
  __shared__ T sB[kGKC][kGT + 1];
  __shared__ double dred[32];
  const int tid = threadIdx.x, nt_ = blockDim.x;
  const int n = cf.n, d = cf.d;
  const int stages = cf.stages > 0 ? cf.stages : kGprStages;
  const int G = gw.G, p = gw.p, nt = gw.s.nt, np = gw.s.np, nv = gw.s.nv;
  const int warp = tid >> 5, lane = tid & 31, c = tile_col();
  T* il = sh.inv_ls;
  T* const A = gw.A;
  T* const L = gw.L;
  auto tile = [np](T* M, int I, int J) { return M + (long)I * kGT * np + J * kGT; };

  for (int k = tid; k < d; k += nt_) il[k] = jmin(gexp(-theta[k]), gw.cap);
  const T sf2 = gexp(theta[d]), s2 = gexp(theta[d + 1]);
  const T diag_add = s2 + T(cf.jitter);                 // absolute jitter
  __syncthreads();

  // ---- 1. grams: the lower tiles of K, the identity in the padding
  for (long q = p; q < gw.s.ntl; q += G) {
    int I, J;
    tri_decode(q, &I, &J);
    T* At = tile(A, I, J);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = tile_row(u), i = I * kGT + r, j = J * kGT + c;
      T v;
      if (i < n && j < n) v = gpr_gram(X, il, d, i, j, sf2) + (i == j ? diag_add : T(0));
      else v = i == j ? T(1) : T(0);
      At[(long)r * np + c] = v;
    }
  }
  group_sync(gw.bar, G, p);
  if (stages < 2) return;

  // ---- 2-3. the factorisation, fused with the inverse (stages >= 3)
  const bool inv = stages >= 3;
  for (int s = 0; s <= nt; ++s) {
    const int nf = s < nt ? nt - s : 0;                        // column s
    const int rr = s < nt ? nt - s - 1 : 0;
    const long ntr = s >= 1 ? (long)rr * (rr + 1) / 2 : 0;     // trailing (i, j), s < j <= i
    const int k = s - 1;                                       // the inverse's step
    const long nfin = inv && s >= 1 ? k : 0;                   // row k, j < k
    const long nupd = inv && s >= 1 ? (long)(nt - 1 - k) * (k + 1) : 0;   // i > k, j <= k
    const long total = nf + ntr + nfin + nupd;
    if (total == 0) break;
    if (p < nf) {         // the diagonal tile of column s: D = A(s, s) - L(s, s-1) L(s, s-1)^T
      T acc[4] = {T(0), T(0), T(0), T(0)};
      if (s >= 1)
        tile_mac(acc, tile(L, s, s - 1), np, 1, tile(L, s, s - 1), 1, np, sA, sB);
      const T* Ds = tile(A, s, s);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = tile_row(u);
        gw.Lf[r * kGT + c] = __ldcg(Ds + (long)r * np + c) - acc[u];
      }
      __syncthreads();
      factor_diag_tile(gw.Lf, gw.Li);
      if (p == 0) {               // Linv(s, s) into L's diagonal slot; log diag L
        T* Ls = tile(L, s, s);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = tile_row(u);
          Ls[(long)r * np + c] = gw.Li[r * kGT + c];
        }
        if (tid < kGT) gw.ld[s * kGT + tid] = glog(gw.Lf[tid * kGT + tid]);
      }
    }
    for (long q = p; q < total; q += G) {
      if (q < nf) {
        if (q == 0) continue;                                  // the diagonal tile: above
        const int i = s + (int)q;            // L(i, s) = (A(i, s) - L(i, s-1) L(s, s-1)^T) Lss^-T
        T acc[4] = {T(0), T(0), T(0), T(0)};
        if (s >= 1)
          tile_mac(acc, tile(L, i, s - 1), np, 1, tile(L, s, s - 1), 1, np, sA, sB);
        const T* Ai = tile(A, i, s);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = tile_row(u);
          gw.Tt[r * kGT + c] = __ldcg(Ai + (long)r * np + c) - acc[u];
          acc[u] = T(0);
        }
        __syncthreads();
        tile_mac(acc, gw.Tt, kGT, 1, gw.Li, 1, kGT, sA, sB);
        T* Lo = tile(L, i, s);
#pragma unroll
        for (int u = 0; u < 4; ++u) Lo[(long)tile_row(u) * np + c] = acc[u];
      } else if (q < nf + ntr) {             // A(i, j) -= L(i, s-1) L(j, s-1)^T
        int ii, jj;
        tri_decode(q - nf, &ii, &jj);
        const int i = s + 1 + ii, j = s + 1 + jj;
        T acc[4] = {T(0), T(0), T(0), T(0)};
        tile_mac(acc, tile(L, i, s - 1), np, 1, tile(L, j, s - 1), 1, np, sA, sB);
        T* At = tile(A, i, j);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const long o = (long)tile_row(u) * np + c;
          At[o] = __ldcg(At + o) - acc[u];
        }
      } else if (q < nf + ntr + nfin) {      // Linv(k, j) = Linv(k, k) W(k, j) into L(k, j)
        const int j = (int)(q - nf - ntr);
        T acc[4] = {T(0), T(0), T(0), T(0)};
        tile_mac(acc, tile(L, k, k), np, 1, tile(A, k, j), np, 1, sA, sB);
        T* Lo = tile(L, k, j);
#pragma unroll
        for (int u = 0; u < 4; ++u) Lo[(long)tile_row(u) * np + c] = acc[u];
      } else {                               // W(i, j) -= L(i, k) Linv(k, j), i > k >= j
        const long e = q - nf - ntr - nfin;
        const int i = k + 1 + (int)(e / (k + 1)), j = (int)(e % (k + 1));
        T acc[4] = {T(0), T(0), T(0), T(0)};
        const T* Bk = tile(L, k, k);                           // Linv(k, k)
        long bk = np;
        if (j < k) {                         // Linv(k, j), formed here (its owner writes it)
          tile_mac(acc, tile(L, k, k), np, 1, tile(A, k, j), np, 1, sA, sB);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            gw.Tt[tile_row(u) * kGT + c] = acc[u];
            acc[u] = T(0);
          }
          __syncthreads();
          Bk = gw.Tt;
          bk = kGT;
        }
        tile_mac(acc, tile(L, i, k), np, 1, Bk, bk, 1, sA, sB);
        T* Wt = tile(A, i, j);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const long o = (long)tile_row(u) * np + c;
          Wt[o] = (j < k ? __ldcg(Wt + o) : T(0)) - acc[u];
        }
      }
    }
    group_sync(gw.bar, G, p);
  }
  if (stages < 4) return;

  // ---- 4. t = Linv y (tile rows), then a = Linv^T t; the value's sums
  for (int I = p; I < nt; I += G) {          // warp w: rows w, w + 8, ...; lanes over columns
    for (int r = warp; r < kGT; r += kGWarps) {
      const int i = I * kGT + r;
      double acc = 0.0;
      for (int J = 0; J <= I; ++J) {
        const int j = J * kGT + lane;
        if (j < n) acc += double(__ldcg(L + (long)i * np + j)) * double(y[j]);
      }
      acc = warp_sum(acc);
      if (lane == 0) gw.t[i] = T(acc);
    }
  }
  group_sync(gw.bar, G, p);
  for (int I = p; I < nt; I += G) {          // lane: column i of tile I; warp w: rows w, w + 8, ...
    const int i = I * kGT + lane;
    double acc = 0.0;
    for (int K = I; K < nt; ++K)
      for (int kk = warp; kk < kGT; kk += kGWarps) {
        const int kr = K * kGT + kk;
        acc += double(__ldcg(L + (long)kr * np + i)) * double(__ldcg(gw.t + kr));
      }
    gw.wsum[warp * 32 + lane] = acc;
    __syncthreads();
    if (tid < kGT) {
      double v = 0.0;
      for (int w = 0; w < kGWarps; ++w) v += gw.wsum[w * 32 + tid];
      gw.a[I * kGT + tid] = T(v);
    }
    __syncthreads();
  }
  group_sync(gw.bar, G, p);
  double p_ld = 0.0, p_q = 0.0;
  for (int i = tid; i < n; i += nt_) {
    p_ld += double(__ldcg(gw.ld + i));
    const double ti = double(__ldcg(gw.t + i));
    p_q += ti * ti;
  }
  const T logdet = T(2.0 * block_sum(p_ld, dred));
  const T quad = T(block_sum(p_q, dred));
  if (stages < 5) return;

  // ---- 5. per lower tile: K^-1, Kbar, P = Kbar o Kcore and the tile's partials
  for (long q = p; q < gw.s.ntl; q += G) {
    int I, J;
    tri_decode(q, &I, &J);
    T acc[4] = {T(0), T(0), T(0), T(0)};
    for (int K = I; K < nt; ++K)             // K^-1(I, J) = sum_K Linv(K, I)^T Linv(K, J)
      tile_mac(acc, tile(L, K, I), 1, np, tile(L, K, J), np, 1, sA, sB);
    const double wgt = I > J ? 2.0 : 1.0;
    const int j = J * kGT + c;
    T P[4];
    double vP = 0.0, vtr = 0.0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = I * kGT + tile_row(u);
      P[u] = T(0);
      if (i < n && j < n) {
        const T kbar = T(0.5) * (__ldcg(gw.a + i) * __ldcg(gw.a + j) - acc[u]);
        P[u] = kbar * gpr_gram(X, il, d, i, j, sf2);
        vP += wgt * double(P[u]);
        if (i == j) vtr += double(kbar);
      }
    }
    for (int v = 0; v < nv; ++v) {
      double x = 0.0;
      if (v == 0) {
        x = vP;
      } else if (v == 1) {
        x = vtr;
      } else {                             // sum P_ij (xs_ik - xs_jk)^2, k = v - 2
        const int kd = v - 2;
        const T xj = j < n ? X[(long)j * d + kd] * il[kd] : T(0);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = I * kGT + tile_row(u);
          if (i < n && j < n) {
            const T df = X[(long)i * d + kd] * il[kd] - xj;
            x += wgt * double(P[u] * df * df);
          }
        }
      }
      x = warp_sum(x);
      if (lane == 0) gw.wsum[warp * nv + v] = x;
    }
    __syncthreads();
    for (int v = tid; v < nv; v += nt_) {
      double sum = 0.0;
      for (int w = 0; w < kGWarps; ++w) sum += gw.wsum[w * nv + v];
      gw.part[q * nv + v] = sum;
    }
    __syncthreads();
  }
  group_sync(gw.bar, G, p);
  if (stages < 6) return;

  // ---- 6. every block: the tile partials in tile order; the priors
  for (int v = tid; v < nv; v += nt_) {
    const T sv = T(sum_partials(gw.part, nv, (int)gw.s.ntl, v));
    if (v >= 2) {
      T lp, gp;
      prior_leaf(cf.leaf[0], theta[v - 2], &lp, &gp);
      g_out[v - 2] = -(sv + gp);
    } else {
      sh.red[v] = sv;
    }
  }
  __syncthreads();
  if (tid == 0) {
    const T S_P = sh.red[0], tr_kbar = sh.red[1];
    const T F = T(-0.5) * (quad + logdet + T(n) * glog(T(6.283185307179586)));
    T lp_ls = T(0), lp, gp;
    for (int k = 0; k < d; ++k) { prior_leaf(cf.leaf[0], theta[k], &lp, &gp); lp_ls += lp; }
    T lp_os, gp_os, lp_n, gp_n;
    prior_leaf(cf.leaf[1], theta[d], &lp_os, &gp_os);
    prior_leaf(cf.leaf[2], theta[d + 1], &lp_n, &gp_n);
    g_out[d] = -(S_P + gp_os);
    g_out[d + 1] = -(s2 * tr_kbar + gp_n);
    *U_out = -(F + lp_ls + lp_os + lp_n);
  }
  __syncthreads();
}

// The grouped gpr core as the sampler kernels take it (see CoreGroup). Z
// and dZ are not read: the dense target has no inducing points.
template <typename T>
struct GprGroupCore {
  using WorkT = GprWork<T>;
  static __host__ __device__ int dim(const BoundCfg& cf) { return cf.d + 2; }

  // The work of block blockIdx.x (chain blockIdx.x / G, place p =
  // blockIdx.x % G) in the launch's scratch, and the lengthscale cap,
  // formed once per launch: each block takes the max of |X| over its rows
  // and, after the chain's barrier, every block reduces the G maxima.
  static __device__ WorkT work(T* scratch, const BoundCfg& cf, const T* X, const T*,
                               BoundShared<T>& sh) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const int G = cf.group, C = gridDim.x / G, c = blockIdx.x / G, p = blockIdx.x % G;
    const int n = cf.n, d = cf.d;
    WorkT gw;
    gw.s = gpr_shape(n, d);
    gw.G = G;
    gw.p = p;
    char* base = (char*)scratch;
    char* chain = base + (long)C * kBarWords * 4 + (long)c * gpr_chain_bytes<T>(gw.s, G);
    gw.bar = (unsigned*)base + (long)c * kBarWords;
    gw.part = (double*)chain;
    gw.wsum = gw.part + gw.s.ntl * gw.s.nv + (long)p * gw.s.nw;
    gw.xmax = gw.part + gw.s.ntl * gw.s.nv + (long)G * gw.s.nw;
    T* t = (T*)(gw.xmax + G);
    const long nn = (long)gw.s.np * gw.s.np;
    gw.A = t;
    gw.L = t + nn;
    gw.t = t + 2 * nn;
    gw.a = gw.t + gw.s.np;
    gw.ld = gw.a + gw.s.np;
    gw.Lf = gw.ld + gw.s.np + 3L * p * kGT * kGT;
    gw.Li = gw.Lf + kGT * kGT;
    gw.Tt = gw.Li + kGT * kGT;

    const int r0 = row_begin(n, G, p), r1 = row_begin(n, G, p + 1);
    T mx = T(0);
    for (long i = tid; i < (long)(r1 - r0) * d; i += nt) mx = jmax(mx, gabs(X[(long)r0 * d + i]));
    mx = block_max(mx, sh.red);
    if (tid == 0) gw.xmax[p] = double(mx);
    group_sync(gw.bar, G, p);
    if (tid == 0) {
      T top = T(0);
      for (int q = 0; q < G; ++q) {
        const T v = T(__ldcg(gw.xmax + q));
        top = v > top ? v : top;
      }
      sh.red[0] = top;
    }
    __syncthreads();
    gw.cap = T(1024) / jmax(sh.red[0], T(1e-3));
    __syncthreads();
    return gw;
  }

  static __device__ void eval(const BoundCfg& cf, const T* z, const T* X, const T* y,
                              const T*, const WorkT& w, BoundShared<T>& sh, T* U, T* g, T*) {
    gpr_group_bound(cf, z, X, y, w, sh, U, g);
  }
};

template <>
struct CoreGroup<GprGroupCore> {
  static constexpr bool value = true;
};

}  // namespace ggp
