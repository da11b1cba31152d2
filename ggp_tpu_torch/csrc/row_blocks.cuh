// Row blocks of the collapsed bound, shared by the kernels that spread one
// evaluation over many thread blocks: kernel 12 (z_adam_stream.cu, the
// streamed Z chunk) and the grouped sampler core (vfe_group.cuh).
//
// Both cut the n rows into blocks, form each block's grams Knm_b and An_b =
// Knm_b L^-T / sigma, and let each block sum its rows into partials of its
// own (no float atomics); the partials are then summed in the order p = 0,
// 1, ..., P - 1, so a result does not depend on which block ran first.
#pragma once

#include "vfe_bound.cuh"

namespace ggp {

constexpr int kRowTR = 32, kRowTC = 32, kRowKC = 8;   // block_gemm tiles of the row passes

// xn (nr) and Knm (nr x m) of the nr rows of X from row0 against Z, with
// the scaled inducing norms zn (m) and the capped inverse lengthscales il:
// grams by norm expansion, clamped at 0. Ends with a barrier.
template <typename T>
__device__ void block_knm(int m, int d, const T* X, const T* Z, const T* zn, const T* il,
                          T sf2, int row0, int nr, T* Knm, T* xn) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < nr; i += nt) {
    T q = T(0);
    for (int k = 0; k < d; ++k) { const T b = X[(long)(row0 + i) * d + k] * il[k]; q += b * b; }
    xn[i] = q;
  }
  __syncthreads();
  for (int idx = tid; idx < nr * m; idx += nt) {
    const int i = idx / m, j = idx % m;
    T dot = T(0);
    for (int k = 0; k < d; ++k)
      dot += (X[(long)(row0 + i) * d + k] * il[k]) * (Z[j * d + k] * il[k]);
    const T r2 = jmax(xn[i] + zn[j] - T(2) * dot, T(0));
    Knm[idx] = sf2 * gexp(T(-0.5) * r2);
  }
  __syncthreads();
}

// An = Knm V / sigma of nr rows, V = L^-T upper triangular (V(k, j) = 0 for
// k > j); `ld` loads Knm and V. Ends with a barrier.
template <typename T, typename Ld = PlainLoad>
__device__ void block_an(int m, int nr, const T* Knm, const T* V, T sigma, T* An,
                         T (*sA)[kRowTR + 1], T (*sB)[kRowTC + 1], Ld ld = Ld()) {
  block_gemm<T, kRowTR, kRowTC, kRowKC, kThreads>(
      nr, m, m, Knm, m, 1, V, m, 1, K_TO_C, sA, sB,
      [&](int i, int j, T v) { An[i * m + j] = v / sigma; }, ld);
}

// sum_{p < P} part[p * stride + idx], in the order p = 0 .. P-1, read from
// L2 (the partials were written by other blocks); four loads in flight.
__device__ __forceinline__ double sum_partials(const double* part, long stride, int P,
                                               long idx) {
  double acc = 0.0;
  int p = 0;
  for (; p + 4 <= P; p += 4) {
    const double a0 = __ldcg(part + p * stride + idx);
    const double a1 = __ldcg(part + (p + 1) * stride + idx);
    const double a2 = __ldcg(part + (p + 2) * stride + idx);
    const double a3 = __ldcg(part + (p + 3) * stride + idx);
    acc += a0;
    acc += a1;
    acc += a2;
    acc += a3;
  }
  for (; p < P; ++p) acc += __ldcg(part + p * stride + idx);
  return acc;
}

// First row of block p when n rows are cut into G contiguous blocks whose
// sizes differ by at most one: blocks p = 0 .. G-1 cover [0, n) once
// (ops/vfe_group.py row_blocks mirrors it).
__host__ __device__ inline int row_begin(int n, int G, int p) {
  return (int)((long)n * p / G);
}

// Index of (a, b), a <= b, in the packed upper triangle of an m x m matrix.
__host__ __device__ inline long upper_index(int m, int a, int b) {
  return (long)a * m - (long)a * (a - 1) / 2 + (b - a);
}

}  // namespace ggp
