// Tiled float64 GEMM with a permuted store, shared by the Schur assembly
// (schur_assemble.cu) and the projected block matvec (kkt_matvec.cu).
//
// C = A @ B with A (M x K) read at a[i * lda_m + k * lda_k] and B (K x N)
// read at b[k * ldb_k + j * ldb_n]; element (i, j) of the product is
// stored at
//     out[(i / i2) * s_i1 + (i % i2) * s_i2 + (j / j2) * s_j1 + (j % j2) * s_j2]
// so that a caller writes its result straight into the interleaved layout
// the next contraction (or the caller of the kernel) wants, without a
// separate relayout pass over device memory.
//
// Design: 64 x 64 output tiles, a 16-deep slice of A and B staged through
// shared memory per step, 256 threads each accumulating a 4 x 4 block in
// registers with fused multiply-adds (the f64 CUDA cores; DMMA tensor-core
// tiles are later work).  Edges are masked, so any M, N, K >= 1 is taken.
#pragma once

#include <cuda_runtime.h>

namespace {

struct PermStore {
  long long i2, s_i1, s_i2, j2, s_j1, s_j2;
  __device__ __forceinline__ long long offset(long long i, long long j) const {
    return (i / i2) * s_i1 + (i % i2) * s_i2 + (j / j2) * s_j1 + (j % j2) * s_j2;
  }
};

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gemm_f64_perm_kernel(const double* __restrict__ a, long long lda_m, long long lda_k,
                     const double* __restrict__ b, long long ldb_k, long long ldb_n,
                     double* __restrict__ c, PermStore st, int M, int N, int K) {
  __shared__ double As[kBK][kBM + 1];
  __shared__ double Bs[kBK][kBN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long row0 = (long long)blockIdx.y * kBM;
  const long long col0 = (long long)blockIdx.x * kBN;
  double acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK;
      const long long gi = row0 + r, gk = k0 + kk;
      As[kk][r] = (gi < M && gk < K) ? a[gi * lda_m + gk * lda_k] : 0.0;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int kk = e / kBN, cc = e % kBN;
      const long long gk = k0 + kk, gj = col0 + cc;
      Bs[kk][cc] = (gk < K && gj < N) ? b[gk * ldb_k + gj * ldb_n] : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      double ar[4], br[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) ar[p] = As[kk][ty + 16 * p];
#pragma unroll
      for (int q = 0; q < 4; ++q) br[q] = Bs[kk][tx + 16 * q];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fma(ar[p], br[q], acc[p][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const long long i = row0 + ty + 16 * p;
    if (i >= M) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long j = col0 + tx + 16 * q;
      if (j < N) c[st.offset(i, j)] = acc[p][q];
    }
  }
}

inline cudaError_t launch_gemm_f64(const double* a, long long lda_m, long long lda_k,
                                   const double* b, long long ldb_k, long long ldb_n,
                                   double* c, PermStore st, int M, int N, int K,
                                   cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const long long gy = (M + kBM - 1) / kBM;
  if (gy > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)((N + kBN - 1) / kBN), (unsigned)gy);
  gemm_f64_perm_kernel<<<grid, kThreads, 0, stream>>>(a, lda_m, lda_k, b, ldb_k, ldb_n, c,
                                                       st, M, N, K);
  return cudaGetLastError();
}

}  // namespace
