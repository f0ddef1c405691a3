// K4: blocked lower Cholesky factorization with failure report
//
// Replaces: ttipm_tpu/ops/kernels.py::panel_cholesky (Pallas kernel
// _panel_cholesky_kernel, dispatcher cholesky_lower): the L_Z factor of
// every fused local solve (ttipm_tpu/solvers/fused.py:110,
// fused_host.py:115) and the whitened shrink pencil of the step-size
// eigensolver (ttipm_tpu/solvers/fused_eigen.py:65).
//
// Contract (differs from the TPU kernel): the matrix's lower triangle is
// factored in place (row-major), the strict upper triangle is zeroed, and
// the first pivot that is not positive (or not a number) is reported in
// `info` as its 1-based order, like torch.linalg.cholesky_ex; nothing is
// clamped.  The fused local solve relies on that failure signal to keep
// its previous core.
//
// Bound on the H100: n = 4 R'^2 for the solve's bond ranks, up to ~5200
// (215 MB f64) at R = 32 plus enrichment; n^3 / 3 = 47 GFLOP there, 1.4 ms
// at the 34 TFLOP/s f64 CUDA-core peak (NVIDIA data sheet, SXM).  Most of
// the flops are in the trailing updates, which are GEMM-shaped, so large n
// is bound by f64 FMA throughput; at the small n of early solves (n = 256
// at R = 8) the n / 32 sequential steps make it latency-bound.
//
// Design: a single block cannot hold n = 4096 in shared memory, so this is
// a right-looking blocked factorization with 32-column panels, three
// launches per panel: (1) factor the 32 x 32 diagonal block in shared
// memory (one block), (2) triangular-solve the panel below it (64 rows per
// block), (3) subtract L21 L21^T from the lower triangle of the trailing
// matrix in 64 x 64 tiles (register-blocked, 4 x 4 per thread).  Every
// launch first reads `info` and returns if an earlier panel failed.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kNB = 32;       // panel width
constexpr int kTile = 64;     // trailing-update tile and panel rows per block
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
chol_diag_kernel(double* __restrict__ A, int n, int k0, int nb, int* __restrict__ info) {
  if (*info != 0) return;
  __shared__ double T[kNB][kNB + 1];
  __shared__ int fail;
  const int tid = threadIdx.x;
  for (int e = tid; e < nb * nb; e += kThreads) {
    const int i = e / nb, j = e % nb;
    T[i][j] = A[(long long)(k0 + i) * n + k0 + j];
  }
  if (tid == 0) fail = 0;
  __syncthreads();
  for (int j = 0; j < nb; ++j) {
    if (tid == 0) {
      const double d = T[j][j];
      if (!(d > 0.0)) fail = j + 1;
      else T[j][j] = sqrt(d);
    }
    __syncthreads();
    if (fail) break;
    const double piv = T[j][j];
    for (int i = j + 1 + tid; i < nb; i += kThreads) T[i][j] /= piv;
    __syncthreads();
    const int w = nb - j - 1;
    for (int e = tid; e < w * w; e += kThreads) {
      const int i = j + 1 + e / w, c = j + 1 + e % w;
      if (c <= i) T[i][c] -= T[i][j] * T[c][j];
    }
    __syncthreads();
  }
  if (fail) {
    if (tid == 0) *info = k0 + fail;
    return;
  }
  for (int e = tid; e < nb * nb; e += kThreads) {
    const int i = e / nb, j = e % nb;
    if (j <= i) A[(long long)(k0 + i) * n + k0 + j] = T[i][j];
  }
}

// L21 = A21 L11^{-T} for the rows below the diagonal block.
__global__ void __launch_bounds__(kThreads)
chol_trsm_kernel(double* __restrict__ A, int n, int k0, int nb, const int* __restrict__ info) {
  if (*info != 0) return;
  __shared__ double Lk[kNB][kNB + 1];
  __shared__ double X[kTile][kNB + 1];
  const int tid = threadIdx.x;
  const int row0 = k0 + nb + blockIdx.x * kTile;
  const int rows = min(kTile, n - row0);
  for (int e = tid; e < nb * nb; e += kThreads) {
    const int i = e / nb, j = e % nb;
    Lk[i][j] = A[(long long)(k0 + i) * n + k0 + j];
  }
  for (int e = tid; e < rows * nb; e += kThreads) {
    const int i = e / nb, j = e % nb;
    X[i][j] = A[(long long)(row0 + i) * n + k0 + j];
  }
  __syncthreads();
  for (int j = 0; j < nb; ++j) {
    const double piv = Lk[j][j];
    for (int i = tid; i < rows; i += kThreads) X[i][j] /= piv;
    __syncthreads();
    const int w = nb - j - 1;
    for (int e = tid; e < rows * w; e += kThreads) {
      const int i = e / w, c = j + 1 + e % w;
      X[i][c] -= X[i][j] * Lk[c][j];
    }
    __syncthreads();
  }
  for (int e = tid; e < rows * nb; e += kThreads) {
    const int i = e / nb, j = e % nb;
    A[(long long)(row0 + i) * n + k0 + j] = X[i][j];
  }
}

// A22 -= L21 L21^T on the lower-triangle tiles of the trailing matrix.
__global__ void __launch_bounds__(kThreads)
chol_syrk_kernel(double* __restrict__ A, int n, int k0, int nb, const int* __restrict__ info) {
  if (*info != 0) return;
  if (blockIdx.x > blockIdx.y) return;  // strictly upper tile
  __shared__ double Li[kTile][kNB + 1];
  __shared__ double Lj[kTile][kNB + 1];
  const int tid = threadIdx.x;
  const int k1 = k0 + nb;
  const int i0 = k1 + blockIdx.y * kTile;
  const int j0 = k1 + blockIdx.x * kTile;
  for (int e = tid; e < kTile * nb; e += kThreads) {
    const int rr = e / nb, p = e % nb;
    Li[rr][p] = (i0 + rr < n) ? A[(long long)(i0 + rr) * n + k0 + p] : 0.0;
    Lj[rr][p] = (j0 + rr < n) ? A[(long long)(j0 + rr) * n + k0 + p] : 0.0;
  }
  __syncthreads();
  const int tx = tid % 16, ty = tid / 16;
  double acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0;
  for (int p = 0; p < nb; ++p) {
    double li[4], lj[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) li[a] = Li[ty + 16 * a][p];
#pragma unroll
    for (int b = 0; b < 4; ++b) lj[b] = Lj[tx + 16 * b][p];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fma(li[a], lj[b], acc[a][b]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= n) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx + 16 * b;
      if (j < n && j <= i) A[(long long)i * n + j] -= acc[a][b];
    }
  }
}

__global__ void zero_upper_kernel(double* __restrict__ A, int n) {
  const long long total = (long long)n * n;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    if (e % n > e / n) A[e] = 0.0;
  }
}

}  // namespace

extern "C" int ttipm_panel_cholesky(double* A, int n, int* info, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int k0 = 0; k0 < n; k0 += kNB) {
    const int nb = std::min(kNB, n - k0);
    chol_diag_kernel<<<1, kThreads, 0, st>>>(A, n, k0, nb, info);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int rem = n - k0 - nb;
    if (rem > 0) {
      const unsigned tiles = (unsigned)((rem + kTile - 1) / kTile);
      chol_trsm_kernel<<<tiles, kThreads, 0, st>>>(A, n, k0, nb, info);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      chol_syrk_kernel<<<dim3(tiles, tiles), kThreads, 0, st>>>(A, n, k0, nb, info);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  const long long total = (long long)n * n;
  const unsigned blocks = (unsigned)std::min<long long>((total + 255) / 256, 4096);
  zero_upper_kernel<<<blocks, 256, 0, st>>>(A, n);
  return (int)cudaGetLastError();
}
