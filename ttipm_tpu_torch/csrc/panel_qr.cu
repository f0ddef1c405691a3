// K3: reduced Householder QR of a tall panel (m >= n)
//
// Replaces: ttipm_tpu/ops/kernels.py::panel_qr (Pallas kernel
// _panel_qr_kernel, dispatcher qr_reduced), used by the fused sweeps'
// bond splits on the enrichment-augmented basis u_aug
// (ttipm_tpu/solvers/fused_algebra.py:284,370).
//
// Bound on the H100: the panels are (4 R', w) with R' the neighbouring bond
// rank and w <= R + kick, at most (144, 36) f64 = 41 KB at R = 32.  The
// factorization is ~2 m n^2 = 0.4 MFLOP, a fraction of a microsecond of any
// SM; what bounds it is the n sequential reflector steps, each a reduction
// plus a rank-1 update with block-wide synchronisation.  So the kernel is
// latency-bound, and the design keeps everything in one SM's shared memory.
//
// Design: one thread block per panel.  The panel (column-major) and the Q
// accumulator live in dynamic shared memory (2 m n + n doubles; up to
// 227 KB).  For each column a block reduction gives the norm below the
// diagonal and LAPACK's dlarfg rule gives the reflector (tau = 0 when the
// column is already reduced, beta = -sign(x_j) ||x||), so Q and R carry
// LAPACK's signs.  The reflector is applied to the trailing columns one
// warp per column.  Q is formed by backward accumulation of the reflectors
// on I[:, :n]; R is written with exact zeros below the diagonal.
#include <cuda_runtime.h>

namespace {

constexpr int kQrThreads = 256;

__device__ double block_sum(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = (lane < (int)(blockDim.x >> 5)) ? red[lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

__device__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// H = I - tau v v^T with v[j] = 1 and v[i > j] = V[i + j m], applied to
// columns c0.. of the column-major m x n matrix X (rows j..m-1).
__device__ void apply_reflector(const double* V, double* X, int m, int n, int j, int c0,
                                double tau) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int c = c0 + warp; c < n; c += nwarps) {
    double w = 0.0;
    for (int i = j + lane; i < m; i += 32) {
      const double vi = (i == j) ? 1.0 : V[i + (long long)j * m];
      w += vi * X[i + (long long)c * m];
    }
    w = tau * warp_sum(w);
    for (int i = j + lane; i < m; i += 32) {
      const double vi = (i == j) ? 1.0 : V[i + (long long)j * m];
      X[i + (long long)c * m] -= vi * w;
    }
  }
}

__global__ void __launch_bounds__(kQrThreads)
panel_qr_kernel(const double* __restrict__ a, double* __restrict__ q,
                double* __restrict__ r, int m, int n) {
  extern __shared__ double smem[];
  double* A = smem;                       // m x n, column-major; v below diag
  double* Q = smem + (long long)m * n;    // m x n, column-major
  double* tau = Q + (long long)m * n;     // n
  __shared__ double red[32];
  __shared__ double s_beta, s_tau, s_scale;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long mn = (long long)m * n;

  for (long long e = tid; e < mn; e += nt) {
    const int i = (int)(e / n), j = (int)(e % n);
    A[i + (long long)j * m] = a[e];
  }
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    double part = 0.0;
    for (int i = j + 1 + tid; i < m; i += nt) {
      const double x = A[i + (long long)j * m];
      part += x * x;
    }
    const double sigma2 = block_sum(part, red);
    if (tid == 0) {
      const double xj = A[j + (long long)j * m];
      if (sigma2 == 0.0) {
        s_tau = 0.0;
        s_beta = xj;
        s_scale = 0.0;
      } else {
        const double beta = -copysign(sqrt(xj * xj + sigma2), xj);
        s_tau = (beta - xj) / beta;
        s_scale = 1.0 / (xj - beta);
        s_beta = beta;
      }
    }
    __syncthreads();
    const double tj = s_tau;
    if (tj != 0.0) {
      const double sc = s_scale;
      for (int i = j + 1 + tid; i < m; i += nt) A[i + (long long)j * m] *= sc;
    }
    __syncthreads();
    if (tid == 0) {
      A[j + (long long)j * m] = s_beta;
      tau[j] = tj;
    }
    if (tj != 0.0) apply_reflector(A, A, m, n, j, j + 1, tj);
    __syncthreads();
  }

  for (long long e = tid; e < mn; e += nt) {
    const int i = (int)(e % m), c = (int)(e / m);
    Q[e] = (i == c) ? 1.0 : 0.0;
  }
  __syncthreads();
  for (int j = n - 1; j >= 0; --j) {
    if (tau[j] != 0.0) apply_reflector(A, Q, m, n, j, j, tau[j]);
    __syncthreads();
  }

  for (long long e = tid; e < mn; e += nt) {
    const int i = (int)(e / n), c = (int)(e % n);
    q[e] = Q[i + (long long)c * m];
  }
  for (long long e = tid; e < (long long)n * n; e += nt) {
    const int i = (int)(e / n), c = (int)(e % n);
    r[e] = (i <= c) ? A[i + (long long)c * m] : 0.0;
  }
}

}  // namespace

extern "C" int ttipm_panel_qr(const double* a, double* q, double* r, int m, int n,
                              void* stream) {
  if (m < n || n < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = (2 * (size_t)m * n + n) * sizeof(double);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(panel_qr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  panel_qr_kernel<<<1, kQrThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a, q, r, m, n);
  return (int)cudaGetLastError();
}
