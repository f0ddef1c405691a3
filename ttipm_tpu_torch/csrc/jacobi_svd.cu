// J1: one-sided Jacobi orthogonalisation of a square f64 matrix (the core
// of the port's SVD on the card).
//
// Replaces no Pallas kernel.  It is the counterpart of the jnp program
// ttipm_tpu/ops/jacobi.py::_jacobi_orthogonalise (:121), which the JAX
// package runs as one XLA program a factorization for every f64 SVD of a
// TPU trace (jacobi_svd, :208).  It was added because the port's SVDs on
// the card were cuSOLVER calls, each a library launch sequence with a
// host check of its info, 3,133 of them in a maxcut d8 solve
// (tools/jacobi_census.py); this kernel
// decides convergence on the device and never synchronises with the host.
// The pipeline around it (ttipm_tpu_torch/ops/jacobi.py::_factor_tall: the
// scaling, K3's QR of the operand and of r^T, the sort by column norm,
// K3's completion QR) is torch code and K3.
//
// Contract: a, nbatch contiguous (n, n) f64 matrices W, n even, 2 <= n <=
// kMaxN (the tall pipeline's r2^T, padded to even order).  Out: W V (the
// rotated columns), V (exactly orthonormal: a product of rotations) and the
// squared column norms of W V, each contiguous.  Same schedule, rotation
// rule, tolerance and stop test as the plain version
// (ops/jacobi.py::orthogonalise_plain): the round-robin steps of n / 2
// disjoint pairs, n - 1 steps a sweep; with s_ij = max(sqrt(a b),
// floor_rel s0, 1e-30), s0 the input's largest squared column norm, a pair
// with Gram entries a = <wi, wi>, b = <wj, wj>, c = <wi, wj> is rotated
// where |c| > tol s_ij, by t = sign(tau) / (|tau| + sqrt(1 + tau^2)), tau =
// (b - a) / (2 c); the sweeps stop after one without a rotation, or after
// 26 (the JAX program has no floor and tests the Gram matrix formed after
// each sweep: see orthogonalise_plain).  An instance that still rotated in
// its 26th sweep, or met a non-finite sum, comes out as NaN in all three
// outputs.
//
// Design.  One CTA an instance holds W and V column-major in shared memory
// with an odd leading dimension: 2 n (n + 1) 8 bytes, 224 KB at n = 118,
// the bound (kMaxN).  A warp owns a pair of the step (at most 32 warps,
// pairs p = warp mod W): its lanes read the two columns of W (rows strided
// by 32), form the three sums and reduce them with xor shuffles, so that
// every lane holds the same bits and computes the same rotation, then
// rotate the two columns of W and of V in place.  The pairs of a step are
// disjoint, so the warps touch disjoint columns; one __syncthreads ends a
// step.  A warp that rotates (or meets a non-finite sum) sets a flag in
// shared memory, read after the sweep.  An instance's result does not depend on the batch: the batch is
// the grid, and nothing is shared between CTAs.
//
// Bound on the H100: a pair costs 18 n flops (the three sums 6 n, the
// rotations of two columns of W and of V 12 n), n / 2 pairs a step, n - 1
// steps a sweep: about 9 n^2 (n - 1) flops a sweep, which chip_smoke.py's bound_ms counts for the sweeps this run's
// data needed (the kernel reports them), and n^2 8 bytes in, 2 n^2 + n
// out.  At the solve's orders (4-60) that is well
// under a microsecond of the card by either measure.  What bounds the
// kernel is latency: n - 1 dependent steps a sweep, each a chain of loads,
// a five-level shuffle reduction, a square root and two divisions, the
// updates and a block barrier.
#include <cuda_runtime.h>

#include "jacobi.cuh"

namespace {

using namespace ttipm::jacobi;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxN = 118;
constexpr int kMaxThreads = 1024;
constexpr int kScratch = 64;

size_t smem_bytes(int n) { return sizeof(double) * (2 * (size_t)n * (n | 1) + n + kScratch); }

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max_nan(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__global__ void __launch_bounds__(kMaxThreads, 1)
jacobi_svd_kernel(const double* __restrict__ a, int n, double tol, double floor_rel,
                  double* __restrict__ w_out,
                  double* __restrict__ v_out, double* __restrict__ norms_out,
                  int* __restrict__ sweeps_out) {
  extern __shared__ double smem[];
  const int ld = n | 1;
  double* W = smem;        // column c at W + c * ld
  double* V = W + n * ld;
  double* d = V + n * ld;  // squared column norms of W
  double* red = d + n;     // kScratch: the warps' maxima, the input's, the sweep's flags
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const long long nn = (long long)n * n;
  const double* ab = a + blockIdx.x * nn;
  for (int e = tid; e < n * n; e += nthreads) {
    const int r = e / n, c = e - r * n;
    W[c * ld + r] = ab[e];
    V[c * ld + r] = r == c ? 1.0 : 0.0;
  }
  __syncthreads();
  // the floor of the pairs' scale: floor_rel times the largest squared
  // column norm of the input
  double m0 = 0.0;
  for (int c = tid; c < n; c += nthreads) {
    const double* wc = W + c * ld;
    double s = 0.0;
    for (int r = 0; r < n; ++r) s = fma(wc[r], wc[r], s);
    m0 = max_nan(m0, s);
  }
  m0 = warp_max(m0);
  if (lane == 0) red[warp] = m0;
  __syncthreads();
  if (tid == 0) {
    double t = red[0];
    for (int w = 1; w < nwarps; ++w) t = max_nan(t, red[w]);
    red[32] = t;
  }
  __syncthreads();
  const double pair_floor = floor_rel * red[32];
  const int h = n / 2;
  int sweeps = 0;
  bool failed = true;
  while (sweeps < kMaxSweeps) {
    if (tid == 0) red[40] = red[41] = 0.0;  // this sweep: a rotation, a non-finite sum
    __syncthreads();
    for (int k = 0; k < n - 1; ++k) {
      for (int p = warp; p < h; p += nwarps) {
        const int i = schedule_index(n, k, p), j = schedule_index(n, k, n - 1 - p);
        double* wi = W + i * ld;
        double* wj = W + j * ld;
        double sa = 0.0, sb = 0.0, sc = 0.0;
        for (int r = lane; r < n; r += 32) {
          const double x = wi[r], y = wj[r];
          sa = fma(x, x, sa);
          sb = fma(y, y, sb);
          sc = fma(x, y, sc);
        }
        sa = warp_sum(sa);
        sb = warp_sum(sb);
        sc = warp_sum(sc);
        const bool rotate = fabs(sc) > tol * fmax(__dsqrt_rn(sa * sb), pair_floor);
        if (lane == 0 && rotate) red[40] = 1.0;
        if (lane == 0 && !isfinite(sa + sb + sc)) red[41] = 1.0;
        double cs, sn;
        rotation(rotate, __ddiv_rn(sb - sa, 2.0 * (rotate ? sc : 1.0)), cs, sn);
        if (rotate) {
          double* vi = V + i * ld;
          double* vj = V + j * ld;
          for (int r = lane; r < n; r += 32) {
            const double x = wi[r], y = wj[r];
            wi[r] = cs * x - sn * y;
            wj[r] = sn * x + cs * y;
            const double u = vi[r], w = vj[r];
            vi[r] = cs * u - sn * w;
            vj[r] = sn * u + cs * w;
          }
        }
      }
      __syncthreads();
    }
    ++sweeps;
    const bool rotated = red[40] != 0.0, bad = red[41] != 0.0;
    __syncthreads();  // the flags are read before they are reset
    failed = rotated || bad;
    if (!failed || bad) break;
  }
  for (int c = tid; c < n; c += nthreads) {
    const double* wc = W + c * ld;
    double s = 0.0;
    for (int r = 0; r < n; ++r) s = fma(wc[r], wc[r], s);
    d[c] = s;
  }
  __syncthreads();
  const bool bad = failed;
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  double* wo = w_out + blockIdx.x * nn;
  double* vo = v_out + blockIdx.x * nn;
  for (int e = tid; e < n * n; e += nthreads) {
    const int r = e / n, c = e - r * n;
    wo[e] = bad ? nan : W[c * ld + r];
    vo[e] = bad ? nan : V[c * ld + r];
  }
  for (int c = tid; c < n; c += nthreads) norms_out[blockIdx.x * (long long)n + c] = bad ? nan : d[c];
  if (tid == 0 && sweeps_out != nullptr) sweeps_out[blockIdx.x] = sweeps;
}

}  // namespace

// a: nbatch contiguous (n, n) f64 matrices; w, v: nbatch (n, n) outputs,
// norms2: nbatch n outputs, all contiguous; sweeps: null, or nbatch ints
// that receive each instance's sweeps.  tol: the plain version's
// tol_for(n).  threads: ops/kernels.py::j1_plan (a warp a pair, at most
// 32).  The dynamic shared memory limit is raised once per device.
extern "C" int ttipm_jacobi_svd(const double* a, int nbatch, int n, double tol,
                                double floor_rel, double* w,
                                double* v, double* norms2, int* sweeps, int threads,
                                void* stream) {
  if (n < 2 || n > kMaxN || n % 2 != 0 || nbatch < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || !(tol > 0.0) || !(floor_rel >= 0.0))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n);
  if (smem > (size_t)kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  static unsigned raised = 0;  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(raised & bit)) {
    err = cudaFuncSetAttribute(jacobi_svd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxDynamicSmem);
    if (err != cudaSuccess) return (int)err;
    raised |= bit;
  }
  jacobi_svd_kernel<<<nbatch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, n, tol, floor_rel, w, v, norms2, sweeps);
  return (int)cudaGetLastError();
}
