// K2: projected KKT block matvec
//     y[l,m,L] = sum phi_l[l,s,r] A[s,m,n,S] phi_r[L,S,R] x[r,n,R]
//
// Replaces: ttipm_tpu/ops/kernels.py::kkt_block_matvec (Pallas kernel
// _kkt_matvec_kernel), the fused algebra's `apply` / `apply_T`
// (ttipm_tpu/solvers/fused_algebra.py:41-45), which every local solve calls
// through local_product, z_product and mixed_product (6 applies each).
//
// Bound on the H100: at the slice's shapes (bond ranks l, r, L, R <= 36,
// physical 4, operator ranks s, S of 1..~100) the three stages are GEMMs
// of 2*(l s r n R + m S s n l R + l m S R L) flops, 10 MFLOP at R = 36,
// s = S = 9: 0.3 us at the card's 34 TFLOP/s f64 CUDA-core peak (NVIDIA
// data sheet, SXM).  The bytes moved (operands plus two staged
// intermediates) are a few hundred KB.  So one call is bound by launch
// latency and by the dependency chain of its three stages, not by flops
// or bandwidth.
//
// Design: the Pallas kernel's three chained matmuls with transpose-reshapes
// become three launches of one tiled f64 GEMM (gemm_f64.cuh) whose store
// writes each intermediate directly in the layout the next stage reads as a
// plain row-major matrix; the scratch buffers come from the wrapper.  The
// staged form costs O(R^3 s) flops where a per-output-element sum would
// cost O(R^4 s S).  Fusing the stages into one persistent launch is later
// work.
#include "gemm_f64.cuh"

extern "C" int ttipm_kkt_matvec(const double* phil, const double* a2, const double* phir,
                                const double* x, double* t1, double* t2, double* y, int l,
                                int s, int r, int m, int n, int S, int L, int R,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // stage 1: t1[s,n,l,R] = sum_r phil[(l,s), r] x[r, (n,R)]
  PermStore p1{s, R, (long long)n * l * R, R, (long long)l * R, 1};
  cudaError_t err = launch_gemm_f64(phil, r, 1, x, (long long)n * R, 1, t1, p1, l * s, n * R,
                                    r, st);
  if (err != cudaSuccess) return (int)err;
  // stage 2: t2[l,m,S,R] = sum_(s,n) a2[(m,S), (s,n)] t1[(s,n), (l,R)]
  PermStore p2{S, (long long)S * R, R, R, (long long)m * S * R, 1};
  err = launch_gemm_f64(a2, (long long)s * n, 1, t1, (long long)l * R, 1, t2, p2, m * S,
                        l * R, s * n, st);
  if (err != cudaSuccess) return (int)err;
  // stage 3: y[(l,m), L] = sum_(S,R) t2[(l,m), (S,R)] phir[L, (S,R)]
  PermStore p3{(long long)l * m, 0, L, L, 0, 1};
  err = launch_gemm_f64(t2, (long long)S * R, 1, phir, 1, (long long)S * R, y, p3, l * m, L,
                        S * R, st);
  return (int)err;
}

extern "C" const char* ttipm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
