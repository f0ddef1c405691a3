// K1: Schur block assembly
//     B[(l,m,L),(r,n,R)] = sum_{s,S} phi_l[l,s,r] A[s,m,n,S] phi_r[L,S,R]
//
// Replaces: ttipm_tpu/ops/kernels.py::schur_assemble (Pallas kernel
// _schur_kernel), the fused algebra's `proj`
// (ttipm_tpu/solvers/fused_algebra.py:47): four calls per local factor
// (ttipm_tpu/solvers/fused.py:110-117) and the eigen-window assemblies
// (ttipm_tpu/solvers/fused_eigen.py:44-53).
//
// Bound on the H100: B is (4 l L) x (4 r R); at bond rank 36 that is
// 5184 x 5184 f64 = 215 MB written once, against 2 * 5184^2 * S flops for
// the S-contraction: 215 MB at 3.35 TB/s is 64 us, and the flops at the
// 34 TFLOP/s f64 CUDA-core peak (NVIDIA data sheet, SXM) are 64 us at
// S = 40.  Below operator rank ~40 the kernel is bound by writing B to
// device memory, above it by f64 FMA throughput.
//
// Design: as on the TPU, stage 1 W[l,m,r,n,S] = phi_l . A (the small
// s-contraction) is an einsum in the wrapper.  The kernel is the
// S-contraction GEMM (l m r n) x S x (L R) with the 6-D interleave
// (l,m,r,n),(L,R) -> (l,m,L),(r,n,R) done in its store, so B is written
// once in its final layout and never relaid out.  Each output element is
// stored exactly once; rows of consecutive R are contiguous.
#include "gemm_f64.cuh"

extern "C" int ttipm_schur_assemble(const double* W, const double* P, double* out, int l,
                                    int m, int r, int n, int S, int L, int R, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rnR = (long long)r * n * R;
  // row i = (l,m | r,n) of W, column j = (L | R) of P
  PermStore ps{(long long)r * n, (long long)L * rnR, R, R, rnR, 1};
  return (int)launch_gemm_f64(W, S, 1, P, (long long)L * R, 1, out, ps, l * m * r * n, L * R,
                              S, st);
}
