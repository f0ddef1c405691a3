// J1: one-sided Jacobi orthogonalisation of a square f64 matrix (the core
// of the port's SVD on the card), in two regimes chosen by the order:
// element rotations below ops/kernels.py's J1_BLOCK_FROM, a two-level
// (block) one-sided Jacobi from there to kMaxBlockN.
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
// kMaxBlockN (the tall pipeline's r2^T, padded to even order; the element
// regime to kMaxN).  Out: W V (the rotated columns), V (exactly
// orthonormal: a product of rotations) and the squared column norms of
// W V, each contiguous.  The rotation rule, tolerance and stop test are
// the plain versions' (ops/jacobi.py::orthogonalise_plain,
// orthogonalise_block_plain): with s_ij = max(sqrt(a b), floor_rel s0), s0
// the input's largest squared column norm, a pair with Gram entries a =
// <wi, wi>, b = <wj, wj>, c = <wi, wj> is rotated where |c| > tol s_ij, by
// t = sign(tau) / (|tau| + sqrt(1 + tau^2)), tau = (b - a) / (2 c); the
// sweeps stop after one without a rotation, or after 26 (the JAX program
// has no floor and tests the Gram matrix formed after each sweep: see
// orthogonalise_plain).  An instance that still rotated in its 26th sweep,
// or met a non-finite sum, comes out as NaN in all three outputs.  An
// instance's result does not depend on the batch: the batch is the grid
// (the element regime's x axis, the block regime's y axis), and nothing is
// shared between instances.
//
// Element regime (jacobi_svd_kernel).  One CTA an instance holds W and V
// column-major in shared memory with an odd leading dimension: 2 n (n + 1)
// 8 bytes, 224 KB at n = 118, its bound (kMaxN).  The round-robin steps of
// n / 2 disjoint pairs, n - 1 steps a sweep; a warp owns a pair of the step
// (at most 32 warps, pairs p = warp mod W): its lanes read the two columns
// of W (rows strided by 32), form the three sums and reduce them with xor
// shuffles, so that every lane holds the same bits and computes the same
// rotation, then rotate the two columns of W and of V in place.  The pairs
// of a step are disjoint, so the warps touch disjoint columns; one
// __syncthreads ends a step.  What bounds it is latency: n - 1 dependent
// steps a sweep (two rounds of warps a step above order 64), each a chain
// of loads, three five-level shuffle reductions, a square root and two
// divisions, the updates and a block barrier (clock stamps, PERF.md).
//
// Block regime (jacobi_svd_block_kernel, kB = 16).  The n columns are cut
// into nb = ceil(n / kB) blocks of kB (the last ragged, and an empty one where nb
// is odd, so that nb is even); the outer sweep runs the round robin of
// order nb over the blocks, nb - 1 outer steps of nb / 2 slots, a slot a
// pair of blocks (P, Q), a CTA a slot, a cluster of nb / 2 CTAs an instance
// (at most 4).  Blocks of 8 (a cluster of up to 8) were measured slower at
// orders 52-64 and 80-128 (PERF.md).  CTA s holds the block columns at
// positions s (half 0) and nb - 1 - s (half 1) of the schedule, of W and of
// V, all rows, twice (an outer step reads one copy; the other receives the
// next step's columns).  An outer step:
//  1. the Gram matrix G = [W_P W_Q]^T [W_P W_Q] (2 kB x 2 kB) on the f64
//     tensor cores (mma.sync m16n8k4, a warp a 16 x 8 tile);
//  2. the inner problem: one cyclic sweep of the element rule on G,
//     accumulating the slot's orthogonal U (jacobi.cuh::inner_sweep, J2's:
//     a = g_ii, b = g_jj, c = (g_ij + g_ji) / 2, J1's floor; refined
//     rotations, quiet tiles skipped, U's columns scaled to unit length);
//  3. the products and the ring shift: [W_P W_Q] U and [V_P V_Q] U on the
//     tensor cores (a warp a strip of 16 rows of W or V), each result
//     stored where the round robin moves its block column next: this CTA's
//     other copy or a neighbour's, by distributed-shared-memory stores (a
//     copy where U = I); the slot's flags (rotated, non-finite) to every
//     CTA, two parities;
//  4. one cluster barrier.
// No step loads through distributed shared memory.  Columns past the order
// (the ragged and the empty block) are zeros, which never rotate, and stay
// zeros under the products.  The outer sweeps stop after one in which no
// inner sweep rotated: every pair of columns has then met in some slot on
// W as it is.  After a whole sweep the blocks are back where they started.
// The scale s0 is the one cluster-wide reduction.
//
// Bound on the H100 (chip_smoke.py's bound_ms, for both regimes the element
// schedule's work): a pair costs 18 n flops (the three sums 6 n, the
// rotations of two columns of W and of V 12 n), n / 2 pairs a step, n - 1
// steps a sweep: about 9 n^2 (n - 1) flops a sweep, for the sweeps the
// element rule needs on the operand, and n^2 8 bytes in, 2 n^2 + n out: at
// order 128 and 10 sweeps 0.19 GFLOP, 2.8 us at the card's 67 TFLOP/s f64.
// What bounds the block regime is latency too, but of the inner steps:
// 2 kB - 1 an outer step, each a chain of square roots and divisions and
// two CTA barriers, in all slots at once.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "jacobi.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ttipm::jacobi;

constexpr int kMaxN = 118;        // the element regime's bound
constexpr int kMaxBlockN = 128;   // the block regime's
constexpr int kMaxThreads = 1024;
constexpr int kScratch = 64;
constexpr int kMaxBlockCtas = 4;

// The block regime's block width, and its threads: one 2 x 2 block of the
// inner tile each.
constexpr int kB = 16;
constexpr int kBlockThreads = kB * kB;

size_t smem_bytes(int n) { return sizeof(double) * (2 * (size_t)n * (n | 1) + n + kScratch); }

// Leading dimension of the block regime's columns: the rows rounded up to
// 16, plus 4 (conflict-free tensor core fragments, as J2's).
__host__ __device__ inline int block_ld(int n) { return (n + 15) / 16 * 16 + 4; }

// The block regime's shared memory (ops/kernels.py::_j1_block_smem): the two
// copies of the slot's columns of W and V, the inner sweep's two tiles, U,
// the inner step's rotations (two parities), the cluster's maxima; the
// slots' flags (two parities) and the inner steps' votes.
size_t block_smem_bytes(int n) {
  const size_t m = 2 * kB;
  return sizeof(double) * (4 * m * block_ld(n) + 2 * m * (m + 1) + m * (m + 4) + 4 * kB +
                           kMaxBlockCtas) +
         sizeof(int) * (2 * kMaxBlockCtas + 2);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// The element regime
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kMaxThreads, 1)
jacobi_svd_kernel(const double* __restrict__ a, int n, double tol, double floor_rel,
                  double* __restrict__ w_out,
                  double* __restrict__ v_out, double* __restrict__ norms_out,
                  int* __restrict__ sweeps_out, long long* __restrict__ stamps) {
  extern __shared__ double smem[];
  const int ld = n | 1;
  double* W = smem;        // column c at W + c * ld
  double* V = W + n * ld;
  double* d = V + n * ld;  // squared column norms of W
  double* red = d + n;     // kScratch: the warps' maxima, the input's, the sweep's flags
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  Stamps st(stamps, stamps != nullptr && tid == 0 && blockIdx.x == 0);
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
  st.lap(0);
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
        if (st.out != nullptr) {
          wait_for(sa + sb + sc);
          st.lap(1);
        }
        sa = warp_sum(sa);
        sb = warp_sum(sb);
        sc = warp_sum(sc);
        if (st.out != nullptr) {
          wait_for(sa + sb + sc);
          st.lap(2);
        }
        const bool rotate = fabs(sc) > tol * fmax(__dsqrt_rn(sa * sb), pair_floor);
        if (lane == 0 && rotate) red[40] = 1.0;
        if (lane == 0 && !isfinite(sa + sb + sc)) red[41] = 1.0;
        double cs, sn;
        rotation(rotate, __ddiv_rn(sb - sa, 2.0 * (rotate ? sc : 1.0)), cs, sn);
        if (st.out != nullptr) {
          wait_for(cs + sn);
          st.lap(3);
        }
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
        st.lap(4);
      }
      __syncthreads();
      st.lap(5);
      st.count(7);
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
  st.lap(6);
  st.count(8, sweeps);
}

// ---------------------------------------------------------------------------
// The block regime
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kBlockThreads, 1)
jacobi_svd_block_kernel(const double* __restrict__ a, int n, double tol, double floor_rel,
                        double* __restrict__ w_out, double* __restrict__ v_out,
                        double* __restrict__ norms_out, int* __restrict__ sweeps_out,
                        long long* __restrict__ stamps) {
  constexpr int kM = 2 * kB;      // columns of a slot
  constexpr int kLdS = kM + 1;    // the Gram tile's leading dimension
  constexpr int kLdU = kM + 4;    // U's: conflict-free tensor core fragments
  constexpr int kGramTiles = (kM / 16) * (kM / 8);
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = (int)gridDim.x;
  const int rank = (int)cluster.block_rank();  // the slot
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int g = lane >> 2, t = lane & 3;  // the tensor core fragment coordinates
  const int nb = (n + kB - 1) / kB, np = 2 * ctas;
  const int ld = block_ld(n);
  const int strips = (n + 15) / 16;  // row strips of 16 of the products
  const int rows4 = (n + 3) / 4 * 4;  // the Gram's depth (the rows past n are zeros)
  extern __shared__ __align__(16) double block_smem[];
  // a copy: W's virtual column h kB + j (block of half h, its column j) at
  // copy + (h kB + j) ld, V's kM ld further
  const int copy = 2 * kM * ld;
  double* cur = block_smem;
  double* nxt = cur + copy;
  double* tile = nxt + copy;            // the inner sweep's two tiles
  double* umine = tile + 2 * kM * kLdS;  // the slot's U
  double* rcs = umine + kM * kLdU;      // parity r: cs at rcs + 2 kB r, sn kB further
  double* red = rcs + 4 * kB;           // kMaxBlockCtas: each CTA's largest squared norm
  int* flags = reinterpret_cast<int*>(red + kMaxBlockCtas);  // [parity][slot]: 1 rotated, 2 non-finite
  int* vote = flags + 2 * kMaxBlockCtas;  // an inner step's rotation, two parities
  Stamps st(stamps, stamps != nullptr && tid == 0 && rank == 0 && blockIdx.y == 0);
  const long long nn = (long long)n * n;
  const double* ab = a + blockIdx.y * nn;
  auto width = [&](int blk) { return blk < nb ? min(kB, n - blk * kB) : 0; };

  // Both copies zero (rows past the order, columns past it), then the
  // columns of the blocks at positions rank and np - 1 - rank of step 0
  // (where every sweep ends) and V = I on them; this CTA's largest squared
  // column norm.
  {
    for (int e = tid; e < 2 * copy; e += nthreads) cur[e] = 0.0;
    __syncthreads();
    const int P = schedule_index(np, 0, rank), Q = schedule_index(np, 0, np - 1 - rank);
    for (int e = tid; e < n * kM; e += nthreads) {
      const int r = e / kM, vc = e - r * kM;
      const int blk = vc < kB ? P : Q, j = vc < kB ? vc : vc - kB;
      if (j < width(blk)) {
        const int c = blk * kB + j;
        cur[vc * ld + r] = ab[(long long)r * n + c];
        cur[(kM + vc) * ld + r] = r == c ? 1.0 : 0.0;
      }
    }
    __syncthreads();
    double m0 = 0.0;
    for (int vc = tid; vc < kM; vc += nthreads) {
      const double* wc = cur + vc * ld;
      double s = 0.0;
      for (int r = 0; r < n; ++r) s = fma(wc[r], wc[r], s);
      m0 = max_nan(m0, s);
    }
    m0 = warp_max(m0);
    if (lane == 0) tile[warp] = m0;
    __syncthreads();
    if (tid == 0) {
      double m = tile[0];
      for (int w = 1; w < nwarps; ++w) m = max_nan(m, tile[w]);
      for (int r = 0; r < ctas; ++r) cluster.map_shared_rank(red, r)[rank] = m;
    }
    cluster.sync();
  }
  double m0_all = red[0];
  for (int r = 1; r < ctas; ++r) m0_all = max_nan(m0_all, red[r]);
  const double s0 = floor_rel * m0_all;
  // where the round robin moves each half's block column: the copy (this
  // CTA's or a neighbour's) and the half there
  double* dst[2];
  for (int h = 0; h < 2; ++h) {
    const int npos = next_position(np, h == 0 ? rank : np - 1 - rank);
    const int dslot = slot_of(np, npos);
    double* base = dslot == rank ? nxt : cluster.map_shared_rank(nxt, dslot);
    dst[h] = base + half_of(np, npos) * kB * ld;
  }
  st.lap(0);

  int sweeps = 0;
  bool failed = true;
  while (sweeps < kMaxSweeps) {
    bool sweep_rotated = false, sweep_bad = false;
    for (int k = 0; k < np - 1; ++k) {
      // 1. the Gram matrix of the slot's columns
      double* scur = tile;
      double* snxt = tile + kM * kLdS;
      for (int ti = warp; ti < kGramTiles; ti += nwarps) {
        const int mt = ti / (kM / 8), nt = ti - mt * (kM / 8);
        const double* a0 = cur + (16 * mt + g) * ld;
        const double* a1 = a0 + 8 * ld;
        const double* b0 = cur + (8 * nt + g) * ld;
        double acc[4] = {0.0, 0.0, 0.0, 0.0};
        for (int r = t; r < rows4; r += 4) dmma(acc, a0[r], a1[r], b0[r]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          scur[(16 * mt + g) * kLdS + 8 * nt + 2 * t + e] = acc[e];
          scur[(16 * mt + g + 8) * kLdS + 8 * nt + 2 * t + e] = acc[2 + e];
        }
      }
      for (int e = tid; e < kM * kM; e += nthreads) {
        const int i = e / kM, j = e - i * kM;
        umine[i * kLdU + j] = i == j ? 1.0 : 0.0;
      }
      __syncthreads();
      st.lap(1);

      // 2. the inner problem
      bool rotated, bad;
      // the stamps of the inner sweep (J1_STAMP_PARTS[1])
      inner_sweep<kB>(scur, snxt, umine, rcs, vote, tol, s0, st, InnerParts{2, 3, 4, 10, 11, 13},
                      rotated, bad);

      // 3. the products and the shift: a warp a strip of 16 rows of W or V
      for (int job = warp; job < 2 * strips; job += nwarps) {
        const int mat = job < strips ? 0 : 1, sidx = job - mat * strips;
        const double* src = cur + mat * kM * ld;
        const int r0 = 16 * sidx + g, r1 = r0 + 8;
        if (rotated) {
          double acc[kM / 8][4] = {};
#pragma unroll
          for (int kk = 0; kk < kM / 4; ++kk) {
            const int vc = 4 * kk + t;
            const double x0 = src[vc * ld + r0], x1 = src[vc * ld + r1];
#pragma unroll
            for (int nt = 0; nt < kM / 8; ++nt) dmma(acc[nt], x0, x1, umine[vc * kLdU + 8 * nt + g]);
          }
          if (st.out != nullptr) {
            wait_for(acc[0][0]);
            st.lap(5);
          }
#pragma unroll
          for (int nt = 0; nt < kM / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int vc = 8 * nt + 2 * t + e, h = vc < kB ? 0 : 1;
              double* out = dst[h] + (mat * kM + vc - h * kB) * ld;
              if (r0 < n) out[r0] = acc[nt][e];
              if (r1 < n) out[r1] = acc[nt][2 + e];
            }
          }
        } else {
          for (int e = lane; e < 16 * kM; e += 32) {
            const int vc = e >> 4, r = 16 * sidx + (e & 15), h = vc < kB ? 0 : 1;
            if (r < n) dst[h][(mat * kM + vc - h * kB) * ld + r] = src[vc * ld + r];
          }
        }
        st.lap(6);
      }
      if (tid == 0) {
        const int f = (rotated ? 1 : 0) | (bad ? 2 : 0);
        for (int r = 0; r < ctas; ++r)
          cluster.map_shared_rank(flags, r)[(k & 1) * kMaxBlockCtas + rank] = f;
      }
      st.lap(6);

      // 4. the next step's columns and every slot's flags are in place
      cluster.sync();
      st.lap(7);
      st.count(9);
      for (int s = 0; s < ctas; ++s) {
        const int f = flags[(k & 1) * kMaxBlockCtas + s];
        sweep_rotated |= (f & 1) != 0;
        sweep_bad |= (f & 2) != 0;
      }
      double* tmp = cur;
      cur = nxt;
      nxt = tmp;
      for (int h = 0; h < 2; ++h) {  // the copies trade places everywhere
        const int npos = next_position(np, h == 0 ? rank : np - 1 - rank);
        const int dslot = slot_of(np, npos);
        double* base = dslot == rank ? nxt : cluster.map_shared_rank(nxt, dslot);
        dst[h] = base + half_of(np, npos) * kB * ld;
      }
    }
    ++sweeps;
    failed = sweep_rotated || sweep_bad;
    if (!failed || sweep_bad) break;
  }

  // W V, V and the squared column norms of W V; NaN for an instance that
  // failed; the blocks are where step 0 put them
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  const int P = schedule_index(np, 0, rank), Q = schedule_index(np, 0, np - 1 - rank);
  double* wo = w_out + blockIdx.y * nn;
  double* vo = v_out + blockIdx.y * nn;
  for (int vc = tid; vc < kM; vc += nthreads) {
    const int blk = vc < kB ? P : Q, j = vc < kB ? vc : vc - kB;
    if (j >= width(blk)) continue;
    const double* wc = cur + vc * ld;
    double s = 0.0;
    for (int r = 0; r < n; ++r) s = fma(wc[r], wc[r], s);
    norms_out[blockIdx.y * (long long)n + blk * kB + j] = failed ? nan : s;
  }
  for (int e = tid; e < n * kM; e += nthreads) {
    const int r = e / kM, vc = e - r * kM;
    const int blk = vc < kB ? P : Q, j = vc < kB ? vc : vc - kB;
    if (j >= width(blk)) continue;
    const long long o = (long long)r * n + blk * kB + j;
    wo[o] = failed ? nan : cur[vc * ld + r];
    vo[o] = failed ? nan : cur[(kM + vc) * ld + r];
  }
  if (rank == 0 && tid == 0 && sweeps_out != nullptr) sweeps_out[blockIdx.y] = sweeps;
  st.lap(8);
  st.count(12, sweeps);
}

int launch(const double* a, int nbatch, int n, double tol, double floor_rel, double* w, double* v,
           double* norms2, int* sweeps, int block, int ctas, int threads, long long* stamps,
           void* stream) {
  if (n < 2 || n % 2 != 0 || nbatch < 1 || !(tol > 0.0) || !(floor_rel >= 0.0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (block == 0) {
    if (n > kMaxN || ctas != 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
      return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(n);
    if (smem > (size_t)kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
    static unsigned done = 0;
    if ((err = prepare(jacobi_svd_kernel, done, false)) != cudaSuccess) return (int)err;
    jacobi_svd_kernel<<<nbatch, threads, smem, st>>>(a, n, tol, floor_rel, w, v, norms2, sweeps,
                                                     stamps);
    return (int)cudaGetLastError();
  }
  const int nb = (n + kB - 1) / kB;
  if (block != kB || n > kMaxBlockN || nbatch > 65535 || ctas != (nb + nb % 2) / 2 ||
      ctas > kMaxBlockCtas || threads != kBlockThreads)
    return (int)cudaErrorInvalidValue;
  const size_t smem = block_smem_bytes(n);
  if (smem > (size_t)kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  static unsigned done = 0;
  if ((err = prepare(jacobi_svd_block_kernel, done, false)) != cudaSuccess) return (int)err;
  return (int)launch_cluster(jacobi_svd_block_kernel, ctas, nbatch, threads, smem, st, a, n, tol,
                             floor_rel, w, v, norms2, sweeps, stamps);
}

}  // namespace

// a: nbatch contiguous (n, n) f64 matrices; w, v: nbatch (n, n) outputs,
// norms2: nbatch n outputs, all contiguous; sweeps: null, or nbatch ints
// that receive each instance's sweeps (outer sweeps in the block regime).
// tol: the plain version's tol_for(n).  block, ctas, threads:
// ops/kernels.py::j1_plan (block 0: the element regime, one CTA an
// instance, a warp a pair, at most 32; 16: the block regime, a cluster of
// ctas CTAs an instance).
extern "C" int ttipm_jacobi_svd(const double* a, int nbatch, int n, double tol,
                                double floor_rel, double* w, double* v, double* norms2,
                                int* sweeps, int block, int ctas, int threads, void* stream) {
  return launch(a, nbatch, n, tol, floor_rel, w, v, norms2, sweeps, block, ctas, threads,
                nullptr, stream);
}

// The same factorization of one instance with the clock stamps of CTA 0's
// thread 0 in stamps (16 int64 zeros): the cycles of each part of the run
// summed over it, then counts (ops/kernels.py::J1_STAMP_PARTS).  Element
// regime: setup, the loads and products of a pair's three sums, their
// shuffle reductions, the threshold and the rotation, the update of the two
// columns of W and V, the step's barrier, the store; steps, sweeps.  Block
// regime: setup, the Gram matrix, the inner steps' rotations, their updates
// (and U's scaling), their barriers, the products, their stores to the next
// copies (and the flags), the cluster barrier, the store; outer steps,
// inner steps, inner steps that rotated, sweeps, inner sweeps skipped as
// quiet (their steps not counted).
extern "C" int ttipm_jacobi_svd_stamps(const double* a, int n, double tol, double floor_rel,
                                       double* w, double* v, double* norms2, int block, int ctas,
                                       int threads, long long* stamps, void* stream) {
  if (stamps == nullptr) return (int)cudaErrorInvalidValue;
  return launch(a, 1, n, tol, floor_rel, w, v, norms2, nullptr, block, ctas, threads, stamps,
                stream);
}
