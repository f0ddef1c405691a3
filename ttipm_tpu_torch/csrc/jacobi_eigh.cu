// J2: cyclic two-sided Jacobi eigendecomposition of a symmetric f64 matrix
// (the core of the port's eigh and eigvalsh on the card), in two regimes
// chosen by the order: element rotations below ops/kernels.py's
// J2_BLOCK_FROM, a two-level (block) Jacobi from there to kMaxN.
//
// Replaces no Pallas kernel.  It is the counterpart of the jnp program
// ttipm_tpu/ops/jacobi.py::_jacobi_eigh_core (:370), which the JAX package
// runs as one XLA program a factorization for every f64 eigh of a TPU
// trace (jacobi_eigh, :431).  It was added because the eigen windows' and
// the step-size pencils' eigh and eigvalsh on the card were cuSOLVER
// calls with a host check of their info (1,586 in a maxcut d10 solve, at
// orders up to 256: tools/jacobi_census.py); this kernel decides
// convergence on the device and never synchronises with the host.  The
// scaling, the odd-order padding, the sort and the removal of the padded
// pair are torch code around it (ttipm_tpu_torch/ops/jacobi.py::jacobi_eigh).
//
// Contract: a, nbatch contiguous symmetric (n, n) f64 matrices, n even,
// 2 <= n <= kMaxN.  Out: w, the diagonal of the rotated matrix (the
// eigenvalues, unsorted), and, unless v is null (eigvalsh: A's rotations
// never read V, so w keeps its bits), V (exactly orthonormal, a = V diag(w)
// V^T), contiguous.  The rotation rule, tolerance and stop test are the
// plain versions' (ops/jacobi.py::eigh_core_plain, eigh_block_plain): with
// b_ij = (a_ij + a_ji) / 2 and s_ij = max(sqrt(|a_ii a_jj|), s0, 1e-30), s0
// = floor_rel max |a| of the input, a pair is rotated where |b_ij| > tol
// s_ij, by t = sign(tau) / (|tau| + sqrt(1 + tau^2)), tau = (a_jj - a_ii) /
// (2 b_ij), first the columns, then the rows, then V; the sweeps stop
// after one without a rotation, or after 26; an instance that still
// rotated in its 26th sweep, or met a non-finite number, comes out NaN.
// (The JAX program measures a_ij against sqrt(|a_ii a_jj| + 1e-30) and
// tests the matrix after each sweep: see eigh_core_plain.)  An instance's
// result does not depend on the batch: the batch is the grid's y axis, a
// cluster an instance, and the stop is decided from flags every CTA of the
// cluster holds alike.
//
// Element regime (jacobi_eigh_kernel).  A step rotates the n / 2 disjoint
// pairs of the round-robin schedule.  A and V of order 256 take 1 MB: a
// cluster of 1, 2, 4 or 8 CTAs (ops/kernels.py::j2_plan) splits the
// indices into blocks of nc = ceil(n / ctas); CTA r holds its columns of A
// twice (a step reads one copy, writes the other) and the same rows of V.
// Every CTA computes all n / 2 rotations itself from a_ii, a_jj and a_ij
// read through distributed shared memory; the owner of column c writes
// column c of G^T A G from c and its partner column (local or remote) and
// rotates row c of V; one cluster barrier ends the step.  What bounds it
// (clock stamps, PERF.md): n - 1 dependent steps a sweep, each a round of
// remote loads, a chain of three square roots and three divisions, 32 n^2
// bytes of shared-memory traffic over the cluster and a cluster barrier.
// The steps grow as n and a step's bytes as n^2, so at 128-256 it loses
// 1.7-3.5x to cuSOLVER's syevd.
//
// Block regime (jacobi_eigh_block_kernel, kB = 16).  The n indices are cut
// into nb = ceil(n / kB) blocks of kB (the last ragged, and an empty one where
// nb is odd, so that nb is even); the outer sweep runs the round robin of
// order nb over the blocks, nb - 1 outer steps of nb / 2 slots, a slot a
// pair of blocks (P, Q), a CTA a slot.  CTA s holds the block columns at
// positions s (half 0) and nb - 1 - s (half 1) of the schedule: all rows,
// 2 kB columns, twice (the row update writes the other copy).  An outer
// step:
//  1. the inner problem: the CTA copies the 2 kB x 2 kB diagonal tile
//     A[P u Q, P u Q] and runs one cyclic sweep of the element rule on it,
//     accumulating the slot's orthogonal U (jacobi.cuh::inner_sweep, which
//     J1's block regime shares: refined rotations, two CTA barriers an
//     inner step, quiet tiles skipped, U's columns scaled to unit length);
//  2. U and the slot's flags (rotated, non-finite) go to every CTA of the
//     cluster by distributed-shared-memory stores;
//  3. the columns: A[:, P u Q] <- A[:, P u Q] U in place, and V[:, P u Q]
//     <- V[:, P u Q] U in device memory (V stays in L2: 0.5 MB at 256), on
//     the f64 tensor cores (mma.sync m16n8k4), skipped where U = I;
//  4. cluster barrier;
//  5. the rows and the ring shift: every CTA applies each slot's U^T to
//     that slot's rows of its own columns (DMMA, a copy where U = I) and
//     stores the result where the round robin moves the block column next:
//     its own other copy or a neighbour's, by distributed-shared-memory
//     stores;
//  6. cluster barrier.
// No step loads through distributed shared memory.  Two cluster barriers
// an outer step: about (nb - 1) 2 a sweep instead of n - 1, and the
// element step's n^2 shared-memory traffic becomes 2 kB n an outer step.
// The outer sweeps stop after one in which no inner sweep rotated: every
// pair of indices has then met in some slot on the matrix as it is.
// After a whole sweep the blocks are back where they started.  The
// scale s0 is the one cluster-wide reduction (each CTA's maximum stored
// into every CTA, combined in rank order).  Order 256 takes 8 CTAs, 272
// nine (a non-portable cluster).
//
// Bound on the H100 (chip_smoke.py's bound_ms, for both regimes the
// element schedule's work): a step does 12 flops for each (column, row
// pair) of A (6 n^2) and 6 for each (row, pair) of V (3 n^2), n - 1 steps a
// sweep: about 9 n^2 (n - 1) flops a sweep, for the sweeps the plain
// element version needs on the operand; n^2 8 bytes in, n^2 + n out.  At n
// = 256 and 8 sweeps that is 1.2 GFLOP, 18 us at the card's 67 TFLOP/s
// f64.  What bounds the block regime is latency too, but of the inner
// steps: about 2 n of them a sweep, each a chain of square roots and
// divisions and two CTA barriers, in all slots at once.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "jacobi.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ttipm::jacobi;

constexpr int kMaxN = 272;
constexpr int kMaxCtas = 8;        // the element regime's largest cluster
constexpr int kMaxBlockCtas = 16;  // the block regime's (non-portable above 8)
constexpr int kMaxThreads = 1024;
constexpr int kScratch = 48;  // 32 warp maxima, then kMaxCtas CTA maxima (in CTA 0)
constexpr int kStamps = 16;

// The block regime's block width, and its threads: one 2 x 2 block of the
// inner tile each.
constexpr int kB = 16;
constexpr int kBlockThreads = kB * kB;

// Leading dimension of the block regime's columns: conflict-free tensor
// core fragments (lanes t = 0..3 of a column 4 banks of 8 bytes apart).
__host__ __device__ inline int block_ld(int n) { return (n + 15) / 16 * 16 + 4; }

size_t smem_bytes(int n, int ctas) {
  const size_t nc = (n + ctas - 1) / ctas, h = n / 2;
  return sizeof(double) * (3 * nc * (n | 1) + 2 * h + kScratch + nc) +
         sizeof(int) * (2 * h + nc + 2);
}

// The block regime's shared memory (ops/kernels.py::_j2_block_smem): the
// two copies of the slot's columns (each also room for the inner sweep's
// two tiles: the copies trade places every outer step), every slot's U, the inner step's rotations (two parities), the
// cluster's maxima; the slots' flags and the inner steps' votes.
size_t block_smem_bytes(int n, int ctas) {
  const size_t m = 2 * kB, panel = m * block_ld(n), tiles = 2 * m * (m + 1);
  return sizeof(double) * (2 * (panel > tiles ? panel : tiles) + ctas * m * (m + 4) + 4 * kB +
                           kMaxBlockCtas) +
         sizeof(int) * (kMaxBlockCtas + 2);
}

// Column `col` of the copy at local address `copy`, in the CTA that owns it.
__device__ __forceinline__ const double* column(cg::cluster_group& cluster, double* copy,
                                                int col, int nc, int ld) {
  const int owner = col / nc;
  return cluster.map_shared_rank(copy, owner) + (col - owner * nc) * ld;
}

// The maximum of every thread's v over the cluster (NaN kept), alike in
// every CTA: warps, then the CTA into CTA 0's slots, then all slots in
// rank order.
__device__ double cluster_max(cg::cluster_group& cluster, double v, double* red, int ctas,
                              int rank) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (tid == 0) {
    double t = red[0];
    for (int w = 1; w < nwarps; ++w) t = max_nan(t, red[w]);
    cluster.map_shared_rank(red, 0)[32 + rank] = t;
  }
  cluster.sync();
  const double* slots = cluster.map_shared_rank(red, 0) + 32;
  double m = slots[0];
  for (int q = 1; q < ctas; ++q) m = max_nan(m, slots[q]);
  cluster.sync();  // the slots are read before they are written again
  return m;
}

// The threshold test and the rotation of a pair (a_ii, a_jj, b_ij): both
// regimes and the plain versions (ops/jacobi.py::eigh_rotations).
__device__ __forceinline__ void pair_rotation(double aii, double ajj, double bij, double tol,
                                              double s0, bool& rotate, bool& finite, double& cs,
                                              double& sn) {
  const double scale = fmax(__dsqrt_rn(fabs(aii * ajj)), s0);
  rotate = fabs(bij) > tol * scale;
  finite = isfinite(aii + ajj + bij);
  rotation(rotate, __ddiv_rn(ajj - aii, 2.0 * (rotate ? bij : 1.0)), cs, sn);
}

// ---------------------------------------------------------------------------
// The element regime
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kMaxThreads, 1)
jacobi_eigh_kernel(const double* __restrict__ a, int n, int ctas, double tol, double floor_rel,
                   double* __restrict__ w_out, double* __restrict__ v_out,
                   int* __restrict__ sweeps_out, long long* __restrict__ stamps) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h = n / 2, ld = n | 1, nc = (n + ctas - 1) / ctas;
  const int c0 = rank * nc;
  const int own = max(0, min(n, c0 + nc) - c0);
  const bool vectors = v_out != nullptr;
  extern __shared__ double smem[];
  double* copy0 = smem;
  double* copy1 = copy0 + nc * ld;
  double* V = copy1 + nc * ld;  // rows c0 .. c0 + own - 1, row-major
  double* cs = V + nc * ld;
  double* sn = cs + h;
  double* red = sn + h;
  const double** partner = reinterpret_cast<const double**>(red + kScratch);  // nc
  int* ip = reinterpret_cast<int*>(partner + nc);
  int* jp = ip + h;
  int* pinfo = jp + h;  // of owned column lc: 2 p + (it is the j of pair p)
  int* flags = pinfo + nc;  // this sweep: a rotation, a non-finite number
  const int tid = threadIdx.x, nthreads = blockDim.x;
  Stamps st(stamps, stamps != nullptr && tid == 0 && rank == 0 && blockIdx.y == 0);
  // a thread's first item (owned column, row pair) of a step and its stride
  const int lc0 = tid / h, q0 = tid - lc0 * h, dl = nthreads / h, dq = nthreads - dl * h;
  const long long nn = (long long)n * n;
  const double* ab = a + blockIdx.y * nn;
  double amax = 0.0;
  for (int e = tid; e < own * n; e += nthreads) {
    const int r = e / own, lc = e - r * own;
    const double x = ab[(long long)r * n + c0 + lc];
    copy0[lc * ld + r] = x;
    amax = max_nan(amax, fabs(x));
  }
  if (vectors) {
    for (int e = tid; e < own * n; e += nthreads) {
      const int lr = e / n, c = e - lr * n;
      V[lr * ld + c] = c0 + lr == c ? 1.0 : 0.0;
    }
  }
  const double s0 = fmax(floor_rel * cluster_max(cluster, amax, red, ctas, rank), kTiny);
  st.lap(0);
  double* cur = copy0;
  double* nxt = copy1;
  int sweeps = 0;
  bool failed = true;
  while (sweeps < kMaxSweeps) {
    if (tid == 0) flags[0] = flags[1] = 0;
    __syncthreads();
    for (int k = 0; k < n - 1; ++k) {
      // 1. the pairs and rotations of step k, alike in every CTA; each
      //    owned column's pair and its partner column's address
      for (int p = tid; p < h; p += nthreads) {
        const int i = schedule_index(n, k, p), j = schedule_index(n, k, n - 1 - p);
        ip[p] = i;
        jp[p] = j;
        const double* ci = column(cluster, cur, i, nc, ld);
        const double* cj = column(cluster, cur, j, nc, ld);
        if (i >= c0 && i < c0 + own) {
          partner[i - c0] = cj;
          pinfo[i - c0] = 2 * p;
        }
        if (j >= c0 && j < c0 + own) {
          partner[j - c0] = ci;
          pinfo[j - c0] = 2 * p + 1;
        }
        const double aii = ci[i], ajj = cj[j], bij = 0.5 * (cj[i] + ci[j]);
        if (st.out != nullptr) {
          wait_for(bij + aii + ajj);
          st.lap(1);
        }
        bool rotate, finite;
        double c, s;
        pair_rotation(aii, ajj, bij, tol, s0, rotate, finite, c, s);
        if (rotate) flags[0] = 1;
        if (!finite) flags[1] = 1;
        cs[p] = c;
        sn[p] = s;
        if (st.out != nullptr) {
          wait_for(c + s);
          st.lap(2);
        }
      }
      __syncthreads();
      st.lap(3);
      // 2. item (owned column lc, row pair q): column lc of G^T A G at rows
      //    q into the other copy, and row lc of V G at the columns of pair q
      int lc = lc0, q = q0;
      while (lc < own) {
        const int ri = ip[q], rj = jp[q];
        const double cq = cs[q], sq = sn[q];
        const int pc = pinfo[lc], p = pc >> 1;
        const bool is_j = pc & 1;
        const double cp = cs[p], sp = sn[p];
        const double* mine = cur + lc * ld;
        const double* other = partner[lc];
        const double xi = mine[ri], yi = other[ri], xj = mine[rj], yj = other[rj];
        // the column rotation: (c, c') = (i, j): cs x - sn y; (j, i): sn y + cs x
        const double ti = is_j ? sp * yi + cp * xi : cp * xi - sp * yi;
        const double tj = is_j ? sp * yj + cp * xj : cp * xj - sp * yj;
        double* out = nxt + lc * ld;
        out[ri] = cq * ti - sq * tj;
        out[rj] = sq * ti + cq * tj;
        if (vectors) {
          double* vr = V + lc * ld;
          const double vi = vr[ri], vj = vr[rj];
          vr[ri] = cq * vi - sq * vj;
          vr[rj] = sq * vi + cq * vj;
        }
        q += dq;
        lc += dl;
        if (q >= h) {
          q -= h;
          ++lc;
        }
      }
      st.lap(4);
      // 3. no CTA reads a copy before it is complete or writes one that
      //    another still reads
      if (ctas == 1)
        __syncthreads();
      else
        cluster.sync();
      st.lap(5);
      st.count(7);
      double* t = cur;
      cur = nxt;
      nxt = t;
    }
    ++sweeps;
    // every CTA computed every pair's decision alike, so all read the same
    const bool rotated = flags[0] != 0, bad = flags[1] != 0;
    __syncthreads();  // the flags are read before they are reset
    failed = rotated || bad;
    if (!failed || bad) break;
  }
  const bool bad = failed;
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  for (int lc = tid; lc < own; lc += nthreads)
    w_out[blockIdx.y * (long long)n + c0 + lc] = bad ? nan : cur[lc * ld + c0 + lc];
  if (vectors) {
    double* vo = v_out + blockIdx.y * nn + (long long)c0 * n;
    for (int e = tid; e < own * n; e += nthreads) {
      const int lr = e / n, c = e - lr * n;
      vo[e] = bad ? nan : V[lr * ld + c];
    }
  }
  if (rank == 0 && tid == 0 && sweeps_out != nullptr) sweeps_out[blockIdx.y] = sweeps;
  st.lap(6);
  st.count(8, sweeps);
}

// ---------------------------------------------------------------------------
// The block regime
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kBlockThreads, 1)
jacobi_eigh_block_kernel(const double* __restrict__ a, int n, double tol, double floor_rel,
                         double* __restrict__ w_out, double* __restrict__ v_out,
                         int* __restrict__ sweeps_out, long long* __restrict__ stamps) {
  constexpr int kM = 2 * kB;      // order of a slot's tile
  constexpr int kLdS = kM + 1;    // the tile's leading dimension
  constexpr int kLdU = kM + 4;    // U's: conflict-free tensor core fragments
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = (int)gridDim.x;
  const int rank = (int)cluster.block_rank();  // the slot
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int g = lane >> 2, t = lane & 3;  // the tensor core fragment coordinates
  const int nb = (n + kB - 1) / kB, np = 2 * ctas;
  const int ld = block_ld(n);
  const int strips = (n + 15) / 16;  // row strips of 16 of the column products
  const bool vectors = v_out != nullptr;
  extern __shared__ __align__(16) double block_smem[];
  // virtual column h kB + j (block of half h, its column j) at acur + col ld
  const int panel = kM * ld, tiles = 2 * kM * kLdS, copy = panel > tiles ? panel : tiles;
  double* acur = block_smem;
  double* anxt = acur + copy;
  double* utab = anxt + copy;  // slot s's U at utab + s kM kLdU
  double* rcs = utab + ctas * kM * kLdU;  // parity r: cs at rcs + 2 kB r, sn kB further
  double* red = rcs + 4 * kB;             // kMaxBlockCtas: each CTA's max |a|
  int* flags = reinterpret_cast<int*>(red + kMaxBlockCtas);  // slot s: 1 rotated, 2 non-finite
  int* vote = flags + kMaxBlockCtas;      // an inner step's rotation, two parities
  double* umine = utab + rank * kM * kLdU;
  Stamps st(stamps, stamps != nullptr && tid == 0 && rank == 0 && blockIdx.y == 0);
  const long long nn = (long long)n * n;
  const double* ab = a + blockIdx.y * nn;
  double* vb = vectors ? v_out + blockIdx.y * nn : nullptr;
  auto width = [&](int blk) { return blk < nb ? min(kB, n - blk * kB) : 0; };

  // The columns of the blocks at positions rank and np - 1 - rank of step
  // 0 (where every sweep ends), all rows, zeros past the order; V = I on
  // them; this CTA's max |a|.
  {
    const int P = schedule_index(np, 0, rank), Q = schedule_index(np, 0, np - 1 - rank);
    double amax = 0.0;
    for (int e = tid; e < ld * kM; e += nthreads) {
      const int r = e / kM, vc = e - r * kM;
      const int blk = vc < kB ? P : Q, j = vc < kB ? vc : vc - kB;
      const bool real = r < n && j < width(blk);
      const double x = real ? ab[(long long)r * n + blk * kB + j] : 0.0;
      acur[vc * ld + r] = x;
      amax = max_nan(amax, fabs(x));
    }
    if (vectors) {
      for (int e = tid; e < n * kM; e += nthreads) {
        const int r = e / kM, vc = e - r * kM;
        const int blk = vc < kB ? P : Q, j = vc < kB ? vc : vc - kB;
        if (j < width(blk)) {
          const int c = blk * kB + j;
          __stcg(vb + (long long)r * n + c, r == c ? 1.0 : 0.0);
        }
      }
    }
    amax = warp_max(amax);
    if (lane == 0) anxt[warp] = amax;
    __syncthreads();
    if (tid == 0) {
      double m = anxt[0];
      for (int w = 1; w < nwarps; ++w) m = max_nan(m, anxt[w]);
      for (int r = 0; r < ctas; ++r) cluster.map_shared_rank(red, r)[rank] = m;
    }
    cluster.sync();
  }
  double amax_all = red[0];
  for (int r = 1; r < ctas; ++r) amax_all = max_nan(amax_all, red[r]);
  const double s0 = fmax(floor_rel * amax_all, kTiny);
  st.lap(0);

  int sweeps = 0;
  bool failed = true;
  while (sweeps < kMaxSweeps) {
    bool sweep_rotated = false, sweep_bad = false;
    for (int k = 0; k < np - 1; ++k) {
      const int P = schedule_index(np, k, rank), Q = schedule_index(np, k, np - 1 - rank);
      const int wP = width(P), wQ = width(Q);
      // the global row of virtual index v of slot (P, Q), -1 where empty
      auto vrow = [&](int v, int bp, int bq, int wp, int wq) {
        return v < kB ? (v < wp ? bp * kB + v : -1) : (v - kB < wq ? bq * kB + v - kB : -1);
      };

      // 1. the inner problem: one sweep of the element rule on the tile
      double* scur = anxt;
      double* snxt = anxt + kM * kLdS;
      for (int e = tid; e < kM * kM; e += nthreads) {
        const int vi = e / kM, vj = e - vi * kM;
        const int ri = vrow(vi, P, Q, wP, wQ), rj = vrow(vj, P, Q, wP, wQ);
        scur[vi * kLdS + vj] = ri >= 0 && rj >= 0 ? acur[vj * ld + ri] : 0.0;
        umine[vi * kLdU + vj] = vi == vj ? 1.0 : 0.0;
      }
      __syncthreads();
      st.lap(2);
      bool rotated, bad;
      // the stamps of the inner sweep (J2_STAMP_PARTS[1])
      inner_sweep<kB>(scur, snxt, umine, rcs, vote, tol, s0, st, InnerParts{1, 2, 3, 12, 13, 15},
                      rotated, bad);

      // 2. U and the flags to every CTA (stores only)
      if (tid == 0) {
        const int f = (rotated ? 1 : 0) | (bad ? 2 : 0);
        for (int r = 0; r < ctas; ++r) cluster.map_shared_rank(flags, r)[rank] = f;
      }
      if (rotated) {
        constexpr int kPairs = kM * kLdU / 2;
        const double2* src = reinterpret_cast<const double2*>(umine);
        for (int d = 1; d < ctas; ++d) {
          const int r = rank + d < ctas ? rank + d : rank + d - ctas;
          double2* dst = reinterpret_cast<double2*>(cluster.map_shared_rank(umine, r));
          for (int e = tid; e < kPairs; e += nthreads) dst[e] = src[e];
        }
      }
      st.lap(4);

      // 3. the columns: A[:, P u Q] U in place, V[:, P u Q] U in device
      //    memory; a warp owns a strip of 16 rows (it reads the whole strip
      //    before it writes)
      if (rotated) {
        for (int sidx = warp; sidx < strips; sidx += nwarps) {
          const int m0 = sidx * 16, r0 = m0 + g, r1 = m0 + g + 8;
          double acc[kM / 8][4] = {};
#pragma unroll
          for (int kk = 0; kk < kM / 4; ++kk) {
            const int vc = 4 * kk + t;
            const bool real = vrow(vc, P, Q, wP, wQ) >= 0;
            const double a0 = real && r0 < n ? acur[vc * ld + r0] : 0.0;
            const double a1 = real && r1 < n ? acur[vc * ld + r1] : 0.0;
#pragma unroll
            for (int nt = 0; nt < kM / 8; ++nt) dmma(acc[nt], a0, a1, umine[vc * kLdU + 8 * nt + g]);
          }
#pragma unroll
          for (int nt = 0; nt < kM / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int vc = 8 * nt + 2 * t + e;
              if (vrow(vc, P, Q, wP, wQ) < 0) continue;
              if (r0 < n) acur[vc * ld + r0] = acc[nt][e];
              if (r1 < n) acur[vc * ld + r1] = acc[nt][2 + e];
            }
          }
        }
        st.lap(5);
        if (vectors) {
          for (int sidx = warp; sidx < strips; sidx += nwarps) {
            const int m0 = sidx * 16, r0 = m0 + g, r1 = m0 + g + 8;
            double acc[kM / 8][4] = {};
#pragma unroll
            for (int kk = 0; kk < kM / 4; ++kk) {
              const int vc = 4 * kk + t, c = vrow(vc, P, Q, wP, wQ);
              const double a0 = c >= 0 && r0 < n ? __ldcg(vb + (long long)r0 * n + c) : 0.0;
              const double a1 = c >= 0 && r1 < n ? __ldcg(vb + (long long)r1 * n + c) : 0.0;
#pragma unroll
              for (int nt = 0; nt < kM / 8; ++nt)
                dmma(acc[nt], a0, a1, umine[vc * kLdU + 8 * nt + g]);
            }
#pragma unroll
            for (int nt = 0; nt < kM / 8; ++nt) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = vrow(8 * nt + 2 * t + e, P, Q, wP, wQ);
                if (c < 0) continue;
                if (r0 < n) __stcg(vb + (long long)r0 * n + c, acc[nt][e]);
                if (r1 < n) __stcg(vb + (long long)r1 * n + c, acc[nt][2 + e]);
              }
            }
          }
        }
        st.lap(6);
      }

      // 4. every slot's U and flags are in every CTA; the columns are done
      cluster.sync();
      st.lap(7);
      unsigned identity = 0;  // bit s: slot s did not rotate
      for (int s = 0; s < ctas; ++s) {
        const int f = flags[s];
        sweep_rotated |= (f & 1) != 0;
        sweep_bad |= (f & 2) != 0;
        if (!(f & 1)) identity |= 1u << s;
      }

      // 5. the rows and the shift: item (half h, tile of 8 columns ct, slot
      //    s) applies slot s's U^T to its rows of the tile's columns and
      //    stores them where the round robin moves the half's block column
      constexpr int kTiles = kB / 8;
      for (int item = warp; item < 2 * kTiles * ctas; item += nwarps) {
        const int s = item % ctas, ct = (item / ctas) % kTiles, h = item / (ctas * kTiles);
        const int wh = h == 0 ? wP : wQ;
        const int col = ct * 8 + g;  // the lane's column in the half (B fragment)
        if (ct * 8 >= wh) continue;
        const int pos = h == 0 ? rank : np - 1 - rank, npos = next_position(np, pos);
        const int dslot = slot_of(np, npos), dh = half_of(np, npos);
        double* dst = dslot == rank ? anxt : cluster.map_shared_rank(anxt, dslot);
        double* dcol = dst + (dh * kB + ct * 8) * ld;
        const double* scol = acur + (h * kB + ct * 8) * ld;
        const int Ps = schedule_index(np, k, s), Qs = schedule_index(np, k, np - 1 - s);
        const int wPs = width(Ps), wQs = width(Qs);
        if (identity >> s & 1) {
          for (int e = lane; e < kM * 8; e += 32) {
            const int v = e >> 3, c = e & 7, r = vrow(v, Ps, Qs, wPs, wQs);
            if (r >= 0 && ct * 8 + c < wh) dcol[c * ld + r] = scol[c * ld + r];
          }
          continue;
        }
        const double* us = utab + s * kM * kLdU;
        double acc[kM / 16][4] = {};
#pragma unroll
        for (int kk = 0; kk < kM / 4; ++kk) {
          const int vr = 4 * kk + t, r = vrow(vr, Ps, Qs, wPs, wQs);
          const double b = r >= 0 && col < wh ? scol[g * ld + r] : 0.0;
#pragma unroll
          for (int mt = 0; mt < kM / 16; ++mt)
            dmma(acc[mt], us[vr * kLdU + 16 * mt + g], us[vr * kLdU + 16 * mt + g + 8], b);
        }
#pragma unroll
        for (int mt = 0; mt < kM / 16; ++mt) {
          const int r0 = vrow(16 * mt + g, Ps, Qs, wPs, wQs);
          const int r1 = vrow(16 * mt + g + 8, Ps, Qs, wPs, wQs);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 2 * t + e;
            if (ct * 8 + c >= wh) continue;
            if (r0 >= 0) dcol[c * ld + r0] = acc[mt][e];
            if (r1 >= 0) dcol[c * ld + r1] = acc[mt][2 + e];
          }
        }
      }
      st.lap(8);
      // 6. the next step's columns are complete everywhere
      cluster.sync();
      st.lap(9);
      st.count(11);
      double* tmp = acur;
      acur = anxt;
      anxt = tmp;
    }
    ++sweeps;
    failed = sweep_rotated || sweep_bad;
    if (!failed || sweep_bad) break;
  }

  // w (the diagonal) and, for an instance that failed, NaN in w and in
  // this CTA's columns of V; the blocks are where step 0 put them
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  const int P = schedule_index(np, 0, rank), Q = schedule_index(np, 0, np - 1 - rank);
  const int wP = width(P), wQ = width(Q);
  for (int vc = tid; vc < kM; vc += nthreads) {
    const int blk = vc < kB ? P : Q, j = vc < kB ? vc : vc - kB;
    if (j >= (vc < kB ? wP : wQ)) continue;
    const int c = blk * kB + j;
    w_out[blockIdx.y * (long long)n + c] = failed ? nan : acur[vc * ld + c];
  }
  if (failed && vectors) {
    for (int e = tid; e < n * kM; e += nthreads) {
      const int r = e / kM, vc = e - r * kM;
      const int blk = vc < kB ? P : Q, j = vc < kB ? vc : vc - kB;
      if (j < (vc < kB ? wP : wQ)) __stcg(vb + (long long)r * n + blk * kB + j, nan);
    }
  }
  if (rank == 0 && tid == 0 && sweeps_out != nullptr) sweeps_out[blockIdx.y] = sweeps;
  st.lap(10);
  st.count(14, sweeps);
}

int launch(const double* a, int nbatch, int n, double tol, double floor_rel, double* w, double* v,
           int* sweeps, int block, int ctas, int threads, long long* stamps, void* stream) {
  if (n < 2 || n > kMaxN || n % 2 != 0 || nbatch < 1 || nbatch > 65535 || !(tol > 0.0) ||
      !(floor_rel >= 0.0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (block == 0) {
    if ((ctas != 1 && ctas != 2 && ctas != 4 && ctas != kMaxCtas) || threads < 32 ||
        threads > kMaxThreads || threads % 32 != 0)
      return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(n, ctas);
    if (smem > (size_t)kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
    static unsigned done = 0;
    if ((err = prepare(jacobi_eigh_kernel, done, false)) != cudaSuccess) return (int)err;
    return (int)launch_cluster(jacobi_eigh_kernel, ctas, nbatch, threads, smem, st, a, n, ctas,
                               tol, floor_rel, w, v, sweeps, stamps);
  }
  const int nb = (n + kB - 1) / kB;
  if (block != kB || ctas != (nb + nb % 2) / 2 || ctas > kMaxBlockCtas || threads != kBlockThreads)
    return (int)cudaErrorInvalidValue;
  const size_t smem = block_smem_bytes(n, ctas);
  if (smem > (size_t)kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  static unsigned done = 0;
  if ((err = prepare(jacobi_eigh_block_kernel, done, true)) != cudaSuccess) return (int)err;
  return (int)launch_cluster(jacobi_eigh_block_kernel, ctas, nbatch, threads, smem, st, a, n, tol,
                             floor_rel, w, v, sweeps, stamps);
}

}  // namespace

// a: nbatch contiguous symmetric (n, n) f64 matrices; w: nbatch n outputs;
// v: nbatch (n, n) outputs, contiguous, or null (the eigenvalues alone);
// sweeps: null, or nbatch ints that receive each instance's sweeps (outer
// sweeps in the block regime).  tol: the plain version's tol_for(n).
// block, ctas, threads: ops/kernels.py::j2_plan (block 0: the element
// regime; 16: the block regime).  One cluster of ctas
// CTAs an instance.
extern "C" int ttipm_jacobi_eigh(const double* a, int nbatch, int n, double tol, double floor_rel,
                                 double* w, double* v, int* sweeps, int block, int ctas,
                                 int threads, void* stream) {
  return launch(a, nbatch, n, tol, floor_rel, w, v, sweeps, block, ctas, threads, nullptr,
                stream);
}

// The same factorization of one instance with CTA 0's clock stamps in
// stamps (kStamps int64 zeros): the cycles of each part of the run summed
// over it, then counts (ops/kernels.py::J2_STAMP_PARTS).  Element regime:
// setup, the remote loads of a step's rotation inputs, the rotations, the
// wait for the other threads' rotations, the update, the cluster barrier,
// the store; steps, sweeps.  Block regime: setup, the inner steps'
// rotations, their updates (and tile loads), their barriers, the U push,
// the column product of A, of V, barrier 1, the row product and shift,
// barrier 2, the store; outer steps, inner steps, inner steps that
// rotated, sweeps, inner sweeps skipped as quiet (their steps not counted).
extern "C" int ttipm_jacobi_eigh_stamps(const double* a, int n, double tol, double floor_rel,
                                        double* w, double* v, int block, int ctas, int threads,
                                        long long* stamps, void* stream) {
  if (stamps == nullptr) return (int)cudaErrorInvalidValue;
  return launch(a, 1, n, tol, floor_rel, w, v, nullptr, block, ctas, threads, stamps, stream);
}
