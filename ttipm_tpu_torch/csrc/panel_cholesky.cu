// K4: lower Cholesky factorization with failure report
//
// Replaces: ttipm_tpu/ops/kernels.py::panel_cholesky (Pallas kernel
// _panel_cholesky_kernel, dispatcher cholesky_lower): the L_Z factor of
// every fused local solve (ttipm_tpu/solvers/fused.py:110,
// fused_host.py:115) and the whitened shrink pencil of the step-size
// eigensolver (ttipm_tpu/solvers/fused_eigen.py:65).
//
// Contract (differs from the TPU kernel): only the lower triangle of `a`
// (any strides) is read; `out` receives L with its strict upper triangle
// zero; `info` receives 0, or the 1-based order of the first pivot that is
// not positive or not a number, like torch.linalg.cholesky_ex (L is then
// unspecified).  Nothing is clamped: the fused local solve relies on the
// failure signal to keep its previous core.  f64 or f32, any order n >= 1.
//
// Orders: n = 4 R'^2 for the solve's bond ranks.  MaxCut d8 gives n <= 400
// (mostly 16-144); R = 16-32 gives n up to ~5200.
//
// Two regimes, chosen here by n; the boundary 512 is the largest order
// whose 32 x 32 tiles fit a cluster of 8 CTAs with the ownership below.
// Cycle counts below are from an H100 (1980 MHz).
//
// 1. Resident, n <= 512: one launch, no copy, no separate pass for the
//    upper zeros or for info.  n^3/3 is at most 45 MFLOP here: what bounds
//    it is the serial chain of the method and its latencies.  Per 32
//    columns: one warp's factor of the diagonal tile, ~8.8K cycles (each
//    column waits on a shuffle, ~30, a correctly rounded square root, ~91,
//    and reciprocal, ~71); the solve of the next panel tile, ~2.2K; its
//    update of the next diagonal tile, ~0.9K; a cluster barrier, ~0.9K.
//    The design keeps all of it on chip and takes everything else off the
//    chain.  The tiles stay in shared memory from load to store, in one CTA
//    up to n = 160 and above that in a cluster of 8 CTAs that owns tile
//    rows in snake order (rows c and 15 - c on CTA c; at most 17 tiles,
//    176 KB).  Every CTA computes the factor of diagonal tile k + 1 itself
//    (so all see the same failure without a message) during step k, beside
//    the panel solve and the trailing update.  The two tiles the chain of
//    step k + 1 starts from are written to out by their owner in step k and
//    read from L2: 16 warps reading them from one CTA's shared memory
//    through the cluster cost ~7K cycles a step, L2 ~3K.  The trailing
//    update keeps off the chain's scheduler.
//
// 2. Blocked, n > 512: 64-column panels; a copy of the lower triangle of
//    `a` into `out`, then one persistent kernel (see the section below):
//    one CTA runs the chain of diagonal factors one panel ahead, the others
//    take the panel solves and the trailing updates as tasks that wait on
//    flags.  Per panel the chain costs ~45K cycles: loads ~10K, the solve
//    of the block below the diagonal ~11K, its update of the next diagonal
//    block ~3.4K, the 64 x 64 factor ~22K.  Its code runs out of line, one
//    copy of each building block: run once per panel while the other CTAs
//    keep L2 busy, inlined copies of the factor came cold from L2 and took
//    2-7 times their warm 21K cycles.  The trailing matrix streams through
//    HBM once per panel, n^3 / (6 * 64) * 16 B = 2.9 GB at n = 4096 (0.9 ms
//    at 3.35 TB/s); the updates run on the f64 tensor cores.  What bounds it
//    at n = 4096 is the throughput of the update tasks (one CTA per SM; a
//    second one per SM, which costs the chain registers, gained nothing),
//    and below n ~ 2048 the chain.  Code size counts here too: unrolling
//    the loads of a task further made every order slower.
//
// A batch of B matrices of one order (the lockstep batched solve, one
// matrix an instance, a batch stride apart; info one int each) is one call.
// In the resident regime it is one launch, the instance the grid's y
// dimension (one CTA or one cluster each).  In the blocked regime the call
// launches the copy and the persistent kernel once per instance, in turn on
// the stream, each with its own slice of the workspace: the persistent
// kernel takes every SM for one factorization.  An instance runs the code
// of a single call, so it gets its bits.
//
// Two instances, double and float (scalar.cuh), from one template.  The
// float one is the TPU kernel's own type (the Pallas dispatcher takes f32
// only, ttipm_tpu/ops/kernels.py:332) at full f32 precision: Hopper has no
// f32 matrix instruction but TF32's, so its trailing updates, the DMMA
// fragments of the double instance, are FFMA register tiles on the SIMT
// cores instead (warp_update32 and tile_products below), in the same
// regimes, tiles and task graph; each element's products form one chain in
// ascending k.  Pivots are correctly rounded square roots and reciprocals
// in float, as LAPACK spotf2 takes them; info is cholesky_ex's.  The
// float bound is the FP32 SIMT rate (67 TFLOP/s at 700 W), equal to the
// f64 tensor cores', so the blocked regime's update tasks cost about what
// the double ones do while moving half the bytes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "scalar.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTs = 32;                 // tile order
constexpr int kLd = 36;                 // shared row stride of a tile: DMMA fragments conflict-free,
                                        // rows on 16 bytes in float too
constexpr int kTileElems = kTs * kLd;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kResidentMaxN = 512;
constexpr int kSingleCtaMaxT = 5;       // n <= 160: one CTA holds all 15 tiles
constexpr int kClusterCtas = 8;
constexpr int kResidentMaxTiles = 17;   // 2 * kClusterCtas + 1
constexpr int kNB = 64;                 // blocked regime panel width
constexpr int kStageLd = kNB + 4;        // shared row stride of a staged 64-wide panel block

// Bytes of dynamic shared memory of the two regimes' kernels.
template <typename Real>
constexpr size_t resident_smem() {
  return (size_t)((kResidentMaxTiles + 3) * kTileElems + 4 * kTs) * sizeof(Real);
}
template <typename Real>
constexpr size_t blocked_smem() {
  return (size_t)std::max(10 * kTileElems + 3 * kNB, 2 * kNB * kStageLd) * sizeof(Real);
}

// Resident regime: tile row i lives on CTA row_owner(i); its tiles (i, 0..i)
// are contiguous there from slot row_slot(i).
__host__ __device__ inline int row_owner(int i, int ctas) {
  return ctas == 1 ? 0 : (i < ctas ? i : 2 * ctas - 1 - i);
}

__host__ __device__ inline int row_slot(int i, int ctas) {
  return ctas == 1 ? i * (i + 1) / 2 : (i < ctas ? 0 : 2 * ctas - i);
}

// D (16x8) += A (16x4) * B (4x8) on the f64 tensor cores, the sm_90 shape:
// lane (g, t) = (lane / 4, lane % 4) holds A[g][t], A[g + 8][t], B[t][g] and
// D[g][2t..2t+1], D[g + 8][2t..2t+1].  It runs twice as fast as m8n8k4
// (65 against 33 TFLOP/s on an H100) and gives the same bits as two
// m8n8k4 products (each k step is one rounding).
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

template <typename Real>
__device__ __forceinline__ void load_row(Real (&x)[kTs], const Real* tile) {
  const Real* p = tile + (threadIdx.x & 31) * kLd;
#pragma unroll
  for (int c = 0; c < kTs; ++c) x[c] = p[c];
}

template <typename Real>
__device__ __forceinline__ void store_row(const Real (&x)[kTs], Real* tile) {
  Real* p = tile + (threadIdx.x & 31) * kLd;
#pragma unroll
  for (int c = 0; c < kTs; ++c) p[c] = x[c];
}

// One warp; lane r holds row r of a symmetric 32 x 32 block (only x[0..r]
// is read).  On return it holds row r of the lower Cholesky factor (x[c]
// for c > r is left as scratch) and inv[j] = 1 / L[j][j]; col is a
// 64-double scratch.  Returns 0, or the 1-based order of the first pivot
// that is not positive or NaN (the same in every lane).
//
// The column loop is the serial chain of the factorization, so it is one
// basic block without branches: every lane scales and updates its whole
// row, which leaves the lower part exact (it reads only lower entries and
// the pivot) and puts scratch above the diagonal.  The pivot arithmetic is
// LAPACK dpotf2's: a correctly rounded square root, then the column times
// its correctly rounded reciprocal.  (On an H100, d * rsqrt(d) is 12% faster
// at n = 256 but moves the last bits enough that MaxCut d8 seed 24 takes 11
// iterations instead of 8, as it does with cuSOLVER's factor.)  The scaled
// column goes through shared memory (one store, broadcast loads) instead
// of shuffles.  The next pivot does not wait for that round trip: lane
// j + 1 computes it from its own x[j] (the value it would load), with the
// same fma, and shuffles it out.
template <typename Real>
__device__ __forceinline__ int warp_potrf32(Real (&x)[kTs], Real* inv, Real* col) {
  const int lane = threadIdx.x & 31;
  int fail = 0;
  Real my_inv = Real(0);
  Real d = __shfl_sync(kFull, x[0], 0);
#pragma unroll
  for (int j = 0; j < kTs; ++j) {
    fail = (fail == 0 && !(d > Real(0))) ? j + 1 : fail;
    const Real s = ttipm::sqrt_rn(d);
    const Real r = ttipm::rcp_rn(s);
    my_inv = lane == j ? r : my_inv;
    x[j] = lane == j ? s : x[j] * r;
    if (j + 1 < kTs) d = __shfl_sync(kFull, ttipm::madd(-x[j], x[j], x[j + 1]), j + 1);
    Real* cj = col + (j & 1) * kTs;
    cj[lane] = x[j];
    __syncwarp();
#pragma unroll
    for (int c = j + 1; c < kTs; ++c) x[c] = ttipm::madd(-x[j], cj[c], x[c]);
  }
  inv[lane] = my_inv;
  __syncwarp();
  return fail;
}

// One warp; lane r holds row r of X.  X := X L^{-T} for the lower factor L
// (shared memory, stride kLd) whose inverse pivots are inv.
template <typename Real>
__device__ __forceinline__ void warp_trsm32(Real (&x)[kTs], const Real* L, const Real* inv) {
#pragma unroll
  for (int c = 0; c < kTs; ++c) {
    x[c] *= inv[c];
#pragma unroll
    for (int q = c + 1; q < kTs; ++q) x[q] = ttipm::madd(-x[c], L[q * kLd + c], x[q]);
  }
}

// One warp: C = Cin - A B^T for 32 x 32 tiles of stride kLd (row blocks
// rb0 .. rb1 - 1 of 16 rows); C in this CTA's shared memory, Cin, A and B
// anywhere in the cluster's (Cin may be C).  Each element's products are
// summed over k in one chain, then subtracted from Cin.
//
// double: the f64 tensor cores.
__device__ __forceinline__ void warp_update32(double* C, const double* Cin, const double* A,
                                              const double* B, int rb0 = 0, int rb1 = 2) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  double bf[4][8];
#pragma unroll
  for (int cb = 0; cb < 4; ++cb)
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) bf[cb][kc] = B[(8 * cb + g) * kLd + 4 * kc + t];
#pragma unroll
  for (int rb = rb0; rb < rb1; ++rb) {
    double af[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) af[h][kc] = A[(16 * rb + 8 * h + g) * kLd + 4 * kc + t];
    double acc[4][4];
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) {
      acc[cb][0] = acc[cb][1] = acc[cb][2] = acc[cb][3] = 0.0;
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) dmma(acc[cb], af[0][kc], af[1][kc], bf[cb][kc]);
    }
#pragma unroll
    for (int cb = 0; cb < 4; ++cb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = (16 * rb + 8 * h + g) * kLd + 8 * cb + 2 * t;
        C[idx] = Cin[idx] - acc[cb][2 * h];
        C[idx + 1] = Cin[idx + 1] - acc[cb][2 * h + 1];
      }
  }
}

// float: FFMA on the SIMT cores (Hopper's only f32 matrix instruction is
// TF32, which keeps 10 bits of mantissa).  Lane c owns column c of C and
// holds row c of B in registers; the rows of A come as float4 loads that
// every lane shares (a broadcast), so a step of four k is one load for
// four fma per element, ascending in k.
__device__ __forceinline__ void warp_update32(float* C, const float* Cin, const float* A,
                                              const float* B, int rb0 = 0, int rb1 = 2) {
  const int lane = threadIdx.x & 31;
  float b[kTs];
  const float4* bp = reinterpret_cast<const float4*>(B + lane * kLd);
#pragma unroll
  for (int q = 0; q < kTs / 4; ++q) {
    const float4 v = bp[q];
    b[4 * q] = v.x, b[4 * q + 1] = v.y, b[4 * q + 2] = v.z, b[4 * q + 3] = v.w;
  }
  for (int rb = rb0; rb < rb1; ++rb) {
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int q = 0; q < kTs / 4; ++q) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(A + (16 * rb + i) * kLd + 4 * q);
        acc[i] = fmaf(a.x, b[4 * q], acc[i]);
        acc[i] = fmaf(a.y, b[4 * q + 1], acc[i]);
        acc[i] = fmaf(a.z, b[4 * q + 2], acc[i]);
        acc[i] = fmaf(a.w, b[4 * q + 3], acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int idx = (16 * rb + i) * kLd + lane;
      C[idx] = Cin[idx] - acc[i];
    }
  }
}

// One warp: D = factor of the 32 x 32 block (only its lower part is read),
// inv its inverse pivots; returns the failure as warp_potrf32 does.
template <typename Real>
__device__ __forceinline__ int warp_factor_tile(Real* D, Real* inv, Real* col) {
  Real x[kTs];
  load_row(x, D);
  const int f = warp_potrf32(x, inv, col);
  store_row(x, D);
  return f;
}

// One warp copies one tile (any address in the cluster) with 16-byte loads.
template <typename Real>
__device__ __forceinline__ void warp_copy_tile(Real* dst, const Real* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll 6
  for (int e = threadIdx.x & 31; e < kTileElems * (int)sizeof(Real) / 16; e += 32) d[e] = s[e];
}

// One warp loads tile (i, j) of the matrix m (strides s0, s1) into a
// shared tile, identity-padded past n; on a diagonal tile only c <= r is
// read and the rest is zero.  The loads bypass L1, since another CTA may
// have written m in this launch.
template <typename Real>
__device__ __forceinline__ void warp_load_tile(Real* dst, const Real* m, long long s0,
                                               long long s1, int n, int i, int j) {
  const int lane = threadIdx.x & 31, gj = j * kTs + lane;
#pragma unroll 8
  for (int r = 0; r < kTs; ++r) {
    const int gi = i * kTs + r;
    Real v = gi == gj ? Real(1) : Real(0);
    if (gi < n && gj < n && (i != j || lane <= r)) v = __ldcg(m + gi * s0 + gj * s1);
    dst[r * kLd + lane] = v;
  }
}

// One warp stores the part of a shared tile (i, j) that lies inside the
// n x n row-major matrix m.
template <typename Real>
__device__ __forceinline__ void warp_store_tile(Real* m, int n, int i, int j, const Real* src) {
  const int lane = threadIdx.x & 31, gj = j * kTs + lane;
  if (gj >= n) return;
#pragma unroll 8
  for (int r = 0; r < kTs && i * kTs + r < n; ++r)
    m[(long long)(i * kTs + r) * n + gj] = src[r * kLd + lane];
}

// Split cluster barrier (each thread arrives once, then waits) and named
// CTA barriers (some warps arrive, the others wait).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int Id, int Count>
__device__ __forceinline__ void named_arrive() {
  asm volatile("bar.arrive %0, %1;\n" ::"n"(Id), "n"(Count) : "memory");
}

template <int Id, int Count>
__device__ __forceinline__ void named_wait() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(Id), "n"(Count) : "memory");
}

// ---------------------------------------------------------------------------
// Resident regime: one launch of one CTA or one cluster.
// ---------------------------------------------------------------------------

// Step k, with the factor D_k of diagonal tile k in hand (stop if it
// failed).  Warp 0 of every CTA runs the chain of the next factor: it
// fetches tile (k+1, k), solves L(k+1, k) itself and hands it on (named
// barriers 1 and 4), updates the first 16 rows of tile (k+1, k+1) while
// warp 5 (on another scheduler, so on another tensor core) updates the
// other 16 (barrier 3), and factors it into D_{k+1}.  Warp 4 fetches tile
// (k+1, k+1) for them (barrier 2).  In a cluster both tiles come from out,
// where their owner stored them in step k - 1 (from a in step 0).  The
// other warps solve this CTA's other panel tiles (i, k); after the cluster
// barrier warps 1-3 and 5-7 update this CTA's trailing tiles (the owner of
// row k + 1 also stores L(k+1, k)).  A full cluster barrier ends the step.  So
// the factor of the next diagonal tile, the serial chain of the method,
// runs beside the panel solve and the trailing update.
// Every CTA computes D_k and L(k+1, k) with the same code on the same
// data, so all hold the same values and see the same failure.
template <typename Real>
__global__ void __launch_bounds__(kThreads, 1)
chol_resident_kernel(const Real* __restrict__ a, long long s0, long long s1, long long sa,
                     Real* __restrict__ out, int n, int T, int* __restrict__ info) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Real* smem = reinterpret_cast<Real*>(smem_raw);
  __shared__ int fail[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = (int)cluster.num_blocks();
  const int me = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5;
  const long long bi = blockIdx.y;  // the instance: its matrix, factor and info
  a += bi * sa;
  out += bi * n * n;
  info += bi;
  Real* Dbuf = smem;                     // factored diagonal tiles k, k + 1 (by parity)
  Real* invbuf = smem + 2 * kTileElems;  // their inverse pivots
  Real* col = invbuf + 2 * kTs;          // column scratch of the diagonal factor
  Real* Lst = col + 2 * kTs;             // L(k + 1, k), solved in this CTA
  Real* tiles = Lst + kTileElems;        // the tile rows this CTA owns
  // address of tile (i, j) in the shared memory of row i's owner
  auto tile = [&](int i, int j) { return tiles + (row_slot(i, ctas) + j) * kTileElems; };
  auto remote = [&](int i, int j) {
    return cluster.map_shared_rank(tile(i, j), row_owner(i, ctas));
  };

  if (warp == 0) {  // diagonal tile 0 straight from a, factored while the other warps load
    const int gi = threadIdx.x;
    Real x[kTs];
#pragma unroll
    for (int c = 0; c < kTs; ++c)
      x[c] = c <= gi ? (gi < n ? a[gi * s0 + c * s1] : (c == gi ? Real(1) : Real(0))) : Real(0);
    const int f = warp_potrf32(x, invbuf, col);
    store_row(x, Dbuf);
    if (threadIdx.x == 0) fail[0] = f;
  } else {
    for (int i = 0; i < T; ++i) {  // this CTA's tile rows, identity-padded past n
      if (row_owner(i, ctas) != me) continue;
      Real* base = tile(i, 0);
#pragma unroll 8
      for (int e = threadIdx.x - 32; e < (i + 1) * kTs * kTs; e += kThreads - 32) {
        const int j = e / (kTs * kTs), r = (e / kTs) % kTs, c = e % kTs;
        const int gi = i * kTs + r, gj = j * kTs + c;
        Real v = Real(0);  // strict upper part of a diagonal tile
        if (gj <= gi) v = gi < n ? a[gi * s0 + gj * s1] : (gj == gi ? Real(1) : Real(0));
        base[j * kTileElems + r * kLd + c] = v;
      }
    }
  }
  cluster.sync();

  int failed = 0;
  for (int k = 0; k < T; ++k) {
    const Real* D = Dbuf + (k & 1) * kTileElems;
    const Real* inv = invbuf + (k & 1) * kTs;
    if (fail[k & 1]) {  // the same verdict in every CTA
      failed = k * kTs + fail[k & 1];
      break;
    }
    const bool next = k + 1 < T;
    Real* Dn = Dbuf + ((k + 1) & 1) * kTileElems;
    if (warp == 0) {
      if (next) {  // read before the trailing update below overwrites it
        if (ctas == 1) warp_copy_tile(Lst, tile(k + 1, k));
        else if (k == 0) warp_load_tile(Lst, a, s0, s1, n, 1, 0);
        else warp_load_tile(Lst, out, n, 1, n, k + 1, k);
        __syncwarp();
      }
      cluster_arrive();
      if (next) {
        Real x[kTs];
        load_row(x, Lst);
        warp_trsm32(x, D, inv);
        store_row(x, Lst);
        named_arrive<4, 64>();         // L(k+1, k) for warp 5
        named_arrive<1, kThreads>();   // ... and for the trailing update
        named_wait<2, 96>();           // warp 4 copied tile (k+1, k+1)
        warp_update32(Dn, Dn, Lst, Lst, 0, 1);
        named_wait<3, 64>();           // warp 5 updated its other rows
        const int f = warp_factor_tile(Dn, invbuf + ((k + 1) & 1) * kTs, col);
        if (threadIdx.x == 0) fail[(k + 1) & 1] = f;
      }
      cluster_wait();
    } else if (warp == 5) {
      cluster_arrive();
      if (next) {
        named_wait<4, 64>();
        named_wait<2, 96>();
        warp_update32(Dn, Dn, Lst, Lst, 1, 2);
        named_arrive<3, 64>();
      }
      cluster_wait();
    } else {
      constexpr int kSolvers = kWarps - 2;
      const int slot = warp < 5 ? warp - 1 : warp - 2;
      if (warp == 4 && next) {
        if (ctas == 1) warp_copy_tile(Dn, tile(k + 1, k + 1));
        else if (k == 0) warp_load_tile(Dn, a, s0, s1, n, 1, 1);
        else warp_load_tile(Dn, out, n, 1, n, k + 1, k + 1);
        named_arrive<2, 96>();
      }
      if (row_owner(k, ctas) == me) {    // tile (k, k) was last read in step k - 1 (if k > 0)
        Real* dst = tile(k, k);
        for (int e = slot * 32 + (threadIdx.x & 31); e < kTs * kTs; e += kSolvers * 32) {
          const int idx = (e / kTs) * kLd + e % kTs;
          dst[idx] = D[idx];
        }
      }
      for (int i = k + 2, t = 0; i < T; ++i) {
        if (row_owner(i, ctas) != me || t++ % kSolvers != slot) continue;
        Real x[kTs];
        load_row(x, tile(i, k));
        warp_trsm32(x, D, inv);
        store_row(x, tile(i, k));
      }
      cluster_arrive();
      cluster_wait();  // panel k final in every CTA
    }
    if (next && warp == 4) named_wait<1, kThreads>();
    if (next && warp != 0 && warp != 4) {  // warp 4 leaves warp 0's scheduler to the chain
      constexpr int kWork = kWarps - 2;
      const int slot = warp < 4 ? warp - 1 : warp - 2;
      named_wait<1, kThreads>();  // L(k+1, k) in Lst
      if (row_owner(k + 1, ctas) == me) {
        Real* dst = tile(k + 1, k);
        for (int e = slot * 32 + (threadIdx.x & 31); e < kTs * kTs; e += kWork * 32) {
          const int idx = (e / kTs) * kLd + e % kTs;
          dst[idx] = Lst[idx];
        }
      }
      for (int i = k + 2, t = 0; i < T; ++i) {
        if (row_owner(i, ctas) != me) continue;
        for (int j = k + 1; j <= i; ++j) {
          if (t++ % kWork != slot) continue;
          warp_update32(tile(i, j), tile(i, j), tile(i, k), j == k + 1 ? Lst : remote(j, k));
          if (i == k + 2 && ctas > 1) {  // the chain of step k + 1 reads these two from out
            __syncwarp();
            warp_store_tile(out, n, i, j, tile(i, j));
          }
        }
      }
    }
    cluster.sync();  // trailing tiles and the next diagonal factor done
  }
  cluster.sync();  // no CTA leaves while another may read its tiles

  for (int i = 0; i < T; ++i) {  // L's rows, zeros right of the diagonal tile
    if (row_owner(i, ctas) != me) continue;
#pragma unroll 4
    for (int j = 0; j < T; ++j) {
      const Real* src = tile(i, min(i, j));
#pragma unroll
      for (int it = 0; it < kTs * kTs / kThreads; ++it) {
        const int e = threadIdx.x + it * kThreads, r = e / kTs, c = e % kTs;
        const int gi = i * kTs + r, gj = j * kTs + c;
        if (gi < n && gj < n) out[(long long)gi * n + gj] = gj <= gi ? src[r * kLd + c] : Real(0);
      }
    }
  }
  if (me == 0 && threadIdx.x == 0) *info = failed;
}

// ---------------------------------------------------------------------------
// Blocked regime, n > 512: P = ceil(n / 64) panels of 64 columns, in two
// launches: a copy of the lower triangle of a into out, then one persistent
// kernel whose CTAs are all resident at once (cooperative launch).
//
// CTA 0 runs the chain, the serial part of the method, and keeps its code
// and the current diagonal factor on chip: it factors diagonal block 0, and
// for each panel k < P - 1 solves block (k+1, k), updates the diagonal
// block (k+1, k+1) with it and factors that block.  The other CTAs take
// tasks in order from a counter: per panel k, the solves of blocks (i, k),
// i >= k + 2, then the updates of the lower trailing tiles (i, j),
// k + 1 <= j <= i, but (k+1, k+1).  Each task first waits for its inputs
// (flags in ws, raised with release stores after a CTA barrier): a solve
// for the factor of block k and for tile (i, k) to hold the updates of
// panels 0 .. k-1; an update for blocks (i, k) and (j, k) and for the
// update of tile (i, j) by panel k - 1.  Every input of a task comes from a
// task earlier in the order or from the chain, whose inputs come from
// earlier tasks, so a CTA that waits waits on CTAs that run: no wait can
// hang.  A wait that lasts seconds stops the kernel with info = -1.
//
// Data written in the kernel is read past L1 (ld.cg, cp.async.cg).  The
// factored diagonal blocks stay in out, their inverse pivots in ws.  A
// solve also zeros the block mirroring its own above the diagonal.  The
// first failing block sets info; the factorization runs on (L is
// unspecified then).
// ---------------------------------------------------------------------------

__host__ __device__ inline int blocked_panels(int n) { return (n + kNB - 1) / kNB; }

// ws (workspace<Real>(n) elements): 64 P inverse pivots, then 3 + P + P^2
// ints.
template <typename Real>
struct BlockedWs {
  Real* inv;   // inv[64 k + c]: inverse pivots of diagonal block k
  int* next;     // tasks taken
  int* chain;    // chain = k + 1 once diagonal block k is factored
  int* abort;    // a wait timed out
  int* solved;   // solved[i] = k + 1 once block (i, k) is solved
  int* updated;  // updated[i P + j] = panels applied to tile (i, j)
};

template <typename Real>
__device__ __forceinline__ BlockedWs<Real> blocked_ws(Real* ws, int n) {
  const int P = blocked_panels(n);
  BlockedWs<Real> w;
  w.inv = ws;
  w.next = reinterpret_cast<int*>(ws + (long long)P * kNB);
  w.chain = w.next + 1;
  w.abort = w.next + 2;
  w.solved = w.next + 3;
  w.updated = w.solved + P;
  return w;
}

__device__ __forceinline__ void release_flag(int* flag, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(flag), "r"(v) : "memory");
}

__device__ __forceinline__ int acquire_flag(const int* flag) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(flag) : "memory");
  return v;
}

// Thread 0 waits until *flag >= at_least; false if the kernel is aborting.
__device__ bool wait_flag(const int* flag, int at_least, int* abort) {
  for (long long spin = 0;; ++spin) {
    if (acquire_flag(flag) >= at_least) return true;
    if ((spin & 1023) == 0 && (spin > (1LL << 22) || *(volatile int*)abort)) {
      *(volatile int*)abort = 1;
      return false;
    }
    __nanosleep(32);
  }
}

// After the CTA's stores: barrier, then thread 0 raises the flag (the
// release store orders the stores the barrier made it see).
__device__ __forceinline__ void publish(int* flag, int v) {
  __syncthreads();
  if (threadIdx.x == 0) release_flag(flag, v);
}

// Out-of-line copies of the warp building blocks for the blocked regime.
// Its chain runs them once per panel, beside CTAs that keep L2 busy, so
// their instructions must stay in the SM's instruction cache: one copy of
// each instead of one per call site.
template <typename Real>
__device__ __noinline__ int factor_tile_ool(Real* D, Real* inv, Real* col) {
  return warp_factor_tile(D, inv, col);
}

// One warp: X := X L^{-T} for 32 x 32 tiles (rows of X in lanes).
template <typename Real>
__device__ __noinline__ void solve_tile_ool(Real* X, const Real* L, const Real* inv) {
  Real x[kTs];
  load_row(x, X);
  warp_trsm32(x, L, inv);
  store_row(x, X);
}

template <typename Real>
__device__ __noinline__ void update_tile_ool(Real* C, const Real* A, const Real* B) {
  warp_update32(C, C, A, B);
}

// One warp: factor the 64 x 64 block held as its lower tiles G00 = G,
// G10 = G + kTileElems, G11 = G + 2 kTileElems; inv gets its 64 inverse
// pivots.  Returns 0 or the 1-based order of the first failing pivot.
template <typename Real>
__device__ int warp_factor64(Real* G, Real* inv, Real* col) {
  Real* G10 = G + kTileElems;
  Real* G11 = G + 2 * kTileElems;
  const int fail = factor_tile_ool(G, inv, col);
  solve_tile_ool(G10, G, inv);
  __syncwarp();
  update_tile_ool(G11, G10, G10);
  __syncwarp();
  const int f = factor_tile_ool(G11, inv + kTs, col);
  return fail ? fail : (f ? f + kTs : 0);
}

// Offset of element (r, c), c <= r, of a 64 x 64 block in its lower tiles.
__device__ __forceinline__ int g_index(int r, int c) {
  return (r / kTs + c / kTs) * kTileElems + (r % kTs) * kLd + c % kTs;
}

// Offset of element (r, c) of a full 64 x 64 block in tiles X[2 (r / 32) + c / 32].
__device__ __forceinline__ int x_index(int r, int c) {
  return (2 * (r / kTs) + c / kTs) * kTileElems + (r % kTs) * kLd + c % kTs;
}

// X (64 x 64 in tiles) := X L^{-T}, L = [[G00, 0], [G10, G11]]; warps 0
// and 1 take one tile row each.  Starts and ends with a CTA barrier.
template <typename Real>
__device__ __forceinline__ void solve_panel_block(Real* X, const Real* G, const Real* inv) {
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    Real* X0 = X + 2 * warp * kTileElems;
    Real* X1 = X0 + kTileElems;
    solve_tile_ool(X0, G, inv);
    __syncwarp();
    update_tile_ool(X1, X0, G + kTileElems);
    __syncwarp();
    solve_tile_ool(X1, G + 2 * kTileElems, inv + kTs);
  }
  __syncthreads();
}

// The CTA loads diagonal block (d, d) of A (lower part, identity-padded
// past n) into lower tiles G.
template <typename Real>
__device__ __forceinline__ void load_diag_block(Real* G, const Real* A, int n, int d) {
  const int r0 = d * kNB;
#pragma unroll 4
  for (int it = 0; it < kNB * kNB / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads, r = e / kNB, c = e % kNB;
    if (c / kTs > r / kTs) continue;
    Real v = r == c ? Real(1) : Real(0);
    if (r0 + r < n && c <= r) v = __ldcg(A + (long long)(r0 + r) * n + r0 + c);
    G[g_index(r, c)] = v;
  }
}

// The CTA writes the factored block G, zeros above the diagonal, into
// diagonal block (d, d) of A, and its inverse pivots into inv_out.
template <typename Real>
__device__ __forceinline__ void store_diag_block(const Real* G, const Real* inv, Real* A,
                                                 int n, int d, Real* inv_out) {
  const int r0 = d * kNB;
#pragma unroll 4
  for (int it = 0; it < kNB * kNB / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads, r = e / kNB, c = e % kNB;
    if (r0 + r < n && r0 + c < n)
      A[(long long)(r0 + r) * n + r0 + c] = c <= r ? G[g_index(r, c)] : Real(0);
  }
  if (threadIdx.x < kNB) inv_out[threadIdx.x] = inv[threadIdx.x];
}

// Panel block (i, k) of A into X, rows past n zero.
template <typename Real>
__device__ __forceinline__ void load_panel_block(Real* X, const Real* A, int n, int i, int k) {
#pragma unroll 4
  for (int it = 0; it < kNB * kNB / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads, r = e / kNB, c = e % kNB, gi = i * kNB + r;
    X[x_index(r, c)] = gi < n ? __ldcg(A + (long long)gi * n + k * kNB + c) : Real(0);
  }
}

// Solved panel block X into block (i, k) of A; zeros into block (k, i).
template <typename Real>
__device__ __forceinline__ void store_panel_block(const Real* X, Real* A, int n, int i, int k) {
#pragma unroll 4
  for (int it = 0; it < kNB * kNB / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads, r = e / kNB, c = e % kNB, gi = i * kNB + r;
    if (gi < n) A[(long long)gi * n + k * kNB + c] = X[x_index(r, c)];
    const int gj = i * kNB + c;
    if (gj < n) A[(long long)(k * kNB + r) * n + gj] = Real(0);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One thread's products of update_tile over one staged 32-column group:
// acc[cf][2 rf + h] += sum_k Li[row(rf)][k] Lj[col(cf, h)][k] for the
// rows 16 wr + 8 rf + g and columns 32 wc + 8 cf + 2 t + h of the tile.
// double: on the f64 tensor cores, k in four-wide steps (m16n8k4).
__device__ __forceinline__ void tile_products(double (&acc)[4][4], const double* Li,
                                              const double* Lj, int half) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp >> 1, wc = warp & 1, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < kTs / 4; ++kc) {
    const int kk = half * kTs + 4 * kc + t;
    double af[2], bf[4];
#pragma unroll
    for (int rf = 0; rf < 2; ++rf) af[rf] = Li[(16 * wr + 8 * rf + g) * kStageLd + kk];
#pragma unroll
    for (int cf = 0; cf < 4; ++cf) bf[cf] = Lj[(32 * wc + 8 * cf + g) * kStageLd + kk];
#pragma unroll
    for (int cf = 0; cf < 4; ++cf) dmma(acc[cf], af[0], af[1], bf[cf]);
  }
}

// float: FFMA, each element's products one chain ascending in k, the rows
// and columns read four k at a time (float4); 10 loads for 64 fma.
__device__ __forceinline__ void tile_products(float (&acc)[4][4], const float* Li,
                                              const float* Lj, int half) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp >> 1, wc = warp & 1, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < kTs / 4; ++q) {
    const int kk = half * kTs + 4 * q;
    float4 af[2], bf[4][2];
#pragma unroll
    for (int rf = 0; rf < 2; ++rf)
      af[rf] = *reinterpret_cast<const float4*>(Li + (16 * wr + 8 * rf + g) * kStageLd + kk);
#pragma unroll
    for (int cf = 0; cf < 4; ++cf)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        bf[cf][h] = *reinterpret_cast<const float4*>(
            Lj + (32 * wc + 8 * cf + 2 * t + h) * kStageLd + kk);
#pragma unroll
    for (int rf = 0; rf < 2; ++rf)
#pragma unroll
      for (int cf = 0; cf < 4; ++cf)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& c = acc[cf][2 * rf + h];
          c = fmaf(af[rf].x, bf[cf][h].x, c);
          c = fmaf(af[rf].y, bf[cf][h].y, c);
          c = fmaf(af[rf].z, bf[cf][h].z, c);
          c = fmaf(af[rf].w, bf[cf][h].w, c);
        }
  }
}

// The CTA: tile (i, j) of A -= L(i, k) L(j, k)^T (64 x 64 tiles; only the
// lower triangle of a diagonal tile is stored).  The two panel blocks are
// staged through shared memory (Li, Lj) in two 32-column groups, the
// second in flight while the first is multiplied (tile_products).
template <typename Real>
__device__ void update_tile(Real* A, int n, int i, int j, int k, Real* Li, Real* Lj) {
  constexpr int V = 16 / sizeof(Real);  // elements of one 16-byte copy
  const int i0 = i * kNB, j0 = j * kNB, k0 = k * kNB;
  const bool vectors = n % V == 0;  // rows start on 16 bytes: copy V elements at once
  for (int half = 0; half < 2; ++half) {
    if (vectors) {
#pragma unroll 2
      for (int it = 0; it < 2 * kNB * kTs / V / kThreads; ++it) {
        const int e = threadIdx.x + it * kThreads;
        const int which = e / (kNB * kTs / V), rem = e % (kNB * kTs / V);
        const int r = rem / (kTs / V), c = half * kTs + V * (rem % (kTs / V));
        const int gr = (which ? j0 : i0) + r;
        Real* dst = (which ? Lj : Li) + r * kStageLd + c;
        if (gr < n) {
          cp_async16(dst, A + (long long)gr * n + k0 + c);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) dst[v] = Real(0);
        }
      }
    } else {
#pragma unroll 2
      for (int it = 0; it < 2 * kNB * kTs / kThreads; ++it) {
        const int e = threadIdx.x + it * kThreads;
        const int which = e / (kNB * kTs), rem = e % (kNB * kTs);
        const int r = rem / kTs, c = half * kTs + rem % kTs;
        const int gr = (which ? j0 : i0) + r;
        (which ? Lj : Li)[r * kStageLd + c] =
            gr < n ? __ldcg(A + (long long)gr * n + k0 + c) : Real(0);
      }
    }
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp >> 1, wc = warp & 1, g = lane >> 2, t = lane & 3;
  // this thread's elements of the tile: rows i0 + row(rf), columns j0 + col(cf, h)
  auto row = [&](int rf) { return 16 * wr + 8 * rf + g; };
  auto col = [&](int cf, int h) { return 32 * wc + 8 * cf + 2 * t + h; };
  Real cv[2][4][2];
#pragma unroll
  for (int rf = 0; rf < 2; ++rf)  // start all the C loads before the products
#pragma unroll
    for (int cf = 0; cf < 4; ++cf)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gi = i0 + row(rf), gj = j0 + col(cf, h);
        cv[rf][cf][h] = (gi < n && gj <= gi) ? __ldcg(A + (long long)gi * n + gj) : Real(0);
      }
  Real acc[4][4];  // acc[cf][2 rf + h] is element (row(rf), col(cf, h))
#pragma unroll
  for (int cf = 0; cf < 4; ++cf) acc[cf][0] = acc[cf][1] = acc[cf][2] = acc[cf][3] = Real(0);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (half == 0) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    tile_products(acc, Li, Lj, half);
  }
#pragma unroll
  for (int rf = 0; rf < 2; ++rf)
#pragma unroll
    for (int cf = 0; cf < 4; ++cf)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gi = i0 + row(rf), gj = j0 + col(cf, h);
        if (gi < n && gj <= gi) A[(long long)gi * n + gj] = cv[rf][cf][h] - acc[cf][2 * rf + h];
      }
}

// Lower triangle of a into out, one CTA per row; info and the flags of ws
// start at 0.
template <typename Real>
__global__ void __launch_bounds__(kThreads)
chol_copy_kernel(const Real* __restrict__ a, long long s0, long long s1,
                 Real* __restrict__ out, int n, int* __restrict__ info, Real* __restrict__ ws) {
  const int i = blockIdx.x;
  const Real* src = a + i * s0;
  Real* dst = out + (long long)i * n;
#pragma unroll 4
  for (int j = threadIdx.x; j <= i; j += kThreads) dst[j] = src[j * s1];
  if (i == 0) {
    const int P = blocked_panels(n);
    int* flags = blocked_ws<Real>(ws, n).next;
    for (int e = threadIdx.x; e < 3 + P + P * P; e += kThreads) flags[e] = 0;
    if (threadIdx.x == 0) *info = 0;
  }
}

// Tasks of panel k: T - 1 solves, then T (T + 1) / 2 - 1 updates.
__host__ __device__ inline int panel_tasks(int P, int k) {
  const int T = P - 1 - k;
  return T - 1 + T * (T + 1) / 2 - 1;
}

template <typename Real>
__device__ void chain_cta(Real* A, int n, const BlockedWs<Real>& w, int* info, Real* smem) {
  __shared__ int fail, ok;
  const int P = blocked_panels(n);
  const int warp = threadIdx.x >> 5;
  Real* G = smem;                  // factored diagonal block k: tiles (0,0), (1,0), (1,1)
  Real* H = G + 3 * kTileElems;    // diagonal block k + 1
  Real* X = H + 3 * kTileElems;    // block (k+1, k), 4 tiles
  Real* inv = X + 4 * kTileElems;  // inverse pivots of G and H, by parity
  Real* col = inv + 2 * kNB;       // column scratch of the factor
  load_diag_block(G, A, n, 0);
  __syncthreads();
  if (warp == 0) {
    const int f = warp_factor64(G, inv, col);
    if (threadIdx.x == 0) fail = f;
  }
  __syncthreads();
  store_diag_block(G, inv, A, n, 0, w.inv);
  if (threadIdx.x == 0 && fail) *info = fail;
  publish(w.chain, 1);
  for (int k = 0; k + 1 < P; ++k) {
    Real* Gi = inv + (k & 1) * kNB;
    Real* Hi = inv + ((k + 1) & 1) * kNB;
    if (threadIdx.x == 0) {
      ok = wait_flag(w.updated + (k + 1) * P + k, k, w.abort) &&
           wait_flag(w.updated + (k + 1) * P + k + 1, k, w.abort);
    }
    __syncthreads();
    if (!ok) break;
    load_panel_block(X, A, n, k + 1, k);
    load_diag_block(H, A, n, k + 1);
    solve_panel_block(X, G, Gi);
    store_panel_block(X, A, n, k + 1, k);
    publish(w.solved + k + 1, k + 1);
    if (warp < 3) {  // H -= X X^T on tiles (0,0), (1,0), (1,1), 32 columns of X at a time
      const int tr = warp == 0 ? 0 : 1, tc = warp == 2 ? 1 : 0;
      Real* C = H + (tr + tc) * kTileElems;
      update_tile_ool(C, X + 2 * tr * kTileElems, X + 2 * tc * kTileElems);
      __syncwarp();
      update_tile_ool(C, X + (2 * tr + 1) * kTileElems, X + (2 * tc + 1) * kTileElems);
    }
    __syncthreads();
    if (warp == 0) {
      const int f = warp_factor64(H, Hi, col);
      if (threadIdx.x == 0) fail = f;
    }
    __syncthreads();
    store_diag_block(H, Hi, A, n, k + 1, w.inv + (k + 1) * kNB);
    if (threadIdx.x == 0 && fail && *info == 0) *info = (k + 1) * kNB + fail;
    publish(w.chain, k + 2);
    Real* tmp = G;  // the new factor is the next step's G
    G = H;
    H = tmp;
  }
}

// The blocked factorization after the copy (see above).
template <typename Real>
__global__ void __launch_bounds__(kThreads, 1)
chol_blocked_kernel(Real* __restrict__ A, int n, Real* __restrict__ ws,
                    int* __restrict__ info) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Real* smem = reinterpret_cast<Real*>(smem_raw);
  __shared__ int task, ok;
  const BlockedWs<Real> w = blocked_ws(ws, n);
  if (blockIdx.x == 0) {
    chain_cta(A, n, w, info, smem);
  } else {
    const int P = blocked_panels(n);
    int taken = threadIdx.x == 0 ? atomicAdd(w.next, 1) : 0;
    for (;;) {
      if (threadIdx.x == 0) {
        task = taken;
        taken = atomicAdd(w.next, 1);  // the next task, fetched while this one runs
      }
      __syncthreads();
      int t = task, k = 0;
      while (k + 1 < P && t >= panel_tasks(P, k)) t -= panel_tasks(P, k++);
      if (k + 1 >= P) break;
      const int T = P - 1 - k;
      if (t < T - 1) {  // solve block (i, k)
        const int i = k + 2 + t;
        Real* G = smem;
        Real* X = G + 3 * kTileElems;
        Real* inv = X + 4 * kTileElems;
        if (threadIdx.x == 0)
          ok = wait_flag(w.chain, k + 1, w.abort) &&
               wait_flag(w.updated + i * P + k, k, w.abort);
        __syncthreads();
        if (!ok) break;
        load_diag_block(G, A, n, k);  // the factor: its lower part
        if (threadIdx.x < kNB) inv[threadIdx.x] = __ldcg(w.inv + k * kNB + threadIdx.x);
        load_panel_block(X, A, n, i, k);
        solve_panel_block(X, G, inv);
        store_panel_block(X, A, n, i, k);
        publish(w.solved + i, k + 1);
      } else {  // update lower tile (k+1+bi, k+1+bj), b = 1 .. skips (k+1, k+1)
        const int b = t - (T - 1) + 1;
        int bi = ((int)__fsqrt_rn((float)(8 * b + 1)) - 1) / 2;  // then made exact below
        while (bi * (bi + 1) / 2 > b) --bi;
        while ((bi + 1) * (bi + 2) / 2 <= b) ++bi;
        const int i = k + 1 + bi, j = k + 1 + b - bi * (bi + 1) / 2;
        if (threadIdx.x == 0)
          ok = wait_flag(w.solved + i, k + 1, w.abort) && wait_flag(w.solved + j, k + 1, w.abort) &&
               wait_flag(w.updated + i * P + j, k, w.abort);
        __syncthreads();
        if (!ok) break;
        update_tile(A, n, i, j, k, smem, smem + kNB * kStageLd);
        publish(w.updated + i * P + j, k + 1);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && *(volatile int*)w.abort) *info = -1;
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

int resident_tiles(int T, int ctas) {
  int most = 0;
  for (int c = 0; c < ctas; ++c) {
    int held = 0;
    for (int i = 0; i < T; ++i)
      if (row_owner(i, ctas) == c) held += i + 1;
    most = std::max(most, held);
  }
  return most;
}

// Raise the dynamic shared-memory limits once per device.
template <typename Real>
cudaError_t set_smem_limits() {
  static unsigned done = 0;  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit && (done & bit)) return cudaSuccess;
  if ((err = cudaFuncSetAttribute(chol_resident_kernel<Real>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)resident_smem<Real>())) != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(chol_blocked_kernel<Real>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)blocked_smem<Real>())) != cudaSuccess) return err;
  done |= bit;
  return cudaSuccess;
}

template <typename Real>
cudaError_t launch_resident(const Real* a, long long s0, long long s1, long long sa, int nbatch,
                            Real* out, int n, int* info, cudaStream_t st) {
  const int T = (n + kTs - 1) / kTs;
  const int ctas = T <= kSingleCtaMaxT ? 1 : kClusterCtas;
  const size_t smem =
      (size_t)((resident_tiles(T, ctas) + 3) * kTileElems + 4 * kTs) * sizeof(Real);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, nbatch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, chol_resident_kernel<Real>, a, s0, s1, sa, out, n, T, info);
}

template <typename Real>
cudaError_t launch_blocked(const Real* a, long long s0, long long s1, Real* out, int n,
                           int* info, Real* ws, cudaStream_t st) {
  static int ctas[32] = {};  // resident CTAs of the persistent kernel, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (ctas[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chol_blocked_kernel<Real>,
                                                        kThreads, blocked_smem<Real>());
    if (err != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    if (per_sm * sms < 2) return cudaErrorInvalidConfiguration;
    ctas[dev] = per_sm * sms;
  }
  chol_copy_kernel<Real><<<n, kThreads, 0, st>>>(a, s0, s1, out, n, info, ws);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  void* args[] = {&out, &n, &ws, &info};
  return cudaLaunchCooperativeKernel((void*)chol_blocked_kernel<Real>, dim3(ctas[dev]),
                                     dim3(kThreads), args, blocked_smem<Real>(), st);
}

// Elements of workspace the factorization of order n needs (0 up to the
// resident bound): 64 P inverse pivots, then 3 + P + P^2 ints.
template <typename Real>
long long workspace(int n) {
  if (n <= kResidentMaxN) return 0;
  const long long P = blocked_panels(n);
  const long long ints = 3 + P + P * P;
  return P * kNB + (ints * (long long)sizeof(int) + sizeof(Real) - 1) / sizeof(Real);
}

// nbatch matrices, sa elements apart; out nbatch contiguous n x n
// factors, info nbatch ints.  ws: nbatch times workspace<Real>(n)
// elements, or null up to the resident bound.
template <typename Real>
int factor(const Real* a, long long s0, long long s1, long long sa, int nbatch, Real* out, int n,
           int* info, Real* ws, void* stream) {
  if (n < 1 || nbatch < 1 || nbatch > 65535 || (n > kResidentMaxN && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem_limits<Real>();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= kResidentMaxN) return (int)launch_resident(a, s0, s1, sa, nbatch, out, n, info, st);
  const long long wsz = workspace<Real>(n);
  for (long long i = 0; i < nbatch; ++i) {
    err = launch_blocked(a + i * sa, s0, s1, out + i * n * n, n, info + i, ws + i * wsz, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" long long ttipm_panel_cholesky_workspace(int n) { return workspace<double>(n); }

extern "C" long long ttipm_panel_cholesky_workspace_f32(int n) { return workspace<float>(n); }

extern "C" int ttipm_panel_cholesky(const double* a, long long s0, long long s1, long long sa,
                                    int nbatch, double* out, int n, int* info, double* ws,
                                    void* stream) {
  return factor(a, s0, s1, sa, nbatch, out, n, info, ws, stream);
}

extern "C" int ttipm_panel_cholesky_f32(const float* a, long long s0, long long s1, long long sa,
                                        int nbatch, float* out, int n, int* info, float* ws,
                                        void* stream) {
  return factor(a, s0, s1, sa, nbatch, out, n, info, ws, stream);
}
