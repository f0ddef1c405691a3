// J2: cyclic two-sided Jacobi eigendecomposition of a symmetric f64 matrix
// (the core of the port's eigh and eigvalsh on the card).
//
// Replaces no Pallas kernel.  It is the counterpart of the jnp program
// ttipm_tpu/ops/jacobi.py::_jacobi_eigh_core (:370), which the JAX package
// runs as one XLA program a factorization for every f64 eigh of a TPU
// trace (jacobi_eigh, :431).  It was added because the eigen windows' and
// the step-size pencils' eigh and eigvalsh on the card were cuSOLVER
// calls with a host check of their info (1,586 in a maxcut d10 solve, at
// orders up to 256: tools/jacobi_census.py); this kernel decides convergence on the device and
// never synchronises with the host.  The scaling, the odd-order padding,
// the sort and the removal of the padded pair are torch code around it
// (ttipm_tpu_torch/ops/jacobi.py::jacobi_eigh).
//
// Contract: a, nbatch contiguous symmetric (n, n) f64 matrices, n even,
// 2 <= n <= kMaxN.  Out: w, the diagonal of the rotated matrix (the
// eigenvalues, unsorted), and V (exactly orthonormal, a = V diag(w) V^T),
// contiguous.  Same schedule, rotation rule, tolerance and stop test as
// the plain version (ops/jacobi.py::eigh_core_plain): step k rotates the
// n / 2 disjoint pairs (i, j) of the round-robin schedule, first the
// columns (A G), then the rows (G^T (A G)), then the columns of V.  With
// b_ij = (a_ij + a_ji) / 2 and s_ij = max(sqrt(|a_ii a_jj|), s0, 1e-30),
// s0 = floor_rel max |a| of the input, a pair is rotated where |b_ij| >
// tol s_ij, by t = sign(tau) / (|tau| + sqrt(1 + tau^2)), tau = (a_jj -
// a_ii) / (2 b_ij); the sweeps stop after one without a rotation, or
// after 26; an instance that still rotated in its 26th sweep, or met a
// non-finite number, comes out NaN.  (The JAX program measures a_ij
// against sqrt(|a_ii a_jj| + 1e-30) and tests the matrix after each
// sweep: see eigh_core_plain.)
//
// Design.  A and V of order 256 take 1 MB in f64: no CTA holds them.  An
// instance is a cluster of 1, 2, 4 or 8 CTAs (the fewest whose shares fit,
// ops/kernels.py::j2_plan) that split the n indices into blocks of nc =
// ceil(n / ctas).  CTA r holds columns r nc .. r nc + nc - 1 of A twice
// (the step reads one copy, writes the other) and the same rows of V, each
// with an odd leading dimension in its shared memory: 3 nc (n + 1) 8
// bytes, 198 KB at n = 256 on 8 CTAs, 229 KB at n = 272 (kMaxN).  A step:
//  1. every CTA computes the rotations of all n / 2 pairs itself, from
//     a_ii, a_jj and a_ij read through distributed shared memory, so that
//     all hold the same bits and no rotation is broadcast; the same
//     threads note each owned column's pair and its partner's address;
//  2. the owner of column c writes column c of G^T A G into its other
//     copy: with the partner column c' of c's pair (local or remote), row
//     r of the new column is the row rotation of pair (r, r') applied to
//     the column rotation of (c, c') at rows r and r', which is the JAX
//     program's order of operations element by element; the same item
//     rotates the columns r, r' of row c of V in place (V G mixes columns
//     only, so rows are independent).  A thread walks its items with a
//     fixed stride (no division in the step);
//  3. one cluster barrier (a CTA barrier on a cluster of one): no CTA
//     reads a copy before it is complete or writes one that another still
//     reads.
// Every CTA notes whether a pair of the sweep rotated (or met a
// non-finite number) from the decisions it computed itself, alike in all:
// no exchange decides the stop.  s0 is the one cluster-wide reduction
// (each CTA's maximum into CTA 0, combined in rank order by all).  An instance's result does not depend on the batch: the
// batch is the grid's y axis, a cluster an instance.
//
// Bound on the H100: a step does 12 flops for each (column, row pair) of
// A (6 n^2) and 6 for each (row, pair) of V (3 n^2), n - 1 steps a sweep:
// about 9 n^2 (n - 1) flops a sweep,
// which chip_smoke.py's bound_ms counts for the sweeps this run's data
// needed (the kernel reports them); n^2 8 bytes in, n^2 + n out.  At n =
// 256 and 8 sweeps that is 1.2 GFLOP, 18 us at the card's 67 TFLOP/s f64.
// What bounds the kernel is latency: n - 1 dependent steps a sweep, each a round of remote loads,
// a square root and two divisions, the updates and a cluster barrier.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "jacobi.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ttipm::jacobi;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxN = 272;
constexpr int kMaxCtas = 8;
constexpr int kMaxThreads = 1024;
constexpr int kScratch = 48;  // 32 warp maxima, then kMaxCtas CTA maxima (in CTA 0)

size_t smem_bytes(int n, int ctas) {
  const size_t nc = (n + ctas - 1) / ctas, h = n / 2;
  return sizeof(double) * (3 * nc * (n | 1) + 2 * h + kScratch + nc) +
         sizeof(int) * (2 * h + nc + 2);
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max_nan(v, __shfl_xor_sync(kFull, v, off));
  return v;
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

__global__ void __launch_bounds__(kMaxThreads, 1)
jacobi_eigh_kernel(const double* __restrict__ a, int n, int ctas, double tol, double floor_rel,
                   double* __restrict__ w_out, double* __restrict__ v_out,
                   int* __restrict__ sweeps_out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h = n / 2, ld = n | 1, nc = (n + ctas - 1) / ctas;
  const int c0 = rank * nc;
  const int own = max(0, min(n, c0 + nc) - c0);
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
  for (int e = tid; e < own * n; e += nthreads) {
    const int lr = e / n, c = e - lr * n;
    V[lr * ld + c] = c0 + lr == c ? 1.0 : 0.0;
  }
  const double s0 = fmax(floor_rel * cluster_max(cluster, amax, red, ctas, rank), kTiny);
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
        const double scale = fmax(__dsqrt_rn(fabs(aii * ajj)), s0);
        const bool rotate = fabs(bij) > tol * scale;
        if (rotate) flags[0] = 1;
        if (!isfinite(aii + ajj + bij)) flags[1] = 1;
        rotation(rotate, __ddiv_rn(ajj - aii, 2.0 * (rotate ? bij : 1.0)), cs[p], sn[p]);
      }
      __syncthreads();
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
        double* vr = V + lc * ld;
        const double vi = vr[ri], vj = vr[rj];
        vr[ri] = cq * vi - sq * vj;
        vr[rj] = sq * vi + cq * vj;
        q += dq;
        lc += dl;
        if (q >= h) {
          q -= h;
          ++lc;
        }
      }
      // 3. no CTA reads a copy before it is complete or writes one that
      //    another still reads
      if (ctas == 1)
        __syncthreads();
      else
        cluster.sync();
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
  double* vo = v_out + blockIdx.y * nn + (long long)c0 * n;
  for (int e = tid; e < own * n; e += nthreads) {
    const int lr = e / n, c = e - lr * n;
    vo[e] = bad ? nan : V[lr * ld + c];
  }
  if (rank == 0 && tid == 0 && sweeps_out != nullptr) sweeps_out[blockIdx.y] = sweeps;
}

}  // namespace

// a: nbatch contiguous symmetric (n, n) f64 matrices; w: nbatch n outputs,
// v: nbatch (n, n) outputs, contiguous; sweeps: null, or nbatch ints that
// receive each instance's sweeps.  tol: the plain version's
// tol_for(n).  ctas, threads: ops/kernels.py::j2_plan.  One cluster of
// ctas CTAs an instance; the dynamic shared memory limit is raised once
// per device.
extern "C" int ttipm_jacobi_eigh(const double* a, int nbatch, int n, double tol, double floor_rel,
                                 double* w,
                                 double* v, int* sweeps, int ctas, int threads,
                                 void* stream) {
  if (n < 2 || n > kMaxN || n % 2 != 0 || nbatch < 1 || nbatch > 65535 ||
      (ctas != 1 && ctas != 2 && ctas != 4 && ctas != kMaxCtas) || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || !(tol > 0.0) || !(floor_rel >= 0.0))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n, ctas);
  if (smem > (size_t)kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  static unsigned raised = 0;  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(raised & bit)) {
    err = cudaFuncSetAttribute(jacobi_eigh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxDynamicSmem);
    if (err != cudaSuccess) return (int)err;
    raised |= bit;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, nbatch);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, jacobi_eigh_kernel, a, n, ctas, tol, floor_rel, w, v,
                           sweeps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
