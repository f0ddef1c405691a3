// What the two Jacobi kernels (jacobi_svd.cu, jacobi_eigh.cu) share: the
// round-robin schedule, the rotation angle and the constants of the JAX
// package's Jacobi programs (ttipm_tpu/ops/jacobi.py), in float64; the
// block regimes' pieces (the inner sweep on a pair of blocks with its
// threshold and refined rotations, the f64 tensor core product, the ring
// shift of the block columns); the clock stamps; the cluster launch.
#pragma once

#include <cuda_runtime.h>

namespace ttipm {
namespace jacobi {

constexpr double kTiny = 1e-30;   // TINY, ttipm_tpu/ops/jacobi.py:46
constexpr int kMaxSweeps = 26;    // _MAX_SWEEPS
constexpr int kMaxDynamicSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;

// The index at position p of step k of the round-robin schedule of even
// order n (_round_robin, ttipm_tpu/ops/jacobi.py:70-82): position 0 holds
// 0, position p >= 1 holds 1 + (p - 1 - k) mod (n - 1).  Step k pairs the
// indices at positions p and n - 1 - p, p < n / 2.
__device__ __forceinline__ int schedule_index(int n, int k, int p) {
  if (p == 0) return 0;
  const int r = (p - 1 - k) % (n - 1);
  return 1 + (r < 0 ? r + n - 1 : r);
}

// The position of index x at step k (the inverse of schedule_index).
__device__ __forceinline__ int schedule_position(int n, int k, int x) {
  return x == 0 ? 0 : 1 + (x - 1 + k) % (n - 1);
}

// The position the round robin of order np moves position p to (position
// 0 stays, np - 1 goes to 1, the others one up), and the slot and half
// that hold a position: the block regimes' ring shift.
__device__ __forceinline__ int next_position(int np, int p) {
  return p == 0 ? 0 : (p == np - 1 ? 1 : p + 1);
}
__device__ __forceinline__ int slot_of(int np, int p) { return p < np / 2 ? p : np - 1 - p; }
__device__ __forceinline__ int half_of(int np, int p) { return p < np / 2 ? 0 : 1; }

// (cs, sn) of the rotation with tangent t = sign(tau) / (|tau| + sqrt(1 +
// tau^2)), sign(0) = +1, t = 0 where it is not finite; the identity when
// `rotate` is false.  sqrt and the divisions are correctly rounded.
__device__ __forceinline__ void rotation(bool rotate, double tau, double& cs, double& sn) {
  double t = __ddiv_rn(tau >= 0.0 ? 1.0 : -1.0, fabs(tau) + __dsqrt_rn(1.0 + tau * tau));
  if (!isfinite(t)) t = 0.0;
  const double c = __ddiv_rn(1.0, __dsqrt_rn(1.0 + t * t));
  cs = rotate ? c : 1.0;
  sn = rotate ? c * t : 0.0;
}

// The larger of a and b, NaN if either is NaN (fmax drops a NaN).
__device__ __forceinline__ double max_nan(double a, double b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max_nan(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Clock stamps of one thread (the *_stamps entries): lap(k) adds the
// cycles since the previous lap to part k, count(k) adds to entry k, by
// atomics whose result nobody waits for.
struct Stamps {
  unsigned long long* out;
  long long last;
  __device__ Stamps(long long* p, bool on)
      : out(on ? reinterpret_cast<unsigned long long*>(p) : nullptr), last(0) {
    if (out != nullptr) last = clock64();
  }
  __device__ __forceinline__ void lap(int k) {
    if (out == nullptr) return;
    const long long now = clock64();
    atomicAdd(out + k, (unsigned long long)(now - last));
    last = now;
  }
  __device__ __forceinline__ void count(int k, int v = 1) {
    if (out != nullptr) atomicAdd(out + k, (unsigned long long)v);
  }
};

// Makes the stamp that follows wait for x (a load's or a chain's result).
__device__ __forceinline__ void wait_for(double x) {
  if (__double_as_longlong(x) == 0x7ff4dead0000beefLL) asm volatile("" ::: "memory");
}

// D (16x8) += A (16x4) * B (4x8) on the f64 tensor cores (csrc/panel_cholesky.cu):
// lane (g, t) = (lane / 4, lane % 4) holds A[g][t], A[g + 8][t], B[t][g] and
// D[g][2t..2t+1], D[g + 8][2t..2t+1].
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// 1 / x and 1 / sqrt(x) for a positive normal x: the tensor-free
// approximations of the special function unit refined by two Newton steps
// each (to within an ulp or two: the correctly rounded divisions and roots
// of `rotation` cost a chain of five long sequences an inner step).
__device__ __forceinline__ double rcp_fast(double x) {
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  double e = fma(-x, y, 1.0);
  y = fma(y, e, y);
  e = fma(-x, y, 1.0);
  return fma(y, e, y);
}
__device__ __forceinline__ double rsqrt_fast(double x) {
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  double e = fma(-x * y, y, 1.0);
  y = fma(0.5 * y, e, y);
  e = fma(-x * y, y, 1.0);
  return fma(0.5 * y, e, y);
}

// The rotation of `rotation` for tau = d / e (e != 0), to within an ulp or
// two of its correctly rounded values: t = sign(tau) |e| / (|d| + sqrt(d^2 +
// e^2)), c = 1 / sqrt(1 + t^2), s = c t, where d and e are of a size whose
// squares neither overflow nor underflow (the block regimes' operands, which
// the pipelines scale to max |a| = 1); the correctly rounded rule elsewhere.
// With d = e = 0 it gives the identity; outside that range with `rotate`
// false, the identity too (the result is not used).
__device__ __forceinline__ void rotation_fast(bool rotate, double d, double e, double& cs,
                                              double& sn) {
  const double ad = fabs(d), ae = fabs(e), m = fmax(ad, ae);
  if (!(m > 1e-140 && m < 1e140)) {
    if (rotate)
      rotation(true, __ddiv_rn(d, e), cs, sn);
    else
      cs = 1.0, sn = 0.0;
    return;
  }
  const double r2 = fma(d, d, e * e);
  double t = ae * rcp_fast(ad + r2 * rsqrt_fast(r2));
  if (d != 0.0 && (d < 0.0) != (e < 0.0)) t = -t;  // tau < 0
  const double c = rsqrt_fast(fma(t, t, 1.0));
  cs = c;
  sn = c * t;
}

// The block regimes' threshold test: |b_ij| > tol max(sqrt(|a_ii a_jj|),
// s0), the root as x / sqrt(x) to an ulp or two (NaN at x = 0, which fmax
// replaces by s0, as it would 0).  J2: the tile of A, s0 its floor; J1: the
// Gram tile of the slot's columns, s0 J1's floor.
__device__ __forceinline__ bool pair_rotates(double aii, double ajj, double bij, double tol,
                                             double s0) {
  const double x = fabs(aii * ajj);
  return fabs(bij) > tol * fmax(x * rsqrt_fast(x), s0);
}

// Where inner_sweep adds its cycles and counts (Stamps indices).
struct InnerParts {
  int rotations, update, barriers, steps, rotating, quiet;
};

// The inner problem of a block regime's outer step: one cyclic sweep of the
// element rule (round robin of order 2 kB) on the symmetric 2 kB x 2 kB tile
// at scur (leading dimension 2 kB + 1; snxt the same size: an inner step
// writes the other copy), accumulating the rotations into U at u
// (leading dimension 2 kB + 4, U = I on entry); kB kB threads, one 2 x 2
// block of the tile and of U each.  kB threads compute a step's rotations
// (t from d = a_jj - a_ii and e = 2 b_ij with one root and one reciprocal,
// refined approximations, beside the threshold test) and post them in
// rcs (4 kB doubles: two parities); every thread then rotates its block:
// two CTA barriers an inner step, one in a step without a rotation (vote:
// two ints), and none in a sweep whose tile has no pair to rotate (all
// pairs are tested at once first).  U's columns are then scaled to unit
// length (a rotation with t^2 below half an ulp keeps c = 1 and lengthens
// its columns, and an index is rotated twice as often as in the element
// rule).  Empty and ragged indices are zeros, which never rotate.  Returns
// whether a pair rotated and whether one met a non-finite number, alike in
// every thread.
template <int kB>
__device__ __forceinline__ void inner_sweep(double* scur, double* snxt, double* umine,
                                            double* rcs, int* vote, double tol, double s0,
                                            Stamps& st, InnerParts parts, bool& rotated,
                                            bool& bad) {
  constexpr int kM = 2 * kB;      // order of a slot's tile
  constexpr int kH = kB;          // pairs of an inner step
  constexpr int kLdS = kM + 1;    // the tile's leading dimension
  constexpr int kLdU = kM + 4;    // U's: conflict-free tensor core fragments
  constexpr int kThreads = kB * kB;
  constexpr int kItems = kH * kH / kThreads;  // 2 x 2 blocks of a thread
  const int tid = threadIdx.x, nthreads = blockDim.x;
  rotated = false;
  bad = false;
  // the thread's pairs' indices at step 0, moved along with the steps
  // (an index x > 0 goes to x - 1, 1 to kM - 1)
  int idx[kItems][4];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int item = tid + it * kThreads, p = item / kH, q = item - p * kH;
    idx[it][0] = schedule_index(kM, 0, p);
    idx[it][1] = schedule_index(kM, 0, kM - 1 - p);
    idx[it][2] = schedule_index(kM, 0, q);
    idx[it][3] = schedule_index(kM, 0, kM - 1 - q);
  }
  int ri = schedule_index(kM, 0, tid), rj = schedule_index(kM, 0, kM - 1 - tid);
  // a quiet tile: every pair's test at once on the tile as it is; where
  // none would rotate, no step changes the tile, so the sweep is that
  // test (its non-finite numbers included) and is skipped
  bool any = false;
  for (int e = tid; e < kM * kM; e += nthreads) {
    const int i = e / kM, j = e - i * kM;
    if (i >= j) continue;
    const double aii = scur[i * kLdS + i], ajj = scur[j * kLdS + j];
    const double bij = 0.5 * (scur[i * kLdS + j] + scur[j * kLdS + i]);
    any |= pair_rotates(aii, ajj, bij, tol, s0);
    bad |= !isfinite(aii + ajj + bij);
  }
  if (!__syncthreads_or(any)) {
    bad = __syncthreads_or(bad);
    st.count(parts.quiet);
    st.lap(parts.rotations);
  } else {
    for (int k2 = 0; k2 < kM - 1; ++k2) {
      const int par = k2 & 1;
      double* rc = rcs + 2 * kB * par;
      double* rs = rc + kB;
      if (tid < kH) {
        double c = 1.0, s = 0.0;
        const double aii = scur[ri * kLdS + ri], ajj = scur[rj * kLdS + rj];
        const double bij = 0.5 * (scur[ri * kLdS + rj] + scur[rj * kLdS + ri]);
        // the rotation is computed alongside the test, whose result then
        // selects it: the two chains overlap
        const bool rotate = pair_rotates(aii, ajj, bij, tol, s0);
        rotation_fast(rotate, ajj - aii, 2.0 * bij, c, s);
        if (!rotate) c = 1.0, s = 0.0;
        rotated |= rotate;
        bad |= !isfinite(aii + ajj + bij);
        rc[tid] = c;
        rs[tid] = s;
        const unsigned vote_any = __any_sync((1u << kH) - 1u, rotate);
        if (tid == 0) vote[par] = vote_any ? 1 : 0;
        if (st.out != nullptr) {
          wait_for(c + s);
          st.lap(parts.rotations);
        }
      }
      ri = ri == 0 ? 0 : (ri == 1 ? kM - 1 : ri - 1);
      rj = rj == 0 ? 0 : (rj == 1 ? kM - 1 : rj - 1);
      __syncthreads();
      st.lap(parts.barriers);
      if (vote[par] != 0) {
        st.count(parts.rotating);
#pragma unroll
        for (int it = 0; it < kItems; ++it) {
          const int item = tid + it * kThreads;
          const int p = item / kH, q = item - p * kH;
          const int ip = idx[it][0], jp = idx[it][1], iq = idx[it][2], jq = idx[it][3];
          const double cp = rc[p], sp = rs[p], cq = rc[q], sq = rs[q];
          const double x = scur[ip * kLdS + iq], y = scur[ip * kLdS + jq];
          const double z = scur[jp * kLdS + iq], u = scur[jp * kLdS + jq];
          double* u0 = umine + ip * kLdU;
          double* u1 = umine + jp * kLdU;
          const double a0 = u0[iq], b0 = u0[jq], a1 = u1[iq], b1 = u1[jq];
          // the columns (iq, jq), then the rows (ip, jp): G_p^T S G_q
          const double ti = cq * x - sq * y, tj = sq * x + cq * y;
          const double ui = cq * z - sq * u, uj = sq * z + cq * u;
          snxt[ip * kLdS + iq] = cp * ti - sp * ui;
          snxt[jp * kLdS + iq] = sp * ti + cp * ui;
          snxt[ip * kLdS + jq] = cp * tj - sp * uj;
          snxt[jp * kLdS + jq] = sp * tj + cp * uj;
          // U <- U G_q on rows ip and jp
          u0[iq] = cq * a0 - sq * b0;
          u0[jq] = sq * a0 + cq * b0;
          u1[iq] = cq * a1 - sq * b1;
          u1[jq] = sq * a1 + cq * b1;
        }
        st.lap(parts.update);
        __syncthreads();
        st.lap(parts.barriers);
        double* tmp = scur;
        scur = snxt;
        snxt = tmp;
      }
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
#pragma unroll
        for (int z = 0; z < 4; ++z) {
          const int x = idx[it][z];
          idx[it][z] = x == 0 ? 0 : (x == 1 ? kM - 1 : x - 1);
        }
      }
    }
    rotated = __syncthreads_or(rotated);
    bad = __syncthreads_or(bad);
    st.count(parts.steps, kM - 1);
    st.lap(parts.barriers);
  }
  // unit columns of U: kM / 8 lanes a column, then a division
  if (rotated) {
    constexpr int kPer = 8;  // rows a thread sums
    double* norms = rcs;     // kM of them (the rotations are done with)
    for (int col = tid / (kM / kPer); col < kM; col += nthreads / (kM / kPer)) {
      const int r0 = (tid % (kM / kPer)) * kPer;
      double ss = 0.0;
#pragma unroll
      for (int r = 0; r < kPer; ++r)
        ss = fma(umine[(r0 + r) * kLdU + col], umine[(r0 + r) * kLdU + col], ss);
#pragma unroll
      for (int off = 1; off < kM / kPer; off <<= 1) ss += __shfl_xor_sync(kFull, ss, off);
      if (r0 == 0) norms[col] = __dsqrt_rn(ss);
    }
    __syncthreads();
    for (int e = tid; e < kM * kM; e += nthreads) {
      const int r = e / kM, col = e - r * kM;
      umine[r * kLdU + col] = __ddiv_rn(umine[r * kLdU + col], norms[col]);
    }
    __syncthreads();
  }
  st.lap(parts.update);
}

// Raises the kernel's dynamic shared memory limit (and, for a cluster
// above 8 CTAs, allows it) once per device.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, unsigned& done, bool nonportable) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxDynamicSmem);
  if (err != cudaSuccess) return err;
  if (nonportable) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  done |= bit;
  return cudaSuccess;
}

// A grid of (ctas, nbatch) CTAs in clusters of ctas along x.
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, int ctas, int nbatch, int threads, size_t smem,
                           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, nbatch);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace jacobi
}  // namespace ttipm
