// K3: reduced Householder QR of a tall panel (m >= n)
//
// Replaces: ttipm_tpu/ops/kernels.py::panel_qr (Pallas kernel
// _panel_qr_kernel, dispatcher qr_reduced), used by the fused sweeps'
// bond splits on the enrichment-augmented basis u_aug
// (ttipm_tpu/solvers/fused_algebra.py:284,370).  In the port its callers
// are bck_split_step (which takes Q transposed) and fwd_split_step of
// ttipm_tpu_torch/solvers/fused_algebra.py.
//
// Contract: a (m, n) f64 or f32 with any strides, n <= m <= 512, n <= 128
// (the envelope the reference documents).  q receives Q with orthonormal
// columns, as the contiguous (m, n) array or, with q_trans, as the
// contiguous (n, m) array Q^T; r the (n, n) upper triangle with exact
// zeros below the diagonal; Q R = a.  The reflectors follow LAPACK's
// dlarfg: beta = -sign(x_j) ||x||, and tau = 0 with the column left as it
// is when the part below the diagonal is exactly zero, so R carries
// LAPACK's signs.  sqrt and the divisions are correctly rounded.  A NaN in
// a comes out as NaNs; no loop depends on the data.
//
// Two instances, double and float (scalar.cuh), from one template.  The
// float one is the TPU's production kernel's counterpart (the Pallas
// dispatcher takes f32 only, ttipm_tpu/ops/kernels.py:226): it keeps the
// panel, the partial sums and the reflector scalars in float.
//
// The norm.  Both instances form ||x||^2 as a plain sum of squares, which
// is what every panel of the solve takes (orthonormal columns in [-1, 1]
// and an enrichment block of unit scale), and check it: where the sum lies
// below the smallest normal number for a column with rows below the
// diagonal (squares underflowed: in float, entries below ~1e-19), or where
// x_j^2 plus the sum is not finite (squares overflowed: in float, entries
// above ~1e19; or a NaN), the column's largest magnitude s is taken (one
// more reduction) and the norm is s ||x / s||, as dlarfg's dnrm2 scales it.
// The check reads numbers every warp (every CTA of a cluster) holds alike,
// so all take the same branch; panels that pass it keep their bits.  tau =
// 0 exactly when the column is exactly zero below the diagonal, as LAPACK
// decides.  Left as it is: a column whose norm lies below 1 / max_finite
// (its 1 / (x_j - beta) overflows; dlarfg rescales such columns).  The JAX
// kernel's 1e-30 guard on v^T v is not needed: v^T v = 2 beta (beta - x_j)
// is zero only with the norm.
//
// Bound on the H100: the solve's panels are (4 R', R + kick), 24 x 6 to
// 40 x 10 at bond rank 8 and at most 144 x 36 at rank 32: a few KB and
// under 1 MFLOP, a fraction of a microsecond of one SM by bytes or by
// operations.  What bounds the kernel is the chain of the method: n
// reflectors, each a reduction over the rows, a square root and a division,
// and an update that the next reflector waits for; then n more steps that
// form Q.  The design shortens every link of that chain and keeps
// everything else off it.
//
// Design.  The panel sits in shared memory, column-major with an odd
// leading dimension (the row-major load and store are then free of bank
// conflicts), and column c belongs to warp c mod W for the whole kernel,
// W = min(n, 16) warps (32 in a cluster), chosen in Python (k3_plan).
// Lanes hold rows: a CTA has at most 192 of them, so a lane keeps its 1, 2,
// 4 or 6 rows of the reflector and of the column it works on in registers
// (the kernel is compiled for each), a column costs one load and one store
// a step, and the row loops have no branches.
//
// Forward step j.  Column j is final when the step starts and is only read
// in it: a warp reads it once and forms, in one pair of interleaved
// shuffle reductions, the squared norm below the diagonal and the dot
// product with its first own column.  Every warp then computes beta, tau
// and scale = 1 / (x_j - beta) itself from the same numbers in the same
// order, so all hold the same bits and no warp waits for another's
// scalars.  The reflector is never written: v_i = scale x_i is formed
// where it is used (rounded once, as dlarfg leaves it), and the dot
// products take x, since w_c = tau (a_jc + scale sum_i x_i a_ic).  (The
// update as a_ic - x_i (scale w_c) and Q's dot products on scale x_i are as
// accurate, but MaxCut d8 seed 24 then takes 10 iterations instead of 8,
// as it does with cuSOLVER's QR in this kernel's place: the path turns on
// the last bits.)  Each
// warp updates its own columns, the owner of column j + 1 that column
// first, and one __syncthreads ends the step: one barrier and one
// reduction deep per column, where the first form of this kernel spent
// six block barriers, two reductions in sequence and a section of one
// thread.  R's diagonal (beta), tau and scale go to three small arrays.
//
// Q is formed in place over the reflectors as LAPACK's dorg2r does it, so
// there is no second m x n buffer: R is stored first, then for j = n - 2
// down to 0 every warp applies H_j to its own columns c > j (which already
// hold columns of Q), and the owner of column j + 1 first turns that
// column into H_{j+1} e_{j+1} in its registers: the other warps read it as
// a reflector during step j + 1 and are past that step's barrier.  Again
// one barrier a step, no reflector to wait for.  The other way,
// Q = I - V (T V_1^T) with the compact WY factor T, trades this chain for a
// Gram matrix V^T V (n^2 / 2 reductions) and a triangular recurrence of the
// same depth: not taken.
//
// Measured on an H100 (clock stamps, cycles): a forward step takes ~1040 at
// 24 x 6 and ~1180 at 40 x 10, of which the reduction is ~230 and the
// scalars ~380; a Q step 860-910.  With the rows read from shared memory in
// loops (this kernel's first form) the steps took 1270-1700 and 1550-1800,
// and at 128 x 34 the five passes over the trailing panel a step, not the
// chain, set the time (3160 cycles a step against 2130 now).
//
// Panels of more than 192 rows go to a cluster of 2 or 4 CTAs, each with a
// slab of at most 192 rows, launched together so that all are resident.
// The step is the same; the per-column partial sums (norm and dot
// products, one vector of n - j numbers a CTA) and row j of the trailing
// panel are exchanged once a step through a workspace in device memory:
// plain stores, a barrier, a release store of the CTA's step counter,
// acquire loads of the others' (through L2; distributed shared memory
// measured slower for this pattern in K4).  Every CTA adds the partials in
// CTA order and computes the same scalars.  Two slots alternate, so a CTA a
// step ahead never overwrites what another still reads.  This regime is
// off the solve's path: 2 n exchanges of ~3K cycles each.  A column whose
// norm is scaled (above) makes one more: each CTA's largest magnitude and
// its sum of squares scaled by it, combined in CTA order (dlassq's rule).
//
// A batch of B panels of one shape (the lockstep batched solve, one panel
// an instance, a batch stride apart) is one launch: the grid's y dimension
// is the instance, one CTA or one cluster each, with its own slice of the
// workspace.  An instance runs the code of a single launch, so it gets its
// bits.
//
// The launch plan (CTAs, threads, workspace, shared memory) is chosen in
// Python (ops/kernels.py::k3_plan) and checked here against the same
// constants.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "scalar.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxM = 512;
constexpr int kMaxN = 128;
constexpr int kMaxCtas = 4;
constexpr int kMaxThreads = 1024;        // of a CTA in a cluster
constexpr int kMaxThreadsOneCta = 512;   // of the one CTA: 128 registers a thread
constexpr int kMaxDynamicSmem = 232448;
constexpr int kScalarRows = 3;  // tau, scale, beta: n elements each after the panel
constexpr int kStamps = 6;      // phase stamps of ttipm_panel_qr_stamps
constexpr int kMaxSlabRows = 192;  // rows of a CTA: at most 6 a lane, held in registers

// Elements of an instance's workspace in a cluster: two slots of ctas + 1
// vectors of n (the partials and row j), the pairs of the scaled norm,
// and ctas step counters (an int each, in an element's room).
__host__ __device__ __forceinline__ long long ws_elems(int ctas, int n) {
  return 2LL * (ctas + 1) * n + 2LL * ctas + ctas;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Two sums at once: the shuffles of one hide the latency of the other.
template <typename T>
__device__ __forceinline__ void warp_sum2(T& u, T& v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T a = __shfl_xor_sync(kFull, u, off), b = __shfl_xor_sync(kFull, v, off);
    u += a;
    v += b;
  }
}

// The larger of a and b, NaN where either is.
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (b > a || b != b) ? b : a;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = nan_max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <typename T>
struct Reflector {
  T tau, scale, beta;
};

// dlarfg from the pivot x_j and the squared norm of the column below it.
template <typename T>
__device__ __forceinline__ Reflector<T> make_reflector(T xj, T sigma2) {
  Reflector<T> h;
  if (sigma2 == T(0)) {
    h.tau = T(0);
    h.scale = T(0);
    h.beta = xj;
  } else {
    h.beta = -ttipm::copysign_(ttipm::sqrt_rn(xj * xj + sigma2), xj);
    h.tau = (h.beta - xj) / h.beta;
    h.scale = T(1) / (xj - h.beta);
  }
  return h;
}

// Whether the plain sum of squares sigma2 of the column below the pivot x_j
// cannot give the norm: it underflowed (below the smallest normal, with
// rows below the diagonal) or x_j^2 + sigma2 overflowed (or is NaN).
template <typename T>
__device__ __forceinline__ bool needs_scaled_norm(T xj, T sigma2, int j, int m) {
  return (sigma2 < ttipm::min_normal(xj) && j < m - 1) ||
         !(xj * xj + sigma2 <= ttipm::max_finite(xj));
}

// dlarfg from the pivot and ss = sum_i (x_i / s)^2, s >= |x_j| the largest
// magnitude of the column.
template <typename T>
__device__ __forceinline__ Reflector<T> make_reflector_scaled(T xj, T ss, T s) {
  Reflector<T> h;
  if (ss == T(0)) {
    h.tau = T(0);
    h.scale = T(0);
    h.beta = xj;
  } else {
    const T q = ttipm::div_rn(xj, s);
    h.beta = -ttipm::copysign_(s * ttipm::sqrt_rn(ttipm::madd(q, q, ss)), xj);
    h.tau = (h.beta - xj) / h.beta;
    h.scale = T(1) / (xj - h.beta);
  }
  return h;
}

__device__ __forceinline__ void release_flag(int* flag, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(flag), "r"(v) : "memory");
}

__device__ __forceinline__ int acquire_flag(const int* flag) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(flag) : "memory");
  return v;
}

// After the CTA's stores to the workspace: raise this CTA's step counter,
// wait for every CTA's.  The CTAs of a cluster are resident together, so
// the wait ends; one that lasts seconds is a fault and stops the kernel.
__device__ __forceinline__ void exchange(int* flags, int ctas, int cta, int step) {
  __syncthreads();
  if (threadIdx.x == 0) release_flag(flags + cta, step);
  if (threadIdx.x < ctas) {
    long long spin = 0;
    while (acquire_flag(flags + threadIdx.x) < step) {
      if (++spin > (1LL << 24)) __trap();
      __nanosleep(20);
    }
  }
  __syncthreads();
}

// The sum over the CTAs, in CTA order, of entry c of their partials.
template <typename T>
__device__ __forceinline__ T sum_partials(const T* slot, int ctas, int n, int c) {
  T s = T(0);
  for (int k = 0; k < ctas; ++k) s += __ldcg(slot + k * n + c);
  return s;
}

// The CTA's rows r0 .. r0 + ml - 1 of a into the column-major A.
template <typename T>
__device__ __forceinline__ void load_panel(T* A, int ld, const T* __restrict__ a,
                                           long long s0, long long s1, int r0, int ml, int n) {
  const bool along_rows = s1 <= s0;  // lanes along the unit (or smaller) stride of a
  const int total = ml * n;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    int li, c;
    if (along_rows) {
      li = e / n;
      c = e - li * n;
    } else {
      c = e / ml;
      li = e - c * ml;
    }
    A[li + c * ld] = a[(r0 + li) * s0 + c * s1];
  }
}

// R from the columns' upper parts and beta; every CTA writes the rows it
// holds (and the diagonal and the zeros, which all hold alike).
template <typename T>
__device__ __forceinline__ void store_r(const T* A, int ld, const T* bet_s,
                                        T* __restrict__ r, int r0, int ml, int n) {
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, c = e - i * n;
    if (i >= c) {
      r[e] = i == c ? bet_s[c] : T(0);
    } else if (i >= r0 && i < r0 + ml) {
      r[e] = A[i - r0 + c * ld];
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_q(const T* A, int ld, T* __restrict__ q,
                                        int q_trans, int m, int r0, int ml, int n) {
  const int total = ml * n;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    if (q_trans) {
      const int c = e / ml, li = e - c * ml;
      q[(long long)c * m + r0 + li] = A[li + c * ld];
    } else {
      const int li = e / n, c = e - li * n;
      q[(long long)(r0 + li) * n + c] = A[li + c * ld];
    }
  }
}

// One value of column c turned into H_c e_c: zero above the diagonal,
// 1 - tau on it, -tau v below (f = -tau scale; the column holds x).
template <typename T>
__device__ __forceinline__ T turned(T x, int gi, int c, T tc, T f) {
  return gi < c ? T(0) : (gi == c ? T(1) - tc : (tc == T(0) ? T(0) : f * x));
}

// One warp turns its column c in place.
template <typename T>
__device__ __forceinline__ void turn_column(T* col, int c, int r0, int ml, T tc,
                                            T sc) {
  const T f = -tc * sc;
  for (int li = threadIdx.x & 31; li < ml; li += 32) col[li] = turned(col[li], r0 + li, c, tc, f);
  __syncwarp();
}

// ---------------------------------------------------------------------------
// One CTA (kMulti false), or a cluster of gridDim.x CTAs that hold mb rows
// each.  A CTA has at most 32 kRpl rows: a lane keeps its kRpl rows of the
// reflector and of the column it works on in registers, so a column costs
// one load and one store a step and the row loops have no branches.
// ---------------------------------------------------------------------------
template <typename T, int kRpl, bool kMulti>
__global__ void __launch_bounds__(kMulti ? kMaxThreads : kMaxThreadsOneCta, 1)
panel_qr_kernel(const T* __restrict__ a, long long s0, long long s1, long long sa,
                T* __restrict__ q, int q_trans, T* __restrict__ r, int m, int n, int mb, T* ws,
                long long* stamps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, W = blockDim.x >> 5;
  const int ctas = kMulti ? (int)gridDim.x : 1, cta = kMulti ? (int)blockIdx.x : 0;
  const long long bi = blockIdx.y;  // the instance: its panel, factors and workspace
  a += bi * sa;
  q += bi * m * n;
  r += bi * n * n;
  if (kMulti) ws += bi * ws_elems(ctas, n);
  const int ld = mb | 1;
  const int r0 = cta * mb;                  // first row of this CTA's slab
  const int ml = max(0, min(mb, m - r0));   // its rows
  T* A = smem;                         // ml x n, column-major, leading dimension ld
  T* tau_s = A + ld * n;
  T* scl_s = tau_s + n;
  T* bet_s = scl_s + n;
  T* pairs = kMulti ? ws + 2 * (ctas + 1) * n : nullptr;  // a CTA's largest magnitude, scaled ssq
  int* flags = kMulti ? reinterpret_cast<int*>(pairs + 2 * ctas) : nullptr;
  auto stamp = [&](int k) {
    if (stamps != nullptr && tid == 0 && cta == 0) stamps[k] = clock64();
  };
  // the absolute value, NaN kept
  auto mag = [](T x) { return x < T(0) ? -x : x; };
  // this lane's kRpl values of a column, zero past the slab
  auto load_rows = [&](const T* col, T (&v)[kRpl]) {
#pragma unroll
    for (int k = 0; k < kRpl; ++k) v[k] = lane + 32 * k < ml ? col[lane + 32 * k] : T(0);
  };
  auto dot_rows = [&](const T (&x)[kRpl], const T (&v)[kRpl]) {
    T p = T(0);
#pragma unroll
    for (int k = 0; k < kRpl; ++k) p = ttipm::madd(x[k], v[k], p);
    return p;
  };
  // the CTA that holds row j publishes it from column j on
  auto publish_row = [&](T* rowv, int j) {
    const int lj = j - r0;
    if (lj >= 0 && lj < ml)
      for (int c = j + tid; c < n; c += blockDim.x) rowv[c] = A[lj + c * ld];
  };
  stamp(0);
  if (kMulti && tid == 0) flags[cta] = 0;
  load_panel(A, ld, a, s0, s1, r0, ml, n);
  if (kMulti) cg::this_cluster().sync();
  else __syncthreads();
  stamp(1);

  // ---- forward: reflectors and R ----
  int sync = 0;  // exchanges made so far: the value of the step counters
  int cur = warp;  // the smallest own column >= j (own: c = warp mod W)
  for (int j = 0; j < n; ++j) {
    const bool owner = cur == j;
    if (owner) cur += W;
    const bool active = owner || cur < n;
    const int lj = j - r0;  // local index of row j (in the slab or not)
    const T* xcol = A + j * ld;
    T* slot = kMulti ? ws + (j & 1) * (ctas + 1) * n : nullptr;
    T* rowv = kMulti ? slot + ctas * n : nullptr;
    int c = cur;
    T* mine = A + min(c, n - 1) * ld;
    T x[kRpl], v[kRpl];  // column j below the diagonal; the working column
    T xj = T(0), ajc = T(0), sig = T(0), p = T(0);
    if (active) {
      load_rows(xcol, x);
#pragma unroll
      for (int k = 0; k < kRpl; ++k) x[k] = r0 + lane + 32 * k > j ? x[k] : T(0);
      if (!kMulti) {
        load_rows(mine, v);
        xj = xcol[j];
        ajc = mine[j];
        sig = dot_rows(x, x);
        p = dot_rows(x, v);
        warp_sum2(sig, p);
      } else {
        T* part = slot + cta * n;
        if (owner) {
          sig = warp_sum(dot_rows(x, x));
          if (lane == 0) part[j] = sig;
        }
        for (int cc = c; cc < n; cc += W) {
          load_rows(A + cc * ld, v);
          p = warp_sum(dot_rows(x, v));
          if (lane == 0) part[cc] = p;
        }
      }
    }
    if (kMulti) {
      publish_row(rowv, j);
      exchange(flags, ctas, cta, ++sync);
      xj = __ldcg(rowv + j);  // every warp: the scaling decision is the cluster's
      sig = sum_partials(slot, ctas, n, j);
      if (active) {
        load_rows(mine, v);
        ajc = __ldcg(rowv + min(c, n - 1));
        p = sum_partials(slot, ctas, n, min(c, n - 1));
      }
    }
    // the scaled norm where the sum of squares cannot give it: s, the
    // column's largest magnitude (x_j's included), and sum (x_i / s)^2
    const bool scaled = needs_scaled_norm(xj, sig, j, m);
    T s = T(0), ss = T(0);
    if (scaled && !kMulti && active) {
      T mx = T(0);
#pragma unroll
      for (int k = 0; k < kRpl; ++k) mx = nan_max(mx, mag(x[k]));
      s = nan_max(warp_max(mx), mag(xj));
      if (s != T(0)) {
#pragma unroll
        for (int k = 0; k < kRpl; ++k) {
          const T y = ttipm::div_rn(x[k], s);
          ss = ttipm::madd(y, y, ss);
        }
        ss = warp_sum(ss);
      }
    } else if (scaled && kMulti) {
      if (owner) {  // this CTA's rows: its largest magnitude and sum of squares scaled by it
        T mx = T(0), sq = T(0);
#pragma unroll
        for (int k = 0; k < kRpl; ++k) mx = nan_max(mx, mag(x[k]));
        mx = warp_max(mx);
        if (mx != T(0)) {
#pragma unroll
          for (int k = 0; k < kRpl; ++k) {
            const T y = ttipm::div_rn(x[k], mx);
            sq = ttipm::madd(y, y, sq);
          }
          sq = warp_sum(sq);
        }
        if (lane == 0) {
          pairs[2 * cta] = mx;
          pairs[2 * cta + 1] = sq;
        }
      }
      exchange(flags, ctas, cta, ++sync);
      if (active) {  // combined in CTA order
        s = mag(xj);
        for (int k = 0; k < ctas; ++k) s = nan_max(s, __ldcg(pairs + 2 * k));
        if (s != T(0)) {
          for (int k = 0; k < ctas; ++k) {
            const T mk = __ldcg(pairs + 2 * k);
            if (mk == T(0)) continue;
            const T rk = ttipm::div_rn(mk, s);
            ss = ttipm::madd(__ldcg(pairs + 2 * k + 1) * rk, rk, ss);
          }
        }
      }
    }
    if (active) {
      const Reflector<T> h = scaled ? make_reflector_scaled(xj, ss, s) : make_reflector(xj, sig);
      if (owner && lane == 0) {
        tau_s[j] = h.tau;
        scl_s[j] = h.scale;
        bet_s[j] = h.beta;
      }
      if (h.tau != T(0) && c < n) {
        T xs[kRpl];  // the reflector below the diagonal (zero on and above row j)
#pragma unroll
        for (int k = 0; k < kRpl; ++k) xs[k] = x[k] * h.scale;
        for (;;) {
          const T w = h.tau * (ajc + h.scale * p);
#pragma unroll
          for (int k = 0; k < kRpl; ++k) {
            const int li = lane + 32 * k;
            if (li < ml && li >= lj) mine[li] = li == lj ? v[k] - w : v[k] - xs[k] * w;
          }
          c += W;
          if (c >= n) break;
          mine = A + c * ld;
          load_rows(mine, v);
          if (kMulti) {
            ajc = __ldcg(rowv + c);
            p = sum_partials(slot, ctas, n, c);
          } else {
            ajc = mine[j];
            p = warp_sum(dot_rows(x, v));
          }
        }
      }
    }
    __syncthreads();
    stamp(kStamps + j);
  }
  stamp(2);
  store_r(A, ld, bet_s, r, r0, ml, n);
  __syncthreads();
  stamp(3);

  // ---- Q in place over the reflectors ----
  int cq = warp;  // the smallest own column > j
  while (cq < n) cq += W;
  int step = n;  // slot turns so far (the forward pass took n)
  for (int j = n - 2; j >= 0; --j) {
    if (cq - W > j) cq -= W;
    const bool active = cq < n;
    const T tj = tau_s[j], sj = scl_s[j];  // the same in every warp and CTA
    const int lj = j - r0;
    T* slot = nullptr;
    if (kMulti && tj != T(0)) {  // steps without a reflector make no exchange
      ++step;
      slot = ws + ((step - 1) & 1) * (ctas + 1) * n;
    }
    T x[kRpl], xs[kRpl], v[kRpl];  // column j below the diagonal, the reflector there
    if (active) {                       // (x scaled); the working column
      load_rows(A + j * ld, x);
#pragma unroll
      for (int k = 0; k < kRpl; ++k) {
        x[k] = r0 + lane + 32 * k > j ? x[k] : T(0);
        xs[k] = x[k] * sj;
      }
      for (int c = cq; c < n; c += W) {
        T* col = A + c * ld;
        const bool fresh = c == j + 1;  // still holds its reflector: turn it first
        if (!fresh && tj == T(0)) continue;
        load_rows(col, v);
        if (fresh) {
          const T tc = tau_s[c], f = -tc * scl_s[c];
#pragma unroll
          for (int k = 0; k < kRpl; ++k) {
            const int li = lane + 32 * k;
            v[k] = li < ml ? turned(v[k], r0 + li, c, tc, f) : T(0);
          }
        }
        // row j of the columns after j is still zero: w = tau v^T q_c has
        // no term from it
        T p = tj != T(0) ? warp_sum(dot_rows(x, v)) : T(0);
        if (kMulti) {
          if (tj != T(0) && lane == 0) slot[cta * n + c] = p;
          if (!fresh) continue;
        } else if (tj != T(0)) {
          const T w = tj * (sj * p);
#pragma unroll
          for (int k = 0; k < kRpl; ++k)
            v[k] = lane + 32 * k == lj ? -w : v[k] - xs[k] * w;
        }
#pragma unroll
        for (int k = 0; k < kRpl; ++k)
          if (lane + 32 * k < ml) col[lane + 32 * k] = v[k];
      }
    }
    if (kMulti && tj != T(0)) {
      exchange(flags, ctas, cta, ++sync);
      if (active) {
        for (int c = cq; c < n; c += W) {
          T* col = A + c * ld;
          load_rows(col, v);
          const T w = tj * (sj * sum_partials(slot, ctas, n, c));
#pragma unroll
          for (int k = 0; k < kRpl; ++k) {
            const int li = lane + 32 * k;
            if (li < ml && li >= lj) col[li] = li == lj ? -w : v[k] - xs[k] * w;
          }
        }
      }
    }
    __syncthreads();
    stamp(kStamps + n + j);
  }
  if (warp == 0) turn_column(A, 0, r0, ml, tau_s[0], scl_s[0]);
  __syncthreads();
  stamp(4);
  store_q(A, ld, q, q_trans, m, r0, ml, n);
  if (stamps != nullptr) {
    __syncthreads();
    stamp(5);
  }
}

template <typename T>
size_t smem_bytes(int mb, int n) {
  return ((size_t)(mb | 1) * n + (size_t)kScalarRows * n) * sizeof(T);
}

// One kernel for the slab height and the regime; the shared-memory limit
// is raised once per device.
template <typename T, int kRpl, bool kMulti>
cudaError_t launch_as(const T* a, long long s0, long long s1, long long sa, int nbatch, T* q,
                      int q_trans, T* r, int m, int n, int ctas, int threads, T* ws,
                      long long* stamps, cudaStream_t st) {
  static unsigned raised = 0;  // one bit per device
  auto kernel = panel_qr_kernel<T, kRpl, kMulti>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(raised & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxDynamicSmem);
    if (err != cudaSuccess) return err;
    raised |= bit;
  }
  int mb = (m + ctas - 1) / ctas;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, nbatch);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes<T>(mb, n);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kMulti ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, a, s0, s1, sa, q, q_trans, r, m, n, mb, ws, stamps);
}

template <typename T, bool kMulti>
cudaError_t launch_rows(int mb, const T* a, long long s0, long long s1, long long sa, int nbatch,
                        T* q, int q_trans, T* r, int m, int n, int ctas, int threads, T* ws,
                        long long* stamps, cudaStream_t st) {
  if (mb <= 32)
    return launch_as<T, 1, kMulti>(a, s0, s1, sa, nbatch, q, q_trans, r, m, n, ctas, threads, ws,
                                   stamps, st);
  if (mb <= 64)
    return launch_as<T, 2, kMulti>(a, s0, s1, sa, nbatch, q, q_trans, r, m, n, ctas, threads, ws,
                                   stamps, st);
  if (mb <= 128)
    return launch_as<T, 4, kMulti>(a, s0, s1, sa, nbatch, q, q_trans, r, m, n, ctas, threads, ws,
                                   stamps, st);
  return launch_as<T, kMaxSlabRows / 32, kMulti>(a, s0, s1, sa, nbatch, q, q_trans, r, m, n,
                                                 ctas, threads, ws, stamps, st);
}

template <typename T>
cudaError_t launch(const T* a, long long s0, long long s1, long long sa, int nbatch, T* q,
                   int q_trans, T* r, int m, int n, int ctas, int threads, T* ws,
                   long long* stamps, cudaStream_t st) {
  if (n < 1 || m < n || m > kMaxM || n > kMaxN || ctas < 1 || ctas > kMaxCtas || threads < 32 ||
      threads > (ctas > 1 ? kMaxThreads : kMaxThreadsOneCta) || threads % 32 != 0 ||
      (ctas > 1 && ws == nullptr) || nbatch < 1 || nbatch > 65535 ||
      (stamps != nullptr && nbatch != 1))
    return cudaErrorInvalidValue;
  const int mb = (m + ctas - 1) / ctas;
  if (mb > kMaxSlabRows || smem_bytes<T>(mb, n) > (size_t)kMaxDynamicSmem)
    return cudaErrorInvalidValue;
  if (ctas > 1)
    return launch_rows<T, true>(mb, a, s0, s1, sa, nbatch, q, q_trans, r, m, n, ctas, threads,
                                ws, stamps, st);
  return launch_rows<T, false>(mb, a, s0, s1, sa, nbatch, q, q_trans, r, m, n, 1, threads, ws,
                               stamps, st);
}

}  // namespace

// a: nbatch panels (m, n) with element strides s0, s1, the instances sa
// elements apart.  q: nbatch times m n elements, each (m, n) row-major or,
// with q_trans, (n, m) row-major.  r: nbatch times n n elements.  ctas,
// threads: the launch plan of k3_plan.  ws: nbatch times ws_elems(ctas, n)
// = 2 (ctas + 1) n + 3 ctas elements when ctas > 1 (uninitialised), else
// unused.  One entry for
// double, one for float.
extern "C" int ttipm_panel_qr(const double* a, long long s0, long long s1, long long sa,
                              int nbatch, double* q, int q_trans, double* r, int m, int n,
                              int ctas, int threads, double* ws, void* stream) {
  return (int)launch(a, s0, s1, sa, nbatch, q, q_trans, r, m, n, ctas, threads, ws, nullptr,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int ttipm_panel_qr_f32(const float* a, long long s0, long long s1, long long sa,
                                  int nbatch, float* q, int q_trans, float* r, int m, int n,
                                  int ctas, int threads, float* ws, void* stream) {
  return (int)launch(a, s0, s1, sa, nbatch, q, q_trans, r, m, n, ctas, threads, ws, nullptr,
                     static_cast<cudaStream_t>(stream));
}

// The same factorization of a contiguous f64 panel into a contiguous (m, n)
// q, with clock stamps of CTA 0's thread 0 (kStamps + 2 n of them): start,
// panel loaded, forward chain done, R stored, Q chain done, Q stored; then
// the end of every forward step and of every Q step.
extern "C" int ttipm_panel_qr_stamps(const double* a, double* q, double* r, int m, int n,
                                     int ctas, int threads, double* ws, long long* stamps,
                                     void* stream) {
  if (stamps == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch(a, n, 1, 0, 1, q, 0, r, m, n, ctas, threads, ws, stamps,
                     static_cast<cudaStream_t>(stream));
}
