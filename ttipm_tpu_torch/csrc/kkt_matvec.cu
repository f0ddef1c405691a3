// K2: projected KKT block product, one launch for a whole group of terms
//     out[l, row, m, L] = sum over the terms t of that row of
//         sum phi_l[l,s,r] A[s,m,n,S] phi_r[L,S,R] x[r,n,R]
//
// Replaces: ttipm_tpu/ops/kernels.py::kkt_block_matvec (Pallas kernel
// _kkt_matvec_kernel), the fused algebra's `apply` / `apply_T`
// (ttipm_tpu/solvers/fused_algebra.py:41-45), and the six applies, three
// adds and the stack that make one local_product, z_product or
// mixed_product there.
//
// Bound on the H100: a term at the solve's usual shape (bond ranks 8,
// physical 4, operator ranks 4) is 66 KFLOP on ~10 KB of operands, far
// under a microsecond at the card's f64 rate or its 3.35 TB/s; at bond
// rank 36 and operator rank 9 it is 10 MFLOP on a few hundred KB.  A call
// is bound by the latency of a launch and by the dependency chain of the
// three contraction stages, never by operations or bytes.
//
// Design, for that bound: fewer launches, no intermediate in device
// memory, no relayout of an operand.
//  * One kernel runs the three stages of a term,
//      t1[s,n,l,R] = sum_r     phi_l[l,s,r] x[r,n,R]
//      t2[l,m,S,R] = sum_(s,n) A[s,m,n,S]   t1[s,n,l,R]
//      y [l,m,L]   = sum_(S,R) t2[l,m,S,R]  phi_r[L,S,R],
//    with t1 and t2 in shared memory.  The staged form costs O(R^3 s)
//    operations where a sum per output element would cost O(R^4 s S).
//  * The index l is free through all three stages, so the grid's x
//    dimension cuts l into chunks and the CTAs neither reduce nor talk.
//    Where one value of l does not fit the 227 KB of shared memory, the
//    CTA also walks over tiles of R, which is free through stages 1 and 2,
//    and carries the stage-3 sum across its tiles itself.  The wrapper
//    chooses chunk and tile from the shapes; every shape is taken.
//  * The grid's y dimension is the output row.  A CTA runs the terms of
//    its row one after the other, adds them in shared memory and stores
//    straight into out[:, row].  The term table (pointers, dims, element
//    strides, row) is a kernel parameter passed by value: no device
//    allocation and no copy for it.
//  * Every operand is read through its element strides, so transposed and
//    flipped views cost no copy.
//  * A batch of B structurally identical products (the lockstep batched
//    solve, one product an instance) is the same launch: the table is one
//    instance's, each operand of a term has a batch stride besides, and the
//    grid's z dimension is the instance.  The chunk of l may be smaller for
//    a batch (the grid is fuller); neither it nor the staging changes an
//    instance's arithmetic, so an instance gets the bits of a launch of its
//    product alone.
//  * A dependent fma whose operand comes from device memory costs the load's
//    latency every step (measured on the card: 8 cycles a step from
//    registers, 22 from shared memory, 55-105 from L1, ~150 from L2), and
//    an operand element is used about once per CTA, so nothing is ever warm
//    in L1.  Where they fit beside t1 and t2, the CTA therefore first copies
//    its slices of phi_l, x, A and phi_r into shared memory (all threads,
//    coalesced along the operand's contiguous index) and runs the chains
//    from there; an operand that does not fit is read in place.
//  * Arithmetic: plain fma in the operands' type.  Each stage sums its
//    contracted index in ascending order in one fma chain from zero (stage
//    2: s outer, n inner; stage 3: S outer, R inner), and the terms of a
//    row are added in table order: while R is not tiled these are the bits
//    of three chained fma GEMMs followed by adds of the terms.
//
// Two instances, double and float (scalar.cuh), from one template.  The
// float instance is the one the TPU ran: the Pallas kernel accumulates in
// f32 for f32 operands (ttipm_tpu/ops/kernels.py:60-63).  It keeps every
// operand, t1, t2 and the sums in float, in the same order; its plan
// (k2_tiles) counts 4-byte elements, so a CTA holds twice as many values
// of l (or R) before it has to tile.
#include <cuda_runtime.h>

#include <cstring>

#include "scalar.cuh"

namespace {

constexpr int kMaxTerms = 12;
constexpr int kMaxThreads = 512;
constexpr int kTermWords = 26;  // 64-bit words of one packed term
constexpr int kBatchWords = 4;  // 64-bit words of one term's batch strides
constexpr int kMaxDynamicSmem = 232448;

template <typename T>
struct Term {
  const T* phil;
  const T* a;
  const T* phir;
  const T* x;
  int l, s, r, m, n, S, L, R, row;
  long long phl0, phl1, phl2, a0, a1, a2, a3, phr0, phr1, phr2, x0, x1, x2;
  long long bphl, ba, bphr, bx;  // element strides between the instances of a batch
};

template <typename T>
struct TermTable {
  int nterms;
  Term<T> t[kMaxTerms];
};

// The wrapper's launch plan: chunk of l and tile of R per CTA, threads and
// bytes of shared memory of a CTA, and the elements reserved for t1, t2 and
// for the staged slices of phi_l, x, A and phi_r (0: read in place).
constexpr int kPlanWords = 10;
struct Plan {
  int lc, rt, threads, smem_bytes, cap1, cap2, cap_phl, cap_x, cap_a, cap_phr;
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
kkt_product_kernel(const __grid_constant__ TermTable<T> tab, T* __restrict__ out, int l,
                   int m, int L, int nrows, const __grid_constant__ Plan plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int row = blockIdx.y;
  const long long bi = blockIdx.z;  // the instance
  const int lc = plan.lc, rt = plan.rt;
  const int l0 = blockIdx.x * lc;
  const int nl = min(lc, l - l0);
  const int nlm = nl * m;
  const int nout = nlm * L;
  // Output element o = (L, (l,m)) is owned by thread o % blockDim.x in every
  // stage 3 and in the store, so yrow and yterm need no barrier of their own.
  T* yrow = smem;
  T* yterm = yrow + lc * m * L;
  T* t1 = yterm + lc * m * L;
  T* t2 = t1 + plan.cap1;
  T* phl_s = t2 + plan.cap2;
  T* x_s = phl_s + plan.cap_phl;
  T* a_s = x_s + plan.cap_x;
  T* phr_s = a_s + plan.cap_a;
  const int Lp = L | 1;  // odd leading dimension of the staged phi_r

  for (int o = tid; o < nout; o += nthreads) yrow[o] = T(0);
  bool first = true;
  for (int ti = 0; ti < tab.nterms; ++ti) {
    const Term<T>& t = tab.t[ti];
    if (t.row != row) continue;
    for (int R0 = 0; R0 < t.R; R0 += rt) {
      const int nR = min(rt, t.R - R0);
      const bool last_tile = R0 + nR >= t.R;

      // Operands: staged into shared memory where the plan has room (then
      // contiguous in the order the stages walk them), else in place.
      const T* phl_p = t.phil + bi * t.bphl + l0 * t.phl0;
      long long phl0 = t.phl0, phl1 = t.phl1, phl2 = t.phl2;
      if (nl * t.s * t.r <= plan.cap_phl) {  // [li][s][r]
        for (int e = tid; e < nl * t.s * t.r; e += nthreads) {
          const int ri = e % t.r, q = e / t.r;
          phl_s[e] = phl_p[(q / t.s) * phl0 + (q % t.s) * phl1 + ri * phl2];
        }
        phl_p = phl_s, phl0 = t.s * t.r, phl1 = t.r, phl2 = 1;
      }
      const T* x_p = t.x + bi * t.bx + R0 * t.x2;
      long long x0 = t.x0, x1 = t.x1, x2 = t.x2;
      if (t.r * t.n * nR <= plan.cap_x) {  // [r][n][Ri]
        for (int e = tid; e < t.r * t.n * nR; e += nthreads) {
          const int Ri = e % nR, q = e / nR;
          x_s[e] = x_p[(q / t.n) * x0 + (q % t.n) * x1 + Ri * x2];
        }
        x_p = x_s, x0 = t.n * nR, x1 = nR, x2 = 1;
      }
      const T* a_p = t.a + bi * t.ba;
      long long a0 = t.a0, a1 = t.a1, a2 = t.a2, a3 = t.a3;
      if (t.s * t.m * t.n * t.S <= plan.cap_a) {  // [s][m][n][S]
        for (int e = tid; e < t.s * t.m * t.n * t.S; e += nthreads) {
          const int Si = e % t.S;
          int q = e / t.S;
          const int ni = q % t.n;
          q /= t.n;
          a_s[e] = a_p[(q / t.m) * a0 + (q % t.m) * a1 + ni * a2 + Si * a3];
        }
        a_p = a_s, a0 = t.m * t.n * t.S, a1 = t.n * t.S, a2 = t.S, a3 = 1;
      }
      const T* phr_p = t.phir + bi * t.bphr + R0 * t.phr2;
      long long phr0 = t.phr0, phr1 = t.phr1, phr2 = t.phr2;
      if (t.S * nR * Lp <= plan.cap_phr) {  // [S][Ri][L], L fastest and padded
        for (int e = tid; e < L * t.S * nR; e += nthreads) {
          const int Ri = e % nR, q = e / nR;
          const int Si = q % t.S, Li = q / t.S;
          phr_s[(Si * nR + Ri) * Lp + Li] = phr_p[Li * phr0 + Si * phr1 + Ri * phr2];
        }
        phr_p = phr_s, phr0 = 1, phr1 = nR * Lp, phr2 = Lp;
      }
      __syncthreads();

      // stage 1: t1[s,n,li,Ri] = sum_r phi_l[l0+li,s,r] x[r,n,R0+Ri]
      const int n1 = t.s * t.n * nl * nR;
      for (int e = tid; e < n1; e += nthreads) {
        const int Ri = e % nR;
        int q = e / nR;
        const int li = q % nl;
        q /= nl;
        const int ni = q % t.n;
        const int si = q / t.n;
        const T* p = phl_p + li * phl0 + si * phl1;
        const T* xx = x_p + ni * x1 + Ri * x2;
        T acc = T(0);
#pragma unroll 4
        for (int ri = 0; ri < t.r; ++ri) acc = ttipm::madd(p[ri * phl2], xx[ri * x0], acc);
        t1[e] = acc;
      }
      __syncthreads();

      // stage 2: t2[li,m,S,Ri] = sum_(s,n) A[s,m,n,S] t1[s,n,li,Ri]
      const int n2 = nl * t.m * t.S * nR;
      const int step1 = nl * nR;
      const int ld2 = (t.S * nR) | 1;  // odd: the rows stage 3 reads fall in distinct banks
      for (int e = tid; e < n2; e += nthreads) {
        const int Ri = e % nR;
        int q = e / nR;
        const int Si = q % t.S;
        q /= t.S;
        const int mi = q % t.m;
        const int li = q / t.m;
        const T* ap = a_p + mi * a1 + Si * a3;
        const T* tp = t1 + li * nR + Ri;
        T acc = T(0);
        for (int si = 0; si < t.s; ++si) {
#pragma unroll 4
          for (int ni = 0; ni < t.n; ++ni)
            acc = ttipm::madd(ap[si * a0 + ni * a2], tp[(si * t.n + ni) * step1], acc);
        }
        t2[(li * t.m + mi) * ld2 + Si * nR + Ri] = acc;
      }
      __syncthreads();

      // stage 3: y[li,m,L] (+)= sum_(S,Ri) t2[li,m,S,Ri] phi_r[L,S,R0+Ri]
      // (l,m) runs fastest over the lanes: a warp reads few distinct rows
      // of phi_r, each broadcast, instead of 32 rows a stride apart
      for (int o = tid; o < nout; o += nthreads) {
        const int lm = o % nlm;
        const int Li = o / nlm;
        const T* tp = t2 + lm * ld2;
        const T* pp = phr_p + Li * phr0;
        T acc = (R0 == 0) ? T(0) : yterm[o];
        for (int Si = 0; Si < t.S; ++Si) {
#pragma unroll 4
          for (int Ri = 0; Ri < nR; ++Ri)
            acc = ttipm::madd(tp[Si * nR + Ri], pp[Si * phr1 + Ri * phr2], acc);
        }
        if (!last_tile)
          yterm[o] = acc;
        else
          yrow[o] = first ? acc : yrow[o] + acc;
      }
      __syncthreads();  // the buffers are free for the next tile or term
    }
    first = false;
  }

  T* outb = out + bi * l * nrows * m * L;
  for (int o = tid; o < nout; o += nthreads) {
    const int lm = o % nlm;
    const int Li = o / nlm;
    outb[(((long long)(l0 + lm / m) * nrows + row) * m + lm % m) * L + Li] = yrow[o];
  }
}

__global__ void empty_kernel() {}

// `table` holds nterms packed terms of kTermWords 64-bit words each: the
// four operand addresses, l s r m n S L R, the element strides of phi_l
// (3), A (4), phi_r (3) and x (3), and the output row.  `bstrides` holds,
// for a batch of nbatch instances, kBatchWords words a term: the element
// strides between the instances of phi_l, A, phi_r and x (unread when
// nbatch is 1).  `plan` holds the kPlanWords 32-bit words of a Plan.
// `out` is the contiguous (nbatch, l, nrows, m, L) result, in the operands'
// type (double or float).
template <typename T>
int kkt_product(const long long* table, const long long* bstrides, int nterms, int nbatch,
                const int* plan_words, T* out, int l, int m, int L, int nrows, void* stream) {
  Plan plan;
  static_assert(sizeof(Plan) == kPlanWords * sizeof(int), "Plan is kPlanWords ints");
  memcpy(&plan, plan_words, sizeof(Plan));
  if (nterms < 0 || nterms > kMaxTerms || l <= 0 || m <= 0 || L <= 0 || nrows <= 0 ||
      nrows > 65535 || nbatch <= 0 || nbatch > 65535 || (nbatch > 1 && bstrides == nullptr) || plan.lc <= 0 || plan.rt <= 0 || plan.smem_bytes > kMaxDynamicSmem ||
      plan.threads <= 0 || plan.threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const long long elems = 2LL * plan.lc * m * L + plan.cap1 + plan.cap2 + plan.cap_phl +
                          plan.cap_x + plan.cap_a + plan.cap_phr;
  if (elems * (long long)sizeof(T) > plan.smem_bytes) return (int)cudaErrorInvalidValue;
  TermTable<T> tab;
  tab.nterms = nterms;
  for (int i = 0; i < nterms; ++i) {
    const long long* w = table + (long long)i * kTermWords;
    Term<T>& t = tab.t[i];
    t.phil = reinterpret_cast<const T*>(w[0]);
    t.a = reinterpret_cast<const T*>(w[1]);
    t.phir = reinterpret_cast<const T*>(w[2]);
    t.x = reinterpret_cast<const T*>(w[3]);
    t.l = (int)w[4], t.s = (int)w[5], t.r = (int)w[6], t.m = (int)w[7];
    t.n = (int)w[8], t.S = (int)w[9], t.L = (int)w[10], t.R = (int)w[11];
    t.phl0 = w[12], t.phl1 = w[13], t.phl2 = w[14];
    t.a0 = w[15], t.a1 = w[16], t.a2 = w[17], t.a3 = w[18];
    t.phr0 = w[19], t.phr1 = w[20], t.phr2 = w[21];
    t.x0 = w[22], t.x1 = w[23], t.x2 = w[24];
    t.row = (int)w[25];
    const long long* bw = nbatch > 1 ? bstrides + (long long)i * kBatchWords : nullptr;
    t.bphl = bw ? bw[0] : 0, t.ba = bw ? bw[1] : 0, t.bphr = bw ? bw[2] : 0;
    t.bx = bw ? bw[3] : 0;
    const int nR = t.R < plan.rt ? t.R : plan.rt;
    if (t.l != l || t.m != m || t.L != L || t.row < 0 || t.row >= nrows ||
        (long long)t.s * t.n * plan.lc * nR > plan.cap1 ||
        (long long)plan.lc * t.m * (((long long)t.S * nR) | 1) > plan.cap2)
      return (int)cudaErrorInvalidValue;
  }
  if (plan.smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kkt_product_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned)((l + plan.lc - 1) / plan.lc), (unsigned)nrows, (unsigned)nbatch);
  kkt_product_kernel<T><<<grid, plan.threads, plan.smem_bytes,
                          static_cast<cudaStream_t>(stream)>>>(tab, out, l, m, L, nrows, plan);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ttipm_kkt_product(const long long* table, const long long* bstrides, int nterms,
                                 int nbatch, const int* plan_words, double* out, int l, int m,
                                 int L, int nrows, void* stream) {
  return kkt_product<double>(table, bstrides, nterms, nbatch, plan_words, out, l, m, L, nrows,
                             stream);
}

extern "C" int ttipm_kkt_product_f32(const long long* table, const long long* bstrides,
                                     int nterms, int nbatch, const int* plan_words, float* out,
                                     int l, int m, int L, int nrows, void* stream) {
  return kkt_product<float>(table, bstrides, nterms, nbatch, plan_words, out, l, m, L, nrows,
                            stream);
}

// An empty kernel through the same path: the floor of a single call.
extern "C" int ttipm_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* ttipm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
