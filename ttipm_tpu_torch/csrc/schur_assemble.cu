// K1: Schur block assembly, one launch for a group of blocks
//     B_g[(l,m,L),(r,n,R)] = sum_{s,S} phi_l[l,s,r] A[s,m,n,S] phi_r[L,S,R]
//
// Replaces: ttipm_tpu/ops/kernels.py::schur_assemble (Pallas kernel
// _schur_kernel) together with the stage-1 einsum in front of it, the
// fused algebra's `proj` (ttipm_tpu/solvers/fused_algebra.py:47): four
// calls per local factor (ttipm_tpu/solvers/fused.py:110-117) and the
// eigen-window assemblies in pairs (ttipm_tpu/solvers/fused_eigen.py:44-53).
//
// Bound on the H100: B is (m l L) x (n r R).  At the solve's usual shape
// (bond ranks 8, physical 4, operator ranks 4) it is 256 x 256 f64 =
// 512 KB written once, 0.16 us at 3.35 TB/s: a call is bound by the
// latency of its launch.  At bond rank 32 and operator rank 9 it is
// 4096 x 4096 = 134 MB, 40 us at that rate, against 0.3 GFLOP for the
// S-contraction (under 10 us at the f64 rate): bound by writing B.
//
// Design.
//  * Stage 1 runs inside the kernel.  The CTA that owns a tile of rows
//    (l,m | r,n) builds its slice of W[l,m,r,n,S] = sum_s phi_l A in
//    shared memory (the s-contraction is small, and a W row serves all
//    L*R columns), then walks over 64-wide tiles of the columns (L | R),
//    contracting S against phi_r staged through shared memory, and stores
//    with the 6-D interleave (l,m,r,n),(L,R) -> (l,m,L),(r,n,R): B is
//    written once in its final layout, consecutive R contiguous.  Where W's
//    slice for all of S does not fit, S is cut into chunks and the slice
//    is rebuilt per column tile, so every shape is taken.
//  * phi_l, A and phi_r are read through their element strides: no
//    permuted copy in the wrapper.
//  * A group of blocks of equal output size is one launch, the block in
//    blockIdx.z; the table of blocks (pointers, dims, strides) is a kernel
//    parameter passed by value.  Small blocks take 16-row tiles so that a
//    group still spreads over the card.
//  * A batch of B structurally identical groups (the lockstep batched
//    solve, one group an instance) is the same launch: the table is one
//    instance's, each operand of a block has a batch stride besides, and
//    the z axis runs over (block, instance), the instance fastest, so the
//    output is the contiguous (nblocks, B, M, N).  An instance is computed
//    by the same code in the same order as a launch of its group alone.
//  * Arithmetic: plain fma in the operands' type, each contracted index
//    ascending in one chain from zero.
//
// Two instances, double and float (scalar.cuh), from one template.  The
// float instance replaces the TPU kernel where it actually ran: the Pallas
// kernel computes in f32 (ttipm_tpu/ops/kernels.py:127-137), at HIGHEST
// matmul precision.  It sums in float in the same order; its staging plan
// (k1_tiles) is sized in 4-byte elements, so twice as many fit.
#include <cuda_runtime.h>

#include "scalar.cuh"

namespace {

constexpr int kMaxBlocks = 8;
constexpr int kBlockWords = 21;  // 64-bit words of one packed block
constexpr int kBatchWords = 3;   // 64-bit words of one block's batch strides
constexpr int kThreads = 256;
constexpr int kTN = 64;  // columns (L | R) per tile
constexpr int kKS = 32;  // slice of S staged from phi_r per step
constexpr int kMaxDynamicSmem = 232448;

template <typename T>
struct Block {
  const T* phil;
  const T* a;
  const T* phir;
  int l, s, r, m, n, S, L, R;
  long long phl0, phl1, phl2, a0, a1, a2, a3, phr0, phr1, phr2;
  long long bphl, ba, bphr;  // element strides between the instances of a batch
};

template <typename T>
struct BlockTable {
  int nblocks, nbatch;
  Block<T> b[kMaxBlocks];
};

// P = rows of the tile / 16.  `sc` is the chunk of S whose W slice is
// resident (sc >= S: built once), ldw the odd leading dimension of Ws.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
schur_kernel(const __grid_constant__ BlockTable<T> tab, T* __restrict__ out,
             long long out_block_stride, int sc, int ldw) {
  constexpr int TM = 16 * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* Ws = smem;  // TM x ldw, then Ps: kKS x (kTN + 1)
  T(*Ps)[kTN + 1] = reinterpret_cast<T(*)[kTN + 1]>(smem + TM * ldw);

  const Block<T>& b = tab.b[blockIdx.z / tab.nbatch];
  const long long bi = blockIdx.z % tab.nbatch;  // the instance
  const T* phil = b.phil + bi * b.bphl;
  const T* amat = b.a + bi * b.ba;
  const T* phir = b.phir + bi * b.bphr;
  const long long Mw = (long long)b.l * b.m * b.r * b.n;
  const int Nw = b.L * b.R;
  const long long row0 = (long long)blockIdx.y * TM;
  if (row0 >= Mw) return;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long N = (long long)b.r * b.n * b.R;
  T* o = out + blockIdx.z * out_block_stride;

  // output offset of (row, column 0) for this thread's rows; -1 past the edge
  long long rowbase[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long gi = row0 + ty + 16 * p;
    if (gi >= Mw) {
      rowbase[p] = -1;
      continue;
    }
    const int ni = (int)(gi % b.n);
    long long q = gi / b.n;
    const int ri = (int)(q % b.r);
    q /= b.r;
    const int mi = (int)(q % b.m);
    const long long li = q / b.m;
    rowbase[p] = ((li * b.m + mi) * b.L) * N + ((long long)ri * b.n + ni) * b.R;
  }

  const bool resident = sc >= b.S;
  const int ncolt = (Nw + kTN - 1) / kTN;
  bool built = false;
  for (int ct = blockIdx.x; ct < ncolt; ct += gridDim.x) {
    T acc[P][4];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = T(0);

    for (int S0 = 0; S0 < b.S; S0 += sc) {
      const int nS = min(sc, b.S - S0);
      if (!(resident && built)) {
        __syncthreads();  // every thread is done with the previous slice
        // stage 1: Ws[row][Si] = sum_s phi_l[l,s,r] A[s,m,n,S0+Si]
        for (int e = tid; e < TM * nS; e += kThreads) {
          const int Si = e % nS;
          const int rr = e / nS;
          const long long gi = row0 + rr;
          T w = T(0);
          if (gi < Mw) {
            const int ni = (int)(gi % b.n);
            long long q = gi / b.n;
            const int ri = (int)(q % b.r);
            q /= b.r;
            const int mi = (int)(q % b.m);
            const long long li = q / b.m;
            const T* p = phil + li * b.phl0 + ri * b.phl2;
            const T* ap = amat + mi * b.a1 + ni * b.a2 + (S0 + Si) * b.a3;
#pragma unroll 4
            for (int si = 0; si < b.s; ++si) w = ttipm::madd(p[si * b.phl1], ap[si * b.a0], w);
          }
          Ws[rr * ldw + Si] = w;
        }
        built = true;
      }
      for (int k0 = 0; k0 < nS; k0 += kKS) {
        const int nk = min(kKS, nS - k0);
        __syncthreads();  // Ws is built; the previous slice of phi_r is consumed
        for (int e = tid; e < nk * kTN; e += kThreads) {
          const int kk = e / kTN, cc = e % kTN;
          const int gj = ct * kTN + cc;
          Ps[kk][cc] = gj < Nw ? phir[(gj / b.R) * b.phr0 + (S0 + k0 + kk) * b.phr1 +
                                        (gj % b.R) * b.phr2]
                               : T(0);
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < nk; ++kk) {
          T ar[P], br[4];
#pragma unroll
          for (int p = 0; p < P; ++p) ar[p] = Ws[(ty + 16 * p) * ldw + k0 + kk];
#pragma unroll
          for (int q = 0; q < 4; ++q) br[q] = Ps[kk][tx + 16 * q];
#pragma unroll
          for (int p = 0; p < P; ++p)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[p][q] = ttipm::madd(ar[p], br[q], acc[p][q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gj = ct * kTN + tx + 16 * q;
      if (gj >= Nw) continue;
      const long long coff = (long long)(gj / b.R) * N + gj % b.R;
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (rowbase[p] >= 0) o[rowbase[p] + coff] = acc[p][q];
    }
  }
}

template <typename T, int P>
cudaError_t launch(const BlockTable<T>& tab, T* out, long long stride, int sc, int ldw,
                   dim3 grid, int smem_bytes, cudaStream_t st) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        schur_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
    if (err != cudaSuccess) return err;
  }
  schur_kernel<T, P><<<grid, kThreads, smem_bytes, st>>>(tab, out, stride, sc, ldw);
  return cudaGetLastError();
}

// `table` holds nblocks packed blocks of kBlockWords 64-bit words each:
// the three operand addresses, l s r m n S L R, and the element strides of
// phi_l (3), A (4) and phi_r (3).  `bstrides` holds, for a batch of
// nbatch instances, kBatchWords words a block: the element strides between
// the instances of phi_l, A and phi_r (unread when nbatch is 1).  `out` is
// the contiguous (nblocks, nbatch, M, N) result, in the operands' type
// (double or float).  tm is the row tile (16, 32 or 64), sc the resident
// chunk of S, colsplit the number of CTAs that share the column tiles of a
// row tile.
template <typename T>
int schur_assemble(const long long* table, const long long* bstrides, int nblocks, int nbatch,
                   T* out, int tm, int sc, int colsplit, void* stream) {
  if (nblocks <= 0 || nblocks > kMaxBlocks || nbatch <= 0 || sc <= 0 || colsplit <= 0 ||
      (nbatch > 1 && bstrides == nullptr))
    return (int)cudaErrorInvalidValue;
  BlockTable<T> tab;
  tab.nblocks = nblocks;
  tab.nbatch = nbatch;
  long long rows = 0, M = 0, N = 0;
  for (int i = 0; i < nblocks; ++i) {
    const long long* w = table + (long long)i * kBlockWords;
    Block<T>& b = tab.b[i];
    b.phil = reinterpret_cast<const T*>(w[0]);
    b.a = reinterpret_cast<const T*>(w[1]);
    b.phir = reinterpret_cast<const T*>(w[2]);
    b.l = (int)w[3], b.s = (int)w[4], b.r = (int)w[5], b.m = (int)w[6];
    b.n = (int)w[7], b.S = (int)w[8], b.L = (int)w[9], b.R = (int)w[10];
    b.phl0 = w[11], b.phl1 = w[12], b.phl2 = w[13];
    b.a0 = w[14], b.a1 = w[15], b.a2 = w[16], b.a3 = w[17];
    b.phr0 = w[18], b.phr1 = w[19], b.phr2 = w[20];
    const long long* bw = nbatch > 1 ? bstrides + (long long)i * kBatchWords : nullptr;
    b.bphl = bw ? bw[0] : 0, b.ba = bw ? bw[1] : 0, b.bphr = bw ? bw[2] : 0;
    const long long Mi = (long long)b.l * b.m * b.L, Ni = (long long)b.r * b.n * b.R;
    if (Mi <= 0 || Ni <= 0 || b.s <= 0 || b.S <= 0) return (int)cudaErrorInvalidValue;
    if (i == 0) M = Mi, N = Ni;
    if (Mi != M || Ni != N) return (int)cudaErrorInvalidValue;
    const long long r = (long long)b.l * b.m * b.r * b.n;
    rows = r > rows ? r : rows;
  }
  const long long row_tiles = (rows + tm - 1) / tm;
  if (row_tiles > 65535 || colsplit > 65535 || (long long)nblocks * nbatch > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const int ldw = sc | 1;
  const long long smem = ((long long)tm * ldw + (long long)kKS * (kTN + 1)) * sizeof(T);
  if (smem > kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)colsplit, (unsigned)row_tiles, (unsigned)(nblocks * nbatch));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tm) {
    case 64: return (int)launch<T, 4>(tab, out, M * N, sc, ldw, grid, (int)smem, st);
    case 32: return (int)launch<T, 2>(tab, out, M * N, sc, ldw, grid, (int)smem, st);
    case 16: return (int)launch<T, 1>(tab, out, M * N, sc, ldw, grid, (int)smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ttipm_schur_assemble(const long long* table, const long long* bstrides,
                                    int nblocks, int nbatch, double* out, int tm, int sc,
                                    int colsplit, void* stream) {
  return schur_assemble<double>(table, bstrides, nblocks, nbatch, out, tm, sc, colsplit, stream);
}

extern "C" int ttipm_schur_assemble_f32(const long long* table, const long long* bstrides,
                                        int nblocks, int nbatch, float* out, int tm, int sc,
                                        int colsplit, void* stream) {
  return schur_assemble<float>(table, bstrides, nblocks, nbatch, out, tm, sc, colsplit, stream);
}
