// Matmul with column statistics for Hopper (sm_90a), plain C interface.
//
// Replaces tools/probe_matmul_stats.py::make_pallas (body `kernel`, the
// pl.pallas_call of the feasibility probe for ResNet-50's 1x1
// convolutions): for x [M, K] and w [K, N], both bf16 and contiguous,
//   acc = x . w           accumulated in f32,
//   y   = bf16(acc)       [M, N],
//   s   = sum_rows acc    [1, N] f32 (of acc, not of the rounded y),
//   s2  = sum_rows acc^2  [1, N] f32.
// Limits: M >= 1 (any M: the last row tile is masked, where the TPU kernel
// needed M % 512 == 0), K >= 16 and a multiple of 16, N a multiple of 8
// and 8 <= N <= 256.
//
// Bound: at the probe's four shapes (ResNet-50's 1x1 convolutions at
// batch 128) the work is 13.15 GFLOP, 13.3 us at the 989 TFLOP/s bf16
// tensor-core rate, against 65-257 MB of x, w, y and the sums, 19-77 us at
// 3.35 TB/s: bound by bytes, mostly the write of y. The products still run
// on the tensor cores (bf16 mma.sync m16n8k16, f32 accumulate): on the CUDA
// cores' 67 TFLOP/s f32 FMA they would take 196 us, longer than the bytes.
//
// Design for this card rather than the Pallas grid carried over. On the
// TPU the grid walks 512-row tiles in order on one core, holds all of w in
// VMEM and carries s and s2 in one resident output block from step to
// step. Here blocks run in parallel and in no order, so:
// - One block of 256 threads (8 warps) owns a tile of 64 rows and all N
//   columns (N <= 256), so it writes its y tile once and takes that tile's
//   statistics in the same epilogue. 64 rows give 392 blocks at the
//   smallest shape (25088 rows), some three per SM; 512 would give 49.
// - w does not fit in shared memory (1024 x 256 bf16 is 512 KB), so the
//   block walks K in chunks of 32: x [64, 32] and w [32, N] tiles are
//   staged by cp.async into two buffers, the next chunk loading while the
//   tensor cores work on this one. Rows past M, columns of w past N and
//   depths past K are zero-filled, so they add nothing to acc or the sums.
// - Warps 0-3 own 16 rows each of the left half of the columns, warps 4-7
//   of the right half. A fragments come from the row-major x tile as 32-bit
//   pairs, B fragments from the row-major w tile by ldmatrix.trans.
// - Epilogue: y is rounded to bf16 into shared memory and written with
//   16-byte stores. Column sums of acc and acc^2 are per-thread sums of the
//   lane's two rows, then xor-shuffles over lanes 4, 8 and 16 (the lanes
//   of one column pair), then a fixed-order sum over the 4 row warps in
//   shared memory; each block writes its 64-row partials to a [2, nb, N]
//   f32 scratch (nb = ceil(M / 64), allocated by the caller).
// - A second kernel sums the partials per column in a fixed order (each
//   thread a strided run of blocks, then a tree in shared memory). No
//   atomics, so s and s2 are the same bits on every run.
// One call of mx_matmul_stats runs both kernels and counts as one launch
// of K6. Not done yet: wgmma, TMA, a persistent grid that would carry the
// sums in registers across tiles and shrink the partials.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;        // rows of a block's tile
constexpr int kBK = 32;        // depth of a staged chunk
constexpr int kThreads = 256;  // 8 warps: 4 row warps x 2 column halves
constexpr int kRowWarps = 4;
constexpr int kRedCols = 8;    // columns of one reduce block
constexpr int kRedThreads = 1024;
constexpr int kRedGroups = kRedThreads / kRedCols;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Shared-memory layout of a block whose tile is NC columns wide. Rows are
// padded by 8 halves so the fragment loads and stores hit distinct banks.
template <int NC>
struct Tile {
  static constexpr int LDX = kBK + 8;  // halves per row of the x tile
  static constexpr int LDW = NC + 8;   // halves per row of the w tile
  static constexpr int LDY = NC + 8;   // halves per row of the y tile
  static constexpr int kXStage = kBM * LDX;
  static constexpr int kStage = kXStage + kBK * LDW;   // halves
  static constexpr int kLoadBytes = 2 * 2 * kStage;    // two stages
  static constexpr int kYBytes = 2 * kBM * LDY;
  static constexpr int kRedBytes = 2 * kRowWarps * NC * 4;
  static constexpr int kSmem = cmax(kLoadBytes, kYBytes + kRedBytes);
};

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Four 8x8 b16 matrices, transposed: lanes 8j..8j+7 give the row addresses
// of matrix j; lane l receives, in r[j], matrix j's elements (2(l%4), l/4)
// and (2(l%4) + 1, l/4): from a row-major [k][n] tile, the B fragment of
// mma.m16n8k16.col.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += A(16x16, row) * B(16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage the chunk at depth k0: x rows [m0, m0 + 64), w columns [0, NC).
template <int NC>
__device__ __forceinline__ void load_chunk(bf16* xs, bf16* ws,
                                           const bf16* x, const bf16* w,
                                           int m0, int k0, int M, int K,
                                           int N, int tid) {
  using T = Tile<NC>;
  constexpr int kXVec = kBK / 8;   // 16-byte vectors per x tile row
  constexpr int kWVec = NC / 8;
  for (int idx = tid; idx < kBM * kXVec; idx += kThreads) {
    const int r = idx / kXVec, c = (idx % kXVec) * 8;
    const bool ok = m0 + r < M && k0 + c < K;
    cp_async16(xs + r * T::LDX + c,
               ok ? x + (size_t)(m0 + r) * K + k0 + c : x, ok);
  }
  for (int idx = tid; idx < kBK * kWVec; idx += kThreads) {
    const int r = idx / kWVec, c = (idx % kWVec) * 8;
    const bool ok = k0 + r < K && c < N;
    cp_async16(ws + r * T::LDW + c,
               ok ? w + (size_t)(k0 + r) * N + c : w, ok);
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 2)
matmul_stats_tile(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  bf16* __restrict__ y, float* __restrict__ part, int M,
                  int K, int N, int nb) {
  using T = Tile<NC>;
  constexpr int kWarpCols = NC / 2;
  constexpr int NT = kWarpCols / 8;   // 8-column n-tiles of a warp
  __shared__ __align__(16) unsigned char smem[T::kSmem];
  bf16* stage0 = reinterpret_cast<bf16*>(smem);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp % kRowWarps, wc = warp / kRowWarps;
  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tg = lane & 3;   // fragment column pair
  const int m0 = blockIdx.x * kBM;
  const int nk = (K + kBK - 1) / kBK;

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  load_chunk<NC>(stage0, stage0 + T::kXStage, x, w, m0, 0, M, K, N, tid);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      bf16* nxt = stage0 + ((kt + 1) & 1) * T::kStage;
      load_chunk<NC>(nxt, nxt + T::kXStage, x, w, m0, (kt + 1) * kBK, M, K,
                     N, tid);
    }
    cp_async_commit();   // possibly empty: keeps one group in flight
    cp_async_wait<1>();  // chunk kt has landed (this thread's copies)
    __syncthreads();     // ... and every thread's
    const bf16* xs = stage0 + (kt & 1) * T::kStage;
    const bf16* ws = xs + T::kXStage;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[4];
      const bf16* xa = xs + (wr * 16 + g) * T::LDX + ks * 16 + tg * 2;
      a[0] = ld_pair(xa);
      a[1] = ld_pair(xa + 8 * T::LDX);
      a[2] = ld_pair(xa + 8);
      a[3] = ld_pair(xa + 8 * T::LDX + 8);
      // lane l addresses row l%8 of matrix l/8: matrices (k 0-7, n-tile
      // 2p), (k 8-15, 2p), (k 0-7, 2p+1), (k 8-15, 2p+1)
      const int j = lane >> 3;
      const bf16* wb = ws + (ks * 16 + (j & 1) * 8 + (lane & 7)) * T::LDW +
                       wc * kWarpCols + (j >> 1) * 8;
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, wb + p * 16);
        mma_bf16(acc[2 * p], a, b[0], b[1]);
        mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();   // every read of this stage is done before reuse
  }
  cp_async_wait<0>();

  // epilogue: the shared memory of the stages now holds the bf16 y tile
  // and the row warps' column sums
  bf16* ys = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(smem + T::kYBytes);  // [2][4][NC]
  const int r = wr * 16 + g;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int c = wc * kWarpCols + t * 8 + tg * 2;
    *reinterpret_cast<uint32_t*>(ys + r * T::LDY + c) =
        pack_bf16(acc[t][0], acc[t][1]);
    *reinterpret_cast<uint32_t*>(ys + (r + 8) * T::LDY + c) =
        pack_bf16(acc[t][2], acc[t][3]);
    float s0 = acc[t][0] + acc[t][2], s1 = acc[t][1] + acc[t][3];
    float q0 = acc[t][0] * acc[t][0] + acc[t][2] * acc[t][2];
    float q1 = acc[t][1] * acc[t][1] + acc[t][3] * acc[t][3];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      q0 += __shfl_xor_sync(0xffffffffu, q0, off);
      q1 += __shfl_xor_sync(0xffffffffu, q1, off);
    }
    if (g == 0) {
      red[wr * NC + c] = s0;
      red[wr * NC + c + 1] = s1;
      red[(kRowWarps + wr) * NC + c] = q0;
      red[(kRowWarps + wr) * NC + c + 1] = q1;
    }
  }
  __syncthreads();
  if (tid < N) {   // N <= NC <= kThreads
    const float* rs = red + tid;
    const float* rq = red + kRowWarps * NC + tid;
    part[(size_t)blockIdx.x * N + tid] =
        (rs[0] + rs[NC]) + (rs[2 * NC] + rs[3 * NC]);
    part[((size_t)nb + blockIdx.x) * N + tid] =
        (rq[0] + rq[NC]) + (rq[2 * NC] + rq[3 * NC]);
  }
  constexpr int kYVec = NC / 8;
  const int rows = M - m0 < kBM ? M - m0 : kBM;
  for (int idx = tid; idx < kBM * kYVec; idx += kThreads) {
    const int yr = idx / kYVec, c = (idx % kYVec) * 8;
    if (yr < rows && c < N)
      *reinterpret_cast<uint4*>(y + (size_t)(m0 + yr) * N + c) =
          *reinterpret_cast<const uint4*>(ys + yr * T::LDY + c);
  }
}

// s[c] and s2[c] from the [2, nb, N] partials: a block owns 8 columns;
// thread (group, column) sums blocks group, group + 128, ... in order,
// then the 128 groups fold in a fixed tree in shared memory.
__global__ void __launch_bounds__(kRedThreads)
matmul_stats_reduce(const float* __restrict__ part, float* __restrict__ s,
                    float* __restrict__ s2, int nb, int N) {
  __shared__ float sh[2][kRedGroups][kRedCols];
  const int c = threadIdx.x % kRedCols, grp = threadIdx.x / kRedCols;
  const int col = blockIdx.x * kRedCols + c;   // < N: N % 8 == 0
  float a = 0.f, b = 0.f;
  for (int i = grp; i < nb; i += kRedGroups) {
    a += part[(size_t)i * N + col];
    b += part[((size_t)nb + i) * N + col];
  }
  sh[0][grp][c] = a;
  sh[1][grp][c] = b;
  __syncthreads();
  for (int stride = kRedGroups / 2; stride > 0; stride >>= 1) {
    if (grp < stride) {
      sh[0][grp][c] += sh[0][grp + stride][c];
      sh[1][grp][c] += sh[1][grp + stride][c];
    }
    __syncthreads();
  }
  if (grp == 0) {
    s[col] = sh[0][0][c];
    s2[col] = sh[1][0][c];
  }
}

template <int NC>
cudaError_t launch_tiles(const void* x, const void* w, void* y, float* part,
                         int M, int K, int N, int nb, cudaStream_t st) {
  matmul_stats_tile<NC><<<nb, kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(y), part, M, K, N, nb);
  return cudaGetLastError();
}

}  // namespace

// x [M, K], w [K, N], y [M, N]: contiguous bf16 device buffers, 16-byte
// aligned; s, s2: N f32 each; partials: 2 * ceil(M / 64) * N f32 of
// scratch. Returns the cudaError_t of the two launches (0 on success).
extern "C" int mx_matmul_stats(const void* x, const void* w, void* y,
                               float* s, float* s2, float* partials, int M,
                               int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 16 || K % 16 != 0 || N < 8 || N % 8 != 0 || N > 256)
    return (int)cudaErrorInvalidValue;
  const int nb = (M + kBM - 1) / kBM;
  cudaError_t err;
  if (N <= 64)
    err = launch_tiles<64>(x, w, y, partials, M, K, N, nb, st);
  else if (N <= 128)
    err = launch_tiles<128>(x, w, y, partials, M, K, N, nb, st);
  else
    err = launch_tiles<256>(x, w, y, partials, M, K, N, nb, st);
  if (err != cudaSuccess) return (int)err;
  matmul_stats_reduce<<<N / kRedCols, kRedThreads, 0, st>>>(partials, s, s2,
                                                            nb, N);
  return (int)cudaGetLastError();
}
