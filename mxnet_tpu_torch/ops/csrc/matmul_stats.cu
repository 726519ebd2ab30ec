// Matmul with column statistics for Hopper (sm_90a), plain C interface.
//
// Replaces tools/probe_matmul_stats.py::make_pallas (body `kernel`, the
// pl.pallas_call of the feasibility probe for ResNet-50's 1x1
// convolutions): for x [M, K] and w [K, N], both bf16 and contiguous,
//   acc = x . w           accumulated in f32,
//   y   = bf16(acc)       [M, N],
//   s   = sum_rows acc    [1, N] f32 (of acc, not of the rounded y),
//   s2  = sum_rows acc^2  [1, N] f32.
// Limits: M >= 1 (any M: TMA zero-fills the rows past M and clips the
// store there, where the TPU kernel needed M % 512 == 0), K >= 16 and a
// multiple of 16, N a multiple of 8 and 8 <= N <= 256; x, w and y start
// 16-byte aligned.
//
// Bound: at the probe's four shapes (ResNet-50's 1x1 convolutions at
// batch 128) the bytes of x, w, y and the sums take 19-77 us at 3.35 TB/s,
// mostly the write of y (shapes A and B) or the read of x (C, D); the
// 2MKN operations take 3.3-13.3 us at the 989 TFLOP/s bf16 tensor-core
// rate. D ([25088, 1024] x [1024, 256]) sits near the balance: 13.3 us of
// operations against 19.3 us of bytes, so it needs the tensor cores' rate
// as well as the memory's.
//
// Design (Hopper's shape: persistent, warp-specialised, TMA and wgmma):
// - Persistent grid of 64-row tiles (all N columns): min(#SMs, tiles)
//   blocks; block b walks the row tiles b, b + grid, ... in order and
//   carries its column sums from tile to tile, so the sums are
//   deterministic without atomics. 64 rows never put more rows on the
//   busiest block than 128 do (D: 3 tiles of 64 against 2 of 128).
// - A producer warp, one thread of which keeps TMA loads in flight in a
//   ring of stages (8 at N <= 128, 4 at N > 128: the deepest that fits
//   beside the y staging tile): each holds a [64, 64] x chunk and the
//   matching [64, N] chunk of w (128-byte swizzle, 2-d maps, rows past M
//   and columns past K zero-filled). Every tile reads w again, from L2.
//   Full mbarriers carry the bytes' arrival, empty ones the consumers'
//   release (one arrival a warp).
// - Products: one consumer warpgroup runs wgmma.mma_async m64nNPk16
//   (NP = N rounded up to 64, 128 or 256; the extra columns are zero or
//   never loaded, and never stored): A = the x chunk (K-major), B = w
//   [K, N] as it lies, read MN-major through the descriptor's transpose
//   bit. A chunk's four k-steps are one commit group; the stage of the
//   previous chunk is released once only the newest group is in flight.
// - Epilogue, while the producer already loads the next tile: each
//   thread rounds its accumulators to bf16 into a 128-byte-swizzled
//   staging tile (conflict-free 4-byte stores) and one thread writes it
//   with TMA stores, clipped at M and N. The statistics come from the
//   f32 accumulators in place (each thread sums its two rows), then a
//   reduce-scatter butterfly over the 8 lanes that share a column (7/8
//   of a shuffle per value instead of 3), then a fixed-order sum over the
//   4 warps through shared memory into the block's running [2, N]
//   partial, held in registers by the threads that own it.
// - Each block writes its partial once, to row 1 + block of a
//   [2, 1 + grid, N] f32 buffer (grid <= 132 blocks: 270 KB at N = 256,
//   where one block a tile wrote 12.8 MB); a second kernel sums the
//   partials per column in a fixed order into row 0: s, and s2.
// Measured and left out (PERF.md, section 6): 128-row tiles on two consumer
// warpgroups, pairs of blocks in a cluster that multicast w's streamed
// chunks (slower at every grid size), a second y staging buffer, and w
// held in shared memory for a block's whole walk where it fits (no
// faster than streaming it at A, B and C).
// One call of mx_matmul_stats runs both kernels and counts as one launch
// of K6.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kSmemMax = 232448;   // a block's dynamic shared memory
constexpr int kBM = 64;            // rows of a tile
constexpr int kMaxStages = 8;
constexpr int kConsumers = 128;    // one consumer warpgroup
constexpr int kThreads = kConsumers + 32;   // and a producer warp
constexpr int kRedCols = 8;        // columns of one reduce block
constexpr int kRedThreads = 1024;
constexpr int kRedGroups = kRedThreads / kRedCols;

// Byte offsets of the NP instance's shared memory from its 1024-aligned
// base: the y staging tile, the ring (an x chunk, then w's chunk, a
// stage), the warps' column sums, the barriers; `kTotal` includes the
// alignment slack. Every tile slab starts 1024-aligned (128-byte
// swizzle). The ring is the deepest, up to kMaxStages, that fits.
template <int NP>
struct Layout {
  static constexpr int kStageBytes = kBM * 128 + 64 * NP * 2;
  static constexpr int kFixed = kBM * NP * 2 + 4 * 2 * NP * 4 + 1024;
  static constexpr int kStages =
      (kSmemMax - kFixed) / (kStageBytes + 16) < kMaxStages
          ? (kSmemMax - kFixed) / (kStageBytes + 16)
          : kMaxStages;
  static constexpr int kYs = 0;
  static constexpr int kRing = kYs + kBM * NP * 2;
  static constexpr int kRed = kRing + kStages * kStageBytes;
  static constexpr int kBars = kRed + 4 * 2 * NP * 4;
  static constexpr int kTotal = kBars + 8 * 2 * kStages + 1024;
  static_assert(kStages >= 2 && kTotal <= kSmemMax, "the ring must fit");
};

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// One level of the reduce-scatter over lanes `mask` apart: of v[0, 2h)
// this lane keeps the half its lane bit names and adds the partner's
// copy of it; the kept half lands in v[0, h).
template <int H, int MASK>
__device__ __forceinline__ void scatter_level(float* v, int lane) {
  const bool upper = (lane & MASK) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, MASK);
  }
}

template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
matmul_stats_tile(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_w,
                  const __grid_constant__ CUtensorMap tm_y,
                  float* __restrict__ stats, int M, int K, int N) {
  using L = Layout<NP>;
  constexpr int stages = L::kStages;
  constexpr int kV = NP / 2;   // accumulators a thread
  // (stat, column) slots of the block's partial a consumer thread owns
  constexpr int kSlots = (2 * NP + kConsumers - 1) / kConsumers;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const int nk = (K + 63) / 64;
  const uint32_t ys = base + L::kYs, ring = base + L::kRing;
  const uint32_t bars = base + L::kBars;
  float* red = reinterpret_cast<float*>(gbase + L::kRed);   // [4][2][NP]
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (stages + s); };
  const int tiles = (M + kBM - 1) / kBM;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);   // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer: one thread issues every load
    if (tid == kConsumers) {
      // w's slabs that hold a column below N; the others stay unloaded:
      // they only reach accumulator columns that are never stored
      const int wslabs = (N + 63) / 64;
      const uint32_t stage_tx = kBM * 128 + wslabs * 8192;
      int s = 0;
      uint32_t phase = 0;
      bool wrapped = false;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        for (int kc = 0; kc < nk; ++kc) {
          if (wrapped) mbar_wait(empty(s), phase ^ 1u);
          const uint32_t st = ring + s * L::kStageBytes;
          mbar_expect_tx(full(s), stage_tx);
          tma_load_2d(st, &tm_x, full(s), kc * 64, t * kBM);
          for (int c = 0; c < wslabs; ++c)
            tma_load_2d(st + kBM * 128 + c * 64 * 128, &tm_w, full(s),
                        c * 64, kc * 64);
          if (++s == stages) {
            s = 0;
            phase ^= 1u;
            wrapped = true;
          }
        }
      }
    }
    return;
  }

  // the consumer warpgroup
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int row0 = warp * 16 + g;   // and row0 + 8
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  };

  // m64nNP f32 accumulator: element 4n + 2i + j is (row0 + 8i, 8n + 2tg + j)
  float acc[kV];
  float psum[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) psum[i] = 0.f;

  int s = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int prev = 0;
    fence_regs<kV>(acc);
    for (int kc = 0; kc < nk; ++kc) {
      mbar_wait(full(s), phase);
      const uint32_t xs = ring + s * L::kStageBytes, wb = xs + kBM * 128;
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < 4; ++kd)
        wgmma_ss_tb<NP>(acc, smem_desc(xs + kd * 32, 16, 1024),
                        smem_desc(wb + kd * 16 * 128, 64 * 128, 1024),
                        kc > 0 || kd > 0);
      wgmma_commit();
      if (kc > 0) {
        wgmma_wait<1>();   // the previous chunk's products are done
        release(prev);
      }
      prev = s;
      if (++s == stages) {
        s = 0;
        phase ^= 1u;
      }
    }
    wgmma_wait<0>();
    fence_regs<kV>(acc);
    release(prev);

    // the staging tile is free once the last tile's store has read it;
    // the warps' column sums of the last tile have been read
    if (tid == 0) bulk_wait_read<0>();
    named_sync(1, kConsumers);

    // y: bf16 pairs into the swizzled staging tile, slab n / 8, 16-byte
    // chunk (n % 8) ^ (row % 8) of the row (row % 8 == g)
#pragma unroll
    for (int n = 0; n < NP / 8; ++n) {
      const uint32_t a = ys + (n / 8) * kBM * 128 + row0 * 128 +
                         (((n % 8) ^ g) * 16) + tg * 4;
      st_shared_u32(a, pack_bf16(acc[4 * n], acc[4 * n + 1]));
      st_shared_u32(a + 8 * 128, pack_bf16(acc[4 * n + 2], acc[4 * n + 3]));
    }
    fence_async_smem();

    // statistics in place: v[4n + j] = sum, v[4n + 2 + j] = sum of
    // squares of column 8n + 2tg + j over this lane's two rows
#pragma unroll
    for (int n = 0; n < NP / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float a = acc[4 * n + j], b = acc[4 * n + 2 + j];
        acc[4 * n + j] = a + b;
        acc[4 * n + 2 + j] = a * a + b * b;
      }
    // over the 8 lanes of a column (lane bits 4, 3, 2): this lane ends
    // with v[0, kV / 8) = values hi * kV/2 + mid * kV/4 + lo * kV/8 + r
    scatter_level<kV / 2, 16>(acc, lane);
    scatter_level<kV / 4, 8>(acc, lane);
    scatter_level<kV / 8, 4>(acc, lane);
    const int i0 = ((lane >> 4) & 1) * (kV / 2) + ((lane >> 3) & 1) * (kV / 4) +
                   ((lane >> 2) & 1) * (kV / 8);
#pragma unroll
    for (int r = 0; r < kV / 8; ++r) {
      const int i = i0 + r;
      const int stat = (i >> 1) & 1, col = 8 * (i >> 2) + 2 * tg + (i & 1);
      red[(warp * 2 + stat) * NP + col] = acc[r];
    }
    named_sync(1, kConsumers);

    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < NP / 64; ++c)
        if (c * 64 < N)
          tma_store_2d(&tm_y, ys + c * kBM * 128, c * 64, t * kBM);
      bulk_commit();
    }
    // the block's partial, in tile order, each slot over the warps in order
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int p = tid + i * kConsumers;
      if (p < 2 * NP) {
        const float* r = red + (p / NP) * NP + p % NP;
        psum[i] += (r[0] + r[2 * NP]) + (r[4 * NP] + r[6 * NP]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int p = tid + i * kConsumers;
    const int stat = p / NP, col = p % NP;
    if (p < 2 * NP && col < N)
      stats[((size_t)stat * (gridDim.x + 1) + 1 + blockIdx.x) * N + col] =
          psum[i];
  }
  if (tid == 0) bulk_wait_all();
}

// s[c] and s2[c] (rows 0 of the [2, 1 + nb, N] buffer) from the nb
// blocks' partials (rows 1 ..): a block owns 8 columns; thread (group,
// column) sums blocks group, group + 128, ... in order, then the 128
// groups fold in a fixed tree in shared memory.
__global__ void __launch_bounds__(kRedThreads)
matmul_stats_reduce(float* __restrict__ stats, int nb, int N) {
  __shared__ float sh[2][kRedGroups][kRedCols];
  const int c = threadIdx.x % kRedCols, grp = threadIdx.x / kRedCols;
  const int col = blockIdx.x * kRedCols + c;   // < N: N % 8 == 0
  float* s = stats;
  float* s2 = stats + (size_t)(nb + 1) * N;
  float a = 0.f, b = 0.f;
  for (int i = grp; i < nb; i += kRedGroups) {
    a += s[(size_t)(1 + i) * N + col];
    b += s2[(size_t)(1 + i) * N + col];
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

template <int NP>
int launch_tiles(const CUtensorMap& tx, const CUtensorMap& tw,
                 const CUtensorMap& ty, float* stats, int M, int K, int N,
                 int grid, cudaStream_t st) {
  constexpr auto kernel = matmul_stats_tile<NP>;
  cudaError_t e = allow_smem<kernel>(kSmemMax);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, Layout<NP>::kTotal, st>>>(tx, tw, ty, stats, M,
                                                     K, N);
  return (int)cudaGetLastError();
}

// The tensor map of a 2-d bf16 matrix (encode_map_2d), kept from the last
// call of this thread in `slot`: a map is a function of its arguments
// alone, and a caller that repeats its operands (or gets the same block
// back from the caching allocator) skips the encode.
int cached_map(int slot, CUtensorMap* map, const void* ptr, long long cols,
               long long rows, int box_rows) {
  struct Entry {
    CUtensorMap map;
    const void* ptr;
    long long cols, rows;
    int box_rows;
    bool ok;
  };
  static thread_local Entry last[3];
  Entry& e = last[slot];
  if (!(e.ok && e.ptr == ptr && e.cols == cols && e.rows == rows &&
        e.box_rows == box_rows)) {
    e.ok = false;
    const int r = encode_map_2d(&e.map, ptr, cols, rows, cols * 2, box_rows);
    if (r != 0) return r;
    e.ptr = ptr;
    e.cols = cols;
    e.rows = rows;
    e.box_rows = box_rows;
    e.ok = true;
  }
  *map = e.map;
  return 0;
}

}  // namespace

// x [M, K], w [K, N], y [M, N]: contiguous bf16 device buffers, 16-byte
// aligned; stats: a [2, 1 + grid, N] f32 buffer, rows 0 s and s2 on
// return, rows 1 .. grid scratch; grid blocks, 1 .. ceil(M / 64)
// (ops/matmul_stats.py `plan`: min(SMs, tiles)). Returns the cudaError_t of the two launches (0 on
// success), or flash::kErrNoEncoder / kErrEncode + the CUresult when a
// tensor map cannot be made.
extern "C" int mx_matmul_stats(const void* x, const void* w, void* y,
                               float* stats, int M, int K, int N, int grid,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 16 || K % 16 != 0 || N < 8 || N % 8 != 0 || N > 256 ||
      grid < 1 || grid > (M + kBM - 1) / kBM ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int np = N <= 64 ? 64 : N <= 128 ? 128 : 256;
  CUtensorMap tx, tw, ty;
  int r = cached_map(0, &tx, x, K, M, kBM);
  if (r == 0) r = cached_map(1, &tw, w, N, K, 64);
  if (r == 0) r = cached_map(2, &ty, y, N, M, kBM);
  if (r != 0) return r;
  if (np == 64)
    r = launch_tiles<64>(tx, tw, ty, stats, M, K, N, grid, st);
  else if (np == 128)
    r = launch_tiles<128>(tx, tw, ty, stats, M, K, N, grid, st);
  else
    r = launch_tiles<256>(tx, tw, ty, stats, M, K, N, grid, st);
  if (r != 0) return r;
  matmul_stats_reduce<<<N / kRedCols, kRedThreads, 0, st>>>(stats, grid, N);
  return (int)cudaGetLastError();
}
