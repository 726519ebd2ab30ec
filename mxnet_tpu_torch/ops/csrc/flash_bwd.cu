// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py::_flash_bwd_dq_kernel (K3)
// and ::_flash_bwd_dkv_kernel (K4), both launched by
// _flash_attention_bwd_pallas. Same functions: from the forward's saved
// f32 log-sum-exp lse and D = rowsum(dO * O) (computed by the caller),
// P = exp(scale * Q K^T - lse) is rebuilt tile by tile on the visible
// pairs (top-left causal rule: key position <= query position, Tq != Tk
// allowed), and
//   dS = P * (dO V^T - D),  dQ = scale * dS K,
//   dK = scale * dS^T Q,    dV = P^T dO.
// No [T, T] matrix touches device memory. Any Tq, Tk >= 1; D is 64 or
// 128 (Dv == D).
//
// Layout: q, do are [B, H, Tq, D] and k, v [B, H, Tk, D] views read
// through their B, H and T strides (in elements; D contiguous). The bf16
// path takes any view whose rows start 16-byte aligned with strides that
// are multiples of 16 bytes: the transformer's heads of one qkv product
// and the head-transposed gradient of its attention output arrive
// without a copy. The f32 path takes contiguous tensors. lse and D are
// contiguous f32 [B*H, Tq]; dq is a contiguous [B*H, Tq, D], dk and dv
// contiguous [B*H, Tk, D].
//
// The TPU split is kept and no atomics are used, so the bits are the same
// from call to call: K3 runs one block per (query tile, b*h) and walks the
// key tiles up to the causal diagonal; K4 runs one block per (key tile,
// b*h) and walks the query tiles from the first that sees its keys. Both
// take the longest causal walks first.
//
// Bound: at the training path's shape [16, 8, 1024, 128] bf16 causal K3
// does three products (S, dP, dQ) over 524,800 visible pairs a head, 51.6
// GFLOP (52.2 us at 989 TFLOP/s), against 168.8 MB read and written (50.4
// us at 3.35 TB/s); K4 does four (S, dP, dV, dK), 68.8 GFLOP (69.6 us)
// against 202.4 MB (60.4 us). Both are bounded by operations: the products
// belong on the tensor cores, fed without stalls. Expected: with the
// tensor work at 250-390 TFLOP/s (K2 reaches 388), K3 + K4 take
// 0.44-0.69 ms with P and dS as hi + lo terms, 0.31-0.48 ms with one.
//
// bf16, the training path. Design (Hopper's warp-specialised shape, as
// K2 in flash_fwd.cu, on the helpers of flash_common.cuh):
// - a producer, one thread of which issues every TMA load (4-d tensor
//   maps over the strided views, 128-byte swizzle, rows past T zero-filled
//   per head): the block's own operands once, then the walked operand's
//   tiles into a ring of kStages stages; "full" mbarriers carry the bytes'
//   arrival to the consumers and "empty" ones the stage's release back;
// - consumer warpgroups of 64 rows each. The two score products run as
//   wgmma.mma_async with A and B from shared memory (both K-major, D in
//   64-column slabs of 128 bytes). P and dS are formed on the f32
//   accumulator fragments, and the m64nN accumulator layout is, pair by
//   pair, the bf16 register-A layout of the next wgmma, so they feed the
//   gradient products from registers with no shuffle; those products read
//   B (K, Q or dO, [rows, D] with D contiguous) from its TMA tile through
//   the descriptor's MN-major mode, so nothing is transposed.
// - K3 (dQ): the producer loads Q and dO once, then K and V tiles of 64
//   keys. A consumer keeps its rows' lse and D in registers: S = Q K^T and
//   dP = dO V^T (m64n64), dS = P (dP - D), dQ += dS K (m64nD, A = dS).
//   Two block shapes: 2 consumer warpgroups (128 query rows) and a
//   producer warpgroup that gives its registers to them (setmaxnreg 40 /
//   232), 3 stages, one block an SM; or, for grids of fewer 128-row tiles
//   than SMs, 1 consumer warpgroup (64 rows) and a producer warp, 2
//   stages, two blocks an SM. See launch_dq_shape.
// - K4 (dK, dV): 128 keys a block, 2 consumer warpgroups of 64 keys that
//   hold their m64nD dK and dV accumulators for the whole walk, a producer
//   warpgroup (setmaxnreg 40 / 232). The producer loads the block's K and
//   V once, then streams 64-query tiles of Q and dO by TMA, and its 128
//   threads copy each tile's lse (scaled by log2 e) and D into the same
//   stage (the full barrier counts the TMA bytes and 129 arrivals). A
//   consumer computes the transposed scores, with its keys as wgmma's M:
//   S^T = K Q^T and dP^T = V dO^T (m64n64), P^T with lse and D indexed
//   along columns, dS^T = P^T (dP^T - D), then dV += P^T dO and
//   dK += dS^T Q (m64nD, A from registers). A warpgroup whose first
//   visible query tile comes later, or whose keys lie past Tk, still waits
//   for each stage's load and releases it, which keeps every stage's
//   arrivals in its phase.
// - ragged edges: TMA zero-fills rows past Tq or Tk. Only the tiles that
//   cross the diagonal or an edge are masked (P = 0 there): a key past Tk
//   in K3, or a query past Tq in K4, would otherwise meet exp(-lse) times
//   a zero row, which is NaN where exp overflows.
// - P and dS go into their products as hi + lo bf16 terms (~16 mantissa
//   bits, as the f32 TPU kernel keeps them in f32): 10 product-equivalents
//   of the function's 7. The checks' limit (chip_smoke.py closeness, per
//   element and in L2) is already 0.46-0.74 used by the outputs' own bf16
//   rounding with hi + lo; a build with one bf16 term used 0.92-5.21 of
//   it (up to 5x over) for 11-18% less device time, so it was measured
//   and taken out (PERF.md, the K3/K4 findings).
// - registers: the tile that stays put (Q and dO in K3, K and V in K4)
//   is read through opaque(), else the compiler hoists its 16 wgmma
//   descriptors out of the walk (32 registers) and K4 at D = 128 and
//   K3's one-warpgroup blocks at D = 128 spilled 36 bytes. ptxas: 168
//   registers at launch in the two-warpgroup blocks (setmaxnreg gives
//   the consumers 232), 125-166 in K3's one-warpgroup blocks; no spills.
//
// Measured on an H100 (700 W, chip_smoke.py) at the training shape,
// the LM's strided views: K3 0.178 ms and K4 0.284-0.286 ms of device
// time (CUDA graphs), the tensor cores running the hi + lo work at 386
// and 361-364 TFLOP/s (289 and 240-243 of the function's); the kernels
// they replace took 0.568-0.576 and 0.808-0.823 ms; SDPA's backward,
// all three gradients, 0.320-0.328. Not yet tried: FlashAttention-3's
// ping-pong of the two consumer warpgroups (it did not pay in K2),
// larger key tiles, a persistent grid, the epilogue through shared
// memory and TMA stores, one fused pass with dQ summed by f32 atomics
// (5 products, not bitwise reproducible), D = rowsum(dO * O) folded
// into K3.
//
// f32: full f32 precision forbids the bf16 tensor cores, so the products
// run as f32 FMA on the CUDA cores: 128 threads as a 16 x 8 grid, each
// owning 4 rows x 8 columns of the score tile and 4 rows x D/8 columns of
// the outputs, with all tiles staged in shared memory.

#include "flash_common.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: TMA ring, wgmma, warp-specialised
// ---------------------------------------------------------------------------

// the m64nN accumulator acc as the register-A fragments of N / 16 wgmma
// steps: columns 16kk .. 16kk + 15 are, pair by pair, step kk's fragment;
// as hi + lo bf16 pairs
template <int N>
__device__ __forceinline__ void to_a(const float* acc, uint32_t (*hi)[4],
                                     uint32_t (*lo)[4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1], hi[kk][r],
                 lo[kk][r]);
}

// d += A B, m64nD over a depth of K: A the hi + lo fragments of to_a<K>,
// B a [K rows, D] tile with D contiguous (its slabs K * 128 bytes apart),
// read MN-major; issued, not committed
template <int D, int K>
__device__ __forceinline__ void wgmma_ab(float* d, const uint32_t (*hi)[4],
                                         const uint32_t (*lo)[4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t db = smem_desc(b + kk * 16 * 128, K * 128, 1024);
    wgmma_rs<D>(d, hi[kk], db);
    wgmma_rs<D>(d, lo[kk], db);
  }
}

template <int D, int kWG, int kStages>
struct DqTiles {
  static constexpr int BN = 64;             // keys a tile
  static constexpr int kSlabs = D / 64;     // 128-byte column slabs of a row
  static constexpr int BM = 64 * kWG;       // query rows of a block
  // two consumer warpgroups take a whole producer warpgroup, so that
  // setmaxnreg can move its registers to them; one takes a single warp
  static constexpr int kProducerThreads = kWG == 2 ? 128 : 32;
  static constexpr int kThreads = 128 * kWG + kProducerThreads;
  static constexpr uint32_t kQBytes = BM * D * 2;      // Q or dO
  static constexpr uint32_t kTileBytes = BN * D * 2;   // a K or V tile
  // Q, dO, the K ring, the V ring (each slab 1024-byte aligned for the
  // swizzle), then q_full, full[], empty[]; 1024 to align
  static constexpr size_t kSmem =
      1024 + 2 * kQBytes + 2 * kStages * kTileBytes + 8 * (1 + 2 * kStages);
};

// K3: dQ for one tile of 64 * kWG query rows.
template <int D, int kWG, int kStages>
__global__ void __launch_bounds__(DqTiles<D, kWG, kStages>::kThreads,
                                  kWG == 1 ? 2 : 1)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do,
                  const float* __restrict__ lse,
                  const float* __restrict__ dcap, bf16* __restrict__ dq,
                  int heads, int tq, int tk, float scale, int causal) {
  using T = DqTiles<D, kWG, kStages>;
  constexpr int BN = T::BN;
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdo = sq + T::kQBytes;
  const uint32_t sk = sdo + T::kQBytes;             // + stage * kTileBytes
  const uint32_t sv = sk + kStages * T::kTileBytes;
  const uint32_t q_full = sv + kStages * T::kTileBytes;
  auto full = [&](int s) { return q_full + 8u * (1 + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + kStages + s); };

  const int bh = blockIdx.x;
  const int batch = bh / heads, head = bh % heads;
  // grid.y counts query tiles from the last: under the causal mask the
  // last has the most key tiles, so the long blocks start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::BM;
  const int n_k = (tk + BN - 1) / BN;
  // key tiles that rows up to last_row see
  auto tiles_upto = [&](int last_row) {
    return causal ? min(n_k, last_row / BN + 1) : n_k;
  };
  const int n_block = tiles_upto(min(q0 + T::BM, tq) - 1);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * kWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == kWG) {
    // producer: one thread issues every load
    if constexpr (kWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 128 * kWG) {
      mbar_expect_tx(q_full, 2 * T::kQBytes);
      tma_rows<T::kSlabs>(sq, &tm_q, q_full, T::BM, q0, head, batch);
      tma_rows<T::kSlabs>(sdo, &tm_do, q_full, T::BM, q0, head, batch);
      for (int t = 0; t < n_block; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty(s), ((t / kStages) - 1) & 1);
        mbar_expect_tx(full(s), 2 * T::kTileBytes);
        tma_rows<T::kSlabs>(sk + s * T::kTileBytes, &tm_k, full(s), BN,
                            t * BN, head, batch);
        tma_rows<T::kSlabs>(sv + s * T::kTileBytes, &tm_v, full(s), BN,
                            t * BN, head, batch);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows r0 .. r0 + 63
  if constexpr (kWG == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int r0 = q0 + wg * 64;
  const int n_mine = r0 < tq ? tiles_upto(min(r0 + 64, tq) - 1) : 0;
  const int row0 = r0 + warp * 16 + g, row1 = row0 + 8;   // this lane's rows
  // the rows' lse (log2 domain) and D; rows past tq read 0 and are never
  // written
  const size_t rows = (size_t)bh * tq;
  const float l0 = row0 < tq ? lse[rows + row0] * kLog2e : 0.f;
  const float l1 = row1 < tq ? lse[rows + row1] * kLog2e : 0.f;
  const float c0 = row0 < tq ? dcap[rows + row0] : 0.f;
  const float c1 = row1 < tq ? dcap[rows + row1] : 0.f;
  const float scale_log2 = scale * kLog2e;

  // m64nD f32 accumulator: element 4n + 2i + j is (row_i, 8n + 2tg + j)
  float dqacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqacc[i] = 0.f;
  const uint32_t sq_wg = sq + wg * 64 * 128, sdo_wg = sdo + wg * 64 * 128;
  // tiles from first_masked on cross the diagonal or Tk
  const int first_masked = min(causal ? (r0 + 1) / BN : n_k, tk / BN);

  float sacc[BN / 2], dpacc[BN / 2];
  uint32_t hi[BN / 16][4], lo[BN / 16][4];
  if (n_mine > 0) mbar_wait(q_full, 0);
  for (int t = 0; t < n_block; ++t) {
    const int s = t % kStages;
    // past this warpgroup's diagonal the stage is only released in turn
    // (waiting for its load keeps the arrivals in the stage's phase)
    mbar_wait(full(s), (t / kStages) & 1);
    if (t < n_mine) {
      const uint32_t ks = sk + s * T::kTileBytes, vs = sv + s * T::kTileBytes;
      // S = Q K^T, dP = dO V^T
      fence_regs<BN / 2>(sacc);
      fence_regs<BN / 2>(dpacc);
      wgmma_fence();
      wgmma_abt<BN, D>(sacc, opaque(sq_wg), T::BM, ks, BN);
      wgmma_abt<BN, D>(dpacc, opaque(sdo_wg), T::BM, vs, BN);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BN / 2>(sacc);
      fence_regs<BN / 2>(dpacc);
      // dS = P (dP - D), P = 2^(S scale log2(e) - lse log2(e)) where
      // visible, into sacc
      const bool mask = t >= first_masked;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * n + e;
          float p = ex2(fmaf(sacc[i], scale_log2, e < 2 ? -l0 : -l1));
          if (mask) {
            const int col = t * BN + 8 * n + 2 * tg + (e & 1);
            if (col >= tk || (causal && col > (e < 2 ? row0 : row1))) p = 0.f;
          }
          sacc[i] = p * (dpacc[i] - (e < 2 ? c0 : c1));
        }
      // dQ += dS K
      to_a<BN>(sacc, hi, lo);
      fence_regs<D / 2>(dqacc);
      wgmma_fence();
      wgmma_ab<D, BN>(dqacc, hi, lo, ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(dqacc);
    }
    mbar_arrive(empty(s));
  }
  if (n_mine == 0) return;

  bf16* o0 = dq + (rows + row0) * D;
  bf16* o1 = dq + (rows + row1) * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + tg * 2;
    if (row0 < tq)
      *reinterpret_cast<__nv_bfloat162*>(o0 + col) = __floats2bfloat162_rn(
          dqacc[4 * n] * scale, dqacc[4 * n + 1] * scale);
    if (row1 < tq)
      *reinterpret_cast<__nv_bfloat162*>(o1 + col) = __floats2bfloat162_rn(
          dqacc[4 * n + 2] * scale, dqacc[4 * n + 3] * scale);
  }
}

template <int D, int kStages>
struct DkvTiles {
  static constexpr int kWG = 2;             // consumer warpgroups, 64 keys each
  static constexpr int BK = 64 * kWG;       // keys of a block
  static constexpr int BQ = 64;             // queries a tile
  static constexpr int kSlabs = D / 64;
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr uint32_t kKBytes = BK * D * 2;      // the block's K or V
  static constexpr uint32_t kTileBytes = BQ * D * 2;   // a Q or dO tile
  static constexpr uint32_t kStatBytes = 2 * BQ * 4;   // a tile's lse and D
  // K, V, the Q ring, the dO ring, the lse/D ring, then kv_full, full[],
  // empty[]; 1024 to align
  static constexpr size_t kSmem = 1024 + 2 * kKBytes +
                                  kStages * (2 * kTileBytes + kStatBytes) +
                                  8 * (1 + 2 * kStages);
};

// K4: dK and dV for one tile of 128 keys.
template <int D, int kStages>
__global__ void __launch_bounds__(DkvTiles<D, kStages>::kThreads, 1)
flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ dcap, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int heads, int tq, int tk,
                   float scale, int causal) {
  using T = DkvTiles<D, kStages>;
  constexpr int BQ = T::BQ, BK = T::BK, kWG = T::kWG;
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static_assert(2 * BQ == 128, "the producer's 128 threads copy lse and D");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sk = smem_u32(base);
  const uint32_t sv = sk + T::kKBytes;
  const uint32_t sq = sv + T::kKBytes;                // + stage * kTileBytes
  const uint32_t sdo = sq + kStages * T::kTileBytes;
  const uint32_t sst = sdo + kStages * T::kTileBytes; // + stage * kStatBytes
  const uint32_t kv_full = sst + kStages * T::kStatBytes;
  // stage s: lse (log2 domain) of its BQ queries, then their D
  float* stats = reinterpret_cast<float*>(base + (sst - sk));
  auto full = [&](int s) { return kv_full + 8u * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8u * (1 + kStages + s); };

  const int bh = blockIdx.x;
  const int batch = bh / heads, head = bh % heads;
  // grid.y counts key tiles from the first: under the causal mask the
  // first sees the most query tiles, so the long blocks start first
  const int k0 = blockIdx.y * BK;
  const int n_q = (tq + BQ - 1) / BQ;
  // the first query tile that keys from first_key on see
  auto first_tile = [&](int first_key) { return causal ? first_key / BQ : 0; };
  const int j0 = first_tile(k0);
  const int n_walk = max(0, n_q - j0);   // a key tile past tq sees none

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      // the TMA issuer's expect_tx and each producer thread's lse/D store
      mbar_init(full(s), 1 + 128);
      mbar_init(empty(s), 128 * kWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == kWG) {
    // producer warpgroup: thread 0 issues every TMA load, all 128 copy
    // each tile's lse and D
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = tid - 128 * kWG;
    if (pt == 0 && n_walk > 0) {
      mbar_expect_tx(kv_full, 2 * T::kKBytes);
      tma_rows<T::kSlabs>(sk, &tm_k, kv_full, BK, k0, head, batch);
      tma_rows<T::kSlabs>(sv, &tm_v, kv_full, BK, k0, head, batch);
    }
    for (int i = 0; i < n_walk; ++i) {
      const int s = i % kStages, q0 = (j0 + i) * BQ;
      if (i >= kStages) mbar_wait(empty(s), ((i / kStages) - 1) & 1);
      if (pt == 0) {
        mbar_expect_tx(full(s), 2 * T::kTileBytes);
        tma_rows<T::kSlabs>(sq + s * T::kTileBytes, &tm_q, full(s), BQ, q0,
                            head, batch);
        tma_rows<T::kSlabs>(sdo + s * T::kTileBytes, &tm_do, full(s), BQ,
                            q0, head, batch);
      }
      // queries past tq read 0 (their tile is masked)
      const int row = q0 + pt % BQ;
      float x = 0.f;
      if (row < tq)
        x = pt < BQ ? lse[(size_t)bh * tq + row] * kLog2e
                    : dcap[(size_t)bh * tq + row];
      stats[s * 2 * BQ + pt] = x;
      mbar_arrive(full(s));
    }
    return;
  }

  // consumer warpgroup wg: keys kr0 .. kr0 + 63; each SM sub-partition
  // holds one producer and two consumer warps: 40 + 2 * 232 registers a
  // lane fill its 16384
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int kr0 = k0 + wg * 64;
  const bool mine = kr0 < tk;           // keys of its own to write
  const int j_first = first_tile(kr0);
  const int key0 = kr0 + warp * 16 + g, key1 = key0 + 8;   // this lane's keys
  const float scale_log2 = scale * kLog2e;

  float dkacc[D / 2], dvacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dkacc[i] = dvacc[i] = 0.f;
  const uint32_t sk_wg = sk + wg * 64 * 128, sv_wg = sv + wg * 64 * 128;

  float sacc[BQ / 2], dpacc[BQ / 2];
  uint32_t phi[BQ / 16][4], plo[BQ / 16][4], dhi[BQ / 16][4], dlo[BQ / 16][4];
  if (mine && j_first < n_q) mbar_wait(kv_full, 0);
  for (int i = 0; i < n_walk; ++i) {
    const int j = j0 + i, s = i % kStages;
    mbar_wait(full(s), (i / kStages) & 1);
    if (mine && j >= j_first) {
      const uint32_t qs = sq + s * T::kTileBytes, dos = sdo + s * T::kTileBytes;
      const float* st = stats + s * 2 * BQ;
      // S^T = K Q^T, dP^T = V dO^T
      fence_regs<BQ / 2>(sacc);
      fence_regs<BQ / 2>(dpacc);
      wgmma_fence();
      wgmma_abt<BQ, D>(sacc, opaque(sk_wg), BK, qs, BQ);
      wgmma_abt<BQ, D>(dpacc, opaque(sv_wg), BK, dos, BQ);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BQ / 2>(sacc);
      fence_regs<BQ / 2>(dpacc);
      // P^T into sacc and dS^T = P^T (dP^T - D) into dpacc, lse and D
      // indexed by the query (column); the tile is masked where it
      // crosses the diagonal or tq
      const int q0 = j * BQ;
      const bool mask = (causal && q0 < kr0 + 64) || q0 + BQ > tq;
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = 4 * n + e;
          const int c = 8 * n + 2 * tg + (e & 1);
          float p = ex2(fmaf(sacc[idx], scale_log2, -st[c]));
          if (mask && (q0 + c >= tq ||
                       (causal && (e < 2 ? key0 : key1) > q0 + c)))
            p = 0.f;
          dpacc[idx] = p * (dpacc[idx] - st[BQ + c]);
          sacc[idx] = p;
        }
      // dV += P^T dO, dK += dS^T Q
      to_a<BQ>(sacc, phi, plo);
      to_a<BQ>(dpacc, dhi, dlo);
      fence_regs<D / 2>(dvacc);
      fence_regs<D / 2>(dkacc);
      wgmma_fence();
      wgmma_ab<D, BQ>(dvacc, phi, plo, dos);
      wgmma_ab<D, BQ>(dkacc, dhi, dlo, qs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(dvacc);
      fence_regs<D / 2>(dkacc);
    }
    mbar_arrive(empty(s));
  }
  if (!mine) return;

  // keys that see no query (causal, past tq) write zeros
  const size_t keys = (size_t)bh * tk;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + tg * 2;
    if (key0 < tk) {
      const size_t o = (keys + key0) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + o) = __floats2bfloat162_rn(
          dkacc[4 * n] * scale, dkacc[4 * n + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + o) =
          __floats2bfloat162_rn(dvacc[4 * n], dvacc[4 * n + 1]);
    }
    if (key1 < tk) {
      const size_t o = (keys + key1) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + o) = __floats2bfloat162_rn(
          dkacc[4 * n + 2] * scale, dkacc[4 * n + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + o) =
          __floats2bfloat162_rn(dvacc[4 * n + 2], dvacc[4 * n + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA
// ---------------------------------------------------------------------------

constexpr int kBlock = 64;   // rows of a query or key tile
constexpr int kThreads = 128;

constexpr int kRows = 4;   // tile rows per thread (kBlock / 16)
constexpr int kCols = 8;   // tile columns per thread (kBlock / 8)

// Rows [r0, r0 + 64) of a row-major [n, D] f32 matrix into dst[64][D + 1]
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int r0, int n) {
  for (int idx = threadIdx.x; idx < kBlock * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = r0 + r < n ? src[(size_t)(r0 + r) * D + c] : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_f32() {
  // Q, dO, K, V tiles [64][D + 1], dS tile [64][64 + 1]
  return sizeof(float) * (4 * kBlock * (D + 1) + kBlock * (kBlock + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dcap, float* __restrict__ dq,
                 int tq, int tk, float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int LDP = kBlock + 1;
  constexpr int kOut = D / 8;
  extern __shared__ float smf[];
  float* qs = smf;
  float* dos = qs + kBlock * LD;
  float* ks = dos + kBlock * LD;
  float* vs = ks + kBlock * LD;
  float* dss = vs + kBlock * LD;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlock;
  const size_t qoff = (size_t)bh * tq * D, koff = (size_t)bh * tk * D;
  const int ty = threadIdx.x >> 3;  // rows ty*4 .. ty*4+3
  const int tx = threadIdx.x & 7;   // columns tx + 8*j

  stage_f32<D>(qs, q + qoff, q0, tq);
  stage_f32<D>(dos, dout + qoff, q0, tq);
  float lr[kRows], cr[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    lr[i] = row < tq ? lse[(size_t)bh * tq + row] : 0.f;
    cr[i] = row < tq ? dcap[(size_t)bh * tq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.f;
  }

  const int n_k = (tk + kBlock - 1) / kBlock;
  int upper = n_k;
  if (causal) {
    const int u = (q0 + kBlock - 1) / kBlock + 1;
    upper = u < n_k ? u : n_k;
  }

  for (int t = 0; t < upper; ++t) {
    const int k0 = t * kBlock;
    __syncthreads();
    stage_f32<D>(ks, k + koff, k0, tk);
    stage_f32<D>(vs, v + koff, k0, tk);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[kRows], dov[kRows], kv[kCols], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = qs[(ty * kRows + i) * LD + d];
        dov[i] = dos[(ty * kRows + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kv[j] = ks[(tx + 8 * j) * LD + d];
        vv[j] = vs[(tx + 8 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + 8 * j;
        const bool vis = col < tk && !(causal && col > row);
        const float p = vis ? expf(s[i][j] * scale - lr[i]) : 0.f;
        dss[(ty * kRows + i) * LDP + tx + 8 * j] = p * (dp[i][j] - cr[i]);
      }
    }
    __syncthreads();

    // dQ += dS K
#pragma unroll 2
    for (int kk = 0; kk < kBlock; ++kk) {
      float dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsv[i] = dss[(ty * kRows + i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const float kv = ks[kk * LD + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= tq) continue;
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      dq[qoff + (size_t)row * D + tx + 8 * j] = acc[i][j] * scale;
  }
}

template <int D>
constexpr size_t dkv_smem_f32() {
  // K, V, Q, dO tiles [64][D + 1], P^T and dS^T [64][64 + 1], lse and D
  return sizeof(float) *
         (4 * kBlock * (D + 1) + 2 * kBlock * (kBlock + 1) + 2 * kBlock);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ dcap, float* __restrict__ dk,
                  float* __restrict__ dv, int tq, int tk, float scale,
                  int causal) {
  constexpr int LD = D + 1;
  constexpr int LDP = kBlock + 1;
  constexpr int kOut = D / 8;
  extern __shared__ float smf[];
  float* ks = smf;
  float* vs = ks + kBlock * LD;
  float* qs = vs + kBlock * LD;
  float* dos = qs + kBlock * LD;
  float* ps = dos + kBlock * LD;
  float* dss = ps + kBlock * LDP;
  float* ls = dss + kBlock * LDP;
  float* dcs = ls + kBlock;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlock;
  const size_t qoff = (size_t)bh * tq * D, koff = (size_t)bh * tk * D;
  const int ty = threadIdx.x >> 3;  // key rows ty*4 .. ty*4+3
  const int tx = threadIdx.x & 7;   // query / output columns tx + 8*j

  stage_f32<D>(ks, k + koff, k0, tk);
  stage_f32<D>(vs, v + koff, k0, tk);
  float dka[kRows][kOut], dva[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kOut; ++j) dka[i][j] = dva[i][j] = 0.f;

  const int n_q = (tq + kBlock - 1) / kBlock;
  const int lower = causal ? k0 / kBlock : 0;

  for (int jt = lower; jt < n_q; ++jt) {
    const int q0 = jt * kBlock;
    __syncthreads();
    stage_f32<D>(qs, q + qoff, q0, tq);
    stage_f32<D>(dos, dout + qoff, q0, tq);
    for (int i = threadIdx.x; i < kBlock; i += kThreads) {
      const bool in = q0 + i < tq;
      ls[i] = in ? lse[(size_t)bh * tq + q0 + i] : 0.f;
      dcs[i] = in ? dcap[(size_t)bh * tq + q0 + i] : 0.f;
    }
    __syncthreads();

    // P^T = exp(scale K Q^T - lse[query]) on visible pairs
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float kv[kRows], qv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) kv[i] = ks[(ty * kRows + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) qv[j] = qs[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int krow = k0 + ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 8 * j;
        const int qpos = q0 + c;
        const bool vis = qpos < tq && krow < tk && !(causal && krow > qpos);
        ps[(ty * kRows + i) * LDP + c] =
            vis ? expf(s[i][j] * scale - ls[c]) : 0.f;
      }
    }

    // dP^T = V dO^T; dS^T = P^T (dP^T - D[query]) (this thread's own
    // P^T entries, so no barrier between)
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float vv[kRows], dov[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) vv[i] = vs[(ty * kRows + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) dov[j] = dos[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(vv[i], dov[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 8 * j;
        const int o = (ty * kRows + i) * LDP + c;
        dss[o] = ps[o] * (s[i][j] - dcs[c]);
      }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q
#pragma unroll 2
    for (int qq = 0; qq < kBlock; ++qq) {
      float pv[kRows], dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pv[i] = ps[(ty * kRows + i) * LDP + qq];
        dsv[i] = dss[(ty * kRows + i) * LDP + qq];
      }
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const float dov = dos[qq * LD + tx + 8 * j];
        const float qv = qs[qq * LD + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          dva[i][j] = fmaf(pv[i], dov, dva[i][j]);
          dka[i][j] = fmaf(dsv[i], qv, dka[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int krow = k0 + ty * kRows + i;
    if (krow >= tk) continue;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const size_t o = koff + (size_t)krow * D + tx + 8 * j;
      dk[o] = dka[i][j] * scale;
      dv[o] = dva[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int D, int kWG, int kStages>
int launch_dq(const Operand& q, const Operand& k, const Operand& v,
              const Operand& dout, const float* lse, const float* dcap,
              void* dq, int b, int h, int tq, int tk, float scale,
              int causal, cudaStream_t stream) {
  using T = DqTiles<D, kWG, kStages>;
  CUtensorMap mq, mk, mv, mdo;
  int err = encode_map(&mq, q, b, h, tq, D, T::BM);
  if (!err) err = encode_map(&mdo, dout, b, h, tq, D, T::BM);
  if (!err) err = encode_map(&mk, k, b, h, tk, D, T::BN);
  if (!err) err = encode_map(&mv, v, b, h, tk, D, T::BN);
  if (err) return err;
  constexpr auto kernel = flash_bwd_dq_bf16<D, kWG, kStages>;
  const cudaError_t e = allow_smem<kernel>(T::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid(b * h, (tq + T::BM - 1) / T::BM);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(
      mq, mk, mv, mdo, lse, dcap, static_cast<bf16*>(dq), h, tq, tk, scale,
      causal);
  return cudaGetLastError();
}

// two consumer warpgroups (128 query rows a block, one block an SM) and 3
// stages wherever the grid has at least as many 128-row tiles as the card
// has SMs; else one warpgroup (64 rows, two blocks an SM) and 2 stages, as
// K2 chooses
template <int D>
int launch_dq_shape(const Operand& q, const Operand& k, const Operand& v,
                    const Operand& dout, const float* lse, const float* dcap,
                    void* dq, int b, int h, int tq, int tk, float scale,
                    int causal, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  if ((long long)b * h * ((tq + 127) / 128) >= sms)
    return launch_dq<D, 2, 3>(q, k, v, dout, lse, dcap, dq, b, h, tq, tk,
                              scale, causal, stream);
  return launch_dq<D, 1, 2>(q, k, v, dout, lse, dcap, dq, b, h, tq, tk,
                            scale, causal, stream);
}

template <int D>
int launch_dkv(const Operand& q, const Operand& k, const Operand& v,
               const Operand& dout, const float* lse, const float* dcap,
               void* dk, void* dv, int b, int h, int tq, int tk, float scale,
               int causal, cudaStream_t stream) {
  constexpr int kStages = 3;
  using T = DkvTiles<D, kStages>;
  CUtensorMap mq, mk, mv, mdo;
  int err = encode_map(&mq, q, b, h, tq, D, T::BQ);
  if (!err) err = encode_map(&mdo, dout, b, h, tq, D, T::BQ);
  if (!err) err = encode_map(&mk, k, b, h, tk, D, T::BK);
  if (!err) err = encode_map(&mv, v, b, h, tk, D, T::BK);
  if (err) return err;
  constexpr auto kernel = flash_bwd_dkv_bf16<D, kStages>;
  const cudaError_t e = allow_smem<kernel>(T::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid(b * h, (tk + T::BK - 1) / T::BK);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(
      mq, mk, mv, mdo, lse, dcap, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), h, tq, tk, scale, causal);
  return cudaGetLastError();
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq_f32(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* dcap,
                   void* dq, int bh, int tq, int tk, float scale,
                   int causal, cudaStream_t s) {
  const dim3 grid((tq + kBlock - 1) / kBlock, bh);
  return launch(flash_bwd_dq_f32<D>, dq_smem_f32<D>(), grid, s,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v),
                static_cast<const float*>(dout), lse, dcap,
                static_cast<float*>(dq), tq, tk, scale, causal);
}

template <int D>
cudaError_t dkv_f32(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* dcap,
                    void* dk, void* dv, int bh, int tq, int tk, float scale,
                    int causal, cudaStream_t s) {
  const dim3 grid((tk + kBlock - 1) / kBlock, bh);
  return launch(flash_bwd_dkv_f32<D>, dkv_smem_f32<D>(), grid, s,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v),
                static_cast<const float*>(dout), lse, dcap,
                static_cast<float*>(dk), static_cast<float*>(dv), tq, tk,
                scale, causal);
}

}  // namespace

// Both entries: q, do are [b, h, tq, d] and k, v [b, h, tk, d] with
// element strides (s*b, s*h, s*t, 1); bf16 views need 16-byte aligned
// rows and strides of 16-byte multiples, f32 tensors must be contiguous
// (their strides are not read). lse, dcap: contiguous f32 [b*h, tq].
// is_bf16: 1 = bf16, 0 = f32. Each returns a cudaError_t (0 on success),
// 1999 when libcuda's tensor-map encoder cannot be found, or 2000 + the
// CUresult of a failed encode.

// K3. dq: contiguous [b*h, tq, d].
extern "C" int mx_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dcap, void* dq, int b, int h, int tq,
    int tk, int d, long long sqb, long long sqh, long long sqt,
    long long skb, long long skh, long long skt, long long svb,
    long long svh, long long svt, long long sdb, long long sdh,
    long long sdt, float scale, int causal, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const Operand oq{q, sqb, sqh, sqt}, ok{k, skb, skh, skt},
        ov{v, svb, svh, svt}, od{dout, sdb, sdh, sdt};
    if (d == 64)
      return launch_dq_shape<64>(oq, ok, ov, od, lse, dcap, dq, b, h, tq, tk,
                                 scale, causal, s);
    if (d == 128)
      return launch_dq_shape<128>(oq, ok, ov, od, lse, dcap, dq, b, h, tq, tk,
                                  scale, causal, s);
    return (int)cudaErrorInvalidValue;
  }
  if (d == 64)
    return dq_f32<64>(q, k, v, dout, lse, dcap, dq, b * h, tq, tk, scale,
                      causal, s);
  if (d == 128)
    return dq_f32<128>(q, k, v, dout, lse, dcap, dq, b * h, tq, tk, scale,
                       causal, s);
  return (int)cudaErrorInvalidValue;
}

// K4. dk, dv: contiguous [b*h, tk, d].
extern "C" int mx_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dcap, void* dk, void* dv, int b, int h,
    int tq, int tk, int d, long long sqb, long long sqh, long long sqt,
    long long skb, long long skh, long long skt, long long svb,
    long long svh, long long svt, long long sdb, long long sdh,
    long long sdt, float scale, int causal, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const Operand oq{q, sqb, sqh, sqt}, ok{k, skb, skh, skt},
        ov{v, svb, svh, svt}, od{dout, sdb, sdh, sdt};
    if (d == 64)
      return launch_dkv<64>(oq, ok, ov, od, lse, dcap, dk, dv, b, h, tq, tk,
                            scale, causal, s);
    if (d == 128)
      return launch_dkv<128>(oq, ok, ov, od, lse, dcap, dk, dv, b, h, tq, tk,
                             scale, causal, s);
    return (int)cudaErrorInvalidValue;
  }
  if (d == 64)
    return dkv_f32<64>(q, k, v, dout, lse, dcap, dk, dv, b * h, tq, tk,
                       scale, causal, s);
  if (d == 128)
    return dkv_f32<128>(q, k, v, dout, lse, dcap, dk, dv, b * h, tq, tk,
                        scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
