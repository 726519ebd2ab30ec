// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py::_flash_fwd_kernel (launched
// by _flash_attention_pallas). Same function: O = softmax(scale * Q K^T) V
// with a running row max m and sum l kept in f32, masked scores set to
// -1e30, l clamped at 1e-30, the causal mask top-left aligned (key
// position <= query position, both counted from 0, Tq != Tk allowed) and
// key tiles past the diagonal skipped; it also writes the f32
// log-sum-exp lse = m + log(l) per query row, laid out [B*H, Tq] (no
// 8-row TPU broadcast). Any Tq, Tk >= 1; D is 64 or 128 (Dv == D).
//
// Layout: q, k, v are [B, H, T, D] views read through their B, H and T
// strides (in elements; D contiguous). The bf16 path takes any view whose
// rows start 16-byte aligned with strides that are multiples of 16 bytes:
// the transformer's heads of one qkv product arrive without a copy. The
// f32 path takes contiguous tensors. o is a contiguous [B*H, Tq, D].
//
// The TPU kernel keeps a head's K/V in VMEM and walks it with a
// sequential fori_loop; here blocks run in parallel over (batch*head,
// query tile), the longest causal tiles first, and a loop inside each
// block walks the key tiles.
//
// bf16, the path of serving and training. Bound: at the training shape
// [16, 8, 1024, 128] causal the function is 34.4 GFLOP (34.8 us at the
// 989 TFLOP/s bf16 tensor rate) against 134.7 MB of Q, K, V, O and lse
// (40.2 us at 3.35 TB/s): bytes, barely. At the serving shape
// [1, 8, 2048, 128] it is 8.6 GFLOP (8.7 us) against 16.8 MB (5.0 us):
// operations. P enters P V as two bf16 terms (hi + lo, ~16 bits of P, as
// the f32 TPU kernel keeps P in f32), so the tensor cores do 1.5x the
// function's products: 52 us at the training shape. Design (Hopper's
// warp-specialised shape):
// - a producer, one thread of which loads Q once and then every key
//   tile's K and V by TMA (cp.async.bulk.tensor, 4-d tensor maps over the
//   strided views, 128-byte swizzle, rows past T zero-filled per head)
//   into a ring of kStages stages; "full" mbarriers (K and V apart) carry
//   the bytes' arrival to the consumers and "empty" ones the stage's
//   release back;
// - kWG consumer warpgroups of 64 query rows each. S = Q K^T is
//   wgmma.mma_async m64nBNk16 with A = Q and B = K from shared memory
//   (both K-major, D in 64-column slabs of 128 bytes); the online softmax
//   runs on the f32 accumulator fragments (a row's 4 lanes reduce with
//   shuffles, exp2 with scale * log2(e) folded into one FMA, the mask only
//   on tiles that cross the diagonal or Tk); O += P V is wgmma m64nDk16
//   with A = P from registers, issued twice (hi, then lo): the m64nN f32
//   accumulator layout is, pair by pair, the bf16 register-A layout of the
//   next wgmma, so P needs no shuffle; B = V straight from its TMA tile
//   through the descriptor's MN-major (transposed) mode, so nothing
//   transposes V;
// - variant 1: 2 consumer warpgroups (128 query rows) and a producer
//   warpgroup that gives its registers to them (setmaxnreg 40 / 232; with
//   a producer warp instead, the 3 warps an SM sub-partition holds get 168
//   registers a lane, and a 128-key tile spilled), 3 stages, one block an
//   SM; variant 2: 1 consumer warpgroup (64 rows) and a producer warp,
//   64-key tiles, 2 stages, two blocks an SM, for grids of fewer 128-row
//   tiles than SMs (the serving shape's 128 on 132 SMs). See
//   launch_bf16_variant for the choice.
// Measured on the H100: 0.133 ms at the training shape, so the tensor
// cores run the 51.6 GFLOP that hi + lo make at 388 TFLOP/s, where SDPA
// runs its 34.4 GFLOP in 0.081 ms (425 TFLOP/s). Tried and left out:
// issuing each tile's S = Q K^T with the previous tile's P V and running
// the softmax under that P V (FlashAttention-3's intra-warpgroup
// pipelining), with named barriers that hand the two warpgroups' product
// issue back and forth (its ping-pong). With a branch between a wgmma's
// issue and its wait, ptxas serialised the wgmma (C7518) and it took
// 0.164-0.190 ms; without, 0.1337-0.1344 ms against 0.1328, and 4% less
// at the serving shape (0.0388 against 0.0404 ms): no gain worth its
// code. Not yet tried: a persistent grid, pairing a long causal query
// tile with a short one, O stored through shared memory by TMA rather
// than 4-byte stores.
//
// f32: full f32 precision forbids the bf16 tensor-core path, so the
// products run as f32 FMA on the CUDA cores (67 TFLOP/s peak): 128
// threads as a 16 x 8 grid, each owning 4 query rows x 8 key columns of
// the score tile and the same 4 rows x D/8 output columns, with Q (pre-
// scaled), K, V and P staged in f32 in shared memory.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------------------
// bf16: TMA ring, wgmma, warp-specialised
// ---------------------------------------------------------------------------

template <int D, int BN, int kWG, int kStages>
struct Tiles {
  static constexpr int kSlabs = D / 64;    // 128-byte column slabs of a row
  static constexpr int BM = 64 * kWG;      // query rows of a block
  // two consumer warpgroups take a whole producer warpgroup, so that
  // setmaxnreg can move its registers to them; one takes a single warp
  static constexpr int kProducerThreads = kWG == 2 ? 128 : 32;
  static constexpr int kThreads = 128 * kWG + kProducerThreads;
  static constexpr uint32_t kQBytes = BM * D * 2;
  static constexpr uint32_t kTileBytes = BN * D * 2;   // one K or V tile
  // Q, the K ring, the V ring (each slab 1024-byte aligned for the
  // swizzle), then q_full, full_k[], full_v[], empty[]; 1024 to align
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kTileBytes + 8 * (1 + 3 * kStages);
};

template <int D, int BN, int kWG, int kStages>
__global__ void __launch_bounds__(Tiles<D, BN, kWG, kStages>::kThreads,
                                  kWG == 1 ? 2 : 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
               int heads, int tq, int tk, float scale_log2, int causal) {
  using T = Tiles<D, BN, kWG, kStages>;
  static_assert(BN == 64 || BN == 128, "key tile of 64 or 128");
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + T::kQBytes;              // + stage * kTileBytes
  const uint32_t sv = sk + kStages * T::kTileBytes;
  const uint32_t q_full = sv + kStages * T::kTileBytes;
  auto full_k = [&](int s) { return q_full + 8u * (1 + s); };
  auto full_v = [&](int s) { return q_full + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + 2 * kStages + s); };

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
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
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
      mbar_expect_tx(q_full, T::kQBytes);
      tma_rows<T::kSlabs>(sq, &tm_q, q_full, T::BM, q0, head, batch);
      for (int t = 0; t < n_block; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty(s), ((t / kStages) - 1) & 1);
        const uint32_t ks = sk + s * T::kTileBytes;
        const uint32_t vs = sv + s * T::kTileBytes;
        mbar_expect_tx(full_k(s), T::kTileBytes);
        tma_rows<T::kSlabs>(ks, &tm_k, full_k(s), BN, t * BN, head, batch);
        mbar_expect_tx(full_v(s), T::kTileBytes);
        tma_rows<T::kSlabs>(vs, &tm_v, full_v(s), BN, t * BN, head, batch);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows r0 .. r0 + 63. With two, each SM
  // sub-partition holds one producer and two consumer warps: 40 + 2 * 232
  // registers a lane fill its 16384.
  if constexpr (kWG == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int r0 = q0 + wg * 64;
  const int n_mine = r0 < tq ? tiles_upto(min(r0 + 64, tq) - 1) : 0;
  const int row0 = r0 + warp * 16 + g, row1 = row0 + 8;   // this lane's rows

  // m64nD f32 accumulator: element 4n + 2i + j is (row_i, 8n + 2tg + j)
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  // running max (log2 domain, scaled) and this lane's share of the sum
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const uint32_t sq_wg = sq + wg * 64 * 128;

  auto stage = [](int t) { return t % kStages; };
  auto parity = [](int t) { return static_cast<uint32_t>((t / kStages) & 1); };

  // S = Q K^T (raw dot products, 64 x BN) of key tile t, issued
  float sacc[BN / 2];
  auto issue_s = [&](int t) {
    const uint32_t ks = sk + stage(t) * T::kTileBytes;
    fence_regs<BN / 2>(sacc);
    wgmma_fence();
    wgmma_abt<BN, D>(sacc, sq_wg, T::BM, ks, BN);
    wgmma_commit();
  };

  // P as the register-A fragments of P V's 16-key steps: the S
  // accumulators of key columns 16kk .. 16kk + 15 in A's order, as
  // P = hi + lo bf16 pairs (one bf16 term would cost up to 2^-9 of |v|)
  uint32_t phi[BN / 16][4], plo[BN / 16][4];
  auto split_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1],
                   phi[kk][r], plo[kk][r]);
  };

  // O += P V of key tile t, issued; V [keys, D] is read MN-major: 8-key
  // groups 1024 bytes apart, D's 64-column slabs BN * 128 bytes apart
  auto issue_pv = [&](int t) {
    const uint32_t vs = sv + stage(t) * T::kTileBytes;
    fence_regs<D / 2>(oacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t dv = smem_desc(vs + kk * 16 * 128, BN * 128, 1024);
      wgmma_rs<D>(oacc, phi[kk], dv);
      wgmma_rs<D>(oacc, plo[kk], dv);
    }
    wgmma_commit();
  };

  // tiles from first_masked on cross the diagonal or Tk
  const int first_masked =
      min(causal ? (r0 + 1) / BN : n_k, tk / BN);

  // with mask, set tile t's scores past the diagonal or Tk to -1e30; then
  // turn them into p = 2^(S * scale*log2e - m) with the new running max
  // m; returns alpha = 2^(m_old - m) for each row
  auto softmax = [&](int t, bool mask, float& a0, float& a1) {
    const int k0 = t * BN;
    if (mask) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + n * 8 + tg * 2 + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (col >= tk || (causal && col > row)) sacc[4 * n + e] = kNeg;
        }
    }
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sacc[4 * n], sacc[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[4 * n + 2], sacc[4 * n + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0 * scale_log2);
    const float mn1 = fmaxf(m1, mx1 * scale_log2);
    a0 = ex2(m0 - mn0);
    a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      sacc[4 * n] = ex2(fmaf(sacc[4 * n], scale_log2, -mn0));
      sacc[4 * n + 1] = ex2(fmaf(sacc[4 * n + 1], scale_log2, -mn0));
      sacc[4 * n + 2] = ex2(fmaf(sacc[4 * n + 2], scale_log2, -mn1));
      sacc[4 * n + 3] = ex2(fmaf(sacc[4 * n + 3], scale_log2, -mn1));
      rs0 += sacc[4 * n] + sacc[4 * n + 1];
      rs1 += sacc[4 * n + 2] + sacc[4 * n + 3];
    }
    l0 = l0 * a0 + rs0;   // the 4 lanes of a row sum their shares at the end
    l1 = l1 * a1 + rs1;
  };

  auto rescale_o = [&](float a0, float a1) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      oacc[4 * n] *= a0;
      oacc[4 * n + 1] *= a0;
      oacc[4 * n + 2] *= a1;
      oacc[4 * n + 3] *= a1;
    }
  };

  // Each tile: S = Q K^T, softmax, O += P V; the two warpgroups of a
  // block (and the two blocks of an SM with one) fill each other's gaps
  // on the tensor cores.
  if (n_mine > 0) mbar_wait(q_full, 0);
  for (int t = 0; t < n_block; ++t) {
    if (t >= n_mine) {
      // past this warpgroup's diagonal: release the stage in turn
      // (waiting for its load keeps the arrivals in the stage's phase)
      mbar_wait(full_v(stage(t)), parity(t));
      mbar_arrive(empty(stage(t)));
      continue;
    }
    float a0, a1;
    mbar_wait(full_k(stage(t)), parity(t));
    issue_s(t);
    wgmma_wait<0>();
    fence_regs<BN / 2>(sacc);
    softmax(t, t >= first_masked, a0, a1);
    split_p();
    rescale_o(a0, a1);
    mbar_wait(full_v(stage(t)), parity(t));
    issue_pv(t);
    wgmma_wait<0>();
    fence_regs<D / 2>(oacc);
    mbar_arrive(empty(stage(t)));
  }
  if (n_mine == 0) return;

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float li0 = fmaxf(l0, 1e-30f), li1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / li0, inv1 = 1.f / li1;
  __nv_bfloat16* o0 = o + ((size_t)bh * tq + row0) * D;
  __nv_bfloat16* o1 = o + ((size_t)bh * tq + row1) * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + tg * 2;
    if (row0 < tq)
      *reinterpret_cast<__nv_bfloat162*>(o0 + col) = __floats2bfloat162_rn(
          oacc[4 * n] * inv0, oacc[4 * n + 1] * inv0);
    if (row1 < tq)
      *reinterpret_cast<__nv_bfloat162*>(o1 + col) = __floats2bfloat162_rn(
          oacc[4 * n + 2] * inv1, oacc[4 * n + 3] * inv1);
  }
  if (tg == 0) {
    // m is max(S) * scale * log2(e): m * ln 2 is the natural-log max
    constexpr float kLn2 = 0.6931471805599453f;
    if (row0 < tq) lse[(size_t)bh * tq + row0] = m0 * kLn2 + logf(li0);
    if (row1 < tq) lse[(size_t)bh * tq + row1] = m1 * kLn2 + logf(li1);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;

constexpr int kRowsPerThread = 4;   // kBlockQ / 16
constexpr int kColsPerThread = 8;   // kBlockK / 8

template <int D>
constexpr size_t smem_bytes_f32() {
  // qs and ks padded rows, vs dense rows, ps padded rows
  return sizeof(float) * (kBlockQ * (D + 1) + kBlockK * (D + 1) +
                          kBlockK * D + kBlockQ * (kBlockK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int tq, int tk, float scale,
              int causal) {
  constexpr int LD = D + 1;
  constexpr int LDP = kBlockK + 1;
  constexpr int kOutCols = D / 8;
  extern __shared__ float smem[];
  float* qs = smem;                   // [kBlockQ][LD]
  float* ks = qs + kBlockQ * LD;      // [kBlockK][LD]
  float* vs = ks + kBlockK * LD;      // [kBlockK][D]
  float* ps = vs + kBlockK * D;       // [kBlockQ][LDP]

  const int bh = blockIdx.y;
  // last query tile first: under the causal mask it has the most key
  // tiles, so the long blocks start before the short ones
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const float* qb = q + (size_t)bh * tq * D;
  const float* kb = k + (size_t)bh * tk * D;
  const float* vb = v + (size_t)bh * tk * D;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // 0..15: rows ty*4 .. ty*4+3
  const int tx = tid & 7;   // 0..7: key columns tx + 8*j, out columns tx + 8*j

  // Q tile, pre-scaled in f32 (rows past tq are zero)
  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int gr = q0 + r;
    qs[r * LD + c] = gr < tq ? qb[(size_t)gr * D + c] * scale : 0.f;
  }

  float acc[kRowsPerThread][kOutCols];
  float m[kRowsPerThread], l[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) acc[i][j] = 0.f;
  }

  const int n_k = (tk + kBlockK - 1) / kBlockK;
  int upper = n_k;
  if (causal) {
    // only key tiles whose start can be <= the tile's last query row
    const int u = (q0 + kBlockQ - 1) / kBlockK + 1;
    upper = u < n_k ? u : n_k;
  }

  for (int t = 0; t < upper; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile's K/V/P reads are done
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int gr = k0 + r;
      const bool in = gr < tk;
      ks[r * LD + c] = in ? kb[(size_t)gr * D + c] : 0.f;
      vs[r * D + c] = in ? vb[(size_t)gr * D + c] : 0.f;
    }
    __syncthreads();

    // S = (scale Q) K^T for this thread's 4 x 8 entries
    float s[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRowsPerThread], kv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = qs[(ty * kRowsPerThread + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        kv[j] = ks[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, online softmax update, P to shared memory
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty * kRowsPerThread + i;
      const int qpos = q0 + r;
      float mt = kNeg;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int kpos = k0 + tx + 8 * j;
        if (kpos >= tk || (causal && kpos > qpos)) s[i][j] = kNeg;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[r * LDP + tx + 8 * j] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V for this thread's 4 rows x D/8 columns
#pragma unroll 2
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = ps[(ty * kRowsPerThread + i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) {
        const float vv = vs[kk * D + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int gr = q0 + ty * kRowsPerThread + i;
    if (gr >= tq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / li;
    float* orow = o + ((size_t)bh * tq + gr) * D;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) orow[tx + 8 * j] = acc[i][j] * inv;
    if (tx == 0) lse[(size_t)bh * tq + gr] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int D, int BN, int kWG, int kStages>
int launch_bf16(const Operand& q, const Operand& k, const Operand& v, void* o,
                float* lse, int b, int h, int tq, int tk, float scale,
                int causal, cudaStream_t stream) {
  using T = Tiles<D, BN, kWG, kStages>;
  CUtensorMap mq, mk, mv;
  int err = encode_map(&mq, q, b, h, tq, D, T::BM);
  if (!err) err = encode_map(&mk, k, b, h, tk, D, BN);
  if (!err) err = encode_map(&mv, v, b, h, tk, D, BN);
  if (err) return err;
  constexpr auto kernel = flash_fwd_bf16<D, BN, kWG, kStages>;
  const cudaError_t e = allow_smem<kernel>(T::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid(b * h, (tq + T::BM - 1) / T::BM);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, h, tq, tk,
      scale * 1.4426950408889634f, causal);
  return cudaGetLastError();
}

// variant 1: two consumer warpgroups (128 query rows a block, one block an
// SM), 3 stages, 64-key tiles at D = 128 and 128-key tiles at D = 64;
// variant 2: one warpgroup (64 rows, two blocks an SM), 64-key tiles, 2
// stages. 0 picks 1 wherever the grid has at least as many 128-row tiles
// as the card has SMs, else 2. Device times on the H100 (CUDA graphs):
// at the training shape's 1024 tiles 1 takes 0.1325 ms and 2 0.1439; at
// the serving shape's 128 on 132 SMs 2 takes 0.0413 and 1 0.0462; at
// [2, 4, 2000, 64] (128 tiles) 2 takes 0.0317 and 1 0.0338.
template <int D>
int launch_bf16_variant(int variant, const Operand& q, const Operand& k,
                        const Operand& v, void* o, float* lse, int b, int h,
                        int tq, int tk, float scale, int causal,
                        cudaStream_t stream) {
  if (variant == 0) {
    int sms = 0;
    const cudaError_t e = sm_count(&sms);
    if (e != cudaSuccess) return e;
    variant = (long long)b * h * ((tq + 127) / 128) >= sms ? 1 : 2;
  }
  if (variant == 1)
    return launch_bf16<D, D == 64 ? 128 : 64, 2, 3>(
        q, k, v, o, lse, b, h, tq, tk, scale, causal, stream);
  if (variant == 2)
    return launch_bf16<D, 64, 1, 2>(q, k, v, o, lse, b, h, tq, tk, scale,
                                    causal, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename Kernel>
cudaError_t launch_f32(Kernel kernel, size_t smem, const void* q,
                       const void* k, const void* v, void* o, float* lse,
                       int bh, int tq, int tk, float scale, int causal,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + kBlockQ - 1) / kBlockQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, tq, tk,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: [b, h, T, d] with element strides (s*b, s*h, s*t, 1); bf16
// views need 16-byte aligned rows and strides of 16-byte multiples, f32
// tensors must be contiguous. o: contiguous [b*h, tq, d] like q; lse: f32
// [b*h, tq]. is_bf16: 1 = bf16, 0 = f32. variant (bf16 only): 0 = chosen
// by the grid's size, 1 = 128-row blocks, 2 = 64-row blocks. Returns a
// cudaError_t (0 on success), 1999 when libcuda's tensor-map encoder
// cannot be found, or 2000 + the CUresult of a failed encode.
extern "C" int mx_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, float* lse, int b, int h, int tq,
                            int tk, int d, long long sqb, long long sqh,
                            long long sqt, long long skb, long long skh,
                            long long skt, long long svb, long long svh,
                            long long svt, float scale, int causal,
                            int is_bf16, int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const Operand oq{q, sqb, sqh, sqt}, ok{k, skb, skh, skt},
        ov{v, svb, svh, svt};
    if (d == 64)
      return launch_bf16_variant<64>(variant, oq, ok, ov, o, lse, b, h, tq,
                                     tk, scale, causal, s);
    if (d == 128)
      return launch_bf16_variant<128>(variant, oq, ok, ov, o, lse, b, h, tq,
                                      tk, scale, causal, s);
    return (int)cudaErrorInvalidValue;
  }
  if (d == 64)
    return launch_f32(flash_fwd_f32<64>, smem_bytes_f32<64>(), q, k, v, o,
                      lse, b * h, tq, tk, scale, causal, s);
  if (d == 128)
    return launch_f32(flash_fwd_f32<128>, smem_bytes_f32<128>(), q, k, v, o,
                      lse, b * h, tq, tk, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
