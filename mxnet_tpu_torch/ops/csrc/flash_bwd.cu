// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py::_flash_bwd_dq_kernel (K3)
// and ::_flash_bwd_dkv_kernel (K4), both launched by
// _flash_attention_bwd_pallas. Same functions: from the forward's saved
// f32 log-sum-exp lse and D = rowsum(dO * O) (computed by the caller),
// P = exp(scale * Q K^T - lse) is rebuilt tile by tile on the visible
// pairs (top-left causal rule: key position <= query position), and
//   dS = P * (dO V^T - D),  dQ = scale * dS K,
//   dK = scale * dS^T Q,    dV = P^T dO.
// No [T, T] matrix touches device memory.
//
// Layout: q, do [BH, Tq, D]; k, v [BH, Tk, D]; lse, dcap [BH, Tq] f32;
// dq like q, dk and dv like k. All contiguous and 16-byte aligned, bf16
// or f32; D is 64 or 128 (Dv == D).
//
// Design. The TPU split is kept and no atomics are used, so results are
// deterministic: K3 runs one block per (64-query tile, b*h) and walks
// the 64-key tiles up to the causal diagonal; K4 runs one block per
// (64-key tile, b*h) and walks the 64-query tiles from the first one
// that can see its keys. Ragged Tq, Tk and Tq != Tk are zero-filled at
// the tile edges and masked.
//
// Bound: at the training path's shape [16, 8, 1024, 128] bf16 causal K3
// does three products (S, dP, dQ) over 524,800 visible pairs per head,
// 51.6 GFLOP (52.2 us at 989 TFLOP/s), against 168.8 MB read and written
// (50.4 us at 3.35 TB/s); K4 does four (S, dP, dV, dK), 68.8 GFLOP (69.6
// us) against 202.4 MB (60.4 us). Both are bounded by operations, so the
// products belong on the tensor cores.
//
// - bf16: each of the 4 warps owns 16 rows of the block's tile and runs
//   every product as mma.sync m16n8k16 (bf16 in, f32 accumulate). The
//   score tiles (S, dP, P, dS) live in registers; P and dS go straight
//   from the accumulators into the next product as its A operand, as the
//   forward feeds P. K4 computes the transposed products (S^T = K Q^T,
//   dP^T = V dO^T) with key rows as the M dimension, so P^T and dS^T sit
//   in the A layout of dV += P^T dO and dK += dS^T Q; lse and D are then
//   indexed along columns. Register pressure: K4 holds the dK and dV
//   accumulators (2 x 16 x D f32 per warp, 128 registers a thread at
//   D = 128), so the K and V fragments are reloaded from shared memory
//   at each k-step rather than kept in registers, dP^T is formed 16
//   queries (one k-step of the dK product) at a time, and at D = 128
//   the query tile is 32 rows (64 spilled: 255 registers). The operands that
//   are not inputs (P, dS) each go into their product as two bf16 terms
//   (hi + lo, ~16 mantissa bits, as in the forward) at the cost of a
//   second mma: single terms doubled the error.
// - f32: full f32 precision forbids the bf16 tensor cores, so the
//   products run as f32 FMA on the CUDA cores: 128 threads as a 16 x 8
//   grid, each owning 4 rows x 8 columns of the score tile and 4 rows x
//   D/8 columns of the outputs, with all tiles staged in shared memory.
//
// Not yet done: cp.async or TMA double buffering, wgmma, ldmatrix.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlock = 64;   // rows of a query or key tile
constexpr int kThreads = 128;

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) = hi + lo with hi, lo bf16 pairs
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
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

// Rows [r0, r0 + R) of a row-major [n, D] matrix into dst[R][LD], rows
// past n zero (consecutive threads on consecutive 16-byte vectors).
template <int D, int LD, int R = kBlock>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int r0, int n) {
  constexpr int kVec = D / 8;
  for (int idx = threadIdx.x; idx < R * kVec; idx += kThreads) {
    const int r = idx / kVec, c = (idx % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// The same rows transposed into dst[D][LDT] (consecutive threads on
// consecutive rows, so the 2-byte stores of one instruction hit distinct
// banks).
template <int D, int LDT, int R = kBlock>
__device__ __forceinline__ void stage_cols(bf16* dst, const bf16* src,
                                           int r0, int n) {
  constexpr int kVec = D / 8;
  for (int idx = threadIdx.x; idx < R * kVec; idx += kThreads) {
    const int r = idx % R, c = (idx / R) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(c + i) * LDT + r] = e[i];
  }
}

// A operand of the k-step at columns [c0, c0 + 16) of a 16-row tile
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* base,
                                       int ld, int c0, int g, int tg) {
  a[0] = ld_pair(base + g * ld + c0 + tg * 2);
  a[1] = ld_pair(base + (g + 8) * ld + c0 + tg * 2);
  a[2] = ld_pair(base + g * ld + c0 + 8 + tg * 2);
  a[3] = ld_pair(base + (g + 8) * ld + c0 + 8 + tg * 2);
}

// B operand B[k][n] = m[n0 + n][c0 + k] of a row-major tile m
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* m, int ld, int n0,
                                       int c0, int g, int tg) {
  const bf16* p = m + (n0 + g) * ld + c0 + tg * 2;
  b0 = ld_pair(p);
  b1 = ld_pair(p + 8);
}

// The accumulators of two 8-column n-tiles as the A operand of one
// 16-deep k-step, split into hi and the remainder lo.
__device__ __forceinline__ void acc_to_a(const float t0[4],
                                         const float t1[4], uint32_t hi[4],
                                         uint32_t lo[4]) {
  split_bf16(t0[0], t0[1], hi[0], lo[0]);
  split_bf16(t0[2], t0[3], hi[1], lo[1]);
  split_bf16(t1[0], t1[1], hi[2], lo[2]);
  split_bf16(t1[2], t1[3], hi[3], lo[3]);
}

// c += (hi + lo) * B
__device__ __forceinline__ void mma_acc(float c[4], const uint32_t hi[4],
                                        const uint32_t lo[4], uint32_t b0,
                                        uint32_t b1) {
  mma_bf16(c, hi, b0, b1);
  mma_bf16(c, lo, b0, b1);
}

template <int D>
constexpr size_t dq_smem_bf16() {
  // Q, dO, K, V tiles [64][D + 8] and K^T [D][64 + 8]
  return sizeof(bf16) * (4 * kBlock * (D + 8) + D * (kBlock + 8));
}

// K3: dQ for one 64-query tile.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ dcap, bf16* __restrict__ dq,
                  int tq, int tk, float scale, int causal) {
  constexpr int LD = D + 8;
  constexpr int LDT = kBlock + 8;
  constexpr int kSteps = D / 16;    // k-steps of the S and dP products
  constexpr int kNT = kBlock / 8;   // 8-key n-tiles of the score tile
  constexpr int kDT = D / 8;        // 8-column n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kBlock * LD;
  bf16* ks = dos + kBlock * LD;
  bf16* vs = ks + kBlock * LD;
  bf16* kt = vs + kBlock * LD;

  const int bh = blockIdx.y;
  // last query tile first: under the causal mask it walks the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlock;
  const size_t qoff = (size_t)bh * tq * D, koff = (size_t)bh * tk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;

  stage_rows<D, LD>(qs, q + qoff, q0, tq);
  stage_rows<D, LD>(dos, dout + qoff, q0, tq);
  // rows past tq read lse = D = 0; their dQ is never written
  const float l0 = row0 < tq ? lse[(size_t)bh * tq + row0] : 0.f;
  const float l1 = row1 < tq ? lse[(size_t)bh * tq + row1] : 0.f;
  const float c0 = row0 < tq ? dcap[(size_t)bh * tq + row0] : 0.f;
  const float c1 = row1 < tq ? dcap[(size_t)bh * tq + row1] : 0.f;
  const bf16* qw = qs + warp * 16 * LD;
  const bf16* dow = dos + warp * 16 * LD;

  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int n_k = (tk + kBlock - 1) / kBlock;
  int upper = n_k;
  if (causal) {
    const int u = (q0 + kBlock - 1) / kBlock + 1;
    upper = u < n_k ? u : n_k;
  }

  for (int t = 0; t < upper; ++t) {
    const int k0 = t * kBlock;
    __syncthreads();  // the previous tile's reads are done
    stage_rows<D, LD>(ks, k + koff, k0, tk);
    stage_rows<D, LD>(vs, v + koff, k0, tk);
    stage_cols<D, LDT>(kt, k + koff, k0, tk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      uint32_t aq[4], ad[4];
      load_a(aq, qw, LD, st * 16, g, tg);
      load_a(ad, dow, LD, st * 16, g, tg);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, ks, LD, n * 8, st * 16, g, tg);
        mma_bf16(s[n], aq, b0, b1);
        load_b(b0, b1, vs, LD, n * 8, st * 16, g, tg);
        mma_bf16(dp[n], ad, b0, b1);
      }
    }

    // P = exp(scale S - lse) on visible pairs; dS = P (dP - D), into s
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + tg * 2 + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const bool vis = col < tk && !(causal && col > row);
        const float p = vis ? expf(s[n][e] * scale - (e < 2 ? l0 : l1))
                            : 0.f;
        s[n][e] = p * (dp[n][e] - (e < 2 ? c0 : c1));
      }
    }

    // dQ += dS K: dS of key n-tiles 2j, 2j+1 is the A operand of k-step j
#pragma unroll
    for (int j = 0; j < kNT / 2; ++j) {
      uint32_t hi[4], lo[4];
      acc_to_a(s[2 * j], s[2 * j + 1], hi, lo);
#pragma unroll
      for (int dn = 0; dn < kDT; ++dn) {
        uint32_t b0, b1;
        load_b(b0, b1, kt, LDT, dn * 8, j * 16, g, tg);
        mma_acc(acc[dn], hi, lo, b0, b1);
      }
    }
  }

#pragma unroll
  for (int dn = 0; dn < kDT; ++dn) {
    const int col = dn * 8 + tg * 2;
    if (row0 < tq)
      *reinterpret_cast<__nv_bfloat162*>(dq + qoff + (size_t)row0 * D +
                                         col) =
          __floats2bfloat162_rn(acc[dn][0] * scale, acc[dn][1] * scale);
    if (row1 < tq)
      *reinterpret_cast<__nv_bfloat162*>(dq + qoff + (size_t)row1 * D +
                                         col) =
          __floats2bfloat162_rn(acc[dn][2] * scale, acc[dn][3] * scale);
  }
}

// K4's query tile: 64 rows, but 32 at D = 128, where the dK and dV
// accumulators take 128 registers a thread and a 64-query P^T tile (32
// more) made ptxas spill; the 32-query tile needs 16.
template <int D>
constexpr int kDkvRowsQ = D >= 128 ? 32 : 64;

template <int D>
constexpr size_t dkv_smem_bf16() {
  // K, V tiles [64][D + 8]; Q, dO tiles [BQ][D + 8]; Q^T and dO^T
  // [D][BQ + 8]; then the query tile's lse and D in f32
  constexpr int BQ = kDkvRowsQ<D>;
  return sizeof(bf16) * (2 * kBlock * (D + 8) + 2 * BQ * (D + 8) +
                         2 * D * (BQ + 8)) +
         sizeof(float) * 2 * BQ;
}

// K4: dK and dV for one 64-key tile.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dcap, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int tq, int tk, float scale,
                   int causal) {
  constexpr int BQ = kDkvRowsQ<D>;
  constexpr int LD = D + 8;
  constexpr int LDT = BQ + 8;
  constexpr int kSteps = D / 16;
  constexpr int kNT = BQ / 8;       // 8-query n-tiles of the score tile
  constexpr int kDT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kBlock * LD;
  bf16* qs = vs + kBlock * LD;
  bf16* dos = qs + BQ * LD;
  bf16* qt = dos + BQ * LD;
  bf16* dot = qt + D * LDT;
  float* ls = reinterpret_cast<float*>(dot + D * LDT);
  float* dcs = ls + BQ;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlock;
  const size_t qoff = (size_t)bh * tq * D, koff = (size_t)bh * tk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int krow0 = k0 + warp * 16 + g, krow1 = krow0 + 8;

  stage_rows<D, LD>(ks, k + koff, k0, tk);
  stage_rows<D, LD>(vs, v + koff, k0, tk);
  const bf16* kw = ks + warp * 16 * LD;
  const bf16* vw = vs + warp * 16 * LD;

  float dka[kDT][4], dva[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  const int n_q = (tq + BQ - 1) / BQ;
  // causal: query tiles before this key tile's first position see none
  // of its keys (a key tile at or past tq gets no query and writes zeros)
  const int lower = causal ? k0 / BQ : 0;

  for (int jt = lower; jt < n_q; ++jt) {
    const int q0 = jt * BQ;
    __syncthreads();  // the previous tile's reads are done
    stage_rows<D, LD, BQ>(qs, q + qoff, q0, tq);
    stage_rows<D, LD, BQ>(dos, dout + qoff, q0, tq);
    stage_cols<D, LDT, BQ>(qt, q + qoff, q0, tq);
    stage_cols<D, LDT, BQ>(dot, dout + qoff, q0, tq);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const bool in = q0 + i < tq;
      ls[i] = in ? lse[(size_t)bh * tq + q0 + i] : 0.f;
      dcs[i] = in ? dcap[(size_t)bh * tq + q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T: 16 keys x BQ queries per warp
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      uint32_t a[4];
      load_a(a, kw, LD, st * 16, g, tg);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, qs, LD, n * 8, st * 16, g, tg);
        mma_bf16(s[n], a, b0, b1);
      }
    }

    // P^T = exp(scale S^T - lse[query]) on visible pairs
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + tg * 2 + (e & 1);
        const int qpos = q0 + col;
        const int krow = e < 2 ? krow0 : krow1;
        const bool vis = qpos < tq && krow < tk && !(causal && krow > qpos);
        s[n][e] = vis ? expf(s[n][e] * scale - ls[col]) : 0.f;
      }
    }

    // dV += P^T dO
#pragma unroll
    for (int j = 0; j < kNT / 2; ++j) {
      uint32_t hi[4], lo[4];
      acc_to_a(s[2 * j], s[2 * j + 1], hi, lo);
#pragma unroll
      for (int dn = 0; dn < kDT; ++dn) {
        uint32_t b0, b1;
        load_b(b0, b1, dot, LDT, dn * 8, j * 16, g, tg);
        mma_acc(dva[dn], hi, lo, b0, b1);
      }
    }

    // dP^T = V dO^T and dS^T = P^T (dP^T - D[query]), 16 queries at a
    // time, each straight into dK += dS^T Q
#pragma unroll
    for (int j = 0; j < kNT / 2; ++j) {
      float dp[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) dp[h][0] = dp[h][1] = dp[h][2] = dp[h][3] = 0.f;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        uint32_t a[4];
        load_a(a, vw, LD, st * 16, g, tg);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t b0, b1;
          load_b(b0, b1, dos, LD, (2 * j + h) * 8, st * 16, g, tg);
          mma_bf16(dp[h], a, b0, b1);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = (2 * j + h) * 8 + tg * 2 + (e & 1);
          dp[h][e] = s[2 * j + h][e] * (dp[h][e] - dcs[col]);
        }
      }
      uint32_t hi[4], lo[4];
      acc_to_a(dp[0], dp[1], hi, lo);
#pragma unroll
      for (int dn = 0; dn < kDT; ++dn) {
        uint32_t b0, b1;
        load_b(b0, b1, qt, LDT, dn * 8, j * 16, g, tg);
        mma_acc(dka[dn], hi, lo, b0, b1);
      }
    }
  }

#pragma unroll
  for (int dn = 0; dn < kDT; ++dn) {
    const int col = dn * 8 + tg * 2;
    if (krow0 < tk) {
      const size_t o = koff + (size_t)krow0 * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + o) =
          __floats2bfloat162_rn(dka[dn][0] * scale, dka[dn][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + o) =
          __floats2bfloat162_rn(dva[dn][0], dva[dn][1]);
    }
    if (krow1 < tk) {
      const size_t o = koff + (size_t)krow1 * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + o) =
          __floats2bfloat162_rn(dka[dn][2] * scale, dka[dn][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + o) =
          __floats2bfloat162_rn(dva[dn][2], dva[dn][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA
// ---------------------------------------------------------------------------

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
cudaError_t dq_bf16(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* dcap,
                    void* dq, int bh, int tq, int tk, float scale,
                    int causal, cudaStream_t s) {
  const dim3 grid((tq + kBlock - 1) / kBlock, bh);
  return launch(flash_bwd_dq_bf16<D>, dq_smem_bf16<D>(), grid, s,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                lse, dcap, static_cast<bf16*>(dq), tq, tk, scale, causal);
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
cudaError_t dkv_bf16(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* dcap,
                     void* dk, void* dv, int bh, int tq, int tk, float scale,
                     int causal, cudaStream_t s) {
  const dim3 grid((tk + kBlock - 1) / kBlock, bh);
  return launch(flash_bwd_dkv_bf16<D>, dkv_smem_bf16<D>(), grid, s,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                lse, dcap, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                tq, tk, scale, causal);
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

// K3. Returns a cudaError_t (0 on success). is_bf16: 1 = bf16, 0 = f32.
extern "C" int mx_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* dcap, void* dq, int bh, int tq,
                               int tk, int d, float scale, int causal,
                               int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && d == 64)
    return dq_bf16<64>(q, k, v, dout, lse, dcap, dq, bh, tq, tk, scale,
                       causal, s);
  if (is_bf16 && d == 128)
    return dq_bf16<128>(q, k, v, dout, lse, dcap, dq, bh, tq, tk, scale,
                        causal, s);
  if (!is_bf16 && d == 64)
    return dq_f32<64>(q, k, v, dout, lse, dcap, dq, bh, tq, tk, scale,
                      causal, s);
  if (!is_bf16 && d == 128)
    return dq_f32<128>(q, k, v, dout, lse, dcap, dq, bh, tq, tk, scale,
                       causal, s);
  return (int)cudaErrorInvalidValue;
}

// K4. Returns a cudaError_t (0 on success). is_bf16: 1 = bf16, 0 = f32.
extern "C" int mx_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* dcap, void* dk, void* dv,
                                int bh, int tq, int tk, int d, float scale,
                                int causal, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && d == 64)
    return dkv_bf16<64>(q, k, v, dout, lse, dcap, dk, dv, bh, tq, tk,
                        scale, causal, s);
  if (is_bf16 && d == 128)
    return dkv_bf16<128>(q, k, v, dout, lse, dcap, dk, dv, bh, tq, tk,
                         scale, causal, s);
  if (!is_bf16 && d == 64)
    return dkv_f32<64>(q, k, v, dout, lse, dcap, dk, dv, bh, tq, tk, scale,
                       causal, s);
  if (!is_bf16 && d == 128)
    return dkv_f32<128>(q, k, v, dout, lse, dcap, dk, dv, bh, tq, tk,
                        scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
