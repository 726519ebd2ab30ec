// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py::_flash_fwd_kernel (launched
// by _flash_attention_pallas). Same function: O = softmax(scale * Q K^T) V
// with a running row max m and sum l kept in f32, masked scores set to
// -1e30, l clamped at 1e-30, the causal mask top-left aligned (key
// position <= query position, both counted from 0) and key tiles past the
// diagonal skipped; it also writes the f32 log-sum-exp lse = m + log(l)
// per query row, laid out [B*H, Tq] (no 8-row TPU broadcast).
//
// Layout: q [BH, Tq, D], k [BH, Tk, D], v [BH, Tk, D], o like q, all
// contiguous and 16-byte aligned, bf16 or f32; D is 64 or 128 (Dv == D).
//
// Design for this card rather than the Pallas grid carried over. The TPU
// kernel keeps the full K/V of one head in VMEM and walks it with a
// sequential fori_loop over the grid's single core. Here one CUDA block of
// 128 threads owns a tile of 64 query rows of one (batch, head); blocks
// run in parallel over (query tile, batch*head), and a loop inside the
// block walks K/V tiles of 64 rows staged in shared memory. Rows past Tq
// and keys past Tk are zero-filled and masked, so any T works.
//
// Bound: at the serving slice's shape [1, 8, 2048, 128] bf16 causal the
// work is about 8.6 GFLOP (8.7 us at the 989 TFLOP/s bf16 tensor-core
// rate) against 16.8 MB of Q/K/V/O (5.0 us at 3.35 TB/s): it is bounded
// by operations, so the products belong on the tensor cores.
//
// - bf16 (the serving path): each of the 4 warps owns 16 query rows and
//   runs both products as mma.sync m16n8k16 (bf16 in, f32 accumulate).
//   Its Q fragments stay in registers for the whole K/V walk; the score
//   tile S = Q K^T lives in registers, is scaled and masked there, and the
//   online max/sum/rescale happen there (the 4 lanes sharing a row reduce
//   with shuffles); P is split into two bf16 terms (hi + lo, keeping ~16
//   bits of it as the f32 TPU kernel keeps all of it) and fed straight
//   from the S accumulators into the P V product as its A operand, so no
//   score or probability ever touches shared or device memory. K is staged
//   row-major and V transposed in shared memory (rows padded by 8 halves
//   so the fragment loads hit distinct banks). Not yet done: cp.async or
//   TMA double buffering of the K/V tiles and wgmma.
// - f32: full f32 precision forbids the bf16 tensor-core path, so the
//   products run as f32 FMA on the CUDA cores (67 TFLOP/s peak): 128
//   threads as a 16 x 8 grid, each owning 4 query rows x 8 key columns of
//   the score tile and the same 4 rows x D/8 output columns, with Q (pre-
//   scaled), K, V and P staged in f32 in shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
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

template <int D>
constexpr size_t smem_bytes_bf16() {
  // Q and K tiles [64][D + 8], V^T tile [D][64 + 8], in bf16
  return sizeof(__nv_bfloat16) *
         (2 * kBlockQ * (D + 8) + D * (kBlockK + 8));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
               int tq, int tk, float scale, int causal) {
  constexpr int LDK = D + 8;        // halves per row of the Q and K tiles
  constexpr int LDV = kBlockK + 8;  // halves per row of the V^T tile
  constexpr int kVec = D / 8;       // 16-byte vectors per row
  constexpr int kSteps = D / 16;    // k-steps of the Q K^T product
  constexpr int kNT = kBlockK / 8;  // 8-key n-tiles of the score tile
  constexpr int kDT = D / 8;        // 8-column n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockQ * LDK;
  __nv_bfloat16* vt = ks + kBlockK * LDK;

  const int bh = blockIdx.y;
  // last query tile first: under the causal mask it has the most key
  // tiles, so the long blocks start before the short ones
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const __nv_bfloat16* qb = q + (size_t)bh * tq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * tk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * tk * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tg = lane & 3;   // fragment column pair
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  for (int idx = tid; idx < kBlockQ * kVec; idx += kThreads) {
    const int r = idx / kVec, c = (idx % kVec) * 8;
    uint4 val = zero4;
    if (q0 + r < tq)
      val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(qs + r * LDK + c) = val;
  }
  __syncthreads();
  uint32_t qf[kSteps][4];
  {
    const __nv_bfloat16* qw = qs + warp * 16 * LDK;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      qf[s][0] = ld_pair(qw + g * LDK + s * 16 + tg * 2);
      qf[s][1] = ld_pair(qw + (g + 8) * LDK + s * 16 + tg * 2);
      qf[s][2] = ld_pair(qw + g * LDK + s * 16 + 8 + tg * 2);
      qf[s][3] = ld_pair(qw + (g + 8) * LDK + s * 16 + 8 + tg * 2);
    }
  }

  float oacc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
    oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  const int row0 = q0 + warp * 16 + g;  // this lane's two query rows
  const int row1 = row0 + 8;

  const int n_k = (tk + kBlockK - 1) / kBlockK;
  int upper = n_k;
  if (causal) {
    const int u = (q0 + kBlockQ - 1) / kBlockK + 1;
    upper = u < n_k ? u : n_k;
  }

  for (int t = 0; t < upper; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile's K/V reads are done
    // K row-major (consecutive threads on consecutive vectors of a row)
    for (int idx = tid; idx < kBlockK * kVec; idx += kThreads) {
      const int r = idx / kVec, c = (idx % kVec) * 8;
      uint4 val = zero4;
      if (k0 + r < tk)
        val = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * D + c);
      *reinterpret_cast<uint4*>(ks + r * LDK + c) = val;
    }
    // V transposed (consecutive threads on consecutive rows, so the
    // scattered 2-byte stores of one instruction hit distinct banks)
    for (int idx = tid; idx < kBlockK * kVec; idx += kThreads) {
      const int r = idx % kBlockK, c = (idx / kBlockK) * 8;
      uint4 val = zero4;
      if (k0 + r < tk)
        val = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * D + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[(c + i) * LDV + r] = e[i];
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const __nv_bfloat16* kr = ks + (n * 8 + g) * LDK + st * 16 + tg * 2;
        mma_bf16(s[n], qf[st], ld_pair(kr), ld_pair(kr + 8));
      }
    }

    // scale, mask, online softmax (rows row0: s[.][0..1], row1: s[.][2..3])
    float mt0 = kNeg, mt1 = kNeg;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + tg * 2 + (e & 1);
        const int row = e < 2 ? row0 : row1;
        float x = s[n][e] * scale;
        if (col >= tk || (causal && col > row)) x = kNeg;
        s[n][e] = x;
      }
      mt0 = fmaxf(mt0, fmaxf(s[n][0], s[n][1]));
      mt1 = fmaxf(mt1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, off));
      mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, off));
    }
    const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      oacc[j][0] *= a0;
      oacc[j][1] *= a0;
      oacc[j][2] *= a1;
      oacc[j][3] *= a1;
    }

    // O += P V: the S accumulators of key n-tiles 2j, 2j+1 are exactly the
    // A fragment of the 16-key k-step j. P goes in as two bf16 terms,
    // P = hi + lo, so the product keeps ~16 mantissa bits of P as the f32
    // TPU kernel does (one bf16 term would cost up to 2^-9 of |v| in O).
#pragma unroll
    for (int j = 0; j < kNT / 2; ++j) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * j][0], s[2 * j][1], hi[0], lo[0]);
      split_bf16(s[2 * j][2], s[2 * j][3], hi[1], lo[1]);
      split_bf16(s[2 * j + 1][0], s[2 * j + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * j + 1][2], s[2 * j + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dn = 0; dn < kDT; ++dn) {
        const __nv_bfloat16* vr = vt + (dn * 8 + g) * LDV + j * 16 + tg * 2;
        const uint32_t b0 = ld_pair(vr), b1 = ld_pair(vr + 8);
        mma_bf16(oacc[dn], hi, b0, b1);
        mma_bf16(oacc[dn], lo, b0, b1);
      }
    }
  }

  const float li0 = fmaxf(l0, 1e-30f), li1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / li0, inv1 = 1.f / li1;
#pragma unroll
  for (int dn = 0; dn < kDT; ++dn) {
    const int col = dn * 8 + tg * 2;
    if (row0 < tq)
      *reinterpret_cast<__nv_bfloat162*>(
          o + ((size_t)bh * tq + row0) * D + col) =
          __floats2bfloat162_rn(oacc[dn][0] * inv0, oacc[dn][1] * inv0);
    if (row1 < tq)
      *reinterpret_cast<__nv_bfloat162*>(
          o + ((size_t)bh * tq + row1) * D + col) =
          __floats2bfloat162_rn(oacc[dn][2] * inv1, oacc[dn][3] * inv1);
  }
  if (tg == 0) {
    if (row0 < tq) lse[(size_t)bh * tq + row0] = m0 + logf(li0);
    if (row1 < tq) lse[(size_t)bh * tq + row1] = m1 + logf(li1);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA
// ---------------------------------------------------------------------------

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

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const void* q, const void* k,
                   const void* v, void* o, float* lse, int bh, int tq,
                   int tk, float scale, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + kBlockQ - 1) / kBlockQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, tq, tk, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). is_bf16: 1 = bf16, 0 = f32.
extern "C" int mx_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, float* lse, int bh, int tq, int tk,
                            int d, float scale, int causal, int is_bf16,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (is_bf16 && d == 64)
    return launch<bf16>(flash_fwd_bf16<64>, smem_bytes_bf16<64>(), q, k, v,
                        o, lse, bh, tq, tk, scale, causal, s);
  if (is_bf16 && d == 128)
    return launch<bf16>(flash_fwd_bf16<128>, smem_bytes_bf16<128>(), q, k,
                        v, o, lse, bh, tq, tk, scale, causal, s);
  if (!is_bf16 && d == 64)
    return launch<float>(flash_fwd_f32<64>, smem_bytes_f32<64>(), q, k, v,
                         o, lse, bh, tq, tk, scale, causal, s);
  if (!is_bf16 && d == 128)
    return launch<float>(flash_fwd_f32<128>, smem_bytes_f32<128>(), q, k,
                         v, o, lse, bh, tq, tk, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
