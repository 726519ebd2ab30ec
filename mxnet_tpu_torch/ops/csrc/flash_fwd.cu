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

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------------------
// bf16: TMA ring, wgmma, one producer warp
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the barrier's phase of the given parity has completed; a
// wait past ~2^34 cycles (seconds) is a broken protocol, so it traps (a
// launch error) rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0)
      start = clock64();
    else if (clock64() - start > (1ll << 34))
      __trap();
  }
}

// TMA: the box {64 columns, rows, 1, 1} of a 4-d map at (column, row,
// head, batch) into shared memory, completing on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head),
      "r"(batch), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[0..32) (+)= A(smem, K-major) * B(smem, K-major), m64n64k16
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0..64) (+)= A(smem, K-major) * B(smem, K-major), m64n128k16
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0..32) += A(registers) * B(smem, MN-major), m64n64k16
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..64) += A(registers) * B(smem, MN-major), m64n128k16
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (N == 64)
    wgmma_ss_n64(d, da, db, accumulate);
  else
    wgmma_ss_n128(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == kWG) {
    // producer: one thread issues every load
    if constexpr (kWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 128 * kWG) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int c = 0; c < T::kSlabs; ++c)
        tma_load(sq + c * T::BM * 128, &tm_q, q_full, c * 64, q0, head,
                 batch);
      for (int t = 0; t < n_block; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty(s), ((t / kStages) - 1) & 1);
        const uint32_t ks = sk + s * T::kTileBytes;
        const uint32_t vs = sv + s * T::kTileBytes;
        mbar_expect_tx(full_k(s), T::kTileBytes);
        for (int c = 0; c < T::kSlabs; ++c)
          tma_load(ks + c * BN * 128, &tm_k, full_k(s), c * 64, t * BN, head,
                   batch);
        mbar_expect_tx(full_v(s), T::kTileBytes);
        for (int c = 0; c < T::kSlabs; ++c)
          tma_load(vs + c * BN * 128, &tm_v, full_v(s), c * 64, t * BN, head,
                   batch);
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
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const uint32_t off = (kd % 4) * 32;   // 16 columns = 32 bytes
      wgmma_ss<BN>(sacc,
                   smem_desc(sq_wg + (kd / 4) * T::BM * 128 + off, 16, 1024),
                   smem_desc(ks + (kd / 4) * BN * 128 + off, 16, 1024),
                   kd > 0);
    }
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

// codes the entry returns besides cudaError_t values (all below 1000)
constexpr int kErrNoEncoder = 1999;   // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 2000;      // + the CUresult of a failed encode

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (no link
// against libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 4-d bf16 map over a [b, h, t, d] view with element strides (sb, sh, st,
// 1), box {64, rows, 1, 1}, 128-byte swizzle, zero fill past each extent
int encode_map(CUtensorMap* map, const void* ptr, int b, int h, int t, int d,
               long long sb, long long sh, long long st, int rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)st * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

// the card's SM count (one query a process)
cudaError_t sm_count(int* n) {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *n = count;
  return cudaSuccess;
}

struct Operand {
  const void* ptr;
  long long sb, sh, st;
};

template <int D, int BN, int kWG, int kStages>
int launch_bf16(const Operand& q, const Operand& k, const Operand& v, void* o,
                float* lse, int b, int h, int tq, int tk, float scale,
                int causal, cudaStream_t stream) {
  using T = Tiles<D, BN, kWG, kStages>;
  CUtensorMap mq, mk, mv;
  int err = encode_map(&mq, q.ptr, b, h, tq, D, q.sb, q.sh, q.st, T::BM);
  if (!err) err = encode_map(&mk, k.ptr, b, h, tk, D, k.sb, k.sh, k.st, BN);
  if (!err) err = encode_map(&mv, v.ptr, b, h, tk, D, v.sb, v.sh, v.st, BN);
  if (err) return err;
  auto kernel = flash_fwd_bf16<D, BN, kWG, kStages>;
  // once a device and process, so that a launch under CUDA-graph
  // capture makes no attribute call
  static unsigned long long smem_set = 0;   // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !((smem_set >> dev) & 1)) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
    if (e != cudaSuccess) return e;
    if (dev < 64) smem_set |= 1ull << dev;
  }
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
