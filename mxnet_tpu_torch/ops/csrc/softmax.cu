// Row softmax for Hopper (sm_90a), plain C interface.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py::fused_softmax (body
// _softmax_kernel): y[r, :] = exp(x[r, :] - max) / sum(exp(x[r, :] - max))
// over the last axis of a contiguous [N, C] tensor, with max, exp and sum
// in f32 and y written in the input's dtype (f32, bf16 or f16). Its one
// caller is SoftmaxOutput's forward (mxnet_tpu/ops/loss.py:41-43): LeNet at
// [64, 10] f32, ResNet-50 at [128, 1000] f32.
//
// Bound: five f32 operations an element, so memory bound everywhere. The
// least traffic is one read of x and one write of y (2 N C elem bytes):
// [128, 1000] f32 is 1.02 MB, 0.31 us at 3.35 TB/s; at such sizes the
// launch and one round trip to memory cost more than the bytes, so what
// counts is the chain of dependent steps a row waits on.
//
// Design: the row is read once, into registers, and every thread issues
// all its loads before it uses any. Then the max (fmaxf over the
// registers, shuffles within the row's threads, shared memory across
// warps), the sum of exp(x - max) (kept in registers where they fit), the
// write of exp(x - max) / sum from the registers. No per-element
// rescaling. One variant a tier of row width (the `variant` argument;
// ops/softmax.py `variant` picks the first that holds the row, from its
// capacity table), each spreading rows over the SMs:
//   id  threads a row  slots a thread          row capacity (f32; bf16/f16)
//   1   8 lanes        4 scalars               C <= 32
//   2   a warp         8 16-byte vectors       C/v <= 256  (1024; 2048)
//   3   512 threads    8 vectors               C/v <= 4096 (16384; 32768)
//   0   512 threads    two passes, online      any C
// (v = elements a 16-byte vector: 4 f32, 8 bf16/f16.) Variant 1 holds 16
// rows in a block of 128 threads, 2 two warps (two rows), 3 one row a
// block. [64, 10] f32 runs variant 1 on 4 blocks (8 lanes a row ran
// faster than 4 on the H100); [128, 1000] f32 variant 2 on 64 blocks;
// [4096, 32000] bf16 variant 3, 4096 blocks of a row each. In 3 the
// 16-bit types keep the raw vectors and take exp again for the write
// rather than hold 8 f32 values a vector in registers. Variant 0 is the
// former kernel: a thread walks its share of the row keeping a running
// (max, sum), the pairs merge across the block, a second pass re-reads
// the row and writes; only two floats a thread live across the passes,
// so any C fits ([8, 2097152] f32). Narrower variants for the widths
// between (4 lanes a row; a warp with 1-4 vectors a lane; 256 threads a
// row) were built and left out: no path sends those widths, and no
// reading on the H100 showed one beating the next wider variant.
//
// Vector variants read the 16-byte aligned body of each row as vectors;
// the unaligned head and the tail (fewer than 2v elements in all) are one
// scalar slot of the first threads. The write vectorises when x's and
// y's rows share their alignment, else it writes element by element from
// the same registers. Slots past the row hold -inf: exp(-inf - max) is 0,
// and a row of -inf gives NaN as the plain version does (-inf - -inf).
//
// exp is the accurate expf (no fast-math flag), and the division is a true
// f32 division, so the result differs from the plain f32 version only by
// summation order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWideThreads = 512;   // variants 0 and 3
constexpr int kLanes = 8, kLaneSlots = 4;   // variant 1
constexpr int kVecSlots = 8;                // variants 2 and 3

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

// A 16-byte vector <-> its kVec elements as f32, through the 32-bit words
// (no array of T behind a cast, which put the 16-bit variants' vector in
// local memory).
__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) {
  return (uint32_t)__bfloat16_as_ushort(v);
}
__device__ __forceinline__ uint32_t bits(__half v) {
  return (uint32_t)__half_as_ushort(v);
}

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  static constexpr uint32_t kNegInf = 0xff800000u;   // a word of -inf
  __device__ static void load(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 store(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  static constexpr uint32_t kNegInf = 0xff80ff80u;
  __device__ static void load(const uint4& u, float (&f)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = lo_bf16(w[i]);
      f[2 * i + 1] = hi_bf16(w[i]);
    }
  }
  __device__ static uint32_t pack(float a, float b) {
    return bits(__float2bfloat16(a)) | (bits(__float2bfloat16(b)) << 16);
  }
  __device__ static uint4 store(const float (&f)[8]) {
    return make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]),
                      pack(f[6], f[7]));
  }
};
template <> struct Vec<__half> {
  static constexpr int n = 8;
  static constexpr uint32_t kNegInf = 0xfc00fc00u;
  __device__ static void load(const uint4& u, float (&f)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu)));
      f[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
    }
  }
  __device__ static uint32_t pack(float a, float b) {
    return bits(__float2half(a)) | (bits(__float2half(b)) << 16);
  }
  __device__ static uint4 store(const float (&f)[8]) {
    return make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]),
                      pack(f[6], f[7]));
  }
};

// Fold one value into the running (m, s): s holds sum exp(x - m).
__device__ __forceinline__ void push(float v, float& m, float& s) {
  if (v > m) {
    s = s * expf(m - v) + 1.f;   // m = -inf gives s * 0 + 1
    m = v;
  } else if (v != -INFINITY) {
    s += expf(v - m);            // NaN stays NaN through the sum
  }
}

// Merge another (m2, s2) into (m, s).
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mn = fmaxf(m, m2);
  const float a = (m == -INFINITY) ? 0.f : s * expf(m - mn);
  const float b = (m2 == -INFINITY) ? 0.f : s2 * expf(m2 - mn);
  m = mn;
  s = a + b;
}

__device__ __forceinline__ void warp_merge(float& m, float& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
}

// Elements before the first 16-byte boundary of p (at most c).
template <typename T>
__device__ __forceinline__ long long head_len(const T* p, long long c) {
  const long long h =
      (long long)((16u - ((uintptr_t)p & 15u)) & 15u) / (long long)sizeof(T);
  return h < c ? h : c;
}

// Pass 1 over one row by threads [tid, tid + n, ...): running (m, s).
template <typename T>
__device__ void row_stats(const T* row, long long c, int tid, int n,
                          float& m, float& s) {
  constexpr int kVec = Vec<T>::n;
  const long long head = head_len(row, c);
  for (long long i = tid; i < head; i += n) push(to_f(row[i]), m, s);
  const long long nvec = (c - head) / kVec;
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  for (long long j = tid; j < nvec; j += n) {
    float f[kVec];
    Vec<T>::load(body[j], f);
#pragma unroll
    for (int k = 0; k < kVec; ++k) push(f[k], m, s);
  }
  for (long long i = head + nvec * kVec + tid; i < c; i += n)
    push(to_f(row[i]), m, s);
}

// Pass 2: y = exp(x - m) / s.
template <typename T>
__device__ void row_write(const T* row, T* out, long long c, int tid, int n,
                          float m, float s) {
  constexpr int kVec = Vec<T>::n;
  if ((((uintptr_t)row ^ (uintptr_t)out) & 15u) != 0) {
    for (long long i = tid; i < c; i += n)
      out[i] = from_f<T>(expf(to_f(row[i]) - m) / s);
    return;
  }
  const long long head = head_len(row, c);
  for (long long i = tid; i < head; i += n)
    out[i] = from_f<T>(expf(to_f(row[i]) - m) / s);
  const long long nvec = (c - head) / kVec;
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  uint4* obody = reinterpret_cast<uint4*>(out + head);
  for (long long j = tid; j < nvec; j += n) {
    float f[kVec];
    Vec<T>::load(body[j], f);
#pragma unroll
    for (int k = 0; k < kVec; ++k) f[k] = expf(f[k] - m) / s;
    obody[j] = Vec<T>::store(f);
  }
  for (long long i = head + nvec * kVec + tid; i < c; i += n)
    out[i] = from_f<T>(expf(to_f(row[i]) - m) / s);
}

// Max and sum over the G threads of a row: G-aligned lanes of one warp.
template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ... and over a block of kThreads threads that holds one row: each warp's
// value through shared memory, every thread folding them in warp order
template <int kThreads, bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* sh) {
  v = kMax ? group_max<32>(v) : group_sum<32>(v);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = sh[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i)
    r = kMax ? fmaxf(r, sh[i]) : r + sh[i];
  return r;
}

// Variant 1: G lanes a row, S scalar slots a lane (element lane + G *
// slot), 128 threads a block. Groups past the last row keep to
// the shuffles and store nothing.
template <typename T, int G, int S>
__global__ void __launch_bounds__(128, 1)
softmax_small(const T* __restrict__ x, T* __restrict__ y, long long rows,
              int c) {
  const int t = threadIdx.x % G;
  const long long r = (long long)blockIdx.x * (128 / G) + threadIdx.x / G;
  const bool live = r < rows;
  const T* row = x + r * c;
  float v[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = t + s * G;
    v[s] = live && i < c ? to_f(row[i]) : -INFINITY;
  }
  float m = v[0];
#pragma unroll
  for (int s = 1; s < S; ++s) m = fmaxf(m, v[s]);
  m = group_max<G>(m);
  float sum = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    v[s] = expf(v[s] - m);
    sum += v[s];
  }
  sum = group_sum<G>(sum);
  if (!live) return;
  T* out = y + r * c;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = t + s * G;
    if (i < c) out[i] = from_f<T>(v[s] / sum);
  }
}

// Variants 2 and 3: G threads a row (a warp, or the whole block of
// kThreads), S 16-byte vectors of the row's aligned body a thread (vector
// t + G * slot) and one scalar slot for the head and tail. kReexp: take
// exp again for the write rather than keep S * v f32 values.
template <typename T, int G, int S, int kThreads, bool kReexp>
__global__ void __launch_bounds__(kThreads, 1)
softmax_rows(const T* __restrict__ x, T* __restrict__ y, long long rows,
             long long c) {
  using V = Vec<T>;
  constexpr int kVec = V::n;
  constexpr bool kBlock = G > 32;
  static_assert(!kBlock || G == kThreads, "a wide row takes its block");
  __shared__ float sh_m[kBlock ? kThreads / 32 : 1];
  __shared__ float sh_s[kBlock ? kThreads / 32 : 1];
  const int t = threadIdx.x % G;
  const long long r = (long long)blockIdx.x * (kThreads / G) + threadIdx.x / G;
  if (r >= rows) return;   // whole warps leave together
  const T* row = x + r * c;
  T* out = y + r * c;
  const long long head = head_len(row, c);
  const long long nvec = (c - head) / kVec;
  const long long tail = c - head - nvec * kVec;
  const uint4* body = reinterpret_cast<const uint4*>(row + head);

  // every load first: the body's vectors, then the head or tail element
  uint4 raw[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const long long j = t + (long long)s * G;
    raw[s] = j < nvec ? body[j]
                      : make_uint4(V::kNegInf, V::kNegInf, V::kNegInf,
                                   V::kNegInf);
  }
  long long ie = -1;
  float xe = -INFINITY;
  if (t < head + tail) {
    ie = t < head ? t : head + nvec * kVec + (t - head);
    xe = to_f(row[ie]);
  }

  float m = xe;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    float f[kVec];
    V::load(raw[s], f);
#pragma unroll
    for (int k = 0; k < kVec; ++k) m = fmaxf(m, f[k]);
  }
  m = kBlock ? block_reduce<kThreads, true>(m, sh_m) : group_max<G>(m);

  float e[kReexp ? 1 : S][kVec];
  const float ee = expf(xe - m);
  float sum = ee;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    float f[kVec];
    V::load(raw[s], f);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float q = expf(f[k] - m);
      sum += q;
      if constexpr (!kReexp) e[s][k] = q;
    }
  }
  sum = kBlock ? block_reduce<kThreads, false>(sum, sh_s) : group_sum<G>(sum);

  if (ie >= 0) out[ie] = from_f<T>(ee / sum);
  const bool vec_out = (((uintptr_t)row ^ (uintptr_t)out) & 15u) == 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const long long j = t + (long long)s * G;
    if (j >= nvec) continue;
    float f[kVec];
    if constexpr (kReexp) {
      V::load(raw[s], f);
#pragma unroll
      for (int k = 0; k < kVec; ++k) f[k] = expf(f[k] - m) / sum;
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) f[k] = e[s][k] / sum;
    }
    if (vec_out) {
      reinterpret_cast<uint4*>(out + head)[j] = V::store(f);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        out[head + j * kVec + k] = from_f<T>(f[k]);
    }
  }
}

// Variant 0: one block a row, two passes.
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
softmax_wide(const T* __restrict__ x, T* __restrict__ y, long long c) {
  __shared__ float sm[kWideThreads / 32];
  __shared__ float ss[kWideThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* row = x + (long long)blockIdx.x * c;
  float m = -INFINITY, s = 0.f;
  row_stats(row, c, tid, kWideThreads, m, s);
  warp_merge(m, s);
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kWideThreads / 32 ? sm[lane] : -INFINITY;
    s = lane < kWideThreads / 32 ? ss[lane] : 0.f;
    warp_merge(m, s);
    if (lane == 0) {
      sm[0] = m;
      ss[0] = s;
    }
  }
  __syncthreads();
  m = sm[0];
  s = ss[0];
  row_write(row, y + (long long)blockIdx.x * c, c, tid, kWideThreads, m, s);
}

template <typename T>
int launch(const void* x, void* y, long long rows, long long c, int variant,
           cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  constexpr bool k16 = sizeof(T) == 2;
  const long long vectors = c / Vec<T>::n;
  auto blocks = [&](long long per_block) {
    return (unsigned)((rows + per_block - 1) / per_block);
  };
  switch (variant) {
    case 1:
      if (c > kLanes * kLaneSlots) return (int)cudaErrorInvalidValue;
      softmax_small<T, kLanes, kLaneSlots><<<blocks(128 / kLanes), 128, 0,
                                             st>>>(xp, yp, rows, (int)c);
      break;
    case 2:
      if (vectors > 32 * kVecSlots) return (int)cudaErrorInvalidValue;
      softmax_rows<T, 32, kVecSlots, 64, false><<<blocks(2), 64, 0, st>>>(
          xp, yp, rows, c);
      break;
    case 3:
      if (vectors > kWideThreads * kVecSlots)
        return (int)cudaErrorInvalidValue;
      softmax_rows<T, kWideThreads, kVecSlots, kWideThreads, k16>
          <<<blocks(1), kWideThreads, 0, st>>>(xp, yp, rows, c);
      break;
    case 0:
      softmax_wide<T><<<blocks(1), kWideThreads, 0, st>>>(xp, yp, c);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: contiguous [rows, c] device buffers of one dtype; dtype 0 f32,
// 1 bf16, 2 f16; variant 0-3 from the table above (one that holds c).
// Returns the cudaError_t of the launch.
extern "C" int mx_softmax(const void* x, void* y, long long rows, long long c,
                          int dtype, int variant, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || c < 1 || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch<float>(x, y, rows, c, variant, st);
    case 1: return launch<__nv_bfloat16>(x, y, rows, c, variant, st);
    case 2: return launch<__half>(x, y, rows, c, variant, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
