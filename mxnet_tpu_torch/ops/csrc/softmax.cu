// Row softmax for Hopper (sm_90a), plain C interface.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py::fused_softmax (body
// _softmax_kernel): y[r, :] = exp(x[r, :] - max) / sum(exp(x[r, :] - max))
// over the last axis of a contiguous [N, C] tensor, with max, exp and sum
// in f32 and y written in the input's dtype (f32, bf16 or f16). Its one
// caller is SoftmaxOutput's forward (mxnet_tpu/ops/loss.py:41-43): LeNet at
// [64, 10] f32, ResNet-50 at [128, 1000] f32.
//
// Bound: two f32 operations a byte at most, so memory bound everywhere. The
// least traffic is one read of x and one write of y (2 N C elem bytes):
// [128, 1000] f32 is 1.02 MB, 0.31 us at 3.35 TB/s; at such sizes a launch
// costs more than the bytes.
//
// Design for this card rather than the TPU grid carried over. The TPU
// kernel keeps a block of up to 256 whole rows in VMEM and falls back to
// jax.nn.softmax when a row passes 4 MB. Here there is no row limit and
// no fallback: a thread walks its share of the row once, keeping a running
// max m and sum s (the online-softmax merge: a larger value v rescales the
// sum, s = s * exp(m - v) + 1); the (m, s) pairs merge across the warp by
// shuffles and across warps through shared memory; a second pass re-reads
// the row (from L2 while it is still there) and writes exp(x - m) / s. The
// row is read twice and written once; only two floats per thread live
// across the passes, so any C fits.
//
// - Narrow rows (C <= 1024, the paths' 10 and 1000): one warp per row,
//   8 rows per 256-thread block, so a [128, 1000] problem is 16 blocks of
//   full warps rather than 128 blocks of mostly idle threads.
// - Wide rows: one 512-thread block per row.
// Loads and stores are 16 bytes a thread (4 f32 or 8 bf16/f16) over the
// 16-byte aligned body of each row; the unaligned head and the tail go
// element by element, so unaligned rows (odd C) still vectorise their body.
// The write pass vectorises when x's and y's rows share their alignment
// (always, for a fresh y and an x without a storage offset), else it goes
// element by element.
//
// exp is the accurate expf (no fast-math flag), and the division is a true
// f32 division, so the result differs from the plain f32 version only by
// summation order. Not done yet: caching a row in shared memory for a
// single read, and splitting a few huge rows across several blocks (the
// [8, 2097152] f32 check runs 8 blocks on 132 SMs).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNarrowC = 1024;
constexpr int kNarrowThreads = 256;   // 8 warps, one row each
constexpr int kWideThreads = 512;

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

// One warp per row.
template <typename T>
__global__ void __launch_bounds__(kNarrowThreads)
softmax_narrow(const T* __restrict__ x, T* __restrict__ y, long long rows,
               long long c) {
  const int lane = threadIdx.x & 31;
  const long long r =
      (long long)blockIdx.x * (kNarrowThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;   // whole warps leave together
  const T* row = x + r * c;
  float m = -INFINITY, s = 0.f;
  row_stats(row, c, lane, 32, m, s);
  warp_merge(m, s);
  row_write(row, y + r * c, c, lane, 32, m, s);
}

// One block per row.
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
int launch(const void* x, void* y, long long rows, long long c,
           cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (c <= kNarrowC) {
    const long long blocks = (rows + kNarrowThreads / 32 - 1) /
                             (kNarrowThreads / 32);
    softmax_narrow<T><<<(unsigned)blocks, kNarrowThreads, 0, st>>>(
        xp, yp, rows, c);
  } else {
    softmax_wide<T><<<(unsigned)rows, kWideThreads, 0, st>>>(xp, yp, c);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: contiguous [rows, c] device buffers of one dtype; dtype 0 f32,
// 1 bf16, 2 f16. Returns the cudaError_t of the launch.
extern "C" int mx_softmax(const void* x, void* y, long long rows, long long c,
                          int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || c < 1 || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch<float>(x, y, rows, c, st);
    case 1: return launch<__nv_bfloat16>(x, y, rows, c, st);
    case 2: return launch<__half>(x, y, rows, c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
