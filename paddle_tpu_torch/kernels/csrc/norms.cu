// Row layer norm (B4) and row RMS norm (B5) for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the TPU kernels of paddle_tpu/kernels/pallas/norms.py:
//   B4 _ln_pallas :68 (kernel _ln_kernel :17-27): per row, the f32 mean
//      and the f32 variance as the mean of (x - mean)^2 (never
//      E[x^2] - mean^2, which loses precision on rows with a large mean),
//      y = (x - mean) * rsqrt(var + eps), then the optional weight and
//      bias applied in f32, then ONE cast to x's dtype;
//   B5 _rms_pallas :88 (kernel _rms_kernel :30-36): per row,
//      y = x * rsqrt(mean(x^2) + eps) in f32, the optional weight applied
//      in f32, then one cast.
// The reference's gate (rows % 8 == 0 and h % 128 == 0, norms.py:132,
// :162) is a TPU tiling rule and is dropped: any n >= 1 rows and any
// width h >= 1 are taken.
//
// What bounds it on the card: bytes. Each element is read once and
// written once and costs a handful of flops, far below the ~295 flops
// per byte the H100 needs before its arithmetic is the limit, so the
// least time is (n*h*(in + out bytes) + the size of w and b) / 3.35 TB/s.
//
// Design, simple and right first:
//   * one CTA per row, of one thread per 16-byte vector of the row in
//     whole warps, at most 256 threads (so one warp for a row of up to
//     32 vectors), each thread striding over the row;
//   * 16-byte vector loads of x where its rows are 16-byte aligned (the
//     pointer and, with more than one row, the row stride say so), and
//     16-byte vector stores where out's rows are aligned too (scalar
//     stores of each vector's elements otherwise), with a scalar tail for
//     a width that is not a multiple of the vector; scalar accesses where
//     x's rows are not aligned;
//   * three passes over the row (the mean, the centred sum of squares,
//     the normalised output; RMS needs two). Only the first reads device
//     memory: the row (8 KB at h = 4096 in bf16) is then served from L1
//     and L2. f32 accumulation, warp shuffles, then one shared-memory
//     step across warps;
//   * the weight and bias are read by element in whatever float type
//     they have (a null pointer means absent: no tensor of ones or zeros
//     is made), converted to f32, applied, and the result is cast once.
// Keeping the row in registers or shared memory (one pass over device
// memory and none over L1), and several rows per CTA for narrow rows,
// are the later, faster version.
//
// The launch runs on the caller's stream, allocates nothing and does not
// synchronise; the C entry returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// dtype codes shared with the Python wrapper (kernels/norms.py)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// one element of the weight or bias, of any of the three float types
__device__ __forceinline__ float load_param(const void* p, int dtype,
                                            int i) {
  if (dtype == kBF16) return to_f(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dtype == kF16) return to_f(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) f[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) e[i] = from_f<T>(f[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// sum of v over the block (blockDim.x a multiple of 32, at most 1024);
// every thread gets the total. `sh` holds 32 floats; the leading barrier
// lets the caller reduce twice in a row through the same buffer.
__device__ __forceinline__ float block_sum(float v, float* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? sh[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) sh[0] = v;
  }
  __syncthreads();
  return sh[0];
}

// RMS: kRms = true (no centring, no bias); layer norm: kRms = false.
template <typename T, bool kRms>
__global__ void __launch_bounds__(kMaxThreads)
    norm_kernel(const T* __restrict__ x, const void* __restrict__ w,
                const void* __restrict__ b, T* __restrict__ out, int h,
                long long x_stride, long long out_stride, int w_dtype,
                int b_dtype, float eps, int vec_in, int vec_out) {
  __shared__ float sh[32];
  constexpr int V = Vec<T>::N;
  const long long row = blockIdx.x;
  const T* xr = x + row * x_stride;
  T* orow = out + row * out_stride;
  const int nvec = vec_in ? h / V : 0;   // whole vectors; the rest scalar
  const int tail0 = nvec * V;
  const float inv_h = 1.0f / static_cast<float>(h);

  // pass 1: the mean (layer norm) or the mean of squares (RMS)
  float acc = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float f[V];
    load_vec(xr + static_cast<long long>(i) * V, f);
#pragma unroll
    for (int j = 0; j < V; ++j) acc += kRms ? f[j] * f[j] : f[j];
  }
  for (int i = tail0 + threadIdx.x; i < h; i += blockDim.x) {
    const float f = to_f(xr[i]);
    acc += kRms ? f * f : f;
  }
  const float s1 = block_sum(acc, sh) * inv_h;

  float mean = 0.f, rstd;
  if (kRms) {
    rstd = rsqrtf(s1 + eps);
  } else {
    // pass 2: the centred sum of squares, as _ln_kernel computes it
    mean = s1;
    acc = 0.f;
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      float f[V];
      load_vec(xr + static_cast<long long>(i) * V, f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float c = f[j] - mean;
        acc += c * c;
      }
    }
    for (int i = tail0 + threadIdx.x; i < h; i += blockDim.x) {
      const float c = to_f(xr[i]) - mean;
      acc += c * c;
    }
    rstd = rsqrtf(block_sum(acc, sh) * inv_h + eps);
  }

  // last pass: normalise, the affine in f32, one cast
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float f[V];
    const int c0 = i * V;
    load_vec(xr + c0, f);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float y = (f[j] - mean) * rstd;
      if (w != nullptr) y *= load_param(w, w_dtype, c0 + j);
      if (!kRms && b != nullptr) y += load_param(b, b_dtype, c0 + j);
      f[j] = y;
    }
    if (vec_out) {
      store_vec(orow + c0, f);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) orow[c0 + j] = from_f<T>(f[j]);
    }
  }
  for (int i = tail0 + threadIdx.x; i < h; i += blockDim.x) {
    float y = (to_f(xr[i]) - mean) * rstd;
    if (w != nullptr) y *= load_param(w, w_dtype, i);
    if (!kRms && b != nullptr) y += load_param(b, b_dtype, i);
    orow[i] = from_f<T>(y);
  }
}

template <typename T>
int launch(int rms, const void* x, const void* w, const void* b, void* out,
           long long n, int h, long long x_stride, long long out_stride,
           int w_dtype, int b_dtype, float eps, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const long long es = sizeof(T);
  // a row stride matters only when there is a second row
  const int vec_in = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                     (n == 1 || (x_stride * es) % 16 == 0);
  const int vec_out = vec_in &&
                      (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
                      (n == 1 || (out_stride * es) % 16 == 0);
  // one thread per 16-byte vector of the row, in whole warps, at most 256
  const int per_thread = vec_in ? V : 1;
  int threads = (h + per_thread - 1) / per_thread;
  threads = ((threads + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const dim3 grid(static_cast<unsigned>(n));
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (rms) {
    norm_kernel<T, true><<<grid, threads, 0, stream>>>(
        xt, w, b, ot, h, x_stride, out_stride, w_dtype, b_dtype, eps, vec_in,
        vec_out);
  } else {
    norm_kernel<T, false><<<grid, threads, 0, stream>>>(
        xt, w, b, ot, h, x_stride, out_stride, w_dtype, b_dtype, eps, vec_in,
        vec_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rms: 1 = B5 (RMS norm; b must be null), 0 = B4 (layer norm).
// x [n, h] with row stride x_stride (elements; the row itself dense),
// out [n, h] with row stride out_stride, both of dtype x_dtype; w and b
// [h] of their own dtypes, or null. Returns 0 or a CUDA error code; -1
// for arguments the kernel does not take.
extern "C" int norm_launch(int rms, const void* x, const void* w,
                           const void* b, void* out, long long n, int h,
                           long long x_stride, long long out_stride,
                           int x_dtype, int w_dtype, int b_dtype, float eps,
                           void* stream) {
  if (n < 1 || n > 0x7fffffffLL || h < 1 || (rms && b != nullptr)) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32)
    return launch<float>(rms, x, w, b, out, n, h, x_stride, out_stride,
                         w_dtype, b_dtype, eps, s);
  if (x_dtype == kBF16)
    return launch<__nv_bfloat16>(rms, x, w, b, out, n, h, x_stride,
                                 out_stride, w_dtype, b_dtype, eps, s);
  if (x_dtype == kF16)
    return launch<__half>(rms, x, w, b, out, n, h, x_stride, out_stride,
                          w_dtype, b_dtype, eps, s);
  return -1;
}
