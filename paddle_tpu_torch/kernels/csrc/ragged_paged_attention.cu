// Ragged paged attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel paddle_tpu/kernels/pallas/ragged_paged_attention.py
// (_ragged_pallas :313, kernel _ragged_kernel :166). It computes what the
// reference _ragged_reference (:101) computes: for each packed query token
// t and q head h, one softmax over
//   (a) its row's cached context in the token-major paged pool
//       [T_pool, Hk, D] (the row's owned pages, slots below kv_start), and
//   (b) the packed fresh k/v of its own row at positions <= pos[t];
// int8 pools fold per-kv-head dequant scales into the scores and values;
// q head h reads kv head h / (H / Hk); a dead token (row -1) or a token
// with no valid key writes 0. Output is f32 [T, H, D].
//
// What bounds it on the card: each (token, head) pair reads every valid
// key and value of its row once, so the work is 4*D flops per valid
// (head, key) pair over ~4*D bytes of k/v per pair. The distinct bytes
// (q, k_new, v_new, the rows' valid pool pages, the f32 output) are few
// and the flops are modest, so the roofline bound is small; this simple
// first version is instead limited by latency: one warp walks its keys
// one at a time, each step a dependent chain of loads, a shuffle
// reduction and two exponentials. K/V rows are re-read by every query
// token of the row, and are served from L2/L1 rather than device memory.
//
// Design, simple and right first:
//   * one warp per (packed token, q head); 32 lanes split D, each lane
//     holds D/32 contiguous elements of q, of the f32 accumulator, and of
//     each k/v row it loads; a butterfly shuffle reduces each dot product;
//   * the online-softmax state (running max m, sum l) lives in registers
//     and spans both phases, with f32 arithmetic throughout;
//   * the wrapper prepares compact operands so the warp reads only what
//     its row owns: the row's pages sorted by start position with the
//     valid slot count of each, and the [first, last] span of the row's
//     packed tokens (the row/position test stays inside the span, so any
//     packing is right). The Pallas kernel's visit of every pool tile
//     and every packed tile for every q tile is not carried over.
//   * q*scale and the probabilities stay in f32, where the reference
//     rounds them to the pool dtype before each product; the kernel is
//     held to the plain version run in f32 on the same bf16 (or f16)
//     values. q/k/v are f32, bf16 or f16 and the pools of q's type or
//     int8, all widened to f32 on load.
// Sharing K/V tiles across a q tile in shared memory, wgmma and TMA are
// the later, faster version.
//
// The launch runs on the caller's stream, allocates nothing and does not
// synchronise; the C entry returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr float kNegInit = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

// N contiguous elements starting at p, widened to f32
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f(p[i]);
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ p,
                                         float (&out)[N]) {
  static_assert(N % 2 == 0, "bf16 rows load in pairs");
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(p2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __half* __restrict__ p,
                                         float (&out)[N]) {
  static_assert(N % 2 == 0, "f16 rows load in pairs");
  const __half2* p2 = reinterpret_cast<const __half2*>(p);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __half22float2(p2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int N>
struct Softmax {
  float m = kNegInit;
  float l = 0.f;
  float acc[N];

  __device__ __forceinline__ Softmax() {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
  }

  // fold one key: score s, value row v scaled by vscale
  __device__ __forceinline__ void add(float s, const float (&v)[N],
                                      float vscale) {
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
    const float pv = p * vscale;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = acc[i] * alpha + pv * v[i];
    m = m_new;
  }
};

template <typename TQ, typename TP, int D>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ragged_attn_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k_new,
                   const TQ* __restrict__ v_new,
                   const TP* __restrict__ kpool,
                   const TP* __restrict__ vpool,
                   const int* __restrict__ rows, const int* __restrict__ pos,
                   const int* __restrict__ page_ids,
                   const int* __restrict__ page_cnt,
                   const int* __restrict__ npages,
                   const int* __restrict__ span_lo,
                   const int* __restrict__ span_hi,
                   const float* __restrict__ kdq,
                   const float* __restrict__ vdq, float* __restrict__ out,
                   int T, int H, int Hk, int NB, int bs, int with_pool,
                   long long q_st, long long k_st, long long v_st,
                   float scale) {
  constexpr int N = D / 32;
  const int lane = threadIdx.x & 31;
  const long long w =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= static_cast<long long>(T) * H) return;
  const int t = static_cast<int>(w / H);
  const int h = static_cast<int>(w % H);
  float* o = out + w * D + lane * N;
  const int r = rows[t];

  Softmax<N> sm;
  if (r >= 0) {
    const int hk = h / (H / Hk);
    float qv[N];
    load_vec(q + t * q_st + static_cast<long long>(h) * D + lane * N, qv);
#pragma unroll
    for (int i = 0; i < N; ++i) qv[i] *= scale;
    float kv[N], vv[N];

    if (with_pool) {
      // (a) the row's cached context: valid slots of its owned pages
      const float kd = kdq ? kdq[hk] : 1.f;
      const float vd = vdq ? vdq[hk] : 1.f;
      const long long row_stride = static_cast<long long>(Hk) * D;
      const int np = npages[r];
      for (int j = 0; j < np; ++j) {
        const int pg = page_ids[r * NB + j];
        const int cnt = page_cnt[r * NB + j];
        const long long base = static_cast<long long>(pg) * bs * row_stride +
                               static_cast<long long>(hk) * D + lane * N;
        for (int s = 0; s < cnt; ++s) {
          const long long at = base + s * row_stride;
          load_vec(kpool + at, kv);
          load_vec(vpool + at, vv);
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < N; ++i) dot += qv[i] * kv[i];
          sm.add(warp_sum(dot) * kd, vv, vd);
        }
      }
    }

    // (b) the row's own packed tokens at positions <= pos[t]
    const int pt = pos[t];
    const int hi = span_hi[r];
    for (int u = span_lo[r]; u <= hi; ++u) {
      if (rows[u] != r || pos[u] > pt) continue;  // uniform across the warp
      load_vec(k_new + u * k_st + static_cast<long long>(hk) * D + lane * N,
               kv);
      load_vec(v_new + u * v_st + static_cast<long long>(hk) * D + lane * N,
               vv);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) dot += qv[i] * kv[i];
      sm.add(warp_sum(dot), vv, 1.f);
    }
  }

  const float inv = sm.l > 0.f ? 1.f / sm.l : 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] = sm.acc[i] * inv;
}

template <typename TQ, typename TP, int D>
void launch(const void* q, const void* k_new, const void* v_new,
            const void* kpool, const void* vpool, const int* rows,
            const int* pos, const int* page_ids, const int* page_cnt,
            const int* npages, const int* span_lo, const int* span_hi,
            const float* kdq, const float* vdq, float* out, int T, int H,
            int Hk, int NB, int bs, int with_pool, long long q_st,
            long long k_st, long long v_st, float scale,
            cudaStream_t stream) {
  const long long warps = static_cast<long long>(T) * H;
  const unsigned grid =
      static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  ragged_attn_kernel<TQ, TP, D><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(k_new),
      static_cast<const TQ*>(v_new), static_cast<const TP*>(kpool),
      static_cast<const TP*>(vpool), rows, pos, page_ids, page_cnt, npages,
      span_lo, span_hi, kdq, vdq, out, T, H, Hk, NB, bs, with_pool, q_st,
      k_st, v_st, scale);
}

template <typename TQ, typename TP>
int dispatch_d(int D, const void* q, const void* k_new, const void* v_new,
               const void* kpool, const void* vpool, const int* rows,
               const int* pos, const int* page_ids, const int* page_cnt,
               const int* npages, const int* span_lo, const int* span_hi,
               const float* kdq, const float* vdq, float* out, int T, int H,
               int Hk, int NB, int bs, int with_pool, long long q_st,
               long long k_st, long long v_st, float scale,
               cudaStream_t stream) {
#define RPA_LAUNCH(DD)                                                     \
  launch<TQ, TP, DD>(q, k_new, v_new, kpool, vpool, rows, pos, page_ids,   \
                     page_cnt, npages, span_lo, span_hi, kdq, vdq, out, T, \
                     H, Hk, NB, bs, with_pool, q_st, k_st, v_st, scale,    \
                     stream)
  switch (D) {
    case 64: RPA_LAUNCH(64); break;
    case 128: RPA_LAUNCH(128); break;
    case 256: RPA_LAUNCH(256); break;
    default: return -1;
  }
#undef RPA_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only),
// 3 = float16.
// Returns cudaGetLastError() after the launch, or -1 for a dtype/head_dim
// combination the kernel is not built for.
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* k_new, const void* v_new, const void* kpool,
    const void* vpool, const void* rows, const void* pos,
    const void* page_ids, const void* page_cnt, const void* npages,
    const void* span_lo, const void* span_hi, const void* kdq,
    const void* vdq, void* out, int T, int H, int Hk, int D, int NB, int bs,
    int with_pool, int q_dtype, int pool_dtype, long long q_st,
    long long k_st, long long v_st, float scale, void* stream) {
#define RPA_ARGS                                                            \
  D, q, k_new, v_new, kpool, vpool, static_cast<const int*>(rows),          \
      static_cast<const int*>(pos), static_cast<const int*>(page_ids),      \
      static_cast<const int*>(page_cnt), static_cast<const int*>(npages),   \
      static_cast<const int*>(span_lo), static_cast<const int*>(span_hi),   \
      static_cast<const float*>(kdq), static_cast<const float*>(vdq),       \
      static_cast<float*>(out), T, H, Hk, NB, bs, with_pool, q_st, k_st,    \
      v_st, scale, static_cast<cudaStream_t>(stream)
  if (q_dtype == 1) {
    if (pool_dtype == 1) return dispatch_d<__nv_bfloat16, __nv_bfloat16>(RPA_ARGS);
    if (pool_dtype == 2) return dispatch_d<__nv_bfloat16, int8_t>(RPA_ARGS);
  } else if (q_dtype == 3) {
    if (pool_dtype == 3) return dispatch_d<__half, __half>(RPA_ARGS);
    if (pool_dtype == 2) return dispatch_d<__half, int8_t>(RPA_ARGS);
  } else if (q_dtype == 0) {
    if (pool_dtype == 0) return dispatch_d<float, float>(RPA_ARGS);
    if (pool_dtype == 2) return dispatch_d<float, int8_t>(RPA_ARGS);
  }
#undef RPA_ARGS
  return -1;
}
