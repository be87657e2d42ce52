// Building blocks of the Hopper (sm_90a) attention kernels, shared by
// flash_fwd_sm90.cu (B1) and flash_bwd_sm90.cu (B2): cp.async copies into
// 128-byte-swizzled tiles, wgmma matrix descriptors, the wgmma products of
// one 64-row warpgroup tile with A from shared memory or from registers,
// and the packing of an f32 accumulator into a register A operand, for
// either 16-bit element type the kernels take (bf16 and f16: the same
// layouts, the same f32 accumulation, only the PTX type names and the
// rounding differ). Everything is inline and in an anonymous namespace,
// so each library that includes it gets its own copy.
// paddle_tpu_torch/utils/build.py hashes this header with the sources, so
// an edit rebuilds both.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// shared-memory operands are 32-bit addresses in the shared window
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two f32 as a pair of T (round to nearest even, as torch's cast; out of
// f16's range they round to inf, as torch's cast does), the first in the
// low half
template <class T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<bf16>(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
template <>
__device__ __forceinline__ uint32_t pack2<f16>(float lo, float hi) {
  const __half2 p = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// byte offset of 16-byte chunk c (along D) of row r in an R-row tile laid
// out as D / 64 blocks of [R][64], each row 128 bytes with the 128-byte
// swizzle (chunk c of row r at c ^ (r & 7)): what wgmma's SWIZZLE_128B
// descriptors read, K-major for Q and K, MN-major for V
template <int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>((c >> 3) * (R * 128) + r * 128 +
                               (((c & 7) ^ (r & 7)) << 4));
}

template <int D, int R, int THREADS, class T>
__device__ __forceinline__ void cp_tile(uint32_t dst, const T* src,
                                         long long stride) {
  static_assert(sizeof(T) == 2, "16-bit elements, 8 to a copy");
  constexpr int CPR = D / 8;
#pragma unroll
  for (int it = 0; it < R * CPR / THREADS; ++it) {
    const int i = it * THREADS + static_cast<int>(threadIdx.x);
    const int r = i / CPR, c = i % CPR;
    cp_async16(dst + swz<R>(r, c), src + r * stride + c * 8);
  }
}

// a wgmma matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), layout SWIZZLE_128B (1 << 62)
__device__ __forceinline__ uint64_t wdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// registers a wgmma in flight reads or writes: pinned in place, so the
// compiler neither moves their uses across the wait nor reuses them early
template <int N>
__device__ __forceinline__ void pin(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// d[N/8][4] (+)= A · B for one k16 step of a 64-row warpgroup tile, A and
// B of element type T (bf16 or f16), f32 accumulation: wgmma_ss reads A
// (K-major) and B (K-major) through descriptors, scale_d = 0 overwrites
// d; wgmma_rs_t takes A from registers (the m16n8k16 A layout per warp)
// and B MN-major (transposed)
template <int N, class T>
__device__ void wgmma_ss(float (&d)[N / 8][4], uint64_t a, uint64_t b,
                         int scale_d);
template <int N, class T>
__device__ void wgmma_rs_t(float (&d)[N / 8][4], const uint32_t (&a)[4],
                           uint64_t b);

// the accumulator operands of a product n wide: d[0 .. n/8 - 1][0 .. 3]
#define SM90_D4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define SM90_N32 SM90_D4(0), SM90_D4(1), SM90_D4(2), SM90_D4(3)
#define SM90_N64 \
  SM90_N32, SM90_D4(4), SM90_D4(5), SM90_D4(6), SM90_D4(7)
#define SM90_N128                                                          \
  SM90_N64, SM90_D4(8), SM90_D4(9), SM90_D4(10), SM90_D4(11), SM90_D4(12), \
      SM90_D4(13), SM90_D4(14), SM90_D4(15)
#define SM90_R16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define SM90_R32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define SM90_R64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// the five products the kernels use, for element type T whose PTX name
// is TY ("bf16" or "f16"): AB names the A and B operands and P the
// scale_d flag, by operand number after the accumulators
#define SM90_WGMMA_SS(N, T, TY, REGS, ACC, AB, P)                          \
  template <>                                                              \
  __device__ __forceinline__ void wgmma_ss<N, T>(                          \
      float(&d)[N / 8][4], uint64_t a, uint64_t b, int scale_d) {          \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"            \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY      \
                 "." TY " " REGS ", " AB ", p, 1, 1, 0, 0;\n}\n"           \
                 : ACC                                                     \
                 : "l"(a), "l"(b), "r"(scale_d));                          \
  }
#define SM90_WGMMA_RS_T(N, T, TY, REGS, ACC, AB, P)                        \
  template <>                                                              \
  __device__ __forceinline__ void wgmma_rs_t<N, T>(                        \
      float(&d)[N / 8][4], const uint32_t(&a)[4], uint64_t b) {            \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"            \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY      \
                 "." TY " " REGS ", " AB ", p, 1, 1, 1;\n}\n"              \
                 : ACC                                                     \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),     \
                   "r"(1));                                                \
  }
#define SM90_WGMMA(T, TY)                                                  \
  SM90_WGMMA_SS(32, T, TY, SM90_R16, SM90_N32, "%16, %17", "%18")          \
  SM90_WGMMA_SS(64, T, TY, SM90_R32, SM90_N64, "%32, %33", "%34")          \
  SM90_WGMMA_SS(128, T, TY, SM90_R64, SM90_N128, "%64, %65", "%66")        \
  SM90_WGMMA_RS_T(64, T, TY, SM90_R32, SM90_N64,                           \
                  "{%32, %33, %34, %35}, %36", "%37")                      \
  SM90_WGMMA_RS_T(128, T, TY, SM90_R64, SM90_N128,                         \
                  "{%64, %65, %66, %67}, %68", "%69")
SM90_WGMMA(bf16, "bf16")
SM90_WGMMA(f16, "f16")
#undef SM90_WGMMA
#undef SM90_WGMMA_RS_T
#undef SM90_WGMMA_SS
#undef SM90_R64
#undef SM90_R32
#undef SM90_R16
#undef SM90_N128
#undef SM90_N64
#undef SM90_N32
#undef SM90_D4

// an f32 accumulator tile [64][N] as A fragments of T for the next
// product (P of p·v in B1, Pᵀ and dSᵀ in B2): the wgmma accumulator
// layout of two neighbouring n8 columns is the register A layout of one
// k16 step
template <int N, class T>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[N / 16][4],
                                       const float (&s)[N / 8][4]) {
#pragma unroll
  for (int kp = 0; kp < N / 16; ++kp) {
    pa[kp][0] = pack2<T>(s[2 * kp][0], s[2 * kp][1]);
    pa[kp][1] = pack2<T>(s[2 * kp][2], s[2 * kp][3]);
    pa[kp][2] = pack2<T>(s[2 * kp + 1][0], s[2 * kp + 1][1]);
    pa[kp][3] = pack2<T>(s[2 * kp + 1][2], s[2 * kp + 1][3]);
  }
}

}  // namespace
