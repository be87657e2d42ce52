// Flash attention forward (B1) and backward (B2) for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the TPU kernels of paddle_tpu/kernels/pallas/flash_attention.py:
//   B1  _flash_fwd_fused (:267, kernel _fwd_kernel :101)
//   B2  _flash_bwd_fused (:457, kernel _bwd_kernel :364)
// and computes what they compute, on the paddle layout [b, s, heads, D]:
//   * forward: o = softmax(q_scaled kᵀ) v per (batch, q head), q head h
//     reading kv head h / (H / Hk) (GQA/MQA); bottom-right causal mask
//     (query i sees keys <= i + sk - sq); optional segment-id equality
//     mask; online softmax in f32 over k tiles; masked scores at -1e30
//     and masked probabilities 0, so a row with no valid key gives o = 0
//     and lse = -1e30. Writes o in q's dtype and lse f32 as [b, H, sq]
//     (the TPU kernel's [b, H*8, sq] copies each row over 8 sublanes);
//   * backward (FA2): p = exp(s - lse) recomputed, dv += cast(p)ᵀ·do,
//     dp = do·vᵀ, ds = p·(dp - delta), dk += cast(ds)ᵀ·q_scaled,
//     dq += cast(ds)·k, dq scaled by sm_scale and cast to q's dtype.
//     delta = rowsum(do·o) comes in from the wrapper (a torch op, as the
//     reference computes it outside its kernel, :521-525).
//
// What bounds it on this card: at the training shape (b 16, s 1024,
// H 12, D 64, causal) the forward does ~26 GFLOP over ~0.1 GB, close to
// both lines (0.026 ms at the tensor cores' rate, 0.030 ms at HBM's),
// and the backward ~64 GFLOP over ~0.2 GB, bound by the tensor cores'
// rate (~0.065 ms). This
// first version is simple and right, and is limited instead by issue
// and shared-memory traffic: every mma operand is loaded from shared
// memory with plain 16/32-bit loads (no ldmatrix), no copy overlaps the
// math (no cp.async/TMA), and mma.sync runs at a fraction of what
// wgmma reaches. Those are the later, faster version.
//
// Design:
//   * one CTA of BM/16 warps per (q tile | k tile, head, batch); each
//     warp owns 16 rows of the tile and its rows' accumulators, in the
//     register layout of mma.m16n8k16 (lane g = lane/4, t = lane%4 holds
//     rows g and g+8, columns 8j+2t and 8j+2t+1). Warps share only the
//     tiles in shared memory, so no reduction crosses warps;
//   * bf16 and f16 products run on the tensor cores (mma.sync m16n8k16,
//     f32 accumulate; one template over the 16-bit element type T, whose
//     PTX name is the only difference); f32 inputs run the same code with
//     a SIMT product in full f32 (no TF32), which is what the f32 parity
//     checks need;
//   * causal tiles above the diagonal are never visited: the forward
//     and dq loops stop at the last k tile a q tile can see, and the
//     dk/dv loop starts at the first q tile that can see its k tile
//     (the counterpart of _block_classes :71). The mask is evaluated only
//     on tiles that straddle the diagonal or carry segment ids;
//   * the backward is split deterministically, with no atomics: one
//     kernel over k tiles owns dk/dv of (batch, kv head, k tile) and
//     walks every q tile of every q head of its GQA group, so no two
//     CTAs write one dk row; one kernel over q tiles owns dq. The cost
//     of the split is that s, p and dp are recomputed in both kernels
//     (the TPU kernel computes them once and writes a dq partial per k
//     block, summed afterwards: 3 score-sized products per pair there,
//     5 here);
//   * the reference's casts are kept where the tensor cores need them
//     anyway: p to v's dtype before p·v, p to do's dtype before dv, ds to
//     q's/k's dtype before dk/dq. Row sums of p and every accumulator
//     are f32;
//   * q, k, v and do are read through a batch and a token stride (they
//     arrive as views of the fused qkv projection); heads and head_dim
//     must be dense, and rows 16-byte aligned (the wrapper checks).
//
// Tiles: BM = 64 rows for q and k (32 for f32 at D = 256, where 64 would
// not fit in shared memory). Shared-memory rows are padded by 16 bytes so
// the fragment loads of a warp fall in distinct banks.
//
// Launches run on the caller's stream, allocate nothing and do not
// synchronise; the C entries return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);  // round to nearest even, as torch's cast
}

template <typename T, int D>
struct Cfg {
  static constexpr int BM = (sizeof(T) == 4 && D == 256) ? 32 : 64;
  static constexpr int WARPS = BM / 16;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LD = D + PAD;    // row stride of a [rows][D] tile
  static constexpr int LDP = BM + PAD;  // row stride of a [rows][BM] tile
  static constexpr int NT_S = BM / 8;   // n8 tiles across a score row
  static constexpr int NT_D = D / 8;    // n8 tiles across a head_dim row
};

// ---------------------------------------------------------------------------
// warp products: acc[NT][4] += A[16 x K] · B[K x 8 NT]
//   A(r, kk) = a[r * lda + kk]
//   B(kk, n) = b[n * ldb + kk]  when B_K_CONTIG (B is an [n][k] tile)
//            = b[kk * ldb + n]  otherwise       (B is a  [k][n] tile)
// acc follows the m16n8k16 accumulator layout described above.
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint16_t bits(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
__device__ __forceinline__ uint16_t bits(__half x) {
  return __half_as_ushort(x);
}
template <typename T>
__device__ __forceinline__ uint32_t pack2(T lo, T hi) {
  return static_cast<uint32_t>(bits(lo)) |
         (static_cast<uint32_t>(bits(hi)) << 16);
}

// c += a · b, one m16n8k16 product of 16-bit T with f32 accumulation;
// TY is T's PTX name
template <typename T>
__device__ void mma16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                      uint32_t b1);
#define FA_MMA16(T, TY)                                                   \
  template <>                                                             \
  __device__ __forceinline__ void mma16<T>(                               \
      float(&c)[4], const uint32_t(&a)[4], uint32_t b0, uint32_t b1) {    \
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY      \
                 ".f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "           \
                 "{%0,%1,%2,%3};\n"                                       \
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])         \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),   \
                   "r"(b1));                                              \
  }
FA_MMA16(__nv_bfloat16, "bf16")
FA_MMA16(__half, "f16")
#undef FA_MMA16

template <int NT, int K, bool B_K_CONTIG, typename T>
__device__ __forceinline__ void warp_mm(float (&acc)[NT][4], const T* a,
                                        int lda, const T* b, int ldb) {
  static_assert(sizeof(T) == 2, "16-bit elements: the tensor-core product");
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    af[0] = ld32(a + g * lda + k0 + 2 * t);
    af[1] = ld32(a + (g + 8) * lda + k0 + 2 * t);
    af[2] = ld32(a + g * lda + k0 + 2 * t + 8);
    af[3] = ld32(a + (g + 8) * lda + k0 + 2 * t + 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + g;
      uint32_t b0, b1;
      if (B_K_CONTIG) {
        b0 = ld32(b + n * ldb + k0 + 2 * t);
        b1 = ld32(b + n * ldb + k0 + 2 * t + 8);
      } else {
        b0 = pack2(b[(k0 + 2 * t) * ldb + n], b[(k0 + 2 * t + 1) * ldb + n]);
        b1 = pack2(b[(k0 + 2 * t + 8) * ldb + n],
                   b[(k0 + 2 * t + 9) * ldb + n]);
      }
      mma16<T>(acc[j], af, b0, b1);
    }
  }
}

// f32: the same owned elements, computed with f32 FMAs (full precision)
template <int NT, int K, bool B_K_CONTIG>
__device__ __forceinline__ void warp_mm(float (&acc)[NT][4], const float* a,
                                        int lda, const float* b, int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    const float a0 = a[g * lda + kk];
    const float a1 = a[(g + 8) * lda + kk];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + 2 * t;
      float b0, b1;
      if (B_K_CONTIG) {
        b0 = b[n * ldb + kk];
        b1 = b[(n + 1) * ldb + kk];
      } else {
        b0 = b[kk * ldb + n];
        b1 = b[kk * ldb + n + 1];
      }
      acc[j][0] = fmaf(a0, b0, acc[j][0]);
      acc[j][1] = fmaf(a0, b1, acc[j][1]);
      acc[j][2] = fmaf(a1, b0, acc[j][2]);
      acc[j][3] = fmaf(a1, b1, acc[j][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// rows [0, R) of a head's [*, D] slice (row i at src + i * row_stride)
// into dst[i * LD], in 16-byte chunks by all threads of the CTA
template <typename T, int D, int R, int THREADS, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row_stride) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CPR = D / V;
  for (int i = threadIdx.x; i < R * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * V;
    *reinterpret_cast<uint4*>(dst + r * LD + c) =
        *reinterpret_cast<const uint4*>(src + r * row_stride + c);
  }
}

// an accumulator tile (C layout) into shared memory as T, row stride ld
template <typename T, int NT>
__device__ __forceinline__ void store_frag(T* dst, int ld,
                                           const float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = 8 * j + 2 * t;
    dst[g * ld + c] = from_f<T>(acc[j][0]);
    dst[g * ld + c + 1] = from_f<T>(acc[j][1]);
    dst[(g + 8) * ld + c] = from_f<T>(acc[j][2]);
    dst[(g + 8) * ld + c + 1] = from_f<T>(acc[j][3]);
  }
}

// two neighbouring values of one row to global memory
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(__half* p, float x, float y) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
}

// a warp's 16 accumulator rows (scaled by `mul`) into global rows
// [row0, row0 + 16) of a [*, heads, D] tensor at head `h`
template <typename T, int NT>
__device__ __forceinline__ void store_rows(T* out, long long row0,
                                           int heads, int h, int D,
                                           const float (&acc)[NT][4],
                                           float mul_lo, float mul_hi) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  T* lo = out + ((row0 + g) * heads + h) * static_cast<long long>(D);
  T* hi = out + ((row0 + g + 8) * heads + h) * static_cast<long long>(D);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = 8 * j + 2 * t;
    store2(lo + c, acc[j][0] * mul_lo, acc[j][1] * mul_lo);
    store2(hi + c, acc[j][2] * mul_hi, acc[j][3] * mul_hi);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// validity of the element (e) of n-tile j of a warp's score fragment:
// the row index is rlo (e < 2) or rlo + 8, the column c0 + 8j + 2t + e%2.
// `rows_are_q` says whether rows are queries (forward, dq) or keys (dk/dv).
struct Masker {
  int causal, offset;
  const int* seg_r;  // segment ids of the tile's rows (shared), or null
  const int* seg_c;  // of its columns
  __device__ __forceinline__ bool ok(int row, int col, int lrow, int lcol,
                                     bool rows_are_q) const {
    bool v = true;
    if (causal) v = rows_are_q ? (col <= row + offset) : (row <= col + offset);
    if (seg_r) v = v && (seg_r[lrow] == seg_c[lcol]);
    return v;
  }
};

// ---------------------------------------------------------------------------
// B1: forward. grid (sq / BM, H, b)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T, D>::THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int H, int Hk,
                 int causal, long long q_sb, long long q_st, long long k_sb,
                 long long k_st, long long v_sb, long long v_st) {
  using C = Cfg<T, D>;
  constexpr int BM = C::BM, LD = C::LD, LDP = C::LDP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BM * LD;
  T* Vs = Ks + BM * LD;
  T* Ps = Vs + BM * LD;
  int* qseg_s = reinterpret_cast<int*>(Ps + BM * LDP);
  int* kseg_s = qseg_s + BM;

  const int q0 = blockIdx.x * BM, h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (H / Hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int offset = sk - sq;
  const bool has_seg = q_seg != nullptr;
  const Masker mk{causal, offset, has_seg ? qseg_s : nullptr, kseg_s};

  load_tile<T, D, BM, C::THREADS, LD>(
      Qs, q + bi * q_sb + q0 * q_st + static_cast<long long>(h) * D, q_st);
  if (has_seg)
    for (int i = threadIdx.x; i < BM; i += C::THREADS)
      qseg_s[i] = q_seg[static_cast<long long>(bi) * sq + q0 + i];

  // keys [0, kend) are visible to some row of this tile
  const int kend = causal ? min(sk, q0 + BM + offset) : sk;
  const int nkb = kend > 0 ? (kend + BM - 1) / BM : 0;
  const int lr = warp * 16 + g;           // local rows lr and lr + 8
  T* Pw = Ps + warp * 16 * LDP;

  float acc[C::NT_D][4];
  zero(acc);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BM;
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile<T, D, BM, C::THREADS, LD>(
        Ks, k + bi * k_sb + k0 * k_st + static_cast<long long>(hk) * D, k_st);
    load_tile<T, D, BM, C::THREADS, LD>(
        Vs, v + bi * v_sb + k0 * v_st + static_cast<long long>(hk) * D, v_st);
    if (has_seg)
      for (int i = threadIdx.x; i < BM; i += C::THREADS)
        kseg_s[i] = kv_seg[static_cast<long long>(bi) * sk + k0 + i];
    __syncthreads();

    float s[C::NT_S][4];
    zero(s);
    warp_mm<C::NT_S, D, true>(s, Qs + warp * 16 * LD, LD, Ks, LD);

    // mask only tiles that straddle this warp's diagonal or carry segments
    const bool masked =
        has_seg || (causal && k0 + BM - 1 > q0 + warp * 16 + offset);
    uint32_t bad = 0;  // bit 4j+e: element masked
    if (masked) {
#pragma unroll
      for (int j = 0; j < C::NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lrow = lr + (e >> 1) * 8, lcol = 8 * j + 2 * t + (e & 1);
          if (!mk.ok(q0 + lrow, k0 + lcol, lrow, lcol, true)) {
            s[j][e] = kNegInf;
            bad |= 1u << (4 * j + e);
          }
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < C::NT_S; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < C::NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a row with no valid key yet has mx = -1e30 and exp(0) = 1:
        // masked elements are zeroed explicitly, as the reference does
        const float p = (bad >> (4 * j + e)) & 1u
                            ? 0.f
                            : expf(s[j][e] - mx[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float alpha = expf(m[i] - mx[i]);
      l[i] = alpha * l[i] + quad_sum(rs[i]);
      m[i] = mx[i];
#pragma unroll
      for (int j = 0; j < C::NT_D; ++j) {
        acc[j][2 * i] *= alpha;
        acc[j][2 * i + 1] *= alpha;
      }
    }
    store_frag<T, C::NT_S>(Pw, LDP, s);  // p cast to v's dtype
    __syncwarp();
    warp_mm<C::NT_D, BM, false>(acc, Pw, LDP, Vs, LD);
  }

  const float sl0 = l[0] == 0.f ? 1.f : l[0];
  const float sl1 = l[1] == 0.f ? 1.f : l[1];
  // the reference divides by the row sum; so does this (not * 1/l)
#pragma unroll
  for (int j = 0; j < C::NT_D; ++j) {
    acc[j][0] /= sl0;
    acc[j][1] /= sl0;
    acc[j][2] /= sl1;
    acc[j][3] /= sl1;
  }
  store_rows<T, C::NT_D>(o, static_cast<long long>(bi) * sq + q0 + warp * 16,
                         H, h, D, acc, 1.f, 1.f);
  if (t == 0) {
    float* lrow = lse + (static_cast<long long>(bi) * H + h) * sq + q0;
    lrow[lr] = m[0] + logf(sl0);
    lrow[lr + 8] = m[1] + logf(sl1);
  }
}

// ---------------------------------------------------------------------------
// B2, part 1: dk and dv. grid (sk / BM, Hk, b)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T, D>::THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ q_seg,
                      const int* __restrict__ kv_seg, T* __restrict__ dk,
                      T* __restrict__ dv, int sq, int sk, int H, int Hk,
                      int causal, long long q_sb, long long q_st,
                      long long k_sb, long long k_st, long long v_sb,
                      long long v_st, long long do_sb, long long do_st) {
  using C = Cfg<T, D>;
  constexpr int BM = C::BM, LD = C::LD, LDP = C::LDP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BM * LD;
  T* Qs = Vs + BM * LD;
  T* dOs = Qs + BM * LD;
  T* Ps = dOs + BM * LD;
  float* lse_s = reinterpret_cast<float*>(Ps + BM * LDP);
  float* delta_s = lse_s + BM;
  int* qseg_s = reinterpret_cast<int*>(delta_s + BM);
  int* kseg_s = qseg_s + BM;

  const int k0 = blockIdx.x * BM, hk = blockIdx.y, bi = blockIdx.z;
  const int G = H / Hk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int offset = sk - sq;
  const bool has_seg = q_seg != nullptr;
  // rows of the score tile are keys here, columns queries
  const Masker mk{causal, offset, has_seg ? kseg_s : nullptr, qseg_s};

  load_tile<T, D, BM, C::THREADS, LD>(
      Ks, k + bi * k_sb + k0 * k_st + static_cast<long long>(hk) * D, k_st);
  load_tile<T, D, BM, C::THREADS, LD>(
      Vs, v + bi * v_sb + k0 * v_st + static_cast<long long>(hk) * D, v_st);
  if (has_seg)
    for (int i = threadIdx.x; i < BM; i += C::THREADS)
      kseg_s[i] = kv_seg[static_cast<long long>(bi) * sk + k0 + i];

  // queries that see key k0 or later: rows >= k0 - offset
  int qb0 = 0;
  if (causal) qb0 = max(0, k0 - offset) / BM;
  const int nqb = sq / BM;
  const int lr = warp * 16 + g;  // local key rows lr and lr + 8
  T* Pw = Ps + warp * 16 * LDP;

  float dk_acc[C::NT_D][4], dv_acc[C::NT_D][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int hh = 0; hh < G; ++hh) {
    const int h = hk * G + hh;
    for (int qb = qb0; qb < nqb; ++qb) {
      const int q0 = qb * BM;
      __syncthreads();
      load_tile<T, D, BM, C::THREADS, LD>(
          Qs, q + bi * q_sb + q0 * q_st + static_cast<long long>(h) * D,
          q_st);
      load_tile<T, D, BM, C::THREADS, LD>(
          dOs, dout + bi * do_sb + q0 * do_st + static_cast<long long>(h) * D,
          do_st);
      for (int i = threadIdx.x; i < BM; i += C::THREADS) {
        const long long at = (static_cast<long long>(bi) * H + h) * sq + q0 + i;
        lse_s[i] = lse[at];
        delta_s[i] = delta[at];
        if (has_seg) qseg_s[i] = q_seg[static_cast<long long>(bi) * sq + q0 + i];
      }
      __syncthreads();

      // pᵀ: rows keys, columns queries
      float p[C::NT_S][4];
      zero(p);
      warp_mm<C::NT_S, D, true>(p, Ks + warp * 16 * LD, LD, Qs, LD);
      const bool masked =
          has_seg || (causal && k0 + warp * 16 + 15 > q0 + offset);
#pragma unroll
      for (int j = 0; j < C::NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lrow = lr + (e >> 1) * 8, lcol = 8 * j + 2 * t + (e & 1);
          const bool ok =
              !masked || mk.ok(k0 + lrow, q0 + lcol, lrow, lcol, false);
          p[j][e] = ok ? expf(p[j][e] - lse_s[lcol]) : 0.f;
        }
      store_frag<T, C::NT_S>(Pw, LDP, p);  // p cast to do's dtype
      __syncwarp();
      warp_mm<C::NT_D, BM, false>(dv_acc, Pw, LDP, dOs, LD);

      // dpᵀ = v · doᵀ, then dsᵀ = pᵀ (dpᵀ - delta)
      float dp[C::NT_S][4];
      zero(dp);
      warp_mm<C::NT_S, D, true>(dp, Vs + warp * 16 * LD, LD, dOs, LD);
#pragma unroll
      for (int j = 0; j < C::NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[j][e] *= dp[j][e] - delta_s[8 * j + 2 * t + (e & 1)];
      __syncwarp();  // every lane has read Pw
      store_frag<T, C::NT_S>(Pw, LDP, p);  // ds cast to q's dtype
      __syncwarp();
      warp_mm<C::NT_D, BM, false>(dk_acc, Pw, LDP, Qs, LD);
    }
  }
  const long long row0 = static_cast<long long>(bi) * sk + k0 + warp * 16;
  store_rows<T, C::NT_D>(dk, row0, Hk, hk, D, dk_acc, 1.f, 1.f);
  store_rows<T, C::NT_D>(dv, row0, Hk, hk, D, dv_acc, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// B2, part 2: dq. grid (sq / BM, H, b)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T, D>::THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ q_seg,
                    const int* __restrict__ kv_seg, T* __restrict__ dq,
                    int sq, int sk, int H, int Hk, int causal, float sm_scale,
                    long long q_sb, long long q_st, long long k_sb,
                    long long k_st, long long v_sb, long long v_st,
                    long long do_sb, long long do_st) {
  using C = Cfg<T, D>;
  constexpr int BM = C::BM, LD = C::LD, LDP = C::LDP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + BM * LD;
  T* Ks = dOs + BM * LD;
  T* Vs = Ks + BM * LD;
  T* Ps = Vs + BM * LD;
  float* lse_s = reinterpret_cast<float*>(Ps + BM * LDP);
  float* delta_s = lse_s + BM;
  int* qseg_s = reinterpret_cast<int*>(delta_s + BM);
  int* kseg_s = qseg_s + BM;

  const int q0 = blockIdx.x * BM, h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (H / Hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int offset = sk - sq;
  const bool has_seg = q_seg != nullptr;
  const Masker mk{causal, offset, has_seg ? qseg_s : nullptr, kseg_s};

  load_tile<T, D, BM, C::THREADS, LD>(
      Qs, q + bi * q_sb + q0 * q_st + static_cast<long long>(h) * D, q_st);
  load_tile<T, D, BM, C::THREADS, LD>(
      dOs, dout + bi * do_sb + q0 * do_st + static_cast<long long>(h) * D,
      do_st);
  for (int i = threadIdx.x; i < BM; i += C::THREADS) {
    const long long at = (static_cast<long long>(bi) * H + h) * sq + q0 + i;
    lse_s[i] = lse[at];
    delta_s[i] = delta[at];
    if (has_seg) qseg_s[i] = q_seg[static_cast<long long>(bi) * sq + q0 + i];
  }

  const int kend = causal ? min(sk, q0 + BM + offset) : sk;
  const int nkb = kend > 0 ? (kend + BM - 1) / BM : 0;
  const int lr = warp * 16 + g;
  T* Pw = Ps + warp * 16 * LDP;

  float dq_acc[C::NT_D][4];
  zero(dq_acc);
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BM;
    __syncthreads();
    load_tile<T, D, BM, C::THREADS, LD>(
        Ks, k + bi * k_sb + k0 * k_st + static_cast<long long>(hk) * D, k_st);
    load_tile<T, D, BM, C::THREADS, LD>(
        Vs, v + bi * v_sb + k0 * v_st + static_cast<long long>(hk) * D, v_st);
    if (has_seg)
      for (int i = threadIdx.x; i < BM; i += C::THREADS)
        kseg_s[i] = kv_seg[static_cast<long long>(bi) * sk + k0 + i];
    __syncthreads();
    if (kb == 0) {
      lse_r[0] = lse_s[lr];
      lse_r[1] = lse_s[lr + 8];
      delta_r[0] = delta_s[lr];
      delta_r[1] = delta_s[lr + 8];
    }

    float p[C::NT_S][4];
    zero(p);
    warp_mm<C::NT_S, D, true>(p, Qs + warp * 16 * LD, LD, Ks, LD);
    const bool masked =
        has_seg || (causal && k0 + BM - 1 > q0 + warp * 16 + offset);
#pragma unroll
    for (int j = 0; j < C::NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lrow = lr + (e >> 1) * 8, lcol = 8 * j + 2 * t + (e & 1);
        const bool ok =
            !masked || mk.ok(q0 + lrow, k0 + lcol, lrow, lcol, true);
        p[j][e] = ok ? expf(p[j][e] - lse_r[e >> 1]) : 0.f;
      }
    float dp[C::NT_S][4];
    zero(dp);
    warp_mm<C::NT_S, D, true>(dp, dOs + warp * 16 * LD, LD, Vs, LD);
#pragma unroll
    for (int j = 0; j < C::NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] *= dp[j][e] - delta_r[e >> 1];
    store_frag<T, C::NT_S>(Pw, LDP, p);  // ds cast to k's dtype
    __syncwarp();
    warp_mm<C::NT_D, BM, false>(dq_acc, Pw, LDP, Ks, LD);
  }
  store_rows<T, C::NT_D>(dq, static_cast<long long>(bi) * sq + q0 + warp * 16,
                         H, h, D, dq_acc, sm_scale, sm_scale);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <typename T, int D>
size_t fwd_smem() {
  using C = Cfg<T, D>;
  return (3 * C::BM * C::LD + C::BM * C::LDP) * sizeof(T) +
         2 * C::BM * sizeof(int);
}

template <typename T, int D>
size_t bwd_smem() {
  using C = Cfg<T, D>;
  return (4 * C::BM * C::LD + C::BM * C::LDP) * sizeof(T) +
         2 * C::BM * sizeof(float) + 2 * C::BM * sizeof(int);
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

struct Strides {
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st, do_sb, do_st;
};

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, const int* q_seg,
        const int* kv_seg, void* o, float* lse, int b, int sq, int sk, int H,
        int Hk, int causal, const Strides& st, cudaStream_t stream) {
  using C = Cfg<T, D>;
  const size_t smem = fwd_smem<T, D>();
  int rc = allow_smem(flash_fwd_kernel<T, D>, smem);
  if (rc) return rc;
  dim3 grid(sq / C::BM, H, b);
  flash_fwd_kernel<T, D><<<grid, C::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_seg, kv_seg, static_cast<T*>(o), lse, sq,
      sk, H, Hk, causal, st.q_sb, st.q_st, st.k_sb, st.k_st, st.v_sb,
      st.v_st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, const int* q_seg,
        const int* kv_seg, void* dq, void* dk, void* dv, int b, int sq,
        int sk, int H, int Hk, int causal, float sm_scale, const Strides& st,
        cudaStream_t stream) {
  using C = Cfg<T, D>;
  const size_t smem = bwd_smem<T, D>();
  int rc = allow_smem(flash_bwd_dkdv_kernel<T, D>, smem);
  if (rc) return rc;
  rc = allow_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (rc) return rc;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  flash_bwd_dkdv_kernel<T, D><<<dim3(sk / C::BM, Hk, b), C::THREADS, smem,
                                stream>>>(
      qp, kp, vp, dop, lse, delta, q_seg, kv_seg, static_cast<T*>(dk),
      static_cast<T*>(dv), sq, sk, H, Hk, causal, st.q_sb, st.q_st, st.k_sb,
      st.k_st, st.v_sb, st.v_st, st.do_sb, st.do_st);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  flash_bwd_dq_kernel<T, D><<<dim3(sq / C::BM, H, b), C::THREADS, smem,
                              stream>>>(
      qp, kp, vp, dop, lse, delta, q_seg, kv_seg, static_cast<T*>(dq), sq, sk,
      H, Hk, causal, sm_scale, st.q_sb, st.q_st, st.k_sb, st.k_st, st.v_sb,
      st.v_st, st.do_sb, st.do_st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16. Strides are in
// elements; heads and head_dim of q/k/v/do are dense. Returns
// cudaGetLastError() after the launch(es), or -1 for a dtype/head_dim the
// kernels are not built for.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, const void* q_seg,
    const void* kv_seg, void* o, void* lse, int b, int sq, int sk, int H,
    int Hk, int D, int causal, int dtype, long long q_sb, long long q_st,
    long long k_sb, long long k_st, long long v_sb, long long v_st,
    void* stream) {
  const Strides st{q_sb, q_st, k_sb, k_st, v_sb, v_st, 0, 0};
#define FA_FWD(TT, DD)                                                      \
  return fwd<TT, DD>(q, k, v, static_cast<const int*>(q_seg),               \
                     static_cast<const int*>(kv_seg), o,                    \
                     static_cast<float*>(lse), b, sq, sk, H, Hk, causal, st, \
                     static_cast<cudaStream_t>(stream))
  if (dtype == 1) {
    if (D == 64) FA_FWD(__nv_bfloat16, 64);
    if (D == 128) FA_FWD(__nv_bfloat16, 128);
    if (D == 256) FA_FWD(__nv_bfloat16, 256);
  } else if (dtype == 2) {
    if (D == 64) FA_FWD(__half, 64);
    if (D == 128) FA_FWD(__half, 128);
    if (D == 256) FA_FWD(__half, 256);
  } else if (dtype == 0) {
    if (D == 64) FA_FWD(float, 64);
    if (D == 128) FA_FWD(float, 128);
    if (D == 256) FA_FWD(float, 256);
  }
#undef FA_FWD
  return -1;
}

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* q_seg,
    const void* kv_seg, void* dq, void* dk, void* dv, int b, int sq, int sk,
    int H, int Hk, int D, int causal, int dtype, float sm_scale,
    long long q_sb, long long q_st, long long k_sb, long long k_st,
    long long v_sb, long long v_st, long long do_sb, long long do_st,
    void* stream) {
  const Strides st{q_sb, q_st, k_sb, k_st, v_sb, v_st, do_sb, do_st};
#define FA_BWD(TT, DD)                                                        \
  return bwd<TT, DD>(q, k, v, dout, static_cast<const float*>(lse),           \
                     static_cast<const float*>(delta),                        \
                     static_cast<const int*>(q_seg),                          \
                     static_cast<const int*>(kv_seg), dq, dk, dv, b, sq, sk,  \
                     H, Hk, causal, sm_scale, st,                             \
                     static_cast<cudaStream_t>(stream))
  if (dtype == 1) {
    if (D == 64) FA_BWD(__nv_bfloat16, 64);
    if (D == 128) FA_BWD(__nv_bfloat16, 128);
    if (D == 256) FA_BWD(__nv_bfloat16, 256);
  } else if (dtype == 2) {
    if (D == 64) FA_BWD(__half, 64);
    if (D == 128) FA_BWD(__half, 128);
    if (D == 256) FA_BWD(__half, 256);
  } else if (dtype == 0) {
    if (D == 64) FA_BWD(float, 64);
    if (D == 128) FA_BWD(float, 128);
    if (D == 256) FA_BWD(float, 256);
  }
#undef FA_BWD
  return -1;
}
