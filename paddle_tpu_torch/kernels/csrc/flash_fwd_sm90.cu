// Flash attention forward (B1) for Hopper (sm_90a), bf16 and f16 at
// head_dim 64 and 128: the design the port's main paths run. Hand-written
// CUDA C++.
//
// Replaces the TPU kernel paddle_tpu/kernels/pallas/flash_attention.py
// ::_flash_fwd_fused (:267, kernel _fwd_kernel :101) for bf16 or f16
// q/k/v at D in {64, 128}. flash_attention.cu::flash_fwd_kernel keeps f32
// at any D and bf16/f16 at D 256 (no model of the main paths has D 256).
// The element type T is a template parameter: f16 runs the same tiles
// and the f16 twins of the wgmma products (sm90_wgmma.cuh), rounding p
// and o to f16 where the bf16 instance rounds them to bf16. It
// computes what _flash_fwd_reference (kernels/flash_attention.py)
// computes, on the paddle layout [b, s, heads, D]:
//   * o = softmax(q_scaled kᵀ) v per (batch, q head), q head h reading kv
//     head h / (H / Hk) (GQA/MQA); bottom-right causal mask (query i sees
//     keys <= i + sk - sq); optional segment-id equality mask; masked
//     scores count as -1e30 and masked probabilities as 0, so a row with
//     no valid key gives o = 0 and lse = -1e30;
//   * an online softmax in f32; p is cast to T before p·v and o is
//     divided by the f32 row sum; lse = m + log(l) in natural log, f32
//     [b, H, sq], which B2 reads back;
//   * q, k and v are read through a batch and a token stride (views of a
//     packed qkv projection are read in place); heads and head_dim dense,
//     rows 16-byte aligned (the wrapper checks).
//
// What bounds it on this card (chip_smoke.py::_flash_bound): at
// gpt2_small's training shape (b 16, s 1024, H 12, D 64, causal) 25.8
// GFLOP over 101.5 MB, 0.0261 ms at the tensor cores' bf16 rate and
// 0.0303 ms at HBM's: bytes, by a little. At gpt3_1p3b's (b 4, s 2048,
// H 16, D 128, causal) 68.7 GFLOP over 134.7 MB: operations (0.0695 ms
// against 0.0403). At the fused encoder's (b 16, s 512, H 12, D 64,
// non-causal) 12.9 GFLOP over 50.7 MB: bytes (0.0151 against 0.0130).
// Both lines are close, so the kernel has to feed the tensor cores from
// shared memory at their rate and keep device memory busy meanwhile;
// the softmax (one ex2 a score, 16 a clock an SM) costs about as much
// as the products at D 64, so another warpgroup's products have to run
// beside it (two a CTA, and two CTAs an SM at D 64).
//
// Design. This is stage 2 of the redesign, wgmma; stage 1 (mma.sync
// m16n8k16 with ldmatrix fragments, Q in registers) was measured and
// replaced. Against flash_attention.cu's flash_fwd_kernel (the simple
// design):
//   1. q tiles of 128 rows per CTA (one CTA per (q tile, head, batch)),
//      two consumer warpgroups of 64 rows, so each K/V tile brought in
//      serves 128 rows, not 64. Q is loaded once into shared memory and
//      read from there by every product (the simple design re-reads its
//      fragments by scalar loads on every k tile).
//   2. K and V tiles of 64 keys go through a ring of STAGES buffers in
//      dynamic shared memory, filled by cp.async.cg 16-byte copies with
//      commit_group / wait_group, so tiles kb + 1 .. kb + STAGES - 1 are
//      in flight while tile kb is computed (3 buffers at both head_dims:
//      at D 64 two CTAs then share an SM, at D 128 one CTA takes it); one
//      __syncthreads a tile (the simple design loads each tile
//      synchronously between two barriers). Tiles are laid out in the
//      128-byte swizzle (16-byte chunk c of a 128-byte row r at
//      c ^ (r & 7)): every cp.async store phase touches 32 distinct
//      banks, and it is the layout wgmma's descriptors read.
//   3. S = Q Kᵀ by wgmma m64n64k16 with Q and K read from shared memory
//      through matrix descriptors (K-major), and O += P V by wgmma
//      m64nDk16 with V read MN-major by the transpose bit. No fragment
//      is built by the threads: no ldmatrix, no scalar shared-memory
//      loads (the simple design builds each of V's fragments from four
//      16-bit loads).
//   4. P stays in registers: the wgmma accumulator layout of two
//      neighbouring n8 score columns is the register A-fragment layout of
//      one k16 step, so the f32 scores are packed to T pairs and fed
//      to P V directly (the simple design stores P to shared memory and
//      reads it back).
//   5. The softmax is in base 2: exp2(s·log2e − m·log2e), one FFMA and
//      one ex2.approx a score; the running max stays in natural units,
//      so lse = m + log(l) as the reference computes it. Row sums are
//      kept per thread and reduced across the quad once, at the end.
//      Masked scores are -inf and the running max starts at -1e30, so a
//      masked probability is exp2(-inf) = 0 with no extra bookkeeping.
//   6. Causal calls take q tiles in reverse order of blockIdx.x: each
//      (batch, head) launches its longest tile first, and the grid ends
//      on short tiles. k tiles above the diagonal are never loaded, a
//      warpgroup skips the products of a tile its rows cannot see, and
//      the mask is evaluated only on tiles that straddle a warp's
//      diagonal or carry segment ids.
//
// The copies, descriptors and wgmma products are sm90_wgmma.cuh's, shared
// with B2 (flash_bwd_sm90.cu). Tile sizes are compile-time (FA90_D64_* /
// FA90_D128_*), so a probe can build variants and time them beside the
// default (tools/flash_fwd_probe.py). Launches
// run on the caller's stream, allocate nothing and do not synchronise;
// the C entry returns cudaGetLastError().
#include "sm90_wgmma.cuh"

// k-tile width, ring depth and CTAs an SM asked of the compiler, per
// head_dim
#ifndef FA90_D64_BN
#define FA90_D64_BN 64
#endif
#ifndef FA90_D64_STAGES
#define FA90_D64_STAGES 3
#endif
#ifndef FA90_D64_MINB
#define FA90_D64_MINB 2
#endif
#ifndef FA90_D128_BN
#define FA90_D128_BN 64
#endif
#ifndef FA90_D128_STAGES
#define FA90_D128_STAGES 3
#endif
#ifndef FA90_D128_MINB
#define FA90_D128_MINB 1
#endif

namespace {

constexpr float kNegInf = -1e30f;

template <int D_, int BN_, int STAGES_, int MINB_>
struct Cfg {
  static constexpr int D = D_, BN = BN_, STAGES = STAGES_, MINB = MINB_;
  static constexpr int BM = 128, THREADS = 256;
  static constexpr int NT_S = BN / 8, NT_D = D / 8, KQ = D / 16, KP = BN / 16;
  static constexpr uint32_t QB = BM * D * 2;  // bytes of the Q tile
  static constexpr uint32_t TB = BN * D * 2;  // bytes of one K or V tile
  // + 1024: the tiles start on a 1024-byte boundary (the swizzle atom)
  static constexpr size_t SMEM = QB + 2 * STAGES * TB + 1024;
  static_assert(D % 64 == 0 && (BN == 64 || BN == 128) && STAGES >= 2,
                "64-column swizzle blocks, wgmma widths, a ring");
  static_assert((BM * D / 8) % THREADS == 0 && (BN * D / 8) % THREADS == 0,
                "tiles split evenly into 16-byte copies");
};

// what the mask and the softmax of one warp need to know of its rows
struct Rows {
  int r0, g, t, offset, causal, bi, sk;
  const int* kv_seg;  // nullptr without segment ids
  int qsg[2];         // the segment ids of rows r0 + g and r0 + g + 8
};

// the online-softmax step of one k tile (keys k0 .. k0 + N - 1) for a warp's
// 16 rows: masks s where it has to, folds its row max into m, turns s into
// unnormalised p (base 2; masked scores are -inf, so p = 0), adds p's row
// sums to l and returns in alpha the factor the accumulator takes
template <int N>
__device__ __forceinline__ void softmax_step(float (&s)[N / 8][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0,
                                             const Rows& w) {
  // mask only tiles that straddle the warp's diagonal or carry segments
  if (w.kv_seg || (w.causal && k0 + N - 1 > w.r0 + w.offset)) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = k0 + 8 * j + 2 * w.t;
      int ks[2] = {0, 0};
      if (w.kv_seg) {
        ks[0] = __ldg(w.kv_seg + static_cast<long long>(w.bi) * w.sk + c);
        ks[1] = __ldg(w.kv_seg + static_cast<long long>(w.bi) * w.sk + c + 1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = w.r0 + w.g + 8 * (e >> 1);
        bool ok = !w.causal || c + (e & 1) <= row + w.offset;
        if (w.kv_seg) ok = ok && w.qsg[e >> 1] == ks[e & 1];
        if (!ok) s[j][e] = neg_inf();
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m[i];
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
    mx = quad_max(mx);
    const float ms = mx * kLog2e;
    // (m_old - mx) first: exactly 0 when the max did not move, also at
    // -1e30, where m_old * log2e - ms could carry ms's rounding error
    // (~1e22) into ex2
    alpha[i] = ex2((m[i] - mx) * kLog2e);
    m[i] = mx;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e) {
        const float p = ex2(fmaf(s[j][e], kLog2e, -ms));
        s[j][e] = p;
        rs += p;
      }
    l[i] = l[i] * alpha[i] + rs;
  }
}

// grid (sq / 128, H, b); warpgroup wg owns q rows [64 wg, 64 wg + 64) of the
// tile, its warp w rows 16 w .. 16 w + 15 of those, in the m16n8k16
// accumulator layout (lane g = lane / 4, t = lane % 4: rows g and g + 8,
// columns 8j + 2t and 8j + 2t + 1 of n8 tile j). Each k tile: S = Q Kᵀ as
// one wgmma group, waited for; the softmax; O += P V as another.
template <class C, class T>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
flash_fwd_sm90(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ q_seg,
               const int* __restrict__ kv_seg, T* __restrict__ o,
               float* __restrict__ lse, int sq, int sk, int H, int Hk,
               int causal, long long q_sb, long long q_st, long long k_sb,
               long long k_st, long long v_sb, long long v_st) {
  constexpr int D = C::D, BM = C::BM, BN = C::BN, S = C::STAGES;
  constexpr int THREADS = C::THREADS;
  constexpr uint32_t TB = C::TB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t Qs = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t Ks = Qs + C::QB;   // [S] tiles
  const uint32_t Vs = Ks + S * TB;  // [S] tiles

  // causal: longest q tile of each (batch, head) first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BM, h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (H / Hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int rg0 = q0 + wg * 64;  // this warpgroup's first query row
  Rows w;
  w.r0 = rg0 + (warp & 3) * 16;  // this warp's first query row
  w.g = lane >> 2;
  w.t = lane & 3;
  w.offset = sk - sq;
  w.causal = causal;
  w.bi = bi;
  w.sk = sk;
  w.kv_seg = kv_seg;
  w.qsg[0] = w.qsg[1] = 0;

  const T* kbase = k + bi * k_sb + static_cast<long long>(hk) * D;
  const T* vbase = v + bi * v_sb + static_cast<long long>(hk) * D;
  // keys [0, kend) are visible to some row of this tile; this
  // warpgroup's rows see tiles [0, nkw) (uniform over it, as wgmma needs)
  const int kend = causal ? min(sk, q0 + BM + w.offset) : sk;
  const int nkb = kend > 0 ? (kend + BN - 1) / BN : 0;
  const int kw = causal ? min(sk, rg0 + 64 + w.offset) : sk;
  const int nkw = kw > 0 ? (kw + BN - 1) / BN : 0;

  // prologue: Q and tile 0 in group 0, tiles 1 .. S - 2 one group each
  if (nkb > 0) {
    cp_tile<D, BM, THREADS>(
        Qs, q + bi * q_sb + q0 * q_st + static_cast<long long>(h) * D, q_st);
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
      if (s < nkb) {
        cp_tile<D, BN, THREADS>(Ks + s * TB, kbase + s * BN * k_st, k_st);
        cp_tile<D, BN, THREADS>(Vs + s * TB, vbase + s * BN * v_st, v_st);
      }
      cp_commit();
    }
  }
  if (q_seg) {
    w.qsg[0] = q_seg[static_cast<long long>(bi) * sq + w.r0 + w.g];
    w.qsg[1] = q_seg[static_cast<long long>(bi) * sq + w.r0 + w.g + 8];
  }

  float acc[C::NT_D][4];
#pragma unroll
  for (int j = 0; j < C::NT_D; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // Q's rows of this warpgroup, K-major: k16 step kk is 32 bytes into
  // 64-column block kk / 4; 8-row groups 1024 bytes apart
  const uint32_t qrow = Qs + wg * 64 * 128;

  for (int kb = 0; kb < nkb; ++kb) {
    cp_wait<S - 2>();     // tile kb (and, at kb = 0, Q) has landed ...
    fence_proxy_async();  // ... is visible to wgmma's reads ...
    __syncthreads();      // ... for every thread; tile kb - 1 is consumed
    {
      const int nb = kb + S - 1;  // refill the buffer of tile kb - 1
      if (nb < nkb) {
        const int st = nb % S;
        cp_tile<D, BN, THREADS>(Ks + st * TB, kbase + nb * BN * k_st, k_st);
        cp_tile<D, BN, THREADS>(Vs + st * TB, vbase + nb * BN * v_st, v_st);
      }
      cp_commit();
    }
    // a tile wholly right of this warpgroup's last row's diagonal adds
    // nothing
    if (kb >= nkw) continue;
    const uint32_t Kt = Ks + (kb % S) * TB;
    const uint32_t Vt = Vs + (kb % S) * TB;

    // S = Q Kᵀ; K is K-major, as Q
    float s[C::NT_S][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KQ; ++kk)
      wgmma_ss<BN, T>(s,
                   wdesc(qrow + (kk >> 2) * (BM * 128) + (kk & 3) * 32, 16,
                         1024),
                   wdesc(Kt + (kk >> 2) * (BN * 128) + (kk & 3) * 32, 16,
                         1024),
                   kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);

    float alpha[2];
    softmax_step<BN>(s, m, l, alpha, kb * BN, w);
#pragma unroll
    for (int j = 0; j < C::NT_D; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
    uint32_t pa[C::KP][4];
    pack_p<BN, T>(pa, s);

    // O += P V; V is MN-major: k16 step kp is two 8-key groups (1024
    // bytes each) on, and 64-column blocks of D are BN * 128 bytes apart
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kp = 0; kp < C::KP; ++kp)
      wgmma_rs_t<D, T>(acc, pa[kp], wdesc(Vt + kp * 2048, BN * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    pin(pa);
  }
  cp_wait<0>();  // only empty groups can be left; drained before exit

  // o = acc / l (the reference divides; a row with no valid key has
  // acc = 0, l = 0, m = -1e30, so o = 0 and lse = -1e30)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lt = quad_sum(l[i]);
    const float sl = lt == 0.f ? 1.f : lt;
    const int row = w.r0 + w.g + 8 * i;
    T* orow = o + ((static_cast<long long>(bi) * sq + row) * H + h) *
                      static_cast<long long>(D);
#pragma unroll
    for (int j = 0; j < C::NT_D; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * w.t) =
          pack2<T>(acc[j][2 * i] / sl, acc[j][2 * i + 1] / sl);
    if (w.t == 0)
      lse[(static_cast<long long>(bi) * H + h) * sq + row] = m[i] + logf(sl);
  }
}

using Cfg64 = Cfg<64, FA90_D64_BN, FA90_D64_STAGES, FA90_D64_MINB>;
using Cfg128 = Cfg<128, FA90_D128_BN, FA90_D128_STAGES, FA90_D128_MINB>;

template <class C, class T>
int launch(const void* q, const void* k, const void* v, const void* q_seg,
           const void* kv_seg, void* o, void* lse, int b, int sq, int sk,
           int H, int Hk, int causal, long long q_sb, long long q_st,
           long long k_sb, long long k_st, long long v_sb, long long v_st,
           void* stream) {
  // once per instantiation, outside any stream capture that follows
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      flash_fwd_sm90<C, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM)));
  if (attr) return attr;
  if (sq % C::BM || sk % C::BN || Hk < 1 || H % Hk) return -2;
  flash_fwd_sm90<C, T><<<dim3(sq / C::BM, H, b), C::THREADS, C::SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), static_cast<T*>(o),
      static_cast<float*>(lse), sq, sk, H, Hk, causal, q_sb, q_st, k_sb, k_st,
      v_sb, v_st);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_d(const void* q, const void* k, const void* v, const void* q_seg,
             const void* kv_seg, void* o, void* lse, int b, int sq, int sk,
             int H, int Hk, int D, int causal, long long q_sb, long long q_st,
             long long k_sb, long long k_st, long long v_sb, long long v_st,
             void* stream) {
  if (D == 64)
    return launch<Cfg64, T>(q, k, v, q_seg, kv_seg, o, lse, b, sq, sk, H, Hk,
                            causal, q_sb, q_st, k_sb, k_st, v_sb, v_st,
                            stream);
  if (D == 128)
    return launch<Cfg128, T>(q, k, v, q_seg, kv_seg, o, lse, b, sq, sk, H,
                             Hk, causal, q_sb, q_st, k_sb, k_st, v_sb, v_st,
                             stream);
  return -1;
}

}  // namespace

// dtype codes 1 = bfloat16, 2 = float16; head_dim 64 or 128; strides in
// elements. Returns cudaGetLastError() after the launch, -1 for a dtype or
// head_dim this kernel is not built for, -2 for lengths its tiles do not
// divide.
extern "C" int flash_fwd_sm90_launch(const void* q, const void* k,
                                     const void* v, const void* q_seg,
                                     const void* kv_seg, void* o, void* lse,
                                     int b, int sq, int sk, int H, int Hk,
                                     int D, int causal, int dtype,
                                     long long q_sb, long long q_st,
                                     long long k_sb, long long k_st,
                                     long long v_sb, long long v_st,
                                     void* stream) {
  if (dtype == 1)
    return launch_d<bf16>(q, k, v, q_seg, kv_seg, o, lse, b, sq, sk, H, Hk,
                          D, causal, q_sb, q_st, k_sb, k_st, v_sb, v_st,
                          stream);
  if (dtype == 2)
    return launch_d<f16>(q, k, v, q_seg, kv_seg, o, lse, b, sq, sk, H, Hk,
                         D, causal, q_sb, q_st, k_sb, k_st, v_sb, v_st,
                         stream);
  return -1;
}
