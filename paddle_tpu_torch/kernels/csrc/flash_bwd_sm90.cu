// Flash attention backward (B2) for Hopper (sm_90a), bf16 and f16 at
// head_dim 64 and 128: the design the training path runs. Hand-written
// CUDA C++.
//
// Replaces the TPU kernel paddle_tpu/kernels/pallas/flash_attention.py
// ::_flash_bwd_fused (:457, pallas_call :544, kernel _bwd_kernel :364)
// for bf16 or f16 q/k/v/do at D in {64, 128} (the element type T is a
// template parameter; f16 rounds p and ds to f16 where bf16 rounds them
// to bf16, as the reference casts them to the input dtype).
// flash_attention.cu's flash_bwd_dkdv_kernel / flash_bwd_dq_kernel keep
// f32 at any D and bf16/f16 at D 256. It computes what _flash_bwd_reference
// (kernels/flash_attention.py) computes, on the paddle layout
// [b, s, heads, D], from (q_scaled, k, v, o, lse [b, H, sq] f32 in
// natural log, do):
//   * delta = rowsum(do·o) in f32, [b, H, sq] (flash_bwd_delta below,
//     the reference's :521-525);
//   * per (q head, key) pair: p = exp(s - lse), masked to exactly 0;
//     dv += cast(p)ᵀ·do; dp = do·vᵀ; ds = p·(dp - delta);
//     dk += cast(ds)ᵀ·q_scaled; dq += cast(ds)·k; dq is scaled by
//     sm_scale in f32 and cast to q's dtype once;
//   * GQA (a dk/dv owner walks every q head of its group), the
//     bottom-right causal offset sk - sq, segment ids; a key no query sees
//     gets dk = dv = 0 and a query with no valid key dq = 0;
//   * q, k, v and do are read through a batch and a token stride (the
//     fused qkv projection's views are read in place); heads and head_dim
//     dense, rows 16-byte aligned (the wrapper checks).
//
// What bounds it on this card (chip_smoke.py::_flash_bound: 10·D flops a
// valid pair, q, k, v, o, do, dq, dk, dv, lse and delta moved once): at
// gpt2_small's training shape (b 16, s 1024, H 12, D 64, causal) 64.5
// GFLOP over 202.9 MB, 0.0652 ms at the tensor cores' bf16 rate against
// 0.0606 ms at HBM's: operations, by a little. At gpt3_1p3b's (b 4,
// s 2048, H 16, D 128, causal) 171.9 GFLOP over 269.5 MB: operations
// (0.1738 ms against 0.0804). So the products have to run on wgmma, fed
// from shared memory without the threads building fragments, and the
// exp and the elementwise dS beside them.
//
// Design (stage 1: the deterministic split, on wgmma). Against
// flash_attention.cu's kernels (the simple design: 64-row tiles, 4 warps,
// mma.sync on fragments built from scalar shared-memory loads,
// synchronous tiles, P and dS through shared memory):
//   1. dk/dv kernel, grid (sk / 128, Hk, b): two consumer warpgroups own
//      64 keys each; K and V of the CTA's 128 keys load once. The CTA
//      walks the q tiles (BQ queries) of every q head of its GQA group
//      through a ring of STAGES buffers of (Q, dO, lse, delta) filled by
//      cp.async in the 128-byte swizzle, one __syncthreads a tile. Per
//      tile and warpgroup:
//        Sᵀ  = K·Qᵀ           wgmma, K and Q K-major from shared memory
//        dPᵀ = V·dOᵀ          wgmma, issued right behind Sᵀ
//        Pᵀ  = exp(Sᵀ - lse)  in the accumulator registers, while dPᵀ runs
//        dSᵀ = Pᵀ∘(dPᵀ - δ)   in dPᵀ's registers
//        dV += Pᵀ·dO          wgmma, Pᵀ packed from registers, dO MN-major
//                              through the transpose bit (as B1 reads V)
//        dK += dSᵀ·Q          wgmma, dSᵀ packed from registers, Q MN-major,
//                              in one group with dV
//      Packing both after dSᵀ keeps at most Sᵀ, dPᵀ, dK and dV live (not
//      the packed Pᵀ beside them), which is what lets 128-query tiles fit
//      at D 64.
//      dK and dV stay in registers and are written once, at the end.
//   2. dq kernel, grid (sq / 128, H, b), longest causal tile first: two
//      warpgroups own 64 queries each; Q and dO load once, K and V tiles
//      (BN keys) stream through the ring. S = Q·Kᵀ and dP = dO·Vᵀ by
//      wgmma from shared memory, P and dS in registers, dQ += dS·K by
//      wgmma with dS from registers and K MN-major. dq is scaled and cast
//      once.
//   3. Neither P nor dS touches shared memory; no fragment is built by
//      the threads (no ldmatrix, no scalar shared-memory loads). exp is
//      exp2 of s·log2e - lse·log2e (one FFMA and one ex2.approx a score).
//   4. Causal skipping is per tile and uniform over a warpgroup, as wgmma
//      needs: the dk/dv loop starts at the first q tile that sees the
//      CTA's keys and a warpgroup skips the tiles that see none of its
//      own; the dq loop stops at the last k tile the CTA's rows see and a
//      warpgroup skips the tiles beyond its own rows' diagonal (B1's
//      rule). The mask is evaluated only on tiles that straddle a warp's
//      diagonal or carry segment ids.
// What stage 1 leaves on the table: S and dP are computed in both
// kernels, 7 score-sized products a pair instead of the 5 of a single
// pass (dq accumulated across key tiles by atomics). A single pass needs
// dS with query rows as a wgmma operand while the dk/dv kernel holds dSᵀ
// with key rows in registers, so dS would have to go through shared
// memory. The sums are deterministic: every output element is owned by
// one thread of one CTA.
//
// Registers bound the tiles: a dk/dv thread holds dK and dV (2 × D / 2
// f32) beside Sᵀ and dPᵀ (2 × BQ / 2), so BQ is 128 at D 64 and 64 at
// D 128; a dq thread holds dQ (D / 2) beside S and dP (2 × BN / 2), BN
// 128. nvcc -Xptxas -v (tools/flash_fwd_probe.py --bwd): dk/dv 252 and
// 243 registers, dq 206 and 243, delta 26-28, no spills, no stack; one
// 256-thread CTA an SM. Tile widths and ring depths are -D macros
// (FB90_*), so the probe can build variants and time them beside the
// default.
// Launches run on the caller's stream, allocate nothing and do not
// synchronise; the C entries return cudaGetLastError().
#include "sm90_wgmma.cuh"

// q-tile width and ring depth of the dk/dv loop, k-tile width and ring
// depth of the dq loop, per head_dim
#ifndef FB90_D64_BQ
#define FB90_D64_BQ 128
#endif
#ifndef FB90_D64_KV_STAGES
#define FB90_D64_KV_STAGES 3
#endif
#ifndef FB90_D64_BN
#define FB90_D64_BN 128
#endif
#ifndef FB90_D64_DQ_STAGES
#define FB90_D64_DQ_STAGES 3
#endif
#ifndef FB90_D128_BQ
#define FB90_D128_BQ 64
#endif
#ifndef FB90_D128_KV_STAGES
#define FB90_D128_KV_STAGES 3
#endif
#ifndef FB90_D128_BN
#define FB90_D128_BN 128
#endif
#ifndef FB90_D128_DQ_STAGES
#define FB90_D128_DQ_STAGES 2
#endif

namespace {

// the dk/dv kernel: BK = 128 keys a CTA, (Q, dO) tiles of BQ queries
template <int D_, int BQ_, int STAGES_>
struct KvCfg {
  static constexpr int D = D_, BQ = BQ_, STAGES = STAGES_;
  static constexpr int BK = 128, THREADS = 256;
  static constexpr int NT_S = BQ / 8, NT_D = D / 8, KD = D / 16, KQ = BQ / 16;
  static constexpr uint32_t KB = BK * D * 2;  // bytes of the K (or V) tile
  static constexpr uint32_t TB = BQ * D * 2;  // bytes of one Q (or dO) tile
  static constexpr uint32_t RB = BQ * 4;      // bytes of one lse (or delta) row
  // + 1024: the tiles start on a 1024-byte boundary (the swizzle atom)
  static constexpr size_t SMEM = 2 * KB + STAGES * (2 * TB + 2 * RB) + 1024;
  static_assert(D % 64 == 0 && (BQ == 32 || BQ == 64 || BQ == 128) &&
                    STAGES >= 2,
                "64-column swizzle blocks, wgmma widths, a ring");
  static_assert((BK * D / 8) % THREADS == 0 && (BQ * D / 8) % THREADS == 0,
                "tiles split evenly into 16-byte copies");
};

// the dq kernel: BM = 128 queries a CTA, (K, V) tiles of BN keys
template <int D_, int BN_, int STAGES_>
struct QCfg {
  static constexpr int D = D_, BN = BN_, STAGES = STAGES_;
  static constexpr int BM = 128, THREADS = 256;
  static constexpr int NT_S = BN / 8, NT_D = D / 8, KD = D / 16, KP = BN / 16;
  static constexpr uint32_t QB = BM * D * 2;  // bytes of the Q (or dO) tile
  static constexpr uint32_t TB = BN * D * 2;  // bytes of one K (or V) tile
  static constexpr size_t SMEM = 2 * QB + 2 * STAGES * TB + 1024;
  static_assert(D % 64 == 0 && (BN == 32 || BN == 64 || BN == 128) &&
                    STAGES >= 2,
                "64-column swizzle blocks, wgmma widths, a ring");
  static_assert((BM * D / 8) % THREADS == 0 && (BN * D / 8) % THREADS == 0,
                "tiles split evenly into 16-byte copies");
};

// K-major descriptor of k16 step kk of a tile of R rows (64-column blocks
// R * 128 bytes apart), from byte `row` of its first 64-column block
template <int R>
__device__ __forceinline__ uint64_t kdesc(uint32_t row, int kk) {
  return wdesc(row + (kk >> 2) * (R * 128) + (kk & 3) * 32, 16, 1024);
}
// MN-major descriptor of k16 step kp (16 rows) of an R-row tile read
// through the transpose bit, as B1 reads V
template <int R>
__device__ __forceinline__ uint64_t tdesc(uint32_t tile, int kp) {
  return wdesc(tile + kp * 2048, R * 128, 1024);
}

// two f32 from shared memory at a 32-bit address (ordered after the
// barrier that publishes them)
__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// one output row pair of a warp's accumulator (rows g and g + 8 of its 16,
// columns 8j + 2t, 8j + 2t + 1) as T, scaled, into [.., heads, D]
template <int NT_D, class T>
__device__ __forceinline__ void store_acc(T* base, long long row0,
                                          int heads, int head, int g, int t,
                                          const float (&acc)[NT_D][4],
                                          float scale) {
  constexpr int D = NT_D * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    T* out = base + ((row0 + g + 8 * i) * heads + head) *
                        static_cast<long long>(D);
#pragma unroll
    for (int j = 0; j < NT_D; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * t) =
          pack2<T>(acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// delta = rowsum(do · o) in f32, [b, H, sq]: L lanes a (batch, token, head)
// row, each reading 16 bytes of do and of o at a time, 32 / L rows a warp,
// tokens fastest so that a warp's writes are contiguous
// ---------------------------------------------------------------------------
template <typename T, int D>
struct DeltaCfg {
  static constexpr int CH = D * static_cast<int>(sizeof(T)) / 16;  // chunks
  static constexpr int L = CH < 32 ? CH : 32;  // lanes of a row
  static constexpr int ROWS = 8 * (32 / L);    // rows of a 256-thread block
};

// the f32 dot product of two 16-byte chunks
__device__ __forceinline__ float dot16(const uint4& x, const uint4& y, float) {
  return fmaf(__uint_as_float(x.x), __uint_as_float(y.x),
              fmaf(__uint_as_float(x.y), __uint_as_float(y.y),
                   fmaf(__uint_as_float(x.z), __uint_as_float(y.z),
                        __uint_as_float(x.w) * __uint_as_float(y.w))));
}
__device__ __forceinline__ float dot16(const uint4& x, const uint4& y, bf16) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(a[i]), w = __bfloat1622float2(b[i]);
    acc = fmaf(u.x, w.x, fmaf(u.y, w.y, acc));
  }
  return acc;
}
__device__ __forceinline__ float dot16(const uint4& x, const uint4& y, f16) {
  const __half2* a = reinterpret_cast<const __half2*>(&x);
  const __half2* b = reinterpret_cast<const __half2*>(&y);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __half22float2(a[i]), w = __half22float2(b[i]);
    acc = fmaf(u.x, w.x, fmaf(u.y, w.y, acc));
  }
  return acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const T* __restrict__ dout, const T* __restrict__ o,
                float* __restrict__ delta, int b, int sq, int H,
                long long do_sb, long long do_st, long long o_sb,
                long long o_st) {
  using C = DeltaCfg<T, D>;
  const int lane = threadIdx.x & 31, c0 = lane % C::L;
  const long long r = static_cast<long long>(blockIdx.x) * C::ROWS +
                      (threadIdx.x >> 5) * (32 / C::L) + lane / C::L;
  const bool live = r < static_cast<long long>(b) * H * sq;
  float acc = 0.f;
  if (live) {
    const int s = static_cast<int>(r % sq);
    const int h = static_cast<int>((r / sq) % H);
    const int bi = static_cast<int>(r / (static_cast<long long>(sq) * H));
    const uint4* dp = reinterpret_cast<const uint4*>(
        dout + bi * do_sb + s * do_st + static_cast<long long>(h) * D);
    const uint4* op = reinterpret_cast<const uint4*>(
        o + bi * o_sb + s * o_st + static_cast<long long>(h) * D);
#pragma unroll
    for (int c = c0; c < C::CH; c += C::L)
      acc += dot16(__ldg(dp + c), __ldg(op + c), T());
  }
  // every lane takes part in the shuffles, live or not
#pragma unroll
  for (int m = C::L / 2; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (live && c0 == 0) delta[r] = acc;
}

// ---------------------------------------------------------------------------
// dk and dv. grid (sk / 128, Hk, b); warpgroup wg owns keys
// [k0 + 64 wg, k0 + 64 wg + 64), its warp w keys 16 w .. 16 w + 15 of those,
// in the accumulator layout (lane g = lane / 4, t = lane % 4: keys g and
// g + 8, queries 8j + 2t and 8j + 2t + 1 of n8 tile j)
// ---------------------------------------------------------------------------
template <class C, class T>
__global__ void __launch_bounds__(C::THREADS, 1)
flash_bwd_dkdv_sm90(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ q_seg,
                    const int* __restrict__ kv_seg, T* __restrict__ dk,
                    T* __restrict__ dv, int sq, int sk, int H, int Hk,
                    int causal, long long q_sb, long long q_st, long long k_sb,
                    long long k_st, long long v_sb, long long v_st,
                    long long do_sb, long long do_st) {
  constexpr int D = C::D, BQ = C::BQ, BK = C::BK, S = C::STAGES;
  constexpr int THREADS = C::THREADS;
  constexpr uint32_t TB = C::TB, RB = C::RB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t Ks = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t Vs = Ks + C::KB;
  const uint32_t Qs = Vs + C::KB;    // [S] tiles
  const uint32_t Os = Qs + S * TB;   // [S] dO tiles
  const uint32_t Ls = Os + S * TB;   // [S] lse rows, then [S] delta rows

  const int k0 = blockIdx.x * BK, hk = blockIdx.y, bi = blockIdx.z;
  const int G = H / Hk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int offset = sk - sq;
  const int kw0 = k0 + wg * 64;            // this warpgroup's first key
  const int kr0 = kw0 + (warp & 3) * 16;   // this warp's first key
  // queries that see some key of the tile: q >= k0 - offset (causal)
  const int qlo = causal ? max(0, k0 - offset) : 0;
  const int qb0 = qlo / BQ;
  const int nqt = qlo < sq ? sq / BQ - qb0 : 0;
  const int nit = G * nqt;  // (q head, q tile) pairs, head-major

  // stage st <- the (Q, dO, lse, delta) tiles of pair it
  auto issue = [&](int it, int st) {
    const int h = hk * G + it / nqt, q0 = (qb0 + it % nqt) * BQ;
    cp_tile<D, BQ, THREADS>(
        Qs + st * TB, q + bi * q_sb + q0 * q_st + static_cast<long long>(h) * D,
        q_st);
    cp_tile<D, BQ, THREADS>(Os + st * TB,
                            dout + bi * do_sb + q0 * do_st +
                                static_cast<long long>(h) * D,
                            do_st);
    constexpr int CH = BQ / 4;  // 16-byte chunks of one row
    if (tid < 2 * CH) {
      const int c = tid % CH, which = tid / CH;
      const float* src = (which ? delta : lse) +
                         (static_cast<long long>(bi) * H + h) * sq + q0 + 4 * c;
      cp_async16(Ls + (which * S + st) * RB + 16 * c, src);
    }
  };

  if (nit > 0) {
    cp_tile<D, BK, THREADS>(
        Ks, k + bi * k_sb + k0 * k_st + static_cast<long long>(hk) * D, k_st);
    cp_tile<D, BK, THREADS>(
        Vs, v + bi * v_sb + k0 * v_st + static_cast<long long>(hk) * D, v_st);
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
      if (s < nit) issue(s, s);
      cp_commit();
    }
  }
  float dk_acc[C::NT_D][4], dv_acc[C::NT_D][4];
#pragma unroll
  for (int j = 0; j < C::NT_D; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  // this warpgroup's rows of K and V, K-major
  const uint32_t krow = Ks + wg * 64 * 128, vrow = Vs + wg * 64 * 128;

  for (int it = 0; it < nit; ++it) {
    cp_wait<S - 2>();     // pair it (at it = 0 K and V too) landed ...
    fence_proxy_async();  // ... is visible to wgmma's reads ...
    __syncthreads();      // ... for every thread; pair it - 1 is consumed
    {
      const int nb = it + S - 1;  // refill the buffer of pair it - 1
      if (nb < nit) issue(nb, nb % S);
      cp_commit();
    }
    const int st = it % S;
    const int q0 = (qb0 + it % nqt) * BQ;
    // no query of the tile sees this warpgroup's keys
    if (causal && q0 + BQ - 1 + offset < kw0) continue;
    const uint32_t Qt = Qs + st * TB, Ot = Os + st * TB;

    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, two groups back to back
    float s[C::NT_S][4], dp[C::NT_S][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk)
      wgmma_ss<BQ, T>(s, kdesc<BK>(krow, kk), kdesc<BQ>(Qt, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk)
      wgmma_ss<BQ, T>(dp, kdesc<BK>(vrow, kk), kdesc<BQ>(Ot, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // Sᵀ has landed
    pin(s);

    // Pᵀ = exp(Sᵀ - lse), column j's lse; masked pairs exactly 0
    const uint32_t ls = Ls + st * RB, dl = Ls + (S + st) * RB;
    const bool masked = q_seg || (causal && kr0 + 15 > q0 + offset);
#pragma unroll
    for (int j = 0; j < C::NT_S; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 l2 = lds_f2(ls + 4 * c);
      s[j][0] = ex2(fmaf(s[j][0], kLog2e, -l2.x * kLog2e));
      s[j][1] = ex2(fmaf(s[j][1], kLog2e, -l2.y * kLog2e));
      s[j][2] = ex2(fmaf(s[j][2], kLog2e, -l2.x * kLog2e));
      s[j][3] = ex2(fmaf(s[j][3], kLog2e, -l2.y * kLog2e));
      if (masked) {
        // segment ids of queries c, c + 1 and of keys g, g + 8 (loaded
        // here, not held across the loop: registers are what bounds this
        // kernel)
        int qsg[2] = {0, 0}, ksg[2] = {0, 0};
        if (q_seg) {
          const long long qb = static_cast<long long>(bi) * sq + q0 + c;
          const long long kb = static_cast<long long>(bi) * sk + kr0 + g;
          qsg[0] = __ldg(q_seg + qb);
          qsg[1] = __ldg(q_seg + qb + 1);
          ksg[0] = __ldg(kv_seg + kb);
          ksg[1] = __ldg(kv_seg + kb + 8);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kr0 + g + 8 * (e >> 1), qq = q0 + c + (e & 1);
          bool ok = !causal || key <= qq + offset;
          if (q_seg) ok = ok && ksg[e >> 1] == qsg[e & 1];
          if (!ok) s[j][e] = 0.f;
        }
      }
    }
    wgmma_wait<0>();  // dPᵀ has landed
    pin(dp);

    // dSᵀ = Pᵀ (dPᵀ - delta) into dPᵀ's registers, column j's delta
#pragma unroll
    for (int j = 0; j < C::NT_S; ++j) {
      const float2 d2 = lds_f2(dl + 4 * (8 * j + 2 * t));
      dp[j][0] = s[j][0] * (dp[j][0] - d2.x);
      dp[j][1] = s[j][1] * (dp[j][1] - d2.y);
      dp[j][2] = s[j][2] * (dp[j][2] - d2.x);
      dp[j][3] = s[j][3] * (dp[j][3] - d2.y);
    }
    uint32_t pa[C::KQ][4], da[C::KQ][4];
    pack_p<BQ, T>(pa, s);   // p cast to do's dtype
    pack_p<BQ, T>(da, dp);  // ds cast to q's dtype

    // dV += Pᵀ dO and dK += dSᵀ Q, one group: dO and Q MN-major
    pin(dv_acc);
    pin(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kp = 0; kp < C::KQ; ++kp)
      wgmma_rs_t<D, T>(dv_acc, pa[kp], tdesc<BQ>(Ot, kp));
#pragma unroll
    for (int kp = 0; kp < C::KQ; ++kp)
      wgmma_rs_t<D, T>(dk_acc, da[kp], tdesc<BQ>(Qt, kp));
    wgmma_commit();
    wgmma_wait<0>();
    pin(dv_acc);
    pin(dk_acc);
    pin(pa);
    pin(da);
  }
  cp_wait<0>();  // only empty groups can be left; drained before exit

  const long long row0 = static_cast<long long>(bi) * sk + kr0;
  store_acc<C::NT_D>(dk, row0, Hk, hk, g, t, dk_acc, 1.f);
  store_acc<C::NT_D>(dv, row0, Hk, hk, g, t, dv_acc, 1.f);
}

// ---------------------------------------------------------------------------
// dq. grid (sq / 128, H, b); warpgroup wg owns queries [q0 + 64 wg,
// q0 + 64 wg + 64), in B1's accumulator layout (rows queries, columns keys)
// ---------------------------------------------------------------------------
template <class C, class T>
__global__ void __launch_bounds__(C::THREADS, 1)
flash_bwd_dq_sm90(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const int* __restrict__ q_seg,
                  const int* __restrict__ kv_seg, T* __restrict__ dq,
                  int sq, int sk, int H, int Hk, int causal, float sm_scale,
                  long long q_sb, long long q_st, long long k_sb,
                  long long k_st, long long v_sb, long long v_st,
                  long long do_sb, long long do_st) {
  constexpr int D = C::D, BM = C::BM, BN = C::BN, S = C::STAGES;
  constexpr int THREADS = C::THREADS;
  constexpr uint32_t TB = C::TB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t Qs = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t Os = Qs + C::QB;   // the dO tile
  const uint32_t Ks = Os + C::QB;   // [S] tiles
  const uint32_t Vs = Ks + S * TB;  // [S] tiles

  // causal: longest q tile of each (batch, head) first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BM, h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (H / Hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int offset = sk - sq;
  const int rg0 = q0 + wg * 64;          // this warpgroup's first query
  const int r0 = rg0 + (warp & 3) * 16;  // this warp's first query

  const T* kbase = k + bi * k_sb + static_cast<long long>(hk) * D;
  const T* vbase = v + bi * v_sb + static_cast<long long>(hk) * D;
  // keys [0, kend) are visible to some row of this tile; this
  // warpgroup's rows see tiles [0, nkw) (uniform over it, as wgmma needs)
  const int kend = causal ? min(sk, q0 + BM + offset) : sk;
  const int nkb = kend > 0 ? (kend + BN - 1) / BN : 0;
  const int kw = causal ? min(sk, rg0 + 64 + offset) : sk;
  const int nkw = kw > 0 ? (kw + BN - 1) / BN : 0;

  // prologue: Q, dO and tile 0 in group 0, tiles 1 .. S - 2 one group each
  if (nkb > 0) {
    cp_tile<D, BM, THREADS>(
        Qs, q + bi * q_sb + q0 * q_st + static_cast<long long>(h) * D, q_st);
    cp_tile<D, BM, THREADS>(
        Os, dout + bi * do_sb + q0 * do_st + static_cast<long long>(h) * D,
        do_st);
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
      if (s < nkb) {
        cp_tile<D, BN, THREADS>(Ks + s * TB, kbase + s * BN * k_st, k_st);
        cp_tile<D, BN, THREADS>(Vs + s * TB, vbase + s * BN * v_st, v_st);
      }
      cp_commit();
    }
  }
  // lse (in base 2) and delta of rows r0 + g and r0 + g + 8
  float lse2[2], dl[2];
  int qsg[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long at =
        (static_cast<long long>(bi) * H + h) * sq + r0 + g + 8 * i;
    lse2[i] = lse[at] * kLog2e;
    dl[i] = delta[at];
    if (q_seg) qsg[i] = q_seg[static_cast<long long>(bi) * sq + r0 + g + 8 * i];
  }

  float dq_acc[C::NT_D][4];
#pragma unroll
  for (int j = 0; j < C::NT_D; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;
  const uint32_t qrow = Qs + wg * 64 * 128, orow = Os + wg * 64 * 128;

  for (int kb = 0; kb < nkb; ++kb) {
    cp_wait<S - 2>();
    fence_proxy_async();
    __syncthreads();
    {
      const int nb = kb + S - 1;
      if (nb < nkb) {
        const int st = nb % S;
        cp_tile<D, BN, THREADS>(Ks + st * TB, kbase + nb * BN * k_st, k_st);
        cp_tile<D, BN, THREADS>(Vs + st * TB, vbase + nb * BN * v_st, v_st);
      }
      cp_commit();
    }
    if (kb >= nkw) continue;
    const uint32_t Kt = Ks + (kb % S) * TB, Vt = Vs + (kb % S) * TB;
    const int k0 = kb * BN;

    // S = Q Kᵀ and dP = dO Vᵀ, two groups back to back
    float s[C::NT_S][4], dp[C::NT_S][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk)
      wgmma_ss<BN, T>(s, kdesc<BM>(qrow, kk), kdesc<BN>(Kt, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk)
      wgmma_ss<BN, T>(dp, kdesc<BM>(orow, kk), kdesc<BN>(Vt, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S has landed
    pin(s);

    // P = exp(S - lse), row i's lse; masked pairs exactly 0
    const bool masked = kv_seg || (causal && k0 + BN - 1 > r0 + offset);
#pragma unroll
    for (int j = 0; j < C::NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = ex2(fmaf(s[j][e], kLog2e, -lse2[e >> 1]));
      if (masked) {
        const int c = k0 + 8 * j + 2 * t;
        int ks[2] = {0, 0};
        if (kv_seg) {
          ks[0] = __ldg(kv_seg + static_cast<long long>(bi) * sk + c);
          ks[1] = __ldg(kv_seg + static_cast<long long>(bi) * sk + c + 1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + g + 8 * (e >> 1);
          bool ok = !causal || c + (e & 1) <= row + offset;
          if (kv_seg) ok = ok && qsg[e >> 1] == ks[e & 1];
          if (!ok) s[j][e] = 0.f;
        }
      }
    }
    wgmma_wait<0>();
    pin(dp);
    // dS = P (dP - delta)
#pragma unroll
    for (int j = 0; j < C::NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= dp[j][e] - dl[e >> 1];
    uint32_t da[C::KP][4];
    pack_p<BN, T>(da, s);  // ds cast to k's dtype

    // dQ += dS K, K MN-major
    pin(dq_acc);
    wgmma_fence();
#pragma unroll
    for (int kp = 0; kp < C::KP; ++kp)
      wgmma_rs_t<D, T>(dq_acc, da[kp], tdesc<BN>(Kt, kp));
    wgmma_commit();
    wgmma_wait<0>();
    pin(dq_acc);
    pin(da);
  }
  cp_wait<0>();

  store_acc<C::NT_D>(dq, static_cast<long long>(bi) * sq + r0, H, h, g, t,
                     dq_acc, sm_scale);
}

using Kv64 = KvCfg<64, FB90_D64_BQ, FB90_D64_KV_STAGES>;
using Kv128 = KvCfg<128, FB90_D128_BQ, FB90_D128_KV_STAGES>;
using Q64 = QCfg<64, FB90_D64_BN, FB90_D64_DQ_STAGES>;
using Q128 = QCfg<128, FB90_D128_BN, FB90_D128_DQ_STAGES>;

template <class KC, class QC, class T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, const void* q_seg,
           const void* kv_seg, void* dq, void* dk, void* dv, int b, int sq,
           int sk, int H, int Hk, int causal, float sm_scale, long long q_sb,
           long long q_st, long long k_sb, long long k_st, long long v_sb,
           long long v_st, long long do_sb, long long do_st,
           cudaStream_t stream) {
  // once per instantiation, outside any stream capture that follows
  static const int attr_kv = static_cast<int>(cudaFuncSetAttribute(
      flash_bwd_dkdv_sm90<KC, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(KC::SMEM)));
  static const int attr_q = static_cast<int>(cudaFuncSetAttribute(
      flash_bwd_dq_sm90<QC, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(QC::SMEM)));
  if (attr_kv) return attr_kv;
  if (attr_q) return attr_q;
  if (sq % QC::BM || sq % KC::BQ || sk % KC::BK || sk % QC::BN || Hk < 1 ||
      H % Hk)
    return -2;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dlp = static_cast<const float*>(delta);
  const int* qsp = static_cast<const int*>(q_seg);
  const int* ksp = static_cast<const int*>(kv_seg);
  flash_bwd_dkdv_sm90<KC, T><<<dim3(sk / KC::BK, Hk, b), KC::THREADS,
                               KC::SMEM, stream>>>(
      qp, kp, vp, dop, lp, dlp, qsp, ksp, static_cast<T*>(dk),
      static_cast<T*>(dv), sq, sk, H, Hk, causal, q_sb, q_st, k_sb, k_st,
      v_sb, v_st, do_sb, do_st);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  flash_bwd_dq_sm90<QC, T><<<dim3(sq / QC::BM, H, b), QC::THREADS, QC::SMEM,
                             stream>>>(
      qp, kp, vp, dop, lp, dlp, qsp, ksp, static_cast<T*>(dq), sq, sk, H,
      Hk, causal, sm_scale, q_sb, q_st, k_sb, k_st, v_sb, v_st, do_sb, do_st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_delta(const void* dout, const void* o, void* delta, int b, int sq,
                 int H, long long do_sb, long long do_st, long long o_sb,
                 long long o_st, cudaStream_t stream) {
  const long long rows = static_cast<long long>(b) * H * sq;
  constexpr int R = DeltaCfg<T, D>::ROWS;
  flash_bwd_delta<T, D><<<static_cast<unsigned>((rows + R - 1) / R), 256, 0,
                          stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(o),
      static_cast<float*>(delta), b, sq, H, do_sb, do_st, o_sb, o_st);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_d(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, const void* q_seg,
             const void* kv_seg, void* dq, void* dk, void* dv, int b, int sq,
             int sk, int H, int Hk, int D, int causal, float sm_scale,
             long long q_sb, long long q_st, long long k_sb, long long k_st,
             long long v_sb, long long v_st, long long do_sb, long long do_st,
             cudaStream_t st) {
  if (D == 64)
    return launch<Kv64, Q64, T>(q, k, v, dout, lse, delta, q_seg, kv_seg, dq,
                                dk, dv, b, sq, sk, H, Hk, causal, sm_scale,
                                q_sb, q_st, k_sb, k_st, v_sb, v_st, do_sb,
                                do_st, st);
  if (D == 128)
    return launch<Kv128, Q128, T>(q, k, v, dout, lse, delta, q_seg, kv_seg,
                                  dq, dk, dv, b, sq, sk, H, Hk, causal,
                                  sm_scale, q_sb, q_st, k_sb, k_st, v_sb,
                                  v_st, do_sb, do_st, st);
  return -1;
}

}  // namespace

// B2 for bf16 (dtype code 1) or f16 (dtype code 2) at head_dim 64 or
// 128, from (q_scaled, k, v, do, lse, delta); the arguments of
// flash_attention.cu's flash_attention_bwd_launch. Strides in elements.
// Returns cudaGetLastError() after the launches, -1 for a dtype or
// head_dim this design is not built for, -2 for lengths its tiles do not
// divide.
extern "C" int flash_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* q_seg,
    const void* kv_seg, void* dq, void* dk, void* dv, int b, int sq, int sk,
    int H, int Hk, int D, int causal, int dtype, float sm_scale,
    long long q_sb, long long q_st, long long k_sb, long long k_st,
    long long v_sb, long long v_st, long long do_sb, long long do_st,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_d<bf16>(q, k, v, dout, lse, delta, q_seg, kv_seg, dq, dk,
                          dv, b, sq, sk, H, Hk, D, causal, sm_scale, q_sb,
                          q_st, k_sb, k_st, v_sb, v_st, do_sb, do_st, st);
  if (dtype == 2)
    return launch_d<f16>(q, k, v, dout, lse, delta, q_seg, kv_seg, dq, dk,
                         dv, b, sq, sk, H, Hk, D, causal, sm_scale, q_sb,
                         q_st, k_sb, k_st, v_sb, v_st, do_sb, do_st, st);
  return -1;
}

// delta = rowsum(do · o) in f32 into [b, H, sq], for both of B2's designs:
// dtype 0 = float32, 1 = bfloat16, 2 = float16, head_dim 64, 128 or 256;
// batch and token strides in elements (heads and head_dim dense, rows
// 16-byte aligned). Returns cudaGetLastError(), or -1 for what it is not
// built for.
extern "C" int flash_bwd_delta_launch(const void* dout, const void* o,
                                      void* delta, int b, int sq, int H,
                                      int D, int dtype, long long do_sb,
                                      long long do_st, long long o_sb,
                                      long long o_st, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FB_DELTA(TT, DD)                                                    \
  return launch_delta<TT, DD>(dout, o, delta, b, sq, H, do_sb, do_st, o_sb, \
                              o_st, st)
  if (dtype == 1) {
    if (D == 64) FB_DELTA(bf16, 64);
    if (D == 128) FB_DELTA(bf16, 128);
    if (D == 256) FB_DELTA(bf16, 256);
  } else if (dtype == 2) {
    if (D == 64) FB_DELTA(f16, 64);
    if (D == 128) FB_DELTA(f16, 128);
    if (D == 256) FB_DELTA(f16, 256);
  } else if (dtype == 0) {
    if (D == 64) FB_DELTA(float, 64);
    if (D == 128) FB_DELTA(float, 128);
    if (D == 256) FB_DELTA(float, 256);
  }
#undef FB_DELTA
  return -1;
}
