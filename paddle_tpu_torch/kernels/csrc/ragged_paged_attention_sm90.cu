// Ragged paged attention (B3) for Hopper (sm_90a), bf16 and f16 at
// head_dim 64 and 128: the design the serving engine's packed waves run.
// Hand-written CUDA C++.
//
// Replaces the TPU kernel paddle_tpu/kernels/pallas/ragged_paged_attention.py
// ::_ragged_pallas (:313, kernel _ragged_kernel :166) for bf16 (or f16)
// q/k/v over pools of the same type at D in {64, 128}, with 16-byte
// aligned token rows. The element type T is a template parameter: f16
// runs the same tiles and the f16 twins of the wgmma products, rounding
// p to f16 where bf16 rounds it to bf16.
// ragged_paged_attention.cu (the simple design) keeps f32, int8 pools,
// D 256 and unaligned token strides. It computes what _ragged_reference
// (kernels/ragged_paged_attention.py) computes: for each packed query
// token t and q head h, one online softmax over
//   (a) its row's cached context in the token-major paged pool
//       [T_pool, Hk, D] (the row's owned pages, slots below kv_start), then
//   (b) the packed fresh k/v of its own row at positions <= pos[t];
// q head h reads kv head h / (H / Hk); f32 output [T, H, D]; a dead token
// (row -1) writes exactly 0, as does a token with no valid key.
//
// What bounds it on this card (chip_smoke.py::_bound): bytes, at every
// shape of chip_smoke.py's phase 2. At gpt3_1p3b's fresh wave (8 rows of
// ~536 tokens, H 16, D 128, no pool) the work is ~18.4M valid (head, key)
// pairs, 9.4 GFLOP at 4·D a pair (0.0095 ms at the tensor cores' bf16
// rate), against ~88 MB to move, of which the f32 output alone is 35 MB
// (0.026 ms at HBM's rate). A prefix-resume wave (8 tails of 8-32 tokens
// over a shared 512-token prefix) moves a few MB and does ~0.3 GFLOP.
// So the kernel has to read each K/V row into shared memory once per q
// tile, not once per query token, and stream the output out once.
//
// Design. The Pallas kernel's visit of every pool tile and every packed
// tile for every q tile is not carried over; this is B1's sm90 tile
// (flash_fwd_sm90.cu) turned ragged, on the operands that
// ragged_plan builds once per packed wave:
//   1. q tiles from the plan. The plan sorts the live tokens by (row,
//      position) into a permutation and cuts each row's run into tiles of
//      BM = 64 tokens, one warpgroup; each tile belongs to one row (128
//      tokens over two warpgroups was tried: faster on some waves, slower
//      on others, PERF.md). The grid is (q head, tile slot), tile slots
//      ordered by the keys they walk, longest first. The tile's q rows
//      are gathered through the permutation by cp.async (16 bytes a lane)
//      into the 128-byte-swizzled layout the wgmma descriptors read, and
//      its output rows are written back through the same permutation,
//      so any packing is right. Tiles of dead tokens only zero their rows.
//   2. Pool phase. Key tiles of 64 slots are gathered page by page from
//      the row's pages in start order (the plan's page_ids / page_cnt):
//      slot i of key tile kt is slot (64 kt + i) % bs of the row's page
//      (64 kt + i) / bs. TMA cannot gather rows on sm_90, so cp.async
//      does, into a ring of STAGES buffers as in B1. A slot at or past
//      its page's count is masked to -inf in S; its load is clamped to an
//      address inside the pool.
//   3. Packed phase. Key tiles come from the row's own sorted tokens,
//      masked by pos[key] <= pos[q]; only the tiles up to the last key
//      at or below the tile's largest position are loaded (the plan's
//      kend). The loading threads write each key's mask word (its
//      position, or INT_MIN for a valid pool slot and INT_MAX for an
//      invalid one) beside the tile, so the mask is one compare a score,
//      and it is skipped where a thread's rows see the whole tile: a pool
//      tile within the row's leading valid slots (the plan's count), a
//      packed tile whose last, largest word lies at or below the rows'
//      positions. The gather indices of a key tile (perm, spos, the page
//      lookups) are fetched into registers one tile ahead of its copies,
//      so their loads run under the previous tile's products.
//   4. Products. S = Q Kᵀ by wgmma m64n64k16 from shared memory with f32
//      accumulation; the softmax scale is applied to S in f32 after the
//      product, so Q stays exact (the reference rounds q·scale to T
//      first). O += P V by wgmma with P packed to T from the score
//      registers and V read MN-major through the transpose bit; l is
//      summed from the f32 p. Softmax in base 2 with the max taken on the
//      raw scores, as B1's: one FFMA and one ex2 a score.
//   5. Epilogue. o = acc / l, or 0 where l = 0; f32 rows stored through
//      the permutation (each quad writes 32 contiguous bytes a row).
//
// The copies, descriptors and wgmma products are sm90_wgmma.cuh's,
// shared with B1 and B2. Ring depths are compile-time (RPA90_D64_STAGES,
// RPA90_D128_STAGES), so a probe can build variants and time them beside
// the default (tools/flash_fwd_probe.py --ragged). At D 128 a CTA takes
// 215 registers a thread and 81 KB of shared memory with a 2-buffer
// ring, so two share an SM; a third buffer leaves one and was slower.
// Launches run on the caller's stream, allocate nothing and do not
// synchronise; the C entry returns cudaGetLastError().
#include <limits.h>

#include "sm90_wgmma.cuh"

#ifndef RPA90_D64_STAGES
#define RPA90_D64_STAGES 3
#endif
#ifndef RPA90_D128_STAGES
#define RPA90_D128_STAGES 2
#endif

namespace {

constexpr float kNegInit = -1e30f;
constexpr int BN = 64;  // keys a tile

template <int D_, int STAGES_>
struct Cfg {
  static constexpr int D = D_, STAGES = STAGES_;
  static constexpr int BM = 64, THREADS = 128;  // q rows: one warpgroup
  static constexpr int NT_S = BN / 8, NT_D = D / 8, KQ = D / 16, KP = BN / 16;
  static constexpr int CPR = D / 8;       // 16-byte chunks a row
  static constexpr uint32_t QB = BM * D * 2;  // bytes of the Q tile
  static constexpr uint32_t TB = BN * D * 2;  // bytes of one K or V tile
  // + 1024: the tiles start on a 1024-byte boundary (the swizzle atom)
  static constexpr size_t SMEM = QB + 2 * STAGES * TB + 1024;
  static_assert(D % 64 == 0 && STAGES >= 2,
                "64-column swizzle blocks, a ring");
  static_assert((BM * CPR) % THREADS == 0 && (BN * CPR) % THREADS == 0,
                "tiles split evenly into 16-byte copies");
};

template <class T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const T* kpool;
  const T* vpool;
  const int* perm;      // [T] packed index of each sorted token
  const int* spos;      // [T] position of each sorted token
  const int* tiles;     // [n_tiles, 8] (row, lo, n, kend, rs, cnt, full, 0)
  const int* page_ids;  // [B, NB] the row's pages in start order
  const int* page_cnt;  // [B, NB] valid slots of each
  const int* npages;    // [B]
  float* out;           // [T, H, D]
  int H, Hk, NB, bs, pool_pages, with_pool;
  long long q_st, k_st, v_st;
  float scale_log2;  // softmax scale * log2(e)
};

// what a CTA walks: its row, the row's first sorted token and its packed
// tokens, its valid pages, its pool key tiles, the leading pool slots
// that are all valid, and the kv head
struct Walk {
  int r, rs, cnt, np, NP, full, hk;
};

// the key rows one thread copies of a key tile, fetched ahead of the
// copies: each row's index (a pool row page * bs + slot, or a packed
// token) and its mask word (INT_MIN for a valid pool slot, which every
// query sees; INT_MAX for an invalid slot or a key past the row's
// tokens, which none sees; else the key's position)
template <class C>
struct KeyRows {
  static constexpr int N = BN * C::CPR / C::THREADS;
  int idx[N];
  int word[N];
};

// fetch the key rows of key tile kb (the row's pool tiles first, then
// its packed ones). A pool slot past the row's pages reads a slot of a
// page inside the pool, masked.
template <class C, class T>
__device__ __forceinline__ void fetch_rows(const Params<T>& p, const Walk& w,
                                           int kb, KeyRows<C>& kr) {
#pragma unroll
  for (int it = 0; it < KeyRows<C>::N; ++it) {
    const int i = (it * C::THREADS + static_cast<int>(threadIdx.x)) / C::CPR;
    if (kb < w.NP) {
      const int vs = kb * BN + i;  // the row's virtual pool slot
      const int jp = vs / p.bs;
      const int s = vs - jp * p.bs;
      const int jc = min(jp, p.NB - 1);
      const bool ok = jp < w.np && s < __ldg(p.page_cnt + w.r * p.NB + jc);
      const int page =
          min(__ldg(p.page_ids + w.r * p.NB + jc), p.pool_pages - 1);
      kr.idx[it] = page * p.bs + s;
      kr.word[it] = ok ? INT_MIN : INT_MAX;
    } else {
      const int idx = (kb - w.NP) * BN + i;  // the row's sorted token
      const int u = w.rs + min(idx, w.cnt - 1);
      kr.idx[it] = __ldg(p.perm + u);
      kr.word[it] = idx < w.cnt ? __ldg(p.spos + u) : INT_MAX;
    }
  }
}

// issue the cp.async copies of key tile kb's fetched rows into ring
// buffers Kt / Vt and write its mask words (plain shared stores, read
// after the barrier that precedes the tile's use)
template <class C, class T>
__device__ __forceinline__ void issue_rows(const Params<T>& p, const Walk& w,
                                           int kb, const KeyRows<C>& kr,
                                           uint32_t Kt, uint32_t Vt,
                                           int* words) {
  constexpr int D = C::D, CPR = C::CPR;
#pragma unroll
  for (int it = 0; it < KeyRows<C>::N; ++it) {
    const int i = it * C::THREADS + static_cast<int>(threadIdx.x);
    const int row = i / CPR, c = i % CPR;
    const T* ks;
    const T* vs;
    if (kb < w.NP) {
      const long long at =
          (static_cast<long long>(kr.idx[it]) * p.Hk + w.hk) * D;
      ks = p.kpool + at;
      vs = p.vpool + at;
    } else {
      const long long tok = kr.idx[it];
      ks = p.k + tok * p.k_st + static_cast<long long>(w.hk) * D;
      vs = p.v + tok * p.v_st + static_cast<long long>(w.hk) * D;
    }
    cp_async16(Kt + swz<BN>(row, c), ks + c * 8);
    cp_async16(Vt + swz<BN>(row, c), vs + c * 8);
    if (c == 0) words[row] = kr.word[it];
  }
}

// the online-softmax step of one key tile for a warp's 16 rows: where
// `mask`, masks s by the tile's words against the rows' positions; folds
// s's row max into m (raw units: the scale is positive), turns s into
// unnormalised p = 2^(s·scale·log2e − m·scale·log2e) (masked scores are
// -inf, so p = 0), adds p's row sums to l and returns in alpha the
// factor the accumulator takes
__device__ __forceinline__ void softmax_step(float (&s)[BN / 8][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             const int* words, bool mask,
                                             const int (&qpos)[2], int t,
                                             float sl2) {
  if (mask) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int2 w = *reinterpret_cast<const int2*>(words + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (((e & 1) ? w.y : w.x) > qpos[e >> 1]) s[j][e] = neg_inf();
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m[i];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
    mx = quad_max(mx);
    const float ms = mx * sl2;
    // (m_old - mx) first: exactly 0 when the max did not move, also at
    // the -1e30 start
    alpha[i] = ex2((m[i] - mx) * sl2);
    m[i] = mx;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e) {
        const float pe = ex2(fmaf(s[j][e], sl2, -ms));
        s[j][e] = pe;
        rs += pe;
      }
    l[i] = l[i] * alpha[i] + rs;
  }
}

// grid (H, tile slots); warp w of the warpgroup owns q rows 16 w ..
// 16 w + 15 of the tile, in the m16n8k16
// accumulator layout (lane g = lane / 4, t = lane % 4: rows g and g + 8,
// columns 8j + 2t and 8j + 2t + 1 of n8 tile j)
template <class C, class T>
__global__ void __launch_bounds__(C::THREADS, 1)
rpa_sm90(const Params<T> p) {
  constexpr int D = C::D, BM = C::BM, S = C::STAGES, THREADS = C::THREADS;
  constexpr int CPR = C::CPR;
  constexpr uint32_t TB = C::TB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(16) int words[S][BN];
  const uint32_t Qs = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t Ks = Qs + C::QB;   // [S] tiles
  const uint32_t Vs = Ks + S * TB;  // [S] tiles

  const int h = blockIdx.x;
  const int4 t0 = __ldg(reinterpret_cast<const int4*>(p.tiles) +
                        2 * static_cast<long long>(blockIdx.y));
  const int4 t1 = __ldg(reinterpret_cast<const int4*>(p.tiles) +
                        2 * static_cast<long long>(blockIdx.y) + 1);
  const int r = t0.x, lo = t0.y, n = t0.z, kend = t0.w;
  if (n <= 0) return;
  if (r < 0) {  // dead tokens: their rows of this head are 0
    for (int i = threadIdx.x; i < n * (D / 4); i += THREADS) {
      const long long tok = __ldg(p.perm + lo + i / (D / 4));
      reinterpret_cast<float4*>(p.out + (tok * p.H + h) * D)[i % (D / 4)] =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  Walk w;
  w.r = r;
  w.rs = t1.x;
  w.cnt = t1.y;
  w.full = t1.z;
  w.hk = h / (p.H / p.Hk);
  w.np = p.with_pool ? __ldg(p.npages + r) : 0;
  w.NP = (w.np * p.bs + BN - 1) / BN;        // pool key tiles
  const int nkb = w.NP + (kend + BN - 1) / BN;  // + packed key tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = warp * 16 + g;  // this thread's first row

  // prologue: Q (gathered through the permutation; rows past n repeat
  // the tile's last token) and key tile 0 in group 0, tiles 1 .. S - 2
  // one group each; the rows of tile S - 1 fetched
#pragma unroll
  for (int it = 0; it < BM * CPR / THREADS; ++it) {
    const int i = it * THREADS + static_cast<int>(threadIdx.x);
    const int row = i / CPR, c = i % CPR;
    const long long tok = __ldg(p.perm + lo + min(row, n - 1));
    cp_async16(Qs + swz<BM>(row, c),
               p.q + tok * p.q_st + static_cast<long long>(h) * D + c * 8);
  }
  KeyRows<C> kr;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nkb) {
      fetch_rows<C>(p, w, s, kr);
      issue_rows<C>(p, w, s, kr, Ks + s * TB, Vs + s * TB, words[s]);
    }
    cp_commit();
  }
  if (S - 1 < nkb) fetch_rows<C>(p, w, S - 1, kr);
  // rows past the tile's tokens see no packed key (they are not stored)
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qpos[i] = i0 + 8 * i < n ? __ldg(p.spos + lo + i0 + 8 * i) : INT_MIN;

  float acc[C::NT_D][4];
#pragma unroll
  for (int j = 0; j < C::NT_D; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f};

  for (int kb = 0; kb < nkb; ++kb) {
    cp_wait<S - 2>();     // tile kb (and, at kb = 0, Q) has landed ...
    fence_proxy_async();  // ... is visible to wgmma's reads ...
    __syncthreads();      // ... for every thread; tile kb - 1 is consumed
    {
      // refill the buffer of tile kb - 1 with tile nb, from the rows
      // fetched during tile kb - 1; then fetch tile nb + 1's rows, whose
      // loads run while tile kb is computed
      const int nb = kb + S - 1;
      if (nb < nkb) {
        const int st = nb % S;
        issue_rows<C>(p, w, nb, kr, Ks + st * TB, Vs + st * TB, words[st]);
      }
      cp_commit();
      if (nb + 1 < nkb) fetch_rows<C>(p, w, nb + 1, kr);
    }
    const int st = kb % S;
    const uint32_t Kt = Ks + st * TB;
    const uint32_t Vt = Vs + st * TB;

    // S = Q Kᵀ; Q and K K-major: k16 step kk is 32 bytes into 64-column
    // block kk / 4, 8-row groups 1024 bytes apart
    float sc[BN / 8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KQ; ++kk)
      wgmma_ss<BN, T>(sc,
                   wdesc(Qs + (kk >> 2) * (BM * 128) + (kk & 3) * 32, 16,
                         1024),
                   wdesc(Kt + (kk >> 2) * (BN * 128) + (kk & 3) * 32, 16,
                         1024),
                   kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    pin(sc);

    // a pool tile wholly inside the row's leading valid slots, or a
    // packed tile whose last (largest) word none of this thread's rows
    // is below, needs no mask
    const bool mask = kb < w.NP ? (kb + 1) * BN > w.full
                                : words[st][BN - 1] > min(qpos[0], qpos[1]);
    float alpha[2];
    softmax_step(sc, m, l, alpha, words[st], mask, qpos, t, p.scale_log2);
#pragma unroll
    for (int j = 0; j < C::NT_D; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
    uint32_t pa[C::KP][4];
    pack_p<BN, T>(pa, sc);

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

  // o = acc / l through the permutation; l = 0 (no valid key) gives 0
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i0 + 8 * i;
    const float lt = quad_sum(l[i]);
    if (row >= n) continue;
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
    const long long tok = __ldg(p.perm + lo + row);
    float* orow = p.out + (tok * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < C::NT_D; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) =
          make_float2(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
  }
}

template <class C, class T>
int launch(const Params<T>& p, int n_tiles, void* stream) {
  // once per instantiation, outside any stream capture that follows
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      rpa_sm90<C, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM)));
  if (attr) return attr;
  if (p.Hk < 1 || p.H % p.Hk) return -2;
  if (n_tiles < 1) return 0;
  rpa_sm90<C, T><<<dim3(p.H, n_tiles), C::THREADS, C::SMEM,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

using Cfg64 = Cfg<64, RPA90_D64_STAGES>;
using Cfg128 = Cfg<128, RPA90_D128_STAGES>;

template <class T>
int launch_d(const void* q, const void* k_new, const void* v_new,
             const void* kpool, const void* vpool, const void* perm,
             const void* spos, const void* tiles, const void* page_ids,
             const void* page_cnt, const void* npages, void* out, int n_tiles,
             int H, int Hk, int D, int NB, int bs, int pool_pages,
             int with_pool, long long q_st, long long k_st, long long v_st,
             float scale, void* stream) {
  Params<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k_new);
  p.v = static_cast<const T*>(v_new);
  p.kpool = static_cast<const T*>(kpool);
  p.vpool = static_cast<const T*>(vpool);
  p.perm = static_cast<const int*>(perm);
  p.spos = static_cast<const int*>(spos);
  p.tiles = static_cast<const int*>(tiles);
  p.page_ids = static_cast<const int*>(page_ids);
  p.page_cnt = static_cast<const int*>(page_cnt);
  p.npages = static_cast<const int*>(npages);
  p.out = static_cast<float*>(out);
  p.H = H;
  p.Hk = Hk;
  p.NB = NB;
  p.bs = bs;
  p.pool_pages = pool_pages;
  p.with_pool = with_pool;
  p.q_st = q_st;
  p.k_st = k_st;
  p.v_st = v_st;
  p.scale_log2 = scale * kLog2e;
  if (D == 64) return launch<Cfg64, T>(p, n_tiles, stream);
  if (D == 128) return launch<Cfg128, T>(p, n_tiles, stream);
  return -1;
}

}  // namespace

// q/k/v and pools of dtype code 1 (bfloat16) or 3 (float16) (kpool/vpool
// may be null without a pool), head_dim 64 or 128; token strides in
// elements; n_tiles rows of `tiles`. Returns cudaGetLastError() after the
// launch, -1 for a dtype or head_dim this kernel is not built for, -2 for
// heads that do not group.
extern "C" int ragged_paged_attention_sm90_launch(
    const void* q, const void* k_new, const void* v_new, const void* kpool,
    const void* vpool, const void* perm, const void* spos, const void* tiles,
    const void* page_ids, const void* page_cnt, const void* npages, void* out,
    int n_tiles, int H, int Hk, int D, int NB, int bs, int pool_pages,
    int with_pool, int dtype, long long q_st, long long k_st, long long v_st,
    float scale, void* stream) {
  if (dtype == 1)
    return launch_d<bf16>(q, k_new, v_new, kpool, vpool, perm, spos, tiles,
                          page_ids, page_cnt, npages, out, n_tiles, H, Hk, D,
                          NB, bs, pool_pages, with_pool, q_st, k_st, v_st,
                          scale, stream);
  if (dtype == 3)
    return launch_d<f16>(q, k_new, v_new, kpool, vpool, perm, spos, tiles,
                         page_ids, page_cnt, npages, out, n_tiles, H, Hk, D,
                         NB, bs, pool_pages, with_pool, q_st, k_st, v_st,
                         scale, stream);
  return -1;
}
