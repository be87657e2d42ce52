// Adam / AdamW over a list of tensors in one pass: the port's counterpart
// of paddle_tpu/optimizer/optimizer.py::_fused_step_apply (:317), which
// traces every parameter's Adam rule (optimizers.py:100-121, AdamW's
// decoupled decay :150-154) into one XLA executable. The reference has
// no Pallas kernel here; on the card the update is one launch over a
// table of tensors (the multi-tensor-apply pattern) instead of ~20
// eager ops a tensor.
//
// What bounds it: bytes. Each element reads w, g, m and v once and
// writes w, m and v once (and a low-precision copy of w when w is a
// master): 28 bytes an f32 element with f32 moments, 20 with bf16
// moments, against ~15 f32 operations, so HBM's rate is the limit
// (gpt2_small's 124 M parameters: ~3.5 GB, ~1.0 ms at 3.35 TB/s).
// The design keeps it simple: each block takes one chunk of one tensor,
// each thread four elements at a time (four independent loads of each
// array in flight), scalar and coalesced, so any start address and any
// tail are taken as they are.
//
// The arithmetic is the reference's, op for op, in f32 with no FMA
// contraction (the __f*_rn intrinsics), so it rounds as the plain
// version's separate torch ops do: the gradient is widened to f32
// (optimizer.py:391-392), Adam's coupled L2 added to it first, the
// moments kept in f32 or bf16/f16 (rounded to nearest even on the
// store), the bias corrections from each tensor's beta1_pow/beta2_pow.
//
// The powers: every block of a tensor reads its old beta*_pow, so the
// new value may be stored only after all of them have read it. A second
// launch of one block on the same stream advances them, after the
// update kernel has finished; no block of the update writes a power.
//
// The table travels as kernel parameters (the tensors' addresses, sizes,
// types and decays: up to MTA_MAX_TENSORS a launch, under the 32,764
// bytes CUDA 12.1+ allows), so nothing is copied from the host before a
// launch and a CUDA graph captures the table with the launch.
//
// The statistics variant (mta_launch_stats: the numerics plane's packed
// bundle, the reference's pack_stats over (work, grad, new work),
// paddle_tpu/optimizer/optimizer.py:388-402). The update is in place, so
// a separate pass would need a copy of every pre-update work array and
// would read g, w and the new w from HBM once more; the update already
// holds all three in registers. So each block also sums, over its chunk,
// five f32 values: g^2 and g's nonfinite elements (g widened to f32,
// before Adam's L2 term), w^2, (new w - w)^2 and the new w's nonfinite
// elements; each thread in its own order, then warp shuffles and shared
// memory in a fixed order, one row of a [chunks, 5] scratch a block.
// mta_advance, which runs after the update anyway, folds each tensor's
// rows (one warp a tensor, a fixed order) into row `pos` of a [P, 5]
// table, which the caller lays out as pack_stats does. Every sum
// is taken in a fixed order, so the bundle is the same from run to run;
// the update's own arithmetic is the same code in both variants, so
// parameters and moments are bit-equal with the statistics on and off.
// It adds 20 bytes a chunk and a [P, 5] table to the update's traffic.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#define MTA_MAX_TENSORS 192
#define MTA_CHUNK 16384
#define MTA_THREADS 512
#define MTA_ILP 4

enum { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2, DT_NONE = 3 };

struct MtaTensor {
  float* w;           // the work array (f32 parameter or master), updated
  const void* g;      // the gradient, f32 / bf16 / f16
  void* m;            // first moment, f32 / bf16 / f16, updated
  void* v;            // second moment, same type as m, updated
  void* out;          // bf16 / f16 copy of the new w (masters), or null
  float* pow1;        // beta1_pow, read here, advanced by mta_advance
  float* pow2;        // beta2_pow
  long long n;
  float wd;           // the tensor's group decay (0: none)
  int codes;          // g | m << 2 | out << 4, each a DT_* code
  int pos;            // its row in the statistics table (stats variant)
};

struct MtaTable {
  MtaTensor t[MTA_MAX_TENSORS];
  int chunk_end[MTA_MAX_TENSORS];   // cumulative chunks up to tensor i
  int count;
};

struct MtaHyper {
  const float* lr;    // f32 device scalar
  float b1, omb1, b2, omb2, eps;
  int decoupled;      // 1: AdamW (decay after the step), 0: Adam (L2)
  float* rows;        // stats variant: [chunks, MTA_STATS] scratch
};

#define MTA_STATS 5   // g^2, g nonfinite, w^2, (new w - w)^2, new w nonfinite

static_assert(sizeof(MtaTable) + sizeof(MtaHyper) <= 32764,
              "kernel parameters exceed CUDA's limit");

__device__ __forceinline__ float load_f(const void* p, long long i,
                                        int code) {
  if (code == DT_F32) return static_cast<const float*>(p)[i];
  if (code == DT_BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return __half2float(static_cast<const __half*>(p)[i]);
}

__device__ __forceinline__ void store_f(void* p, long long i, int code,
                                        float x) {
  if (code == DT_F32)
    static_cast<float*>(p)[i] = x;
  else if (code == DT_BF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  else
    static_cast<__half*>(p)[i] = __float2half_rn(x);
}

__device__ __forceinline__ float nonfinite(float x) {
  return isfinite(x) ? 0.f : 1.f;
}

// sum of `x` over the block, the same order every run; every thread gets
// the result in lane 0 of warp 0 only
__device__ __forceinline__ float block_sum(float x, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < MTA_THREADS / 32; ++w) t += smem[w];
  __syncthreads();
  return t;
}

template <bool STATS>
__global__ void __launch_bounds__(MTA_THREADS)
mta_update(const __grid_constant__ MtaTable tab,
           const __grid_constant__ MtaHyper hp) {
  // the tensor this block's chunk belongs to: the first whose
  // cumulative chunk count exceeds the block index (empty tensors own
  // no chunk and are passed over)
  const int b = blockIdx.x;
  int lo = 0, hi = tab.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tab.chunk_end[mid] > b) hi = mid; else lo = mid + 1;
  }
  const MtaTensor& T = tab.t[lo];
  const int first = lo == 0 ? 0 : tab.chunk_end[lo - 1];
  const long long start = static_cast<long long>(b - first) * MTA_CHUNK;
  const long long end = start + MTA_CHUNK < T.n ? start + MTA_CHUNK : T.n;
  const int gc = T.codes & 3, mc = (T.codes >> 2) & 3,
            oc = (T.codes >> 4) & 3;

  const float lr = *hp.lr;
  // the reference's b1p = beta1_pow * beta1, 1 - b1p, lr * wd (f32)
  const float c1 = __fsub_rn(1.f, __fmul_rn(*T.pow1, hp.b1));
  const float c2 = __fsub_rn(1.f, __fmul_rn(*T.pow2, hp.b2));
  const float wd = T.wd;
  const float lrwd = __fmul_rn(lr, wd);
  const bool l2 = !hp.decoupled && wd != 0.f;
  const bool decay = hp.decoupled && wd != 0.f;
  // the statistics' partial sums (STATS only)
  float s_gsq = 0.f, s_gnf = 0.f, s_wsq = 0.f, s_dsq = 0.f, s_pnf = 0.f;

  for (long long base = start + threadIdx.x; base < end;
       base += MTA_ILP * MTA_THREADS) {
    float w[MTA_ILP], g[MTA_ILP], m[MTA_ILP], v[MTA_ILP];
#pragma unroll
    for (int k = 0; k < MTA_ILP; ++k) {
      const long long i = base + k * MTA_THREADS;
      if (i < end) {
        w[k] = T.w[i];
        g[k] = load_f(T.g, i, gc);
        m[k] = load_f(T.m, i, mc);
        v[k] = load_f(T.v, i, mc);
      }
    }
#pragma unroll
    for (int k = 0; k < MTA_ILP; ++k) {
      const long long i = base + k * MTA_THREADS;
      if (i >= end) continue;
      float gk = g[k];
      if (l2) gk = __fadd_rn(gk, __fmul_rn(wd, w[k]));
      const float mk = __fadd_rn(__fmul_rn(hp.b1, m[k]),
                                 __fmul_rn(hp.omb1, gk));
      const float vk = __fadd_rn(__fmul_rn(hp.b2, v[k]),
                                 __fmul_rn(hp.omb2, __fmul_rn(gk, gk)));
      const float mh = __fdiv_rn(mk, c1);
      const float vh = __fdiv_rn(vk, c2);
      const float upd = __fdiv_rn(__fmul_rn(lr, mh),
                                  __fadd_rn(__fsqrt_rn(vh), hp.eps));
      float nw = __fsub_rn(w[k], upd);
      if (decay) nw = __fsub_rn(nw, __fmul_rn(lrwd, w[k]));
      if (STATS) {
        const float d = __fsub_rn(nw, w[k]);
        s_gsq = __fadd_rn(s_gsq, __fmul_rn(g[k], g[k]));
        s_gnf += nonfinite(g[k]);
        s_wsq = __fadd_rn(s_wsq, __fmul_rn(w[k], w[k]));
        s_dsq = __fadd_rn(s_dsq, __fmul_rn(d, d));
        s_pnf += nonfinite(nw);
      }
      T.w[i] = nw;
      store_f(T.m, i, mc, mk);
      store_f(T.v, i, mc, vk);
      if (oc != DT_NONE) store_f(T.out, i, oc, nw);
    }
  }
  if (STATS) {
    __shared__ float smem[MTA_THREADS / 32];
    const float part[MTA_STATS] = {s_gsq, s_gnf, s_wsq, s_dsq, s_pnf};
#pragma unroll
    for (int j = 0; j < MTA_STATS; ++j) {
      const float t = block_sum(part[j], smem);
      if (threadIdx.x == 0) hp.rows[b * MTA_STATS + j] = t;
    }
  }
}

// beta*_pow *= beta*, once a tensor, after every block of mta_update
// has read the old values (stream order). STATS: one warp a tensor folds
// its chunks' rows of `rows` into row T.pos of `table`: lane l sums chunks
// l, l + 32, ... in order, then a fixed shuffle tree.
template <bool STATS>
__global__ void mta_advance(const __grid_constant__ MtaTable tab,
                            float b1, float b2, const float* rows,
                            float* table) {
  for (int t = threadIdx.x; t < tab.count; t += blockDim.x) {
    *tab.t[t].pow1 = __fmul_rn(*tab.t[t].pow1, b1);
    *tab.t[t].pow2 = __fmul_rn(*tab.t[t].pow2, b2);
  }
  if (!STATS) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < tab.count; t += blockDim.x >> 5) {
    const int first = t == 0 ? 0 : tab.chunk_end[t - 1];
    const int last = tab.chunk_end[t];
    float acc[MTA_STATS] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int c = first + lane; c < last; c += 32)
#pragma unroll
      for (int j = 0; j < MTA_STATS; ++j)
        acc[j] = __fadd_rn(acc[j], rows[c * MTA_STATS + j]);
#pragma unroll
    for (int j = 0; j < MTA_STATS; ++j) {
      float x = acc[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
      if (lane == 0) table[tab.t[t].pos * MTA_STATS + j] = x;
    }
  }
}

extern "C" int mta_max_tensors() { return MTA_MAX_TENSORS; }

extern "C" int mta_chunk() { return MTA_CHUNK; }

extern "C" int mta_stats_cols() { return MTA_STATS; }

static int launch(int count, const unsigned long long* ptrs,
                  const long long* n, const float* wd, const int* codes,
                  const int* pos, const void* lr, float b1, float omb1,
                  float b2, float omb2, float eps, int decoupled,
                  float* rows, float* table, void* stream) {
  if (count < 1 || count > MTA_MAX_TENSORS) return cudaErrorInvalidValue;
  MtaTable tab;
  int chunks = 0;
  for (int i = 0; i < count; ++i) {
    const unsigned long long* p = ptrs + 7 * i;
    MtaTensor& T = tab.t[i];
    T.w = reinterpret_cast<float*>(p[0]);
    T.g = reinterpret_cast<const void*>(p[1]);
    T.m = reinterpret_cast<void*>(p[2]);
    T.v = reinterpret_cast<void*>(p[3]);
    T.out = reinterpret_cast<void*>(p[4]);
    T.pow1 = reinterpret_cast<float*>(p[5]);
    T.pow2 = reinterpret_cast<float*>(p[6]);
    T.n = n[i];
    T.wd = wd[i];
    T.codes = codes[i];
    T.pos = pos == nullptr ? 0 : pos[i];
    const long long c = (n[i] + MTA_CHUNK - 1) / MTA_CHUNK;
    if (n[i] < 0 || chunks + c > 0x7fffffffLL) return cudaErrorInvalidValue;
    chunks += static_cast<int>(c);
    tab.chunk_end[i] = chunks;
  }
  tab.count = count;
  MtaHyper hp{static_cast<const float*>(lr), b1, omb1, b2, omb2, eps,
              decoupled, rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool stats = rows != nullptr;
  if (chunks > 0) {
    if (stats)
      mta_update<true><<<chunks, MTA_THREADS, 0, s>>>(tab, hp);
    else
      mta_update<false><<<chunks, MTA_THREADS, 0, s>>>(tab, hp);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (stats)
    mta_advance<true><<<1, 256, 0, s>>>(tab, b1, b2, rows, table);
  else
    mta_advance<false><<<1, 256, 0, s>>>(tab, b1, b2, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// One update of `count` tensors. ptrs: count x 7 addresses (w, g, m, v,
// out or 0, beta1_pow, beta2_pow); n, wd, codes: one each a tensor;
// lr: an f32 device scalar. Returns the first CUDA error of the two
// launches, or 0.
extern "C" int mta_launch(int count, const unsigned long long* ptrs,
                          const long long* n, const float* wd,
                          const int* codes, const void* lr, float b1,
                          float omb1, float b2, float omb2, float eps,
                          int decoupled, void* stream) {
  return launch(count, ptrs, n, wd, codes, nullptr, lr, b1, omb1, b2, omb2,
                eps, decoupled, nullptr, nullptr, stream);
}

// The same update with the statistics: `rows` is a scratch of at least
// chunks x MTA_STATS floats (chunks: the sum over the tensors of
// ceil(n / MTA_CHUNK)), `table` the [P, MTA_STATS] table, `pos` each
// tensor's row in it.
extern "C" int mta_launch_stats(int count, const unsigned long long* ptrs,
                                const long long* n, const float* wd,
                                const int* codes, const int* pos,
                                const void* lr, float b1, float omb1,
                                float b2, float omb2, float eps,
                                int decoupled, void* rows, void* table,
                                void* stream) {
  if (rows == nullptr || table == nullptr) return cudaErrorInvalidValue;
  return launch(count, ptrs, n, wd, codes, pos, lr, b1, omb1, b2, omb2, eps,
                decoupled, static_cast<float*>(rows),
                static_cast<float*>(table), stream);
}

