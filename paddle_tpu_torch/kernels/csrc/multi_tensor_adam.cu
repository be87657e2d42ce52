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
};

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
      T.w[i] = nw;
      store_f(T.m, i, mc, mk);
      store_f(T.v, i, mc, vk);
      if (oc != DT_NONE) store_f(T.out, i, oc, nw);
    }
  }
}

// beta*_pow *= beta*, once a tensor, after every block of mta_update
// has read the old values (stream order)
__global__ void mta_advance(const __grid_constant__ MtaTable tab,
                            float b1, float b2) {
  for (int t = threadIdx.x; t < tab.count; t += blockDim.x) {
    *tab.t[t].pow1 = __fmul_rn(*tab.t[t].pow1, b1);
    *tab.t[t].pow2 = __fmul_rn(*tab.t[t].pow2, b2);
  }
}

extern "C" int mta_max_tensors() { return MTA_MAX_TENSORS; }

extern "C" int mta_chunk() { return MTA_CHUNK; }

// One update of `count` tensors. ptrs: count x 7 addresses (w, g, m, v,
// out or 0, beta1_pow, beta2_pow); n, wd, codes: one each a tensor;
// lr: an f32 device scalar. Returns the first CUDA error of the two
// launches, or 0.
extern "C" int mta_launch(int count, const unsigned long long* ptrs,
                          const long long* n, const float* wd,
                          const int* codes, const void* lr, float b1,
                          float omb1, float b2, float omb2, float eps,
                          int decoupled, void* stream) {
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
    const long long c = (n[i] + MTA_CHUNK - 1) / MTA_CHUNK;
    if (n[i] < 0 || chunks + c > 0x7fffffffLL) return cudaErrorInvalidValue;
    chunks += static_cast<int>(c);
    tab.chunk_end[i] = chunks;
  }
  tab.count = count;
  MtaHyper hp{static_cast<const float*>(lr), b1, omb1, b2, omb2, eps,
              decoupled};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunks > 0) {
    mta_update<<<chunks, MTA_THREADS, 0, s>>>(tab, hp);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  mta_advance<<<1, 256, 0, s>>>(tab, b1, b2);
  return static_cast<int>(cudaGetLastError());
}
