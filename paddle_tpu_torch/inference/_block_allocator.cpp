// Paged-KV-cache block allocator (serving runtime core).
//
// The native piece of the vLLM-style paged attention stack: physical
// cache blocks are a fixed pool; sequences lease blocks as they grow
// and return them on completion. The reference keeps this bookkeeping
// in its C++ inference runtime next to block_multihead_attention
// (paddle/fluid/inference + phi block_multihead_attention kernels);
// here it is a free-list with O(1) alloc/free and a mutex, exposed
// through a C ABI consumed via ctypes (paddle_tpu_torch/inference/
// paged_cache.py). Device-side cache tensors stay in PyTorch; only the
// block accounting lives here. The same source and C ABI back
// paddle_tpu's paged cache, so both packages make the same decisions.
//
// Blocks carry REFCOUNTS (automatic prefix caching: one physical page
// can back the shared prompt prefix of many sequences). pba_alloc
// hands out blocks at refcount 1; pba_ref adds sharers; pba_free is
// unref — a block returns to the free list only when its count drops
// to zero. Every mutation is validated ALL-OR-NOTHING before any state
// changes: a double free, an out-of-range id, or an over-unref within
// one call returns a negative error code and leaves the free list
// untouched (it can never be corrupted by a bad caller).
#include <cstdint>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

struct Allocator {
  std::vector<int32_t> free_list;  // stack of free block ids
  std::vector<int32_t> refcount;   // 0 = free
  std::mutex mu;
  explicit Allocator(int32_t num_blocks)
      : free_list(), refcount(static_cast<size_t>(num_blocks), 0) {
    free_list.reserve(static_cast<size_t>(num_blocks));
    // hand out low ids first (pop from the back)
    for (int32_t i = num_blocks - 1; i >= 0; --i) free_list.push_back(i);
  }
};

}  // namespace

extern "C" {

void* pba_create(int32_t num_blocks) {
  if (num_blocks <= 0) return nullptr;
  return new Allocator(num_blocks);
}

void pba_destroy(void* h) { delete static_cast<Allocator*>(h); }

// lease n blocks (refcount 1) into out[0..n); all-or-nothing.
// 0 = ok, -1 = OOM.
int32_t pba_alloc(void* h, int32_t n, int32_t* out) {
  auto* a = static_cast<Allocator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  if (n < 0 || static_cast<size_t>(n) > a->free_list.size()) return -1;
  for (int32_t i = 0; i < n; ++i) {
    int32_t blk = a->free_list.back();
    a->free_list.pop_back();
    a->refcount[static_cast<size_t>(blk)] = 1;
    out[i] = blk;
  }
  return 0;
}

// unref blocks; a block whose count reaches zero returns to the free
// list. Validated all-or-nothing: returns 0 on success, or -(i+1)
// where i is the first offending index — out of range, not allocated,
// or unref'd more times within this call than its refcount allows —
// with NO state modified.
int32_t pba_free(void* h, const int32_t* blocks, int32_t n) {
  auto* a = static_cast<Allocator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  std::unordered_map<int32_t, int32_t> planned;
  for (int32_t i = 0; i < n; ++i) {
    int32_t blk = blocks[i];
    if (blk < 0 || static_cast<size_t>(blk) >= a->refcount.size())
      return -(i + 1);
    int32_t drops = ++planned[blk];
    if (drops > a->refcount[static_cast<size_t>(blk)]) return -(i + 1);
  }
  for (int32_t i = 0; i < n; ++i) {
    int32_t blk = blocks[i];
    if (--a->refcount[static_cast<size_t>(blk)] == 0)
      a->free_list.push_back(blk);
  }
  return 0;
}

// add one reference to each block (prefix-cache lease of an already
// allocated page). Validated all-or-nothing: returns 0 on success, or
// -(i+1) for the first id that is out of range or not allocated.
int32_t pba_ref(void* h, const int32_t* blocks, int32_t n) {
  auto* a = static_cast<Allocator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  for (int32_t i = 0; i < n; ++i) {
    int32_t blk = blocks[i];
    if (blk < 0 || static_cast<size_t>(blk) >= a->refcount.size() ||
        a->refcount[static_cast<size_t>(blk)] <= 0)
      return -(i + 1);
  }
  for (int32_t i = 0; i < n; ++i)
    ++a->refcount[static_cast<size_t>(blocks[i])];
  return 0;
}

// current refcount of one block (0 = free), or -1 if out of range.
int32_t pba_refcount(void* h, int32_t blk) {
  auto* a = static_cast<Allocator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  if (blk < 0 || static_cast<size_t>(blk) >= a->refcount.size()) return -1;
  return a->refcount[static_cast<size_t>(blk)];
}

int32_t pba_num_free(void* h) {
  auto* a = static_cast<Allocator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  return static_cast<int32_t>(a->free_list.size());
}

}  // extern "C"
