// Native data-loader core: blocking bounded queue + parallel collation.
// (The same source and C ABI as paddle_tpu/io/native/queue.cc.)
//
// Reference: the reader runtime the paddle DataLoader workers feed
// (paddle/fluid/operators/reader/blocking_queue.h: a mutex/condvar
// bounded queue with close semantics, and buffered_reader.cc's
// double-buffered prefetch).
//
// Python worker threads produce batches into this C++ queue (releasing
// the GIL while blocked, so producers and the consumer genuinely
// overlap), and `ptq_collate` assembles sample buffers into the
// contiguous batch with a parallel memcpy: the memory-bandwidth half of
// batch assembly runs outside Python. Exposed through a plain C ABI for
// ctypes.
//
// Build (paddle_tpu_torch/utils/build.py does this at first use):
//   g++ -O3 -shared -fPIC -pthread -std=c++17 -o libptio.so queue.cc
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Queue {
  std::mutex mu;
  std::condition_variable not_empty;
  std::condition_variable not_full;
  std::deque<void*> items;
  size_t capacity;
  bool closed = false;
};

}  // namespace

extern "C" {

// ---- blocking queue (ref blocking_queue.h Send/Receive/Close) ----
void* ptq_create(uint64_t capacity) {
  auto* q = new Queue();
  q->capacity = capacity ? capacity : 1;
  return q;
}

void ptq_destroy(void* h) { delete static_cast<Queue*>(h); }

// 1 = pushed, 0 = timeout, -1 = closed
int ptq_push(void* h, void* item, int64_t timeout_ms) {
  auto* q = static_cast<Queue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  auto pred = [q] { return q->closed || q->items.size() < q->capacity; };
  if (timeout_ms < 0) {
    q->not_full.wait(lk, pred);
  } else if (!q->not_full.wait_for(
                 lk, std::chrono::milliseconds(timeout_ms), pred)) {
    return 0;
  }
  if (q->closed) return -1;
  q->items.push_back(item);
  q->not_empty.notify_one();
  return 1;
}

// 1 = popped into *out, 0 = timeout, -1 = closed AND drained
int ptq_pop(void* h, void** out, int64_t timeout_ms) {
  auto* q = static_cast<Queue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  auto pred = [q] { return q->closed || !q->items.empty(); };
  if (timeout_ms < 0) {
    q->not_empty.wait(lk, pred);
  } else if (!q->not_empty.wait_for(
                 lk, std::chrono::milliseconds(timeout_ms), pred)) {
    return 0;
  }
  if (q->items.empty()) return -1;  // closed and drained
  *out = q->items.front();
  q->items.pop_front();
  q->not_full.notify_one();
  return 1;
}

uint64_t ptq_size(void* h) {
  auto* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->items.size();
}

void ptq_close(void* h) {
  auto* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  q->closed = true;
  q->not_empty.notify_all();
  q->not_full.notify_all();
}

// ---- parallel collation: dst[i] = srcs[i], threaded memcpy ----
void ptq_collate(char* dst, const char** srcs, const uint64_t* sizes,
                 uint64_t n, int threads) {
  if (threads < 2 || n < 2) {
    uint64_t off = 0;
    for (uint64_t i = 0; i < n; ++i) {
      std::memcpy(dst + off, srcs[i], sizes[i]);
      off += sizes[i];
    }
    return;
  }
  std::vector<uint64_t> offs(n);
  uint64_t off = 0;
  for (uint64_t i = 0; i < n; ++i) {
    offs[i] = off;
    off += sizes[i];
  }
  std::vector<std::thread> pool;
  uint64_t per = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    uint64_t lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    pool.emplace_back([=] {
      for (uint64_t i = lo; i < hi; ++i)
        std::memcpy(dst + offs[i], srcs[i], sizes[i]);
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
