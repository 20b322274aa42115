// Threaded prefetching batch loader: the native reader under
// tdc_tpu_torch/data/native_loader.py (ctypes), the port's copy of the JAX
// package's native/prefetch_loader.cpp (the same C ABI).
//
// A reader thread fills a bounded ring of preallocated batch buffers with
// pread(2) while the fit computes on the previous batch; the Python side
// copies each batch out and the slot is recycled. One full sequential pass
// per Lloyd iteration; reset() rewinds for the next pass. Built with
// g++ -O3 -std=c++17 -fPIC -shared -pthread at first use
// (tdc_tpu_torch/ops/_build.py, load_host_library).
//
// C ABI (all functions return <0 on error):
//   ldr_open(path, data_offset, row_bytes, n_rows, rows_per_batch, depth) -> id
//   ldr_next(id, dst, dst_cap_bytes) -> rows copied (0 = end of pass)
//   ldr_reset(id)                    -> rewind to row 0 (restart prefetch)
//   ldr_close(id)
//   ldr_last_error()                 -> errno of last failure

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Batch {
  std::vector<uint8_t> data;
  int64_t rows = 0;
  int64_t seq = -1;  // pass-local batch index; -1 = empty slot
};

struct Loader {
  int fd = -1;
  int64_t data_offset = 0;
  int64_t row_bytes = 0;
  int64_t n_rows = 0;
  int64_t rows_per_batch = 0;
  int64_t n_batches = 0;

  std::vector<Batch> ring;
  std::mutex mu;
  std::condition_variable cv_reader;    // signals: space available / reset
  std::condition_variable cv_consumer;  // signals: batch ready
  int64_t next_fill = 0;     // next batch index the reader will read
  int64_t next_consume = 0;  // next batch index the consumer wants
  uint64_t epoch = 0;        // bumped on reset to invalidate in-flight fills
  bool stop = false;
  std::thread reader;

  ~Loader() {
    {
      std::lock_guard<std::mutex> g(mu);
      stop = true;
    }
    cv_reader.notify_all();
    cv_consumer.notify_all();
    if (reader.joinable()) reader.join();
    if (fd >= 0) close(fd);
  }
};

std::mutex g_mu;
std::vector<Loader*> g_loaders;
std::atomic<int> g_last_errno{0};

Batch* slot_for(Loader* L, int64_t seq) {
  return &L->ring[static_cast<size_t>(seq % L->ring.size())];
}

void reader_main(Loader* L) {
  std::unique_lock<std::mutex> lk(L->mu);
  while (!L->stop) {
    if (L->next_fill >= L->n_batches) {
      // Pass complete; wait for reset or shutdown.
      L->cv_reader.wait(lk);
      continue;
    }
    Batch* b = slot_for(L, L->next_fill);
    if (b->seq >= L->next_consume && b->seq >= 0) {
      // Slot still holds an unconsumed batch; wait for the consumer.
      L->cv_reader.wait(lk);
      continue;
    }
    const int64_t seq = L->next_fill++;
    const uint64_t epoch = L->epoch;
    const int64_t row0 = seq * L->rows_per_batch;
    const int64_t rows =
        std::min(L->rows_per_batch, L->n_rows - row0);
    lk.unlock();

    const int64_t want = rows * L->row_bytes;
    int64_t got = 0;
    while (got < want) {
      ssize_t r = pread(L->fd, b->data.data() + got, want - got,
                        L->data_offset + row0 * L->row_bytes + got);
      if (r <= 0) {
        g_last_errno.store(r < 0 ? errno : EIO);
        got = -1;
        break;
      }
      got += r;
    }

    lk.lock();
    if (L->epoch == epoch) {  // a reset() while reading discards this fill
      b->rows = (got < 0) ? -1 : rows;
      b->seq = seq;
      L->cv_consumer.notify_all();
    }
  }
}

}  // namespace

extern "C" {

int64_t ldr_open(const char* path, int64_t data_offset, int64_t row_bytes,
                 int64_t n_rows, int64_t rows_per_batch, int64_t depth) {
  if (row_bytes <= 0 || n_rows < 0 || rows_per_batch <= 0 || depth <= 0)
    return -1;
  int fd = open(path, O_RDONLY);
  if (fd < 0) {
    g_last_errno.store(errno);
    return -1;
  }
  auto* L = new Loader();
  L->fd = fd;
  L->data_offset = data_offset;
  L->row_bytes = row_bytes;
  L->n_rows = n_rows;
  L->rows_per_batch = rows_per_batch;
  L->n_batches = (n_rows + rows_per_batch - 1) / rows_per_batch;
  L->ring.resize(static_cast<size_t>(depth));
  for (auto& b : L->ring)
    b.data.resize(static_cast<size_t>(rows_per_batch * row_bytes));
  L->reader = std::thread(reader_main, L);

  std::lock_guard<std::mutex> g(g_mu);
  g_loaders.push_back(L);
  return static_cast<int64_t>(g_loaders.size()) - 1;
}

static Loader* get(int64_t id) {
  std::lock_guard<std::mutex> g(g_mu);
  if (id < 0 || id >= static_cast<int64_t>(g_loaders.size())) return nullptr;
  return g_loaders[static_cast<size_t>(id)];
}

int64_t ldr_next(int64_t id, uint8_t* dst, int64_t dst_cap) {
  Loader* L = get(id);
  if (!L) return -1;
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_consume >= L->n_batches) return 0;  // end of pass
  const int64_t seq = L->next_consume;
  Batch* b = slot_for(L, seq);
  L->cv_consumer.wait(lk, [&] { return L->stop || b->seq == seq; });
  if (L->stop) return -1;
  if (b->rows < 0) return -1;  // read error surfaced from the reader thread
  const int64_t bytes = b->rows * L->row_bytes;
  if (bytes > dst_cap) return -1;
  std::memcpy(dst, b->data.data(), static_cast<size_t>(bytes));
  const int64_t rows = b->rows;
  b->seq = -1;  // recycle slot
  L->next_consume++;
  L->cv_reader.notify_all();
  return rows;
}

int64_t ldr_reset(int64_t id) {
  Loader* L = get(id);
  if (!L) return -1;
  {
    std::lock_guard<std::mutex> g(L->mu);
    L->epoch++;
    L->next_fill = 0;
    L->next_consume = 0;
    for (auto& b : L->ring) b.seq = -1;
  }
  L->cv_reader.notify_all();
  return 0;
}

int64_t ldr_close(int64_t id) {
  std::lock_guard<std::mutex> g(g_mu);
  if (id < 0 || id >= static_cast<int64_t>(g_loaders.size())) return -1;
  delete g_loaders[static_cast<size_t>(id)];
  g_loaders[static_cast<size_t>(id)] = nullptr;
  return 0;
}

int64_t ldr_last_error() { return g_last_errno.load(); }

}  // extern "C"
