// Prefetching token-batch data feed over an mmap'd corpus (a copy of the
// reference package's native data feed, the analog of Paddle's
// `paddle/fluid/framework/data_feed.cc` feed threads).
//
// The host's only data-path job is to keep one numpy batch ahead of the
// train step, so this is a single mmap and a producer thread filling a
// bounded ring of ready batches: no worker processes, no IPC.
//
// The corpus is a flat binary file of fixed-size samples
// (sample_elems * elem_size bytes each, e.g. packed token ids). Each
// epoch visits every full sample once, optionally mt19937-shuffled with
// a per-epoch seed (seed + epoch), dropping the last partial batch.

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <numeric>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Feed {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t file_bytes = 0;

  uint64_t sample_bytes = 0;
  uint64_t n_samples = 0;
  uint64_t batch = 0;
  uint64_t batches_per_epoch = 0;
  uint64_t batch_bytes = 0;
  int shuffle = 0;
  uint64_t seed = 0;
  int64_t epochs = 0;  // <= 0: infinite

  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::deque<std::vector<uint8_t>> ready;
  size_t capacity = 4;
  bool done = false;  // producer exhausted all epochs
  std::atomic<bool> stopping{false};
  std::thread producer;

  ~Feed() { close(); }

  void close() {
    bool expected = false;
    if (!stopping.compare_exchange_strong(expected, true)) return;
    {
      std::lock_guard<std::mutex> lk(mu);
      cv_put.notify_all();
      cv_get.notify_all();
    }
    if (producer.joinable()) producer.join();
    if (base) ::munmap(const_cast<uint8_t*>(base), file_bytes);
    if (fd >= 0) ::close(fd);
  }

  void produce() {
    std::vector<uint64_t> order(n_samples);
    for (int64_t epoch = 0; epochs <= 0 || epoch < epochs; ++epoch) {
      // fresh iota each epoch so the permutation is a pure function of
      // (seed, epoch) — a resumed job replays the original data order
      std::iota(order.begin(), order.end(), 0);
      if (shuffle) {
        std::mt19937_64 rng(seed + static_cast<uint64_t>(epoch));
        std::shuffle(order.begin(), order.end(), rng);
      }
      for (uint64_t b = 0; b < batches_per_epoch; ++b) {
        std::vector<uint8_t> buf(batch_bytes);
        for (uint64_t i = 0; i < batch; ++i) {
          uint64_t s = order[b * batch + i];
          std::memcpy(buf.data() + i * sample_bytes,
                      base + s * sample_bytes, sample_bytes);
        }
        std::unique_lock<std::mutex> lk(mu);
        cv_put.wait(lk, [this] {
          return stopping.load() || ready.size() < capacity;
        });
        if (stopping.load()) return;
        ready.push_back(std::move(buf));
        cv_get.notify_one();
      }
    }
    std::lock_guard<std::mutex> lk(mu);
    done = true;
    cv_get.notify_all();
  }

  bool start(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st{};
    if (::fstat(fd, &st) != 0 || st.st_size <= 0) return false;
    file_bytes = static_cast<size_t>(st.st_size);
    void* m = ::mmap(nullptr, file_bytes, PROT_READ, MAP_PRIVATE, fd, 0);
    if (m == MAP_FAILED) return false;
    ::madvise(m, file_bytes, MADV_WILLNEED);
    base = static_cast<const uint8_t*>(m);
    n_samples = file_bytes / sample_bytes;
    batches_per_epoch = n_samples / batch;
    batch_bytes = batch * sample_bytes;
    if (batches_per_epoch == 0) return false;
    producer = std::thread([this] { produce(); });
    return true;
  }
};

}  // namespace

extern "C" {

void* pts_feed_open(const char* path, uint64_t sample_elems,
                    uint32_t elem_size, uint64_t batch, int shuffle,
                    uint64_t seed, int prefetch_depth, int64_t epochs) {
  auto* f = new Feed();
  f->sample_bytes = sample_elems * elem_size;
  f->batch = batch;
  f->shuffle = shuffle;
  f->seed = seed;
  f->capacity = prefetch_depth > 0 ? static_cast<size_t>(prefetch_depth) : 4;
  f->epochs = epochs;
  if (f->sample_bytes == 0 || batch == 0 || !f->start(path)) {
    delete f;
    return nullptr;
  }
  return f;
}

uint64_t pts_feed_batches_per_epoch(void* h) {
  return static_cast<Feed*>(h)->batches_per_epoch;
}

uint64_t pts_feed_num_samples(void* h) {
  return static_cast<Feed*>(h)->n_samples;
}

// Blocks until the next batch is ready and copies it into dst
// (batch * sample_elems * elem_size bytes). Returns 0 on success, -1
// when the feed is exhausted or closed.
int pts_feed_next(void* h, uint8_t* dst) {
  auto* f = static_cast<Feed*>(h);
  std::unique_lock<std::mutex> lk(f->mu);
  f->cv_get.wait(lk, [f] {
    return f->stopping.load() || f->done || !f->ready.empty();
  });
  if (f->ready.empty()) return -1;
  std::vector<uint8_t> buf = std::move(f->ready.front());
  f->ready.pop_front();
  f->cv_put.notify_one();
  lk.unlock();
  std::memcpy(dst, buf.data(), buf.size());
  return 0;
}

void pts_feed_close(void* h) { delete static_cast<Feed*>(h); }

}  // extern "C"
