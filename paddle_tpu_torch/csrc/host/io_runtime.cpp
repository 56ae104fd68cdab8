// Native IO runtime: bounded blocking batch queue + multithreaded file feeder.
//
// Reference capability (all C++ there too):
//   - operators/reader/lod_tensor_blocking_queue.h — bounded blocking queue
//     between producer threads and the device consumer
//   - framework/data_feed.h:120 DataFeed / :305 InMemoryDataFeed —
//     multithreaded file ingestion feeding workers without Python in the loop
//   - operators/reader/buffered_reader.cc — double-buffer prefetch
//
// TPU-native shape: the consumer is the host→HBM transfer feeding jit'd
// steps; Python calls pop() via ctypes and hands zero-copy numpy views to
// jax.device_put.  No CUDA streams to manage — PJRT owns the transfer.
//
// C ABI (ctypes-friendly), thread-safe, no external deps.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Buffer {
  std::unique_ptr<uint8_t[]> data;
  uint64_t size = 0;
};

// Bounded MPMC blocking queue of byte buffers.
class BlockingQueue {
 public:
  explicit BlockingQueue(uint64_t capacity) : cap_(capacity) {}

  bool Push(Buffer buf) {
    std::unique_lock<std::mutex> lk(mu_);
    not_full_.wait(lk, [&] { return q_.size() < cap_ || closed_; });
    if (closed_) return false;
    q_.push_back(std::move(buf));
    not_empty_.notify_one();
    return true;
  }

  // Returns size popped, 0 on closed-and-empty, waits otherwise.
  uint64_t Pop(uint8_t* out, uint64_t out_cap) {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [&] { return !q_.empty() || closed_; });
    if (q_.empty()) return 0;  // closed
    Buffer b = std::move(q_.front());
    q_.pop_front();
    not_full_.notify_one();
    uint64_t n = b.size < out_cap ? b.size : out_cap;
    std::memcpy(out, b.data.get(), n);
    return n;
  }

  // Peek size of the next buffer (blocking); 0 if closed and drained.
  uint64_t NextSize() {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [&] { return !q_.empty() || closed_; });
    if (q_.empty()) return 0;
    return q_.front().size;
  }

  void Close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    not_empty_.notify_all();
    not_full_.notify_all();
  }

  bool closed() {
    std::lock_guard<std::mutex> lk(mu_);
    return closed_;
  }

  uint64_t Size() {
    std::lock_guard<std::mutex> lk(mu_);
    return q_.size();
  }

 private:
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_;
  std::deque<Buffer> q_;
  uint64_t cap_;
  bool closed_ = false;
};

// Multithreaded fixed-record binary file feeder (token shards, TFRecord-less).
// Each worker owns a slice of the file list; records are `record_bytes` long;
// `batch` records are packed per queue entry.  Optional within-worker shuffle
// with a bounded reservoir.
class FileFeeder {
 public:
  FileFeeder(std::vector<std::string> files, uint64_t record_bytes,
             uint64_t batch, int nthreads, BlockingQueue* q, uint64_t seed,
             uint64_t shuffle_window)
      : files_(std::move(files)),
        record_bytes_(record_bytes),
        batch_(batch),
        q_(q),
        shuffle_window_(shuffle_window),
        nthreads_(nthreads) {
    for (int t = 0; t < nthreads; ++t) {
      threads_.emplace_back([this, t, nthreads, seed] {
        Work(t, nthreads, seed + t);
      });
    }
  }

  ~FileFeeder() { Join(); }

  void Join() {
    for (auto& th : threads_)
      if (th.joinable()) th.join();
    threads_.clear();
  }

  uint64_t records_read() const { return records_.load(); }

 private:
  void Work(int tid, int nthreads, uint64_t seed) {
    std::mt19937_64 rng(seed);
    std::vector<std::vector<uint8_t>> reservoir;
    std::vector<uint8_t> packed;
    packed.reserve(batch_ * record_bytes_);
    auto emit_if_full = [&] {
      if (packed.size() >= batch_ * record_bytes_) {
        Buffer b;
        b.size = packed.size();
        b.data = std::make_unique<uint8_t[]>(b.size);
        std::memcpy(b.data.get(), packed.data(), b.size);
        packed.clear();
        q_->Push(std::move(b));
      }
    };
    auto flush_record = [&](std::vector<uint8_t> rec) {
      if (shuffle_window_ > 1) {
        if (reservoir.size() < shuffle_window_) {
          reservoir.push_back(std::move(rec));
          return;
        }
        uint64_t j = rng() % reservoir.size();
        std::swap(reservoir[j], rec);
      }
      packed.insert(packed.end(), rec.begin(), rec.end());
      emit_if_full();
    };
    for (size_t i = tid; i < files_.size(); i += nthreads) {
      if (q_->closed()) return;
      FILE* f = std::fopen(files_[i].c_str(), "rb");
      if (!f) continue;
      std::vector<uint8_t> rec(record_bytes_);
      while (std::fread(rec.data(), 1, record_bytes_, f) == record_bytes_) {
        records_.fetch_add(1);
        flush_record(rec);
        if (q_->closed()) break;
      }
      std::fclose(f);
    }
    // drain reservoir, then emit the trailing PARTIAL batch too — dropping
    // the tail would silently lose up to nthreads*(batch-1) records per
    // epoch (the reference data feed delivers tail batches; consumers that
    // want drop_last semantics filter short batches themselves)
    for (auto& rec : reservoir) {
      packed.insert(packed.end(), rec.begin(), rec.end());
      emit_if_full();
      if (q_->closed()) break;
    }
    if (!packed.empty() && !q_->closed()) {
      Buffer b;
      b.size = packed.size();
      b.data = std::make_unique<uint8_t[]>(b.size);
      std::memcpy(b.data.get(), packed.data(), b.size);
      q_->Push(std::move(b));
    }
    if (done_.fetch_add(1) + 1 == nthreads_) q_->Close();
  }

  std::vector<std::string> files_;
  uint64_t record_bytes_, batch_;
  BlockingQueue* q_;
  uint64_t shuffle_window_;
  int nthreads_;
  std::vector<std::thread> threads_;
  std::atomic<uint64_t> records_{0};
  std::atomic<int> done_{0};
};

}  // namespace

extern "C" {

void* ptq_create(uint64_t capacity) { return new BlockingQueue(capacity); }

int ptq_push(void* h, const uint8_t* data, uint64_t size) {
  Buffer b;
  b.size = size;
  b.data = std::make_unique<uint8_t[]>(size);
  std::memcpy(b.data.get(), data, size);
  return static_cast<BlockingQueue*>(h)->Push(std::move(b)) ? 1 : 0;
}

uint64_t ptq_next_size(void* h) {
  return static_cast<BlockingQueue*>(h)->NextSize();
}

uint64_t ptq_pop(void* h, uint8_t* out, uint64_t cap) {
  return static_cast<BlockingQueue*>(h)->Pop(out, cap);
}

uint64_t ptq_size(void* h) { return static_cast<BlockingQueue*>(h)->Size(); }

void ptq_close(void* h) { static_cast<BlockingQueue*>(h)->Close(); }

void ptq_destroy(void* h) { delete static_cast<BlockingQueue*>(h); }

// files: '\n'-joined paths
void* ptf_start(void* queue, const char* files, uint64_t record_bytes,
                uint64_t batch, int nthreads, uint64_t seed,
                uint64_t shuffle_window) {
  std::vector<std::string> fs;
  std::string cur;
  for (const char* p = files; *p; ++p) {
    if (*p == '\n') {
      if (!cur.empty()) fs.push_back(cur);
      cur.clear();
    } else {
      cur.push_back(*p);
    }
  }
  if (!cur.empty()) fs.push_back(cur);
  return new FileFeeder(std::move(fs), record_bytes, batch, nthreads,
                        static_cast<BlockingQueue*>(queue), seed,
                        shuffle_window);
}

uint64_t ptf_records_read(void* h) {
  return static_cast<FileFeeder*>(h)->records_read();
}

void ptf_join(void* h) { static_cast<FileFeeder*>(h)->Join(); }

void ptf_destroy(void* h) { delete static_cast<FileFeeder*>(h); }

}  // extern "C"
