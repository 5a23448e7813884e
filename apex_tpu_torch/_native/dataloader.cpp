// Threaded prefetching record loader — the native data pipeline the
// reference gets from DALI in examples/imagenet/main_amp.py (its
// --data-backend dali path) and from torch DataLoader worker processes.
//
// Dataset model: a set of files, each a contiguous array of fixed-size
// records (record_bytes).  An epoch is a (optionally shuffled) permutation
// of all record indices; worker threads fill a ring of batch buffers with
// pread()s while the consumer drains batches in order.  Infinite stream:
// each epoch reshuffles with seed+epoch (deterministic given seed, so a
// resumed run replays the same order, matching the CLI's set_epoch
// discipline).
//
// Plain C ABI for ctypes (no pybind11 in this image).

#include <fcntl.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <numeric>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Loader {
  // lifetime count of records that failed to read (truncated / rotated
  // files); those records are zero-filled, and the consumer must be able
  // to see that it happened — silent corruption is worse than a crash
  std::atomic<int64_t> read_errors{0};
  std::vector<int> fds;
  std::vector<int64_t> file_base;  // cumulative record start per file
  int64_t total_records = 0;
  int64_t record_bytes = 0;
  int64_t batch = 0;
  bool shuffle = false;
  uint64_t seed = 0;

  // current epoch's permutation of record indices
  std::vector<int64_t> order;
  int64_t epoch = 0;

  // ring of batch buffers; a slot holds batch seq `ring_seq[s]`, valid to
  // read only once `ring_done[s]`
  std::vector<std::vector<char>> ring;
  std::vector<int64_t> ring_seq;
  std::vector<char> ring_done;
  int64_t next_fill = 0;  // next batch seq a worker will claim
  int64_t next_out = 0;   // next batch seq the consumer wants
  bool stop = false;

  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::vector<std::thread> workers;

  int64_t batches_per_epoch() const { return total_records / batch; }

  void reshuffle_locked() {
    order.resize(static_cast<size_t>(total_records));
    std::iota(order.begin(), order.end(), 0);
    if (shuffle) {
      std::mt19937_64 rng(seed + static_cast<uint64_t>(epoch));
      for (int64_t i = total_records - 1; i > 0; --i) {
        int64_t j = static_cast<int64_t>(rng() % (i + 1));
        std::swap(order[i], order[j]);
      }
    }
  }

  bool read_record(int64_t rec, char* dst) {
    size_t f = 0;
    while (f + 1 < file_base.size() && file_base[f + 1] <= rec) ++f;
    int64_t off = (rec - file_base[f]) * record_bytes;
    int64_t done = 0;
    while (done < record_bytes) {
      ssize_t r = pread(fds[f], dst + done,
                        static_cast<size_t>(record_bytes - done), off + done);
      if (r <= 0) return false;
      done += r;
    }
    return true;
  }

  int64_t free_slot_locked() const {
    for (size_t s = 0; s < ring_seq.size(); ++s)
      if (ring_seq[s] == -1) return static_cast<int64_t>(s);
    return -1;
  }

  void worker() {
    std::vector<int64_t> recs(static_cast<size_t>(batch));
    for (;;) {
      int64_t seq, slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop || free_slot_locked() >= 0; });
        if (stop) return;
        slot = free_slot_locked();
        seq = next_fill++;
        ring_seq[static_cast<size_t>(slot)] = seq;
        ring_done[static_cast<size_t>(slot)] = 0;
        // resolve this batch's record ids under the lock (epoch advance
        // mutates `order`)
        int64_t e = seq / batches_per_epoch();
        int64_t local = seq % batches_per_epoch();
        if (e != epoch) {
          epoch = e;
          reshuffle_locked();
        }
        for (int64_t i = 0; i < batch; ++i)
          recs[static_cast<size_t>(i)] =
              order[static_cast<size_t>(local * batch + i)];
      }
      char* buf = ring[static_cast<size_t>(slot)].data();
      for (int64_t i = 0; i < batch; ++i) {
        if (!read_record(recs[static_cast<size_t>(i)],
                         buf + i * record_bytes)) {
          std::memset(buf + i * record_bytes, 0,
                      static_cast<size_t>(record_bytes));
          read_errors.fetch_add(1, std::memory_order_relaxed);
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        ring_done[static_cast<size_t>(slot)] = 1;
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* axl_open(const char** paths, int64_t n_files, int64_t record_bytes,
               int64_t batch, int shuffle, uint64_t seed, int n_threads,
               int queue_depth) {
  if (n_files <= 0 || record_bytes <= 0 || batch <= 0) return nullptr;
  Loader* L = new Loader();
  L->record_bytes = record_bytes;
  L->batch = batch;
  L->shuffle = shuffle != 0;
  L->seed = seed;
  for (int64_t i = 0; i < n_files; ++i) {
    int fd = open(paths[i], O_RDONLY);
    if (fd < 0) {
      for (int f : L->fds) close(f);
      delete L;
      return nullptr;
    }
    off_t sz = lseek(fd, 0, SEEK_END);
    L->fds.push_back(fd);
    L->file_base.push_back(L->total_records);
    L->total_records += static_cast<int64_t>(sz) / record_bytes;
  }
  if (L->total_records < batch) {
    for (int f : L->fds) close(f);
    delete L;
    return nullptr;
  }
  L->reshuffle_locked();
  int depth = queue_depth > 0 ? queue_depth : 4;
  L->ring.resize(static_cast<size_t>(depth));
  for (auto& b : L->ring)
    b.resize(static_cast<size_t>(batch * record_bytes));
  L->ring_seq.assign(static_cast<size_t>(depth), -1);
  L->ring_done.assign(static_cast<size_t>(depth), 0);
  int t = n_threads > 0 ? n_threads : 2;
  for (int w = 0; w < t; ++w)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

int64_t axl_num_records(void* h) {
  return h ? static_cast<Loader*>(h)->total_records : -1;
}

// Blocks until the next in-order batch is ready; copies it into out.
int axl_next(void* h, char* out) {
  if (!h) return -1;
  Loader* L = static_cast<Loader*>(h);
  int64_t slot = -1;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    int64_t want = L->next_out;
    L->cv_ready.wait(lk, [&] {
      if (L->stop) return true;
      for (size_t s = 0; s < L->ring_seq.size(); ++s) {
        if (L->ring_seq[s] == want && L->ring_done[s]) {
          slot = static_cast<int64_t>(s);
          return true;
        }
      }
      return false;
    });
    if (L->stop) return -1;
  }
  // `slot` is exclusively ours: it stays claimed (seq != -1) until we
  // release it below, and workers never touch a claimed+done slot.
  std::memcpy(out, L->ring[static_cast<size_t>(slot)].data(),
              static_cast<size_t>(L->batch * L->record_bytes));
  {
    std::lock_guard<std::mutex> lg(L->mu);
    L->ring_seq[static_cast<size_t>(slot)] = -1;
    L->ring_done[static_cast<size_t>(slot)] = 0;
    L->next_out++;
  }
  L->cv_free.notify_all();
  return 0;
}

// Count of records zero-filled because pread failed (IO error surface —
// poll after axl_next; nonzero means the epoch's data is suspect).
int64_t axl_error_count(void* h) {
  if (!h) return -1;
  return static_cast<Loader*>(h)->read_errors.load(
      std::memory_order_relaxed);
}

void axl_close(void* h) {
  if (!h) return;
  Loader* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_free.notify_all();
  L->cv_ready.notify_all();
  for (auto& w : L->workers) w.join();
  for (int f : L->fds) close(f);
  delete L;
}

}  // extern "C"
