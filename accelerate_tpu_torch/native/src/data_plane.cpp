// Native host data plane of accelerate_tpu_torch: the disk offload store.
//
// A copy of the JAX package's `native/src/data_plane.cpp`, kept to the part
// the port uses: a persistent thread pool and positional file reads (pread)
// parallelized across it, blocking or as async readahead tickets. It is the
// read path of `native/offload.py`'s `NativeOffloadStore`, the disk tier of
// big-model inference. Plain C++17 + POSIX behind a small C ABI, bound with
// ctypes; built with `g++ -O3 -shared -fPIC -pthread`.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <functional>
#include <mutex>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

// ------------------------------------------------------------------ thread pool
class Pool {
 public:
  explicit Pool(int n_threads) : stop_(false), next_ticket_(1) {
    if (n_threads < 1) n_threads = 1;
    for (int i = 0; i < n_threads; ++i) {
      workers_.emplace_back([this] { Run(); });
    }
  }

  ~Pool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  int size() const { return static_cast<int>(workers_.size()); }

  // Enqueue `n` subtasks under one ticket; ticket completes when all subtasks do.
  // A subtask returning nonzero marks the whole ticket failed (first error wins).
  // Zero subtasks complete the ticket immediately.
  int64_t Submit(std::vector<std::function<int()>> subtasks) {
    int64_t ticket = next_ticket_.fetch_add(1);
    if (subtasks.empty()) {
      std::unique_lock<std::mutex> lk(mu_);
      pending_[ticket] = TicketState{true, 0};
      done_cv_.notify_all();
      return ticket;
    }
    auto remaining = std::make_shared<std::atomic<int64_t>>(
        static_cast<int64_t>(subtasks.size()));
    {
      std::unique_lock<std::mutex> lk(mu_);
      pending_[ticket] = TicketState{false, 0};
      for (auto& fn : subtasks) {
        queue_.emplace_back([this, ticket, remaining, fn = std::move(fn)] {
          int rc = fn();
          std::unique_lock<std::mutex> lk(mu_);
          TicketState& st = pending_[ticket];
          if (rc != 0 && st.status == 0) st.status = rc;
          if (remaining->fetch_sub(1) == 1) {
            st.done = true;
            done_cv_.notify_all();
          }
        });
      }
    }
    cv_.notify_all();
    return ticket;
  }

  // Blocks until the ticket completes; returns its status (0 = ok).
  int Wait(int64_t ticket) {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this, ticket] {
      auto it = pending_.find(ticket);
      return it == pending_.end() || it->second.done;
    });
    int status = 0;
    auto it = pending_.find(ticket);
    if (it != pending_.end()) {
      status = it->second.status;
      pending_.erase(it);
    }
    return status;
  }

 private:
  struct TicketState {
    bool done = false;
    int status = 0;
  };

  void Run() {
    for (;;) {
      std::function<void()> task;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        task = std::move(queue_.front());
        queue_.pop_front();
      }
      task();
    }
  }

  std::vector<std::thread> workers_;
  std::deque<std::function<void()>> queue_;
  std::unordered_map<int64_t, TicketState> pending_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  bool stop_;
  std::atomic<int64_t> next_ticket_;
};

// Split `n` bytes across up to `shards` roughly even contiguous chunks.
std::vector<std::pair<int64_t, int64_t>> Chunks(int64_t n, int shards) {
  std::vector<std::pair<int64_t, int64_t>> out;
  if (n <= 0) return out;
  int64_t per = (n + shards - 1) / shards;
  for (int64_t start = 0; start < n; start += per) {
    out.emplace_back(start, std::min(per, n - start));
  }
  return out;
}

struct Store {
  int fd;
};

}  // namespace

extern "C" {

// ------------------------------------------------------------------ pool
void* atl_pool_create(int num_threads) { return new Pool(num_threads); }

void atl_pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

int atl_pool_size(void* pool) { return static_cast<Pool*>(pool)->size(); }

void atl_wait(void* pool, int64_t ticket) {
  static_cast<Pool*>(pool)->Wait(ticket);
}

// Blocking wait that surfaces the ticket's status (0 = ok, -1 = failed subtask).
int atl_wait_status(void* pool, int64_t ticket) {
  return static_cast<Pool*>(pool)->Wait(ticket);
}

// ------------------------------------------------------------------ offload store
void* atl_store_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  return new Store{fd};
}

void atl_store_close(void* store) {
  Store* s = static_cast<Store*>(store);
  if (s) {
    ::close(s->fd);
    delete s;
  }
}

int64_t atl_store_prefetch(void* pool, void* store, int64_t offset,
                           int64_t nbytes, void* dst);

// Parallel positional read of [offset, offset+nbytes) into dst. Returns 0 on
// success, -1 on a short/failed read.
int atl_store_read(void* pool, void* store, int64_t offset, int64_t nbytes,
                   void* dst) {
  Pool* p = static_cast<Pool*>(pool);
  return p->Wait(atl_store_prefetch(pool, store, offset, nbytes, dst));
}

// Async readahead ticket for the same read; failure is recorded on the ticket
// and surfaced by atl_wait_status.
int64_t atl_store_prefetch(void* pool, void* store, int64_t offset,
                           int64_t nbytes, void* dst) {
  Pool* p = static_cast<Pool*>(pool);
  Store* s = static_cast<Store*>(store);
  std::vector<std::function<int()>> tasks;
  // Stripe only past a floor (8 MiB per subtask): layer streaming prefetches
  // many modest tensors at once, and splitting each of those 8 ways just
  // multiplies queue/lock traffic — their parallelism comes from the tensors
  // already being concurrent tickets. A single huge read still stripes.
  constexpr int64_t kMinStripe = int64_t(8) << 20;
  int shards = static_cast<int>(
      std::min<int64_t>(p->size(), (nbytes + kMinStripe - 1) / kMinStripe));
  for (auto [start, count] : Chunks(nbytes, shards < 1 ? 1 : shards)) {
    tasks.push_back([=] {
      int64_t done = 0;
      while (done < count) {
        ssize_t got = ::pread(s->fd, static_cast<char*>(dst) + start + done,
                              static_cast<size_t>(count - done),
                              offset + start + done);
        if (got <= 0) return -1;
        done += got;
      }
      return 0;
    });
  }
  return p->Submit(std::move(tasks));
}

// Group readahead: read n regions under ONE ticket (one queue handoff for a
// whole layer/parameter-group instead of one per tensor — the handoff, not the
// pread, is what costs on a busy host). Regions are distributed round-robin
// across up to pool-size subtasks; statuses[i] (caller-owned, length n) is
// written 0/-1 per region and outlives the ticket, so a failure is still
// attributable after the shared ticket has been waited on once.
int64_t atl_store_read_many(void* pool, void* store, int64_t n,
                            const int64_t* offsets, const int64_t* nbytes,
                            void** dsts, int32_t* statuses) {
  Pool* p = static_cast<Pool*>(pool);
  Store* s = static_cast<Store*>(store);
  int shards = std::max(1, std::min<int>(p->size(), static_cast<int>(n)));
  // Copy the region tables: the caller's arrays need not outlive this call
  // (the Python binding builds them as temporaries); `statuses` and the
  // destination buffers are caller-owned and must stay alive until the wait.
  auto offs = std::make_shared<std::vector<int64_t>>(offsets, offsets + n);
  auto sizes = std::make_shared<std::vector<int64_t>>(nbytes, nbytes + n);
  auto outs = std::make_shared<std::vector<void*>>(dsts, dsts + n);
  std::vector<std::function<int()>> tasks;
  for (int w = 0; w < shards; ++w) {
    tasks.push_back([=] {
      int bad = 0;
      for (int64_t i = w; i < n; i += shards) {
        int64_t done = 0;
        int32_t st = 0;
        while (done < (*sizes)[i]) {
          ssize_t got = ::pread(s->fd, static_cast<char*>((*outs)[i]) + done,
                                static_cast<size_t>((*sizes)[i] - done),
                                (*offs)[i] + done);
          if (got <= 0) {
            st = -1;
            break;
          }
          done += got;
        }
        statuses[i] = st;
        if (st != 0) bad = 1;
      }
      return bad ? -1 : 0;
    });
  }
  return p->Submit(std::move(tasks));
}

}  // extern "C"
