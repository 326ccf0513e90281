// Native token-window data loader of the PyTorch package: the host-side
// batch path of tpu_docker_api_torch/data/loader.py (a C++ source built
// with the host compiler by _build.py, not a CUDA kernel).
//
// Semantics are BIT-IDENTICAL to the numpy path of data/loader.py — same
// affine-permutation visitation order ((a*pos + seed + epoch) mod n with
// the same coprime-stride derivation), same multi-file window stitching,
// same process-sharded row ranges — proven by the equality tests in
// tests/test_torch_data.py. What the native path adds:
//
// - zero-Python batch assembly: mmap'd files, tight uint16→int32 widen
//   loop, no numpy indirection per window;
// - transparent lookahead: after serving step s for a row range, a
//   background worker precomputes (s+1) for the same range into a
//   double buffer — the trainer's sequential get_batch(i) pattern hits
//   it, overlapping host data work with device compute. Non-sequential
//   access stays correct (a miss just computes synchronously).
//
// C ABI (ctypes-bound by tpu_docker_api_torch/data/loader.py):
//   tpudata_abi_version() -> 1
//   tpudata_open(paths, n_paths, window, dtype_code) -> handle (>0) or -1
//       dtype_code: 2 = uint16 little-endian, 4 = int32 little-endian
//   tpudata_n_tokens(h), tpudata_n_windows(h)
//   tpudata_batch(h, step, global_batch, row_start, row_end, seed, out)
//       fills out[(row_end-row_start) * window] as int32; returns 0
//   tpudata_hits(h) -> batch calls served from the lookahead buffer
//   tpudata_close(h)
//       safe against concurrent tpudata_batch on the same handle: close
//       unregisters the handle, then blocks until in-flight batch calls
//       drain before freeing (in_use pin below)

#include <sys/mman.h>
#include <sys/stat.h>
#include <fcntl.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <numeric>
#include <string>
#include <thread>
#include <vector>

namespace {

struct MappedFile {
  void* ptr = nullptr;
  size_t bytes = 0;
  int64_t n_tokens = 0;
};

struct BatchKey {
  int64_t step, global_batch, row_start, row_end, seed;
  bool operator==(const BatchKey& o) const {
    return step == o.step && global_batch == o.global_batch &&
           row_start == o.row_start && row_end == o.row_end && seed == o.seed;
  }
};

struct Source {
  std::vector<MappedFile> files;
  int64_t window = 0;
  int32_t dtype_code = 2;  // bytes per token
  int64_t n_tokens = 0;
  int64_t n_windows = 0;

  // lookahead double buffer
  std::mutex mu;
  std::condition_variable cv;
  std::thread worker;
  bool worker_started = false;
  bool shutdown = false;
  bool request_pending = false;
  BatchKey request_key{};
  BatchKey ready_key{};
  bool ready = false;
  std::vector<int32_t> ready_buf;
  int64_t hits = 0;  // tpudata_batch calls served from ready_buf

  // calls currently inside tpudata_batch on this handle; tpudata_close
  // waits for it to reach 0 before deleting, so a concurrent close can
  // never free a Source (or join a worker writing the caller's buffer)
  // mid-fill. Incremented under g_mu (so it cannot rise after close
  // unregisters the handle), decremented under this->mu + cv notify
  // (so close's wait is local to THIS source — a slow fill on one
  // handle must not stall the whole registry behind g_mu).
  std::atomic<int64_t> in_use{0};

  ~Source() {
    {
      std::unique_lock<std::mutex> lk(mu);
      shutdown = true;
    }
    cv.notify_all();
    if (worker.joinable()) worker.join();
    for (auto& f : files)
      if (f.ptr) munmap(f.ptr, f.bytes);
  }
};

std::mutex g_mu;
std::map<int64_t, Source*> g_sources;
int64_t g_next_handle = 1;

// Deterministic multiplier coprime to n — EXACTLY loader.py's
// _coprime_stride: a = (0x9E3779B1 * (seed+1)) % n; a |= 1;
// while gcd(a, n) != 1: a = (a + 2) % n or 1.
int64_t coprime_stride(int64_t n, int64_t seed) {
  if (n == 1) return 1;
  unsigned __int128 m = (unsigned __int128)0x9E3779B1ULL *
                        (unsigned __int128)(seed + 1);
  int64_t a = (int64_t)(m % (unsigned __int128)n);
  a |= 1;
  while (std::gcd(a, n) != 1) {
    a = (a + 2) % n;
    if (a == 0) a = 1;
  }
  return a;
}

// Copy window `index` (mod n_windows) into out[0..window), widening to
// int32 — the multi-file stitch walk of TokenSource.read_window.
void read_window(const Source& s, int64_t index, int32_t* out) {
  index %= s.n_windows;
  int64_t start = index * s.window;
  int64_t filled = 0;
  for (const auto& f : s.files) {
    if (start >= f.n_tokens) {
      start -= f.n_tokens;
      continue;
    }
    int64_t take = std::min(f.n_tokens - start, s.window - filled);
    if (s.dtype_code == 2) {
      const uint16_t* p = (const uint16_t*)f.ptr + start;
      for (int64_t i = 0; i < take; ++i) out[filled + i] = (int32_t)p[i];
    } else {
      std::memcpy(out + filled, (const int32_t*)f.ptr + start,
                  (size_t)take * sizeof(int32_t));
    }
    filled += take;
    start = 0;
    if (filled == s.window) return;
  }
}

void fill_batch(const Source& s, const BatchKey& k, int32_t* out) {
  int64_t n = s.n_windows;
  int64_t a = coprime_stride(n, k.seed);
  int64_t rows = k.row_end - k.row_start;
  for (int64_t i = 0; i < rows; ++i) {
    int64_t p = k.step * k.global_batch + k.row_start + i;
    int64_t epoch = p / n;
    int64_t pos = p % n;
    unsigned __int128 w =
        ((unsigned __int128)a * (unsigned __int128)pos +
         (unsigned __int128)(k.seed + epoch)) %
        (unsigned __int128)n;
    read_window(s, (int64_t)w, out + i * s.window);
  }
}

void worker_loop(Source* s) {
  std::unique_lock<std::mutex> lk(s->mu);
  while (true) {
    s->cv.wait(lk, [s] { return s->shutdown || s->request_pending; });
    if (s->shutdown) return;
    BatchKey key = s->request_key;
    s->request_pending = false;
    int64_t rows = key.row_end - key.row_start;
    std::vector<int32_t> buf((size_t)(rows * s->window));
    lk.unlock();
    fill_batch(*s, key, buf.data());
    lk.lock();
    if (s->shutdown) return;
    // a newer request may have superseded this one; last writer wins
    s->ready_buf = std::move(buf);
    s->ready_key = key;
    s->ready = true;
    s->cv.notify_all();
  }
}

}  // namespace

extern "C" {

int32_t tpudata_abi_version() { return 1; }

int64_t tpudata_open(const char** paths, int32_t n_paths, int64_t window,
                     int32_t dtype_code) {
  if (n_paths < 1 || window < 2 ||
      (dtype_code != 2 && dtype_code != 4))
    return -1;
  auto s = new Source();
  s->window = window;
  s->dtype_code = dtype_code;
  for (int32_t i = 0; i < n_paths; ++i) {
    int fd = open(paths[i], O_RDONLY);
    if (fd < 0) {
      delete s;
      return -1;
    }
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size % dtype_code != 0) {
      close(fd);
      delete s;
      return -1;
    }
    MappedFile f;
    f.bytes = (size_t)st.st_size;
    f.n_tokens = st.st_size / dtype_code;
    if (f.bytes > 0) {
      f.ptr = mmap(nullptr, f.bytes, PROT_READ, MAP_PRIVATE, fd, 0);
      if (f.ptr == MAP_FAILED) {
        close(fd);
        delete s;
        return -1;
      }
    }
    close(fd);  // mmap holds its own reference
    s->n_tokens += f.n_tokens;
    s->files.push_back(f);
  }
  s->n_windows = s->n_tokens / window;
  if (s->n_windows < 1) {
    delete s;
    return -1;
  }
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t h = g_next_handle++;
  g_sources[h] = s;
  return h;
}

int64_t tpudata_n_tokens(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_sources.find(handle);
  return it == g_sources.end() ? -1 : it->second->n_tokens;
}

int64_t tpudata_n_windows(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_sources.find(handle);
  return it == g_sources.end() ? -1 : it->second->n_windows;
}

int32_t tpudata_batch(int64_t handle, int64_t step, int64_t global_batch,
                      int64_t row_start, int64_t row_end, int64_t seed,
                      int32_t* out) {
  if (row_end <= row_start || global_batch < 1 || step < 0 || seed < 0)
    return -2;
  Source* s;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_sources.find(handle);
    if (it == g_sources.end()) return -1;
    s = it->second;
    s->in_use.fetch_add(1);  // pins against a concurrent tpudata_close
  }
  BatchKey key{step, global_batch, row_start, row_end, seed};
  int64_t rows = row_end - row_start;
  bool hit = false;
  {
    std::unique_lock<std::mutex> lk(s->mu);
    if (s->ready && s->ready_key == key &&
        (int64_t)s->ready_buf.size() == rows * s->window) {
      std::memcpy(out, s->ready_buf.data(),
                  s->ready_buf.size() * sizeof(int32_t));
      s->ready = false;
      s->hits += 1;
      hit = true;
    }
  }
  if (!hit) fill_batch(*s, key, out);
  // lookahead: precompute the NEXT step for the same row range — the
  // trainer reads sequentially, so this overlaps with device compute
  {
    std::unique_lock<std::mutex> lk(s->mu);
    if (!s->worker_started) {
      s->worker = std::thread(worker_loop, s);
      s->worker_started = true;
    }
    s->request_key = BatchKey{step + 1, global_batch, row_start, row_end,
                              seed};
    s->request_pending = true;
  }
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->in_use.fetch_sub(1);
  }
  s->cv.notify_all();
  return 0;
}

int64_t tpudata_hits(int64_t handle) {
  Source* s;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_sources.find(handle);
    if (it == g_sources.end()) return -1;
    s = it->second;
    s->in_use.fetch_add(1);  // the same pin as tpudata_batch's
  }
  int64_t hits;
  {
    std::lock_guard<std::mutex> lk(s->mu);
    hits = s->hits;
    s->in_use.fetch_sub(1);
  }
  s->cv.notify_all();
  return hits;
}

void tpudata_close(int64_t handle) {
  Source* s = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_sources.find(handle);
    if (it == g_sources.end()) return;
    s = it->second;
    g_sources.erase(it);  // unreachable to new tpudata_batch calls
  }
  {
    // drain in-flight batch calls on THIS source only — g_mu is
    // already released, so other handles stay fully serviceable even
    // if a fill here takes seconds of cold page-ins
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv.wait(lk, [s] { return s->in_use.load() == 0; });
  }
  delete s;  // ~Source joins the worker and unmaps
}

}  // extern "C"
