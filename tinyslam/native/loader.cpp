// Async prefetching frame loader: a native worker pool decodes frames
// ahead of the consumer into a bounded ring of slots, so the Python/JAX
// pipeline never stalls on file IO + PNG inflate (the analog of
// a data-loader runtime; the reference has none — its input path is a
// host-blocking queue.write_texture per frame, reference src/orb.rs:567-583).
//
// C ABI:
//   ts_loader_create(paths, n_paths, capacity, n_threads) -> handle
//   ts_loader_next(handle, out, out_cap, &w, &h, &c, &bd) -> index | -1 end
//   ts_loader_destroy(handle)
//
// Frames are delivered strictly in order; decoding runs out of order across
// the worker pool, bounded by `capacity` in-flight slots.

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" int ts_decode_image(const char* path, uint8_t* out,
                               int64_t out_cap, int32_t* w, int32_t* h,
                               int32_t* channels, int32_t* bitdepth);

namespace {

struct Slot {
  std::vector<uint8_t> data;
  int32_t w = 0, h = 0, channels = 0, bitdepth = 0;
  bool ok = false;
  bool ready = false;
};

struct Loader {
  std::vector<std::string> paths;
  size_t capacity;
  std::vector<std::unique_ptr<Slot>> slots;   // index i -> slot i % capacity? No:
  // we keep a sliding window [next_out, next_out + capacity) of slots keyed
  // by frame index.
  std::mutex mu;
  std::condition_variable cv_ready;
  std::condition_variable cv_space;
  size_t next_claim = 0;   // next frame index a worker will decode
  size_t next_out = 0;     // next frame index the consumer takes
  bool stop = false;
  std::vector<std::thread> workers;
  std::vector<std::unique_ptr<Slot>> window;  // size = capacity

  Slot* slot_for(size_t idx) { return window[idx % capacity].get(); }

  void worker() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop || (next_claim < paths.size() &&
                          next_claim < next_out + capacity);
        });
        if (stop || next_claim >= paths.size()) return;
        idx = next_claim++;
      }
      Slot tmp;
      int32_t w, h, c, bd;
      int rc = ts_decode_image(paths[idx].c_str(), nullptr, 0, &w, &h, &c, &bd);
      if (rc == 0) {
        tmp.data.resize(size_t(w) * h * c * (bd / 8));
        rc = ts_decode_image(paths[idx].c_str(), tmp.data.data(),
                             int64_t(tmp.data.size()), &w, &h, &c, &bd);
      }
      tmp.ok = (rc == 0);
      tmp.w = w; tmp.h = h; tmp.channels = c; tmp.bitdepth = bd;
      {
        std::lock_guard<std::mutex> lk(mu);
        Slot* s = slot_for(idx);
        *s = std::move(tmp);
        s->ready = true;
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* ts_loader_create(const char** paths, int32_t n_paths, int32_t capacity,
                       int32_t n_threads) {
  auto* L = new Loader();
  L->paths.assign(paths, paths + n_paths);
  L->capacity = capacity > 0 ? size_t(capacity) : 8;
  L->window.resize(L->capacity);
  for (auto& s : L->window) s = std::make_unique<Slot>();
  int nt = n_threads > 0 ? n_threads : 4;
  for (int i = 0; i < nt; ++i) {
    L->workers.emplace_back([L] { L->worker(); });
  }
  return L;
}

// Returns the frame index delivered (>= 0), -1 at end of stream, -2 decode
// failure for this frame (stream continues), -3 buffer too small.
int64_t ts_loader_next(void* handle, uint8_t* out, int64_t out_cap,
                       int32_t* w, int32_t* h, int32_t* channels,
                       int32_t* bitdepth) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_out >= L->paths.size()) return -1;
  size_t idx = L->next_out;
  Slot* s = L->slot_for(idx);
  L->cv_ready.wait(lk, [&] { return s->ready; });
  int64_t rc;
  if (!s->ok) {
    rc = -2;
  } else if (out_cap < int64_t(s->data.size())) {
    rc = -3;
  } else {
    std::memcpy(out, s->data.data(), s->data.size());
    *w = s->w; *h = s->h; *channels = s->channels; *bitdepth = s->bitdepth;
    rc = int64_t(idx);
  }
  s->ready = false;
  s->data.clear();
  L->next_out++;
  lk.unlock();
  L->cv_space.notify_all();
  return rc;
}

void ts_loader_peek(void* handle, int64_t idx_unused, int32_t* w, int32_t* h,
                    int32_t* channels, int32_t* bitdepth) {
  // Dimensions of the NEXT frame (blocks until decoded).
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_out >= L->paths.size()) { *w = *h = *channels = *bitdepth = 0; return; }
  Slot* s = L->slot_for(L->next_out);
  L->cv_ready.wait(lk, [&] { return s->ready; });
  *w = s->w; *h = s->h; *channels = s->channels; *bitdepth = s->bitdepth;
}

void ts_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_space.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
