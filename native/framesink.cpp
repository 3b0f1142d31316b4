// Native asynchronous frame sink.
//
// The reference's display path is native: dye pixels go through a CUDA
// surface write into a GL texture and are blitted by the window loop
// (GPUFluidSim.cu:594-601, Main.cpp:166-180) — the host Python equivalent
// must not stall the simulation while encoding/writing frames.  This sink is
// that native piece: a producer/consumer ring buffer
// where the simulation thread pushes RGBA frames (non-blocking, drop-oldest
// like a real-time display) and a background thread encodes them to PNG
// (zlib) and writes them to disk.
//
// C ABI (used from Python via ctypes):
//   fs_open(dir, w, h, capacity) -> handle
//   fs_push(handle, rgba_ptr)    -> 1 if queued, 0 if dropped
//   fs_flush(handle)             -> block until queue drained
//   fs_frames_written(handle), fs_frames_dropped(handle)
//   fs_close(handle)             -> flush, join, free
//
// Build: g++ -O3 -shared -fPIC framesink.cpp -o libframesink.so -lz -pthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "png_encode.h"

namespace {

using pngenc::encode_png;

struct FrameSink {
  std::string dir;
  int w = 0, h = 0;
  size_t capacity = 0;

  std::mutex mu;
  std::condition_variable cv_push, cv_drain;
  std::vector<std::vector<uint8_t>> queue;  // raw RGBA frames
  bool closing = false;

  std::atomic<uint64_t> written{0};
  std::atomic<uint64_t> dropped{0};
  bool busy = false;  // a frame is popped and being encoded

  std::thread worker;

  void run() {
    for (;;) {
      std::vector<uint8_t> frame;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [&] { return closing || !queue.empty(); });
        if (queue.empty()) {
          if (closing) return;
          continue;
        }
        frame = std::move(queue.front());
        queue.erase(queue.begin());
        busy = true;
      }
      std::vector<uint8_t> png = encode_png(frame.data(), w, h);
      char path[4096];
      snprintf(path, sizeof(path), "%s/frame_%08llu.png", dir.c_str(),
               (unsigned long long)written.load());
      FILE* f = fopen(path, "wb");
      if (f) {
        fwrite(png.data(), 1, png.size(), f);
        fclose(f);
        written++;
      } else {
        dropped++;  // disk/permission failure: keep written+dropped == pushed
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        busy = false;
      }
      cv_drain.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* fs_open(const char* dir, int w, int h, int capacity) {
  auto* s = new FrameSink();
  s->dir = dir;
  s->w = w;
  s->h = h;
  s->capacity = size_t(capacity > 0 ? capacity : 8);
  s->worker = std::thread([s] { s->run(); });
  return s;
}

int fs_push(void* handle, const uint8_t* rgba) {
  auto* s = static_cast<FrameSink*>(handle);
  std::vector<uint8_t> copy(rgba, rgba + size_t(s->w) * s->h * 4);
  int accepted = 1;
  {
    std::lock_guard<std::mutex> lk(s->mu);
    if (s->queue.size() >= s->capacity) {
      // drop the OLDEST queued frame, like a real-time display that always
      // shows the latest content
      s->queue.erase(s->queue.begin());
      s->dropped++;
      accepted = 0;
    }
    s->queue.push_back(std::move(copy));
  }
  s->cv_push.notify_one();
  return accepted;  // 0 = an older frame was evicted to make room
}

void fs_flush(void* handle) {
  auto* s = static_cast<FrameSink*>(handle);
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv_drain.wait(lk, [&] { return s->queue.empty() && !s->busy; });
}

uint64_t fs_frames_written(void* handle) {
  return static_cast<FrameSink*>(handle)->written.load();
}

uint64_t fs_frames_dropped(void* handle) {
  return static_cast<FrameSink*>(handle)->dropped.load();
}

void fs_close(void* handle) {
  auto* s = static_cast<FrameSink*>(handle);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->closing = true;
  }
  s->cv_push.notify_all();
  s->worker.join();
  delete s;
}

}  // extern "C"
