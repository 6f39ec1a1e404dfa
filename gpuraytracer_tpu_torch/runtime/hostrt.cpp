// Native host runtime of gpuraytracer_tpu_torch (the port's own copy of
// gpuraytracer_tpu/runtime/hostrt.cpp; this package imports nothing of the
// JAX package). Host code, not a device kernel: the frame loop's substrate
//   - a monotonic high-resolution clock (the QueryPerformanceCounter analog,
//     reference: src/StepTimer.h, src/PerformanceTimers.cpp)
//   - framebuffer presentation to the output sink: PNG encoding + a bounded
//     async writer thread (the swapchain-present analog for a headless
//     renderer, reference: src/DeviceResources.cpp present/frame pacing)
//
// Exposed as a C ABI consumed via ctypes (runtime/hostrt.py), built with
// g++ at first use. The encoder's bytes equal the reference's for the same
// pixels (stored deflate blocks, filter byte 0).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <time.h>

extern "C" {

// ---------------------------------------------------------------------------
// Clock
// ---------------------------------------------------------------------------

int64_t hostrt_now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000000000LL + ts.tv_nsec;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// PNG encoding (no external deps: stored-deflate zlib stream + CRC32/Adler32)
// ---------------------------------------------------------------------------

namespace {

uint32_t crc_table[256];
std::once_flag crc_once;

void init_crc() {
  for (uint32_t n = 0; n < 256; n++) {
    uint32_t c = n;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[n] = c;
  }
}

uint32_t crc32_of(const uint8_t* data, size_t len, uint32_t crc = 0xFFFFFFFFu) {
  std::call_once(crc_once, init_crc);
  for (size_t i = 0; i < len; i++) crc = crc_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return crc;
}

void put_u32_be(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back(uint8_t(v >> 24));
  out.push_back(uint8_t(v >> 16));
  out.push_back(uint8_t(v >> 8));
  out.push_back(uint8_t(v));
}

void append_chunk(std::vector<uint8_t>& out, const char tag[4],
                  const uint8_t* payload, size_t len) {
  put_u32_be(out, uint32_t(len));
  size_t start = out.size();
  out.insert(out.end(), tag, tag + 4);
  if (len) out.insert(out.end(), payload, payload + len);
  uint32_t crc = crc32_of(out.data() + start, out.size() - start) ^ 0xFFFFFFFFu;
  put_u32_be(out, crc);
}

// zlib stream with stored (uncompressed) deflate blocks: larger files than
// real deflate, but dependency-free and fast enough to keep up with frames.
void zlib_stored(std::vector<uint8_t>& out, const uint8_t* data, size_t len) {
  out.push_back(0x78);  // CMF: deflate, 32K window
  out.push_back(0x01);  // FLG: no dict, fastest
  uint32_t a = 1, b = 0;
  for (size_t i = 0; i < len; i++) {
    a = (a + data[i]) % 65521;
    b = (b + a) % 65521;
  }
  size_t pos = 0;
  while (pos < len || len == 0) {
    size_t n = std::min<size_t>(65535, len - pos);
    bool last = (pos + n == len);
    out.push_back(last ? 1 : 0);
    out.push_back(uint8_t(n & 0xFF));
    out.push_back(uint8_t(n >> 8));
    out.push_back(uint8_t(~n & 0xFF));
    out.push_back(uint8_t((~n >> 8) & 0xFF));
    out.insert(out.end(), data + pos, data + pos + n);
    pos += n;
    if (last || len == 0) break;
  }
  put_u32_be(out, (b << 16) | a);  // adler32
}

int encode_png(std::vector<uint8_t>& png, const uint8_t* pixels, int w, int h,
               int channels) {
  if (channels != 3 && channels != 4) return -1;
  png.clear();
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  png.insert(png.end(), sig, sig + 8);

  uint8_t ihdr[13];
  ihdr[0] = uint8_t(w >> 24); ihdr[1] = uint8_t(w >> 16);
  ihdr[2] = uint8_t(w >> 8);  ihdr[3] = uint8_t(w);
  ihdr[4] = uint8_t(h >> 24); ihdr[5] = uint8_t(h >> 16);
  ihdr[6] = uint8_t(h >> 8);  ihdr[7] = uint8_t(h);
  ihdr[8] = 8;                              // bit depth
  ihdr[9] = (channels == 4) ? 6 : 2;        // color type
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  append_chunk(png, "IHDR", ihdr, 13);

  // Raw scanlines with filter byte 0.
  std::vector<uint8_t> raw;
  raw.reserve(size_t(h) * (1 + size_t(w) * channels));
  for (int y = 0; y < h; y++) {
    raw.push_back(0);
    const uint8_t* row = pixels + size_t(y) * w * channels;
    raw.insert(raw.end(), row, row + size_t(w) * channels);
  }
  std::vector<uint8_t> z;
  z.reserve(raw.size() + raw.size() / 65535 * 5 + 16);
  zlib_stored(z, raw.data(), raw.size());
  append_chunk(png, "IDAT", z.data(), z.size());
  append_chunk(png, "IEND", nullptr, 0);
  return 0;
}

int write_file(const char* path, const std::vector<uint8_t>& bytes) {
  FILE* f = fopen(path, "wb");
  if (!f) return -2;
  size_t n = fwrite(bytes.data(), 1, bytes.size(), f);
  int closed = fclose(f);
  return (n == bytes.size() && closed == 0) ? 0 : -3;
}

// ---------------------------------------------------------------------------
// Async frame writer: overlaps PNG encoding and file IO with device rendering
// (the frames-in-flight present queue analog). At most max_depth frames wait
// in the queue; submit blocks until one leaves (backpressure).
// ---------------------------------------------------------------------------

struct FrameJob {
  std::string path;
  std::vector<uint8_t> pixels;
  int w, h, channels;
};

struct Writer {
  std::thread thread;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<FrameJob> queue;
  size_t max_depth;
  size_t in_progress = 0;
  bool stopping = false;
  std::atomic<int64_t> written{0};
  std::atomic<int64_t> errors{0};

  explicit Writer(size_t depth) : max_depth(depth) {
    thread = std::thread([this] { run(); });
  }

  void run() {
    for (;;) {
      FrameJob job;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv.wait(lock, [this] { return stopping || !queue.empty(); });
        if (queue.empty()) return;  // stopping, and nothing left to write
        job = std::move(queue.front());
        queue.pop_front();
        in_progress++;
      }
      cv.notify_all();
      std::vector<uint8_t> png;
      if (encode_png(png, job.pixels.data(), job.w, job.h, job.channels) == 0 &&
          write_file(job.path.c_str(), png) == 0) {
        written.fetch_add(1);
      } else {
        errors.fetch_add(1);
      }
      {
        std::lock_guard<std::mutex> lock(mu);
        in_progress--;
      }
      cv.notify_all();
    }
  }

  void submit(const char* path, const uint8_t* pixels, int w, int h, int c) {
    FrameJob job;
    job.path = path;
    job.pixels.assign(pixels, pixels + size_t(w) * h * c);
    job.w = w; job.h = h; job.channels = c;
    std::unique_lock<std::mutex> lock(mu);
    cv.wait(lock, [this] { return queue.size() < max_depth; });  // backpressure
    queue.push_back(std::move(job));
    cv.notify_all();
  }

  void drain() {
    std::unique_lock<std::mutex> lock(mu);
    cv.wait(lock, [this] { return queue.empty() && in_progress == 0; });
  }

  int64_t queued() {
    std::lock_guard<std::mutex> lock(mu);
    return int64_t(queue.size() + in_progress);
  }

  ~Writer() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stopping = true;
    }
    cv.notify_all();
    if (thread.joinable()) thread.join();
  }
};

}  // namespace

extern "C" {

int hostrt_write_png(const char* path, const uint8_t* pixels, int w, int h,
                     int channels) {
  std::vector<uint8_t> png;
  int rc = encode_png(png, pixels, w, h, channels);
  if (rc != 0) return rc;
  return write_file(path, png);
}

void* hostrt_writer_create(int max_depth) {
  return new Writer(size_t(max_depth > 0 ? max_depth : 3));
}

void hostrt_writer_submit(void* writer, const char* path, const uint8_t* pixels,
                          int w, int h, int channels) {
  static_cast<Writer*>(writer)->submit(path, pixels, w, h, channels);
}

void hostrt_writer_drain(void* writer) {
  static_cast<Writer*>(writer)->drain();
}

int64_t hostrt_writer_written(void* writer) {
  return static_cast<Writer*>(writer)->written.load();
}

int64_t hostrt_writer_errors(void* writer) {
  return static_cast<Writer*>(writer)->errors.load();
}

// Frames waiting in the queue plus the one being written.
int64_t hostrt_writer_queued(void* writer) {
  return static_cast<Writer*>(writer)->queued();
}

void hostrt_writer_destroy(void* writer) { delete static_cast<Writer*>(writer); }

}  // extern "C"
