// dl4jtpu_io: native data-loading runtime.
//
// Role parity with the reference's native IO stack: DataVec's record
// readers + the AsyncDataSetIterator copy path (reference: datavec-local
// executors, libnd4j host-side loaders, JavaCPP image loaders). The
// compute path runs on the GPU; this library keeps the HOST side of the
// input pipeline off the Python interpreter: CSV parsing, MNIST/IDX
// decoding, and a threaded shuffled-minibatch assembler feeding a ring of
// buffers. ring_next copies into a buffer the caller owns, which may be
// pinned host memory that the caller then copies to the device.
//
// Plain C ABI for ctypes; C++17, no external dependencies. Host code,
// built with g++ (deeplearning4j_tpu_torch/native/__init__.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- CSV
// Counts rows/cols of a delimited file (excluding skip_lines header rows).
// Returns 0 on success.
int csv_dims(const char* path, char delim, int skip_lines, int64_t* rows,
             int64_t* cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::string line;
  int64_t r = 0, c = 0;
  int ch;
  int64_t cur_cols = 1;
  bool any = false;
  int64_t line_no = 0;
  while ((ch = std::fgetc(f)) != EOF) {
    if (ch == '\n') {
      if (any && line_no >= skip_lines) {
        ++r;
        if (c == 0) c = cur_cols;
      }
      ++line_no;
      cur_cols = 1;
      any = false;
    } else if (ch == delim) {
      ++cur_cols;
      any = true;
    } else if (ch != '\r') {
      any = true;
    }
  }
  if (any && line_no >= skip_lines) {
    ++r;
    if (c == 0) c = cur_cols;
  }
  std::fclose(f);
  *rows = r;
  *cols = c;
  return 0;
}

// Parses numeric CSV into out[rows*cols] (row-major float32).
int csv_parse(const char* path, char delim, int skip_lines, float* out,
              int64_t rows, int64_t cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  // read whole file (input pipelines stream per-file; files are shards)
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  buf[got] = '\0';

  const char* p = buf.data();
  const char* end = p + got;
  // skip header lines
  for (int s = 0; s < skip_lines && p < end; ++s) {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  int64_t r = 0;
  while (p < end && r < rows) {
    // skip blank lines
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;
    for (int64_t c = 0; c < cols; ++c) {
      char* next = nullptr;
      float v = std::strtof(p, &next);
      if (next == p) {  // non-numeric token: skip to delimiter
        v = 0.0f;
        while (p < end && *p != delim && *p != '\n') ++p;
        next = const_cast<char*>(p);
      }
      out[r * cols + c] = v;
      p = next;
      while (p < end && (*p == delim || *p == ' ')) ++p;
    }
    while (p < end && *p != '\n') ++p;
    ++r;
  }
  return r == rows ? 0 : -2;
}

// ---------------------------------------------------------------- IDX
// MNIST/EMNIST IDX format: magic(4B big-endian: 0,0,dtype,ndim), dims...
static uint32_t be32(const unsigned char* b) {
  return (uint32_t(b[0]) << 24) | (uint32_t(b[1]) << 16) |
         (uint32_t(b[2]) << 8) | uint32_t(b[3]);
}

int idx_dims(const char* path, int64_t* ndim, int64_t* dims /*max 4*/) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  unsigned char hdr[4];
  if (std::fread(hdr, 1, 4, f) != 4) { std::fclose(f); return -2; }
  int nd = hdr[3];
  if (nd < 1 || nd > 4) { std::fclose(f); return -3; }
  *ndim = nd;
  for (int i = 0; i < nd; ++i) {
    unsigned char d[4];
    if (std::fread(d, 1, 4, f) != 4) { std::fclose(f); return -2; }
    dims[i] = be32(d);
  }
  std::fclose(f);
  return 0;
}

// Reads u8 IDX payload into float32 out (optionally scaled by 1/255).
int idx_read_f32(const char* path, float* out, int64_t count, int normalize) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  unsigned char hdr[4];
  if (std::fread(hdr, 1, 4, f) != 4) { std::fclose(f); return -2; }
  int nd = hdr[3];
  std::fseek(f, 4 + 4 * nd, SEEK_SET);
  std::vector<unsigned char> raw(static_cast<size_t>(count));
  size_t got = std::fread(raw.data(), 1, raw.size(), f);
  std::fclose(f);
  if (got != raw.size()) return -2;
  const float scale = normalize ? (1.0f / 255.0f) : 1.0f;
  for (int64_t i = 0; i < count; ++i) out[i] = raw[i] * scale;
  return 0;
}

// ------------------------------------------------- batch assembler ring
// Threaded shuffled-minibatch gatherer over host-resident feature/label
// arrays: the AsyncDataSetIterator's copy work without the GIL.
struct BatchRing {
  const float* x;
  const float* y;
  int64_t n, xf, yf, batch;
  bool shuffle;
  bool drop_last;  // false: emit the trailing partial batch (reference
                   // DataSetIterator contract — a final smaller batch)
  uint64_t seed;
  int64_t epochs;  // -1 = infinite

  std::vector<std::vector<float>> slots_x, slots_y;
  std::vector<int64_t> slot_rows;  // actual rows in each filled slot
  std::queue<int> ready;     // filled slot indices
  std::queue<int> free_;     // reusable slot indices
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::thread worker;
  std::atomic<bool> stop{false};
  bool done = false;

  void run() {
    std::mt19937_64 rng(seed);
    std::vector<int64_t> order(n);
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    int64_t epoch = 0;
    while (!stop.load() && (epochs < 0 || epoch < epochs)) {
      if (shuffle) {
        for (int64_t i = n - 1; i > 0; --i) {
          std::uniform_int_distribution<int64_t> d(0, i);
          std::swap(order[i], order[d(rng)]);
        }
      }
      int64_t limit = drop_last ? n - batch : n - 1;
      for (int64_t start = 0; start <= limit && !stop.load();
           start += batch) {
        int64_t rows = std::min(batch, n - start);
        int slot;
        {
          std::unique_lock<std::mutex> lk(mu);
          cv_free.wait(lk, [&] { return !free_.empty() || stop.load(); });
          if (stop.load()) return;
          slot = free_.front();
          free_.pop();
        }
        float* bx = slots_x[slot].data();
        float* by = slots_y[slot].data();
        for (int64_t i = 0; i < rows; ++i) {
          int64_t src = order[start + i];
          std::memcpy(bx + i * xf, x + src * xf, sizeof(float) * xf);
          if (yf > 0)
            std::memcpy(by + i * yf, y + src * yf, sizeof(float) * yf);
        }
        {
          std::lock_guard<std::mutex> lk(mu);
          slot_rows[slot] = rows;
          ready.push(slot);
        }
        cv_ready.notify_one();
      }
      ++epoch;
    }
    {
      std::lock_guard<std::mutex> lk(mu);
      done = true;
    }
    cv_ready.notify_all();
  }
};

void* ring_create(const float* x, const float* y, int64_t n, int64_t xf,
                  int64_t yf, int64_t batch, int n_slots, int shuffle,
                  uint64_t seed, int64_t epochs, int drop_last) {
  auto* r = new BatchRing();
  r->x = x;
  r->y = y;
  r->n = n;
  r->xf = xf;
  r->yf = yf;
  r->batch = batch;
  r->shuffle = shuffle != 0;
  r->drop_last = drop_last != 0;
  r->seed = seed;
  r->epochs = epochs;
  r->slot_rows.assign(n_slots, 0);
  for (int i = 0; i < n_slots; ++i) {
    r->slots_x.emplace_back(static_cast<size_t>(batch * xf));
    r->slots_y.emplace_back(static_cast<size_t>(batch * (yf > 0 ? yf : 1)));
    r->free_.push(i);
  }
  r->worker = std::thread([r] { r->run(); });
  return r;
}

// Pops the next batch into out_x/out_y, writing the row count (== batch
// except for a trailing partial batch) to *out_rows. Returns 1 on success,
// 0 when the ring is exhausted (all epochs emitted).
int ring_next(void* handle, float* out_x, float* out_y, int64_t* out_rows) {
  auto* r = static_cast<BatchRing*>(handle);
  int slot;
  {
    std::unique_lock<std::mutex> lk(r->mu);
    r->cv_ready.wait(lk, [&] { return !r->ready.empty() || r->done; });
    if (r->ready.empty()) return 0;
    slot = r->ready.front();
    r->ready.pop();
  }
  int64_t rows = r->slot_rows[slot];
  std::memcpy(out_x, r->slots_x[slot].data(),
              sizeof(float) * rows * r->xf);
  if (r->yf > 0)
    std::memcpy(out_y, r->slots_y[slot].data(),
                sizeof(float) * rows * r->yf);
  if (out_rows) *out_rows = rows;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->free_.push(slot);
  }
  r->cv_free.notify_one();
  return 1;
}

void ring_destroy(void* handle) {
  auto* r = static_cast<BatchRing*>(handle);
  r->stop.store(true);
  r->cv_free.notify_all();
  r->cv_ready.notify_all();
  if (r->worker.joinable()) r->worker.join();
  delete r;
}

}  // extern "C"
