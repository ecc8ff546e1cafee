// raystore: the host-side ray-batch sampler and prefetcher of tinynerf_torch
// (HOST_FEED), a copy of the JAX package's native/raystore.cpp with the same C
// ABI, generator, ring buffer and mmap path, so that batch i of a seed is the
// same in both packages.
//
// The device-side data path keeps the whole pixel table on the card and
// samples batches there (tinynerf_torch/data/rays.py). For scenes whose
// pixel table should not live on the device (full-resolution LLFF captures:
// fern = 20 x 4032 x 3024 x 3 floats = 2.9 GB), this layer keeps the table
// on the host (optionally memory-mapped) and assembles ray batches on a
// background thread into a ring of ready batches, so that the card does not
// wait on the host. A counter-based generator makes batch i the same
// whatever the timing.
//
// A plain C ABI, loaded from Python with ctypes (tinynerf_torch/data/native.py)
// and built there with g++ at first use. No Python.h dependency. This file is
// host code: it is not a CUDA source and kernels/build.py does not build it.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// counter-based PRNG (squares32: Widynski's squares RNG — counter-based like
// Philox, 2^64 period per key, passes BigCrush). Deterministic sampling:
// index j of batch i depends only on (seed, i, j).
// ---------------------------------------------------------------------------
inline uint32_t squares32(uint64_t ctr, uint64_t key) {
  uint64_t x = ctr * key;
  uint64_t y = x;
  uint64_t z = y + key;
  x = x * x + y;
  x = (x >> 32) | (x << 32);  // round 1
  x = x * x + z;
  x = (x >> 32) | (x << 32);  // round 2
  x = x * x + y;
  x = (x >> 32) | (x << 32);  // round 3
  return static_cast<uint32_t>((x * x + z) >> 32);  // round 4
}

struct RayStore {
  // pixel table: (num_pix, 3) float32 or uint8, host-resident or mmap'd
  const void *pixels = nullptr;
  bool pixels_u8 = false;
  void *mmap_base = nullptr;
  size_t mmap_len = 0;
  std::vector<float> owned_pixels;   // when loaded rather than mapped
  std::vector<uint8_t> owned_u8;

  // pose table: (num_pics, 17) float32 (always tiny -> owned)
  std::vector<float> poses;

  int64_t num_pix = 0;
  int64_t pic_size = 0;  // H * W
  int64_t width = 0;
  uint64_t seed_key = 0;

  // prefetch ring
  struct Slot {
    std::vector<float> rows, cols, rgb, pose;
    std::vector<int32_t> pic;
    int64_t batch_index = -1;
    bool full = false;
  };
  std::vector<Slot> ring;
  int64_t next_fill = 0;   // batch index the producer fills next
  int64_t next_take = 0;   // batch index the consumer takes next
  int batch = 0;
  std::thread producer;
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::atomic<bool> stop{false};

  // Fills `slot` with batch `bi` of size `b`. Does NOT publish the slot
  // (batch_index/full stay untouched): publication happens under `mu` in
  // producer_loop so the consumer's cv predicate never races a plain write.
  void fill_batch(int64_t bi, Slot &slot, int b) {
    slot.rows.resize(b);
    slot.cols.resize(b);
    slot.rgb.resize(static_cast<size_t>(b) * 3);
    slot.pose.resize(static_cast<size_t>(b) * 17);
    slot.pic.resize(b);
    const float *pf = static_cast<const float *>(pixels);
    const uint8_t *pu = static_cast<const uint8_t *>(pixels);
    for (int j = 0; j < b; ++j) {
      uint64_t ctr = (static_cast<uint64_t>(bi) << 32) | (uint32_t)j;
      // rejection-free modulo bias is negligible for num_pix << 2^32;
      // use 64-bit draw for large stores
      uint64_t draw = (static_cast<uint64_t>(squares32(ctr, seed_key)) << 32) |
                      squares32(ctr ^ 0x9E3779B97F4A7C15ull, seed_key);
      int64_t idx = static_cast<int64_t>(draw % static_cast<uint64_t>(num_pix));
      int64_t pic = idx / pic_size;
      int64_t in_pic = idx % pic_size;
      slot.rows[j] = static_cast<float>(in_pic / width);
      slot.cols[j] = static_cast<float>(in_pic % width);
      slot.pic[j] = static_cast<int32_t>(pic);
      if (pixels_u8) {
        for (int c = 0; c < 3; ++c)
          slot.rgb[j * 3 + c] = pu[idx * 3 + c] * (1.0f / 255.0f);
      } else {
        std::memcpy(&slot.rgb[j * 3], &pf[idx * 3], 3 * sizeof(float));
      }
      std::memcpy(&slot.pose[j * 17], &poses[pic * 17], 17 * sizeof(float));
    }
  }

  void producer_loop() {
    for (;;) {
      std::unique_lock<std::mutex> lk(mu);
      cv_empty.wait(lk, [&] {
        return stop.load() || !ring[next_fill % ring.size()].full;
      });
      if (stop.load()) return;
      Slot &slot = ring[next_fill % ring.size()];
      int64_t bi = next_fill;
      lk.unlock();
      fill_batch(bi, slot, batch);  // not visible to consumer until published
      lk.lock();
      slot.batch_index = bi;  // publish under mu: rs_next's cv predicate
      slot.full = true;       // reads these fields under the same mutex
      ++next_fill;
      cv_full.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// Create a store over caller-provided pixel/pose memory (copied in).
// pixels: (num_pix, 3) float32 if u8 == 0, else uint8.
void *rs_create(const void *pixels, int is_u8, int64_t num_pix,
                const float *poses, int64_t num_pics, int64_t height,
                int64_t width, uint64_t seed) {
  auto *s = new RayStore();
  s->pixels_u8 = is_u8 != 0;
  s->num_pix = num_pix;
  s->pic_size = height * width;
  s->width = width;
  // squares RNG wants an odd, irregular key; derive from seed
  s->seed_key = (seed * 0x9E3779B97F4A7C15ull) | 1ull;
  if (is_u8) {
    s->owned_u8.assign(static_cast<const uint8_t *>(pixels),
                       static_cast<const uint8_t *>(pixels) + num_pix * 3);
    s->pixels = s->owned_u8.data();
  } else {
    s->owned_pixels.assign(static_cast<const float *>(pixels),
                           static_cast<const float *>(pixels) + num_pix * 3);
    s->pixels = s->owned_pixels.data();
  }
  s->poses.assign(poses, poses + num_pics * 17);
  return s;
}

// Create a store over a raw little-endian pixel file (mmap'd, zero-copy) —
// for tables that must not be duplicated in host RAM.
void *rs_create_mmap(const char *pixel_path, int is_u8, int64_t num_pix,
                     const float *poses, int64_t num_pics, int64_t height,
                     int64_t width, uint64_t seed) {
  int fd = open(pixel_path, O_RDONLY);
  if (fd < 0) return nullptr;
  size_t len = static_cast<size_t>(num_pix) * 3 * (is_u8 ? 1 : 4);
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) < len) {
    // A short/truncated file would mmap fine but SIGBUS on first access
    // past EOF — fail loudly here instead.
    close(fd);
    return nullptr;
  }
  void *base = mmap(nullptr, len, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  auto *s = new RayStore();
  s->pixels_u8 = is_u8 != 0;
  s->num_pix = num_pix;
  s->pic_size = height * width;
  s->width = width;
  s->seed_key = (seed * 0x9E3779B97F4A7C15ull) | 1ull;
  s->mmap_base = base;
  s->mmap_len = len;
  s->pixels = base;
  s->poses.assign(poses, poses + num_pics * 17);
  return s;
}

// Synchronous sampling of one deterministic batch (no prefetch thread).
void rs_sample(void *handle, int64_t batch_index, int batch, float *rows,
               float *cols, float *rgb, float *pose, int32_t *pic) {
  auto *s = static_cast<RayStore *>(handle);
  RayStore::Slot slot;
  s->fill_batch(batch_index, slot, batch);
  std::memcpy(rows, slot.rows.data(), batch * sizeof(float));
  std::memcpy(cols, slot.cols.data(), batch * sizeof(float));
  std::memcpy(rgb, slot.rgb.data(), batch * 3 * sizeof(float));
  std::memcpy(pose, slot.pose.data(), batch * 17 * sizeof(float));
  std::memcpy(pic, slot.pic.data(), batch * sizeof(int32_t));
}

// Start the background prefetcher with `depth` ring slots.
void rs_prefetch_start(void *handle, int batch, int depth) {
  auto *s = static_cast<RayStore *>(handle);
  s->batch = batch;
  s->ring.resize(depth);
  s->next_fill = 0;
  s->next_take = 0;
  s->stop.store(false);
  s->producer = std::thread([s] { s->producer_loop(); });
}

// Blocking take of the next prefetched batch; returns its batch index.
int64_t rs_next(void *handle, float *rows, float *cols, float *rgb,
                float *pose, int32_t *pic) {
  auto *s = static_cast<RayStore *>(handle);
  std::unique_lock<std::mutex> lk(s->mu);
  RayStore::Slot &slot = s->ring[s->next_take % s->ring.size()];
  s->cv_full.wait(lk, [&] { return slot.full && slot.batch_index == s->next_take; });
  int64_t bi = slot.batch_index;
  std::memcpy(rows, slot.rows.data(), s->batch * sizeof(float));
  std::memcpy(cols, slot.cols.data(), s->batch * sizeof(float));
  std::memcpy(rgb, slot.rgb.data(), s->batch * 3 * sizeof(float));
  std::memcpy(pose, slot.pose.data(), s->batch * 17 * sizeof(float));
  std::memcpy(pic, slot.pic.data(), s->batch * sizeof(int32_t));
  slot.full = false;
  ++s->next_take;
  s->cv_empty.notify_all();
  return bi;
}

void rs_destroy(void *handle) {
  auto *s = static_cast<RayStore *>(handle);
  if (s->producer.joinable()) {
    s->stop.store(true);
    s->cv_empty.notify_all();
    s->producer.join();
  }
  if (s->mmap_base != nullptr) munmap(s->mmap_base, s->mmap_len);
  delete s;
}

}  // extern "C"
