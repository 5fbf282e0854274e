// Native batch sampler + prefetcher for the neusky_torch data pipeline: the
// JAX package's native/batch_sampler.cpp, whose prefetch thread here also
// draws the sky rays.
//
// Per-image valid/sky pixel index tables are built once in C++, and
// fixed-shape [U images x R rays] batches are drawn by a background
// prefetch thread into a ring buffer, so host batch assembly overlaps the
// device's step (the reference's CacheDataloader workers + NeuSkyPixelSampler
// rejection sampling, neusky_pixel_sampler.py:28-124).
//
// One xorshift128+ stream feeds every draw. While the prefetch thread runs
// it alone advances that stream: it draws each batch's sky rays right after
// the batch's pixels, so the prefetched stream is the synchronous one
// (sampler_sample_batch, then sampler_sample_sky) draw for draw, whatever
// the two threads' timing. sampler_sample_batch and sampler_sample_sky are
// for a sampler that does not prefetch.
//
// C ABI (ctypes); no Python objects cross the boundary. All buffers are
// caller-owned numpy arrays.
//
// Build: g++ -O3 -shared -fPIC -o libbatch_sampler.so batch_sampler.cpp -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

// xorshift128+ — fast, reproducible across platforms
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    s0 = seed ^ 0x9E3779B97F4A7C15ULL;
    s1 = (seed << 1) | 1;
    for (int i = 0; i < 8; i++) next();
  }
  uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  // unbiased-enough bounded draw for table sampling
  uint64_t bounded(uint64_t n) { return next() % n; }
};

struct Batch {
  std::vector<int32_t> image_rows;   // [U]
  std::vector<int64_t> flat_pixels;  // [U*R]
  std::vector<float> rgb;            // [U*R*3]
  std::vector<float> mask;           // [U*R*4]
  std::vector<int32_t> sky_rows;     // [S]
  std::vector<int64_t> sky_pixels;   // [S]
};

struct Sampler {
  // borrowed views of caller-owned arrays (kept alive by Python)
  const float* images = nullptr;  // [C, H*W, 3]
  const float* masks = nullptr;   // [C, H*W, 4]
  int num_images = 0, height = 0, width = 0;

  std::vector<std::vector<int64_t>> valid_idx;  // per-image static pixels
  std::vector<std::vector<int64_t>> sky_idx;    // per-image sky pixels
  bool has_sky = true;

  Rng rng;

  // prefetch machinery
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::queue<Batch*> ready;
  int queue_depth = 4;
  int pf_u = 0, pf_r = 0, pf_sky = 0;
  std::atomic<bool> stop{false};

  explicit Sampler(uint64_t seed) : rng(seed) {}
  ~Sampler() {
    stop.store(true);
    cv_full.notify_all();
    cv_empty.notify_all();
    if (worker.joinable()) worker.join();
    while (!ready.empty()) {
      delete ready.front();
      ready.pop();
    }
  }

  void build_tables() {
    const int64_t hw = (int64_t)height * width;
    valid_idx.assign(num_images, {});
    sky_idx.assign(num_images, {});
    for (int c = 0; c < num_images; c++) {
      const float* m = masks + (int64_t)c * hw * 4;
      auto& v = valid_idx[c];
      auto& s = sky_idx[c];
      v.reserve(hw);
      for (int64_t p = 0; p < hw; p++) {
        if (m[p * 4 + 0] > 0.5f) v.push_back(p);
        if (m[p * 4 + 3] > 0.5f) s.push_back(p);
      }
      if (v.empty()) v.push_back(0);
      if (s.empty()) has_sky = false;
    }
  }

  void fill_batch(Batch* b, int u, int r) {
    const int64_t hw = (int64_t)height * width;
    b->image_rows.resize(u);
    b->flat_pixels.resize((size_t)u * r);
    b->rgb.resize((size_t)u * r * 3);
    b->mask.resize((size_t)u * r * 4);
    for (int i = 0; i < u; i++) {
      int img = (int)rng.bounded(num_images);
      b->image_rows[i] = img;
      const auto& table = valid_idx[img];
      const float* im = images + (int64_t)img * hw * 3;
      const float* mk = masks + (int64_t)img * hw * 4;
      for (int j = 0; j < r; j++) {
        int64_t p = table[rng.bounded(table.size())];
        size_t o = (size_t)i * r + j;
        b->flat_pixels[o] = p;
        std::memcpy(&b->rgb[o * 3], im + p * 3, 3 * sizeof(float));
        std::memcpy(&b->mask[o * 4], mk + p * 4, 4 * sizeof(float));
      }
    }
  }

  // Sky rays: uniform over (image, sky pixel) pairs.
  void fill_sky(int n, int32_t* image_rows, int64_t* flat_pixels) {
    for (int i = 0; i < n; i++) {
      int img = (int)rng.bounded(num_images);
      const auto& table = sky_idx[img];
      image_rows[i] = img;
      flat_pixels[i] = table.empty() ? 0 : table[rng.bounded(table.size())];
    }
  }

  void prefetch_loop() {
    while (!stop.load()) {
      Batch* b = new Batch();
      fill_batch(b, pf_u, pf_r);
      b->sky_rows.resize(pf_sky);
      b->sky_pixels.resize(pf_sky);
      fill_sky(pf_sky, b->sky_rows.data(), b->sky_pixels.data());
      std::unique_lock<std::mutex> lk(mu);
      cv_full.wait(lk, [&] { return (int)ready.size() < queue_depth || stop.load(); });
      if (stop.load()) {
        delete b;
        return;
      }
      ready.push(b);
      cv_empty.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* sampler_create(const float* images, const float* masks, int num_images,
                     int height, int width, uint64_t seed) {
  auto* s = new Sampler(seed);
  s->images = images;
  s->masks = masks;
  s->num_images = num_images;
  s->height = height;
  s->width = width;
  s->build_tables();
  return s;
}

void sampler_destroy(void* handle) { delete static_cast<Sampler*>(handle); }

int sampler_has_sky(void* handle) {
  return static_cast<Sampler*>(handle)->has_sky ? 1 : 0;
}

// Synchronous draw: fills caller buffers.
void sampler_sample_batch(void* handle, int u, int r, int32_t* image_rows,
                          int64_t* flat_pixels, float* rgb, float* mask) {
  auto* s = static_cast<Sampler*>(handle);
  Batch b;
  s->fill_batch(&b, u, r);
  std::memcpy(image_rows, b.image_rows.data(), u * sizeof(int32_t));
  std::memcpy(flat_pixels, b.flat_pixels.data(), (size_t)u * r * sizeof(int64_t));
  std::memcpy(rgb, b.rgb.data(), (size_t)u * r * 3 * sizeof(float));
  std::memcpy(mask, b.mask.data(), (size_t)u * r * 4 * sizeof(float));
}

// Sky rays: uniform over (image, sky pixel) pairs.
void sampler_sample_sky(void* handle, int n, int32_t* image_rows,
                        int64_t* flat_pixels) {
  static_cast<Sampler*>(handle)->fill_sky(n, image_rows, flat_pixels);
}

// Background prefetching into a ring buffer: each batch of u x r rays and
// then its n_sky sky rays.
void sampler_start_prefetch(void* handle, int u, int r, int n_sky,
                            int queue_depth) {
  auto* s = static_cast<Sampler*>(handle);
  s->pf_u = u;
  s->pf_r = r;
  s->pf_sky = n_sky;
  s->queue_depth = queue_depth;
  s->worker = std::thread([s] { s->prefetch_loop(); });
}

// Pop one prefetched batch and its sky rays (blocks until available).
void sampler_next_batch(void* handle, int32_t* image_rows, int64_t* flat_pixels,
                        float* rgb, float* mask, int32_t* sky_rows,
                        int64_t* sky_pixels) {
  auto* s = static_cast<Sampler*>(handle);
  Batch* b = nullptr;
  {
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv_empty.wait(lk, [&] { return !s->ready.empty() || s->stop.load(); });
    if (s->ready.empty()) return;
    b = s->ready.front();
    s->ready.pop();
    s->cv_full.notify_one();
  }
  int u = s->pf_u, r = s->pf_r;
  std::memcpy(image_rows, b->image_rows.data(), u * sizeof(int32_t));
  std::memcpy(flat_pixels, b->flat_pixels.data(), (size_t)u * r * sizeof(int64_t));
  std::memcpy(rgb, b->rgb.data(), (size_t)u * r * 3 * sizeof(float));
  std::memcpy(mask, b->mask.data(), (size_t)u * r * 4 * sizeof(float));
  if (!b->sky_rows.empty()) {
    std::memcpy(sky_rows, b->sky_rows.data(), b->sky_rows.size() * sizeof(int32_t));
    std::memcpy(sky_pixels, b->sky_pixels.data(), b->sky_pixels.size() * sizeof(int64_t));
  }
  delete b;
}

}  // extern "C"
