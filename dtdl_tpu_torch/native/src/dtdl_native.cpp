// dtdl_tpu_torch native runtime: threaded batch pipeline, IDX(.gz) IO,
// topology.  The port's own copy of dtdl_tpu/native/src/dtdl_native.cpp:
// the same C ABI and the same determinism contract.
//
// The reference delegates its host-side runtime to framework internals:
// torch DataLoader worker processes (reference pytorch/single_gpu.py:60-61,
// num_workers=4), Chainer iterators, and TF's C++ input pipeline.  This is
// the framework's own native equivalent: a C++ producer/consumer batch
// pipeline (shuffle, augment, normalize off the Python thread so the
// card's step loop never waits on the GIL), a zlib IDX reader replacing the
// reference's byte-by-byte Python parse (reference chainer/mnist_helper.py:
// 24-27), and a host topology probe for the launchers.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// Determinism contract: batch content depends only on (seed, epoch,
// batch_index) — never on thread scheduling.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <unistd.h>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// deterministic RNG (splitmix64 + xorshift) — stable across platforms
// ---------------------------------------------------------------------------

static inline uint64_t splitmix64(uint64_t& x) {
  x += 0x9E3779B97f4A7C15ULL;
  uint64_t z = x;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed) {}
  uint64_t next() { return splitmix64(s); }
  // unbiased bounded draw (Lemire)
  uint64_t below(uint64_t n) {
    if (n == 0) return 0;
    return next() % n;  // modulo bias negligible for n << 2^64
  }
  float uniform() { return (next() >> 40) * (1.0f / (1ULL << 24)); }
};

// ---------------------------------------------------------------------------
// batch pipeline
// ---------------------------------------------------------------------------

enum Flags {
  DTDL_SHUFFLE = 1,
  DTDL_AUGMENT_CROP_FLIP = 2,  // pad-4 random crop + horizontal flip (NHWC)
  DTDL_NORMALIZE = 4,          // per-channel (x - mean) / std
};

struct Batch {
  std::vector<float> images;
  std::vector<int32_t> labels;
  int64_t index = -1;
  bool ready = false;
};

struct Loader {
  // dataset (borrowed pointers; Python keeps the arrays alive)
  const float* images;
  const int32_t* labels;
  int64_t n;
  int h, w, c, batch;
  int flags;
  uint64_t seed;
  float mean[16], std[16];

  // epoch state
  std::vector<int64_t> perm;
  int64_t n_batches = 0;
  int epoch = -1;

  // pipeline
  int depth;
  int n_threads;
  std::vector<Batch> slots;
  std::atomic<int64_t> next_build{0};   // next batch index to build
  int64_t next_emit = 0;                // next batch index to hand out
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  int64_t per_image() const { return (int64_t)h * w * c; }
};

static void build_batch(Loader* L, int64_t bi, Batch* out) {
  const int64_t px = L->per_image();
  out->images.resize((size_t)L->batch * px);
  out->labels.resize(L->batch);
  // per-batch deterministic RNG: content independent of thread schedule
  uint64_t s = L->seed * 0x9E3779B97f4A7C15ULL + (uint64_t)L->epoch * 0x100000001B3ULL +
               (uint64_t)bi + 0x51ED2701;
  Rng rng(s);
  const bool aug = L->flags & DTDL_AUGMENT_CROP_FLIP;
  const bool norm = L->flags & DTDL_NORMALIZE;
  for (int i = 0; i < L->batch; ++i) {
    int64_t src = L->perm[bi * L->batch + i];
    out->labels[i] = L->labels[src];
    const float* im = L->images + src * px;
    float* dst = out->images.data() + (int64_t)i * px;
    if (!aug) {
      std::memcpy(dst, im, px * sizeof(float));
    } else {
      // pad-4 random crop + hflip, matching the torchvision stack the
      // reference applies (RandomCrop(32,4) + RandomHorizontalFlip)
      int dy = (int)rng.below(9) - 4;  // crop offset into padded image
      int dx = (int)rng.below(9) - 4;
      bool flip = rng.uniform() < 0.5f;
      for (int y = 0; y < L->h; ++y) {
        int sy = y + dy;
        for (int x = 0; x < L->w; ++x) {
          int sx = x + dx;
          int tx = flip ? (L->w - 1 - x) : x;
          float* o = dst + ((int64_t)y * L->w + tx) * L->c;
          if (sy < 0 || sy >= L->h || sx < 0 || sx >= L->w) {
            for (int ch = 0; ch < L->c; ++ch) o[ch] = 0.0f;
          } else {
            const float* p = im + ((int64_t)sy * L->w + sx) * L->c;
            for (int ch = 0; ch < L->c; ++ch) o[ch] = p[ch];
          }
        }
      }
    }
    if (norm) {
      for (int64_t j = 0; j < px; ++j)
        dst[j] = (dst[j] - L->mean[j % L->c]) / L->std[j % L->c];
    }
  }
  out->index = bi;
}

static void worker_loop(Loader* L) {
  while (!L->stop.load()) {
    int64_t bi = L->next_build.fetch_add(1);
    if (bi >= L->n_batches) return;
    int slot = (int)(bi % L->depth);
    Batch* B = &L->slots[slot];
    {
      // wait until the consumer has drained this slot's previous occupant
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_free.wait(lk, [&] {
        return L->stop.load() || (!B->ready && L->next_emit + L->depth > bi);
      });
      if (L->stop.load()) return;
    }
    build_batch(L, bi, B);
    {
      std::lock_guard<std::mutex> lk(L->mu);
      B->ready = true;
    }
    L->cv_ready.notify_all();
  }
}

void* dtdl_loader_create(const float* images, const int32_t* labels,
                         int64_t n, int h, int w, int c, int batch,
                         int depth, int n_threads, int flags, uint64_t seed,
                         const float* mean, const float* stdv) {
  if (!images || !labels || n <= 0 || batch <= 0 || c > 16) return nullptr;
  Loader* L = new Loader();
  L->images = images; L->labels = labels; L->n = n;
  L->h = h; L->w = w; L->c = c; L->batch = batch;
  L->flags = flags; L->seed = seed;
  L->depth = depth > 0 ? depth : 4;
  L->n_threads = n_threads > 0 ? n_threads : 4;
  for (int i = 0; i < c; ++i) {
    L->mean[i] = mean ? mean[i] : 0.0f;
    L->std[i] = stdv ? stdv[i] : 1.0f;
  }
  L->slots.resize(L->depth);
  return L;
}

static void join_workers(Loader* L) {
  L->stop.store(true);
  L->cv_free.notify_all();
  for (auto& t : L->workers) t.join();
  L->workers.clear();
  L->stop.store(false);
}

static void begin_epoch(Loader* L, int epoch, int64_t n_indices) {
  L->epoch = epoch;
  L->n_batches = n_indices / L->batch;  // drop_last semantics
  L->next_build.store(0);
  L->next_emit = 0;
  for (auto& B : L->slots) { B.ready = false; B.index = -1; }
  for (int i = 0; i < L->n_threads; ++i)
    L->workers.emplace_back(worker_loop, L);
}

void dtdl_loader_start_epoch(void* h, int epoch) {
  Loader* L = (Loader*)h;
  join_workers(L);
  L->perm.resize(L->n);
  for (int64_t i = 0; i < L->n; ++i) L->perm[i] = i;
  if (L->flags & DTDL_SHUFFLE) {
    Rng rng(L->seed * 0xD1B54A32D192ED03ULL + (uint64_t)epoch + 1);
    for (int64_t i = L->n - 1; i > 0; --i) {  // Fisher-Yates
      int64_t j = (int64_t)rng.below((uint64_t)i + 1);
      std::swap(L->perm[i], L->perm[j]);
    }
  }
  begin_epoch(L, epoch, L->n);
}

// Start an epoch over caller-provided sample indices (e.g. a sharded
// sampler's per-epoch stripe of a globally reshuffled permutation —
// DistributedSampler parity in multi-host runs).  Indices are copied;
// values must lie in [0, n).  Returns 0, or -1 on invalid input.
int dtdl_loader_start_epoch_indices(void* h, int epoch,
                                    const int64_t* indices, int64_t count) {
  Loader* L = (Loader*)h;
  if (!indices || count <= 0) return -1;
  for (int64_t i = 0; i < count; ++i)
    if (indices[i] < 0 || indices[i] >= L->n) return -1;
  join_workers(L);
  L->perm.assign(indices, indices + count);
  begin_epoch(L, epoch, count);
  return 0;
}

// returns 1 and fills outputs, or 0 at end of epoch
int dtdl_loader_next(void* h, float* out_images, int32_t* out_labels) {
  Loader* L = (Loader*)h;
  if (L->next_emit >= L->n_batches) return 0;
  int slot = (int)(L->next_emit % L->depth);
  Batch* B = &L->slots[slot];
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [&] { return B->ready && B->index == L->next_emit; });
  }
  std::memcpy(out_images, B->images.data(), B->images.size() * sizeof(float));
  std::memcpy(out_labels, B->labels.data(), B->labels.size() * sizeof(int32_t));
  {
    std::lock_guard<std::mutex> lk(L->mu);
    B->ready = false;
    L->next_emit++;
  }
  L->cv_free.notify_all();
  return 1;
}

int64_t dtdl_loader_n_batches(void* h) { return ((Loader*)h)->n_batches; }

void dtdl_loader_destroy(void* h) {
  Loader* L = (Loader*)h;
  L->stop.store(true);
  L->cv_free.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

// ---------------------------------------------------------------------------
// IDX(.gz) reader (zlib) — native replacement for the byte-loop parse
// ---------------------------------------------------------------------------

static std::vector<uint8_t> read_file_maybe_gz(const char* path, bool gz) {
  std::vector<uint8_t> out;
  if (gz) {
    gzFile f = gzopen(path, "rb");
    if (!f) return out;
    uint8_t buf[1 << 16];
    int got;
    while ((got = gzread(f, buf, sizeof(buf))) > 0)
      out.insert(out.end(), buf, buf + got);
    gzclose(f);
  } else {
    FILE* f = fopen(path, "rb");
    if (!f) return out;
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    out.resize(sz);
    if (fread(out.data(), 1, sz, f) != (size_t)sz) out.clear();
    fclose(f);
  }
  return out;
}

static inline uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

// Parse header: returns ndim (<=4) and fills dims; -1 on error.
int dtdl_idx_header(const char* path, int is_gz, int64_t* dims) {
  auto buf = read_file_maybe_gz(path, is_gz != 0);
  if (buf.size() < 4 || buf[0] != 0 || buf[1] != 0 || buf[2] != 0x08)
    return -1;  // only u8 payloads (MNIST) handled natively
  int ndim = buf[3];
  if (ndim < 1 || ndim > 4 || buf.size() < 4 + 4 * (size_t)ndim) return -1;
  for (int i = 0; i < ndim; ++i) dims[i] = be32(buf.data() + 4 + 4 * i);
  return ndim;
}

// Read payload as float32 scaled by 1/255 (images) into out (caller-sized).
int dtdl_idx_read_f32(const char* path, int is_gz, float* out, int64_t count,
                      float scale) {
  auto buf = read_file_maybe_gz(path, is_gz != 0);
  if (buf.size() < 4) return -1;
  int ndim = buf[3];
  size_t off = 4 + 4 * (size_t)ndim;
  if (buf.size() - off < (size_t)count) return -1;
  const uint8_t* p = buf.data() + off;
  for (int64_t i = 0; i < count; ++i) out[i] = p[i] * scale;
  return 0;
}

int dtdl_idx_read_i32(const char* path, int is_gz, int32_t* out,
                      int64_t count) {
  auto buf = read_file_maybe_gz(path, is_gz != 0);
  if (buf.size() < 4) return -1;
  int ndim = buf[3];
  size_t off = 4 + 4 * (size_t)ndim;
  if (buf.size() - off < (size_t)count) return -1;
  const uint8_t* p = buf.data() + off;
  for (int64_t i = 0; i < count; ++i) out[i] = p[i];
  return 0;
}

// ---------------------------------------------------------------------------
// host topology probe (for the slice launcher / runtime bootstrap)
// ---------------------------------------------------------------------------

int dtdl_topology(char* out, int cap) {
  long cpus = sysconf(_SC_NPROCESSORS_ONLN);
  long pages = sysconf(_SC_PHYS_PAGES);
  long page_sz = sysconf(_SC_PAGE_SIZE);
  char host[256] = {0};
  gethostname(host, sizeof(host) - 1);
  double mem_gb = (double)pages * page_sz / (1024.0 * 1024.0 * 1024.0);
  int n = snprintf(out, cap,
                   "{\"host\":\"%s\",\"cpus\":%ld,\"mem_gb\":%.1f}",
                   host, cpus, mem_gb);
  return (n > 0 && n < cap) ? n : -1;
}

}  // extern "C"
