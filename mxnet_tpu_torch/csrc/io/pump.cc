/*
 * pump.cc — native double-buffered batch producer.
 *
 * Role parity: reference `src/io/iter_prefetcher.h` (double-buffer
 * prefetch) + the threaded batch loader `src/io/iter_batchloader.h`. One
 * producer thread assembles batches (OpenMP fan-out inside
 * mxtpu_assemble_batch) into a bounded queue; the Python consumer pops
 * fully-built float32 NCHW buffers — host decode overlaps device compute
 * without touching the GIL.
 *
 * This copy differs from the reference's src/io/pump.cc in one place:
 * mxtpu_pump_reset waits until the producer has dropped its queue, and
 * the producer then starts the epoch after the last one the consumer took
 * a batch from. The reference's reset returns at once, so a next() right
 * after it may serve a batch of the abandoned epoch, and the epoch that
 * follows depends on how far ahead the producer had run.
 */
#include "mxtpu.h"

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstring>
#include <mutex>
#include <numeric>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Batch {
  std::vector<uint8_t> data;  /* float32 NCHW bytes, or uint8 NHWC */
  std::vector<float> labels;
  bool epoch_end = false;
  uint64_t epoch = 0;         /* the epoch the batch (or sentinel) ends */
};

struct Pump {
  std::vector<uint8_t> blob;
  std::vector<int64_t> offsets, lengths;
  std::vector<int64_t> order;
  int batch = 0, c = 0, h = 0, w = 0, resize = 0, u8 = 0;
  float mean[3] = {0, 0, 0}, stdv[3] = {1, 1, 1};
  bool has_mean = false, has_std = false;
  int aug_flags = 0, shuffle = 0, depth = 2;
  uint64_t seed = 0;
  uint64_t epoch = 0;
  /* the epoch of the last batch or sentinel next() handed out, + 1 (0:
   * none yet): a reset starts the epoch after it */
  uint64_t served = 0;

  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::queue<Batch> queue;
  std::atomic<bool> stop{false};
  std::atomic<bool> restart{false};
  std::string error;

  int64_t batches_per_epoch() const {
    return static_cast<int64_t>(offsets.size()) / batch;
  }

  void run() {
    while (!stop.load()) {
      /* one epoch */
      std::vector<int64_t> ord(offsets.size());
      std::iota(ord.begin(), ord.end(), 0);
      if (shuffle) {
        std::mt19937_64 rng(seed + epoch);
        std::shuffle(ord.begin(), ord.end(), rng);
      }
      int64_t nb = batches_per_epoch();
      for (int64_t b = 0; b < nb && !stop.load() && !restart.load(); ++b) {
        Batch out;
        out.epoch = epoch;
        out.data.resize(static_cast<size_t>(batch) * c * h * w *
                        (u8 ? 1 : sizeof(float)));
        out.labels.resize(batch);
        std::vector<int64_t> offs(batch), lens(batch);
        for (int i = 0; i < batch; ++i) {
          int64_t j = ord[b * batch + i];
          offs[i] = offsets[j];
          lens[i] = lengths[j];
        }
        /* aug_flags packing: bits 0-7 = crop/mirror flags, 8-15 =
         * random_h, 16-23 = random_s, 24-31 = random_l (HLS jitter,
         * image_aug_default.cc) — keeps the pump ABI stable */
        int flags = aug_flags & 0xff;
        int rh = (aug_flags >> 8) & 0xff;
        int rs = (aug_flags >> 16) & 0xff;
        int rl = (aug_flags >> 24) & 0xff;
        int r = u8
            ? mxtpu_assemble_batch_u8_aug(
                  blob.data(), offs.data(), lens.data(), batch, c, h, w,
                  resize, flags, seed + epoch * 1315423911ull + b,
                  rh, rs, rl, out.data.data(), out.labels.data())
            : mxtpu_assemble_batch_aug(
                  blob.data(), offs.data(), lens.data(), batch, c, h, w,
                  resize,
                  has_mean ? mean : nullptr, has_std ? stdv : nullptr,
                  flags, seed + epoch * 1315423911ull + b, rh, rs, rl,
                  reinterpret_cast<float *>(out.data.data()),
                  out.labels.data());
        if (r != 0) {
          std::lock_guard<std::mutex> lk(mu);
          error = "batch assembly failed";
          stop.store(true);
          cv_get.notify_all();
          return;
        }
        std::unique_lock<std::mutex> lk(mu);
        cv_put.wait(lk, [&] {
          return queue.size() < static_cast<size_t>(depth) || stop.load() ||
                 restart.load();
        });
        if (stop.load() || restart.load()) break;
        queue.push(std::move(out));
        cv_get.notify_one();
      }
      if (!stop.load() && !restart.load()) {
        Batch sentinel;
        sentinel.epoch_end = true;
        sentinel.epoch = epoch;
        std::unique_lock<std::mutex> lk(mu);
        cv_put.wait(lk, [&] {
          return queue.size() < static_cast<size_t>(depth) || stop.load() ||
                 restart.load();
        });
        if (!stop.load() && !restart.load()) {
          queue.push(std::move(sentinel));
          cv_get.notify_one();
        }
      }
      if (restart.load()) {
        /* cleared under the lock, then acknowledged: mxtpu_pump_reset
         * waits for it, so that no batch of an abandoned epoch is served
         * after a reset, and the next epoch is the one after the last
         * the consumer took from, however far ahead this thread ran */
        std::lock_guard<std::mutex> lk(mu);
        std::queue<Batch>().swap(queue);
        epoch = served;
        restart.store(false);
        cv_get.notify_all();
        continue;
      }
      ++epoch;
    }
  }
};

}  // namespace

extern "C" {

mxtpu_pump_handle mxtpu_pump_create(const char *path, int batch_size, int c,
                                    int h, int w, int resize, int u8_mode,
                                    const float *mean,
                                    const float *std_, int aug_flags,
                                    int shuffle, uint64_t seed, int depth) {
  auto *p = new Pump();
  int64_t n = mxtpu_recordio_count(path);
  if (n <= 0) {
    delete p;
    return nullptr;
  }
  p->offsets.resize(n);
  p->lengths.resize(n);
  if (mxtpu_recordio_scan(path, p->offsets.data(), p->lengths.data(), n) < 0) {
    delete p;
    return nullptr;
  }
  /* load the blob once; records decoded from memory (reference keeps
   * chunked IO — record files here are assumed host-RAM sized) */
  FILE *f = std::fopen(path, "rb");
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  p->blob.resize(sz);
  if (std::fread(p->blob.data(), 1, sz, f) != static_cast<size_t>(sz)) {
    std::fclose(f);
    delete p;
    return nullptr;
  }
  std::fclose(f);
  p->batch = batch_size;
  p->c = c;
  p->h = h;
  p->w = w;
  p->resize = resize;
  p->u8 = u8_mode;
  if (mean) {
    std::memcpy(p->mean, mean, 3 * sizeof(float));
    p->has_mean = true;
  }
  if (std_) {
    std::memcpy(p->stdv, std_, 3 * sizeof(float));
    p->has_std = true;
  }
  p->aug_flags = aug_flags;
  p->shuffle = shuffle;
  p->seed = seed;
  p->depth = depth > 0 ? depth : 2;
  p->worker = std::thread([p] { p->run(); });
  return p;
}

int mxtpu_pump_next(mxtpu_pump_handle h, void *out_data, float *out_labels) {
  auto *p = static_cast<Pump *>(h);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_get.wait(lk, [&] { return !p->queue.empty() || p->stop.load(); });
  if (p->queue.empty()) return -1;
  Batch b = std::move(p->queue.front());
  p->queue.pop();
  p->served = b.epoch + 1;
  p->cv_put.notify_one();
  if (b.epoch_end) return 1;
  std::memcpy(out_data, b.data.data(), b.data.size());
  std::memcpy(out_labels, b.labels.data(), b.labels.size() * sizeof(float));
  return 0;
}

int mxtpu_pump_reset(mxtpu_pump_handle h) {
  auto *p = static_cast<Pump *>(h);
  std::unique_lock<std::mutex> lk(p->mu);
  p->restart.store(true);
  p->cv_put.notify_all();
  /* until the producer has dropped what it queued: without the wait a
   * next() right after the reset could pop a batch of the old epoch */
  p->cv_get.wait(lk, [&] { return !p->restart.load() || p->stop.load(); });
  return 0;
}

int mxtpu_pump_batches_per_epoch(mxtpu_pump_handle h) {
  return static_cast<int>(static_cast<Pump *>(h)->batches_per_epoch());
}

void mxtpu_pump_destroy(mxtpu_pump_handle h) {
  auto *p = static_cast<Pump *>(h);
  p->stop.store(true);
  p->cv_put.notify_all();
  p->cv_get.notify_all();
  if (p->worker.joinable()) p->worker.join();
  delete p;
}

}  /* extern "C" */
