// Native RecordIO + prefetching batch reader + pooled host allocator.
//
// TPU-native equivalents of the reference's native data path:
//  - RecordIO framing      (ref src/io/image_recordio.h, dmlc recordio):
//    [kMagic u32][lrec u32][payload][pad to 4]; lrec = cflag<<29 | len.
//  - Threaded batch reader (ref src/io/iter_image_recordio_2.cc +
//    iter_prefetcher.h): worker threads read record payloads ahead of the
//    consumer through a bounded double-buffered queue; no GIL involvement.
//  - Pooled host allocator (ref src/storage/pooled_storage_manager.h):
//    size-bucketed free lists for staging buffers.
//
// Exposed as a flat C ABI consumed via ctypes (python/native/lib.py).
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

static const uint32_t kMagic = 0xced7230a;

extern "C" {

// ---------------------------------------------------------------- framing
struct RioWriter {
  FILE* f;
};

void* rio_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new RioWriter{f};
  return w;
}

long rio_writer_tell(void* h) { return ftell(static_cast<RioWriter*>(h)->f); }

int rio_write(void* h, const char* buf, uint32_t len) {
  FILE* f = static_cast<RioWriter*>(h)->f;
  uint32_t lrec = len;  // cflag 0
  if (fwrite(&kMagic, 4, 1, f) != 1) return -1;
  if (fwrite(&lrec, 4, 1, f) != 1) return -1;
  if (len && fwrite(buf, 1, len, f) != len) return -1;
  uint32_t pad = (4 - (len & 3)) & 3;
  static const char zeros[4] = {0, 0, 0, 0};
  if (pad && fwrite(zeros, 1, pad, f) != pad) return -1;
  return 0;
}

void rio_writer_close(void* h) {
  auto* w = static_cast<RioWriter*>(h);
  fclose(w->f);
  delete w;
}

// Scan a record file, returning the number of records; offsets/lengths are
// written into caller-provided arrays when non-null (call twice: count, fill).
long rio_scan(const char* path, int64_t* offsets, int64_t* lengths, long cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  long n = 0;
  while (true) {
    long pos = ftell(f);
    uint32_t magic, lrec;
    if (fread(&magic, 4, 1, f) != 1) break;
    if (magic != kMagic) { n = -2; break; }
    if (fread(&lrec, 4, 1, f) != 1) { n = -2; break; }
    uint32_t len = lrec & ((1u << 29) - 1);
    if (offsets && n < cap) offsets[n] = pos;
    if (lengths && n < cap) lengths[n] = len;
    uint32_t pad = (4 - (len & 3)) & 3;
    if (fseek(f, len + pad, SEEK_CUR) != 0) { n = -2; break; }
    n++;
  }
  fclose(f);
  return n;
}

// ---------------------------------------------------------------- allocator
// Size-bucketed pooled allocator (power-of-two rounding like
// GPUPooledRoundedStorageManager, pooled_storage_manager.h:210).
struct HostPool {
  std::mutex mu;
  std::map<size_t, std::vector<void*>> free_list;
  std::atomic<size_t> used{0};
};

static size_t round_pow2(size_t n) {
  size_t p = 4096;
  while (p < n) p <<= 1;
  return p;
}

void* pool_create() { return new HostPool(); }

void* pool_alloc(void* h, size_t size) {
  auto* p = static_cast<HostPool*>(h);
  size_t bucket = round_pow2(size);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    auto it = p->free_list.find(bucket);
    if (it != p->free_list.end() && !it->second.empty()) {
      void* buf = it->second.back();
      it->second.pop_back();
      return buf;
    }
  }
  p->used += bucket;
  return malloc(bucket);
}

void pool_free(void* h, void* buf, size_t size) {
  auto* p = static_cast<HostPool*>(h);
  size_t bucket = round_pow2(size);
  std::lock_guard<std::mutex> lk(p->mu);
  p->free_list[bucket].push_back(buf);
}

size_t pool_used_bytes(void* h) { return static_cast<HostPool*>(h)->used.load(); }

void pool_destroy(void* h) {
  auto* p = static_cast<HostPool*>(h);
  for (auto& kv : p->free_list)
    for (void* b : kv.second) free(b);
  delete p;
}

// ---------------------------------------------------------------- batch reader
// Prefetching batch reader: N worker threads pull batch indices from a work
// queue, read the payloads, and push assembled batches into a bounded ready
// queue (double-buffered handoff, ref iter_prefetcher.h:47).
struct Batch {
  std::vector<char> data;           // concatenated payloads
  std::vector<int64_t> sizes;       // per-record payload size
  long seq;                          // batch sequence number for ordering
};

struct BatchReader {
  std::string path;
  std::vector<int64_t> offsets, lengths;
  std::vector<long> order;
  long batch_size;
  long cursor = 0;              // next batch seq to hand out to workers
  long n_batches;
  bool shuffle;
  std::mt19937 rng;
  int epoch_seed;

  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::map<long, Batch*> ready;   // seq -> batch
  long next_consume = 0;
  long next_produce = 0;
  long epoch = 0;  // bumped by reset(); stale in-flight batches are discarded
  long max_ready;
  bool stop = false;
  std::vector<std::thread> workers;

  ~BatchReader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_ready.notify_all();
    cv_space.notify_all();
    for (auto& t : workers) t.join();
    for (auto& kv : ready) delete kv.second;
  }
};

static void reader_worker(BatchReader* r) {
  FILE* f = fopen(r->path.c_str(), "rb");
  if (!f) return;
  std::vector<long> idxs;
  while (true) {
    long seq, epoch;
    {
      std::unique_lock<std::mutex> lk(r->mu);
      r->cv_space.wait(lk, [&] {
        return r->stop ||
               (r->next_produce < r->n_batches &&
                (long)r->ready.size() < r->max_ready + 1);
      });
      if (r->stop) break;
      // predicate guarantees next_produce < n_batches here; workers persist
      // across epochs (reset() rewinds next_produce and re-notifies)
      seq = r->next_produce++;
      epoch = r->epoch;
      // snapshot record indices under the lock: reset() may reshuffle
      // r->order concurrently with the reads below
      idxs.resize(r->batch_size);
      long n = (long)r->order.size();
      for (long j = 0; j < r->batch_size; ++j)
        idxs[j] = r->order[(seq * r->batch_size + j) % n];
    }
    auto* b = new Batch();
    b->seq = seq;
    for (long j = 0; j < r->batch_size; ++j) {
      long idx = idxs[j];
      int64_t len = r->lengths[idx];
      size_t off = b->data.size();
      b->data.resize(off + len);
      fseek(f, r->offsets[idx] + 8, SEEK_SET);  // skip magic+lrec
      if (fread(b->data.data() + off, 1, len, f) != (size_t)len) {
        // Truncated/failed record: shrink the data region back so offsets
        // stay aligned with sizes, and surface the error as size -1 so the
        // consumer raises instead of training on an empty payload.
        b->data.resize(off);
        b->sizes.push_back(-1);
        continue;
      }
      b->sizes.push_back(len);
    }
    {
      std::lock_guard<std::mutex> lk(r->mu);
      if (epoch == r->epoch) {
        r->ready[seq] = b;
      } else {
        delete b;  // produced for a pre-reset epoch; discard
        b = nullptr;
      }
    }
    r->cv_ready.notify_all();
  }
  fclose(f);
}

void* rio_reader_create(const char* path, long batch_size, int shuffle,
                        int seed, int num_threads, long max_ready,
                        long part_index, long num_parts) {
  auto* r = new BatchReader();
  r->path = path;
  long n = rio_scan(path, nullptr, nullptr, 0);
  if (n <= 0) {
    delete r;
    return nullptr;
  }
  r->offsets.resize(n);
  r->lengths.resize(n);
  rio_scan(path, r->offsets.data(), r->lengths.data(), n);
  long shard = n / num_parts;
  long lo = part_index * shard;
  long hi = (part_index == num_parts - 1) ? n : lo + shard;
  for (long i = lo; i < hi; ++i) r->order.push_back(i);
  r->batch_size = batch_size;
  r->shuffle = shuffle != 0;
  r->rng.seed(seed);
  if (r->shuffle) std::shuffle(r->order.begin(), r->order.end(), r->rng);
  r->n_batches = (long)(r->order.size() + batch_size - 1) / batch_size;
  r->max_ready = max_ready > 0 ? max_ready : 2;
  for (int i = 0; i < (num_threads > 0 ? num_threads : 2); ++i)
    r->workers.emplace_back(reader_worker, r);
  return r;
}

long rio_reader_num_batches(void* h) {
  return static_cast<BatchReader*>(h)->n_batches;
}

long rio_reader_num_records(void* h) {
  return (long)static_cast<BatchReader*>(h)->order.size();
}

// Blocks for the next in-order batch. Returns total bytes (payloads are
// copied into out_buf up to cap); sizes into out_sizes (batch_size entries).
// Returns -1 at end of epoch. If total > cap the batch is NOT consumed:
// it stays queued so the caller can grow its buffer and retry the SAME
// batch (no silent data loss on oversized batches).
long rio_reader_next(void* h, char* out_buf, long cap, int64_t* out_sizes) {
  auto* r = static_cast<BatchReader*>(h);
  Batch* b = nullptr;
  {
    std::unique_lock<std::mutex> lk(r->mu);
    if (r->next_consume >= r->n_batches) return -1;
    long want = r->next_consume;
    r->cv_ready.wait(lk, [&] { return r->stop || r->ready.count(want); });
    if (r->stop) return -1;
    b = r->ready[want];
    long total = (long)b->data.size();
    if (total > cap) return total;  // keep queued; caller retries with bigger buf
    r->ready.erase(want);
    r->next_consume++;
  }
  r->cv_space.notify_all();
  long total = (long)b->data.size();
  memcpy(out_buf, b->data.data(), total);
  for (size_t i = 0; i < b->sizes.size(); ++i) out_sizes[i] = b->sizes[i];
  delete b;
  return total;
}

void rio_reader_reset(void* h, int reshuffle) {
  auto* r = static_cast<BatchReader*>(h);
  {
    std::lock_guard<std::mutex> lk(r->mu);
    for (auto& kv : r->ready) delete kv.second;
    r->ready.clear();
    r->next_consume = 0;
    r->next_produce = 0;
    r->epoch++;  // in-flight worker batches from the old epoch get discarded
    if (reshuffle && r->shuffle)
      std::shuffle(r->order.begin(), r->order.end(), r->rng);
  }
  r->cv_space.notify_all();
}

void rio_reader_destroy(void* h) { delete static_cast<BatchReader*>(h); }

int mxtpu_native_abi_version() { return 1; }

}  // extern "C"
