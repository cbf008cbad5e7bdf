// Native image pipeline: JPEG decode + augmentation + batch assembly in C++
// worker threads — the TPU-native equivalent of the reference's OpenMP decode
// team (ref src/io/iter_image_recordio_2.cc:51 ImageRecordIOParser2 and
// image_aug_default.cc DefaultImageAugmenter): no Python/GIL in the decode
// loop. Batches are assembled as NCHW float32 host tensors ready for a
// single device_put.
//
// Record payload layout is dmlc image-recordio (ref src/io/image_recordio.h):
//   uint32 flag; float label; uint64 id; uint64 id2;   (24-byte IRHeader)
//   [flag > 0: flag x float extra labels]
//   JPEG bytes.
#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>

extern "C" long rio_scan(const char* path, int64_t* offsets, int64_t* lengths,
                         long cap);

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Decode JPEG bytes to tightly-packed RGB8. Returns false on corrupt input.
bool decode_jpeg(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                 int* w, int* h, int min_side_hint) {
  if (len < 2 || buf[0] != 0xFF || buf[1] != 0xD8) return false;  // not JPEG
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  // DCT-domain downscale: pick the largest 1/1..1/8 factor that keeps the
  // short side >= the target (fast path of the reference's resize augmenter)
  if (min_side_hint > 0) {
    int short_side = std::min((int)cinfo.image_width, (int)cinfo.image_height);
    int denom = 1;
    while (denom < 8 && short_side / (denom * 2) >= min_side_hint) denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize((size_t)(*w) * (*h) * 3);
  std::vector<uint8_t> row((size_t)(*w) * cinfo.output_components);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* dst = out->data() + (size_t)cinfo.output_scanline * (*w) * 3;
    if (cinfo.output_components == 3) {
      JSAMPROW r = dst;
      jpeg_read_scanlines(&cinfo, &r, 1);
    } else {  // grayscale -> replicate
      JSAMPROW r = row.data();
      jpeg_read_scanlines(&cinfo, &r, 1);
      for (int x = 0; x < *w; ++x)
        dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = row[x];
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Bilinear resize RGB8 (ref image_aug_default.cc resize via cv::resize).
void resize_bilinear(const uint8_t* src, int sw, int sh, uint8_t* dst, int dw,
                     int dh) {
  const float fx = (float)sw / dw, fy = (float)sh / dh;
  for (int y = 0; y < dh; ++y) {
    float syf = (y + 0.5f) * fy - 0.5f;
    int sy = (int)std::floor(syf);
    float wy = syf - sy;
    int sy0 = std::max(0, std::min(sy, sh - 1));
    int sy1 = std::max(0, std::min(sy + 1, sh - 1));
    for (int x = 0; x < dw; ++x) {
      float sxf = (x + 0.5f) * fx - 0.5f;
      int sx = (int)std::floor(sxf);
      float wx = sxf - sx;
      int sx0 = std::max(0, std::min(sx, sw - 1));
      int sx1 = std::max(0, std::min(sx + 1, sw - 1));
      for (int c = 0; c < 3; ++c) {
        float v00 = src[(sy0 * sw + sx0) * 3 + c];
        float v01 = src[(sy0 * sw + sx1) * 3 + c];
        float v10 = src[(sy1 * sw + sx0) * 3 + c];
        float v11 = src[(sy1 * sw + sx1) * 3 + c];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[(y * dw + x) * 3 + c] = (uint8_t)(v + 0.5f);
      }
    }
  }
}

struct ImgBatch {
  std::vector<float> data;    // N*C*H*W
  std::vector<float> labels;  // N*label_width
  long seq;
  int bad;                    // count of undecodable records
};

struct ImgPipe {
  std::string path;
  std::vector<int64_t> offsets, lengths;
  std::vector<long> order;
  long batch_size;
  int H, W, label_width;
  int resize_short;           // 0 = resize directly to (H,W)
  int rand_crop, rand_mirror;
  float mean[3], std[3], scale;
  bool shuffle;
  std::mt19937 rng;
  long n_batches;

  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::map<long, ImgBatch*> ready;
  long next_consume = 0, next_produce = 0;
  long epoch = 0;  // bumped by reset(); stale in-flight batches are discarded
  long max_ready;
  bool stop = false;
  std::vector<std::thread> workers;

  ~ImgPipe() {
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

void pipe_worker(ImgPipe* p, unsigned tseed) {
  FILE* f = fopen(p->path.c_str(), "rb");
  if (!f) return;
  std::mt19937 rng(tseed);
  std::vector<uint8_t> raw, rgb, resized;
  std::vector<long> idxs;
  while (true) {
    long seq, epoch;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv_space.wait(lk, [&] {
        return p->stop || (p->next_produce < p->n_batches &&
                           (long)p->ready.size() < p->max_ready + 1);
      });
      if (p->stop) break;
      seq = p->next_produce++;
      epoch = p->epoch;
      // snapshot record indices under the lock: reset() may reshuffle
      // p->order concurrently with decode
      idxs.resize(p->batch_size);
      long n = (long)p->order.size();
      for (long j = 0; j < p->batch_size; ++j)
        idxs[j] = p->order[(seq * p->batch_size + j) % n];
    }
    auto* b = new ImgBatch();
    b->seq = seq;
    b->bad = 0;
    const long plane = (long)p->H * p->W;
    b->data.assign((size_t)p->batch_size * 3 * plane, 0.f);
    b->labels.assign((size_t)p->batch_size * p->label_width, 0.f);
    for (long j = 0; j < p->batch_size; ++j) {
      long idx = idxs[j];
      int64_t len = p->lengths[idx];
      raw.resize(len);
      fseek(f, p->offsets[idx] + 8, SEEK_SET);
      if (fread(raw.data(), 1, len, f) != (size_t)len || len < 24) {
        b->bad++;
        continue;
      }
      uint32_t flag;
      float label;
      memcpy(&flag, raw.data(), 4);
      memcpy(&label, raw.data() + 4, 4);
      size_t off = 24;
      float* lab_dst = b->labels.data() + (size_t)j * p->label_width;
      if (flag == 0) {
        lab_dst[0] = label;
      } else {
        // extra-label section must fit inside the record
        if ((int64_t)(24 + (uint64_t)4 * flag) >= len) {
          b->bad++;
          continue;
        }
        for (uint32_t k = 0; k < flag && k < (uint32_t)p->label_width; ++k)
          memcpy(lab_dst + k, raw.data() + off + 4 * k, 4);
        off += (size_t)4 * flag;
      }
      int w = 0, h = 0;
      int hint = p->resize_short > 0 ? p->resize_short : std::min(p->H, p->W);
      if (!decode_jpeg(raw.data() + off, (size_t)(len - (int64_t)off), &rgb, &w,
                       &h, hint)) {
        b->bad++;
        continue;
      }
      // resize: short side to resize_short (keep aspect); with no resize,
      // rand_crop windows the (possibly DCT-downscaled) source directly,
      // else resize straight to HxW
      int rw, rh;
      if (p->resize_short > 0) {
        if (w < h) {
          rw = p->resize_short;
          rh = (int)((int64_t)h * p->resize_short / w);
        } else {
          rh = p->resize_short;
          rw = (int)((int64_t)w * p->resize_short / h);
        }
      } else if (p->rand_crop && w >= p->W && h >= p->H) {
        rw = w;
        rh = h;
      } else {
        rw = p->W;
        rh = p->H;
      }
      const uint8_t* img;
      if (rw == w && rh == h) {
        img = rgb.data();
      } else {
        resized.resize((size_t)rw * rh * 3);
        resize_bilinear(rgb.data(), w, h, resized.data(), rw, rh);
        img = resized.data();
      }
      // crop to (H, W): random if rand_crop else center
      int cx = std::max(0, (rw - p->W)), cy = std::max(0, (rh - p->H));
      int x0, y0;
      if (p->rand_crop) {
        x0 = cx ? (int)(rng() % (cx + 1)) : 0;
        y0 = cy ? (int)(rng() % (cy + 1)) : 0;
      } else {
        x0 = cx / 2;
        y0 = cy / 2;
      }
      bool mirror = p->rand_mirror && (rng() & 1);
      float* dst = b->data.data() + (size_t)j * 3 * plane;
      for (int y = 0; y < p->H && y + y0 < rh; ++y) {
        for (int x = 0; x < p->W && x + x0 < rw; ++x) {
          int sx = mirror ? (std::min(rw - 1, x0 + p->W - 1) - x) : (x0 + x);
          const uint8_t* px = img + ((size_t)(y0 + y) * rw + sx) * 3;
          for (int c = 0; c < 3; ++c)
            dst[(size_t)c * plane + (size_t)y * p->W + x] =
                (px[c] - p->mean[c]) * p->scale / p->std[c];
        }
      }
    }
    {
      std::lock_guard<std::mutex> lk(p->mu);
      if (epoch == p->epoch) {
        p->ready[seq] = b;
      } else {
        delete b;  // produced for a pre-reset epoch; discard
        b = nullptr;
      }
    }
    p->cv_ready.notify_all();
  }
  fclose(f);
}

}  // namespace

extern "C" {

void* img_pipe_create(const char* path, long batch_size, int h, int w,
                      int label_width, int resize_short, int rand_crop,
                      int rand_mirror, const float* mean_rgb,
                      const float* std_rgb, float scale, int shuffle, int seed,
                      int num_threads, long max_ready, long part_index,
                      long num_parts) {
  auto* p = new ImgPipe();
  p->path = path;
  long n = rio_scan(path, nullptr, nullptr, 0);
  if (n <= 0) {
    delete p;
    return nullptr;
  }
  p->offsets.resize(n);
  p->lengths.resize(n);
  rio_scan(path, p->offsets.data(), p->lengths.data(), n);
  long shard = n / num_parts;
  long lo = part_index * shard;
  long hi = (part_index == num_parts - 1) ? n : lo + shard;
  for (long i = lo; i < hi; ++i) p->order.push_back(i);
  p->batch_size = batch_size;
  p->H = h;
  p->W = w;
  p->label_width = label_width > 0 ? label_width : 1;
  p->resize_short = resize_short;
  p->rand_crop = rand_crop;
  p->rand_mirror = rand_mirror;
  for (int c = 0; c < 3; ++c) {
    p->mean[c] = mean_rgb ? mean_rgb[c] : 0.f;
    p->std[c] = (std_rgb && std_rgb[c] != 0.f) ? std_rgb[c] : 1.f;
  }
  p->scale = scale != 0.f ? scale : 1.f;
  p->shuffle = shuffle != 0;
  p->rng.seed(seed);
  if (p->shuffle) std::shuffle(p->order.begin(), p->order.end(), p->rng);
  p->n_batches = (long)(p->order.size() + batch_size - 1) / batch_size;
  p->max_ready = max_ready > 0 ? max_ready : 4;
  int nt = num_threads > 0 ? num_threads : 4;
  for (int i = 0; i < nt; ++i)
    p->workers.emplace_back(pipe_worker, p, (unsigned)(seed * 9973 + i));
  return p;
}

long img_pipe_num_batches(void* h) {
  return static_cast<ImgPipe*>(h)->n_batches;
}

long img_pipe_num_records(void* h) {
  return (long)static_cast<ImgPipe*>(h)->order.size();
}

// Copies the next batch into out_data (N*3*H*W floats) and out_labels
// (N*label_width floats). Returns #bad (undecodable) records, or -1 at
// epoch end.
long img_pipe_next(void* h, float* out_data, float* out_labels) {
  auto* p = static_cast<ImgPipe*>(h);
  ImgBatch* b = nullptr;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    if (p->next_consume >= p->n_batches) return -1;
    long want = p->next_consume;
    p->cv_ready.wait(lk, [&] { return p->stop || p->ready.count(want); });
    if (p->stop) return -1;
    b = p->ready[want];
    p->ready.erase(want);
    p->next_consume++;
  }
  p->cv_space.notify_all();
  memcpy(out_data, b->data.data(), b->data.size() * sizeof(float));
  memcpy(out_labels, b->labels.data(), b->labels.size() * sizeof(float));
  long bad = b->bad;
  delete b;
  return bad;
}

void img_pipe_reset(void* h, int reshuffle) {
  auto* p = static_cast<ImgPipe*>(h);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    for (auto& kv : p->ready) delete kv.second;
    p->ready.clear();
    p->next_consume = 0;
    p->next_produce = 0;
    p->epoch++;  // in-flight worker batches from the old epoch get discarded
    if (reshuffle && p->shuffle)
      std::shuffle(p->order.begin(), p->order.end(), p->rng);
  }
  p->cv_space.notify_all();
}

void img_pipe_destroy(void* h) { delete static_cast<ImgPipe*>(h); }

}  // extern "C"
