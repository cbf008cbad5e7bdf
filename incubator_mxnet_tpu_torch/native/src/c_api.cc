// Flat C ABI — the first slice of the reference's c_api surface
// (ref include/mxnet/c_api.h: MXNDArrayCreate*, MXNDArraySyncCopyFromCPU,
// MXNDArraySyncCopyToCPU, MXNDArrayGetShape, MXNDArrayFree, MXDataIter*;
// error convention ref c_api_error.cc MXGetLastError).
//
// Scope decision (SURVEY §2.1): host-side array staging + native data
// iterators live behind this ABI so language bindings and the predict API
// have a stable flat surface; device arrays stay owned by the Python layer
// — the ABI hands off contiguous host buffers, and the Python layer copies
// them to the device (one copy, same as the reference's CPU->GPU path).
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
void* img_pipe_create(const char*, long, int, int, int, int, int, int,
                      const float*, const float*, float, int, int, int, long,
                      long, long);
long img_pipe_num_batches(void*);
long img_pipe_next(void*, float*, float*);
void img_pipe_reset(void*, int);
void img_pipe_destroy(void*);
}

namespace {
thread_local std::string g_last_error;

int fail(const std::string& msg) {
  g_last_error = msg;
  return -1;
}

// dtype codes follow mshadow (ref 3rdparty/mshadow/mshadow/base.h:334-346)
size_t dtype_size(int dtype) {
  switch (dtype) {
    case 0: return 4;   // float32
    case 1: return 8;   // float64
    case 2: return 2;   // float16
    case 3: return 1;   // uint8
    case 4: return 4;   // int32
    case 5: return 1;   // int8
    case 6: return 8;   // int64
    case 7: return 1;   // bool
    case 12: return 2;  // bfloat16
    default: return 0;
  }
}

struct HostArray {
  std::vector<int64_t> shape;
  int dtype;
  std::vector<uint8_t> data;
  size_t nbytes() const {
    size_t n = dtype_size(dtype);
    for (auto d : shape) n *= (size_t)d;
    return n;
  }
};

struct IterHandle {
  void* pipe;
  long batch, h, w, label_width;
  HostArray data, label;
  long last_bad = -2;  // -2 = before first next
};
}  // namespace

extern "C" {

const char* MXTPUGetLastError() { return g_last_error.c_str(); }

int MXTPUNDArrayCreate(const int64_t* shape, int ndim, int dtype,
                       void** out) {
  if (ndim < 0 || !dtype_size(dtype)) return fail("bad ndim/dtype");
  auto* a = new HostArray();
  a->shape.assign(shape, shape + ndim);
  a->dtype = dtype;
  a->data.resize(a->nbytes());
  *out = a;
  return 0;
}

int MXTPUNDArraySyncCopyFromCPU(void* handle, const void* data,
                                size_t nbytes) {
  auto* a = static_cast<HostArray*>(handle);
  if (nbytes != a->nbytes())
    return fail("size mismatch: got " + std::to_string(nbytes) + ", want " +
                std::to_string(a->nbytes()));
  memcpy(a->data.data(), data, nbytes);
  return 0;
}

int MXTPUNDArraySyncCopyToCPU(void* handle, void* data, size_t nbytes) {
  auto* a = static_cast<HostArray*>(handle);
  if (nbytes != a->nbytes())
    return fail("size mismatch: got " + std::to_string(nbytes) + ", want " +
                std::to_string(a->nbytes()));
  memcpy(data, a->data.data(), nbytes);
  return 0;
}

int MXTPUNDArrayGetShape(void* handle, int* out_ndim, int64_t* out_shape) {
  auto* a = static_cast<HostArray*>(handle);
  *out_ndim = (int)a->shape.size();
  if (out_shape)
    for (size_t i = 0; i < a->shape.size(); ++i) out_shape[i] = a->shape[i];
  return 0;
}

int MXTPUNDArrayGetDType(void* handle, int* out_dtype) {
  *out_dtype = static_cast<HostArray*>(handle)->dtype;
  return 0;
}

int MXTPUNDArrayGetData(void* handle, void** out_ptr) {
  *out_ptr = static_cast<HostArray*>(handle)->data.data();
  return 0;
}

int MXTPUNDArrayFree(void* handle) {
  delete static_cast<HostArray*>(handle);
  return 0;
}

// ------------------------------------------------------------- data iter
// (ref c_api.h MXDataIterCreateIter family, specialized to ImageRecordIter)
int MXTPUImageRecordIterCreate(const char* rec_path, long batch_size, int h,
                               int w, int label_width, int resize_short,
                               int rand_crop, int rand_mirror,
                               const float* mean_rgb, const float* std_rgb,
                               float scale, int shuffle, int seed,
                               int num_threads, long part_index,
                               long num_parts, void** out) {
  void* pipe = img_pipe_create(rec_path, batch_size, h, w, label_width,
                               resize_short, rand_crop, rand_mirror, mean_rgb,
                               std_rgb, scale, shuffle, seed, num_threads, 4,
                               part_index, num_parts);
  if (!pipe) return fail(std::string("cannot open record file ") + rec_path);
  auto* it = new IterHandle();
  it->pipe = pipe;
  it->batch = batch_size;
  it->h = h;
  it->w = w;
  it->label_width = label_width > 0 ? label_width : 1;
  it->data.shape = {batch_size, 3, h, w};
  it->data.dtype = 0;
  it->data.data.resize(it->data.nbytes());
  it->label.shape = {batch_size, it->label_width};
  it->label.dtype = 0;
  it->label.data.resize(it->label.nbytes());
  *out = it;
  return 0;
}

// Advances; returns 1 with data ready, 0 at epoch end.
int MXTPUDataIterNext(void* handle, int* out_has_next) {
  auto* it = static_cast<IterHandle*>(handle);
  long bad = img_pipe_next(it->pipe, (float*)it->data.data.data(),
                           (float*)it->label.data.data());
  it->last_bad = bad;
  *out_has_next = bad >= 0 ? 1 : 0;
  return 0;
}

int MXTPUDataIterGetData(void* handle, void** out_array) {
  *out_array = &static_cast<IterHandle*>(handle)->data;
  return 0;
}

int MXTPUDataIterGetLabel(void* handle, void** out_array) {
  *out_array = &static_cast<IterHandle*>(handle)->label;
  return 0;
}

int MXTPUDataIterGetBadCount(void* handle, long* out_bad) {
  *out_bad = static_cast<IterHandle*>(handle)->last_bad;
  return 0;
}

int MXTPUDataIterReset(void* handle, int reshuffle) {
  auto* it = static_cast<IterHandle*>(handle);
  img_pipe_reset(it->pipe, reshuffle);
  return 0;
}

int MXTPUDataIterFree(void* handle) {
  auto* it = static_cast<IterHandle*>(handle);
  img_pipe_destroy(it->pipe);
  delete it;
  return 0;
}

int mxtpu_capi_abi_version() { return 1; }

}  // extern "C"
