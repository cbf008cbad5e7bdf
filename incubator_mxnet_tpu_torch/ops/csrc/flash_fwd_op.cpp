// K1 as a C++ operator: mxtpu::flash_fwd for a process with no Python.
// It is no new kernel and replaces no TPU kernel: it binds K1
// (flash_fwd.cu, the port of incubator_mxnet_tpu/ops/attention.py
// _fa_kernel) to the dispatcher, so its bound and its times are K1's.
//
// Python processes register mxtpu::flash_fwd through torch.library in
// ops/attention.py (with its fake kernel and FLOP formula) and never load
// this library; the AOTInductor runner (native/src/aoti_serve.cc) loads it
// before it loads a package whose program calls the operator. The schema
// is the Python registration's, character for character.
//
// CUDA tensors launch the hand-written K1 of flash_fwd.cu (flash_fwd_tc for
// bf16/fp16, flash_fwd_fma for fp32) through its extern "C" launcher, on
// the current stream of q's device (at::cuda::getCurrentCUDAStream, which
// is c10::cuda::getCurrentCUDAStream). That part is compiled only with
// -DMXTPU_WITH_CUDA and links K1's library as nvcc builds it. CPU tensors
// run K1's plain version, the ATen ops of ops/attention.py:_fa_reference
// in the same order: the -inf-safe softmax and l clamped at 1e-37, so a
// fully masked row gives out 0 and lse -inf.
//
// mxtpu_flash_fwd_launches() counts K1's launches (one where the launcher
// returned success, nowhere else); mxtpu_flash_fwd_plain_calls() counts
// the plain version's calls.
#include <ATen/ATen.h>
#include <torch/library.h>

#include <atomic>
#include <cmath>
#include <tuple>

#ifdef MXTPU_WITH_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

extern "C" int mxt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                             float* lse, int BH, int S, int D, float scale, int causal,
                             int dtype, int device, void* stream);
extern "C" const char* mxt_cuda_error_string(int err);
#endif

namespace {

std::atomic<long long> g_launches{0};
std::atomic<long long> g_plain_calls{0};

using Pair = std::tuple<at::Tensor, at::Tensor>;

Pair flash_fwd_plain(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                     bool causal, double scale) {
  TORCH_CHECK(q.dim() == 4, "mxtpu::flash_fwd needs q of shape (B, H, S, D); got ",
              q.sizes());
  const int64_t B = q.size(0), H = q.size(1), S = q.size(2);
  at::Tensor s = at::matmul(q.to(at::kFloat) * scale, k.to(at::kFloat).transpose(-1, -2));
  if (causal) {
    at::Tensor keep = at::ones({S, S}, s.options().dtype(at::kBool)).tril();
    s = s.masked_fill(keep.logical_not(), -INFINITY);
  }
  at::Tensor m = s.amax({-1}, true);
  at::Tensor m_safe = at::where(at::isfinite(m), m, at::zeros_like(m));
  at::Tensor p = at::exp(s - m_safe);
  p = at::where(at::isfinite(s), p, at::zeros_like(p));
  at::Tensor l = p.sum({-1}, true).clamp_min(1e-37);
  at::Tensor out = (at::matmul(p, v.to(at::kFloat)) / l).to(q.scalar_type());
  at::Tensor lse = (m + at::log(l)).reshape({B * H, 1, S});
  g_plain_calls.fetch_add(1);
  return {out, lse};
}

#ifdef MXTPU_WITH_CUDA
int dtype_code(at::ScalarType t) {
  switch (t) {
    case at::kFloat: return 0;
    case at::kBFloat16: return 1;
    case at::kHalf: return 2;
    default: return -1;
  }
}

// The checks of ops/attention.py:_check_kernel_args for the forward.
void check_kernel_args(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v) {
  TORCH_CHECK(q.dim() == 4 && k.sizes() == q.sizes() && v.sizes() == q.sizes(),
              "flash_fwd needs q, k, v of one (B, H, S, D) shape; got ", q.sizes(), ", ",
              k.sizes(), ", ", v.sizes());
  const int64_t D = q.size(3);
  TORCH_CHECK(D == 64 || D == 128, "flash_fwd takes head width D in (64, 128), got ", D);
  TORCH_CHECK(dtype_code(q.scalar_type()) >= 0 && k.scalar_type() == q.scalar_type() &&
                  v.scalar_type() == q.scalar_type(),
              "flash_fwd takes float32, bfloat16 or float16 inputs of one type; got ",
              q.scalar_type(), ", ", k.scalar_type(), ", ", v.scalar_type());
  TORCH_CHECK(q.is_contiguous() && k.is_contiguous() && v.is_contiguous(),
              "flash_fwd needs contiguous inputs");
  TORCH_CHECK(k.device() == q.device() && v.device() == q.device(),
              "flash_fwd inputs lie on different devices");
  TORCH_CHECK(q.is_cuda(), "flash_fwd launches on CUDA tensors; got ", q.device());
  const int64_t tiles = q.size(0) * q.size(1) * ((q.size(2) + 63) / 64);
  TORCH_CHECK(tiles < (int64_t{1} << 31), "flash_fwd grid too large for shape ", q.sizes());
}

Pair flash_fwd_cuda(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                    bool causal, double scale) {
  check_kernel_args(q, k, v);
  const int64_t B = q.size(0), H = q.size(1), S = q.size(2), D = q.size(3);
  c10::cuda::CUDAGuard guard(q.device());
  at::Tensor out = at::empty_like(q);
  at::Tensor lse = at::empty({B * H, 1, S}, q.options().dtype(at::kFloat));
  cudaStream_t stream = c10::cuda::getCurrentCUDAStream(q.device().index()).stream();
  const int err = mxt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                lse.data_ptr<float>(), (int)(B * H), (int)S, (int)D,
                                (float)scale, causal ? 1 : 0, dtype_code(q.scalar_type()),
                                (int)q.device().index(), stream);
  TORCH_CHECK(err == 0, "flash_fwd launch failed: ", mxt_cuda_error_string(err));
  g_launches.fetch_add(1);
  return {out, lse};
}
#endif

}  // namespace

extern "C" long long mxtpu_flash_fwd_launches(void) { return g_launches.load(); }
extern "C" long long mxtpu_flash_fwd_plain_calls(void) { return g_plain_calls.load(); }

TORCH_LIBRARY(mxtpu, m) {
  m.def("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal, float scale) "
        "-> (Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(mxtpu, CPU, m) { m.impl("flash_fwd", &flash_fwd_plain); }

#ifdef MXTPU_WITH_CUDA
TORCH_LIBRARY_IMPL(mxtpu, CUDA, m) { m.impl("flash_fwd", &flash_fwd_cuda); }
#endif
