// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel incubator_mxnet_tpu/ops/attention.py:_fa_kernel
// (launched by _fa_call). It computes, for q, k, v of shape (B*H, S, D):
//   s = (q * scale) k^T in fp32, masked to -inf above the diagonal (causal)
//       and past S (ragged last tile);
//   an online softmax over K/V tiles with the -inf-safe rules of the TPU
//       kernel: m_safe = m_new if finite else 0, p = 0 where s = -inf,
//       alpha = exp(m - m_safe) (0 where m = -inf or NaN);
//   out = acc / max(l, 1e-37) in the input type, lse = m + log(max(l, 1e-37))
//       in fp32 with layout (B*H, 1, S).
//
// Bound on this card. The work is 4*B*H*S^2*D flops (half with the causal
// mask) against 4*B*H*S*D input/output elements. At the served BERT shape
// (B*H = 64, S = 512, D = 128, bf16) bytes and bf16 tensor-core operations
// bound it about equally (10 us and 9 us); at the served GPT shape (B*H = 8,
// S = 8192, causal) operations bound it (139 us against 20 us for bytes).
// This first kernel does not use the tensor cores. It multiplies with fp32
// FMAs, whose peak is 67 TFLOP/s, so it cannot come near the bound; it is
// written to be right and simple. A later version moves both products onto
// mma/wgmma and stages tiles with cp.async/TMA.
//
// Design, and what it does about the bound:
//  * The TPU kernel's sequential grid axis over K/V blocks becomes a loop
//    inside one CTA; the CTA owns one (batch*head, 64-row q tile), so the
//    m/l/acc carry lives in registers for the whole loop.
//  * 256 threads as a 16x16 grid. Thread (ty, tx) owns q rows ty + 16*i
//    (i < 4) and, for the score tile, kv columns tx + 16*j (j < 4); for the
//    output it owns columns tx + 16*j (j < D/16). Every row's 16 partial
//    values live in one half-warp, so row max and row sum are 4 shuffles.
//  * Q (pre-scaled), the K-then-V tile and the probabilities are staged in
//    shared memory as fp32 with a padded row stride, so the column walks
//    of both products are free of bank conflicts. 82.7 KB at D = 128 lets
//    two CTAs share an SM.
//  * Causal: the loop ends at the diagonal tile, so tiles above it are
//    neither loaded nor computed. CTAs start with the longest q tiles.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;    // q rows per CTA
constexpr int BN = 64;    // kv rows per loop step
constexpr int NT = 256;   // threads per CTA
constexpr int LDP = BN + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

// Stage rows [r0, r0 + 64) of one (S, D) matrix into shared memory as fp32
// times `mul`, zero past S.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int r0, int S, float mul) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int row = r0 + r;
    dst[r * LD + c] = row < S ? to_f(src[(size_t)row * D + c]) * mul : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int nq, float scale,
                 int causal) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // BM x LD, q * scale
  float* KVs = Qs + BM * LD;     // BN x LD, the K tile, then the V tile
  float* Ps = KVs + BN * LD;     // BM x LDP, probabilities of this step

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x / nq;
  const int qt = nq - 1 - (int)(blockIdx.x % nq);
  const int q0 = qt * BM;
  const size_t base = (size_t)bh * S * D;

  load_tile<T, D>(Qs, q + base, q0, S, scale);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (S + BN - 1) / BN;
  const int kt_end = causal ? min(nk, qt + 1) : nk;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous step is done with KVs and Ps
    load_tile<T, D>(KVs, k + base, k0, S, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = KVs[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= S || (causal && col > row)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      float alpha = isfinite(m[i]) ? expf(m[i] - m_safe) : 0.f;
      if (isnan(alpha)) alpha = 0.f;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = isfinite(s[i][j]) ? expf(s[i][j] - m_safe) : 0.f;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();  // every thread is done reading the K tile
    load_tile<T, D>(KVs, v + base, k0, S, 1.f);
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + n];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = KVs[n * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float li = fmaxf(l[i], 1e-37f);
    T* o = out + base + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[tx + 16 * j] = from_f<T>(acc[i][j] / li);
    if (tx == 0) lse[(size_t)bh * S + row] = m[i] + logf(li);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int BH, int S, float scale, int causal,
                   cudaStream_t stream) {
  const int nq = (S + BM - 1) / BM;
  const size_t smem = sizeof(float) * ((size_t)(BM + BN) * (D + 1) + (size_t)BM * LDP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, D><<<dim3((unsigned)nq * (unsigned)BH), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, S, nq, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     float* lse, int BH, int S, int D, float scale, int causal,
                     cudaStream_t stream) {
  if (D == 64) return launch<T, 64>(q, k, v, out, lse, BH, S, scale, causal, stream);
  if (D == 128) return launch<T, 128>(q, k, v, out, lse, BH, S, scale, causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns the launch's
// cudaError_t (0 on success). Launches on `stream` and does not synchronise.
int mxt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  float* lse, int BH, int S, int D, float scale, int causal,
                  int dtype, int device, void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch_d<float>(q, k, v, out, lse, BH, S, D, scale, causal, st); break;
    case 1: err = launch_d<__nv_bfloat16>(q, k, v, out, lse, BH, S, D, scale, causal, st); break;
    case 2: err = launch_d<__half>(q, k, v, out, lse, BH, S, D, scale, causal, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
