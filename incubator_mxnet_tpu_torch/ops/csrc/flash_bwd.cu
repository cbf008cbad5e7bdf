// Flash-attention backward for Hopper (sm_90a), with a plain C interface:
// two kernels, as the TPU backward has two pallas_calls, and no atomics.
//
// Replaces incubator_mxnet_tpu/ops/attention.py:_fa_bwd_dkv_kernel (K2,
// mxt_flash_bwd_dkv below) and :_fa_bwd_dq_kernel (K3, mxt_flash_bwd_dq),
// both launched by _fa_bwd_call. For q, k, v, dO of shape (B*H, S, D) in the
// input type and lse, delta of shape (B*H, 1, S) in fp32 (delta = rowsum(dO*O)
// minus the LSE cotangent, computed by the caller), each (q row i, kv row j)
// pair recomputes, as _recompute_p_ds does:
//   s  = (q_i . k_j) * scale          (scaled after the product, unlike K1)
//   p  = exp(s - lse_i), and 0 where s is not finite (the -inf rule: a fully
//        masked row gives zero gradients, never NaN), past S, and above the
//        diagonal when causal (kept pairs: i >= j);
//   dp = dO_i . v_j,   ds = p * (dp - delta_i) * scale;
// K2 sums dV_j += p dO_i and dK_j += ds q_i over q rows, K3 sums
// dQ_i += ds k_j over kv rows. Sums are fp32; each gradient is rounded once
// to the input type when it is written.
//
// Bound on this card. K2 does 8*B*H*P*D flops and K3 6*B*H*P*D (P kept
// pairs: S^2, or S(S+1)/2 causal) against reading q, k, v, dO, lse, delta and
// writing their gradients once. At the training shapes (bf16, D = 128; BERT
// B*H = 512, S = 512; GPT B*H = 8, S = 8192 causal) bf16 tensor-core
// operations bound both kernels, not bytes. Like K1, these first kernels do
// not use the tensor cores: they multiply with fp32 FMAs (67 TFLOP/s peak),
// so they cannot come near the bound; they are written to be right and
// simple. mma/wgmma, cp.async/TMA staging and fusing the two kernels with an
// atomic dQ are later work.
//
// Design:
//  * The TPU kernels' sequential grid axis becomes a loop inside one CTA.
//    K2: a CTA owns one (batch*head, 64-row kv tile); K and V stay in shared
//    memory, dK and dV accumulate in registers, and the CTA walks the q
//    tiles (when causal, from the diagonal tile on). K3: a CTA owns one
//    (batch*head, 64-row q tile); q and dO stay in shared memory and lse and
//    delta in registers, dQ accumulates in registers, and the CTA walks the
//    kv tiles up to the diagonal.
//  * 256 threads as a 16x16 grid, as in K1: thread (ty, tx) owns tile rows
//    ty + 16*i (i < 4); for the 64x64 score tile it owns columns tx + 16*j
//    (j < 4), for a gradient tile columns tx + 16*j (j < D/16).
//  * Tiles are staged in shared memory as fp32 with a padded row stride
//    (D + 1, 65), so every column walk is free of bank conflicts. At D = 128
//    that is 162 KB for K2 and 146 KB for K3, one CTA per SM, above the
//    48 KB default: the launch sets the dynamic shared-memory attribute.
//  * Causal: tiles wholly above the diagonal are neither loaded nor
//    computed. CTAs are numbered so that the tiles with the most work start
//    first, and adjacent CTAs share a tile index over batch*head.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BT = 64;    // rows of a q or kv tile
constexpr int NT = 256;   // threads per CTA
constexpr int LDP = BT + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

// Stage rows [r0, r0 + 64) of one (S, D) matrix into shared memory as fp32,
// zero past S.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int r0, int S) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < BT * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int row = r0 + r;
    dst[r * LD + c] = row < S ? to_f(src[(size_t)row * D + c]) : 0.f;
  }
}

// Write a 64 x D fp32 register tile (rows ty + 16*i, columns tx + 16*j) to
// rows [r0, r0 + 64) of an (S, D) matrix in the input type.
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* __restrict__ dst, float (&acc)[4][D / 16],
                                           int r0, int S) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= S) continue;
    T* o = dst + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) o[tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

// acc[i][j] += sum_n A[(ty + 16 i) * LDP + n] * B[n * (D + 1) + tx + 16 j]
// over one 64-wide tile: a (64 x 64) by (64 x D) product into registers.
template <int D>
__device__ __forceinline__ void mma_tile(float (&acc)[4][D / 16], const float* A,
                                         const float* B) {
  constexpr int LD = D + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int n = 0; n < BT; ++n) {
    float a[4], b[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LDP + n];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) b[j] = B[n * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// s[i][j] = R1[row i] . C1[col j] and dp[i][j] = R2[row i] . C2[col j] for
// rows ty + 16 i and columns tx + 16 j of 64 x D fp32 tiles.
template <int D>
__device__ __forceinline__ void two_scores(float (&s)[4][4], float (&dp)[4][4],
                                           const float* R1, const float* C1,
                                           const float* R2, const float* C2) {
  constexpr int LD = D + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float r1[4], c1[4], r2[4], c2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r1[i] = R1[(ty + 16 * i) * LD + d];
      r2[i] = R2[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c1[j] = C1[(tx + 16 * j) * LD + d];
      c2[j] = C2[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(r1[i], c1[j], s[i][j]);
        dp[i][j] = fmaf(r2[i], c2[j], dp[i][j]);
      }
  }
}

// p and ds of one (q row, kv row) pair, with the masking rules above.
__device__ __forceinline__ void p_ds(float dot, float dpv, float lse, float delta,
                                     bool keep, float scale, float& p, float& ds) {
  const float s = dot * scale;
  p = (keep && isfinite(s)) ? expf(s - lse) : 0.f;
  ds = p * (dpv - delta) * scale;
}

// K2: dK, dV of one (batch*head, kv tile).
template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int BH, int S,
                     float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;               // BT x LD
  float* Vs = Ks + BT * LD;       // BT x LD
  float* Qs = Vs + BT * LD;       // BT x LD, this step's q tile
  float* dOs = Qs + BT * LD;      // BT x LD, this step's dO tile
  float* Ps = dOs + BT * LD;      // BT x LDP, p[kv row][q row]
  float* dSs = Ps + BT * LDP;     // BT x LDP, ds[kv row][q row]
  float* rows = dSs + BT * LDP;   // lse[BT], delta[BT] of this step's q rows

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x % BH;
  const int kt = blockIdx.x / BH;  // causal: low kv tiles have the most q tiles
  const int k0 = kt * BT;
  const int nq = (S + BT - 1) / BT;
  const size_t base = (size_t)bh * S * D;

  load_tile<T, D>(Ks, k + base, k0, S);
  load_tile<T, D>(Vs, v + base, k0, S);

  float dKa[4][DJ], dVa[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dKa[i][j] = dVa[i][j] = 0.f;

  for (int qt = causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();  // the previous step is done with Qs, dOs, Ps, dSs, rows
    load_tile<T, D>(Qs, q + base, q0, S);
    load_tile<T, D>(dOs, dout + base, q0, S);
    if (threadIdx.x < BT) {
      const int row = q0 + threadIdx.x;
      rows[threadIdx.x] = row < S ? lse[(size_t)bh * S + row] : 0.f;
      rows[BT + threadIdx.x] = row < S ? delta[(size_t)bh * S + row] : 0.f;
    }
    __syncthreads();

    // kv rows ty + 16 i against q rows tx + 16 j
    float s[4][4], dp[4][4];
    two_scores<D>(s, dp, Ks, Qs, Vs, dOs);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const int qr = q0 + qc;
        const bool keep = kr < S && qr < S && !(causal && qr < kr);
        float p, ds;
        p_ds(s[i][j], dp[i][j], rows[qc], rows[BT + qc], keep, scale, p, ds);
        Ps[(ty + 16 * i) * LDP + qc] = p;
        dSs[(ty + 16 * i) * LDP + qc] = ds;
      }
    }
    __syncthreads();
    mma_tile<D>(dVa, Ps, dOs);   // dV += p^T dO
    mma_tile<D>(dKa, dSs, Qs);   // dK += ds^T q
  }

  store_tile<T, D>(dk + base, dKa, k0, S);
  store_tile<T, D>(dv + base, dVa, k0, S);
}

// K3: dQ of one (batch*head, q tile).
template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int BH, int S, int nq, float scale,
                    int causal) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;               // BT x LD
  float* dOs = Qs + BT * LD;      // BT x LD
  float* Ks = dOs + BT * LD;      // BT x LD, this step's k tile
  float* Vs = Ks + BT * LD;       // BT x LD, this step's v tile
  float* dSs = Vs + BT * LD;      // BT x LDP, ds[q row][kv row]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x % BH;
  const int qt = nq - 1 - (int)(blockIdx.x / BH);  // causal: high q tiles first
  const int q0 = qt * BT;
  const size_t base = (size_t)bh * S * D;

  load_tile<T, D>(Qs, q + base, q0, S);
  load_tile<T, D>(dOs, dout + base, q0, S);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < S ? lse[(size_t)bh * S + row] : 0.f;
    delta_r[i] = row < S ? delta[(size_t)bh * S + row] : 0.f;
  }

  float dQa[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dQa[i][j] = 0.f;

  const int nk = (S + BT - 1) / BT;
  const int kt_end = causal ? min(nk, qt + 1) : nk;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous step is done with Ks, Vs, dSs
    load_tile<T, D>(Ks, k + base, k0, S);
    load_tile<T, D>(Vs, v + base, k0, S);
    __syncthreads();

    // q rows ty + 16 i against kv rows tx + 16 j
    float s[4][4], dp[4][4];
    two_scores<D>(s, dp, Qs, Ks, dOs, Vs);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = k0 + tx + 16 * j;
        const bool keep = kr < S && qr < S && !(causal && qr < kr);
        float p, ds;
        p_ds(s[i][j], dp[i][j], lse_r[i], delta_r[i], keep, scale, p, ds);
        dSs[(ty + 16 * i) * LDP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    mma_tile<D>(dQa, dSs, Ks);   // dQ += ds k
  }

  store_tile<T, D>(dq + base, dQa, q0, S);
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv,
                       int BH, int S, float scale, int causal, cudaStream_t stream) {
  const int nk = (S + BT - 1) / BT;
  const size_t smem = sizeof(float) * (4 * (size_t)BT * (D + 1) + 2 * (size_t)BT * LDP + 2 * BT);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, D><<<dim3((unsigned)nk * (unsigned)BH), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      BH, S, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int BH, int S,
                      float scale, int causal, cudaStream_t stream) {
  const int nq = (S + BT - 1) / BT;
  const size_t smem = sizeof(float) * (4 * (size_t)BT * (D + 1) + (size_t)BT * LDP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D><<<dim3((unsigned)nq * (unsigned)BH), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), BH, S, nq, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dkv_d(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dk, void* dv, int BH,
                  int S, int D, float scale, int causal, cudaStream_t st) {
  if (D == 64) return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, BH, S, scale, causal, st);
  if (D == 128) return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, BH, S, scale, causal, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dq_d(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq, int BH, int S, int D,
                 float scale, int causal, cudaStream_t st) {
  if (D == 64) return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, BH, S, scale, causal, st);
  if (D == 128) return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, BH, S, scale, causal, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Each returns the launch's
// cudaError_t (0 on success), launches on `stream` and does not synchronise.
int mxt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dk, void* dv, int BH,
                      int S, int D, float scale, int causal, int dtype, int device,
                      void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = dkv_d<float>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale, causal, st); break;
    case 1: err = dkv_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale, causal, st); break;
    case 2: err = dkv_d<__half>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale, causal, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

int mxt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq, int BH, int S,
                     int D, float scale, int causal, int dtype, int device,
                     void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = dq_d<float>(q, k, v, dout, lse, delta, dq, BH, S, D, scale, causal, st); break;
    case 1: err = dq_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, BH, S, D, scale, causal, st); break;
    case 2: err = dq_d<__half>(q, k, v, dout, lse, delta, dq, BH, S, D, scale, causal, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
