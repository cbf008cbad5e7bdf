// Fused backward of a 3x3 / stride-1 / pad-1 convolution for Hopper
// (sm_90a), with a plain C interface: dgrad and wgrad in one call, no
// atomics, deterministic.
//
// Replaces incubator_mxnet_tpu/ops/conv_bwd.py:_conv_bwd_kernel (K4), launched
// there by conv3x3_bwd. Layouts as in the JAX package: x (N, H, W, C) and
// dy (N, H, W, K) NHWC, w (3, 3, C, K) HWIO. The caller passes the rotated
// weight wd (9K, C), wd[(tr*3 + ts)*K + k][c] = w[2-tr][2-ts][c][k], prepared
// outside the kernel as the TPU kernel's caller does. With M = N*H*W pixels:
//   dx[m][c]      = sum_{tr,ts,k} dy[n, a+tr-1, b+ts-1, k] * wd[(tr*3+ts)*K+k][c]
//                   (implicit GEMM, M x 9K times 9K x C; taps outside the
//                   image read zero)
//   dw[r][s][c][k] = sum_m x[n, a+r-1, b+s-1, c] * dy[m][k]
//                   (9 GEMMs C x M times M x K)
// Every sum is fp32; dx is rounded once to x's type, dw once to w's type.
//
// Bound on this card. Each of the two products is 2*M*9*C*K flops, 118.4
// GFLOP together at every ResNet-50 bottleneck stage at batch 256, against
// reading x, dy and w and writing dx and dw once (0.04-0.31 GB). So bf16
// tensor-core operations bound it (0.120 ms at 989 TFLOP/s), not bytes.
//
// The TPU kernel walks batch chunks on a sequential grid and carries dw in
// VMEM scratch. Here blocks run in parallel in no order, so the two
// gradients are separate kernels over independent tiles, and dw is summed
// over pixel slices in a second, fixed-order pass (deterministic, no
// atomics). Two routes, chosen by the input type (a routing, not a
// fallback):
//
// bf16 / fp16: tensor cores (conv3x3_dgrad_tc, conv3x3_wgrad_tc). Every
// product is mma.sync.m16n8k16 with fp32 accumulators, its operands read from
// shared memory with ldmatrix. The inputs are already in the working type
// and products and sums are fp32, so no rounding is added: dx and dw are
// rounded once, when they are written.
//  * Tiles stay in the input type in shared memory, 64 (dgrad's B: 64 or
//    128) elements wide with a row stride of the width + 8 (the 8 rows an
//    ldmatrix reads fall on distinct bank groups), filled with 16-byte
//    cp.async copies, neighbouring threads on neighbouring chunks, and
//    double buffered: the next step's copies are in flight while the current
//    step computes. A copy outside the image, past the pixels, or past C or
//    K (C and K are multiples of 8, so a 16-byte copy is all in or all out)
//    reads no byte and zero-fills (source size 0, the address clamped to a
//    valid one).
//  * What bounds these kernels is how often an operand is read again from
//    L2 (each dy row once per tap, each tile once per output tile), so the
//    tiles are as large as 8 warps with 64 fp32 accumulators a thread allow.
//  * dgrad: a CTA of 8 warps owns 128 pixels x 128 channels (C > 64) or 256
//    pixels x 64 channels (a warp 32 x 64 or 64 x 32) and loops over (tap,
//    64-wide k chunk). The A tile is the tap-shifted dy rows, each a
//    contiguous run of k values, read with plain ldmatrix; the B tile is
//    wd's rows (reduction axis k as the row), read with ldmatrix.trans. dx
//    leaves through shared memory as 16-byte stores. 71,680 or 92,160 bytes
//    of shared memory.
//  * wgrad: a CTA of 8 warps owns the three taps of one tap row, 64 c x 64 k
//    of each, and a slice of the pixels (the caller picks the slices so that
//    enough CTAs run), and loops over 64-pixel steps. Read from the x
//    pixel's side, the three taps share one x tile [pixel][c] and each has
//    its own shifted dy tile [pixel][k]; both are reduced along pixel rows
//    and read with ldmatrix.trans. 73,728 bytes of shared memory. Each CTA
//    writes its fp32 partial sums to a workspace; conv3x3_wgrad_reduce adds
//    the slices of each output in slice order and rounds once.
//
// fp32: the first, FMA kernels (conv3x3_dgrad_fma, conv3x3_wgrad_fma): fp32
// shared-memory tiles, 256 threads each accumulating a 4x4 block with float4
// shared-memory reads, and the same slices and reduce pass. TF32 tensor
// cores would not keep fp32's agreement with the plain version.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ------------------------------------------------------------ fp32 route
constexpr int TM = 64;        // dgrad: pixels per CTA;  wgrad: c per CTA
constexpr int TN = 64;        // dgrad: channels c per CTA;  wgrad: k per CTA
constexpr int TK = 32;        // reduction chunk (k for dgrad, pixels for wgrad)
constexpr int NT = 256;       // threads per CTA, a 16 x 16 grid of 4x4 blocks
constexpr int LDA = TK + 4;   // dgrad dy-tile row stride: float4-aligned, and
                              // rows 4 apart fall 16 banks apart

__device__ __forceinline__ float part(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// acc[i][j] += a[i][q] * b[q][j] over q < 4, for one 4-deep slice.
__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 (&a)[4],
                                       const float4 (&b)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float ai = part(a[i], q);
      acc[i][0] += ai * b[q].x;
      acc[i][1] += ai * b[q].y;
      acc[i][2] += ai * b[q].z;
      acc[i][3] += ai * b[q].w;
    }
  }
}

// dx tile: pixels [blockIdx.x*64, +64) x channels [blockIdx.y*64, +64).
__global__ void __launch_bounds__(NT)
conv3x3_dgrad_fma(const float* __restrict__ dy, const float* __restrict__ wd,
                  float* __restrict__ dx, int N, int H, int W, int C, int K) {
  __shared__ __align__(16) float As[TM * LDA];   // [pixel][k], shifted dy
  __shared__ __align__(16) float Bs[TK * TN];    // [k][c], wd
  __shared__ int pn[TM], pa[TM], pb[TM];         // pixel (n, a, b); n = -1 past M

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int HW = H * W, M = N * HW;
  const int m0 = blockIdx.x * TM, c0 = blockIdx.y * TN;
  if (tid < TM) {
    const int m = m0 + tid;
    if (m < M) {
      const int n = m / HW, rem = m - n * HW;
      pn[tid] = n;
      pa[tid] = rem / W;
      pb[tid] = rem % W;
    } else {
      pn[tid] = -1;
    }
  }
  float acc[4][4] = {};
  __syncthreads();

  for (int t = 0; t < 9; ++t) {
    const int da = t / 3 - 1, db = t % 3 - 1;
    for (int k0 = 0; k0 < K; k0 += TK) {
      for (int idx = tid; idx < TM * TK; idx += NT) {
        const int r = idx / TK, kk = idx % TK;
        const int n = pn[r], a = pa[r] + da, b = pb[r] + db;
        float v = 0.f;
        if (n >= 0 && k0 + kk < K && a >= 0 && a < H && b >= 0 && b < W)
          v = dy[(((size_t)n * H + a) * W + b) * K + k0 + kk];
        As[r * LDA + kk] = v;
      }
      for (int idx = tid; idx < TK * TN; idx += NT) {
        const int kk = idx / TN, c = idx % TN;
        float v = 0.f;
        if (k0 + kk < K && c0 + c < C) v = wd[((size_t)t * K + k0 + kk) * C + c0 + c];
        Bs[kk * TN + c] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK; kk += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(&As[(ty * 4 + i) * LDA + kk]);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          b[q] = *reinterpret_cast<const float4*>(&Bs[(kk + q) * TN + tx * 4]);
        fma4x4(acc, a, b);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (pn[r] < 0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c < C) dx[(size_t)(m0 + r) * C + c] = acc[i][j];
    }
  }
}

// Partial dw of tap blockIdx.y over pixels [blockIdx.z*chunk, +chunk), for the
// (c, k) tile blockIdx.x; written to ws[blockIdx.z][tap][c][k] in fp32.
__global__ void __launch_bounds__(NT)
conv3x3_wgrad_fma(const float* __restrict__ x, const float* __restrict__ dy,
                  float* __restrict__ ws, int N, int H, int W, int C, int K, int chunk) {
  __shared__ __align__(16) float Xs[TK * TM];    // [pixel][c], shifted x
  __shared__ __align__(16) float Ds[TK * TN];    // [pixel][k], dy
  __shared__ int pn[TK], pa[TK], pb[TK];         // shifted source pixel; n = -1 if none

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int HW = H * W, M = N * HW;
  const int tiles_k = (K + TN - 1) / TN;
  const int c0 = (blockIdx.x / tiles_k) * TM, k0 = (blockIdx.x % tiles_k) * TN;
  const int t = blockIdx.y, da = t / 3 - 1, db = t % 3 - 1;
  const int m_beg = blockIdx.z * chunk;
  const int m_end = min(M, m_beg + chunk);
  float acc[4][4] = {};

  for (int mb = m_beg; mb < m_end; mb += TK) {
    if (tid < TK) {
      const int m = mb + tid;
      int n = -1, a = 0, b = 0;
      if (m < m_end) {
        n = m / HW;
        const int rem = m - n * HW;
        a = rem / W + da;
        b = rem % W + db;
        if (a < 0 || a >= H || b < 0 || b >= W) n = -1;
      }
      pn[tid] = n;
      pa[tid] = a;
      pb[tid] = b;
    }
    __syncthreads();
    for (int idx = tid; idx < TK * TM; idx += NT) {
      const int mm = idx / TM, c = idx % TM;
      const int n = pn[mm];
      float v = 0.f;
      if (n >= 0 && c0 + c < C) v = x[(((size_t)n * H + pa[mm]) * W + pb[mm]) * C + c0 + c];
      Xs[mm * TM + c] = v;
    }
    for (int idx = tid; idx < TK * TN; idx += NT) {
      const int mm = idx / TN, k = idx % TN;
      float v = 0.f;
      if (mb + mm < m_end && k0 + k < K) v = dy[(size_t)(mb + mm) * K + k0 + k];
      Ds[mm * TN + k] = v;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < TK; mm += 4) {
      float4 a[4], b[4];
      // a[i] holds rows c = ty*4+i for the four pixels mm..mm+3: gather it
      // from the four pixel rows (one float4 read per pixel), transposed.
      float4 xr[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        xr[q] = *reinterpret_cast<const float4*>(&Xs[(mm + q) * TM + ty * 4]);
        b[q] = *reinterpret_cast<const float4*>(&Ds[(mm + q) * TN + tx * 4]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = make_float4(part(xr[0], i), part(xr[1], i), part(xr[2], i), part(xr[3], i));
      fma4x4(acc, a, b);
    }
    __syncthreads();
  }

  float* out = ws + ((size_t)blockIdx.z * 9 + t) * C * K;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx * 4 + j;
      if (k < K) out[(size_t)c * K + k] = acc[i][j];
    }
  }
}

// ----------------------------------------------------- tensor-core route
constexpr int TW = 64;          // reduction chunk (dgrad: k, wgrad: pixels); wgrad c, k tile
constexpr int LDS = TW + 8;     // row stride (elements) of a 64-wide tile
constexpr int TC_NT = 256;      // 8 warps a CTA, both kernels

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (the
// source then reads no byte, but stays a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8m..8m+7 give matrix m's row addresses.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16x8 fp32) += a (16x16, row) * b (16x8, col)
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Two fp32 values rounded to the input type, the lower column in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// Fragment addressing (m16n8k16; g = lane / 4, t = lane % 4). An
// accumulator tile holds (row g, cols 2t, 2t+1) in c0, c1 and row g + 8 in
// c2, c3. A 16x16 A tile at (m0, k0): from an [m][k] matrix (no trans) lane l
// reads row m0 + l % 16 at column k0 + 8 (l / 16); from a [k][m] matrix
// (trans) row k0 + l % 8 + 8 (l / 16) at m0 + 8 ((l / 8) % 2). B tiles for
// two n8 tiles at n0, n0 + 8 and k16 at k0 from a [k][n] matrix (trans):
// lane l reads row k0 + l % 8 + 8 ((l / 8) % 2) at n0 + 8 (l / 16); r0, r1
// are the (b0, b1) of the n tile at n0, r2, r3 those at n0 + 8.
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) << 3; }
__device__ __forceinline__ int at_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int at_col(int lane) { return ((lane >> 3) & 1) << 3; }
__device__ __forceinline__ int bt_row(int lane) { return (lane & 7) + (((lane >> 3) & 1) << 3); }
__device__ __forceinline__ int bt_col(int lane) { return (lane >> 4) << 3; }

// dx tile: pixels [blockIdx.x*BM, +BM) x channels [blockIdx.y*BN, +BN), BM x
// BN = 128 x 128 (C > 64) or 256 x 64. Warp w: pixels BM/4 (w % 4)..,
// channels BN/2 (w / 4).., a 32 x 64 or 64 x 32 warp tile.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(TC_NT)
conv3x3_dgrad_tc(const T* __restrict__ dy, const T* __restrict__ wd, T* __restrict__ dx,
                 int H, int W, int C, int K, int M) {
  constexpr int WM = BM / 4, WN = BN / 2, MI = WM / 16, NJ = WN / 8;
  constexpr int LDB = BN + 8;
  constexpr int A_TILE = BM * LDS, B_TILE = TW * LDB;
  constexpr int A_ROWS = BM * 8 / TC_NT;    // A rows a thread copies
  constexpr int B_TPR = BN / 8;              // threads per B row
  constexpr int B_ROWS = TW * B_TPR / TC_NT; // B rows a thread copies
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);   // [2][A_TILE], shifted dy [pixel][k]
  T* Bs = As + 2 * A_TILE;                   // [2][B_TILE], wd [k][c]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = WM * (warp & 3), wn = WN * (warp >> 2);
  const int m0 = blockIdx.x * BM, c0 = blockIdx.y * BN;

  // this thread's A copies: chunk ac of pixel rows tid/8 + 32 j (eight
  // neighbouring threads copy one 128-byte row), and each pixel's place in
  // the image (far outside it past M, so every tap reads zero there)
  const int ac = (tid & 7) * 8;
  int pa[A_ROWS], pb[A_ROWS];
#pragma unroll
  for (int j = 0; j < A_ROWS; ++j) {
    const int am = m0 + (tid >> 3) + 32 * j;
    pa[j] = -(1 << 20);
    pb[j] = 0;
    if (am < M) {
      const int rem = am % (H * W);
      pa[j] = rem / W;
      pb[j] = rem - pa[j] * W;
    }
  }
  // its B copies: rows tid / B_TPR + j TC_NT / B_TPR, one chunk at column bc
  const int br = tid / B_TPR, bc = (tid % B_TPR) * 8;
  const bool bc_ok = c0 + bc < C;

  const int kch = (K + TW - 1) / TW, steps = 9 * kch;
  auto load = [&](int buf, int step) {
    const int tap = step / kch, k0 = (step - tap * kch) * TW;
    const int da = tap / 3 - 1, db = tap % 3 - 1;
    const bool k_ok = k0 + ac < K;
#pragma unroll
    for (int j = 0; j < A_ROWS; ++j) {
      const int r = (tid >> 3) + 32 * j;
      const int a = pa[j] + da, b = pb[j] + db;
      const bool ok = k_ok && a >= 0 && a < H && b >= 0 && b < W;
      cp_async16(As + buf * A_TILE + r * LDS + ac,
                 dy + (ok ? (size_t)(m0 + r + da * W + db) * K + k0 + ac : 0), ok);
    }
#pragma unroll
    for (int j = 0; j < B_ROWS; ++j) {
      const int r = br + j * (TC_NT / B_TPR), kr = k0 + r;
      const bool ok = bc_ok && kr < K;
      cp_async16(Bs + buf * B_TILE + r * LDB + bc,
                 wd + (ok ? ((size_t)tap * K + kr) * C + c0 + bc : 0), ok);
    }
  };

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load(0, 0);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) {  // the next step loads while this one computes
      load(buf ^ 1, step + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* A = As + buf * A_TILE;
    const T* B = Bs + buf * B_TILE;
#pragma unroll
    for (int kk = 0; kk < TW / 16; ++kk) {
      uint32_t af[MI][4], bf[NJ / 2][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_x4(af[i], A + (wm + 16 * i + a_row(lane)) * LDS + 16 * kk + a_col(lane));
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj)
        ldsm_x4_t(bf[jj], B + (16 * kk + bt_row(lane)) * LDB + wn + 16 * jj + bt_col(lane));
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ / 2; ++jj) {
          mma16816<T>(acc[i][2 * jj], af[i], bf[jj][0], bf[jj][1]);
          mma16816<T>(acc[i][2 * jj + 1], af[i], bf[jj][2], bf[jj][3]);
        }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  // dx leaves through shared memory (the A buffers, free now), so that each
  // row is written with 16-byte stores
  constexpr int LDC = BN + 8;
  T* Cs = As;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        *reinterpret_cast<uint32_t*>(Cs + (wm + 16 * i + g + 8 * h) * LDC + wn + 8 * j + 2 * t) =
            pack2<T>(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  __syncthreads();
  for (int idx = tid; idx < BM * (BN / 8); idx += TC_NT) {
    const int r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
    if (m0 + r < M && c0 + c < C)
      *reinterpret_cast<uint4*>(dx + (size_t)(m0 + r) * C + c0 + c) =
          *reinterpret_cast<const uint4*>(Cs + r * LDC + c);
  }
}

// Partial dw of the three taps of row tr = blockIdx.y (taps 3 tr + ts, ts
// = 0, 1, 2) over the x pixels p of [blockIdx.z*chunk, +chunk), for the
// (c, k) tile blockIdx.x; written to ws[blockIdx.z][tap][c][k] in fp32. Read
// from the x pixel's side, dw[tap][c][k] = sum_p x[p][c] dy[p - off][k] with
// off = (tr-1) W + (ts-1), where dy's pixel (a_p - tr + 1, b_p - ts + 1) lies
// in the image: one x tile [p][c] serves the three taps, each with its own
// shifted dy tile [p][k], zero-filled where that pixel lies outside. The
// product's columns are (tap, k), 3 x 64; warp w owns c 32 (w % 2).. and
// columns 48 (w / 2).. (a 16-column group never straddles two taps).
template <typename T>
__global__ void __launch_bounds__(TC_NT)
conv3x3_wgrad_tc(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ ws,
                 int H, int W, int C, int K, int M, int chunk) {
  constexpr int TILE = TW * LDS, STAGE = 4 * TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);  // [2][x tile, dy tiles of ts 0, 1, 2]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wc = 32 * (warp & 1), wq = 3 * (warp >> 1);  // first 16-column group
  const int HW = H * W;
  const int tiles_k = (K + TW - 1) / TW;
  const int c0 = (blockIdx.x / tiles_k) * TW, k0 = (blockIdx.x % tiles_k) * TW;
  const int tr = blockIdx.y, da = tr - 1;
  const int m_beg = blockIdx.z * chunk;
  const int m_end = min(M, m_beg + chunk);

  // this thread's copies: pixel row tid/4 of each step, 16-byte chunks at
  // columns 8 (tid % 4) and 8 (tid % 4) + 32 of each of the four tiles (four
  // neighbouring threads copy 64 contiguous bytes at a time)
  const int r = tid >> 2, cc = (tid & 3) * 8;
  auto load = [&](int buf, int mb) {
    const int p = mb + r;
    const bool live = p < m_end;
    int a = -(1 << 20), b = 0;
    if (live) {
      const int rem = p % HW;
      a = rem / W;
      b = rem - a * W;
    }
    T* dst = S + buf * STAGE + r * LDS + cc;
    const T* xs = x + (live ? (size_t)p * C : 0);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool ok = live && c0 + cc + 32 * j < C;
      cp_async16(dst + 32 * j, xs + (ok ? c0 + cc + 32 * j : 0), ok);
    }
    const bool row_in = a - da >= 0 && a - da < H;
#pragma unroll
    for (int ts = 0; ts < 3; ++ts) {
      const int db = ts - 1;
      const bool in = row_in && b - db >= 0 && b - db < W;
      const T* ds = dy + (in ? (size_t)(p - da * W - db) * K : 0);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = in && k0 + cc + 32 * j < K;
        cp_async16(dst + (1 + ts) * TILE + 32 * j, ds + (ok ? k0 + cc + 32 * j : 0), ok);
      }
    }
  };

  float acc[2][6][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int steps = m_end > m_beg ? (m_end - m_beg + TW - 1) / TW : 0;
  if (steps > 0) {
    load(0, m_beg);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) {  // the next step loads while this one computes
      load(buf ^ 1, m_beg + (step + 1) * TW);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* X = S + buf * STAGE;
#pragma unroll
    for (int kk = 0; kk < TW / 16; ++kk) {
      uint32_t af[2][4], bf[3][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)  // x^T: [p][c] read transposed into [c][p]
        ldsm_x4_t(af[i], X + (16 * kk + at_row(lane)) * LDS + wc + 16 * i + at_col(lane));
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) {
        const int q = wq + jj;  // 16-column group: tap q / 4, k 16 (q % 4)..
        ldsm_x4_t(bf[jj], X + (1 + q / 4) * TILE + (16 * kk + bt_row(lane)) * LDS +
                              16 * (q % 4) + bt_col(lane));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 3; ++jj) {
          mma16816<T>(acc[i][2 * jj], af[i], bf[jj][0], bf[jj][1]);
          mma16816<T>(acc[i][2 * jj + 1], af[i], bf[jj][2], bf[jj][3]);
        }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

#pragma unroll
  for (int jj = 0; jj < 3; ++jj) {
    const int q = wq + jj, tap = 3 * tr + q / 4;
    float* out = ws + ((size_t)blockIdx.z * 9 + tap) * C * K;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + wc + 16 * i + g + 8 * h;
        if (c >= C) continue;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int kk = k0 + 16 * (q % 4) + 8 * n + 2 * t;
          if (kk < K)
            *reinterpret_cast<float2*>(out + (size_t)c * K + kk) =
                make_float2(acc[i][2 * jj + n][2 * h], acc[i][2 * jj + n][2 * h + 1]);
        }
      }
  }
}

// ------------------------------------------------------------ both routes
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

// dw[i] = sum over slices z, in order, of ws[z][i]; cast once to T.
template <typename T>
__global__ void conv3x3_wgrad_reduce(const float* __restrict__ ws, T* __restrict__ dw,
                                     int splits, size_t total) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[(size_t)z * total + i];
    dw[i] = from_f<T>(s);
  }
}

template <typename T>
cudaError_t reduce_slices(float* ws, void* dw, int C, int K, int splits, cudaStream_t stream) {
  const size_t total = (size_t)9 * C * K;
  const unsigned rblocks = (unsigned)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  conv3x3_wgrad_reduce<T><<<rblocks, 256, 0, stream>>>(ws, static_cast<T*>(dw), splits, total);
  return cudaGetLastError();
}

cudaError_t launch_fma(const void* x, const void* dy, const void* wd, void* dx, void* dw,
                       float* ws, int N, int H, int W, int C, int K, int splits, int chunk,
                       cudaStream_t stream) {
  const int M = N * H * W;
  const dim3 dgrid((unsigned)((M + TM - 1) / TM), (unsigned)((C + TN - 1) / TN));
  conv3x3_dgrad_fma<<<dgrid, NT, 0, stream>>>(static_cast<const float*>(dy),
                                               static_cast<const float*>(wd),
                                               static_cast<float*>(dx), N, H, W, C, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const unsigned tiles = (unsigned)(((C + TM - 1) / TM) * ((K + TN - 1) / TN));
  conv3x3_wgrad_fma<<<dim3(tiles, 9, (unsigned)splits), NT, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), ws, N, H, W, C, K, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_slices<float>(ws, dw, C, K, splits, stream);
}

template <typename T, int BM, int BN>
cudaError_t launch_dgrad_tc(const void* dy, const void* wd, void* dx, int H, int W, int C,
                            int K, int M, cudaStream_t stream) {
  const size_t smem = sizeof(T) * 2 * ((size_t)BM * LDS + (size_t)TW * (BN + 8));
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_dgrad_tc<T, BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((C + BN - 1) / BN));
  conv3x3_dgrad_tc<T, BM, BN><<<grid, TC_NT, smem, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(wd), static_cast<T*>(dx), H, W, C, K, M);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tc(const void* x, const void* dy, const void* wd, void* dx, void* dw,
                      float* ws, int N, int H, int W, int C, int K, int splits, int chunk,
                      cudaStream_t stream) {
  const int M = N * H * W;
  cudaError_t err = C > 64 ? launch_dgrad_tc<T, 128, 128>(dy, wd, dx, H, W, C, K, M, stream)
                           : launch_dgrad_tc<T, 256, 64>(dy, wd, dx, H, W, C, K, M, stream);
  if (err != cudaSuccess) return err;

  const size_t smem = sizeof(T) * 2 * 4 * (size_t)TW * LDS;
  err = cudaFuncSetAttribute(conv3x3_wgrad_tc<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned tiles = (unsigned)(((C + TW - 1) / TW) * ((K + TW - 1) / TW));
  conv3x3_wgrad_tc<T><<<dim3(tiles, 3, (unsigned)splits), TC_NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), ws, H, W, C, K, M, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_slices<T>(ws, dw, C, K, splits, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (FMA kernels), 1 = bfloat16, 2 = float16 (tensor-core
// kernels; x, dy, wd, dx and dw all of it). ws: splits * 9 * C * K fp32
// scratch; pixel slice z of the wgrad covers [z*chunk, (z+1)*chunk), so
// splits * chunk must reach N*H*W. The tensor-core route needs C and K to be
// multiples of 8 (16-byte rows). Returns the launches' cudaError_t (0 on
// success), launches on `stream` and does not synchronise.
int mxt_conv3x3_bwd(const void* x, const void* dy, const void* wd, void* dx, void* dw,
                    float* ws, int N, int H, int W, int C, int K, int splits, int chunk,
                    int dtype, int device, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || K <= 0 || splits <= 0 || chunk <= 0 ||
      (long long)splits * chunk < (long long)N * H * W)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && (C % 8 != 0 || K % 8 != 0)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch_fma(x, dy, wd, dx, dw, ws, N, H, W, C, K, splits, chunk, st); break;
    case 1:
      err = launch_tc<__nv_bfloat16>(x, dy, wd, dx, dw, ws, N, H, W, C, K, splits, chunk, st);
      break;
    case 2: err = launch_tc<__half>(x, dy, wd, dx, dw, ws, N, H, W, C, K, splits, chunk, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
