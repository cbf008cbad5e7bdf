// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel incubator_mxnet_tpu/ops/attention.py:_fa_kernel
// (launched by _fa_call). It computes, for q, k, v of shape (B*H, S, D):
//   s = scale * q k^T in fp32, masked to -inf above the diagonal (causal)
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
//
// Two routes, chosen by the input type (a routing, not a fallback):
//
// bf16 / fp16: tensor cores (flash_fwd_tc), FlashAttention-2 style.
//  * A CTA of 8 warps owns one (batch*head, 128-row q tile), 16 q rows a
//    warp; the TPU kernel's sequential grid axis over K/V blocks becomes a
//    loop over 64-row K/V tiles inside the CTA, so m, l and the output
//    accumulator live in registers for the whole loop.
//  * Both products are mma.sync.m16n8k16 with fp32 accumulators. Q's A
//    fragments are read once with ldmatrix and stay in registers; K is read
//    with plain ldmatrix for S = Q K^T, V with ldmatrix.trans for O += P V.
//    The score accumulator is scaled after the product (q is not rounded
//    again), and the mask overwrites it (never adds), so a zero-filled K
//    row past S cannot turn a -inf q row's score into NaN.
//  * The online softmax runs on the accumulators, in log2 units (scores
//    times scale * log2 e, one ex2 an exponential): each thread holds two
//    rows (g, g + 8 of its warp's 16), row max and row sum take two quad
//    shuffles. l sums the unrounded fp32 p. P then leaves the accumulators
//    straight as bf16/fp16 A fragments of P V (no shared memory).
//  * Rounding: p is rounded to the input type before P V, relative to the
//    running max (as FA2 and SDPA do; the TPU kernel keeps p in fp32), and
//    out once when it is written. Nothing else is rounded. out leaves
//    through the warp's rows of the Q tile as 16-byte stores.
//  * Tiles stay in the input type in shared memory with a row stride of
//    D + 8 elements (the 8 rows an ldmatrix reads fall on distinct bank
//    groups). K and V are double buffered with 16-byte cp.async copies: the
//    next tile's copies are in flight while the current tile computes; rows
//    past S are zero-filled by the copies' source size. 104,448 bytes of
//    shared memory at D = 128 (55,296 at D = 64).
//  * Causal: the loop ends at the diagonal; a warp whose 16 rows all lie
//    above a K/V tile skips its products for it. CTAs are numbered so that
//    the q tiles with the most K/V tiles start first.
//  * Deterministic: no atomics, no split over K/V.
//
// fp32: the first, FMA kernel (flash_fwd_fma): fp32 shared-memory tiles with
// a padded stride, 256 threads as a 16x16 grid, q pre-scaled in fp32. TF32
// tensor cores would not keep fp32's agreement with the plain version.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ------------------------------------------------------------ fp32 route
constexpr int BM = 64;    // q rows per CTA
constexpr int BN = 64;    // kv rows per loop step
constexpr int NT = 256;   // threads per CTA
constexpr int LDP = BN + 1;

// Stage rows [r0, r0 + 64) of one (S, D) matrix into shared memory times
// `mul`, zero past S.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int r0, int S, float mul) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int row = r0 + r;
    dst[r * LD + c] = row < S ? src[(size_t)row * D + c] * mul : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int S, int nq, float scale, int causal) {
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

  load_tile<D>(Qs, q + base, q0, S, scale);

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
    load_tile<D>(KVs, k + base, k0, S, 1.f);
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
    load_tile<D>(KVs, v + base, k0, S, 1.f);
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
    float* o = out + base + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[tx + 16 * j] = acc[i][j] / li;
    if (tx == 0) lse[(size_t)bh * S + row] = m[i] + logf(li);
  }
}

// ----------------------------------------------------- tensor-core route
constexpr int TC_BM = 128;             // q rows per CTA, 16 a warp
constexpr int TC_BN = 64;              // kv rows per loop step
constexpr int TC_WARPS = TC_BM / 16;
constexpr int TC_NT = 32 * TC_WARPS;

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// 2^x (the instruction __expf uses after its multiply by log2 e)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Fragment addressing (m16n8k16; g = lane / 4, t = lane % 4). An
// accumulator tile holds (row g, cols 2t, 2t+1) in c0, c1 and row g + 8 in
// c2, c3. A 16x16 A tile of a row-major matrix at (r0, c0): lane l reads
// row r0 + l % 16 at column c0 + 8 (l / 16). B tiles for two n8 tiles at
// n0, n0 + 8 and k16 at k0: from a [n][k] matrix (no trans) lane l reads
// row n0 + l % 8 + 8 (l / 16) at k0 + 8 ((l / 8) % 2); from a [k][n] matrix
// (trans) row k0 + l % 8 + 8 ((l / 8) % 2) at n0 + 8 (l / 16). Either way
// r0, r1 are the (b0, b1) of the n tile at n0, r2, r3 those at n0 + 8.
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) << 3; }
__device__ __forceinline__ int bn_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int bn_col(int lane) { return ((lane >> 3) & 1) << 3; }
__device__ __forceinline__ int bt_row(int lane) { return (lane & 7) + (((lane >> 3) & 1) << 3); }
__device__ __forceinline__ int bt_col(int lane) { return (lane >> 4) << 3; }

// Copy rows [r0, r0 + rows) of an (S, D) matrix into a tile of row stride
// D + 8, 16 bytes a copy, rows past S zero-filled.
template <typename T, int D>
__device__ __forceinline__ void tile_async(T* dst, const T* __restrict__ src, int r0, int rows,
                                           int S) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int LD = D + 8;
  for (int i = threadIdx.x; i < rows * CH; i += TC_NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const int row = r0 + r;
    const bool ok = row < S;
    cp_async16(dst + r * LD + c, src + (size_t)(ok ? row : 0) * D + c, ok);
  }
}

// bf16/fp16: out, lse of one (batch*head, 128-row q tile). Warp w owns q
// rows 16 w .. 16 w + 15 of the tile.
template <typename T, int D>
__global__ void __launch_bounds__(TC_NT, 1)
flash_fwd_tc(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, float* __restrict__ lse, int BH, int S, int nq, float scale,
             int causal) {
  constexpr int LD = D + 8, KV_TILE = TC_BN * LD, DK = D / 16, DN = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // TC_BM x LD
  T* Ks = Qs + TC_BM * LD;                   // [2][KV_TILE]
  T* Vs = Ks + 2 * KV_TILE;                  // [2][KV_TILE]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = 16 * warp;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x % BH;
  const int qt = nq - 1 - (int)(blockIdx.x / BH);  // causal: high q tiles first
  const int q0 = qt * TC_BM;
  const size_t base = (size_t)bh * S * D;
  const int nk = (S + TC_BN - 1) / TC_BN;
  const int kt_end = causal ? min(nk, (q0 + TC_BM - 1) / TC_BN + 1) : nk;
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};  // this thread's two q rows

  tile_async<T, D>(Qs, q + base, q0, TC_BM, S);
  tile_async<T, D>(Ks, k + base, 0, TC_BN, S);
  tile_async<T, D>(Vs, v + base, 0, TC_BN, S);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qa[DK][4];  // Q's A fragments, for the whole loop
#pragma unroll
  for (int kk = 0; kk < DK; ++kk)
    ldsm_x4(qa[kk], Qs + (wr + a_row(lane)) * LD + a_col(lane) + 16 * kk);

  float o[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // the softmax runs in log2 units: scores times scale * log2 e, so each
  // exponential is one ex2; lse returns to natural units at the end
  const float scale2 = scale * 1.4426950408889634f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  for (int kt = 0; kt < kt_end; ++kt) {
    const int buf = kt & 1, k0 = kt * TC_BN;
    if (kt + 1 < kt_end) {  // the next tile loads while this one computes
      tile_async<T, D>(Ks + (buf ^ 1) * KV_TILE, k + base, k0 + TC_BN, TC_BN, S);
      tile_async<T, D>(Vs + (buf ^ 1) * KV_TILE, v + base, k0 + TC_BN, TC_BN, S);
      cp_async_commit();
    }
    const T* Kc = Ks + buf * KV_TILE;
    const T* Vc = Vs + buf * KV_TILE;

    if (!causal || k0 <= q0 + wr + 15) {  // some of this warp's rows see the tile
      // S = Q K^T: the warp's 16 rows against the tile's 64 kv rows (n8 tiles j)
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      const int ko = bn_row(lane) * LD + bn_col(lane);
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          uint32_t b[4];
          ldsm_x4(b, Kc + ko + 16 * nn * LD + 16 * kk);
          mma16816<T>(s[2 * nn], qa[kk], b[0], b[1]);
          mma16816<T>(s[2 * nn + 1], qa[kk], b[2], b[3]);
        }

      // scale, mask (overwrite; only tiles that reach past S or the
      // diagonal), row max over the quad
      const bool edge = k0 + TC_BN > S || (causal && k0 + TC_BN - 1 > q0 + wr);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const float x = edge && (col >= S || (causal && col > rows[e >> 1]))
                              ? -INFINITY
                              : s[j][e] * scale2;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float m_safe[2], alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_r[h], mx[h]);
        m_safe[h] = isfinite(m_new) ? m_new : 0.f;
        alpha[h] = isfinite(m_r[h]) ? ex2(m_r[h] - m_safe[h]) : 0.f;
        if (isnan(alpha[h])) alpha[h] = 0.f;
        m_r[h] = m_new;
      }

      // p in fp32 for l; rounded to the input type as P's A fragments: n8
      // tile j is half (j % 2) of k16 fragment j / 2
      float rs[2] = {0.f, 0.f};
      uint32_t pa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = isfinite(s[j][e]) ? ex2(s[j][e] - m_safe[e >> 1]) : 0.f;
          rs[e >> 1] += p[e];
        }
        pa[j >> 1][2 * (j & 1)] = pack2<T>(p[0], p[1]);
        pa[j >> 1][2 * (j & 1) + 1] = pack2<T>(p[2], p[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
        l_r[h] = l_r[h] * alpha[h] + rs[h];
      }
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }

      // O += P V, V read transposed ([kv][d] is [k][n])
      const int vo = bt_row(lane) * LD + bt_col(lane);
#pragma unroll
      for (int kk = 0; kk < TC_BN / 16; ++kk)
#pragma unroll
        for (int nn = 0; nn < D / 16; ++nn) {
          uint32_t b[4];
          ldsm_x4_t(b, Vc + vo + 16 * kk * LD + 16 * nn);
          mma16816<T>(o[2 * nn], pa[kk], b[0], b[1]);
          mma16816<T>(o[2 * nn + 1], pa[kk], b[2], b[3]);
        }
    }
    cp_async_wait_all();  // the next tile has landed ...
    __syncthreads();      // ... and every warp is done with this one
  }

  // out leaves through the warp's own 16 rows of the Q tile (read only
  // before the loop), so that each row is written with 16-byte stores
  T* Os = Qs + wr * LD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float li = fmaxf(l_r[h], 1e-37f);
#pragma unroll
    for (int j = 0; j < DN; ++j)
      *reinterpret_cast<uint32_t*>(Os + (g + 8 * h) * LD + 8 * j + 2 * t) =
          pack2<T>(o[j][2 * h] / li, o[j][2 * h + 1] / li);
    if (t == 0 && rows[h] < S)
      lse[(size_t)bh * S + rows[h]] = m_r[h] * 0.6931471805599453f + logf(li);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * DN; i += 32) {
    const int r = i / DN, c = (i % DN) * 8;
    if (q0 + wr + r < S)
      *reinterpret_cast<uint4*>(out + base + (size_t)(q0 + wr + r) * D + c) =
          *reinterpret_cast<const uint4*>(Os + r * LD + c);
  }
}

// ----------------------------------------------------------------- launch
template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* out, float* lse,
                       int BH, int S, float scale, int causal, cudaStream_t stream) {
  const int nq = (S + BM - 1) / BM;
  const size_t smem = sizeof(float) * ((size_t)(BM + BN) * (D + 1) + (size_t)BM * LDP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_fma<D><<<dim3((unsigned)nq * (unsigned)BH), NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, S, nq, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, float* lse,
                      int BH, int S, float scale, int causal, cudaStream_t stream) {
  const int nq = (S + TC_BM - 1) / TC_BM;
  const size_t smem = sizeof(T) * (size_t)(TC_BM + 4 * TC_BN) * (D + 8);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_tc<T, D><<<dim3((unsigned)nq * (unsigned)BH), TC_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, BH, S, nq, scale, causal);
  return cudaGetLastError();
}

cudaError_t fwd_fma(const void* q, const void* k, const void* v, void* out, float* lse, int BH,
                    int S, int D, float scale, int causal, cudaStream_t st) {
  if (D == 64) return launch_fma<64>(q, k, v, out, lse, BH, S, scale, causal, st);
  if (D == 128) return launch_fma<128>(q, k, v, out, lse, BH, S, scale, causal, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t fwd_tc(const void* q, const void* k, const void* v, void* out, float* lse, int BH,
                   int S, int D, float scale, int causal, cudaStream_t st) {
  if (D == 64) return launch_tc<T, 64>(q, k, v, out, lse, BH, S, scale, causal, st);
  if (D == 128) return launch_tc<T, 128>(q, k, v, out, lse, BH, S, scale, causal, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16, 2 = float16 (tensor-core
// kernel). Returns the launch's cudaError_t (0 on success). Launches on
// `stream` and does not synchronise.
int mxt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  float* lse, int BH, int S, int D, float scale, int causal,
                  int dtype, int device, void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = fwd_fma(q, k, v, out, lse, BH, S, D, scale, causal, st); break;
    case 1: err = fwd_tc<__nv_bfloat16>(q, k, v, out, lse, BH, S, D, scale, causal, st); break;
    case 2: err = fwd_tc<__half>(q, k, v, out, lse, BH, S, D, scale, causal, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
