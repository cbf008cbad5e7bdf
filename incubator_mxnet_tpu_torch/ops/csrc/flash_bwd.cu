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
// operations bound both kernels, not bytes.
//
// Two routes, chosen by the input type (a routing, not a fallback):
//
// bf16 / fp16: tensor cores (flash_bwd_dkv_tc, flash_bwd_dq_tc). Every
// product is mma.sync.m16n8k16 with fp32 accumulators, its operands read
// from shared memory with ldmatrix. Rounding points, mirrored by the plain
// version (_fa_bwd_reference): p is rounded to the input type before
// p^T dO; ds is computed in fp32 from the unrounded p and rounded before
// ds^T q and ds k. In exact arithmetic nothing else changes.
//  * A CTA of 8 warps owns one (batch*head, 64-row tile): a kv tile in K2, a
//    q tile in K3; the TPU kernels' sequential grid axis becomes a loop over
//    the other tiles inside the CTA. Warp w owns tile rows 16*(w%4).. and
//    half h = w/4 of each streamed tile's 64 rows, so the four products of a
//    step are split over the warps with no product computed twice. Each
//    warp's gradient rows are a partial sum over its half; the two halves
//    are added once at the end through shared memory, each warp of a pair
//    writing one half of the result (K2: h 0 dV, h 1 dK; K3: h owns D
//    columns [h*D/2, (h+1)*D/2)).
//  * Register reuse. K2 computes S^T = K Q^T and dP^T = V dO^T with kv rows
//    as M, so P^T and dS^T leave the fp32 accumulators directly as the bf16
//    A fragments of dV += P^T dO and dK += dS^T Q; K3 does the same with dS
//    for dQ += dS K. lse and delta are read by each accumulator element's
//    column (K2, from shared memory) or row (K3, in registers), and the
//    causal mask and the S edge use the element's (row, column) from the
//    lane id.
//  * Tiles stay in the input type in shared memory with a row stride of
//    D + 8 elements, so the 8 rows an ldmatrix reads fall on distinct bank
//    groups. Operands whose reduction axis is the row (dO and Q as B of dV
//    and dK, K as B of dQ) are read with ldmatrix.trans.
//  * The streamed tiles (K2: q, dO, lse, delta; K3: k, v) are double
//    buffered with cp.async: the next tile's 16-byte (lse, delta: 4-byte)
//    copies are in flight while the current one computes. Rows past S are
//    zero-filled by the copies' source size.
//  * Shared memory at D = 128: K2 105,472 bytes, K3 104,448 (two CTAs' worth
//    of shared memory fits an SM; registers keep one CTA of 8 warps there).
//  * Causal: tiles wholly above the diagonal are neither loaded nor
//    computed. CTAs are numbered so that the tiles with the most work start
//    first, and adjacent CTAs share a tile index over batch*head.
//  * Deterministic: dQ stays in its own kernel instead of being added
//    atomically by K2, at the cost of recomputing s and dp there (14 flops
//    per pair and D for the pair, against 10 for a fused kernel).
//
// fp32: the first, FMA kernels (flash_bwd_dkv_fma, flash_bwd_dq_fma), fp32
// shared-memory tiles with a padded stride and 256 threads as a 16x16 grid.
// TF32 tensor cores would not keep fp32's agreement with the plain version.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BT = 64;    // rows of a q or kv tile
constexpr int NT = 256;   // threads per CTA
constexpr int LDP = BT + 1;

// ------------------------------------------------------------ fp32 route
// Stage rows [r0, r0 + 64) of one (S, D) matrix into shared memory, zero
// past S.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int r0, int S) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < BT * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int row = r0 + r;
    dst[r * LD + c] = row < S ? src[(size_t)row * D + c] : 0.f;
  }
}

// Write a 64 x D register tile (rows ty + 16*i, columns tx + 16*j) to rows
// [r0, r0 + 64) of an (S, D) matrix.
template <int D>
__device__ __forceinline__ void store_tile(float* __restrict__ dst, float (&acc)[4][D / 16],
                                           int r0, int S) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= S) continue;
    float* o = dst + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) o[tx + 16 * j] = acc[i][j];
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

// K2, fp32: dK, dV of one (batch*head, kv tile).
template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_fma(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int BH, int S,
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

  load_tile<D>(Ks, k + base, k0, S);
  load_tile<D>(Vs, v + base, k0, S);

  float dKa[4][DJ], dVa[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dKa[i][j] = dVa[i][j] = 0.f;

  for (int qt = causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();  // the previous step is done with Qs, dOs, Ps, dSs, rows
    load_tile<D>(Qs, q + base, q0, S);
    load_tile<D>(dOs, dout + base, q0, S);
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

  store_tile<D>(dk + base, dKa, k0, S);
  store_tile<D>(dv + base, dVa, k0, S);
}

// K3, fp32: dQ of one (batch*head, q tile).
template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_fma(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int BH, int S, int nq, float scale,
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

  load_tile<D>(Qs, q + base, q0, S);
  load_tile<D>(dOs, dout + base, q0, S);
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
    load_tile<D>(Ks, k + base, k0, S);
    load_tile<D>(Vs, v + base, k0, S);
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

  store_tile<D>(dq + base, dQa, q0, S);
}

// ----------------------------------------------------- tensor-core route
constexpr int TC_WARPS = 8;
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

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
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

// Copy rows [r0, r0 + 64) of an (S, D) matrix into a tile of row stride
// D + 8, 16 bytes a copy, rows past S zero-filled.
template <typename T, int D>
__device__ __forceinline__ void tile_async(T* dst, const T* __restrict__ src, int r0, int S) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int LD = D + 8;
  for (int i = threadIdx.x; i < BT * CH; i += TC_NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const int row = r0 + r;
    const bool ok = row < S;
    cp_async16(dst + r * LD + c, src + (size_t)(ok ? row : 0) * D + c, ok);
  }
}

// The two score products of one warp: acc1 (16 x 32) = X1[16 rows] Y1^T and
// acc2 = X2 Y2^T over D, with X row-major tiles at row xr and Y row-major
// [n][d] tiles at row yr (32 rows), as mma n8 tiles j = 0..3.
template <typename T, int D>
__device__ __forceinline__ void score_pair(float (&acc1)[4][4], float (&acc2)[4][4],
                                           const T* X1, const T* Y1, const T* X2,
                                           const T* Y2, int xr, int yr, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[j][e] = acc2[j][e] = 0.f;
  const int xo = (xr + a_row(lane)) * LD + a_col(lane);
  const int yo = (yr + bn_row(lane)) * LD + bn_col(lane);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], b[4];
    ldsm_x4(a, X1 + xo + 16 * kk);
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      ldsm_x4(b, Y1 + yo + 16 * nn * LD + 16 * kk);
      mma16816<T>(acc1[2 * nn], a, b[0], b[1]);
      mma16816<T>(acc1[2 * nn + 1], a, b[2], b[3]);
    }
    ldsm_x4(a, X2 + xo + 16 * kk);
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      ldsm_x4(b, Y2 + yo + 16 * nn * LD + 16 * kk);
      mma16816<T>(acc2[2 * nn], a, b[0], b[1]);
      mma16816<T>(acc2[2 * nn + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x D, n8 tiles) += A (16 x 32, two k16 A fragments) Z[32 rows][D]
// with Z a row-major [k][n] tile from row zr (read transposed).
template <typename T, int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4], const uint32_t (&a)[2][4],
                                           const T* Z, int zr, int lane) {
  constexpr int LD = D + 8;
  const int zo = (zr + bt_row(lane)) * LD + bt_col(lane);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn) {
      uint32_t b[4];
      ldsm_x4_t(b, Z + zo + 16 * kk * LD + 16 * nn);
      mma16816<T>(acc[2 * nn], a[kk], b[0], b[1]);
      mma16816<T>(acc[2 * nn + 1], a[kk], b[2], b[3]);
    }
}

// p, ds of one accumulator element with the masking rules above; lse = -inf
// only where every s of the row is -inf, and then p = 0 as well.
__device__ __forceinline__ void tc_p_ds(float dot, float dpv, float lse, float delta,
                                        bool keep, float scale, float& p, float& ds) {
  const float s = dot * scale;
  p = (keep && isfinite(s) && isfinite(lse)) ? __expf(s - lse) : 0.f;
  ds = p * (dpv - delta) * scale;
}

// Store accumulator n8 tiles [j0, j1) of a warp's 16 rows (row0 + g, + 8)
// to an (S, D) matrix in the input type.
template <typename T, int D>
__device__ __forceinline__ void store_frag(T* __restrict__ dst, const float (&acc)[D / 8][4],
                                           int row0, int S, int j0, int j1, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (j < j0 || j >= j1) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + g + 8 * half;
      if (row < S)
        *reinterpret_cast<uint32_t*>(dst + (size_t)row * D + 8 * j + 2 * t) =
            pack2<T>(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

// K2, bf16/fp16: dK, dV of one (batch*head, 64-row kv tile). Warp w: kv
// rows 16 (w % 4).., q rows 32 (w / 4).. of each streamed q tile.
template <typename T, int D>
__global__ void __launch_bounds__(TC_NT, 1)
flash_bwd_dkv_tc(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                 int BH, int S, float scale, int causal) {
  constexpr int LD = D + 8, TILE = BT * LD, DN = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + TILE;
  T* Qs = Vs + TILE;                                  // [2][TILE]
  T* dOs = Qs + 2 * TILE;                             // [2][TILE]
  float* rows = reinterpret_cast<float*>(dOs + 2 * TILE);  // [2][lse BT, delta BT]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = 16 * (warp & 3), h = warp >> 2, wq = 32 * h;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x % BH;
  const int kt = blockIdx.x / BH;  // causal: low kv tiles have the most q tiles
  const int k0 = kt * BT;
  const int nq = (S + BT - 1) / BT;
  const size_t base = (size_t)bh * S * D;
  const float* lse_b = lse + (size_t)bh * S;
  const float* delta_b = delta + (size_t)bh * S;

  auto load_q = [&](int buf, int q0) {
    tile_async<T, D>(Qs + buf * TILE, q + base, q0, S);
    tile_async<T, D>(dOs + buf * TILE, dout + base, q0, S);
    if (threadIdx.x < 2 * BT) {
      const int i = threadIdx.x & (BT - 1), row = q0 + i;
      const bool ok = row < S;
      cp_async4(rows + buf * 2 * BT + threadIdx.x,
                (threadIdx.x < BT ? lse_b : delta_b) + (ok ? row : 0), ok);
    }
  };

  const int qt0 = causal ? kt : 0;
  tile_async<T, D>(Ks, k + base, k0, S);
  tile_async<T, D>(Vs, v + base, k0, S);
  load_q(0, qt0 * BT);
  cp_async_commit();

  float dKa[DN][4], dVa[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dKa[j][e] = dVa[j][e] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int buf = (qt - qt0) & 1, q0 = qt * BT;
    if (qt + 1 < nq) {
      load_q(buf ^ 1, q0 + BT);  // the next tile loads while this one computes
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qc = Qs + buf * TILE;
    const T* dOc = dOs + buf * TILE;
    const float* lse_c = rows + buf * 2 * BT;
    const float* delta_c = lse_c + BT;

    // S^T = K Q^T and dP^T = V dO^T: kv rows wr.. against q rows wq..
    float st[4][4], dpt[4][4];
    score_pair<T, D>(st, dpt, Ks, Qc, Vs, dOc, wr, wq, lane);

    // P^T and dS^T straight from the accumulators into A fragments: n8 tile
    // j is half (j % 2) of k16 fragment j / 2.
    uint32_t pa[2][4], dsa[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = wq + 8 * j + 2 * t + (e & 1);   // row of the q tile
        const int qr = q0 + qc;
        const int kr = k0 + wr + g + 8 * (e >> 1);
        const bool keep = kr < S && qr < S && !(causal && qr < kr);
        tc_p_ds(st[j][e], dpt[j][e], lse_c[qc], delta_c[qc], keep, scale, p[e], ds[e]);
      }
      pa[j >> 1][2 * (j & 1)] = pack2<T>(p[0], p[1]);
      pa[j >> 1][2 * (j & 1) + 1] = pack2<T>(p[2], p[3]);
      dsa[j >> 1][2 * (j & 1)] = pack2<T>(ds[0], ds[1]);
      dsa[j >> 1][2 * (j & 1) + 1] = pack2<T>(ds[2], ds[3]);
    }

    accumulate<T, D>(dVa, pa, dOc, wq, lane);   // dV += P^T dO
    accumulate<T, D>(dKa, dsa, Qc, wq, lane);   // dK += dS^T Q
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  // Add the two halves' partial sums: warp h = 0 hands its dK to its partner
  // and writes dV, h = 1 hands over dV and writes dK. The q and dO buffers
  // (no copy is in flight any more) hold the exchange, in fragment order.
  float* xch = reinterpret_cast<float*>(Qs);
  float* mine = xch + (size_t)warp * DN * 4 * 32;
  const float* theirs = xch + (size_t)(warp ^ 4) * DN * 4 * 32;
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mine[(j * 4 + e) * 32 + lane] = h == 0 ? dKa[j][e] : dVa[j][e];
  __syncthreads();
  if (h == 0) {
#pragma unroll
    for (int j = 0; j < DN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dVa[j][e] += theirs[(j * 4 + e) * 32 + lane];
    store_frag<T, D>(dv + base, dVa, k0 + wr, S, 0, DN, lane);
  } else {
#pragma unroll
    for (int j = 0; j < DN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dKa[j][e] += theirs[(j * 4 + e) * 32 + lane];
    store_frag<T, D>(dk + base, dKa, k0 + wr, S, 0, DN, lane);
  }
}

// K3, bf16/fp16: dQ of one (batch*head, 64-row q tile). Warp w: q rows
// 16 (w % 4).., kv rows 32 (w / 4).. of each streamed kv tile.
template <typename T, int D>
__global__ void __launch_bounds__(TC_NT, 1)
flash_bwd_dq_tc(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int BH, int S, int nq,
                float scale, int causal) {
  constexpr int LD = D + 8, TILE = BT * LD, DN = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + TILE;
  T* Ks = dOs + TILE;      // [2][TILE]
  T* Vs = Ks + 2 * TILE;   // [2][TILE]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = 16 * (warp & 3), h = warp >> 2, wk = 32 * h;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x % BH;
  const int qt = nq - 1 - (int)(blockIdx.x / BH);  // causal: high q tiles first
  const int q0 = qt * BT;
  const size_t base = (size_t)bh * S * D;

  tile_async<T, D>(Qs, q + base, q0, S);
  tile_async<T, D>(dOs, dout + base, q0, S);
  tile_async<T, D>(Ks, k + base, 0, S);
  tile_async<T, D>(Vs, v + base, 0, S);
  cp_async_commit();

  // lse and delta of this thread's two rows (g, g + 8 of the warp's 16)
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + wr + g + 8 * half;
    lse_r[half] = row < S ? lse[(size_t)bh * S + row] : 0.f;
    delta_r[half] = row < S ? delta[(size_t)bh * S + row] : 0.f;
  }

  float dQa[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dQa[j][e] = 0.f;

  const int nk = (S + BT - 1) / BT;
  const int kt_end = causal ? min(nk, qt + 1) : nk;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int buf = kt & 1, k0 = kt * BT;
    if (kt + 1 < kt_end) {
      tile_async<T, D>(Ks + (buf ^ 1) * TILE, k + base, k0 + BT, S);
      tile_async<T, D>(Vs + (buf ^ 1) * TILE, v + base, k0 + BT, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kc = Ks + buf * TILE;
    const T* Vc = Vs + buf * TILE;

    // S = Q K^T and dP = dO V^T: q rows wr.. against kv rows wk..
    float s[4][4], dp[4][4];
    score_pair<T, D>(s, dp, Qs, Kc, dOs, Vc, wr, wk, lane);

    uint32_t dsa[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = q0 + wr + g + 8 * (e >> 1);
        const int kr = k0 + wk + 8 * j + 2 * t + (e & 1);
        const bool keep = kr < S && qr < S && !(causal && qr < kr);
        float p;  // only dS enters dQ
        tc_p_ds(s[j][e], dp[j][e], lse_r[e >> 1], delta_r[e >> 1], keep, scale, p, ds[e]);
      }
      dsa[j >> 1][2 * (j & 1)] = pack2<T>(ds[0], ds[1]);
      dsa[j >> 1][2 * (j & 1) + 1] = pack2<T>(ds[2], ds[3]);
    }

    accumulate<T, D>(dQa, dsa, Kc, wk, lane);   // dQ += dS K
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  // Add the two halves' partial sums: warp h writes D columns
  // [h D/2, (h+1) D/2) and hands the other half to its partner.
  float* xch = reinterpret_cast<float*>(Ks);
  float* mine = xch + (size_t)warp * (DN / 2) * 4 * 32;
  const float* theirs = xch + (size_t)(warp ^ 4) * (DN / 2) * 4 * 32;
#pragma unroll
  for (int j = 0; j < DN; ++j) {
    const bool given = (j < DN / 2) != (h == 0);
    if (given) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[((j % (DN / 2)) * 4 + e) * 32 + lane] = dQa[j][e];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < DN; ++j) {
    const bool kept = (j < DN / 2) == (h == 0);
    if (kept) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dQa[j][e] += theirs[((j % (DN / 2)) * 4 + e) * 32 + lane];
    }
  }
  store_frag<T, D>(dq + base, dQa, q0 + wr, S, h * DN / 2, (h + 1) * DN / 2, lane);
}

// ----------------------------------------------------------------- launch
template <int D>
cudaError_t launch_dkv_fma(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dk, void* dv,
                           int BH, int S, float scale, int causal, cudaStream_t stream) {
  const int nk = (S + BT - 1) / BT;
  const size_t smem = sizeof(float) * (4 * (size_t)BT * (D + 1) + 2 * (size_t)BT * LDP + 2 * BT);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_fma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_fma<D><<<dim3((unsigned)nk * (unsigned)BH), NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), BH, S, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_fma(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dq, int BH, int S,
                          float scale, int causal, cudaStream_t stream) {
  const int nq = (S + BT - 1) / BT;
  const size_t smem = sizeof(float) * (4 * (size_t)BT * (D + 1) + (size_t)BT * LDP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_fma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_fma<D><<<dim3((unsigned)nq * (unsigned)BH), NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dq), BH, S, nq, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dk, void* dv, int BH,
                          int S, float scale, int causal, cudaStream_t stream) {
  const int nk = (S + BT - 1) / BT;
  const size_t smem = sizeof(T) * 6 * (size_t)BT * (D + 8) + sizeof(float) * 4 * BT;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tc<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_tc<T, D><<<dim3((unsigned)nk * (unsigned)BH), TC_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      BH, S, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dq, int BH, int S,
                         float scale, int causal, cudaStream_t stream) {
  const int nq = (S + BT - 1) / BT;
  const size_t smem = sizeof(T) * 6 * (size_t)BT * (D + 8);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_tc<T, D><<<dim3((unsigned)nq * (unsigned)BH), TC_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), BH, S, nq, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dk, void* dv, int BH, int S,
                   int D, float scale, int causal, cudaStream_t st) {
  if (D == 64) return launch_dkv_tc<T, 64>(q, k, v, dout, lse, delta, dk, dv, BH, S, scale, causal, st);
  if (D == 128) return launch_dkv_tc<T, 128>(q, k, v, dout, lse, delta, dk, dv, BH, S, scale, causal, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dq_tc(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dq, int BH, int S, int D,
                  float scale, int causal, cudaStream_t st) {
  if (D == 64) return launch_dq_tc<T, 64>(q, k, v, dout, lse, delta, dq, BH, S, scale, causal, st);
  if (D == 128) return launch_dq_tc<T, 128>(q, k, v, dout, lse, delta, dq, BH, S, scale, causal, st);
  return cudaErrorInvalidValue;
}

cudaError_t dkv_fma(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int BH, int S,
                    int D, float scale, int causal, cudaStream_t st) {
  if (D == 64) return launch_dkv_fma<64>(q, k, v, dout, lse, delta, dk, dv, BH, S, scale, causal, st);
  if (D == 128) return launch_dkv_fma<128>(q, k, v, dout, lse, delta, dk, dv, BH, S, scale, causal, st);
  return cudaErrorInvalidValue;
}

cudaError_t dq_fma(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, int BH, int S, int D,
                   float scale, int causal, cudaStream_t st) {
  if (D == 64) return launch_dq_fma<64>(q, k, v, dout, lse, delta, dq, BH, S, scale, causal, st);
  if (D == 128) return launch_dq_fma<128>(q, k, v, dout, lse, delta, dq, BH, S, scale, causal, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (FMA kernels), 1 = bfloat16, 2 = float16 (tensor-core
// kernels). Each returns the launch's cudaError_t (0 on success), launches
// on `stream` and does not synchronise.
int mxt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dk, void* dv, int BH,
                      int S, int D, float scale, int causal, int dtype, int device,
                      void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = dkv_fma(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale, causal, st); break;
    case 1: err = dkv_tc<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale, causal, st); break;
    case 2: err = dkv_tc<__half>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale, causal, st); break;
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
    case 0: err = dq_fma(q, k, v, dout, lse, delta, dq, BH, S, D, scale, causal, st); break;
    case 1: err = dq_tc<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, BH, S, D, scale, causal, st); break;
    case 2: err = dq_tc<__half>(q, k, v, dout, lse, delta, dq, BH, S, D, scale, causal, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
