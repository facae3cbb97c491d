// Pieces shared by the flash-attention kernels (flash_fwd.cu: K3 and K4,
// flash_bwd.cu: K5 and K6) and the paged kernels (paged_verify.cu: K2;
// the mbarriers and bulk copies also paged_decode.cu: K1).
//
// Flash operands are [b, t, h, dh] views given as pointer + (batch, time,
// head) element strides with dh contiguous, so a kernel reads the q/k/v
// column blocks of a [b, t, 3d] projection in place.  Rows at or past t
// are zero-filled, never read.
//
// Two arithmetic routes, chosen by the input dtype:
// * bf16: tensor cores.  K3-K6 run wgmma on TMA tiles (flash_hopper.cuh);
//   K2 runs mma.sync m16n8k16 fragments (bf16 in, f32 accumulate, the
//   helpers below) in the PTX ISA's documented layouts: a warp owns 16
//   rows, the f32 accumulator of one product turns into the A fragment
//   of the next (P) without shared memory, and B fragments that need a
//   transpose come from ldmatrix.trans.
// * f32 (tests, parity checks; the bf16 forward and backward run wgmma at
//   every head dim up to 512, and the bf16 forward up to 2048 on a
//   thread-block cluster): f32 tiles in shared memory and plain FMAs
//   (`mm`), so a run has f32 products of its inputs throughout.
//   Past 256 (any multiple of 64) in f32, and in bf16 where no wgmma
//   build takes the head dim (rounded where the bf16 kernels round), the
//   same arithmetic runs chunked: score sums walk the head dim 64 columns
//   at a time, and each block owns 128 output columns (`kDhChunk`,
//   `kOutCols`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr float kNeg = -1e30f;  // the reference's finite "-inf" for masked scores
constexpr float kPos = 1e30f;   // LSE of a row with no unmasked key (p == 0 in bwd)

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// max / sum over the 4 lanes of a quad (the lanes holding one fragment row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// mbarriers (one arrival, the thread that posts the expected bytes) and
// copies that complete on them: the flash kernels' TMA tiles
// (flash_hopper.cuh) and the paged kernels' bulk copies of pages and rows
// (paged_decode.cu, paged_verify.cu)
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// global -> shared by the copy engine, completing on mbarrier `bar`
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// (batch, time, head) element strides of one [b, t, h, dh] operand
struct Strides {
  long long b, t, h;
};

// Stage rows [r0, r0 + R) of one (batch, head) slice into `dst` (row
// pitch LD elements) with 16-byte loads by NT threads; rows at or past t
// are zero.  `src` points at row 0 of the slice, `st` is the time stride.
template <typename T, int R, int DH, int LD, int NT>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long st,
                                          int r0, int t) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kVpr = DH / kVec;
  for (int c = threadIdx.x; c < R * kVpr; c += NT) {
    const int r = c / kVpr;
    const int w = c - r * kVpr;
    const int row = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < t) val = reinterpret_cast<const uint4*>(src + (long long)row * st)[w];
    *reinterpret_cast<uint4*>(dst + r * LD + w * kVec) = val;
  }
}

// ---------------------------------------------------------------------------
// plain route: f32 tiles in shared memory
// ---------------------------------------------------------------------------
constexpr int kF32Threads = 256;   // 8 warps
constexpr int kF32Warps = kF32Threads / 32;
constexpr int kF32Tile = 32;       // rows per tile (queries and keys)

// load_rows into an f32 tile from T rows (bf16 widened as it lands).
template <typename T, int R, int DH, int LD, int NT>
__device__ __forceinline__ void load_rows_f32(float* dst, const T* src, long long st,
                                              int r0, int t) {
  if constexpr (sizeof(T) == 4) {
    load_rows<float, R, DH, LD, NT>(dst, reinterpret_cast<const float*>(src), st, r0, t);
  } else {
    constexpr int kVpr = DH / 8;   // 16-byte vectors of 8 bf16 a row
    for (int c = threadIdx.x; c < R * kVpr; c += NT) {
      const int r = c / kVpr;
      const int w = c - r * kVpr;
      const int row = r0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row < t) val = reinterpret_cast<const uint4*>(src + (long long)row * st)[w];
      const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&val);
      float* d = dst + r * LD + w * 8;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(pr[e]);
        d[2 * e] = f.x;
        d[2 * e + 1] = f.y;
      }
    }
  }
}

// x as the nearest T (identity for f32): where the bf16 kernels round.
template <typename T>
__device__ __forceinline__ float round_as(float x) {
  return to_float(from_float<T>(x));
}

// Write rows [r0, r0 + R) (those below t) of an f32 tile as T.
template <typename T, int R, int DH, int LD>
__device__ __forceinline__ void store_rows(T* dst, long long st,
                                           const float* src, int r0, int t) {
  for (int i = threadIdx.x; i < R * DH; i += kF32Threads) {
    const int r = i / DH;
    const int d = i - r * DH;
    if (r0 + r < t) dst[(long long)(r0 + r) * st + d] = from_float<T>(src[r * LD + d]);
  }
}

// ---------------------------------------------------------------------------
// chunked route (head dims past 256, f32 and bf16): the plain route with
// the head dim walked in column chunks, so shared memory stays bounded at
// any head dim
// ---------------------------------------------------------------------------
constexpr int kDhChunk = 64;    // head columns staged per step of a score sum
constexpr int kOutCols = 128;   // output head columns a block owns (grid z)

// the head dims the kernels are built for: 64, 128, 192, 256, and any
// multiple of 64 past 256 (the chunked route)
inline bool valid_head_dim(int dh) {
  return dh == 64 || dh == 128 || dh == 192 || dh == 256 || (dh > 256 && dh % kDhChunk == 0);
}

// Columns [0, w) of rows [r0, r0 + R) into an f32 tile of W columns
// (pitch LD; bf16 widened as it lands) with 16-byte loads; w <= W is a
// multiple of 8, and columns [w, W) and rows at or past t are zero.
template <typename T, int R, int W, int LD, int NT>
__device__ __forceinline__ void load_cols_f32(float* dst, const T* src, long long st,
                                              int r0, int t, int w) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kVpr = W / kVec;
  for (int c = threadIdx.x; c < R * kVpr; c += NT) {
    const int r = c / kVpr;
    const int v = c - r * kVpr;
    const int row = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < t && v * kVec < w)
      val = reinterpret_cast<const uint4*>(src + (long long)row * st)[v];
    float* d = dst + r * LD + v * kVec;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<uint4*>(d) = val;
    } else {
      const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&val);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(pr[e]);
        d[2 * e] = f.x;
        d[2 * e + 1] = f.y;
      }
    }
  }
}

// Columns [0, w) of rows [r0, r0 + R) (those below t) of an f32 tile of
// W columns (pitch LD) written as T.
template <typename T, int R, int W, int LD>
__device__ __forceinline__ void store_cols(T* dst, long long st, const float* src,
                                           int r0, int t, int w) {
  for (int i = threadIdx.x; i < R * W; i += kF32Threads) {
    const int r = i / W;
    const int d = i - r * W;
    if (d < w && r0 + r < t) dst[(long long)(r0 + r) * st + d] = from_float<T>(src[r * LD + d]);
  }
}

// C[M x N] (=, or += with ACC) sum_k A(m, k) B(k, n) over f32 tiles in
// shared memory with plain FMAs.  A(m, k) is A[m * lda + k], or
// A[k * lda + m] with TA; B(k, n) is B[k * ldb + n], or B[n * ldb + k]
// with TB.  C is row-major, pitch ldc.  The caller synchronises.
template <int M, int N, int K, bool TA, bool TB, bool ACC>
__device__ __forceinline__ void mm(float* C, int ldc, const float* A, int lda,
                                   const float* B, int ldb) {
  for (int i = threadIdx.x; i < M * N; i += kF32Threads) {
    const int m = i / N;
    const int n = i - m * N;
    float acc = ACC ? C[m * ldc + n] : 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k)
      acc = fmaf(TA ? A[k * lda + m] : A[m * lda + k],
                 TB ? B[n * ldb + k] : B[k * ldb + n], acc);
    C[m * ldc + n] = acc;
  }
}

// ---------------------------------------------------------------------------
// bf16 route: mma.sync m16n8k16 fragments
// ---------------------------------------------------------------------------
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), lane = 4 g + q:
//   A (16 x 16, row-major): a0 (row g, k 2q..2q+1), a1 (row g+8, same k),
//                           a2 (row g, k 2q+8..),   a3 (row g+8, k 2q+8..)
//   B (16 x 8, "col"):      b0 (k 2q..2q+1, col g), b1 (k 2q+8.., col g)
//   C/D (16 x 8, f32):      c0, c1 (row g, cols 2q, 2q+1),
//                           c2, c3 (row g+8, cols 2q, 2q+1)
// The lower-indexed element of a packed pair sits in the low 16 bits.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed: lane l gives the shared-memory
// address of row (l & 7) of matrix (l >> 3); register i receives matrix
// i's elements (rows 2q, 2q+1; column g).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragment of k-step kc (16 columns) of a [16, 8 NJ] f32
// accumulator in the C layout above (per warp; a wgmma accumulator holds
// one per warp of its warpgroup), rounded to bf16
template <int NJ>
__device__ __forceinline__ void pack_a(uint32_t (&f)[4], const float (&x)[NJ][4], int kc) {
  f[0] = pack_bf16(x[2 * kc][0], x[2 * kc][1]);
  f[1] = pack_bf16(x[2 * kc][2], x[2 * kc][3]);
  f[2] = pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]);
  f[3] = pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3]);
}

// The A fragment of rows [r0, r0 + 16), k [k0, k0 + 16) of a row-major
// bf16 tile with pitch LD.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* s,
                                       int r0, int k0, int g, int q) {
  a[0] = ld_u32(s + (r0 + g) * LD + k0 + 2 * q);
  a[1] = ld_u32(s + (r0 + g + 8) * LD + k0 + 2 * q);
  a[2] = ld_u32(s + (r0 + g) * LD + k0 + 2 * q + 8);
  a[3] = ld_u32(s + (r0 + g + 8) * LD + k0 + 2 * q + 8);
}

// acc[j] (j < NJ, 8 columns each) += A(16 x 16 k-step) . M^T, where B(k, n)
// = M[n0 + 8 j + n][k0 + k] for a row-major bf16 tile M with pitch LD —
// a product against the transpose of a row-major tile (Q K^T).
template <int NJ, int LD>
__device__ __forceinline__ void mma_abt(float (&acc)[NJ][4], const uint32_t (&a)[4],
                                        const __nv_bfloat16* m, int n0, int k0,
                                        int g, int q) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const __nv_bfloat16* row = m + (n0 + 8 * j + g) * LD + k0 + 2 * q;
    mma_16816(acc[j], a, ld_u32(row), ld_u32(row + 8));
  }
}

// acc[j] (j < NJ, 8 columns each) += A(16 x 16 k-step) . M, where B(k, n)
// = M[k0 + k][8 j + n] for a row-major bf16 tile M with pitch LD — a
// product against a row-major tile as it stands (P V); the B fragments
// come from ldmatrix.trans, two column blocks per instruction, for the
// column blocks that start below `cols` (the rest of acc is untouched).
template <int NJ, int LD>
__device__ __forceinline__ void mma_ab(float (&acc)[NJ][4], const uint32_t (&a)[4],
                                       const __nv_bfloat16* m, int k0, int lane,
                                       int cols = 8 * NJ) {
  const int mat = lane >> 3;
  const __nv_bfloat16* row = m + (k0 + (mat & 1) * 8 + (lane & 7)) * LD + (mat >> 1) * 8;
#pragma unroll
  for (int j = 0; j < NJ; j += 2) {
    if (8 * j >= cols) continue;
    uint32_t b[4];
    ldsm_x4_trans(b, row + 8 * j);
    mma_16816(acc[j], a, b[0], b[1]);
    mma_16816(acc[j + 1], a, b[2], b[3]);
  }
}

}  // namespace flash
