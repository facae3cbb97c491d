// Paged speculative-verify attention for Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/kernels/paged_attention.py:
// _verify_kernel (launched by _paged_verify_pallas -> pl.pallas_call).
// Each decode slot carries a chunk of W query rows (the anchor token and
// the draft's proposals); row w sits at position pos0[b] + w and attends
// over that slot's K/V at positions 0..pos0[b] + w.  K/V live in a global
// block pool [n_blocks, h, block_size, dh] addressed through the slot's
// block table [B, max_blocks].  q and out are [B, W, h, dh], read and
// written in that layout as they stand (no transposed copy).
//
// Bound: memory.  The slot's K/V rows 0 .. min(pos0 + W, max_blocks * bs)
// - 1 are read once, sum_b of those rows * h * dh * 2 * element-size
// bytes; the work is 4 * W flops per K/V element pair, so ~W flops per
// byte (W <= 16), far below the ~295 flops per byte where the H100 turns
// compute-bound.  The least time is those bytes over the card's 3.35 TB/s.
//
// Design (K1's, paged_decode.cu, with W rows sharing every staged tile):
// * one thread block of 8 warps per (head, slot); the block walks context
//   rows 0 .. n_ctx - 1, n_ctx = min(pos0 + W, max_blocks * bs), in tiles
//   of kTile rows, looking up each row's pool block in the table —
//   entries 0 .. (n_ctx - 1) / bs only, never one at or past max_blocks
//   (a slot within W of the table's end would otherwise read past it);
// * per tile (16 KB of K and 16 KB of V): all threads load the rows with
//   16-byte loads into registers, store them to shared memory, and issue
//   the next tile's loads before this tile's math;
// * scores: a warp takes two context rows at a time, lanes striding dh
//   with both rows' K in registers, so each q value read from shared
//   memory serves two dot products; the 2W shuffle reductions run side
//   by side.  Keys past a row's own position score -inf;
// * the online softmax of query row w is kept by warp w % 8 (running max
//   and denominator in its registers); p values are stored [key][W] so
//   the P.V loop reads a key's W probabilities as float4s;
// * P.V: thread t accumulates output dim t % 128 of every row over half
//   of the tile's keys (t / 128 picks the half); the two halves share
//   the per-row rescale and are summed once at the end.  Keys every row
//   may see run unpredicated; the last W - 1 keys of the chunk are
//   skipped outright for the rows that may not see them, so a key only a
//   deeper row may read (or the scratch block 0 behind a row the caller
//   masks) never enters a shallower row as 0 * NaN;
// * p is rounded to V's dtype before the P.V product, as the TPU kernel
//   does (a no-op in f32); scores and accumulators stay in f32;
// * W is a template parameter (1..16, one instantiation each), so every
//   per-row loop is unrolled to exactly W.
// Templated on float and bf16; dh <= 128 and a multiple of 8.
//
// Known limits, left to later work (as for K1): B * h blocks (48 at the
// serving shapes) on 132 SMs with one tile in flight each; split-K over
// the context, cp.async/TMA pipelines and tensor-core tiles for the
// W x tile score product are the ways to the bandwidth bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;   // 8 warps; two threads per output dim
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDh = 128;
constexpr int kMaxW = 16;
constexpr int kTileBytes = 16384;                     // K (and V) bytes per tile
constexpr int kVecPerThread = kTileBytes / 16 / kThreads;   // 16-byte loads
constexpr int kDhPerLane = kMaxDh / 32;

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

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ table,
                    const int* __restrict__ pos0, T* __restrict__ out, int h,
                    int bs, int dh, int max_blocks, float scale) {
  // context rows per tile at the largest dh: 64 in bf16, 32 in f32
  constexpr int kTile = kTileBytes / (kMaxDh * (int)sizeof(T));
  constexpr int kW4 = (W + 3) / 4 * 4;              // p row, float4 padded
  constexpr int kRowsPerWarp = (W + kWarps - 1) / kWarps;
  __shared__ __align__(16) unsigned char k_raw[kTileBytes];
  __shared__ __align__(16) unsigned char v_raw[kTileBytes];
  __shared__ float q_s[W][kMaxDh];
  __shared__ __align__(16) float s_s[kTile][kW4];   // scores, then p values
  __shared__ float corr_s[W];           // each row's rescale of its accumulator
  __shared__ float l_s[W];              // each row's final denominator
  const T* k_s = reinterpret_cast<const T*>(k_raw);
  const T* v_s = reinterpret_cast<const T*>(v_raw);

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // q[b, w, head, :] for every row, zero past dh (the score loop reads
  // whole 32-lane strides)
  for (int i = tid; i < W * kMaxDh; i += kThreads) {
    const int w = i / kMaxDh, d = i - w * kMaxDh;
    q_s[w][d] = d < dh
                    ? to_float(q[(((long long)b * W + w) * h + head) * dh + d])
                    : 0.f;
  }
  const int p0 = pos0[b];
  const int n_ctx = min(p0 + W, max_blocks * bs);
  const int* tbl = table + (long long)b * max_blocks;
  const int vec_per_row = dh * (int)sizeof(T) / 16;

  // issue the 16-byte loads of tile rows [j0, j0 + rows) into registers;
  // nothing waits on them until the stores into shared memory
  uint4 kr[kVecPerThread], vr[kVecPerThread];
  auto load_tile = [&](int j0, int rows) {
    const int n_vec = rows * vec_per_row;
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {
      const int c = tid + i * kThreads;
      if (c < n_vec) {
        const int r = c / vec_per_row;
        const int wv = c - r * vec_per_row;
        const int j = j0 + r;
        const long long blk = tbl[j / bs];
        const long long off =
            ((blk * h + head) * bs + (j % bs)) * (long long)dh;
        kr[i] = reinterpret_cast<const uint4*>(k_pool + off)[wv];
        vr[i] = reinterpret_cast<const uint4*>(v_pool + off)[wv];
      }
    }
  };

  // online-softmax state of rows warp, warp + 8 (every lane of the owning
  // warp holds the same values)
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  const int d_out = tid & (kMaxDh - 1);   // this thread's output dim
  const int half = tid / kMaxDh;          // ... and its half of the keys
  float acc[W];
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = 0.f;

  load_tile(0, min(kTile, n_ctx));
  for (int j0 = 0; j0 < n_ctx; j0 += kTile) {
    const int rows = min(kTile, n_ctx - j0);
    const int n_vec = rows * vec_per_row;
    __syncthreads();   // q_s written; the previous tile fully consumed
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {
      const int c = tid + i * kThreads;
      if (c < n_vec) {
        reinterpret_cast<uint4*>(k_raw)[c] = kr[i];
        reinterpret_cast<uint4*>(v_raw)[c] = vr[i];
      }
    }
    __syncthreads();
    // the next tile's loads fly while this tile computes
    if (j0 + kTile < n_ctx) load_tile(j0 + kTile, min(kTile, n_ctx - j0 - kTile));

    // scores: two context rows per warp at a time; lane holds both rows'
    // K[d] for d = lane + 32i
    for (int r0 = 2 * warp; r0 < rows; r0 += 2 * kWarps) {
      const bool two = r0 + 1 < rows;
      float kreg[2][kDhPerLane];
#pragma unroll
      for (int i = 0; i < kDhPerLane; ++i) {
        const int d = lane + 32 * i;
        kreg[0][i] = d < dh ? to_float(k_s[r0 * dh + d]) : 0.f;
        kreg[1][i] = (two && d < dh) ? to_float(k_s[(r0 + 1) * dh + d]) : 0.f;
      }
      float part[2][W];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int i = 0; i < kDhPerLane; ++i) {
          const float qd = q_s[w][lane + 32 * i];
          a0 += qd * kreg[0][i];
          a1 += qd * kreg[1][i];
        }
        part[0][w] = a0;
        part[1][w] = a1;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          part[0][w] += __shfl_xor_sync(0xffffffffu, part[0][w], o);
          part[1][w] += __shfl_xor_sync(0xffffffffu, part[1][w], o);
        }
      }
      if (lane < W) {
        float v0 = part[0][0], v1 = part[1][0];
#pragma unroll
        for (int w = 1; w < W; ++w) {
          v0 = (lane == w) ? part[0][w] : v0;
          v1 = (lane == w) ? part[1][w] : v1;
        }
        // key j0 + r is visible to row `lane` iff j0 + r <= p0 + lane
        s_s[r0][lane] = (j0 + r0 <= p0 + lane) ? v0 * scale : -INFINITY;
        if (two)
          s_s[r0 + 1][lane] =
              (j0 + r0 + 1 <= p0 + lane) ? v1 * scale : -INFINITY;
      }
    }
    __syncthreads();
    // online softmax update, once per query row (row w on warp w % 8)
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int w = warp + kWarps * i;
      if (w < W) {
        float m_tile = -INFINITY;
        for (int r = lane; r < rows; r += 32) m_tile = fmaxf(m_tile, s_s[r][w]);
        // finite: key 0 is visible to every row, and later tiles keep
        // the running max of the first
        const float m_new = fmaxf(m_run[i], warp_max(m_tile));
        float l_tile = 0.f;
        for (int r = lane; r < rows; r += 32) {
          const float p = expf(s_s[r][w] - m_new);   // 0 where masked
          l_tile += p;
          // P rounded to V's dtype before P.V, as the TPU kernel does
          s_s[r][w] = to_float(from_float<T>(p));
        }
        const float corr = expf(m_run[i] - m_new);   // 0 on the first tile
        l_run[i] = l_run[i] * corr + warp_sum(l_tile);
        m_run[i] = m_new;
        if (lane == 0) corr_s[w] = corr;
      }
    }
    __syncthreads();
    if (d_out < dh) {
      float a[W];
#pragma unroll
      for (int w = 0; w < W; ++w) a[w] = 0.f;
      // keys r <= lim are visible to every row; key r > lim only to rows
      // w >= r - lim, and is skipped (not multiplied by 0) for the others
      const int lim = p0 - j0;
      const int r_all = min(rows, lim + 1);
      int r = half;
      for (; r < r_all; r += 2) {
        const float vv = to_float(v_s[r * dh + d_out]);
        float p[kW4];
#pragma unroll
        for (int i = 0; i < kW4 / 4; ++i) {
          const float4 f = reinterpret_cast<const float4*>(&s_s[r][0])[i];
          p[4 * i] = f.x;
          p[4 * i + 1] = f.y;
          p[4 * i + 2] = f.z;
          p[4 * i + 3] = f.w;
        }
#pragma unroll
        for (int w = 0; w < W; ++w) a[w] += p[w] * vv;
      }
      for (; r < rows; r += 2) {
        const float vv = to_float(v_s[r * dh + d_out]);
#pragma unroll
        for (int w = 0; w < W; ++w)
          if (r <= lim + w) a[w] += s_s[r][w] * vv;
      }
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] = acc[w] * corr_s[w] + a[w];
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int w = warp + kWarps * i;
    if (w < W && lane == 0) l_s[w] = l_run[i];
  }
  // the two halves' accumulators meet in the (now free) K tile
  float* red = reinterpret_cast<float*>(k_raw);      // [W][kMaxDh]
  __syncthreads();
  if (half == 1 && d_out < dh) {
#pragma unroll
    for (int w = 0; w < W; ++w) red[w * kMaxDh + d_out] = acc[w];
  }
  __syncthreads();
  if (half == 0 && d_out < dh) {
#pragma unroll
    for (int w = 0; w < W; ++w)
      out[(((long long)b * W + w) * h + head) * dh + d_out] =
          from_float<T>((acc[w] + red[w * kMaxDh + d_out]) / l_s[w]);
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* pos0, void* out, int B, int W,
           int h, int bs, int dh, int max_blocks, float scale,
           cudaStream_t s) {
  const dim3 grid(h, B);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k_pool);
  const T* vv = static_cast<const T*>(v_pool);
  const int* tt = static_cast<const int*>(table);
  const int* pp = static_cast<const int*>(pos0);
  T* oo = static_cast<T*>(out);
  switch (W) {
#define DL4J_VERIFY_CASE(n)                                                 \
  case n:                                                                   \
    paged_verify_kernel<T, n><<<grid, kThreads, 0, s>>>(                    \
        qq, kk, vv, tt, pp, oo, h, bs, dh, max_blocks, scale);              \
    break;
    DL4J_VERIFY_CASE(1) DL4J_VERIFY_CASE(2) DL4J_VERIFY_CASE(3)
    DL4J_VERIFY_CASE(4) DL4J_VERIFY_CASE(5) DL4J_VERIFY_CASE(6)
    DL4J_VERIFY_CASE(7) DL4J_VERIFY_CASE(8) DL4J_VERIFY_CASE(9)
    DL4J_VERIFY_CASE(10) DL4J_VERIFY_CASE(11) DL4J_VERIFY_CASE(12)
    DL4J_VERIFY_CASE(13) DL4J_VERIFY_CASE(14) DL4J_VERIFY_CASE(15)
    DL4J_VERIFY_CASE(16)
#undef DL4J_VERIFY_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain-C entry for ctypes.  Launches on `stream`, allocates nothing,
// does not synchronise; returns cudaGetLastError() (0 on success).
extern "C" int dl4j_paged_verify_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* pos0, void* out, int B, int W, int h, int bs, int dh,
    int max_blocks, float scale, int is_bf16, void* stream) {
  if (B <= 0 || W <= 0 || W > kMaxW || h <= 0 || bs <= 0 || dh <= 0 ||
      dh > kMaxDh || dh % 8 || max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(q, k_pool, v_pool, table, pos0,
                                         out, B, W, h, bs, dh, max_blocks,
                                         scale, s)
                 : launch<float>(q, k_pool, v_pool, table, pos0, out, B, W,
                                 h, bs, dh, max_blocks, scale, s);
}
