// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/kernels/paged_attention.py:
// _decode_kernel (launched by _paged_decode_pallas -> pl.pallas_call).
// One query per decode slot attends over that slot's K/V, which live in
// a global block pool [n_blocks, h, block_size, dh] and are addressed
// through the slot's block table [B, max_blocks]; attend over positions
// 0..pos[b].  Output [B, h, dh] in q's dtype.
//
// Bound: memory.  The work is 4 * sum_b (pos_b + 1) * h * dh flops
// against sum_b (pos_b + 1) * h * dh * 2 (K and V) * element-size bytes
// read — one multiply-add per element loaded, far below the ~295 flops
// per byte where the H100 turns compute-bound.  The least time is those
// bytes over the card's 3.35 TB/s.
//
// Design (right and simple first):
// * one thread block per (head, slot); the block reads pos[b] itself and
//   walks context rows 0..pos[b] in tiles of kTile rows, looking up each
//   row's pool block in the table (entries 0 .. pos[b] / bs only).  Rows
//   past pos[b] — and table entries past the context — are never read,
//   so a scratch block full of garbage (block 0, the pool's write sink)
//   cannot leak into the result, and no gathered [B, L] copy of the pool
//   is ever made;
// * per tile (16 KB of K and 16 KB of V: 64 rows in bf16, 32 in f32 at
//   dh = 128): all 128 threads load the tile's rows with 16-byte loads
//   into registers, every load issued before any store, then store them
//   to shared memory; the NEXT tile's loads are issued right after, so
//   they fly while this tile computes.  (The first version of this
//   kernel loaded V row by row inside the accumulation loop and ran
//   latency-bound at ~117x its bound; PERF.md has the versions' times.)
// * scores: one warp per row (lanes stride dh), four rows at a time so
//   their shuffle reductions overlap; warp 0 then updates the running
//   max / denominator and turns the tile's scores into p values once per
//   row; thread t accumulates output dim t in f32 — the online softmax
//   that the Pallas grid carried across its block axis in VMEM scratch
//   becomes this loop inside the block;
// * p is rounded to V's dtype before the P.V product, as the TPU kernel
//   does (a no-op in f32).
// Templated on float and bf16; dh <= 128 and a multiple of 8 (one thread
// per output dim; rows split into whole 16-byte vectors).
//
// Known limits, left to later work: at the serving path's B = 8 slots
// and h = 6 heads the grid is only 48 blocks on the H100's 132 SMs, with
// one tile in flight per block — split-K over the context (a second pass
// merging partial softmax states), deeper cp.async/TMA pipelines and
// wgmma tiles are the ways to the bandwidth bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDh = 128;
constexpr int kTileBytes = 16384;                  // K (and V) bytes per tile
constexpr int kVecPerThread = kTileBytes / 16 / kThreads;   // 16-byte loads

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ table,
                    const int* __restrict__ pos, T* __restrict__ out,
                    int h, int bs, int dh, int max_blocks, float scale) {
  // context rows per tile at the largest dh: 64 in bf16, 32 in f32
  constexpr int kTile = kTileBytes / (kMaxDh * (int)sizeof(T));
  __shared__ __align__(16) unsigned char k_raw[kTileBytes];
  __shared__ __align__(16) unsigned char v_raw[kTileBytes];
  __shared__ float q_s[kMaxDh];
  __shared__ float s_s[kTile];    // a tile's scores, then its p values
  __shared__ float corr_s;        // the tile's rescale of the accumulator
  __shared__ float l_s;           // the final denominator
  const T* k_s = reinterpret_cast<const T*>(k_raw);
  const T* v_s = reinterpret_cast<const T*>(v_raw);

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const long long qo = ((long long)b * h + head) * dh;
  for (int d = tid; d < dh; d += kThreads) q_s[d] = to_float(q[qo + d]);
  const int n_ctx = pos[b] + 1;
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
        const int w = c - r * vec_per_row;
        const int j = j0 + r;
        const long long blk = tbl[j / bs];
        const long long off =
            ((blk * h + head) * bs + (j % bs)) * (long long)dh;
        kr[i] = reinterpret_cast<const uint4*>(k_pool + off)[w];
        vr[i] = reinterpret_cast<const uint4*>(v_pool + off)[w];
      }
    }
  };

  float m_run = -INFINITY;   // running max      (warp 0, every lane)
  float l_run = 0.f;         // running denominator (warp 0, every lane)
  float acc = 0.f;           // output dim `tid` (tid < dh)
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
    // scores: one warp per row, lanes stride dh; four rows at a time so
    // their shuffle reductions overlap
    for (int r0 = warp * 4; r0 < rows; r0 += kWarps * 4) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = lane; d < dh; d += 32) {
        const float qd = q_s[d];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (r0 + u < rows) part[u] += qd * to_float(k_s[(r0 + u) * dh + d]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          part[u] += __shfl_xor_sync(0xffffffffu, part[u], o);
      }
      if (lane < 4 && r0 + lane < rows) {
        float v = part[0];
#pragma unroll
        for (int u = 1; u < 4; ++u) v = (lane == u) ? part[u] : v;
        s_s[r0 + lane] = v * scale;
      }
    }
    __syncthreads();
    // online softmax update, once per row (warp 0)
    if (warp == 0) {
      float m_tile = -INFINITY;
      for (int r = lane; r < rows; r += 32) m_tile = fmaxf(m_tile, s_s[r]);
      const float m_new = fmaxf(m_run, warp_max(m_tile));
      float l_tile = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float p = expf(s_s[r] - m_new);
        l_tile += p;
        // P rounded to V's dtype before P.V, as the TPU kernel does
        s_s[r] = to_float(from_float<T>(p));
      }
      const float corr = expf(m_run - m_new);   // 0 on the first tile
      l_run = l_run * corr + warp_sum(l_tile);
      m_run = m_new;
      if (lane == 0) corr_s = corr;
    }
    __syncthreads();
    if (tid < dh) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};   // four independent chains
      int r = 0;
      for (; r + 4 <= rows; r += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          a[u] += s_s[r + u] * to_float(v_s[(r + u) * dh + tid]);
      }
      for (; r < rows; ++r) a[0] += s_s[r] * to_float(v_s[r * dh + tid]);
      acc = acc * corr_s + ((a[0] + a[1]) + (a[2] + a[3]));
    }
  }
  if (tid == 0) l_s = l_run;
  __syncthreads();
  if (tid < dh) out[qo + tid] = from_float<T>(acc / l_s);
}

}  // namespace

// Plain-C entry for ctypes.  Launches on `stream`, allocates nothing,
// does not synchronise; returns cudaGetLastError() (0 on success).
extern "C" int dl4j_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* pos, void* out, int B, int h, int bs, int dh, int max_blocks,
    float scale, int is_bf16, void* stream) {
  if (B <= 0 || h <= 0 || bs <= 0 || dh <= 0 || dh > kMaxDh ||
      max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(h, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    paged_decode_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pool),
        static_cast<const __nv_bfloat16*>(v_pool),
        static_cast<const int*>(table), static_cast<const int*>(pos),
        static_cast<__nv_bfloat16*>(out), h, bs, dh, max_blocks, scale);
  } else {
    paged_decode_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pool),
        static_cast<const float*>(v_pool), static_cast<const int*>(table),
        static_cast<const int*>(pos), static_cast<float*>(out), h, bs, dh,
        max_blocks, scale);
  }
  return (int)cudaGetLastError();
}
