// Paged attention at any head dim up to 256: the instantiation of K1
// (paged_decode.cu) and K2 (paged_verify.cu) for head dims their fast
// kernels do not take (above 128, or not a multiple of 8).
//
// Replaces, for those head dims, the TPU kernels of
// deeplearning4j_tpu/kernels/paged_attention.py: _decode_kernel and
// _verify_kernel, which take any head dim.  The fast kernels read rows as
// whole 16-byte vectors and hold q in registers as 128 / 64 lane pairs; a
// bf16 row of dh 12 is 24 bytes, so its rows are not even 16-byte aligned
// in the pool, and the pool cannot be padded (rows are read through the
// table).  This kernel reads rows element by element instead (a warp's
// lanes on neighbouring elements, so a row still arrives in whole
// 32-byte sectors) and holds q and the output accumulator in a register
// width padded to 128 or 256 (kPer = 4 or 8 elements a lane), zero past
// dh, so the padding adds nothing to a dot product.
//
// Query rows: a decode slot has one (W = 1); a verify slot has W, row w
// at position pos[b] + w.  Each row is its own "virtual slot" b * W + w
// of the grid, so verify at these head dims re-reads the slot's K/V once
// a row (W times the bytes of the fast verify kernel, which shares one
// read across its 16-row group).  A row attends over positions 0 ..
// min(pos[b] + w, max_blocks * bs - 1).
//
// Bound: memory, as K1 and K2: one multiply-add per K/V element loaded.
//
// Design: K1's split-K carried over.  Grid (h, B * W, S): split s covers
// context rows [s C, (s+1) C) for a chunk C the wrapper picks from the
// table's capacity; a split at or past the row's context exits at once.
// Each of the 4 warps scores 4 rows at a time (rows warp * 4 + 16 i of
// the split), keeps its own online softmax with P rounded to V's dtype at
// its running max (as K1), and the warps merge through shared memory.  A
// split writes its partial (m, l, acc[dh]) in f32 to scratch; the last
// live split of a (row, head) — a __threadfence() and an atomicAdd ticket
// on its counter — merges every partial, writes O and resets the counter.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace paged_any_dh {

constexpr int kThreads = 128;   // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;        // rows a warp scores at once
constexpr int kMaxDh = 256;

struct Args {
  const void* q;        // [B * W, h, dh]
  const void* k_pool;   // [n_blocks, h, bs, dh]
  const void* v_pool;
  const int* table;     // [B, max_blocks]
  const int* pos;       // [B]: row w of slot b sits at pos[b] + w
  void* out;            // [B * W, h, dh]
  float* part;          // [B * W, h, S, dh + 2] f32: m, l, acc[dh] per split
  int* counter;         // [B * W * h] int32, 0 between launches
  int W, h, bs, dh, max_blocks, chunk, n_split;
  float scale;
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// kPer: elements of the padded head dim a lane holds (dh <= 32 kPer)
template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads) paged_any_dh_kernel(const Args a) {
  __shared__ float wm_s[kWarps], wl_s[kWarps];
  __shared__ float wacc_s[kWarps][32 * kPer];
  __shared__ int last_s;

  const int head = blockIdx.x, vb = blockIdx.y, split = blockIdx.z;
  const int b = vb / a.W, w = vb - b * a.W;
  const int h = a.h, dh = a.dh, bs = a.bs;
  const int n_ctx = min(a.pos[b] + w + 1, a.max_blocks * bs);
  const int c0 = split * a.chunk;
  if (c0 >= n_ctx) return;                        // a dead split
  const int c1 = min(n_ctx, c0 + a.chunk);
  const int n_live = (n_ctx + a.chunk - 1) / a.chunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* tbl = a.table + (long long)b * a.max_blocks;
  const T* kp = static_cast<const T*>(a.k_pool);
  const T* vp = static_cast<const T*>(a.v_pool);
  const long long bh = (long long)vb * h + head;

  // q, scaled, zero past dh: lane holds elements lane + 32 i
  const T* qrow = static_cast<const T*>(a.q) + bh * dh;
  float qv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < dh ? ld(qrow + d) * a.scale : 0.f;
  }

  float m_w = -INFINITY, l_w = 0.f, acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  for (int j0 = c0 + warp * kRows; j0 < c1; j0 += kWarps * kRows) {
    long long off[kRows];
    float s[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int j = j0 + u;
      off[u] = j < c1 ? (((long long)tbl[j / bs] * h + head) * bs + (j % bs)) * dh : -1;
      float part = 0.f;
      if (off[u] >= 0) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int d = lane + 32 * i;
          if (d < dh) part = fmaf(qv[i], ld(kp + off[u] + d), part);
        }
      }
      s[u] = part;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kRows; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
    float m_tile = -INFINITY;
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (off[u] < 0) s[u] = -INFINITY;          // no key at all
      m_tile = fmaxf(m_tile, s[u]);
    }
    const float m_new = fmaxf(m_w, m_tile);      // finite: row j0 is live
    const float corr = expf(m_w - m_new);        // 0 on the warp's first rows
    float l_tile = 0.f, pv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) pv[i] = 0.f;
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (off[u] < 0) continue;
      const float p = expf(s[u] - m_new);
      l_tile += p;
      const float pr = round_to(p, T());         // P in V's dtype, as K1
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int d = lane + 32 * i;
        if (d < dh) pv[i] = fmaf(pr, ld(vp + off[u] + d), pv[i]);
      }
    }
    l_w = l_w * corr + l_tile;
    m_w = m_new;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] = fmaf(acc[i], corr, pv[i]);
  }

  // merge the four warps' states into the split's (m, l, acc)
  if (lane == 0) {
    wm_s[warp] = m_w;
    wl_s[warp] = l_w;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) wacc_s[warp][lane + 32 * i] = acc[i];
  __syncthreads();
  float m_s = -INFINITY;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) m_s = fmaxf(m_s, wm_s[v]);   // finite (warp 0 saw c0)
  float f[kWarps], l_s = 0.f;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    f[v] = expf(wm_s[v] - m_s);                  // 0 for a warp with no row
    l_s = fmaf(wl_s[v], f[v], l_s);
  }
  T* out = static_cast<T*>(a.out) + bh * dh;
  float* part = a.part + (bh * a.n_split + split) * (dh + 2);
  for (int d = tid; d < dh; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) o = fmaf(wacc_s[v][d], f[v], o);
    if (n_live == 1)                             // the whole context here
      store(out + d, o / l_s);
    else
      part[2 + d] = o;
  }
  if (n_live == 1) return;
  if (tid == 0) {
    part[0] = m_s;
    part[1] = l_s;
  }
  __threadfence();                 // the partial is visible device-wide ...
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(a.counter + bh, 1);   // ... before the ticket
    last_s = ticket == n_live - 1;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // the last split: merge every live split's partial (read past L1)
  const float* base = a.part + bh * a.n_split * (dh + 2);
  float m = -INFINITY;
  for (int s = 0; s < n_live; ++s) m = fmaxf(m, __ldcg(base + s * (dh + 2)));
  float l = 0.f;
  for (int s = 0; s < n_live; ++s) {
    const float* ps = base + s * (dh + 2);
    l = fmaf(__ldcg(ps + 1), expf(__ldcg(ps) - m), l);
  }
  for (int d = tid; d < dh; d += kThreads) {
    float o = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float* ps = base + s * (dh + 2);
      o = fmaf(__ldcg(ps + 2 + d), expf(__ldcg(ps) - m), o);
    }
    store(out + d, o / l);
  }
  if (tid == 0) a.counter[bh] = 0;   // ready for the next launch
}

template <typename T>
int launch_t(const Args& a, int B, cudaStream_t s) {
  const dim3 grid(a.h, B * a.W, a.n_split);
  if (a.dh <= 128)
    paged_any_dh_kernel<T, 4><<<grid, kThreads, 0, s>>>(a);
  else
    paged_any_dh_kernel<T, 8><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// Validate and launch.  `chunk` > 0 (any multiple of 1), n_split =
// ceil(max_blocks * bs / chunk); `part` f32 scratch of B * W * h *
// n_split * (dh + 2) values, `counter` B * W * h int32 zeros (left zero).
inline int launch(const void* q, const void* k_pool, const void* v_pool,
                  const void* table, const void* pos, void* out, void* part,
                  void* counter, int B, int W, int h, int bs, int dh,
                  int max_blocks, int chunk, float scale, int is_bf16,
                  void* stream) {
  if (B <= 0 || W <= 0 || h <= 0 || bs <= 0 || dh <= 0 || dh > kMaxDh ||
      max_blocks <= 0 || chunk <= 0 || (long long)B * W > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.table = static_cast<const int*>(table);
  a.pos = static_cast<const int*>(pos);
  a.out = out;
  a.part = static_cast<float*>(part);
  a.counter = static_cast<int*>(counter);
  a.W = W;
  a.h = h;
  a.bs = bs;
  a.dh = dh;
  a.max_blocks = max_blocks;
  a.chunk = chunk;
  a.n_split = (max_blocks * bs + chunk - 1) / chunk;
  a.scale = scale;
  if (a.n_split > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_t<__nv_bfloat16>(a, B, s) : launch_t<float>(a, B, s);
}

}  // namespace paged_any_dh
