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
// Design (v4, split-K over the context in one launch):
// * grid (h, B, S): split s of a slot covers context rows [s C, (s+1) C)
//   for a chunk C (a multiple of the tile) that the wrapper picks from
//   the table's capacity, never from `pos` (no host read).  A block reads
//   pos[b] itself; a split at or past pos[b] + 1 exits at once.  At the
//   serving shapes (8 slots, 6 heads, 1024-row tables, C = 64) the ~450-
//   row mid contexts give ~300 live blocks on the H100's 132 SMs;
// * inside a split, the K/V tiles (kRows rows each) stream through a
//   ring of kStages shared-memory stages filled by cp.async: the copies
//   of tile i + kStages - 1 are issued before tile i is computed, one
//   barrier per tile.  Rows at or past pos[b] + 1 are zero-filled, never
//   read, and so are table entries past the context: the pool's scratch
//   block 0 cannot leak into the result;
// * each warp owns a quarter of every tile's rows and keeps its own
//   online-softmax state (running max, denominator, output accumulator
//   over dh in registers), so no warp waits on another inside the loop.
//   P is rounded to V's dtype before P.V relative to the warp's running
//   max (the TPU kernel rounds relative to its running max; the plain
//   version relative to the row's final max — the same bf16 rounding,
//   at another scale).  The four warps' states merge once per split;
// * a split writes its partial (m, l, acc[dh]) in f32 to scratch.  The
//   last live split of a (slot, head) to finish — told by a
//   __threadfence() and an atomicAdd ticket on that (slot, head)'s
//   counter — rescales each partial by exp(m_s - m), sums, divides by
//   the total l, writes O, and resets the counter to 0 for the next
//   launch.  No second kernel: the decode tick is host-bound, and a
//   merge launch per layer would add to every tick.  A slot whose
//   context fits one split writes O directly.
// Templated on float and bf16; dh <= 128 and a multiple of 8 (rows are
// read as whole 16-byte vectors, scores and P.V as element pairs).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDh = 128;
constexpr int kStages = 3;
constexpr int kTileBytes = 8192;   // K (and V) bytes per tile at dh 128

// rows per tile: 32 in bf16, 16 in f32 (a chunk is a multiple of 32)
template <typename T>
struct Tile {
  static constexpr int kRows = kTileBytes / (kMaxDh * (int)sizeof(T));
  static constexpr int kRowsPerWarp = kRows / kWarps;
  static constexpr size_t kSmem = (size_t)kStages * 2 * kTileBytes;
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16-byte global -> shared copy; with `full` false the 16 bytes are
// zero-filled and nothing is read from `src`
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* table;
  const int* pos;
  void* out;
  float* part;       // [B, h, S, dh + 2] f32: m, l, acc[dh] per split
  int* counter;      // [B * h] int32, 0 between launches
  int h, bs, dh, max_blocks, chunk, n_split;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const Args a) {
  constexpr int R = Tile<T>::kRows;
  constexpr int RW = Tile<T>::kRowsPerWarp;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float wm_s[kWarps], wl_s[kWarps];
  __shared__ float wacc_s[kWarps][kMaxDh];
  __shared__ int last_s;

  const int head = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int h = a.h, dh = a.dh;
  const int n_ctx = a.pos[b] + 1;
  const int c0 = split * a.chunk;
  if (c0 >= n_ctx) return;                        // a dead split
  const int c1 = min(n_ctx, c0 + a.chunk);
  const int n_live = (n_ctx + a.chunk - 1) / a.chunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* tbl = a.table + (long long)b * a.max_blocks;
  const T* kp = static_cast<const T*>(a.k_pool);
  const T* vp = static_cast<const T*>(a.v_pool);
  const long long bh = (long long)b * h + head;

  // q as f32 pairs: lane holds pairs lane and lane + 32 (dh <= 128)
  const T* qrow = static_cast<const T*>(a.q) + bh * dh;
  const int n_pair = dh / 2;
  float2 qv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = lane + 32 * i;
    qv[i] = p < n_pair ? load2(qrow + 2 * p) : make_float2(0.f, 0.f);
    qv[i].x *= a.scale;
    qv[i].y *= a.scale;
  }

  const int vec_per_row = dh * (int)sizeof(T) / 16;
  const int n_tiles = (c1 - c0 + R - 1) / R;
  T* k_ring = reinterpret_cast<T*>(smem);
  T* v_ring = k_ring + kStages * R * dh;
  // issue tile i's copies into its stage (rows past the context are
  // zero-filled; the table is read only for rows below n_ctx)
  auto issue = [&](int i) {
    if (i < n_tiles) {
      const int j0 = c0 + i * R;
      T* ks = k_ring + (i % kStages) * R * dh;
      T* vs = v_ring + (i % kStages) * R * dh;
      for (int c = tid; c < R * vec_per_row; c += kThreads) {
        const int r = c / vec_per_row;
        const int w = c - r * vec_per_row;
        const int j = j0 + r;
        const bool live = j < c1;
        long long off = 0;
        if (live)
          off = (((long long)tbl[j / a.bs] * h + head) * a.bs + (j % a.bs)) * dh;
        cp_async16(ks + r * dh + w * (16 / (int)sizeof(T)),
                   kp + off + w * (16 / (int)sizeof(T)), live);
        cp_async16(vs + r * dh + w * (16 / (int)sizeof(T)),
                   vp + off + w * (16 / (int)sizeof(T)), live);
      }
    }
    cp_async_commit();   // an empty group past the last tile keeps counts
  };

  float m_w = -INFINITY, l_w = 0.f;
  float2 acc[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();   // tile i has landed (this thread's part)
    __syncthreads();                // ... everyone's; tile i - 1 consumed
    issue(i + kStages - 1);
    const T* ks = k_ring + (i % kStages) * R * dh;
    const T* vs = v_ring + (i % kStages) * R * dh;
    const int r0 = warp * RW;                  // this warp's rows
    const int rows_left = c1 - (c0 + i * R) - r0;
    float s[RW];
#pragma unroll
    for (int u = 0; u < RW; ++u) {
      float part = 0.f;
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int p = lane + 32 * ii;
        if (p < n_pair) {
          const float2 kv = load2(ks + (r0 + u) * dh + 2 * p);
          part = fmaf(qv[ii].x, kv.x, fmaf(qv[ii].y, kv.y, part));
        }
      }
      s[u] = part;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < RW; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
    float m_tile = -INFINITY;
#pragma unroll
    for (int u = 0; u < RW; ++u) {
      if (u >= rows_left) s[u] = -INFINITY;    // no key at all
      m_tile = fmaxf(m_tile, s[u]);
    }
    const float m_new = fmaxf(m_w, m_tile);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;   // no row yet
    const float corr = expf(m_w - m_use);
    float l_tile = 0.f;
    float2 pv[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
#pragma unroll
    for (int u = 0; u < RW; ++u) {
      const float p = expf(s[u] - m_use);
      l_tile += p;
      const float pr = round_to(p, T());   // P in V's dtype, as the TPU kernel
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int pp = lane + 32 * ii;
        if (pp < n_pair) {
          const float2 vv = load2(vs + (r0 + u) * dh + 2 * pp);
          pv[ii].x = fmaf(pr, vv.x, pv[ii].x);
          pv[ii].y = fmaf(pr, vv.y, pv[ii].y);
        }
      }
    }
    l_w = l_w * corr + l_tile;
    m_w = m_new;
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      acc[ii].x = fmaf(acc[ii].x, corr, pv[ii].x);
      acc[ii].y = fmaf(acc[ii].y, corr, pv[ii].y);
    }
  }
  cp_async_wait<0>();

  // merge the four warps' states into the split's (m, l, acc)
  if (lane == 0) {
    wm_s[warp] = m_w;
    wl_s[warp] = l_w;
  }
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int p = lane + 32 * ii;
    if (p < n_pair) {
      wacc_s[warp][2 * p] = acc[ii].x;
      wacc_s[warp][2 * p + 1] = acc[ii].y;
    }
  }
  __syncthreads();
  float m_s = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_s = fmaxf(m_s, wm_s[w]);   // finite
  float l_s = 0.f, acc_s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float f = expf(wm_s[w] - m_s);   // 0 for a warp with no row
    l_s = fmaf(wl_s[w], f, l_s);
    if (tid < dh) acc_s = fmaf(wacc_s[w][tid], f, acc_s);
  }
  T* out = static_cast<T*>(a.out) + bh * dh;
  if (n_live == 1) {                           // the whole context here
    if (tid < dh) store(out + tid, acc_s / l_s);
    return;
  }
  float* part = a.part + (bh * a.n_split + split) * (dh + 2);
  if (tid == 0) {
    part[0] = m_s;
    part[1] = l_s;
  }
  if (tid < dh) part[2 + tid] = acc_s;
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
  float l = 0.f, o = 0.f;
  for (int s = 0; s < n_live; ++s) {
    const float* ps = base + s * (dh + 2);
    const float f = expf(__ldcg(ps) - m);
    l = fmaf(__ldcg(ps + 1), f, l);
    if (tid < dh) o = fmaf(__ldcg(ps + 2 + tid), f, o);
  }
  if (tid < dh) store(out + tid, o / l);
  if (tid == 0) a.counter[bh] = 0;   // ready for the next launch
}

template <typename T>
int launch(const Args& a, int B, cudaStream_t s) {
  // once per instantiation, on the first (uncaptured) launch
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Tile<T>::kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(a.h, B, a.n_split);
  paged_decode_kernel<T><<<grid, kThreads, Tile<T>::kSmem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain-C entry for ctypes.  `part` is f32 scratch of B * h * n_split *
// (dh + 2) values; `counter` B * h int32 zeros, left zero on return of
// the kernel; `chunk` the context rows per split (a multiple of 32) and
// n_split = ceil(max_blocks * bs / chunk).  Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError() (0
// on success).
extern "C" int dl4j_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* pos, void* out, void* part, void* counter, int B, int h,
    int bs, int dh, int max_blocks, int chunk, float scale, int is_bf16,
    void* stream) {
  if (B <= 0 || h <= 0 || bs <= 0 || dh <= 0 || dh > kMaxDh || dh % 8 ||
      max_blocks <= 0 || chunk <= 0 || chunk % 32 || B > 65535)
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
  a.h = h;
  a.bs = bs;
  a.dh = dh;
  a.max_blocks = max_blocks;
  a.chunk = chunk;
  a.n_split = (max_blocks * bs + chunk - 1) / chunk;
  a.scale = scale;
  if (a.n_split > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, B, s) : launch<float>(a, B, s);
}
