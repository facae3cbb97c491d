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
//
// The wide build (dl4j_paged_decode_attention_wide): bf16 at every head
// dim in (128, 512] that is a multiple of 8 — zoo.Gpt(n_heads=4, 3, 2) at
// d 768 are 192, 256 and 384.  Same bound (the K/V bytes of the context);
// same grid, chunk, ticket and P rounding as v4.  What it does about the
// bytes:
// * whole pages by the copy engine.  A pool page of one (block, head) is
//   bs x dh contiguous elements (8 KB at bs 16, dh 256), so one thread
//   issues one cp.async.bulk for the page's K rows and one for its V
//   rows, both completing on the stage's mbarrier (expect_tx).  Only the
//   rows below the context are copied (a prefix of the page, still one
//   copy), and pages past it are never read: the table is read only
//   below the context;
// * a ring of n_stage = min(3, pages a split covers, kWideRingBytes /
//   page pair) stages, each one page of K and V (32 KB of K/V in flight
//   per block at bs 16, dh 256; the serving shape's 32-row chunks give
//   each block 2 pages, ~2.7 blocks an SM).  The ring is sized by bytes,
//   not by head dim: at dh 512 a 64-row page pair (128 KiB) takes the
//   ring alone;
// * each warp scores whole rows with one 16-byte shared load a lane a
//   vector (lane l holds q[8 l .. 8 l + 7], and past dh 256 also
//   q[8 (l + 32) ..]) and keeps its own online softmax over the rows
//   warp, warp + 4, ... of every page, four at once, with P rounded to
//   bf16 at its running max as v4.  The head dim is a template constant
//   at the multiples of 64 and a runtime value elsewhere: two builds,
//   kVec 1 and 2, serve every other multiple of 8 (a dh read at run time
//   is slower at 192 and 256 on an H100, so the multiples of 64 keep
//   folded builds; `scripts/paged_turns.py --runtime-dh` times both);
// * the warps' accumulators merge through the ring once it is free, so a
//   block's shared memory is its ring (33 KB at the serving shape, 6
//   blocks an SM at dh 256, 8 at 192);
// * the last split's merge keeps its loads in flight together: a
//   partial is acc[dh] then (m, l) (rows of dh + 4 floats, read as
//   float4), each thread reads one split's (m, l), and 128 / (dh / 4)
//   groups of the block sum alternate splits of each float4 column — a
//   window of 128 splits at a time under a running max.
// Split edges must fall on page edges: the wrapper sends a call here only
// where bs divides the chunk and a page pair fits the ring; the entry
// refuses every other call, q or pools off 16-byte alignment included
// (the wrapper raises).  A head dim that is not a multiple of 8, f32 past
// 128, bf16 past 512, and the block sizes this build does not take go to
// paged_any_dh.cuh's kernel through dl4j_paged_decode_attention_any.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "paged_any_dh.cuh"

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

// ---------------------------------------------------------------------------
// the wide build: bf16 at head dims 136 .. 512 (multiples of 8), pages by
// bulk copy
// ---------------------------------------------------------------------------
constexpr int kWideStages = 3;    // ring stages at most, one page of K and V each
constexpr int kWideMaxDh = 512;   // the widest head dim (kVec 2: 64 lanes of 8)
constexpr int kWideRows = 4;      // rows a warp scores at once
// The ring's bytes: three stages of 64-row pages at dh 256 (K and V, bf16),
// the largest ring this build ran with at 192 and 256.  A launch takes
// n_stage = min(3, chunk / bs, kWideRingBytes / (2 bs dh 2)) stages: at
// dh 512 a 64-row page pair is 128 KiB (one stage), at bs 16 32 KiB (three
// stages, 96 KiB).  A page pair above the ring (bs dh > 49,152) is
// refused (wide_decode_takes in the wrapper).
constexpr size_t kWideRingBytes = (size_t)kWideStages * 2 * 64 * 256 * sizeof(__nv_bfloat16);
// static shared memory beside the ring: the barriers, the warps' (m, l),
// the merge's weights, the flag.  The warps' accumulators (kWarps x dh
// f32) go over the ring once it is free, so the dynamic part is the
// larger of the two (wide_dynamic_bytes) and the static part stays small:
// at the serving shape (2 stages of 16-row pages, dh 256) a block holds
// 33 KB, 6 blocks an SM
constexpr size_t kWideStatic = kWideStages * sizeof(uint64_t) + 2 * kWarps * sizeof(float) +
                               kThreads * sizeof(float) + sizeof(int);
static_assert(kWideRingBytes >= (size_t)kWarps * kWideMaxDh * sizeof(float) &&
                  kWideRingBytes + kWideStatic <= 232448,
              "the ring holds the accumulators, and it and the static buffers fit a "
              "block's shared memory");
// a split's partial: acc[dh], then m and l, padded to a whole float4 (so
// the merge reads acc as float4)
__host__ __device__ constexpr int wide_part_floats(int dh) { return dh + 4; }

// ring stages of a launch: min(kWideStages, chunk / bs, what kWideRingBytes
// holds); 0 where one page pair does not fit
inline int wide_stages(int bs, int dh, int chunk) {
  const size_t pair = (size_t)2 * bs * dh * sizeof(__nv_bfloat16);
  const size_t fit = kWideRingBytes / pair;
  int n = chunk / bs < kWideStages ? chunk / bs : kWideStages;
  return fit < (size_t)n ? (int)fit : n;
}

struct WideArgs {
  Args a;
  int n_stage;   // wide_stages(bs, dh, chunk)
};

__device__ __forceinline__ void unpack8(float (&f)[8], const uint4& v) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(p[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}

// kVec: 16-byte vectors of a row a lane holds (1 up to dh 256, 2 up to
// 512): lane l holds columns [8 l, 8 l + 8) and, with kVec 2, [8 (l + 32),
// 8 (l + 32) + 8), none past dh.  DH: the head dim as a compile-time
// constant (the multiples of 64, Gpt(n_heads=4, 3, 2)'s 192, 256 and 384
// among them: every offset folded), or 0: read at run time (the other
// multiples of 8, one build a kVec)
template <int kVec, int DH>
__global__ void __launch_bounds__(kThreads)
paged_decode_wide_kernel(const WideArgs wa) {
  using bf16 = __nv_bfloat16;
  const Args& a = wa.a;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kWideStages];
  __shared__ float wm_s[kWarps], wl_s[kWarps];
  __shared__ float wt_s[kThreads];   // the merge's weights of a window of splits
  __shared__ int last_s;

  const int head = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int h = a.h, bs = a.bs, dh = DH ? DH : a.dh, n_stage = wa.n_stage;
  const int n_vec = dh / 8;                       // 16-byte vectors a row
  const int n_ctx = min(a.pos[b] + 1, a.max_blocks * bs);
  const int c0 = split * a.chunk;
  if (c0 >= n_ctx) return;                        // a dead split
  const int c1 = min(n_ctx, c0 + a.chunk);
  const int n_live = (n_ctx + a.chunk - 1) / a.chunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* tbl = a.table + (long long)b * a.max_blocks;
  const bf16* kp = static_cast<const bf16*>(a.k_pool);
  const bf16* vp = static_cast<const bf16*>(a.v_pool);
  const long long bh = (long long)b * h + head;
  const int page0 = c0 / bs;                      // c0 sits on a page edge
  const int n_pages = (c1 - 1) / bs - page0 + 1;
  const int page = bs * dh;                       // elements of one page
  bf16* ring = reinterpret_cast<bf16*>(smem);     // [stage][K page, V page]
  float* wacc = reinterpret_cast<float*>(smem);   // [warp][dh], once the ring is free
  const uint32_t bar0 = flash::smem_u32(bars);

  if (tid == 0) {
    for (int i = 0; i < n_stage; ++i) flash::mbar_init(bar0 + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // page i of the split (pool block `blk`) into its stage: its rows
  // below c1 (a prefix of the page, contiguous in the pool), K then V
  auto issue = [&](int i, int blk) {
    const int rows = min(bs, c1 - (page0 + i) * bs);
    const uint32_t bytes = (uint32_t)rows * dh * 2;
    const long long off = ((long long)blk * h + head) * page;
    bf16* ks = ring + (i % n_stage) * 2 * page;
    const uint32_t bar = bar0 + 8 * (i % n_stage);
    flash::mbar_expect(bar, 2 * bytes);
    flash::bulk_g2s(flash::smem_u32(ks), kp + off, bytes, bar);
    flash::bulk_g2s(flash::smem_u32(ks + page), vp + off, bytes, bar);
  };
  if (tid == 0) {
    int blk[kWideStages];   // the first pages' table entries, loaded together
#pragma unroll
    for (int i = 0; i < kWideStages; ++i)
      blk[i] = i < n_stage && i < n_pages ? tbl[page0 + i] : 0;
#pragma unroll
    for (int i = 0; i < kWideStages; ++i)
      if (i < n_stage && i < n_pages) issue(i, blk[i]);
  }

  // q, scaled: lane l holds columns [8 (l + 32 v), + 8) (none past dh)
  float qv[kVec][8], acc[kVec][8];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
#pragma unroll
    for (int e = 0; e < 8; ++e) qv[v][e] = acc[v][e] = 0.f;
    if (lane + 32 * v < n_vec) {
      unpack8(qv[v], *reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.q) + bh * dh +
                                                     8 * (lane + 32 * v)));
#pragma unroll
      for (int e = 0; e < 8; ++e) qv[v][e] *= a.scale;
    }
  }

  float m_w = -INFINITY, l_w = 0.f;
  for (int i = 0; i < n_pages; ++i) {
    const int st = i % n_stage;
    // the table entry of the page that refills this stage, read early
    const int blk_next = tid == 0 && i + n_stage < n_pages ? tbl[page0 + i + n_stage] : 0;
    flash::mbar_wait(bar0 + 8 * st, (i / n_stage) & 1);
    const bf16* ks = ring + st * 2 * page;
    const bf16* vs = ks + page;
    const int rows = min(bs, c1 - (page0 + i) * bs);   // rows past c1 never read
    for (int r0 = warp; r0 < rows; r0 += kWarps * kWideRows) {
      float s[kWideRows];
#pragma unroll
      for (int u = 0; u < kWideRows; ++u) {
        const int r = r0 + kWarps * u;
        float part = 0.f;
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const int c = lane + 32 * v;
          if (r < rows && c < n_vec) {
            float kf[8];
            unpack8(kf, *reinterpret_cast<const uint4*>(ks + r * dh + 8 * c));
#pragma unroll
            for (int e = 0; e < 8; ++e) part = fmaf(qv[v][e], kf[e], part);
          }
        }
        s[u] = part;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < kWideRows; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
      float m_tile = -INFINITY;
#pragma unroll
      for (int u = 0; u < kWideRows; ++u) {
        if (r0 + kWarps * u >= rows) s[u] = -INFINITY;   // no key at all
        m_tile = fmaxf(m_tile, s[u]);
      }
      const float m_new = fmaxf(m_w, m_tile);    // finite: row r0 is live
      const float corr = expf(m_w - m_new);      // 0 on the warp's first rows
      float l_tile = 0.f, pv[kVec][8];
#pragma unroll
      for (int v = 0; v < kVec; ++v)
#pragma unroll
        for (int e = 0; e < 8; ++e) pv[v][e] = 0.f;
#pragma unroll
      for (int u = 0; u < kWideRows; ++u) {
        const int r = r0 + kWarps * u;
        if (r >= rows) continue;
        const float p = expf(s[u] - m_new);
        l_tile += p;
        const float pr = round_to(p, bf16());   // P in V's dtype, as v4
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const int c = lane + 32 * v;
          if (c < n_vec) {
            float vf[8];
            unpack8(vf, *reinterpret_cast<const uint4*>(vs + r * dh + 8 * c));
#pragma unroll
            for (int e = 0; e < 8; ++e) pv[v][e] = fmaf(pr, vf[e], pv[v][e]);
          }
        }
      }
      l_w = l_w * corr + l_tile;
      m_w = m_new;
#pragma unroll
      for (int v = 0; v < kVec; ++v)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[v][e] = fmaf(acc[v][e], corr, pv[v][e]);
    }
    __syncthreads();   // every warp is done with stage st ...
    if (tid == 0 && i + n_stage < n_pages) issue(i + n_stage, blk_next);   // ... refill it
  }

  // merge the four warps' states into the split's (m, l, acc); every
  // warp is past the loop's last barrier, so the ring is free
  if (lane == 0) {
    wm_s[warp] = m_w;
    wl_s[warp] = l_w;
  }
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const int c = lane + 32 * v;
    if (c < n_vec) {
      *reinterpret_cast<float4*>(wacc + warp * dh + 8 * c) =
          make_float4(acc[v][0], acc[v][1], acc[v][2], acc[v][3]);
      *reinterpret_cast<float4*>(wacc + warp * dh + 8 * c + 4) =
          make_float4(acc[v][4], acc[v][5], acc[v][6], acc[v][7]);
    }
  }
  __syncthreads();
  float m_s = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_s = fmaxf(m_s, wm_s[w]);   // finite (warp 0 saw c0)
  float f[kWarps], l_s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    f[w] = expf(wm_s[w] - m_s);                  // 0 for a warp with no row
    l_s = fmaf(wl_s[w], f[w], l_s);
  }
  bf16* out = static_cast<bf16*>(a.out) + bh * dh;
  const int kPart = wide_part_floats(dh);       // acc[dh], m, l, pad
  float* part = a.part + (bh * a.n_split + split) * kPart;
  for (int d = tid; d < dh; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o = fmaf(wacc[w * dh + d], f[w], o);
    if (n_live == 1)                             // the whole context here
      store(out + d, o / l_s);
    else
      part[d] = o;
  }
  if (n_live == 1) return;
  if (tid == 0) {
    part[dh] = m_s;
    part[dh + 1] = l_s;
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
  // the last split: merge every live split's partial (read past L1), a
  // window of 128 splits at a time (one a thread) under a running max:
  // each thread reads its split's (m, l), the block reduces the window's
  // max, the splits' weights exp(m_s - m) go to shared memory, and
  // n_grp = 128 / (dh / 4) groups of the block (3 at dh 136-168, 2 at
  // 176-256, 1 past 256) sum alternate splits of each float4 column of
  // acc, so the window's loads are in flight together
  const float* base = a.part + bh * a.n_split * kPart;
  const int n_c4 = dh / 4;                      // float4 columns of acc
  const int n_grp = kThreads / n_c4;            // >= 1: dh <= 512
  const int c4 = tid % n_c4, grp = tid / n_c4;  // grp >= n_grp idles
  float m = -INFINITY, l = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < n_live; s0 += kThreads) {
    const int n = min(kThreads, n_live - s0);
    const float2 ml = tid < n ? __ldcg(reinterpret_cast<const float2*>(
                                    base + (s0 + tid) * kPart + dh))
                              : make_float2(-INFINITY, 0.f);
    float mw = flash::warp_max(ml.x);
    __syncthreads();   // the last window's maxima and weights are consumed
    if (lane == 0) wm_s[warp] = mw;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mw = fmaxf(mw, wm_s[w]);
    const float m_new = fmaxf(m, mw);            // finite: every split saw a row
    const float sc = expf(m - m_new);            // 0 on the first window
    l *= sc;
    o = make_float4(o.x * sc, o.y * sc, o.z * sc, o.w * sc);
    m = m_new;
    if (tid < n) {
      const float wgt = expf(ml.x - m);
      wt_s[tid] = wgt;
      l = fmaf(ml.y, wgt, l);
    }
    __syncthreads();
    if (grp < n_grp) {
      const float* ps = base + s0 * kPart + 4 * c4;
#pragma unroll 8
      for (int s = grp; s < n; s += n_grp) {
        const float4 x = __ldcg(reinterpret_cast<const float4*>(ps + s * kPart));
        const float wgt = wt_s[s];
        o = make_float4(fmaf(x.x, wgt, o.x), fmaf(x.y, wgt, o.y), fmaf(x.z, wgt, o.z),
                        fmaf(x.w, wgt, o.w));
      }
    }
  }
  l = flash::warp_sum(l);
  __syncthreads();   // every thread has read wm_s and wt_s
  if (lane == 0) wl_s[warp] = l;
  // groups 1 .. n_grp - 1 hand their sums to group 0 through wacc
  float* red = wacc;
  if (grp > 0 && grp < n_grp) *reinterpret_cast<float4*>(red + (grp - 1) * dh + 4 * c4) = o;
  __syncthreads();
  if (grp == 0) {
    for (int g2 = 1; g2 < n_grp; ++g2) {
      const float4 x = *reinterpret_cast<const float4*>(red + (g2 - 1) * dh + 4 * c4);
      o = make_float4(o.x + x.x, o.y + x.y, o.z + x.z, o.w + x.w);
    }
    float lt = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) lt += wl_s[w];
    const float inv = 1.f / lt;
    uint32_t* o2 = reinterpret_cast<uint32_t*>(out + 4 * c4);
    o2[0] = flash::pack_bf16(o.x * inv, o.y * inv);
    o2[1] = flash::pack_bf16(o.z * inv, o.w * inv);
  }
  if (tid == 0) a.counter[bh] = 0;   // ready for the next launch
}

// dynamic shared memory of a launch: the ring, or the warps' accumulators
// where they are larger (pages of under 4 rows)
inline size_t wide_dynamic_bytes(int bs, int dh, int n_stage) {
  const size_t ring = (size_t)n_stage * 2 * bs * dh * sizeof(__nv_bfloat16);
  const size_t accs = (size_t)kWarps * dh * sizeof(float);
  return ring > accs ? ring : accs;
}

template <int kVec, int DH>
int launch_wide(const WideArgs& wa, int B, cudaStream_t s) {
  // once per instantiation, on the first (uncaptured) launch
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_wide_kernel<kVec, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kWideRingBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(wa.a.h, B, wa.a.n_split);
  paged_decode_wide_kernel<kVec, DH>
      <<<grid, kThreads, wide_dynamic_bytes(wa.a.bs, wa.a.dh, wa.n_stage), s>>>(wa);
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

// Any head dim (one query row a slot): paged_any_dh.cuh's kernel.
// `part` and `counter` as dl4j_paged_decode_part_floats and
// dl4j_paged_decode_counters say for build 2 (counters int32 zeros, left
// zero); n_split = ceil(max_blocks * bs / chunk).  Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError() (0 on success).
extern "C" int dl4j_paged_decode_attention_any(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* pos, void* out, void* part, void* counter, int B, int h,
    int bs, int dh, int max_blocks, int chunk, float scale, int is_bf16,
    void* stream) {
  return paged_any_dh::launch(q, k_pool, v_pool, table, pos, out, part,
                              counter, B, 1, h, bs, dh, max_blocks, chunk,
                              scale, is_bf16, stream);
}

// The wide build: bf16 at dh in (128, 512], a multiple of 8, whole pages
// by bulk copy.  Arguments as dl4j_paged_decode_attention, but `part`
// holds B * h * n_split * (dh + 4) f32 (acc, then m and l); `chunk` a
// multiple of bs (split edges on page edges), a page pair of at most
// kWideRingBytes (4 bs dh <= 196,608), q and the pools 16-byte aligned.
// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for a call
// this build does not take.
extern "C" int dl4j_paged_decode_attention_wide(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* pos, void* out, void* part, void* counter, int B, int h,
    int bs, int dh, int max_blocks, int chunk, float scale, int is_bf16,
    void* stream) {
  if (!is_bf16 || dh <= kMaxDh || dh > kWideMaxDh || dh % 8 || B <= 0 || h <= 0 ||
      bs <= 0 || max_blocks <= 0 || chunk <= 0 || chunk % bs || B > 65535 ||
      wide_stages(bs, dh, chunk) < 1 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_pool) |
       reinterpret_cast<uintptr_t>(v_pool)) % 16)
    return (int)cudaErrorInvalidValue;
  WideArgs wa;
  Args& a = wa.a;
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
  wa.n_stage = wide_stages(bs, dh, chunk);
  if (a.n_split > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {   // the multiples of 64 with dh folded, the rest at run time
    case 192: return launch_wide<1, 192>(wa, B, s);
    case 256: return launch_wide<1, 256>(wa, B, s);
    case 320: return launch_wide<2, 320>(wa, B, s);
    case 384: return launch_wide<2, 384>(wa, B, s);
    case 448: return launch_wide<2, 448>(wa, B, s);
    case 512: return launch_wide<2, 512>(wa, B, s);
    default: return dh <= 256 ? launch_wide<1, 0>(wa, B, s) : launch_wide<2, 0>(wa, B, s);
  }
}

// f32 values of split-partial scratch one launch needs, by build (0: the
// v4 entry, whose partial is (m, l, acc[dh]); 1: the wide build, acc[dh],
// m, l and a pad; 2: the any-dh kernel), for B slots of W query rows
// (1 here), h heads, head dim dh and n_split splits.  The wrapper sizes
// its scratch from this, so each layout is known here alone.
extern "C" long long dl4j_paged_decode_part_floats(int build, int B, int W,
                                                  int h, int dh,
                                                  int n_split) {
  if (build == 2) return paged_any_dh::part_floats(B, W, h, dh, n_split);
  return (long long)B * h * n_split * (build == 1 ? wide_part_floats(dh) : dh + 2);
}

// int32 ticket counters one launch needs, by build as above: one a (slot,
// head), and on the any-dh kernel one a (row, head, column slab).
extern "C" long long dl4j_paged_decode_counters(int build, int B, int W, int h,
                                               int dh) {
  if (build == 2) return paged_any_dh::counters(B, W, h, dh);
  return (long long)B * h;
}
