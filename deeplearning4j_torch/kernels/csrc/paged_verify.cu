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
// bytes; the work is 4 * W flops per K/V element pair, ~W flops per byte,
// far below the ~295 flops per byte where the H100 turns compute-bound.
// The least time is those bytes over the card's 3.35 TB/s.
//
// Design (v3: K1's split-K, paged_decode.cu, with W rows a block):
// * grid (h * n_grp, B, S): the W rows go in groups of 16 (one group for
//   W <= 16; any W), and split s of a (slot, head, group) covers context
//   rows [s C, (s+1) C) for a chunk C (a multiple of the 64-key tile) the
//   wrapper picks from the table's capacity, never from pos0 (no host
//   read).  A block reads pos0[b] itself; a split at or past the group's
//   context min(pos0 + w0 + rows, max_blocks * bs) exits at once.  The
//   table is read only for rows below that context, so the walk never
//   reaches an entry at or past max_blocks;
// * inside a split, 64-key tiles of K and V stream through a two-stage
//   cp.async ring (the copies of tile i + 1 fly while tile i computes),
//   rows past the split zero-filled and never read;
// * each of the 4 warps takes 16 keys of every tile and keeps its own
//   online-softmax state for the group's 16 rows.  In bf16 the group's
//   rows are one mma.sync m16n8k16 A fragment (rows >= W are zeros):
//   S = Q K^T for the warp's keys is 2 x dh/16 tensor-core products with
//   K read straight from the padded tile, and P (rounded to bf16 at the
//   warp's running max, as K1 rounds it) becomes the A fragment of P.V
//   (V through ldmatrix.trans).  Keys that only deeper rows may see
//   (the last rows - 1 of the context) never enter a shallower row as
//   0 * NaN: they take a scalar P.V that skips each (row, key) pair the
//   mask hides, and their V rows are zeroed before the warp's tensor-core
//   P.V.  f32 takes the scalar P.V for every key (f32 scores are plain
//   FMAs too, so an f32 run has f32 products);
// * a split's four warps merge through shared memory into its partial
//   (acc[dh], m, l for each row below W) in f32 scratch; the last live
//   split of a (slot, head, group) — told by a __threadfence() and an
//   atomicAdd ticket on its counter — reads every partial's (m, l) at
//   once, rescales each partial by exp(m_s - m) (float4 loads), sums,
//   divides by the total l, writes the rows below W, and resets the
//   counter to 0 for the next launch.  A group whose context fits one
//   split writes its rows directly.
// Templated on float and bf16; dh <= 128 and a multiple of 8.
//
// The wide build (dl4j_paged_verify_attention_wide): bf16 at every head
// dim in (128, 512] that is a multiple of 8 (zoo.Gpt(n_heads=4, 3, 2) at
// d 768 are 192, 256 and 384).  Same bound: the slot's context rows read
// once for all W rows; at these widths the any-dh kernel read them once a
// row, W times the bytes.  What it does about them:
// * v3's grid (h * n_grp, B, S), chunk and last-split merge: each block
//   takes a group of 16 rows, so every page of the context is read once
//   per (slot, head, row group);
// * width classes: the kernel is compiled for DHP = 192, 256, ..., 512,
//   each twice: with dh == DHP folded (kExact) and with dh in (DHP - 64,
//   DHP) read at run time.  Tiles and split partials are laid out at DHP
//   (so each warp owns DHP / 4 output columns, an even number of 8-column
//   blocks, as P.V's paired ldmatrix needs — dh 160 / 4 / 8 is 5 — and
//   the last split's merge has compile-time offsets: computed from a
//   runtime dh they made K2 far slower at 192 and 256 on an H100, and
//   the rest of a runtime dh some; `scripts/paged_turns.py --runtime-dh`
//   times what folding dh buys); the copies
//   move dh columns a row; the pad columns [dh, DHP) of every ring row and
//   of Q are zeroed once per block before the first copy (the copies
//   never write them, and a non-finite pad of K would put 0 x NaN into
//   every score); Q K^T runs ceil(dh / 16) k-steps, P.V skips each warp's
//   column blocks past dh, and no column past dh is stored;
// * 64-key tiles of K and V arrive by the copy engine: warp 0 issues one
//   cp.async.bulk per context row of K and of V (dh * 2 bytes, a row of
//   its page) into rows of DHP + 8 elements, a pitch that ldmatrix and
//   the fragment loads read without bank conflicts, all completing on the
//   stage's mbarrier.  The ring holds min(kStages, tiles a split covers)
//   stages, kStages = 2 where two fit a block's shared memory beside Q
//   and P (DHP <= 384) and 1 past (WideLayout's static_assert holds each
//   class to 232,448 bytes); rows past the split are never copied (the
//   table is read only below the group's context);
// * both products on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//   accumulate).  Q K^T: each of the 4 warps scores 16 keys of the tile
//   for the 16 rows, Q's fragments read from shared memory each k-step
//   (16 x 256 of Q would take 64 registers a thread).  A block-wide row
//   max over the tile (through shared memory) gives every warp the same
//   running max, so P is rounded to bf16 once, staged in shared memory,
//   and P.V splits the OUTPUT columns: warp w owns DHP / 4 of them (a
//   16 x 64 accumulator, 32 registers a thread at 256; 64 at 512) over
//   all 64 keys.  The 0 x NaN rule of v3 holds: keys the group's first
//   row does not see (k > pos0 + w0: seen by deeper rows only) and rows
//   past the context take a scalar P.V that skips each (row, key) pair
//   the mask hides, then each warp zeroes its columns of those V rows
//   before its tensor-core product;
// * the four warps share the running max and denominator, so a split's
//   partial needs no merge across warps: each warp writes its columns.
//   The last split's merge reads each split's (m, l) once (16 lanes a
//   row) and keeps four splits' float4 columns in flight a thread.
// A head dim that is not a multiple of 8, f32 past 128 and bf16 past 512
// take paged_any_dh.cuh's kernel (each query row on its own) through
// dl4j_paged_verify_attention_any.
#include "flash_common.cuh"
#include "paged_any_dh.cuh"

using namespace flash;

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;      // query rows a block takes: one A fragment
// a partial row of v3 (width dh) and of the wide build (width DHP):
// acc[width], then m and l, padded to a whole float4
__host__ __device__ constexpr int part_row_floats(int width) { return width + 4; }
constexpr int kTile = 64;       // keys per tile, 16 a warp
constexpr int kStages = 2;
constexpr int kMaxDh = 128;
constexpr int kMaxNd = kMaxDh / 8;   // output column blocks of 8
constexpr int kMaxSplit = 512;       // splits the last split's merge takes

template <typename T>
struct Layout {
  static constexpr int kVec = 16 / (int)sizeof(T);   // elements per 16 bytes
  static constexpr int LD = kMaxDh + kVec;            // padded row pitch
  static constexpr size_t kTileBytes = (size_t)kTile * LD * sizeof(T);
  static constexpr size_t kK = 0;
  static constexpr size_t kV = kStages * kTileBytes;
  static constexpr size_t kQ = 2 * kStages * kTileBytes;
  static constexpr size_t kQBytes = (size_t)kGroup * LD * sizeof(T);
  // P of the scalar path, [warp][row][key]; bf16 holds Q in registers
  // once the loop starts, so P reuses Q's place there
  static constexpr size_t kP = sizeof(T) == 2 ? kQ : kQ + kQBytes;
  static constexpr size_t kPBytes = (size_t)kWarps * kGroup * 16 * sizeof(float);
  static constexpr size_t kBytes = (kP + kPBytes > kQ + kQBytes ? kP + kPBytes : kQ + kQBytes);
  // after the loop the ring holds each warp's (acc[dh], m, l) per row
  // (rows of 16-byte-aligned float4s), then the last split's (m, l) of
  // every (split, row)
  static constexpr int kWp = kMaxDh + 4;
  static_assert((size_t)kWarps * kGroup * kWp * sizeof(float) <= 2 * kStages * kTileBytes &&
                    2 * (size_t)kMaxSplit * kGroup * sizeof(float) <= 2 * kStages * kTileBytes,
                "the merge buffers fit the ring");
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

// 16-byte global -> shared copy; with `full` false the 16 bytes are
// zero-filled and nothing is read from `src`
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* table;
  const int* pos0;
  void* out;
  float* part;       // [B, h, n_grp, S, 16, dh + 4] f32: acc[dh], m, l per row
  int* counter;      // [B * h * n_grp] int32, 0 between launches
  int W, h, bs, dh, max_blocks, chunk, n_split, n_grp;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const Args a) {
  using L = Layout<T>;
  constexpr int LD = L::LD, kVec = L::kVec;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_ring = reinterpret_cast<T*>(smem + L::kK);
  T* v_ring = reinterpret_cast<T*>(smem + L::kV);
  T* q_s = reinterpret_cast<T*>(smem + L::kQ);
  float* p_s = reinterpret_cast<float*>(smem + L::kP);
  __shared__ float wf_s[kWarps][kGroup], m_s[kGroup], l_s[kGroup];
  __shared__ int last_s;

  const int grp = blockIdx.x % a.n_grp, head = blockIdx.x / a.n_grp;
  const int b = blockIdx.y, split = blockIdx.z;
  const int h = a.h, dh = a.dh;
  const int w0 = grp * kGroup;
  const int n_rows = min(kGroup, a.W - w0);
  const int p0 = a.pos0[b] + w0;                      // the group's row 0
  const int n_ctx = min(p0 + n_rows, a.max_blocks * a.bs);
  const int c0 = split * a.chunk;
  if (c0 >= n_ctx) return;                            // a dead split
  const int c1 = min(n_ctx, c0 + a.chunk);
  const int n_live = (n_ctx + a.chunk - 1) / a.chunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int* tbl = a.table + (long long)b * a.max_blocks;
  const T* kp = static_cast<const T*>(a.k_pool);
  const T* vp = static_cast<const T*>(a.v_pool);
  const long long bh = (long long)b * h + head;
  const int cidx = (int)bh * a.n_grp + grp;

  const int vec_per_row = dh / kVec;
  const int n_tiles = (c1 - c0 + kTile - 1) / kTile;
  // issue tile i's copies into its stage (rows past the split are
  // zero-filled; the table is read only for rows below c1 <= n_ctx)
  auto issue = [&](int i) {
    if (i < n_tiles) {
      const int j0 = c0 + i * kTile;
      T* ks = k_ring + (i % kStages) * kTile * LD;
      T* vs = v_ring + (i % kStages) * kTile * LD;
      for (int c = tid; c < kTile * vec_per_row; c += kThreads) {
        const int r = c / vec_per_row;
        const int w = c - r * vec_per_row;
        const int j = j0 + r;
        const bool live = j < c1;
        long long off = 0;
        if (live) off = (((long long)tbl[j / a.bs] * h + head) * a.bs + (j % a.bs)) * dh;
        cp_async16(ks + r * LD + w * kVec, kp + off + w * kVec, live);
        cp_async16(vs + r * LD + w * kVec, vp + off + w * kVec, live);
      }
    }
    cp_async_commit();   // an empty group past the last tile keeps counts
  };
  issue(0);

  // the group's rows of q, zero past dh and for rows >= W; the K columns
  // [dh, dh rounded up to 16) zero in both stages (the last k-step of
  // the score product reads them; the copies never write them)
  const int dh16 = (dh + 15) / 16 * 16;
  for (int i = tid; i < kGroup * kMaxDh; i += kThreads) {
    const int r = i / kMaxDh, d = i - r * kMaxDh;
    const T* qrow = static_cast<const T*>(a.q) + (((long long)b * a.W + w0 + r) * h + head) * dh;
    q_s[r * LD + d] = r < n_rows && d < dh ? qrow[d] : from_float<T>(0.f);
  }
  for (int i = tid; i < kStages * kTile * (dh16 - dh); i += kThreads) {
    const int r = i / (dh16 - dh);
    k_ring[r * LD + dh + (i - r * (dh16 - dh))] = from_float<T>(0.f);
  }
  __syncthreads();
  const int nk = dh16 / 16;   // k-steps of the score product
  uint32_t qf[kMaxDh / 16][4];
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < kMaxDh / 16; ++kk)
      if (kk < nk)
        load_a<LD>(qf[kk], reinterpret_cast<const __nv_bfloat16*>(q_s), 0, 16 * kk, g, qd);
  }

  // this warp's online-softmax state of rows g and g + 8 (the lanes of a
  // quad hold parts of l; m is the quad's) and its accumulator fragment
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float acc[kMaxNd][4];
#pragma unroll
  for (int j = 0; j < kMaxNd; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float* pw = p_s + warp * kGroup * 16;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();   // tile i has landed (this thread's part)
    __syncthreads();       // ... everyone's; tile i - 1 consumed
    issue(i + 1);
    const T* ks = k_ring + (i % kStages) * kTile * LD;
    T* vs = v_ring + (i % kStages) * kTile * LD;
    const int kw = c0 + i * kTile + 16 * warp;   // this warp's first key

    // S = Q K^T over the warp's 16 keys, [16 rows] x [2 x 8 keys]
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (kBf16) {
      const __nv_bfloat16* kb = reinterpret_cast<const __nv_bfloat16*>(ks);
#pragma unroll
      for (int kk = 0; kk < kMaxDh / 16; ++kk)
        if (kk < nk) mma_abt<2, LD>(s, qf[kk], kb, 16 * warp, 16 * kk, g, qd);
    } else {
      for (int d = 0; d < dh; d += 4) {
        float4 qv[2], kv[2][2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          qv[r] = *reinterpret_cast<const float4*>(q_s + (g + 8 * r) * LD + d);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            kv[j][c] =
                *reinterpret_cast<const float4*>(ks + (16 * warp + 8 * j + 2 * qd + c) * LD + d);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 x = qv[e >> 1], y = kv[j][e & 1];
            s[j][e] = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w, s[j][e]))));
          }
      }
    }

    // mask (row r sees key k iff r < rows, k < c1 and k <= p0 + r), then
    // the online-softmax update of each row over the warp's keys
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1);
        const int key = kw + 8 * j + 2 * qd + (e & 1);
        const bool vis = r < n_rows && key < c1 && key <= p0 + r;
        s[j][e] = vis ? s[j][e] * a.scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const float m_new = fmaxf(m_r[r2], quad_max(mx[r2]));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;   // no key yet
      const float corr = expf(m_r[r2] - m_use);                // 0 on the first
      m_r[r2] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 2 * r2; e < 2 * r2 + 2; ++e) {
          const float p = expf(s[j][e] - m_use);   // 0 where masked
          sum += p;
          s[j][e] = round_to(p, T());   // P in V's dtype, as the TPU kernel
        }
      l_r[r2] = l_r[r2] * corr + sum;
#pragma unroll
      for (int jd = 0; jd < kMaxNd; ++jd) {
        acc[jd][2 * r2] *= corr;
        acc[jd][2 * r2 + 1] *= corr;
      }
    }

    // acc += P V.  Keys every row sees (k <= p0) and the zero rows past
    // the split go through the tensor cores; the hidden ones — keys k >
    // p0 that only deeper rows see, at most rows - 1 of them, in the last
    // warp or two of the context — through a scalar loop that skips each
    // (row, key) pair the mask hides, after which the warp zeroes their V
    // rows (only it reads them) so the tensor-core product adds nothing
    // for them.  f32 takes the scalar loop for every key
    const int k_hid = kBf16 ? max(0, p0 + 1 - kw) : 0;   // the warp's first scalar key
    const int k_end = min(16, c1 - kw);                  // past its last live key
    if (k_hid < k_end) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pw[(g + 8 * (e >> 1)) * 16 + 8 * j + 2 * qd + (e & 1)] = s[j][e];
      __syncwarp();
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int r = g + 8 * r2;
        const int n_vis = r < n_rows ? max(0, min(16, min(p0 + r + 1, c1) - kw)) : 0;
        for (int kk = k_hid; kk < n_vis; ++kk) {
          const float p = pw[r * 16 + kk];
          const T* vrow = vs + (16 * warp + kk) * LD + 2 * qd;
#pragma unroll
          for (int jd = 0; jd < kMaxNd; ++jd) {
            if (8 * jd < dh) {
              const float2 vv = load2(vrow + 8 * jd);
              acc[jd][2 * r2] = fmaf(p, vv.x, acc[jd][2 * r2]);
              acc[jd][2 * r2 + 1] = fmaf(p, vv.y, acc[jd][2 * r2 + 1]);
            }
          }
        }
      }
      __syncwarp();
      if constexpr (kBf16) {
        const int n_vec = dh / kVec;
        for (int c = lane; c < (k_end - k_hid) * n_vec; c += 32) {
          const int kk = k_hid + c / n_vec;
          *reinterpret_cast<uint4*>(vs + (16 * warp + kk) * LD + (c % n_vec) * kVec) =
              make_uint4(0u, 0u, 0u, 0u);
        }
        __syncwarp();
      }
    }
    if constexpr (kBf16) {
      uint32_t pf[4];
      pack_a<2>(pf, s, 0);
      mma_ab<kMaxNd, LD>(acc, pf, reinterpret_cast<const __nv_bfloat16*>(vs), 16 * warp, lane,
                         dh);
    }
  }
  cp_async_wait_all();
  __syncthreads();   // the ring is free: it takes the warps' states

  // each warp's (acc[dh], m, l) per row, then the split's; rows of
  // partials are dh + 4 floats (acc, then m and l), so acc reads as float4
  constexpr int WP = L::kWp;
  float* wbuf = reinterpret_cast<float*>(smem);   // [kWarps][kGroup][WP]
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    float* row = wbuf + (warp * kGroup + g + 8 * r2) * WP;
    const float l = quad_sum(l_r[r2]);
    if (qd == 0) {
      row[kMaxDh] = m_r[r2];
      row[kMaxDh + 1] = l;
    }
#pragma unroll
    for (int jd = 0; jd < kMaxNd; ++jd)
      if (8 * jd < dh)
        *reinterpret_cast<float2*>(row + 8 * jd + 2 * qd) =
            make_float2(acc[jd][2 * r2], acc[jd][2 * r2 + 1]);
  }
  __syncthreads();
  // per row (below W): the split's max, each warp's weight in it (0 for a
  // warp that saw no key) and the split's denominator; then the split's
  // rows, written out (one split) or as its partial
  if (tid < n_rows) {
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wbuf[(w * kGroup + tid) * WP + kMaxDh]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* row = wbuf + (w * kGroup + tid) * WP + kMaxDh;
      const float f = row[0] == -INFINITY ? 0.f : expf(row[0] - m);
      wf_s[w][tid] = f;
      l = fmaf(row[1], f, l);
    }
    m_s[tid] = m;
    l_s[tid] = l;
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  const int dp = dh + 4, d4 = dh / 4;
  float* part = a.part + ((long long)cidx * a.n_split + split) * kGroup * dp;
  for (int i = tid; i < n_rows * d4; i += kThreads) {
    const int r = i / d4, c = 4 * (i - r * d4);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(wbuf + (w * kGroup + r) * WP + c);
      const float f = wf_s[w][r];
      o = make_float4(fmaf(x.x, f, o.x), fmaf(x.y, f, o.y), fmaf(x.z, f, o.z), fmaf(x.w, f, o.w));
    }
    if (n_live == 1) {   // the group's whole context here
      T* orow = out + (((long long)b * a.W + w0 + r) * h + head) * dh + c;
      const float inv = 1.f / l_s[r];
      orow[0] = from_float<T>(o.x * inv);
      orow[1] = from_float<T>(o.y * inv);
      orow[2] = from_float<T>(o.z * inv);
      orow[3] = from_float<T>(o.w * inv);
      continue;
    }
    if (c == 0) {
      part[r * dp + dh] = m_s[r];
      part[r * dp + dh + 1] = l_s[r];
    }
    *reinterpret_cast<float4*>(part + r * dp + c) = o;
  }
  if (n_live == 1) return;
  __threadfence();   // the partial is visible device-wide ...
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(a.counter + cidx, 1);   // ... before the ticket
    last_s = ticket == n_live - 1;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // the last split: merge every live split's partial (read past L1).
  // Every (split, row)'s max and denominator come into the free ring at
  // once; each row's weight of each split, exp(m_s - m), is computed from
  // them; then each float4 of the output takes one load a split
  const float* base = a.part + (long long)cidx * a.n_split * kGroup * dp;
  const long long stride = (long long)kGroup * dp;
  float* wt = reinterpret_cast<float*>(smem);   // [split][row]: m_s, then its weight
  float* lt = wt + kMaxSplit * kGroup;          // [split][row]: l_s
  for (int i = tid; i < n_live * n_rows; i += kThreads) {
    const int s = i / n_rows, r = i - s * n_rows;
    const float* ps = base + s * stride + r * dp + dh;
    wt[s * kGroup + r] = __ldcg(ps);
    lt[s * kGroup + r] = __ldcg(ps + 1);
  }
  __syncthreads();
  if (tid < n_rows) {
    float m = -INFINITY;
    for (int s = 0; s < n_live; ++s) m = fmaxf(m, wt[s * kGroup + tid]);
    float l = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float ms = wt[s * kGroup + tid];
      const float f = ms == -INFINITY ? 0.f : expf(ms - m);   // 0: the row saw no key there
      wt[s * kGroup + tid] = f;
      l = fmaf(lt[s * kGroup + tid], f, l);
    }
    l_s[tid] = l;
  }
  __syncthreads();
  for (int i = tid; i < n_rows * d4; i += kThreads) {
    const int r = i / d4, c = 4 * (i - r * d4);
    const float* pr = base + r * dp + c;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < n_live; ++s) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(pr + s * stride));
      const float f = wt[s * kGroup + r];
      o = make_float4(fmaf(x.x, f, o.x), fmaf(x.y, f, o.y), fmaf(x.z, f, o.z), fmaf(x.w, f, o.w));
    }
    T* orow = out + (((long long)b * a.W + w0 + r) * h + head) * dh + c;
    const float inv = 1.f / l_s[r];
    orow[0] = from_float<T>(o.x * inv);
    orow[1] = from_float<T>(o.y * inv);
    orow[2] = from_float<T>(o.z * inv);
    orow[3] = from_float<T>(o.w * inv);
  }
  if (tid == 0) a.counter[cidx] = 0;   // ready for the next launch
}

template <typename T>
int launch(const Args& a, int B, cudaStream_t s) {
  // once per instantiation, on the first (uncaptured) launch
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(paged_verify_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Layout<T>::kBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(a.h * a.n_grp, B, a.n_split);
  paged_verify_kernel<T><<<grid, kThreads, Layout<T>::kBytes, s>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the wide build: bf16 at head dims 136 .. 512 (multiples of 8), rows by
// bulk copy, in padded width classes of 64 columns
// ---------------------------------------------------------------------------
constexpr int kWideMaxStages = 2;
constexpr int kSmemMax = 232448;   // shared memory a block may have (H100)
// the kernel's static shared memory: the barriers, the warps' row maxima
// and sums, the rows' denominators, the last-split flag
constexpr size_t kWideStatic = kWideMaxStages * sizeof(uint64_t) +
                               2 * (size_t)kWarps * kGroup * sizeof(float) +
                               kGroup * sizeof(float) + sizeof(int);

struct WideArgs {
  Args a;
  int n_stage;   // min(WideLayout<DHP>::kStages, chunk / kTile)
};

// DHP: the padded width class (a multiple of 64, 192 .. 512) of the
// runtime head dims dh in (DHP - 64, DHP]; tiles are laid out at DHP, the
// copies move dh columns a row, the pad columns [dh, DHP) are zero
template <int DHP>
struct WideLayout {
  static constexpr int LD = DHP + 8;         // K, V and Q row pitch (elements)
  static constexpr int PLD = kTile + 8;      // P row pitch
  static constexpr int kCols = DHP / kWarps; // output columns a warp owns
  static constexpr int kNj = kCols / 8;      // ... as column blocks of 8
  static constexpr size_t kTileBytes = (size_t)kTile * LD * sizeof(__nv_bfloat16);
  static constexpr size_t kStage = 2 * kTileBytes;   // K tile, then V tile
  static constexpr size_t kQBytes = (size_t)kGroup * LD * sizeof(__nv_bfloat16);
  static constexpr size_t kPBytes = (size_t)kGroup * PLD * sizeof(__nv_bfloat16);
  // the ring of n stages, then Q, then P
  static constexpr size_t bytes(int n) { return n * kStage + kQBytes + kPBytes; }
  // two ring stages where they fit beside the static buffers (up to DHP
  // 384: 215,552 bytes at 384), else one (448: 133,632; 512: 152,064)
  static constexpr int kStages =
      2 * kStage + kQBytes + kPBytes + kWideStatic <= (size_t)kSmemMax ? 2 : 1;
  static_assert(kStages * kStage + kQBytes + kPBytes + kWideStatic <= (size_t)kSmemMax,
                "the ring, Q, P and the static buffers fit a block's shared memory");
  static_assert(kNj % 2 == 0, "P.V takes column blocks in pairs");
  static_assert(kStage >= (size_t)kMaxSplit * kGroup * sizeof(float),
                "the last split's merge weights fit one stage");
};

// kExact: dh == DHP, a compile-time constant (every offset folded, as
// at 192 and 256 for Gpt(n_heads=4, 3)); else dh is read at run time.
// Either way a partial row is laid out at DHP (part_row_floats(DHP): the
// merge's offsets are compile-time; columns [dh, DHP) are never written
// and their sums never stored)
template <int DHP, bool kExact>
__global__ void __launch_bounds__(kThreads)
paged_verify_wide_kernel(const WideArgs wa) {
  using bf16 = __nv_bfloat16;
  using L = WideLayout<DHP>;
  constexpr int LD = L::LD, PLD = L::PLD, kNj = L::kNj;
  const Args& a = wa.a;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kWideMaxStages];
  __shared__ float red_m[kWarps][kGroup], red_l[kWarps][kGroup];
  __shared__ float lrow_s[kGroup];
  __shared__ int last_s;

  const int grp = blockIdx.x % a.n_grp, head = blockIdx.x / a.n_grp;
  const int b = blockIdx.y, split = blockIdx.z;
  const int h = a.h, bs = a.bs, dh = kExact ? DHP : a.dh, n_stage = wa.n_stage;
  const int w0 = grp * kGroup;
  const int n_rows = min(kGroup, a.W - w0);
  const int p0 = a.pos0[b] + w0;                      // the group's row 0
  const int n_ctx = min(p0 + n_rows, a.max_blocks * bs);
  const int c0 = split * a.chunk;
  if (c0 >= n_ctx) return;                            // a dead split
  const int c1 = min(n_ctx, c0 + a.chunk);
  const int n_live = (n_ctx + a.chunk - 1) / a.chunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int* tbl = a.table + (long long)b * a.max_blocks;
  const bf16* kp = static_cast<const bf16*>(a.k_pool);
  const bf16* vp = static_cast<const bf16*>(a.v_pool);
  const long long bh = (long long)b * h + head;
  const int cidx = (int)bh * a.n_grp + grp;
  const int n_tiles = (c1 - c0 + kTile - 1) / kTile;
  bf16* ring = reinterpret_cast<bf16*>(smem);         // [stage][K tile, V tile]
  bf16* q_s = reinterpret_cast<bf16*>(smem + n_stage * L::kStage);
  bf16* p_s = q_s + kGroup * LD;
  const uint32_t bar0 = smem_u32(bars);

  // the pad columns [dh, DHP) of every ring row and of Q, zeroed once: the
  // copies never write them, and Q K^T's last k-step and P.V's last
  // column blocks read them (a stale non-finite pad of K would put 0 x NaN
  // into every score)
  if (!kExact && dh < DHP) {
    const int n_pad = (DHP - dh) / 8;                  // 16-byte vectors a row
    const int n_ring = n_stage * 2 * kTile;            // ring rows, then Q's
    for (int c = tid; c < (n_ring + kGroup) * n_pad; c += kThreads) {
      const int r = c / n_pad, v = c - r * n_pad;
      bf16* row = r < n_ring ? ring + r * LD : q_s + (r - n_ring) * LD;
      *reinterpret_cast<uint4*>(row + dh + 8 * v) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (tid == 0) {
    for (int i = 0; i < n_stage; ++i) mbar_init(bar0 + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // tile i into its stage, by warp 0: one bulk copy per live row of K and
  // of V, dh columns (rows at or past c1 are never copied)
  auto issue = [&](int i) {
    const int t0 = c0 + i * kTile;
    const int n = min(kTile, c1 - t0);
    bf16* ks = ring + (i % n_stage) * 2 * kTile * LD;
    const uint32_t bar = bar0 + 8 * (i % n_stage);
    long long off[kTile / 32];   // a lane's rows lane, lane + 32: table reads together
#pragma unroll
    for (int u = 0; u < kTile / 32; ++u) {
      const int j = t0 + lane + 32 * u;
      off[u] = lane + 32 * u < n
                   ? (((long long)tbl[j / bs] * h + head) * bs + (j % bs)) * dh
                   : -1;
    }
    if (lane == 0) mbar_expect(bar, (uint32_t)n * dh * 2 * 2);
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kTile / 32; ++u) {
      if (off[u] < 0) continue;
      const int r = lane + 32 * u;
      bulk_g2s(smem_u32(ks + r * LD), kp + off[u], dh * 2, bar);
      bulk_g2s(smem_u32(ks + kTile * LD + r * LD), vp + off[u], dh * 2, bar);
    }
  };
  if (warp == 0)
    for (int i = 0; i < n_stage && i < n_tiles; ++i) issue(i);

  // the group's rows of q (zero for rows >= W), 16-byte vectors
  const int n_vec = dh / 8;
  for (int c = tid; c < kGroup * n_vec; c += kThreads) {
    const int r = c / n_vec, v = c - r * n_vec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows)
      val = *reinterpret_cast<const uint4*>(
          static_cast<const bf16*>(a.q) + (((long long)b * a.W + w0 + r) * h + head) * dh +
          8 * v);
    *reinterpret_cast<uint4*>(q_s + r * LD + 8 * v) = val;
  }
  __syncthreads();

  // rows g and g + 8: the running max and denominator (the same in every
  // warp) and this warp's accumulator over its output columns, of which
  // `cols` lie below dh (none past it are stored)
  const int col0 = warp * L::kCols;
  const int cols = kExact ? L::kCols : dh - col0;
  const int n_k16 = (dh + 15) / 16;                 // Q K^T k-steps
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float acc[kNj][4];
#pragma unroll
  for (int j = 0; j < kNj; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % n_stage;
    mbar_wait(bar0 + 8 * st, (i / n_stage) & 1);
    const bf16* ks = ring + st * 2 * kTile * LD;
    bf16* vs = ring + st * 2 * kTile * LD + kTile * LD;
    const int t0 = c0 + i * kTile;
    const int kw = t0 + 16 * warp;   // this warp's first key

    // S = Q K^T over the warp's 16 keys: [16 rows] x [2 x 8 keys]
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < n_k16; ++kk) {
      uint32_t qf[4];
      load_a<LD>(qf, q_s, 0, 16 * kk, g, qd);
      mma_abt<2, LD>(s, qf, ks, 16 * warp, 16 * kk, g, qd);
    }
    // mask (row r sees key k iff r < rows, k < c1 and k <= p0 + r); the
    // tile's row max across the four warps
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1);
        const int key = kw + 8 * j + 2 * qd + (e & 1);
        const bool vis = r < n_rows && key < c1 && key <= p0 + r;
        s[j][e] = vis ? s[j][e] * a.scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const float m = quad_max(mx[r2]);
      if (qd == 0) red_m[warp][g + 8 * r2] = m;
    }
    __syncthreads();
    float corr[2];
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const int r = g + 8 * r2;
      float m_new = m_r[r2];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m_new = fmaxf(m_new, red_m[w][r]);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;   // no key yet
      corr[r2] = expf(m_r[r2] - m_use);                       // 0 on the first
      m_r[r2] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 2 * r2; e < 2 * r2 + 2; ++e) {
          s[j][e] = expf(s[j][e] - m_use);   // 0 where masked
          sum += s[j][e];
        }
      sum = quad_sum(sum);
      if (qd == 0) red_l[warp][r] = sum;
    }
    // P, rounded to bf16 at the running max (as v3), into shared memory
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = 16 * warp + 8 * j + 2 * qd;
      *reinterpret_cast<uint32_t*>(p_s + g * PLD + k) = pack_bf16(s[j][0], s[j][1]);
      *reinterpret_cast<uint32_t*>(p_s + (g + 8) * PLD + k) = pack_bf16(s[j][2], s[j][3]);
    }
    __syncthreads();
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red_l[w][g + 8 * r2];
      l_r[r2] = l_r[r2] * corr[r2] + sum;
#pragma unroll
      for (int jd = 0; jd < kNj; ++jd) {
        acc[jd][2 * r2] *= corr[r2];
        acc[jd][2 * r2 + 1] *= corr[r2];
      }
    }

    // keys from kz on go around the tensor cores: those only deeper rows
    // see (k > p0) through a scalar P.V that skips each (row, key) pair
    // the mask hides, and past the context nothing; then this warp's
    // columns of their V rows are zeroed, so the tensor-core product
    // multiplies no unread or hidden row (0 x NaN)
    const int kz = max(0, min(min(p0 + 1, c1) - t0, kTile));
    if (kz < kTile) {
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int r = g + 8 * r2;
        const int n_vis = r < n_rows ? max(0, min(kTile, min(p0 + r + 1, c1) - t0)) : 0;
        for (int kk = kz; kk < n_vis; ++kk) {
          const float p = __bfloat162float(p_s[r * PLD + kk]);
          const bf16* vrow = vs + kk * LD + col0 + 2 * qd;
#pragma unroll
          for (int jd = 0; jd < kNj; ++jd) {
            if (!kExact && 8 * jd >= cols) continue;
            const float2 vv = load2(vrow + 8 * jd);
            acc[jd][2 * r2] = fmaf(p, vv.x, acc[jd][2 * r2]);
            acc[jd][2 * r2 + 1] = fmaf(p, vv.y, acc[jd][2 * r2 + 1]);
          }
        }
      }
      __syncwarp();
      for (int c = lane; c < (kTile - kz) * kNj; c += 32) {
        const int kk = kz + c / kNj;
        *reinterpret_cast<uint4*>(vs + kk * LD + col0 + 8 * (c % kNj)) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      __syncwarp();
    }
    // acc += P V over this warp's columns below dh, the tile's 64 keys
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t pf[4];
      load_a<PLD>(pf, p_s, 0, 16 * kc, g, qd);
      mma_ab<kNj, LD>(acc, pf, vs + col0, 16 * kc, lane, cols);
    }
    __syncthreads();   // stage st, P and the row sums are free ...
    if (warp == 0 && i + n_stage < n_tiles) issue(i + n_stage);   // ... refill
  }

  bf16* out = static_cast<bf16*>(a.out);
  if (n_live == 1) {   // the group's whole context here
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const int r = g + 8 * r2;
      if (r >= n_rows) continue;
      const float inv = 1.f / l_r[r2];
      bf16* orow = out + (((long long)b * a.W + w0 + r) * h + head) * dh + col0 + 2 * qd;
#pragma unroll
      for (int jd = 0; jd < kNj; ++jd)
        if (kExact || 8 * jd < cols)
          *reinterpret_cast<uint32_t*>(orow + 8 * jd) =
              pack_bf16(acc[jd][2 * r2] * inv, acc[jd][2 * r2 + 1] * inv);
    }
    return;
  }
  // the split's partial: (acc[dh], m, l) a row, each warp its columns
  constexpr int dp = part_row_floats(DHP);
  float* part = a.part + ((long long)cidx * a.n_split + split) * kGroup * dp;
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int r = g + 8 * r2;
    if (r >= n_rows) continue;
#pragma unroll
    for (int jd = 0; jd < kNj; ++jd)
      if (kExact || 8 * jd < cols)
        *reinterpret_cast<float2*>(part + r * dp + col0 + 8 * jd + 2 * qd) =
            make_float2(acc[jd][2 * r2], acc[jd][2 * r2 + 1]);
    if (warp == 0 && qd == 0) {
      part[r * dp + DHP] = m_r[r2];
      part[r * dp + DHP + 1] = l_r[r2];
    }
  }
  __threadfence();   // the partial is visible device-wide ...
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(a.counter + cidx, 1);   // ... before the ticket
    last_s = ticket == n_live - 1;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // the last split: each row's max over the live splits, then its
  // denominator and every split's weight exp(m_s - m) (0 where the row saw
  // no key) into the free ring — 16 lanes a row, over the splits, each
  // split's (m, l) read once (past L1); then each thread sums its float4
  // columns of the output (kK of them, (row, column) pairs tid + 128 k)
  // over the splits, the loads of four splits' columns in flight at once
  const float* base = a.part + (long long)cidx * a.n_split * kGroup * dp;
  const long long stride = (long long)kGroup * dp;
  float* wt = reinterpret_cast<float*>(smem);   // [split][row]
  const int sub = tid & 15;                     // lane of the row's 16
  for (int r = tid >> 4; r < kGroup; r += kThreads / 16) {
    const bool row = r < n_rows;
    const float* pr = base + r * dp + DHP;
    const float2 ml0 = row && sub < n_live
                           ? __ldcg(reinterpret_cast<const float2*>(pr + sub * stride))
                           : make_float2(-INFINITY, 0.f);
    float m = ml0.x;
    for (int s2 = sub + 16; row && s2 < n_live; s2 += 16) m = fmaxf(m, __ldcg(pr + s2 * stride));
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    if (row && sub < n_live) {
      const float f = ml0.x == -INFINITY ? 0.f : expf(ml0.x - m);
      wt[sub * kGroup + r] = f;
      l = ml0.y * f;
    }
    for (int s2 = sub + 16; row && s2 < n_live; s2 += 16) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(pr + s2 * stride));
      const float f = ml.x == -INFINITY ? 0.f : expf(ml.x - m);
      wt[s2 * kGroup + r] = f;
      l = fmaf(ml.y, f, l);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (row && sub == 0) lrow_s[r] = l;
  }
  __syncthreads();
  constexpr int kC4 = DHP / 4;                                  // float4 columns a row
  constexpr int kK = (kGroup * kC4 + kThreads - 1) / kThreads;  // a thread's (DHP / 32)
  const int n_c4 = n_rows * kC4;
  float4 o[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) o[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s2 = 0; s2 < n_live; ++s2) {
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int i = tid + kThreads * k;
      if (i >= n_c4) continue;
      const int r = i / kC4;
      const float4 x = __ldcg(reinterpret_cast<const float4*>(
          base + s2 * stride + r * dp + 4 * (i - r * kC4)));
      const float f = wt[s2 * kGroup + r];
      o[k] = make_float4(fmaf(x.x, f, o[k].x), fmaf(x.y, f, o[k].y), fmaf(x.z, f, o[k].z),
                         fmaf(x.w, f, o[k].w));
    }
  }
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const int i = tid + kThreads * k;
    if (i >= n_c4) continue;
    const int r = i / kC4, c = 4 * (i - r * kC4);
    if (!kExact && c >= dh) continue;                          // a pad column
    const float inv = 1.f / lrow_s[r];
    bf16* orow = out + (((long long)b * a.W + w0 + r) * h + head) * dh + c;
    *reinterpret_cast<uint32_t*>(orow) = pack_bf16(o[k].x * inv, o[k].y * inv);
    *reinterpret_cast<uint32_t*>(orow + 2) = pack_bf16(o[k].z * inv, o[k].w * inv);
  }
  if (tid == 0) a.counter[cidx] = 0;   // ready for the next launch
}

template <int DHP, bool kExact>
int launch_wide(WideArgs wa, int B, cudaStream_t s) {
  using L = WideLayout<DHP>;
  // once per instantiation, on the first (uncaptured) launch
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(paged_verify_wide_kernel<DHP, kExact>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::bytes(L::kStages));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int tiles = wa.a.chunk / kTile;
  wa.n_stage = tiles < L::kStages ? tiles : L::kStages;
  const dim3 grid(wa.a.h * wa.a.n_grp, B, wa.a.n_split);
  paged_verify_wide_kernel<DHP, kExact><<<grid, kThreads, L::bytes(wa.n_stage), s>>>(wa);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain-C entry for ctypes.  `part` is f32 scratch of B * h * n_grp *
// n_split * 16 * (dh + 4) values (n_grp = ceil(W / 16), n_split =
// ceil(max_blocks * bs / chunk)); `counter` B * h * n_grp int32 zeros,
// left zero on return of the kernel; `chunk` the context rows per split
// (a multiple of 64, at most 512 splits).  Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError() (0 on success).
extern "C" int dl4j_paged_verify_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* pos0, void* out, void* part, void* counter, int B, int W, int h,
    int bs, int dh, int max_blocks, int chunk, float scale, int is_bf16,
    void* stream) {
  if (B <= 0 || W <= 0 || h <= 0 || bs <= 0 || dh <= 0 || dh > kMaxDh || dh % 8 ||
      max_blocks <= 0 || chunk <= 0 || chunk % kTile || B > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.table = static_cast<const int*>(table);
  a.pos0 = static_cast<const int*>(pos0);
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
  a.n_grp = (W + kGroup - 1) / kGroup;
  a.scale = scale;
  if (a.n_split > kMaxSplit || (long long)h * a.n_grp > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, B, s) : launch<float>(a, B, s);
}

// Any head dim: paged_any_dh.cuh's kernel, each of the W query rows of a
// slot on its own.  `part` and `counter` as dl4j_paged_verify_part_floats
// and dl4j_paged_verify_counters say for build 2 (counters int32 zeros,
// left zero); n_split = ceil(max_blocks * bs / chunk).  Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError() (0
// on success).
extern "C" int dl4j_paged_verify_attention_any(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* pos0, void* out, void* part, void* counter, int B, int W, int h,
    int bs, int dh, int max_blocks, int chunk, float scale, int is_bf16,
    void* stream) {
  return paged_any_dh::launch(q, k_pool, v_pool, table, pos0, out, part,
                              counter, B, W, h, bs, dh, max_blocks, chunk,
                              scale, is_bf16, stream);
}

// The wide build: bf16 at dh in (128, 512], a multiple of 8, context rows
// by bulk copy, in the width class DHP = dh rounded up to 64.  Arguments,
// scratch and counters as dl4j_paged_verify_attention (`chunk` a multiple
// of 64, at most 512 splits); q and the pools 16-byte aligned.  Launches
// on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for a call
// this build does not take.
extern "C" int dl4j_paged_verify_attention_wide(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* pos0, void* out, void* part, void* counter, int B, int W, int h,
    int bs, int dh, int max_blocks, int chunk, float scale, int is_bf16,
    void* stream) {
  if (!is_bf16 || dh <= kMaxDh || dh > 512 || dh % 8 || B <= 0 || W <= 0 || h <= 0 ||
      bs <= 0 || max_blocks <= 0 || chunk <= 0 || chunk % kTile || B > 65535 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_pool) |
       reinterpret_cast<uintptr_t>(v_pool)) % 16)
    return (int)cudaErrorInvalidValue;
  WideArgs wa;
  Args& a = wa.a;
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.table = static_cast<const int*>(table);
  a.pos0 = static_cast<const int*>(pos0);
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
  a.n_grp = (W + kGroup - 1) / kGroup;
  a.scale = scale;
  if (a.n_split > kMaxSplit || (long long)h * a.n_grp > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool exact = dh % 64 == 0;
  switch ((dh + 63) / 64) {
    case 3: return exact ? launch_wide<192, true>(wa, B, s) : launch_wide<192, false>(wa, B, s);
    case 4: return exact ? launch_wide<256, true>(wa, B, s) : launch_wide<256, false>(wa, B, s);
    case 5: return exact ? launch_wide<320, true>(wa, B, s) : launch_wide<320, false>(wa, B, s);
    case 6: return exact ? launch_wide<384, true>(wa, B, s) : launch_wide<384, false>(wa, B, s);
    case 7: return exact ? launch_wide<448, true>(wa, B, s) : launch_wide<448, false>(wa, B, s);
    default: return exact ? launch_wide<512, true>(wa, B, s) : launch_wide<512, false>(wa, B, s);
  }
}

// f32 values of split-partial scratch one launch needs, by build (0: the
// v3 entry, a partial of 16 rows of (acc[dh], m, l, pad) per (slot, head,
// row group, split); 1: the wide build, the same rows laid out at the
// width class DHP, dh rounded up to 64; 2: the any-dh kernel, each of the
// W rows on its own), for B slots of W query rows, h heads, head dim dh
// and n_split splits.  The wrapper sizes its scratch from this, so each
// layout is known here alone.
extern "C" long long dl4j_paged_verify_part_floats(int build, int B, int W,
                                                  int h, int dh,
                                                  int n_split) {
  if (build == 2) return paged_any_dh::part_floats(B, W, h, dh, n_split);
  const long long n_grp = (W + kGroup - 1) / kGroup;
  const int width = build == 1 ? (dh + 63) / 64 * 64 : dh;
  return (long long)B * h * n_grp * n_split * kGroup * part_row_floats(width);
}

// int32 ticket counters one launch needs, by build as above: one a (slot,
// head, row group), and on the any-dh kernel one a (row, head, column
// slab).
extern "C" long long dl4j_paged_verify_counters(int build, int B, int W, int h,
                                               int dh) {
  if (build == 2) return paged_any_dh::counters(B, W, h, dh);
  return (long long)B * h * ((W + kGroup - 1) / kGroup);
}
