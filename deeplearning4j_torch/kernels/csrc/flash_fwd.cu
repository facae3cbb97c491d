// Flash-attention forward for Hopper (sm_90a): K3 and K4.
//
// Replaces the TPU kernels deeplearning4j_tpu/kernels/flash_attention.py:
//   K3 _fwd_kernel         (launched by _flash_fwd -> pl.pallas_call, n_k > 1)
//   K4 _fwd_kernel_single  (launched by _flash_fwd -> pl.pallas_call, n_k == 1)
// O = softmax(Q K^T * scale + bias) V for each (batch, head), with an
// optional causal mask and an optional additive key bias [b*h, t] (f32),
// and the per-row log-sum-exp LSE [b*h, t] (f32) the backward recomputes
// P from.  A row with no unmasked key gets O = 0 and LSE = 1e30.
//
// Bound: operations at the training shapes.  Causal at b 8, t 2048, h 6,
// dh 128 the two products take 4 * b * h * dh * t^2 / 2 ~ 51.5 GFLOP
// against ~100 MB of q/k/v/O — ~500 flops per byte, above the ~295 where
// the H100 turns compute-bound in bf16.  At t 512 (K4's shapes) K4's
// three products (Q K^T twice, P V) take 4.8 GFLOP over 25 MB: memory by
// the bound, latency in practice (a few key tiles per block).
//
// Design: one thread block per (query tile, batch*head); the block loops
// over the key tiles the Pallas grid walked in order on its "arbitrary"
// axis, skipping tiles wholly above the diagonal when causal.  Keys at or
// past t are no keys at all (p = 0); rows at or past t are never read or
// written.
// * K3 keeps each row's running max and denominator and rescales its
//   output accumulator per key tile; P is rounded to the input dtype
//   BEFORE the division by the denominator (acc / l at the end), as the
//   TPU kernel does.
// * K4 (the sequence fits one Pallas key block, t <= blk_k) walks the key
//   tiles twice: once for each row's max and denominator, once for P.V
//   with P normalised THEN rounded — K4's rounding point (p / l before the
//   cast).
// * bf16 K3 and K4 (v3; at head dims 192 and 256 too, in place of an
//   FMA build): one kernel on wgmma and TMA tiles, templated on
//   the head dim and kSingle.  A block is two warpgroups on 128 query
//   rows (64 each: wgmma's M); both fit in registers up to dh 256, so no
//   producer warpgroup and no setmaxnreg: thread 0 issues the TMA copies,
//   prefetching the next key tile before the current one is computed (one
//   barrier per tile).  Q (once) and a two-stage ring of K and V tiles
//   (128 keys up to dh 128; 64 at dh 192 and 256, where 128-key tiles
//   would not fit in shared memory beside Q, and O's accumulator takes
//   128 registers a thread at dh 256) arrive by TMA from 4-D tensor maps
//   over the bthd views
//   ((dh, h, t, b) with the projection's strides; rows past t read as
//   zeros), completion on mbarriers, 128-byte swizzled panels of 64 head
//   columns (flash_hopper.cuh).  S = Q K^T is wgmma m64n{keys}k16 with both
//   operands in shared memory; the softmax runs in registers in base 2
//   (the scale times log2 e folded into one FFMA per score, ex2.approx),
//   with a branch-free path for interior tiles (wholly below the
//   diagonal, every key below t, no bias) and masking only on diagonal,
//   ragged and biased tiles (the bias slice read once per tile).  P is the
//   register A operand of O += P V (one wgmma m64n{dh}k16 a k-step, V
//   MN-major through the descriptor's transpose bit).  K4's two passes
//   are one sequence of 2 n_k tiles through the same ring: the first n_k
//   bring K alone (max and denominator, no P V), the next n_k K and V
//   again (from L2; K is not kept resident, which would not fit beside
//   the V ring past t 512).
//   Blocks start in groups of 8 (batch, head) slices, so the K/V that
//   running blocks read stays in L2 (K3 is bound by moving K/V tiles:
//   without its products and exponentials it still takes ~75% of its
//   time, PERF.md), and within a group every slice's heaviest causal
//   query tile goes first, so the lightest blocks fill the last wave (at
//   t 512, b 8, 6 heads: 192 blocks of 4..1 key tiles on 132 SMs, one
//   block an SM).
// * f32 at every head dim up to 256 (tf32 would change the results): 8
//   warps, 32-row tiles, f32 tiles in shared memory and plain FMAs on the
//   inputs' exact values (flash_fwd_plain_kernel).
// * bf16 at head dims 320, 384, 448 and 512: the same machinery on one
//   64-row query tile a block, both warpgroups computing its whole S and
//   each accumulating its own run of output panels
//   (flash_fwd_bf16_wide_kernel, WideFwdLayout).
// * f32 past head dim 256, and bf16 past 512 (any multiple of 64; the TPU
//   kernels take any head dim): the FMA route chunked — S summed over
//   64-column chunks of Q and K, each block owning 128 output columns and
//   recomputing S for them (flash_fwd_chunked_kernel).
// TPU artefacts left behind: the lane-replicated [blk, 128] stat tiles, the
// (1, 8, blk_k) bias broadcast and interpret mode.  Known limits, left to
// later work: each 128-row query block reads every K/V tile below its
// diagonal from L2 on its own (sharing them across a cluster by TMA
// multicast is the next step).
#include <type_traits>

#include "flash_hopper.cuh"

using namespace flash;

namespace {

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // [b*h, t] or null
  void* o;
  float* lse;         // [b*h, t]
  Strides sq, sk, sv, so;
  int h, t;
  float scale;
  int causal;
};

// score of (row, col) from the raw dot product: scaled, biased and masked;
// a causally masked key scores -1e30 (as the reference), a key at or past
// t -inf (no key at all)
__device__ __forceinline__ float masked_score(const FwdArgs& a, const float* bias,
                                              float dot, int row, int col) {
  if (col >= a.t) return -INFINITY;
  float s = dot * a.scale;
  if (bias) s += bias[col];
  if (a.causal && col > row) s = kNeg;
  return s;
}

// ---------------------------------------------------------------------------
// one key tile in registers, shared by the bf16 wgmma kernels
// ---------------------------------------------------------------------------
// A thread holds two rows (row[0], row[1]) of the tile's scores s[NJ][4] in
// wgmma's accumulator layout (columns 8 jj + 2 qd + (e & 1)), its part of
// O (o[ND][4], the same layout), each row's running max m2 of y (base 2)
// and its part l of the row's denominator.  An interior tile (wholly
// below the diagonal, every key below t, no bias, a scale > 0) keeps its
// raw scores and folds the scale into the exponentials; any other tile is
// masked first.

// y = s c + bias log2 e, -inf for a key at or past t (no key at all) or a
// causally masked one: masked_score's semantics in base 2, the bias slice
// read once per tile
template <int NJ>
__device__ __forceinline__ void mask_tile(float (&s)[NJ][4], const FwdArgs& a, const float* bias,
                                          float c, int k0, const int (&row)[2], int qd) {
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int col0 = k0 + 8 * jj + 2 * qd;
    const float b0 = bias && col0 < a.t ? bias[col0] * kLog2e : 0.f;
    const float b1 = bias && col0 + 1 < a.t ? bias[col0 + 1] * kLog2e : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = col0 + (e & 1);
      float y = fmaf(s[jj][e], c, (e & 1) ? b1 : b0);
      if (col >= a.t || (a.causal && col > row[e >> 1])) y = -INFINITY;
      s[jj][e] = y;
    }
  }
}

// K4's first pass over one tile: each row's max and denominator over its
// keys
template <int NJ>
__device__ __forceinline__ void tile_stats(const float (&s)[NJ][4], float (&m2)[2], float (&l)[2],
                                           bool interior, float c, float thr) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) mx = fmaxf(mx, fmaxf(s[jj][2 * r], s[jj][2 * r + 1]));
    mx = quad_max(mx);
    if (interior) mx *= c;
    const float m_new = fmaxf(m2[r], mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;   // no key yet
    float sum = 0.f;
    if (interior) {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) sum += ex2(fmaf(s[jj][e], c, -m_use));
    } else {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) sum += s[jj][e] > thr ? ex2(s[jj][e] - m_use) : 0.f;
    }
    l[r] = l[r] * ex2(m2[r] - m_use) + sum;
    m2[r] = m_new;
  }
}

// P in place of the scores: K4's second pass P = 2^(y - m) / l, normalised
// before it is rounded; K3 the online softmax, o and l rescaled to the
// rows' new max
template <bool kSingle, int NJ, int ND>
__device__ __forceinline__ void tile_p(float (&s)[NJ][4], float (&o)[ND][4], float (&m2)[2],
                                       float (&l)[2], const float (&inv_l)[2], bool interior,
                                       float c, float thr) {
  if constexpr (kSingle) {
    if (interior) {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = ex2(fmaf(s[jj][e], c, -m2[e >> 1])) * inv_l[e >> 1];
    } else {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[jj][e] = s[jj][e] > thr ? ex2(s[jj][e] - m2[e >> 1]) * inv_l[e >> 1] : 0.f;
    }
  } else if (interior) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[jj][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m2[r], quad_max(mx[r]) * c);
      const float corr = ex2(m2[r] - m_new);   // 0 on a row's first tile
      m2[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) {
        o[jd][2 * r] *= corr;
        o[jd][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = ex2(fmaf(s[jj][e], c, -m2[r]));
        s[jj][e] = p;
        l[r] += p;
      }
  } else {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[jj][e]);
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m2[r], quad_max(mx[r]));
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;   // no key yet
      const float corr = ex2(m2[r] - m_use[r]);
      m2[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) {
        o[jd][2 * r] *= corr;
        o[jd][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = s[jj][e] > thr ? ex2(s[jj][e] - m_use[r]) : 0.f;
        s[jj][e] = p;
        l[r] += p;
      }
  }
}

// The epilogue of a thread's two rows: O into `op` (the output columns
// this thread's accumulator starts at, in its (batch, head) slice) — K3
// divided by the row's denominator, K4's already normalised — and, with
// `lse`, the natural-log LSE at lse_row[row]; rows at or past t are not
// written
template <bool kSingle, int ND>
__device__ __forceinline__ void store_o_rows(const FwdArgs& a, __nv_bfloat16* op,
                                             const float (&o)[ND][4], const float (&m2)[2],
                                             const float (&l)[2], const int (&row)[2],
                                             float* lse_row, int qd, bool lse) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = kSingle ? l[r] : quad_sum(l[r]);   // K4 summed it after its first pass
    if (row[r] >= a.t) continue;
    const float inv = kSingle ? 1.f : 1.f / (lr == 0.f ? 1.f : lr);
    __nv_bfloat16* orow = op + (long long)row[r] * a.so.t + 2 * qd;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
      *reinterpret_cast<uint32_t*>(orow + 8 * jd) =
          pack_bf16(o[jd][2 * r] * inv, o[jd][2 * r + 1] * inv);
    if (lse && qd == 0) lse_row[row[r]] = lr == 0.f ? kPos : (m2[r] + log2f(lr)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// bf16 K3 and K4 v3: wgmma on TMA-filled, 128-byte-swizzled tiles
// ---------------------------------------------------------------------------
// Two consumer warpgroups take 64 query rows each (128 a block).  Shared
// memory holds Q once, and a two-stage ring of K and V tiles, each stage
// with its own mbarriers.  A key tile is 128 keys up to head dim 128 and
// 64 at 192 and 256: with 128 keys, Q and the ring would take 240 KB at
// dh 192 and 320 KB at dh 256, over the 227 KB a block may have; with 64
// they take 144 and 192 KB.  In registers, a thread of a warpgroup then
// holds O (DH / 2 f32: 128 at dh 256), S (32 f32) and P (16 bf16 pairs).
constexpr int kWgThreads = 256;   // two warpgroups
constexpr int kWgRows = 128;      // query rows per block (64 a warpgroup)
constexpr int kWgStages = 2;

template <int DH>
struct WgLayout {
  static constexpr int NP = DH / kPanel;
  static constexpr int kKeys = DH <= 128 ? 128 : 64;        // keys per K/V tile
  static constexpr uint32_t kQPanel = 128 * kWgRows;        // 128 rows of 128 B
  static constexpr uint32_t kKvPanel = 128 * kKeys;
  static constexpr uint32_t kQBytes = NP * kQPanel;
  static constexpr uint32_t kKvBytes = NP * kKvPanel;       // one K or V tile
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kWgStages * kKvBytes;
  static constexpr uint32_t kBar = kV + kWgStages * kKvBytes;   // 1 + 2 kWgStages mbarriers
  static constexpr size_t kBytes = kBar + 64 + 1024;   // + slack to align to 1024
};

// Thread 0's TMA copies of sequence tile j into its stage of the K/V ring
// (layout L): K of key tile j and V beside it — K4 (kSingle) walks the
// tiles twice, K alone for j < n_k, then K and V of tile j - n_k.  The
// mbarriers sit at bar_q: Q's, then K's and V's of each stage.
template <typename L, bool kSingle>
__device__ __forceinline__ void issue_kv(const CUtensorMap& tk, const CUtensorMap& tv,
                                         uint32_t k_s, uint32_t v_s, uint32_t bar_q, int j,
                                         int n_k, int hi, int bi) {
  const int st = j % kWgStages;
  const int kt = kSingle && j >= n_k ? j - n_k : j;
  const uint32_t bar_k = bar_q + 8 + 8 * st, bar_v = bar_k + 8 * kWgStages;
  mbar_expect(bar_k, L::kKvBytes);
#pragma unroll
  for (int p = 0; p < L::NP; ++p)
    tma_load(k_s + st * L::kKvBytes + p * L::kKvPanel, tk, bar_k, kPanel * p, hi, kt * L::kKeys,
             bi);
  if (kSingle && j < n_k) return;
  mbar_expect(bar_v, L::kKvBytes);
#pragma unroll
  for (int p = 0; p < L::NP; ++p)
    tma_load(v_s + st * L::kKvBytes + p * L::kKvPanel, tv, bar_v, kPanel * p, hi, kt * L::kKeys,
             bi);
}

// The block's start: thread 0 initialises the mbarriers and issues Q's
// copy (rows q0 on, layout L) behind a barrier of the whole block
template <typename L>
__device__ __forceinline__ void start_tiles(const CUtensorMap& tq, uint32_t q_s, uint32_t bar_q,
                                            int hi, int q0, int bi) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + 2 * kWgStages; ++i) mbar_init(bar_q + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(bar_q, L::kQBytes);
#pragma unroll
    for (int p = 0; p < L::NP; ++p)
      tma_load(q_s + p * L::kQPanel, tq, bar_q, kPanel * p, hi, q0, bi);
  }
}

template <int DH, bool kSingle>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv, const FwdArgs a) {
  using bf16 = __nv_bfloat16;
  using L = WgLayout<DH>;
  constexpr int BR = kWgRows, BC = L::kKeys;
  constexpr int NJ = BC / 8;   // score column blocks per key tile
  constexpr int ND = DH / 8;   // output column blocks
  constexpr int NK = DH / 16;  // k-steps of Q K^T
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sb = (raw + 1023) & ~1023u;   // 1024-byte-aligned swizzle atoms
  const uint32_t q_s = sb + L::kQ, k_s = sb + L::kK, v_s = sb + L::kV;
  const uint32_t bar_q = sb + L::kBar;
  auto bar_k = [&](int st) { return bar_q + 8 + 8 * st; };
  auto bar_v = [&](int st) { return bar_q + 8 + 8 * kWgStages + 8 * st; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, qd = lane & 3;
  const int t = a.t;
  const int n_q = (t + BR - 1) / BR;
  const int2 blk = grouped_block(n_q);   // heaviest causal tile first
  const int bh = blk.x;
  const int bi = bh / a.h, hi = bh - bi * a.h;
  const int q0 = (n_q - 1 - blk.y) * BR;
  const float* bias = a.bias ? a.bias + (long long)bh * t : nullptr;
  const int row[2] = {q0 + 64 * wg + 16 * wi + g, q0 + 64 * wg + 16 * wi + g + 8};
  const int k_end = a.causal ? min(t, q0 + BR) : t;
  const int n_k = (k_end + BC - 1) / BC;
  // K4 walks the key tiles twice: tiles j < n_k are its first pass (K
  // alone), j >= n_k its second (K and V of key tile j - n_k)
  const int n_seq = kSingle ? 2 * n_k : n_k;

  // the consumers prefetch: thread 0 issues tile j + kAhead before tile j
  // is computed (no producer warp)
  constexpr int kAhead = kWgStages - 1;
  auto issue = [&](int j) { issue_kv<L, kSingle>(tk, tv, k_s, v_s, bar_q, j, n_k, hi, bi); };
  start_tiles<L>(tq, q_s, bar_q, hi, q0, bi);
  if (tid == 0)
    for (int j = 0; j < kAhead && j < n_seq; ++j) issue(j);

  const float c = a.scale * kLog2e;
  const float thr = 0.5f * kNeg * kLog2e;   // the reference's p = 0 test, base 2
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m2[2] = {-INFINITY, -INFINITY};   // running row max of y
  float l[2] = {0.f, 0.f};                // this thread's part of the denominator
  float inv_l[2] = {1.f, 1.f};            // K4's second pass: 1 / the row's denominator
  mbar_wait(bar_q, 0);

  for (int j = 0; j < n_seq; ++j) {
    const bool pass1 = kSingle && j < n_k;
    const int k0 = (kSingle && j >= n_k ? j - n_k : j) * BC;
    const int st = j % kWgStages;
    if (j > 0) __syncthreads();   // tile j - 1 read by every warpgroup: its stage is free
    if (tid == 0 && j + kAhead < n_seq) issue(j + kAhead);
    if (kSingle && j == n_k) {   // K4: the first pass is done
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = quad_sum(l[r]);
        inv_l[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
      }
    }
    mbar_wait(bar_k(st), (j / kWgStages) & 1);

    // S = Q K^T, both K-major: a k-step advances 32 bytes inside the
    // swizzled row, a panel every four k-steps
    float s[NJ][4];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const uint32_t kb = (kk % 4) * 32;
      Wgmma<BC>::ss(s, sw128_desc(q_s + (kk / 4) * L::kQPanel + kb + wg * 64 * 128, 16, 1024),
                    sw128_desc(k_s + st * L::kKvBytes + (kk / 4) * L::kKvPanel + kb, 16, 1024),
                    kk > 0);
    }
    wg_commit();
    wg_wait0();
    keep(s);

    const bool interior =
        !bias && c > 0.f && k0 + BC <= t && (!a.causal || k0 + BC - 1 <= q0);
    if (!interior) mask_tile<NJ>(s, a, bias, c, k0, row, qd);
    if (pass1) {   // K4, first pass: each row's max and denominator
      tile_stats<NJ>(s, m2, l, interior, c, thr);
      continue;
    }
    tile_p<kSingle, NJ, ND>(s, o, m2, l, inv_l, interior, c, thr);

    // out += P V: P rounded to bf16 (K3: before the division by l; K4:
    // after it) as wgmma's register A operand; V MN-major — a k-step is
    // 16 key rows (2048 bytes), the next 64 head columns a panel further
    // (LBO)
    uint32_t pf[NJ / 2][4];
#pragma unroll
    for (int kc = 0; kc < NJ / 2; ++kc) pack_a<NJ>(pf[kc], s, kc);
    mbar_wait(bar_v(st), ((kSingle ? j - n_k : j) / kWgStages) & 1);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < NJ / 2; ++kc)
      Wgmma<DH>::rs(o, pf[kc],
                    sw128_desc(v_s + st * L::kKvBytes + kc * 16 * 128, L::kKvPanel, 1024), 1);
    wg_commit();
    wg_wait0();
    keep(o);
    keep(pf);
  }

  store_o_rows<kSingle, ND>(a, static_cast<bf16*>(a.o) + bi * a.so.b + hi * a.so.h, o, m2, l,
                            row, a.lse + (long long)bh * t, qd, true);
}

// ---------------------------------------------------------------------------
// bf16 K3 and K4 past head dim 256 (320, 384, 448, 512): wgmma on 64 rows
// ---------------------------------------------------------------------------
// v3's 128 query rows do not fit past dh 256: at dh 320 Q and its 64-key
// ring take 246,848 bytes, and O would take 160 registers a thread.  Here
// a block is one 64-row query tile on two warpgroups that share its rows.
// Both compute the whole S = Q K^T of a key tile (wgmma m64n{keys}k16,
// the products repeated: 1.5x the bound's flops) and run the same online
// softmax on it, so their row maxima and denominators agree with no
// exchange.  Each owns a contiguous run of 64-column output panels and
// accumulates O[:, its columns] += P V[:, its columns] (one
// m64n{its columns}k16 a k-step, P the register A operand):
//   dh 320: panels 3 + 2 (192 + 128 columns, 96 / 64 O registers)
//   dh 384: 3 + 3 (192 + 192), dh 448: 4 + 3 (256 + 192), dh 512: 4 + 4.
// Shared memory: Q (64 rows) and a two-stage ring of K and V tiles of
// kKeys keys, 64 DH 2 + 2 2 kKeys DH 2 + 1,088 bytes (mbarriers and the
// 1024-byte alignment slack), at most 232,448:
//   dh 320, 64 keys: 205,888;  dh 384, 448, 512, 32 keys: 148,544,
//   173,120, 197,696 (64 keys at dh 384 would take 246,848).
// As v3: thread 0 issues the TMA copies one tile ahead (no producer
// warp, one barrier a tile), blocks start heaviest causal tile first
// within groups of (batch, head) slices, interior tiles are branch-free,
// exponentials base 2 with the scale folded in; K4 walks the key tiles
// twice (K alone, then K and V).
constexpr int kWideRows = 64;   // query rows per block, shared by both warpgroups

template <int DH>
struct WideFwdLayout {
  static constexpr int NP = DH / kPanel;
  static constexpr int kKeys = DH <= 320 ? 64 : 32;    // keys per K/V tile
  static constexpr int NP0 = (NP + 1) / 2;             // warpgroup 0's output panels
  static constexpr int kCols0 = NP0 * kPanel;          // its output columns
  static constexpr int kCols1 = DH - kCols0;           // warpgroup 1's
  static constexpr uint32_t kQPanel = 128 * kWideRows;
  static constexpr uint32_t kKvPanel = 128 * kKeys;
  static constexpr uint32_t kQBytes = NP * kQPanel;
  static constexpr uint32_t kKvBytes = NP * kKvPanel;  // one K or V tile
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kWgStages * kKvBytes;
  static constexpr uint32_t kBar = kV + kWgStages * kKvBytes;   // 1 + 2 kWgStages mbarriers
  static constexpr size_t kBytes = kBar + 64 + 1024;
  static_assert(DH % kPanel == 0 && DH > 256 && DH <= 512, "dh 320, 384, 448 or 512");
  static_assert(kBytes <= 232448, "Q and the K/V ring exceed a block's shared memory");
};

template <int DH, bool kSingle>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_bf16_wide_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv, const FwdArgs a) {
  using bf16 = __nv_bfloat16;
  using L = WideFwdLayout<DH>;
  constexpr int BR = kWideRows, BC = L::kKeys;
  constexpr int NJ = BC / 8;   // score column blocks per key tile
  constexpr int NK = DH / 16;  // k-steps of Q K^T
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sb = (raw + 1023) & ~1023u;   // 1024-byte-aligned swizzle atoms
  const uint32_t q_s = sb + L::kQ, k_s = sb + L::kK, v_s = sb + L::kV;
  const uint32_t bar_q = sb + L::kBar;
  auto bar_k = [&](int st) { return bar_q + 8 + 8 * st; };
  auto bar_v = [&](int st) { return bar_q + 8 + 8 * kWgStages + 8 * st; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, qd = lane & 3;
  const int t = a.t;
  const int n_q = (t + BR - 1) / BR;
  const int2 blk = grouped_block(n_q);   // heaviest causal tile first
  const int bh = blk.x;
  const int bi = bh / a.h, hi = bh - bi * a.h;
  const int q0 = (n_q - 1 - blk.y) * BR;
  const float* bias = a.bias ? a.bias + (long long)bh * t : nullptr;
  const int row[2] = {q0 + 16 * wi + g, q0 + 16 * wi + g + 8};   // both warpgroups
  const int k_end = a.causal ? min(t, q0 + BR) : t;
  const int n_k = (k_end + BC - 1) / BC;
  const int n_seq = kSingle ? 2 * n_k : n_k;   // K4: j < n_k its first pass (K alone)

  constexpr int kAhead = kWgStages - 1;
  auto issue = [&](int j) { issue_kv<L, kSingle>(tk, tv, k_s, v_s, bar_q, j, n_k, hi, bi); };
  start_tiles<L>(tq, q_s, bar_q, hi, q0, bi);
  if (tid == 0)
    for (int j = 0; j < kAhead && j < n_seq; ++j) issue(j);

  const float c = a.scale * kLog2e;
  const float thr = 0.5f * kNeg * kLog2e;   // the reference's p = 0 test, base 2
  // one warpgroup's whole walk over the key tiles, for its N output
  // columns from column col0 (each warpgroup runs its own instantiation)
  auto walk = [&](auto n_cols) {
    constexpr int N = decltype(n_cols)::value;
    constexpr int ND = N / 8;   // this warpgroup's output column blocks
    const int col0 = wg * L::kCols0;
    float o[ND][4];
#pragma unroll
    for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float m2[2] = {-INFINITY, -INFINITY};   // running row max of y
    float l[2] = {0.f, 0.f};                // this thread's part of the denominator
    float inv_l[2] = {1.f, 1.f};            // K4's second pass: 1 / the row's denominator
    mbar_wait(bar_q, 0);

    for (int j = 0; j < n_seq; ++j) {
      const bool pass1 = kSingle && j < n_k;
      const int k0 = (kSingle && j >= n_k ? j - n_k : j) * BC;
      const int st = j % kWgStages;
      if (j > 0) block_sync();   // tile j - 1 read by both warpgroups: its stage is free
      if (tid == 0 && j + kAhead < n_seq) issue(j + kAhead);
      if (kSingle && j == n_k) {   // K4: the first pass is done
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = quad_sum(l[r]);
          inv_l[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
        }
      }
      mbar_wait(bar_k(st), (j / kWgStages) & 1);

      // S = Q K^T over the whole head dim, both K-major
      float s[NJ][4];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const uint32_t kb = (kk % 4) * 32;
        Wgmma<BC>::ss(s, sw128_desc(q_s + (kk / 4) * L::kQPanel + kb, 16, 1024),
                      sw128_desc(k_s + st * L::kKvBytes + (kk / 4) * L::kKvPanel + kb, 16, 1024),
                      kk > 0);
      }
      wg_commit();
      wg_wait0();
      keep(s);

      const bool interior =
          !bias && c > 0.f && k0 + BC <= t && (!a.causal || k0 + BC - 1 <= q0);
      if (!interior) mask_tile<NJ>(s, a, bias, c, k0, row, qd);
      if (pass1) {   // K4, first pass: each row's max and denominator
        tile_stats<NJ>(s, m2, l, interior, c, thr);
        continue;
      }
      tile_p<kSingle, NJ, ND>(s, o, m2, l, inv_l, interior, c, thr);

      // O[:, col0 .. col0 + N) += P V[:, col0 .. col0 + N): P rounded to
      // bf16 (K3: before the division by l; K4: after it), V MN-major —
      // a k-step is 16 key rows (2048 bytes), warpgroup 1's columns
      // start col0 / 64 panels in
      uint32_t pf[NJ / 2][4];
#pragma unroll
      for (int kc = 0; kc < NJ / 2; ++kc) pack_a<NJ>(pf[kc], s, kc);
      mbar_wait(bar_v(st), ((kSingle ? j - n_k : j) / kWgStages) & 1);
      wg_fence();
      const uint32_t v_cols = v_s + st * L::kKvBytes + (col0 / kPanel) * L::kKvPanel;
#pragma unroll
      for (int kc = 0; kc < NJ / 2; ++kc)
        Wgmma<N>::rs(o, pf[kc], sw128_desc(v_cols + kc * 16 * 128, L::kKvPanel, 1024), 1);
      wg_commit();
      wg_wait0();
      keep(o);
      keep(pf);
    }

    // each warpgroup stores its own columns; warpgroup 0 the LSE
    store_o_rows<kSingle, ND>(a, static_cast<bf16*>(a.o) + bi * a.so.b + hi * a.so.h + col0, o,
                              m2, l, row, a.lse + (long long)bh * t, qd, wg == 0);
  };
  if (wg == 0)
    walk(std::integral_constant<int, L::kCols0>{});
  else
    walk(std::integral_constant<int, L::kCols1>{});
}

// ---------------------------------------------------------------------------
// plain route (f32): f32 tiles in shared memory, FMAs
// ---------------------------------------------------------------------------
template <int DH>
struct F32FwdLayout {
  static constexpr int BR = kF32Tile, BC = kF32Tile;
  static constexpr int LDT = DH + 4;    // q, k, v tiles
  static constexpr int LDS = BC + 4;    // scores, then P
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = align128(kQ + sizeof(float) * BR * LDT);
  static constexpr size_t kV = align128(kK + sizeof(float) * BC * LDT);
  static constexpr size_t kS = align128(kV + sizeof(float) * BC * LDT);
  static constexpr size_t kO = align128(kS + sizeof(float) * BR * LDS);
  static constexpr size_t kStat = align128(kO + sizeof(float) * BR * LDT);
  static constexpr size_t kBytes = kStat + sizeof(float) * 3 * BR;
};

template <int DH, bool kSingle>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_plain_kernel(FwdArgs a) {
  using L = F32FwdLayout<DH>;
  constexpr int BR = L::BR, BC = L::BC, LDT = L::LDT, LDS = L::LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::kQ);
  float* k_s = reinterpret_cast<float*>(smem + L::kK);
  float* v_s = reinterpret_cast<float*>(smem + L::kV);
  float* s_s = reinterpret_cast<float*>(smem + L::kS);   // scores, then P
  float* o_s = reinterpret_cast<float*>(smem + L::kO);
  float* m_s = reinterpret_cast<float*>(smem + L::kStat);  // running max
  float* l_s = m_s + BR;                                    // running denominator
  float* c_s = l_s + BR;                                    // this tile's rescale

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int bi = bh / a.h, hi = bh - bi * a.h;
  const int t = a.t;
  const int n_q = (t + BR - 1) / BR;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * BR;
  const float* kp = static_cast<const float*>(a.k) + bi * a.sk.b + hi * a.sk.h;
  const float* vp = static_cast<const float*>(a.v) + bi * a.sv.b + hi * a.sv.h;
  const float* bias = a.bias ? a.bias + (long long)bh * t : nullptr;

  load_rows_f32<float, BR, DH, LDT, kF32Threads>(
      q_s, static_cast<const float*>(a.q) + bi * a.sq.b + hi * a.sq.h, a.sq.t, q0, t);
  for (int i = tid; i < BR * LDT; i += kF32Threads) o_s[i] = 0.f;
  for (int i = tid; i < BR; i += kF32Threads) {
    m_s[i] = kNeg;
    l_s[i] = 0.f;
  }
  const int k_end = a.causal ? min(t, q0 + BR) : t;

  // one warp per row, one key per lane (BC == 32)
  auto row_score = [&](int r, int k0) {
    return masked_score(a, bias, s_s[r * LDS + lane], q0 + r, k0 + lane);
  };

  if constexpr (kSingle) {
    for (int k0 = 0; k0 < k_end; k0 += BC) {   // pass 1: max, denominator
      __syncthreads();
      load_rows_f32<float, BC, DH, LDT, kF32Threads>(k_s, kp, a.sk.t, k0, t);
      __syncthreads();
      mm<BR, BC, DH, false, true, false>(s_s, LDS, q_s, LDT, k_s, LDT);
      __syncthreads();
      for (int r = warp; r < BR; r += kF32Warps) {
        const float s = row_score(r, k0);
        const float m_new = fmaxf(m_s[r], warp_max(s));
        const float sum = warp_sum(s > 0.5f * kNeg ? expf(s - m_new) : 0.f);
        if (lane == 0) {
          l_s[r] = l_s[r] * expf(m_s[r] - m_new) + sum;
          m_s[r] = m_new;
        }
      }
    }
    for (int k0 = 0; k0 < k_end; k0 += BC) {   // pass 2: P / l, then P.V
      __syncthreads();
      load_rows_f32<float, BC, DH, LDT, kF32Threads>(k_s, kp, a.sk.t, k0, t);
      load_rows_f32<float, BC, DH, LDT, kF32Threads>(v_s, vp, a.sv.t, k0, t);
      __syncthreads();
      mm<BR, BC, DH, false, true, false>(s_s, LDS, q_s, LDT, k_s, LDT);
      __syncthreads();
      for (int r = warp; r < BR; r += kF32Warps) {
        const float s = row_score(r, k0);
        const float l = l_s[r] == 0.f ? 1.f : l_s[r];
        s_s[r * LDS + lane] = s > 0.5f * kNeg ? expf(s - m_s[r]) / l : 0.f;
      }
      __syncthreads();
      mm<BR, DH, BC, false, false, true>(o_s, LDT, s_s, LDS, v_s, LDT);
    }
  } else {
    for (int k0 = 0; k0 < k_end; k0 += BC) {
      __syncthreads();
      load_rows_f32<float, BC, DH, LDT, kF32Threads>(k_s, kp, a.sk.t, k0, t);
      load_rows_f32<float, BC, DH, LDT, kF32Threads>(v_s, vp, a.sv.t, k0, t);
      __syncthreads();
      mm<BR, BC, DH, false, true, false>(s_s, LDS, q_s, LDT, k_s, LDT);
      __syncthreads();
      for (int r = warp; r < BR; r += kF32Warps) {
        const float s = row_score(r, k0);
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, warp_max(s));
        const float p = s > 0.5f * kNeg ? expf(s - m_new) : 0.f;
        s_s[r * LDS + lane] = p;
        const float sum = warp_sum(p);
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          l_s[r] = l_s[r] * corr + sum;
          m_s[r] = m_new;
          c_s[r] = corr;
        }
      }
      __syncthreads();
      for (int i = tid; i < BR * DH; i += kF32Threads) {
        const int r = i / DH;
        o_s[r * LDT + (i - r * DH)] *= c_s[r];
      }
      __syncthreads();
      mm<BR, DH, BC, false, false, true>(o_s, LDT, s_s, LDS, v_s, LDT);
    }
  }
  __syncthreads();
  if (!kSingle) {
    for (int i = tid; i < BR * DH; i += kF32Threads) {
      const int r = i / DH;
      const float l = l_s[r];
      o_s[r * LDT + (i - r * DH)] /= (l == 0.f ? 1.f : l);
    }
    __syncthreads();
  }
  store_rows<float, BR, DH, LDT>(static_cast<float*>(a.o) + bi * a.so.b + hi * a.so.h,
                             a.so.t, o_s, q0, t);
  for (int r = tid; r < BR; r += kF32Threads) {
    if (q0 + r >= t) continue;
    const float l = l_s[r];
    a.lse[(long long)bh * t + q0 + r] = l == 0.f ? kPos : m_s[r] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// chunked route (f32 and bf16 past dh 256): the plain route's arithmetic
// with the head dim in chunks
// ---------------------------------------------------------------------------
// S = Q K^T sums over 64-column chunks of Q and K staged in turn (in the
// order the unchunked route sums them), so the [32, 32] score tile, the
// online softmax and the running max and denominator are those of the
// plain route.  O is not kept whole: each block owns kOutCols output
// columns (grid z) and recomputes S for them, so shared memory stays at
// ~56 KB at any head dim and a (batch, head) slice spreads over dh / 128
// blocks; the price is S computed once per output chunk (at dh 320,
// three chunks: twice the products of one pass).  An f32 O of the whole head dim in
// shared memory would bound the head dim instead.
struct ChunkFwdLayout {
  static constexpr int BR = kF32Tile, BC = kF32Tile;
  static constexpr int LDC = kDhChunk + 4;   // q, k column chunks
  static constexpr int LDO = kOutCols + 4;   // v's output columns, O
  static constexpr int LDS = BC + 4;         // scores, then P
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = align128(kQ + sizeof(float) * BR * LDC);
  static constexpr size_t kV = align128(kK + sizeof(float) * BC * LDC);
  static constexpr size_t kS = align128(kV + sizeof(float) * BC * LDO);
  static constexpr size_t kO = align128(kS + sizeof(float) * BR * LDS);
  static constexpr size_t kStat = align128(kO + sizeof(float) * BR * LDO);
  static constexpr size_t kBytes = kStat + sizeof(float) * 3 * BR;
};

template <typename T, bool kSingle>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_chunked_kernel(FwdArgs a, int dh) {
  using L = ChunkFwdLayout;
  constexpr int BR = L::BR, BC = L::BC, LDC = L::LDC, LDO = L::LDO, LDS = L::LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::kQ);
  float* k_s = reinterpret_cast<float*>(smem + L::kK);
  float* v_s = reinterpret_cast<float*>(smem + L::kV);
  float* s_s = reinterpret_cast<float*>(smem + L::kS);   // scores, then P
  float* o_s = reinterpret_cast<float*>(smem + L::kO);
  float* m_s = reinterpret_cast<float*>(smem + L::kStat);  // running max
  float* l_s = m_s + BR;                                    // running denominator
  float* c_s = l_s + BR;                                    // this tile's rescale

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int bi = bh / a.h, hi = bh - bi * a.h;
  const int t = a.t;
  const int n_q = (t + BR - 1) / BR;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * BR;
  const int c0 = (int)blockIdx.z * kOutCols;   // this block's output columns
  const int w = min(kOutCols, dh - c0);
  const T* qp = static_cast<const T*>(a.q) + bi * a.sq.b + hi * a.sq.h;
  const T* kp = static_cast<const T*>(a.k) + bi * a.sk.b + hi * a.sk.h;
  const T* vp = static_cast<const T*>(a.v) + bi * a.sv.b + hi * a.sv.h;
  const float* bias = a.bias ? a.bias + (long long)bh * t : nullptr;

  for (int i = tid; i < BR * LDO; i += kF32Threads) o_s[i] = 0.f;
  for (int i = tid; i < BR; i += kF32Threads) {
    m_s[i] = kNeg;
    l_s[i] = 0.f;
  }
  const int k_end = a.causal ? min(t, q0 + BR) : t;

  // s_s = Q K^T of key tile k0 over the whole head dim; starts and ends
  // synchronised
  auto scores = [&](int k0) {
    for (int d0 = 0; d0 < dh; d0 += kDhChunk) {
      __syncthreads();
      load_rows_f32<T, BR, kDhChunk, LDC, kF32Threads>(q_s, qp + d0, a.sq.t, q0, t);
      load_rows_f32<T, BC, kDhChunk, LDC, kF32Threads>(k_s, kp + d0, a.sk.t, k0, t);
      __syncthreads();
      if (d0 == 0)
        mm<BR, BC, kDhChunk, false, true, false>(s_s, LDS, q_s, LDC, k_s, LDC);
      else
        mm<BR, BC, kDhChunk, false, true, true>(s_s, LDS, q_s, LDC, k_s, LDC);
    }
    __syncthreads();
  };
  auto load_v = [&](int k0) {
    load_cols_f32<T, BC, kOutCols, LDO, kF32Threads>(v_s, vp + c0, a.sv.t, k0, t, w);
  };
  // one warp per row, one key per lane (BC == 32)
  auto row_score = [&](int r, int k0) {
    return masked_score(a, bias, s_s[r * LDS + lane], q0 + r, k0 + lane);
  };

  if constexpr (kSingle) {
    for (int k0 = 0; k0 < k_end; k0 += BC) {   // pass 1: max, denominator
      scores(k0);
      for (int r = warp; r < BR; r += kF32Warps) {
        const float s = row_score(r, k0);
        const float m_new = fmaxf(m_s[r], warp_max(s));
        const float sum = warp_sum(s > 0.5f * kNeg ? expf(s - m_new) : 0.f);
        if (lane == 0) {
          l_s[r] = l_s[r] * expf(m_s[r] - m_new) + sum;
          m_s[r] = m_new;
        }
      }
    }
    for (int k0 = 0; k0 < k_end; k0 += BC) {   // pass 2: P / l, then P.V
      scores(k0);
      load_v(k0);
      for (int r = warp; r < BR; r += kF32Warps) {
        const float s = row_score(r, k0);
        const float l = l_s[r] == 0.f ? 1.f : l_s[r];
        s_s[r * LDS + lane] = s > 0.5f * kNeg ? round_as<T>(expf(s - m_s[r]) / l) : 0.f;
      }
      __syncthreads();
      mm<BR, kOutCols, BC, false, false, true>(o_s, LDO, s_s, LDS, v_s, LDO);
    }
  } else {
    for (int k0 = 0; k0 < k_end; k0 += BC) {
      scores(k0);
      load_v(k0);
      for (int r = warp; r < BR; r += kF32Warps) {
        const float s = row_score(r, k0);
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, warp_max(s));
        const float p = s > 0.5f * kNeg ? expf(s - m_new) : 0.f;
        s_s[r * LDS + lane] = round_as<T>(p);   // P in the input dtype, as K3
        const float sum = warp_sum(p);
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          l_s[r] = l_s[r] * corr + sum;
          m_s[r] = m_new;
          c_s[r] = corr;
        }
      }
      __syncthreads();
      for (int i = tid; i < BR * kOutCols; i += kF32Threads) {
        const int r = i / kOutCols;
        o_s[r * LDO + (i - r * kOutCols)] *= c_s[r];
      }
      __syncthreads();
      mm<BR, kOutCols, BC, false, false, true>(o_s, LDO, s_s, LDS, v_s, LDO);
    }
  }
  __syncthreads();
  if (!kSingle) {
    for (int i = tid; i < BR * kOutCols; i += kF32Threads) {
      const int r = i / kOutCols;
      const float l = l_s[r];
      o_s[r * LDO + (i - r * kOutCols)] /= (l == 0.f ? 1.f : l);
    }
    __syncthreads();
  }
  store_cols<T, BR, kOutCols, LDO>(
      static_cast<T*>(a.o) + bi * a.so.b + hi * a.so.h + c0, a.so.t, o_s, q0, t, w);
  if (blockIdx.z != 0) return;   // one block of the row writes its LSE
  for (int r = tid; r < BR; r += kF32Threads) {
    if (q0 + r >= t) continue;
    const float l = l_s[r];
    a.lse[(long long)bh * t + q0 + r] = l == 0.f ? kPos : m_s[r] + logf(l);
  }
}

template <typename Kernel>
int launch(Kernel kern, size_t bytes, bool& configured, dim3 grid,
           int threads, const FwdArgs& a, cudaStream_t s) {
  // once per instantiation, on the first (uncaptured) launch
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  kern<<<grid, threads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// a bf16 kernel on TMA tiles: `rows` query rows and `keys` keys a tile,
// `bytes` of shared memory, one block per (batch * head, query tile)
template <int DH, typename Kernel>
int launch_tma(Kernel kern, size_t bytes, bool& configured, int rows, int keys,
               const FwdArgs& a, int b, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, a.q, a.sq, b, a.h, a.t, DH, rows);
  if (!rc) rc = make_map(&tk, a.k, a.sk, b, a.h, a.t, DH, keys);
  if (!rc) rc = make_map(&tv, a.v, a.sv, b, a.h, a.t, DH, keys);
  if (rc) return rc;
  if (!configured) {   // once, on the first (uncaptured) launch
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(b * a.h, (a.t + rows - 1) / rows);
  kern<<<grid, kWgThreads, bytes, s>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

template <int DH, bool kSingle>
int launch_wgmma(const FwdArgs& a, int b, cudaStream_t s) {
  static bool configured = false;
  return launch_tma<DH>(flash_fwd_bf16_wgmma_kernel<DH, kSingle>, WgLayout<DH>::kBytes,
                        configured, kWgRows, WgLayout<DH>::kKeys, a, b, s);
}

template <int DH, bool kSingle>
int launch_wide(const FwdArgs& a, int b, cudaStream_t s) {
  static bool configured = false;
  return launch_tma<DH>(flash_fwd_bf16_wide_kernel<DH, kSingle>, WideFwdLayout<DH>::kBytes,
                        configured, kWideRows, WideFwdLayout<DH>::kKeys, a, b, s);
}

template <int DH, bool kSingle>
int launch_plain(const FwdArgs& a, int b, cudaStream_t s) {
  static bool configured = false;
  const dim3 grid((a.t + kF32Tile - 1) / kF32Tile, b * a.h);
  return launch(flash_fwd_plain_kernel<DH, kSingle>, F32FwdLayout<DH>::kBytes,
                configured, grid, kF32Threads, a, s);
}

template <int DH, bool kSingle>
int launch_dh(const FwdArgs& a, int b, int is_bf16, cudaStream_t s) {
  return is_bf16 ? launch_wgmma<DH, kSingle>(a, b, s) : launch_plain<DH, kSingle>(a, b, s);
}

template <typename T, bool kSingle>
int launch_chunked(const FwdArgs& a, int b, int dh, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {   // once, on the first (uncaptured) launch
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_chunked_kernel<T, kSingle>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)ChunkFwdLayout::kBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((a.t + kF32Tile - 1) / kF32Tile, b * a.h, (dh + kOutCols - 1) / kOutCols);
  flash_fwd_chunked_kernel<T, kSingle>
      <<<grid, kF32Threads, ChunkFwdLayout::kBytes, s>>>(a, dh);
  return (int)cudaGetLastError();
}

template <bool kSingle>
int launch_any(const FwdArgs& a, int b, int dh, int is_bf16, cudaStream_t s) {
  switch (dh) {
    case 64: return launch_dh<64, kSingle>(a, b, is_bf16, s);
    case 128: return launch_dh<128, kSingle>(a, b, is_bf16, s);
    case 192: return launch_dh<192, kSingle>(a, b, is_bf16, s);
    case 256: return launch_dh<256, kSingle>(a, b, is_bf16, s);
  }
  if (is_bf16) {   // past 256: the wide kernel up to 512, then the chunked build
    switch (dh) {
      case 320: return launch_wide<320, kSingle>(a, b, s);
      case 384: return launch_wide<384, kSingle>(a, b, s);
      case 448: return launch_wide<448, kSingle>(a, b, s);
      case 512: return launch_wide<512, kSingle>(a, b, s);
    }
    return launch_chunked<__nv_bfloat16, kSingle>(a, b, dh, s);
  }
  return launch_chunked<float, kSingle>(a, b, dh, s);
}

}  // namespace

// Plain-C entry for ctypes.  `strides` holds the (batch, time, head)
// element strides of q, k, v and o, in that order (12 values).  Launches
// on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() (0 on success).  `single` selects K4.
extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v,
                              const void* bias, void* o, void* lse,
                              const long long* strides, int b, int h, int t,
                              int dh, float scale, int causal, int single,
                              int is_bf16, void* stream) {
  if (b <= 0 || h <= 0 || t <= 0 || !valid_head_dim(dh) || b * h > 65535)
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.o = o;
  a.lse = static_cast<float*>(lse);
  Strides* st[4] = {&a.sq, &a.sk, &a.sv, &a.so};
  for (int i = 0; i < 4; ++i) *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.h = h;
  a.t = t;
  a.scale = scale;
  a.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return single ? launch_any<true>(a, b, dh, is_bf16, s)
                : launch_any<false>(a, b, dh, is_bf16, s);
}
