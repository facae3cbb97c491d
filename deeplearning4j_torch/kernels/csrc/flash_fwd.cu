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
// * bf16 K3 and K4 (v3): one kernel on wgmma and TMA tiles, templated on
//   kSingle.  A block is two warpgroups on 128 query rows (64 each:
//   wgmma's M); both fit in registers at dh 128 (no spill), so no
//   producer warpgroup and no setmaxnreg: thread 0 issues the TMA copies,
//   prefetching the next key tile before the current one is computed (one
//   barrier per tile).  Q (once) and a two-stage ring of K and V tiles
//   (128 keys) arrive by TMA from 4-D tensor maps over the bthd views
//   ((dh, h, t, b) with the projection's strides; rows past t read as
//   zeros), completion on mbarriers, 128-byte swizzled panels of 64 head
//   columns (flash_hopper.cuh).  S = Q K^T is wgmma m64n128k16 with both
//   operands in shared memory; the softmax runs in registers in base 2
//   (the scale times log2 e folded into one FFMA per score, ex2.approx),
//   with a branch-free path for interior tiles (wholly below the
//   diagonal, every key below t, no bias) and masking only on diagonal,
//   ragged and biased tiles (the bias slice read once per tile).  P is the
//   register A operand of O += P V (wgmma m64n{dh}k16, V MN-major through
//   the descriptor's transpose bit).  K4's two passes are one sequence of
//   2 n_k tiles through the same ring: the first n_k bring K alone (max
//   and denominator, no P V), the next n_k K and V again (from L2; K is
//   not kept resident, which would not fit beside the V ring past t 512).
//   Blocks start in groups of 8 (batch, head) slices, so the K/V that
//   running blocks read stays in L2 (K3 is bound by moving K/V tiles:
//   without its products and exponentials it still takes ~75% of its
//   time, PERF.md), and within a group every slice's heaviest causal
//   query tile goes first, so the lightest blocks fill the last wave (at
//   t 512, b 8, 6 heads: 192 blocks of 4..1 key tiles on 132 SMs, one
//   block an SM).
// * f32, and bf16 at head dims 192 and 256 (the wgmma route's O
//   accumulator and its two S tiles would not fit in registers there): 8
//   warps, 32-row tiles, f32 tiles in shared memory and plain FMAs on the
//   inputs' exact values; in bf16, P is rounded where K3 and K4 round it
//   and O is written as bf16.  A simple kernel that is right, bound by
//   its FMAs (~67 TFLOP/s f32 peak), not the tensor cores.
// TPU artefacts left behind: the lane-replicated [blk, 128] stat tiles, the
// (1, 8, blk_k) bias broadcast and interpret mode.  Known limits, left to
// later work: each 128-row query block reads every K/V tile below its
// diagonal from L2 on its own (sharing them across a cluster by TMA
// multicast is the next step).
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
// bf16 K3 and K4 v3: wgmma on TMA-filled, 128-byte-swizzled tiles
// ---------------------------------------------------------------------------
// Two consumer warpgroups take 64 query rows each (128 a block); the key
// tile is 128 keys.  Shared memory holds Q once, and a two-stage ring of K
// and V tiles, each stage with its own mbarriers.
constexpr int kWgThreads = 256;   // two warpgroups
constexpr int kWgRows = 128;      // query rows per block (64 a warpgroup)
constexpr int kWgKeys = 128;      // keys per tile
constexpr int kWgStages = 2;

template <int DH>
struct WgLayout {
  static constexpr int NP = DH / kPanel;
  static constexpr uint32_t kPanelBytes = 128 * kWgRows;   // 128 rows of 128 B
  static constexpr uint32_t kTileBytes = NP * kPanelBytes;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kTileBytes;
  static constexpr uint32_t kV = kK + kWgStages * kTileBytes;
  static constexpr uint32_t kBar = kV + kWgStages * kTileBytes;   // 1 + 2 kWgStages mbarriers
  static constexpr size_t kBytes = kBar + 64 + 1024;   // + slack to align to 1024
};

template <int DH, bool kSingle>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv, const FwdArgs a) {
  using bf16 = __nv_bfloat16;
  using L = WgLayout<DH>;
  constexpr int BR = kWgRows, BC = kWgKeys;
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
  auto issue = [&](int j) {
    const int st = j % kWgStages;
    const int kt = kSingle && j >= n_k ? j - n_k : j;
    mbar_expect(bar_k(st), L::kTileBytes);
#pragma unroll
    for (int p = 0; p < L::NP; ++p)
      tma_load(k_s + st * L::kTileBytes + p * L::kPanelBytes, tk, bar_k(st), kPanel * p, hi,
               kt * BC, bi);
    if (kSingle && j < n_k) return;
    mbar_expect(bar_v(st), L::kTileBytes);
#pragma unroll
    for (int p = 0; p < L::NP; ++p)
      tma_load(v_s + st * L::kTileBytes + p * L::kPanelBytes, tv, bar_v(st), kPanel * p, hi,
               kt * BC, bi);
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * kWgStages; ++i) mbar_init(bar_q + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(bar_q, L::kTileBytes);
#pragma unroll
    for (int p = 0; p < L::NP; ++p)
      tma_load(q_s + p * L::kPanelBytes, tq, bar_q, kPanel * p, hi, q0, bi);
    for (int j = 0; j < kAhead && j < n_seq; ++j) issue(j);
  }

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
      const uint32_t koff = (kk / 4) * L::kPanelBytes + (kk % 4) * 32;
      Wgmma<BC>::ss(s, sw128_desc(q_s + koff + wg * 64 * 128, 16, 1024),
                    sw128_desc(k_s + st * L::kTileBytes + koff, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait0();
    keep(s);

    const bool interior =
        !bias && c > 0.f && k0 + BC <= t && (!a.causal || k0 + BC - 1 <= q0);
    if (!interior) {
      // diagonal, ragged or biased tile (or a scale <= 0): masked_score's
      // semantics, the bias slice read once per tile; y = -inf for no key
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int col0 = k0 + 8 * jj + 2 * qd;
        const float b0 = bias && col0 < t ? bias[col0] * kLog2e : 0.f;
        const float b1 = bias && col0 + 1 < t ? bias[col0 + 1] * kLog2e : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = col0 + (e & 1);
          float y = fmaf(s[jj][e], c, (e & 1) ? b1 : b0);
          if (col >= t || (a.causal && col > row[e >> 1])) y = -INFINITY;
          s[jj][e] = y;
        }
      }
    }

    if (pass1) {
      // K4, first pass: each row's max and denominator over its keys
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
            for (int e = 2 * r; e < 2 * r + 2; ++e)
              sum += s[jj][e] > thr ? ex2(s[jj][e] - m_use) : 0.f;
        }
        l[r] = l[r] * ex2(m2[r] - m_use) + sum;
        m2[r] = m_new;
      }
      continue;
    }

    if constexpr (kSingle) {
      // K4, second pass: P = 2^(y - m) / l, normalised before it is rounded
      if (interior) {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[jj][e] = ex2(fmaf(s[jj][e], c, -m2[e >> 1])) * inv_l[e >> 1];
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
                    sw128_desc(v_s + st * L::kTileBytes + kc * 16 * 128, L::kPanelBytes, 1024),
                    1);
    wg_commit();
    wg_wait0();
    keep(o);
    keep(pf);
  }

  bf16* op = static_cast<bf16*>(a.o) + bi * a.so.b + hi * a.so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = kSingle ? l[r] : quad_sum(l[r]);   // K4 summed it after its first pass
    if (row[r] >= t) continue;
    const float inv = kSingle ? 1.f : 1.f / (lr == 0.f ? 1.f : lr);
    bf16* orow = op + (long long)row[r] * a.so.t + 2 * qd;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
      *reinterpret_cast<uint32_t*>(orow + 8 * jd) =
          pack_bf16(o[jd][2 * r] * inv, o[jd][2 * r + 1] * inv);
    if (qd == 0)
      a.lse[(long long)bh * t + row[r]] = lr == 0.f ? kPos : (m2[r] + log2f(lr)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// plain route (f32; bf16 past dh 128): f32 tiles in shared memory, FMAs
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

template <typename T, int DH, bool kSingle>
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
  const T* kp = static_cast<const T*>(a.k) + bi * a.sk.b + hi * a.sk.h;
  const T* vp = static_cast<const T*>(a.v) + bi * a.sv.b + hi * a.sv.h;
  const float* bias = a.bias ? a.bias + (long long)bh * t : nullptr;

  load_rows_f32<T, BR, DH, LDT, kF32Threads>(
      q_s, static_cast<const T*>(a.q) + bi * a.sq.b + hi * a.sq.h, a.sq.t, q0, t);
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
      load_rows_f32<T, BC, DH, LDT, kF32Threads>(k_s, kp, a.sk.t, k0, t);
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
      load_rows_f32<T, BC, DH, LDT, kF32Threads>(k_s, kp, a.sk.t, k0, t);
      load_rows_f32<T, BC, DH, LDT, kF32Threads>(v_s, vp, a.sv.t, k0, t);
      __syncthreads();
      mm<BR, BC, DH, false, true, false>(s_s, LDS, q_s, LDT, k_s, LDT);
      __syncthreads();
      for (int r = warp; r < BR; r += kF32Warps) {
        const float s = row_score(r, k0);
        const float l = l_s[r] == 0.f ? 1.f : l_s[r];
        s_s[r * LDS + lane] = s > 0.5f * kNeg ? round_as<T>(expf(s - m_s[r]) / l) : 0.f;
      }
      __syncthreads();
      mm<BR, DH, BC, false, false, true>(o_s, LDT, s_s, LDS, v_s, LDT);
    }
  } else {
    for (int k0 = 0; k0 < k_end; k0 += BC) {
      __syncthreads();
      load_rows_f32<T, BC, DH, LDT, kF32Threads>(k_s, kp, a.sk.t, k0, t);
      load_rows_f32<T, BC, DH, LDT, kF32Threads>(v_s, vp, a.sv.t, k0, t);
      __syncthreads();
      mm<BR, BC, DH, false, true, false>(s_s, LDS, q_s, LDT, k_s, LDT);
      __syncthreads();
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
  store_rows<T, BR, DH, LDT>(static_cast<T*>(a.o) + bi * a.so.b + hi * a.so.h,
                             a.so.t, o_s, q0, t);
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

template <int DH, bool kSingle>
int launch_wgmma(const FwdArgs& a, int b, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, a.q, a.sq, b, a.h, a.t, DH, kWgRows);
  if (!rc) rc = make_map(&tk, a.k, a.sk, b, a.h, a.t, DH, kWgKeys);
  if (!rc) rc = make_map(&tv, a.v, a.sv, b, a.h, a.t, DH, kWgKeys);
  if (rc) return rc;
  static bool configured = false;
  if (!configured) {   // once, on the first (uncaptured) launch
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16_wgmma_kernel<DH, kSingle>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)WgLayout<DH>::kBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(b * a.h, (a.t + kWgRows - 1) / kWgRows);
  flash_fwd_bf16_wgmma_kernel<DH, kSingle>
      <<<grid, kWgThreads, WgLayout<DH>::kBytes, s>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

template <typename T, int DH, bool kSingle>
int launch_plain(const FwdArgs& a, int b, cudaStream_t s) {
  static bool configured = false;
  const dim3 grid((a.t + kF32Tile - 1) / kF32Tile, b * a.h);
  return launch(flash_fwd_plain_kernel<T, DH, kSingle>, F32FwdLayout<DH>::kBytes,
                configured, grid, kF32Threads, a, s);
}

template <int DH, bool kSingle>
int launch_dh(const FwdArgs& a, int b, int is_bf16, cudaStream_t s) {
  if (!is_bf16) return launch_plain<float, DH, kSingle>(a, b, s);
  if constexpr (DH <= 128)
    return launch_wgmma<DH, kSingle>(a, b, s);
  else
    return launch_plain<__nv_bfloat16, DH, kSingle>(a, b, s);
}

template <bool kSingle>
int launch_any(const FwdArgs& a, int b, int dh, int is_bf16, cudaStream_t s) {
  switch (dh) {
    case 64: return launch_dh<64, kSingle>(a, b, is_bf16, s);
    case 128: return launch_dh<128, kSingle>(a, b, is_bf16, s);
    case 192: return launch_dh<192, kSingle>(a, b, is_bf16, s);
    default: return launch_dh<256, kSingle>(a, b, is_bf16, s);
  }
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
  if (b <= 0 || h <= 0 || t <= 0 || (dh != 64 && dh != 128 && dh != 192 && dh != 256) ||
      b * h > 65535)
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
