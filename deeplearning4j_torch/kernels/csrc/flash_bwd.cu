// Flash-attention backward for Hopper (sm_90a): K5 and K6.
//
// Replaces the TPU kernels deeplearning4j_tpu/kernels/flash_attention.py:
//   K5 _bwd_dkdv_kernel  (first pl.pallas_call of _flash_bwd)
//   K6 _bwd_dq_kernel    (second pl.pallas_call of _flash_bwd)
// Both recompute P = exp(Q K^T * scale + bias - LSE) tile by tile from the
// forward's saved LSE [b*h, t], so nothing [t, t] reaches device memory,
// and take delta = rowsum(dO * O) [b*h, t] (f32), which the caller
// computes beforehand.  With dS = P * (dO V^T - delta):
//   K5, per key tile:   dV = P^T dO (P rounded to the input dtype),
//                       dK = (dS * scale)^T Q, and with a bias
//                       dBias = sum over queries of dS (f32, [b*h, t]);
//   K6, per query tile: dQ = (dS * scale) K.
// dBias carries no division by 8: the TPU kernel's "/ 8.0" only undid the
// VJP of its 8-sublane bias broadcast, which the port does not have.
//
// Bound: operations.  Causal at b 8, t 2048, h 6, dh 128: K5 runs four
// products (Q K^T, dO V^T, P^T dO, dS^T Q) ~103 GFLOP, K6 three (Q K^T,
// dO V^T, dS K) ~77 GFLOP, over ~150 and ~125 MB of operands.
//
// Design: one thread block per (key tile, batch*head) for K5 and per
// (query tile, batch*head) for K6; the block loops over the other axis's
// tiles (the Pallas grid's "arbitrary" axis), skipping tiles wholly on the
// masked side of the causal diagonal.  K5 owns its key tile, so it sums dS
// over every query tile itself and needs no atomics.  Rows and keys at or
// past t are never written.
// * bf16 K5 (v3): wgmma on TMA tiles (flash_hopper.cuh).  A block owns
//   128 keys, two warpgroups of 64 (wgmma's M); its K and V arrive once by
//   TMA and stay in shared memory, and the Q and dO tiles of 64 query rows
//   stream through a two-stage ring from 4-D tensor maps over the bthd
//   views (rows past t read as zeros), with their LSE and delta rows by
//   cp.async; thread 0 prefetches tile j + 1 before tile j is computed (no
//   producer warp, no setmaxnreg).  The transposed tiles S^T = K Q^T and
//   dP^T = V dO^T are wgmma m64n64k16 with keys as M, both operands in
//   shared memory; P^T and dS^T stay in the accumulator registers and
//   become the register A operands of dV += P^T dO and dK += (dS scale)^T
//   Q (wgmma m64n{dh}k16, dO and Q MN-major through the descriptor's
//   transpose bit: one swizzled tile serves both descriptors).  P is
//   recomputed in base 2 (ex2.approx) from each query column's LSE, with a
//   branch-free path for interior tiles (no bias, wholly below the
//   diagonal) and masking on diagonal and biased tiles, the key bias read
//   once per block; rounding points as v2: P to bf16 for P^T dO, dS *
//   scale to bf16 for dS^T Q, dBias the f32 sum of dS.  Low key tiles go
//   first (the most causal work), in groups of 8 (batch, head) slices so
//   the Q/dO tiles the running blocks share stay in L2.  Each block
//   writes its dK and dV once, at the end.
// * bf16 K6 (v3): K5 v3's machinery with queries as wgmma's M.  A block
//   owns 128 query rows, two warpgroups of 64; its Q and dO arrive once by
//   TMA and stay in shared memory, each row's LSE and delta are read once
//   into registers, and the K and V tiles of 64 keys stream through a
//   two-stage TMA ring (thread 0 prefetches tile j + 1 before tile j is
//   computed).  S = Q K^T and dP = dO V^T are wgmma m64n64k16 with both
//   operands in shared memory; dS * scale, rounded to bf16 as in v2, stays
//   in the accumulator registers and becomes the register A operand of
//   dQ += dS K (wgmma m64n{dh}k16, K MN-major through the transpose bit:
//   the tile S read K-major serves both).  64-key tiles keep the S, dP
//   and dQ accumulators at 32 + 32 + 64 f32 registers a thread at dh 128
//   (128-key tiles would take 64 + 64 + 64 beside the A fragments).  P is
//   recomputed in base 2 from each row's LSE, branch-free on interior
//   tiles and masked on diagonal, ragged and biased ones; the heaviest
//   causal query tile goes first, in groups of 8 (batch, head) slices so
//   the K/V tiles the running blocks share stay in L2.  dQ is written
//   once, at the end, with no atomics.
// * bf16 K5 and K6 at head dims 192 and 256 (flash_bwd_dkdv_wide_kernel,
//   flash_bwd_dq_wide_kernel): v3's machinery on 64 x 64 tiles, where
//   v3's dK/dV or dQ accumulators and resident tiles would not fit.  A
//   block owns 64 keys (K5) or 64 query rows (K6), both warpgroups on
//   the same 64, each computing its 32-column half of S^T and dP^T (or S
//   and dP) with wgmma m64n32k16.  K5 stages P^T and dS^T * scale in
//   shared memory as bf16; warpgroup 0 then accumulates dV, warpgroup 1
//   dK, each over the whole head dim (wgmma m64n{dh}k16, A from shared
//   memory).  K6's warpgroups each accumulate a partial dQ over their
//   32-key halves (dS * scale the register A operand), summed once at
//   the end.  Registers and shared memory: see WideLayout.
// * f32 (tf32 would change the results): 8 warps, 32-row tiles, f32
//   tiles in shared memory, plain FMAs on the inputs' exact values.  At
//   dh 256 the tiles take ~213 KB of shared memory.  A simple kernel that
//   is right, bound by its FMAs, not the tensor cores.
// * past head dim 256 (any multiple of 64): the same FMA route chunked —
//   S and dP summed over 64-column chunks, each block owning 128 output
//   columns of dQ or of dK and dV (flash_bwd_chunked_kernel).
#include "flash_hopper.cuh"

using namespace flash;

namespace {

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* bias;   // [b*h, t] or null
  const float* lse;    // [b*h, t]
  const float* delta;  // [b*h, t]
  void* dq;
  void* dk;
  void* dv;
  float* dbias;        // [b*h, t] or null (K5 only)
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int h, t;
  float scale;
  int causal;
};

// P of (query row, key col) from the raw dot product and the row's LSE;
// 0 where either lies at or past t, or the key is causally masked
__device__ __forceinline__ float recompute_p(const BwdArgs& a, const float* bias,
                                             float dot, int row, int col,
                                             float lse) {
  if (row >= a.t || col >= a.t) return 0.f;
  float s = dot * a.scale;
  if (bias) s += bias[col];
  if (a.causal && col > row) s = kNeg;
  return expf(s - lse);
}

// the query tile's LSE and delta rows; rows at or past t get LSE = 1e30
// (so p == 0) and delta 0
template <int R, int NT>
__device__ __forceinline__ void load_stats(const BwdArgs& a, int bh, int q0,
                                           float* lse_s, float* dl_s) {
  for (int r = threadIdx.x; r < R; r += NT) {
    const int row = q0 + r;
    const bool in = row < a.t;
    lse_s[r] = in ? a.lse[(long long)bh * a.t + row] : kPos;
    dl_s[r] = in ? a.delta[(long long)bh * a.t + row] : 0.f;
  }
}

template <int ND>
__device__ __forceinline__ void store_frag_rows(__nv_bfloat16* base, long long st,
                                                const float (&acc)[ND][4],
                                                const int (&row)[2], int t,
                                                int qd) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= t) continue;
    __nv_bfloat16* p = base + (long long)row[r] * st + 2 * qd;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j) = pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// bf16 K5 v3: wgmma on TMA-filled, 128-byte-swizzled tiles
// ---------------------------------------------------------------------------
// A block owns 128 keys, 64 for each of two consumer warpgroups (wgmma's
// M); its K and V arrive once by TMA and stay in shared memory, while the
// Q and dO tiles of 64 query rows stream through a two-stage ring, with
// the tile's LSE and delta rows (cp.async) beside them.
constexpr int kBwThreads = 256;   // two warpgroups
constexpr int kBwKeys = 128;      // keys per block (64 a warpgroup)
constexpr int kBwRows = 64;       // query rows per streamed tile
constexpr int kBwStages = 2;

template <int DH>
struct DkdvLayout {
  static constexpr int NP = DH / kPanel;
  static constexpr uint32_t kKPanel = 128 * kBwKeys;   // 128 rows of 128 B
  static constexpr uint32_t kKTile = NP * kKPanel;
  static constexpr uint32_t kQPanel = 128 * kBwRows;   // 64 rows of 128 B
  static constexpr uint32_t kQTile = NP * kQPanel;
  static constexpr uint32_t kStatBytes = 2 * kBwRows * sizeof(float);   // LSE, delta
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kKTile;
  static constexpr uint32_t kQ = 2 * kKTile;                     // ring of Q tiles
  static constexpr uint32_t kDo = kQ + kBwStages * kQTile;        // ring of dO tiles
  static constexpr uint32_t kStat = kDo + kBwStages * kQTile;     // ring of stats
  static constexpr uint32_t kBar = kStat + kBwStages * kStatBytes;   // K/V + one a stage
  static constexpr size_t kBytes = kBar + 8 * (1 + kBwStages) + 1024;   // + alignment slack
};

template <int DH>
__global__ void __launch_bounds__(kBwThreads, 1)
    flash_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo, const BwdArgs a) {
  using bf16 = __nv_bfloat16;
  using L = DkdvLayout<DH>;
  constexpr int NJ = kBwRows / 8;   // query column blocks of a transposed tile
  constexpr int ND = DH / 8;
  constexpr int NK = DH / 16;       // k-steps of K Q^T and V dO^T
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sb = (raw + 1023) & ~1023u;   // 1024-byte-aligned swizzle atoms
  unsigned char* smem = smem_raw + (sb - raw);
  const uint32_t k_s = sb + L::kK, v_s = sb + L::kV;
  auto q_s = [&](int st) { return sb + L::kQ + st * L::kQTile; };
  auto do_s = [&](int st) { return sb + L::kDo + st * L::kQTile; };
  const uint32_t bar_kv = sb + L::kBar;
  auto bar_q = [&](int st) { return bar_kv + 8 + 8 * st; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, qd = lane & 3;
  const int t = a.t;
  // low key tiles first: they carry the most causal work
  const int2 blk = grouped_block((t + kBwKeys - 1) / kBwKeys);
  const int bh = blk.x;
  const int bi = bh / a.h, hi = bh - bi * a.h;
  const int k0 = blk.y * kBwKeys;
  const int kw0 = k0 + 64 * wg;   // this warpgroup's keys
  const int key[2] = {kw0 + 16 * wi + g, kw0 + 16 * wi + g + 8};
  // causal: query tiles wholly above this key tile see none of its keys
  const int q_begin = a.causal ? k0 : 0;
  const int n_tiles = (t - q_begin + kBwRows - 1) / kBwRows;

  // the consumers prefetch kAhead tiles ahead: thread 0 issues the TMA
  // copies of query tile j + kAhead before tile j is computed; the first
  // 128 threads copy its LSE and delta rows (zeros past t: there Q and dO
  // are zeros as well, so dS = 0), one cp.async group a tile, empty past
  // the last
  constexpr int kAhead = kBwStages - 1;
  auto issue = [&](int j) {
    const int st = j % kBwStages;
    mbar_expect(bar_q(st), 2 * L::kQTile);
#pragma unroll
    for (int p = 0; p < L::NP; ++p) {
      tma_load(q_s(st) + p * L::kQPanel, tq, bar_q(st), kPanel * p, hi,
               q_begin + j * kBwRows, bi);
      tma_load(do_s(st) + p * L::kQPanel, tdo, bar_q(st), kPanel * p, hi,
               q_begin + j * kBwRows, bi);
    }
  };
  auto copy_stats = [&](int j) {
    if (j < n_tiles && tid < 2 * kBwRows) {
      const int i = tid % kBwRows;
      const int row = q_begin + j * kBwRows + i;
      const float* src = (tid < kBwRows ? a.lse : a.delta) + (long long)bh * t + min(row, t - 1);
      cp_async4(sb + L::kStat + (j % kBwStages) * L::kStatBytes + 4 * tid, src,
                row < t ? 4 : 0);
    }
    cp_async_commit();
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + kBwStages; ++i) mbar_init(bar_kv + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(bar_kv, 2 * L::kKTile);
#pragma unroll
    for (int p = 0; p < L::NP; ++p) {
      tma_load(k_s + p * L::kKPanel, tk, bar_kv, kPanel * p, hi, k0, bi);
      tma_load(v_s + p * L::kKPanel, tv, bar_kv, kPanel * p, hi, k0, bi);
    }
    for (int j = 0; j < kAhead && j < n_tiles; ++j) issue(j);
  }
  for (int j = 0; j < kAhead; ++j) copy_stats(j);

  const float* bias = a.bias ? a.bias + (long long)bh * t : nullptr;
  float bk[2];   // the bias of this thread's two keys, constant over the block
#pragma unroll
  for (int r = 0; r < 2; ++r) bk[r] = bias && key[r] < t ? bias[key[r]] : 0.f;
  const float c = a.scale * kLog2e;
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  float db[2] = {0.f, 0.f};
  mbar_wait(bar_kv, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kBwStages;
    const int q0 = q_begin + j * kBwRows;
    cp_async_wait<kAhead - 1>();
    __syncthreads();   // tile j's stats visible; tile j - 1 read by everyone: its stage is free
    if (tid == 0 && j + kAhead < n_tiles) issue(j + kAhead);
    copy_stats(j + kAhead);
    // causal: this warpgroup's keys all come after the tile's queries
    if (a.causal && q0 + kBwRows - 1 < kw0) continue;
    mbar_wait(bar_q(st), (j / kBwStages) & 1);

    // transposed tiles, keys x queries: S^T = K Q^T, dP^T = V dO^T, all
    // K-major — a k-step advances 32 bytes inside the swizzled row, a
    // panel every four k-steps
    float sT[NJ][4], dpT[NJ][4];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const uint32_t ka = (kk / 4) * L::kKPanel + (kk % 4) * 32 + wg * 64 * 128;
      const uint32_t kb = (kk / 4) * L::kQPanel + (kk % 4) * 32;
      Wgmma<64>::ss(sT, sw128_desc(k_s + ka, 16, 1024), sw128_desc(q_s(st) + kb, 16, 1024),
                    kk > 0);
      Wgmma<64>::ss(dpT, sw128_desc(v_s + ka, 16, 1024), sw128_desc(do_s(st) + kb, 16, 1024),
                    kk > 0);
    }
    wg_commit();
    wg_wait0();
    keep(sT);
    keep(dpT);

    // P^T from each query column's LSE in base 2, dS^T = P^T (dP^T -
    // delta); interior tiles (no bias, wholly below the diagonal) are
    // branch-free, the rest mask as the plain version does
    const float* lse_s = reinterpret_cast<const float*>(smem + L::kStat + st * L::kStatBytes);
    const float* dl_s = lse_s + kBwRows;
    const bool interior = !bias && (!a.causal || q0 >= kw0 + 64);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int cq = 8 * jj + 2 * qd;
      const float2 lse = *reinterpret_cast<const float2*>(lse_s + cq);
      const float2 dl = *reinterpret_cast<const float2*>(dl_s + cq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float lse_e = (e & 1) ? lse.y : lse.x;
        float p;
        if (interior) {
          p = ex2(fmaf(sT[jj][e], c, -lse_e * kLog2e));
        } else {
          const int qrow = q0 + cq + (e & 1);
          p = qrow >= t || (a.causal && key[r] > qrow)
                  ? 0.f
                  : ex2((fmaf(sT[jj][e], a.scale, bk[r]) - lse_e) * kLog2e);
        }
        const float ds = p * (dpT[jj][e] - ((e & 1) ? dl.y : dl.x));
        db[r] += ds;
        sT[jj][e] = p;
        dpT[jj][e] = ds * a.scale;
      }
    }

    // dV += P^T dO and dK += (dS scale)^T Q: P and dS * scale rounded to
    // bf16 as wgmma's register A operands; dO and Q MN-major through the
    // transpose bit — a k-step is 16 query rows (2048 bytes), the next 64
    // head columns a panel further (LBO)
    uint32_t pf[NJ / 2][4], sf[NJ / 2][4];
#pragma unroll
    for (int kc = 0; kc < NJ / 2; ++kc) {
      pack_a<NJ>(pf[kc], sT, kc);
      pack_a<NJ>(sf[kc], dpT, kc);
    }
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < NJ / 2; ++kc)
      Wgmma<DH>::rs(dv, pf[kc], sw128_desc(do_s(st) + kc * 16 * 128, L::kQPanel, 1024), 1);
#pragma unroll
    for (int kc = 0; kc < NJ / 2; ++kc)
      Wgmma<DH>::rs(dk, sf[kc], sw128_desc(q_s(st) + kc * 16 * 128, L::kQPanel, 1024), 1);
    wg_commit();
    wg_wait0();
    keep(dv);
    keep(dk);
    keep(pf);
    keep(sf);
  }

  store_frag_rows<ND>(static_cast<bf16*>(a.dk) + bi * a.sdk.b + hi * a.sdk.h, a.sdk.t, dk, key,
                      t, qd);
  store_frag_rows<ND>(static_cast<bf16*>(a.dv) + bi * a.sdv.b + hi * a.sdv.h, a.sdv.t, dv, key,
                      t, qd);
  if (a.dbias) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = quad_sum(db[r]);
      if (qd == 0 && key[r] < t) a.dbias[(long long)bh * t + key[r]] = sum;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 K6 v3: wgmma on TMA-filled, 128-byte-swizzled tiles
// ---------------------------------------------------------------------------
// A block owns 128 query rows, 64 for each of two consumer warpgroups
// (wgmma's M); its Q and dO arrive once by TMA and stay in shared memory,
// while the K and V tiles of 64 keys stream through a two-stage ring.
constexpr int kDqRows = 128;   // query rows per block (64 a warpgroup)
constexpr int kDqKeys = 64;    // keys per streamed tile

template <int DH>
struct DqLayout {
  static constexpr int NP = DH / kPanel;
  static constexpr uint32_t kQPanel = 128 * kDqRows;   // 128 rows of 128 B
  static constexpr uint32_t kQTile = NP * kQPanel;
  static constexpr uint32_t kKPanel = 128 * kDqKeys;   // 64 rows of 128 B
  static constexpr uint32_t kKTile = NP * kKPanel;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDo = kQTile;
  static constexpr uint32_t kK = 2 * kQTile;                  // ring of K tiles
  static constexpr uint32_t kV = kK + kBwStages * kKTile;     // ring of V tiles
  static constexpr uint32_t kBar = kV + kBwStages * kKTile;   // Q/dO + one a stage
  static constexpr size_t kBytes = kBar + 8 * (1 + kBwStages) + 1024;   // + alignment slack
};

template <int DH>
__global__ void __launch_bounds__(kBwThreads, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo, const BwdArgs a) {
  using bf16 = __nv_bfloat16;
  using L = DqLayout<DH>;
  constexpr int NJ = kDqKeys / 8;   // key column blocks of a score tile
  constexpr int ND = DH / 8;
  constexpr int NK = DH / 16;       // k-steps of Q K^T and dO V^T
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sb = (raw + 1023) & ~1023u;   // 1024-byte-aligned swizzle atoms
  const uint32_t q_s = sb + L::kQ, do_s = sb + L::kDo;
  auto k_s = [&](int st) { return sb + L::kK + st * L::kKTile; };
  auto v_s = [&](int st) { return sb + L::kV + st * L::kKTile; };
  const uint32_t bar_q = sb + L::kBar;
  auto bar_kv = [&](int st) { return bar_q + 8 + 8 * st; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, qd = lane & 3;
  const int t = a.t;
  const int n_q = (t + kDqRows - 1) / kDqRows;
  const int2 blk = grouped_block(n_q);   // heaviest causal tile first
  const int bh = blk.x;
  const int bi = bh / a.h, hi = bh - bi * a.h;
  const int q0 = (n_q - 1 - blk.y) * kDqRows;
  const int qw0 = q0 + 64 * wg;   // this warpgroup's rows
  const int row[2] = {qw0 + 16 * wi + g, qw0 + 16 * wi + g + 8};
  const int k_end = a.causal ? min(t, q0 + kDqRows) : t;
  const int n_k = (k_end + kDqKeys - 1) / kDqKeys;

  // the consumers prefetch: thread 0 issues the TMA copies of key tile
  // j + kAhead before tile j is computed (no producer warp)
  constexpr int kAhead = kBwStages - 1;
  auto issue = [&](int j) {
    const int st = j % kBwStages;
    mbar_expect(bar_kv(st), 2 * L::kKTile);
#pragma unroll
    for (int p = 0; p < L::NP; ++p) {
      tma_load(k_s(st) + p * L::kKPanel, tk, bar_kv(st), kPanel * p, hi, j * kDqKeys, bi);
      tma_load(v_s(st) + p * L::kKPanel, tv, bar_kv(st), kPanel * p, hi, j * kDqKeys, bi);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + kBwStages; ++i) mbar_init(bar_q + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(bar_q, 2 * L::kQTile);
#pragma unroll
    for (int p = 0; p < L::NP; ++p) {
      tma_load(q_s + p * L::kQPanel, tq, bar_q, kPanel * p, hi, q0, bi);
      tma_load(do_s + p * L::kQPanel, tdo, bar_q, kPanel * p, hi, q0, bi);
    }
    for (int j = 0; j < kAhead && j < n_k; ++j) issue(j);
  }

  // each row's LSE (and in base 2) and delta, read once; rows at or past
  // t get LSE = 1e30 (p == 0) and delta 0
  const float* bias = a.bias ? a.bias + (long long)bh * t : nullptr;
  float lse[2], lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < t;
    lse[r] = in ? a.lse[(long long)bh * t + row[r]] : kPos;
    lse2[r] = lse[r] * kLog2e;
    dl[r] = in ? a.delta[(long long)bh * t + row[r]] : 0.f;
  }
  const float c = a.scale * kLog2e;
  float dq[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  mbar_wait(bar_q, 0);

  for (int j = 0; j < n_k; ++j) {
    const int st = j % kBwStages;
    const int k0 = j * kDqKeys;
    __syncthreads();   // tile j - 1 read by every warpgroup: its stage is free
    if (tid == 0 && j + kAhead < n_k) issue(j + kAhead);
    // causal: this warpgroup's rows all come before the tile's keys
    if (a.causal && k0 > qw0 + 63) continue;
    mbar_wait(bar_kv(st), (j / kBwStages) & 1);

    // S = Q K^T and dP = dO V^T, all K-major: a k-step advances 32 bytes
    // inside the swizzled row, a panel every four k-steps
    float s[NJ][4], dp[NJ][4];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const uint32_t qa = (kk / 4) * L::kQPanel + (kk % 4) * 32 + wg * 64 * 128;
      const uint32_t kb = (kk / 4) * L::kKPanel + (kk % 4) * 32;
      Wgmma<64>::ss(s, sw128_desc(q_s + qa, 16, 1024), sw128_desc(k_s(st) + kb, 16, 1024),
                    kk > 0);
      Wgmma<64>::ss(dp, sw128_desc(do_s + qa, 16, 1024), sw128_desc(v_s(st) + kb, 16, 1024),
                    kk > 0);
    }
    wg_commit();
    wg_wait0();
    keep(s);
    keep(dp);

    // P from each row's LSE in base 2, dS * scale = P (dP - delta) scale;
    // interior tiles (no bias, every key below t and, causal, at or below
    // the warpgroup's first row) are branch-free, the rest mask as the
    // plain version does
    const bool interior =
        !bias && (a.causal ? k0 + kDqKeys - 1 <= qw0 : k0 + kDqKeys <= t);
    if (interior) {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = ex2(fmaf(s[jj][e], c, -lse2[r]));
          s[jj][e] = p * (dp[jj][e] - dl[r]) * a.scale;
        }
    } else {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int col0 = k0 + 8 * jj + 2 * qd;
        const float b0 = bias && col0 < t ? bias[col0] : 0.f;
        const float b1 = bias && col0 + 1 < t ? bias[col0 + 1] : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = col0 + (e & 1);
          const float p =
              col >= t || row[r] >= t || (a.causal && col > row[r])
                  ? 0.f
                  : ex2((fmaf(s[jj][e], a.scale, (e & 1) ? b1 : b0) - lse[r]) * kLog2e);
          s[jj][e] = p * (dp[jj][e] - dl[r]) * a.scale;
        }
      }
    }

    // dQ += (dS scale) K: dS * scale rounded to bf16 as wgmma's register A
    // operand; K MN-major through the transpose bit — a k-step is 16 key
    // rows (2048 bytes), the next 64 head columns a panel further (LBO)
    uint32_t sf[NJ / 2][4];
#pragma unroll
    for (int kc = 0; kc < NJ / 2; ++kc) pack_a<NJ>(sf[kc], s, kc);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < NJ / 2; ++kc)
      Wgmma<DH>::rs(dq, sf[kc], sw128_desc(k_s(st) + kc * 16 * 128, L::kKPanel, 1024), 1);
    wg_commit();
    wg_wait0();
    keep(dq);
    keep(sf);
  }

  store_frag_rows<ND>(static_cast<bf16*>(a.dq) + bi * a.sdq.b + hi * a.sdq.h, a.sdq.t, dq, row,
                      t, qd);
}

// ---------------------------------------------------------------------------
// bf16 K5 and K6 at head dims 192 and 256: wgmma on 64 x 64 tiles
// ---------------------------------------------------------------------------
// v3's layout does not fit there: a warpgroup owning 64 keys (K5) or rows
// (K6) with the whole head dim would hold dK and dV (K5: DH / 2 f32 each a
// thread, 256 registers at dh 256) or dQ beside its 64 x 64 S and dP
// tiles, and 128 resident rows of K and V (or Q and dO) beside a
// two-stage ring of the other pair take 256 KB of shared memory at
// dh 256.  So a block owns 64 keys (K5) or 64 query rows (K6), both
// warpgroups on the same 64 (wgmma's M), the other axis streaming in
// 64-row tiles; each warpgroup computes its 32-column half of the
// transposed or plain score tiles (wgmma m64n32k16, both operands in
// shared memory).
// * K5: P^T and dS^T * scale go to shared memory as bf16 (two 64 x 64
//   swizzled tiles), and after a barrier warpgroup 0 accumulates dV +=
//   P^T dO and warpgroup 1 dK += (dS^T scale) Q over all 64 queries of the
//   tile (wgmma m64n{dh}k16, A from shared memory K-major, B MN-major):
//   one full-width accumulator a warpgroup, 128 registers at dh 256.  A
//   split by head columns would put a warpgroup's half of dh 192 (96
//   columns) across a swizzled panel's middle.  dBias: each warpgroup
//   sums dS over its query halves; the halves meet in shared memory.
//   Shared memory at dh 256: K + V 64 KB, the Q/dO ring 128 KB, P^T +
//   dS^T 16 KB, stats 1 KB: ~210 KB (162 KB at dh 192).
// * K6: each warpgroup accumulates a partial dQ over its 32-key half of
//   every key tile, dS * scale its register A operand (wgmma m64n{dh}k16,
//   K MN-major), with no barrier between the warpgroups inside the loop;
//   at the end warpgroup 1's partial goes through shared memory (the K
//   ring) to warpgroup 0, which adds and writes dQ once.  Registers: dQ
//   128, S and dP halves 16 + 16 at dh 256.  Shared memory: Q + dO 64 KB,
//   the K/V ring 128 KB: ~194 KB (146 KB at dh 192).
// P is recomputed in base 2 as in v3, interior tiles branch-free and the
// rest masked, with v3's rounding points and launch order.
constexpr int kWide = 64;   // keys a K5 block / rows a K6 block, and the streamed tiles' rows

template <int DH>
struct WideLayout {
  static constexpr int NP = DH / kPanel;
  static constexpr uint32_t kPanelB = 128 * kWide;   // 64 rows of 128 B
  static constexpr uint32_t kTile = NP * kPanelB;    // one 64-row operand tile
  static constexpr uint32_t kStatBytes = 2 * kWide * sizeof(float);   // LSE, delta
  // resident pair (K5: K, V; K6: Q, dO), then the streamed pair's rings
  static constexpr uint32_t kRes0 = 0, kRes1 = kTile;
  static constexpr uint32_t kRing0 = 2 * kTile;
  static constexpr uint32_t kRing1 = kRing0 + kBwStages * kTile;
  static constexpr uint32_t kEnd = kRing1 + kBwStages * kTile;
  // K5 only: P^T, dS^T * scale (one bf16 panel each), the stats ring and
  // warpgroup 1's dBias half
  static constexpr uint32_t kPt = kEnd, kDst = kPt + kPanelB;
  static constexpr uint32_t kStat = kDst + kPanelB;
  static constexpr uint32_t kDb = kStat + kBwStages * kStatBytes;
  static constexpr uint32_t kBarDkdv = kDb + kWide * sizeof(float);
  static constexpr size_t kBytesDkdv = kBarDkdv + 8 * (1 + kBwStages) + 1024;
  static constexpr size_t kBytesDq = kEnd + 8 * (1 + kBwStages) + 1024;
  static_assert(kBytesDkdv <= 232448, "K5 wide tiles exceed shared memory");
  // K6's second partial dQ (f32, 128 threads x DH / 2) fits in its rings
  static_assert(128 * (DH / 2) * sizeof(float) <= 2 * kBwStages * kTile, "dQ partial");
};

template <int DH>
__global__ void __launch_bounds__(kBwThreads, 1)
    flash_bwd_dkdv_wide_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo, const BwdArgs a) {
  using bf16 = __nv_bfloat16;
  using L = WideLayout<DH>;
  constexpr int NJ = kWide / 2 / 8;   // query column blocks of a warpgroup's half
  constexpr int ND = DH / 8;
  constexpr int NK = DH / 16;         // k-steps of K Q^T and V dO^T
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sb = (raw + 1023) & ~1023u;   // 1024-byte-aligned swizzle atoms
  unsigned char* smem = smem_raw + (sb - raw);
  const uint32_t k_s = sb + L::kRes0, v_s = sb + L::kRes1;
  auto q_s = [&](int st) { return sb + L::kRing0 + st * L::kTile; };
  auto do_s = [&](int st) { return sb + L::kRing1 + st * L::kTile; };
  const uint32_t bar_kv = sb + L::kBarDkdv;
  auto bar_q = [&](int st) { return bar_kv + 8 + 8 * st; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, qd = lane & 3;
  const int t = a.t;
  // low key tiles first: they carry the most causal work
  const int2 blk = grouped_block((t + kWide - 1) / kWide);
  const int bh = blk.x;
  const int bi = bh / a.h, hi = bh - bi * a.h;
  const int k0 = blk.y * kWide;
  const int key[2] = {k0 + 16 * wi + g, k0 + 16 * wi + g + 8};
  // causal: query tiles wholly above this key tile see none of its keys
  const int q_begin = a.causal ? k0 : 0;
  const int n_tiles = (t - q_begin + kWide - 1) / kWide;

  // as v3: thread 0 issues the TMA copies of query tile j + kAhead before
  // tile j is computed, the first 128 threads copy its LSE and delta rows
  constexpr int kAhead = kBwStages - 1;
  auto issue = [&](int j) {
    const int st = j % kBwStages;
    mbar_expect(bar_q(st), 2 * L::kTile);
#pragma unroll
    for (int p = 0; p < L::NP; ++p) {
      tma_load(q_s(st) + p * L::kPanelB, tq, bar_q(st), kPanel * p, hi,
               q_begin + j * kWide, bi);
      tma_load(do_s(st) + p * L::kPanelB, tdo, bar_q(st), kPanel * p, hi,
               q_begin + j * kWide, bi);
    }
  };
  auto copy_stats = [&](int j) {
    if (j < n_tiles && tid < 2 * kWide) {
      const int i = tid % kWide;
      const int row = q_begin + j * kWide + i;
      const float* src = (tid < kWide ? a.lse : a.delta) + (long long)bh * t + min(row, t - 1);
      cp_async4(sb + L::kStat + (j % kBwStages) * L::kStatBytes + 4 * tid, src,
                row < t ? 4 : 0);
    }
    cp_async_commit();
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + kBwStages; ++i) mbar_init(bar_kv + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(bar_kv, 2 * L::kTile);
#pragma unroll
    for (int p = 0; p < L::NP; ++p) {
      tma_load(k_s + p * L::kPanelB, tk, bar_kv, kPanel * p, hi, k0, bi);
      tma_load(v_s + p * L::kPanelB, tv, bar_kv, kPanel * p, hi, k0, bi);
    }
    for (int j = 0; j < kAhead && j < n_tiles; ++j) issue(j);
  }
  for (int j = 0; j < kAhead; ++j) copy_stats(j);

  const float* bias = a.bias ? a.bias + (long long)bh * t : nullptr;
  float bk[2];   // the bias of this thread's two keys, constant over the block
#pragma unroll
  for (int r = 0; r < 2; ++r) bk[r] = bias && key[r] < t ? bias[key[r]] : 0.f;
  const float c = a.scale * kLog2e;
  float acc[ND][4];   // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float db[2] = {0.f, 0.f};
  // warpgroup 0 multiplies P^T by dO, warpgroup 1 dS^T * scale by Q
  const uint32_t a_s = sb + (wg ? L::kDst : L::kPt);
  mbar_wait(bar_kv, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kBwStages;
    const int q0 = q_begin + j * kWide;
    cp_async_wait<kAhead - 1>();
    // tile j's stats visible; tile j - 1 read by everyone: its stage and
    // the P^T / dS^T tiles are free
    __syncthreads();
    if (tid == 0 && j + kAhead < n_tiles) issue(j + kAhead);
    copy_stats(j + kAhead);
    mbar_wait(bar_q(st), (j / kBwStages) & 1);

    // this warpgroup's half of the transposed tiles, all 64 keys x its 32
    // queries: S^T = K Q^T, dP^T = V dO^T, both operands K-major
    float sT[NJ][4], dpT[NJ][4];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const uint32_t ka = (kk / 4) * L::kPanelB + (kk % 4) * 32;
      const uint32_t kb = ka + wg * (kWide / 2) * 128;
      Wgmma<32>::ss(sT, sw128_desc(k_s + ka, 16, 1024), sw128_desc(q_s(st) + kb, 16, 1024),
                    kk > 0);
      Wgmma<32>::ss(dpT, sw128_desc(v_s + ka, 16, 1024), sw128_desc(do_s(st) + kb, 16, 1024),
                    kk > 0);
    }
    wg_commit();
    wg_wait0();
    keep(sT);
    keep(dpT);

    // P^T in base 2 from each query column's LSE, dS^T = P^T (dP^T -
    // delta), as v3; then P^T and dS^T * scale to shared memory as bf16 in
    // the 128-byte swizzle wgmma reads (16-byte chunk index ^ row % 8)
    const float* lse_s = reinterpret_cast<const float*>(smem + L::kStat + st * L::kStatBytes);
    const float* dl_s = lse_s + kWide;
    const bool interior = !bias && (!a.causal || q0 >= k0 + kWide);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int cq = (kWide / 2) * wg + 8 * jj + 2 * qd;
      const float2 lse = *reinterpret_cast<const float2*>(lse_s + cq);
      const float2 dl = *reinterpret_cast<const float2*>(dl_s + cq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float lse_e = (e & 1) ? lse.y : lse.x;
        float p;
        if (interior) {
          p = ex2(fmaf(sT[jj][e], c, -lse_e * kLog2e));
        } else {
          const int qrow = q0 + cq + (e & 1);
          p = qrow >= t || (a.causal && key[r] > qrow)
                  ? 0.f
                  : ex2((fmaf(sT[jj][e], a.scale, bk[r]) - lse_e) * kLog2e);
        }
        const float ds = p * (dpT[jj][e] - ((e & 1) ? dl.y : dl.x));
        db[r] += ds;
        sT[jj][e] = p;
        dpT[jj][e] = ds * a.scale;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * wi + g + 8 * r;
        const uint32_t off = row * 128 + ((((cq >> 3) ^ (row & 7)) << 4) | (4 * qd));
        *reinterpret_cast<uint32_t*>(smem + L::kPt + off) =
            pack_bf16(sT[jj][2 * r], sT[jj][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(smem + L::kDst + off) =
            pack_bf16(dpT[jj][2 * r], dpT[jj][2 * r + 1]);
      }
    }
    fence_async_smem();
    __syncthreads();   // both halves of P^T and dS^T written

    // dV += P^T dO (warpgroup 0) or dK += (dS^T scale) Q (warpgroup 1)
    // over the tile's 64 queries: A K-major (a k-step 32 bytes inside the
    // swizzled row), B MN-major through the transpose bit (a k-step is 16
    // query rows, 2048 bytes; the next 64 head columns a panel further)
    const uint32_t b_s = wg ? q_s(st) : do_s(st);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < kWide / 16; ++kc)
      Wgmma<DH>::ss_tb(acc, sw128_desc(a_s + kc * 32, 16, 1024),
                       sw128_desc(b_s + kc * 16 * 128, L::kPanelB, 1024), 1);
    wg_commit();
    wg_wait0();
    keep(acc);
  }

  if (wg)
    store_frag_rows<ND>(static_cast<bf16*>(a.dk) + bi * a.sdk.b + hi * a.sdk.h, a.sdk.t, acc,
                        key, t, qd);
  else
    store_frag_rows<ND>(static_cast<bf16*>(a.dv) + bi * a.sdv.b + hi * a.sdv.h, a.sdv.t, acc,
                        key, t, qd);
  if (a.dbias) {
    float* db_s = reinterpret_cast<float*>(smem + L::kDb);
    float sum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] = quad_sum(db[r]);
      if (wg == 1 && qd == 0) db_s[16 * wi + g + 8 * r] = sum[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (wg == 0 && qd == 0 && key[r] < t)
        a.dbias[(long long)bh * t + key[r]] = sum[r] + db_s[16 * wi + g + 8 * r];
  }
}

template <int DH>
__global__ void __launch_bounds__(kBwThreads, 1)
    flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo, const BwdArgs a) {
  using bf16 = __nv_bfloat16;
  using L = WideLayout<DH>;
  constexpr int NJ = kWide / 2 / 8;   // key column blocks of a warpgroup's half
  constexpr int ND = DH / 8;
  constexpr int NK = DH / 16;         // k-steps of Q K^T and dO V^T
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sb = (raw + 1023) & ~1023u;   // 1024-byte-aligned swizzle atoms
  unsigned char* smem = smem_raw + (sb - raw);
  const uint32_t q_s = sb + L::kRes0, do_s = sb + L::kRes1;
  auto k_s = [&](int st) { return sb + L::kRing0 + st * L::kTile; };
  auto v_s = [&](int st) { return sb + L::kRing1 + st * L::kTile; };
  const uint32_t bar_q = sb + L::kEnd;
  auto bar_kv = [&](int st) { return bar_q + 8 + 8 * st; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, qd = lane & 3;
  const int t = a.t;
  const int n_q = (t + kWide - 1) / kWide;
  const int2 blk = grouped_block(n_q);   // heaviest causal tile first
  const int bh = blk.x;
  const int bi = bh / a.h, hi = bh - bi * a.h;
  const int q0 = (n_q - 1 - blk.y) * kWide;
  const int row[2] = {q0 + 16 * wi + g, q0 + 16 * wi + g + 8};
  const int k_end = a.causal ? min(t, q0 + kWide) : t;
  const int n_k = (k_end + kWide - 1) / kWide;

  constexpr int kAhead = kBwStages - 1;
  auto issue = [&](int j) {
    const int st = j % kBwStages;
    mbar_expect(bar_kv(st), 2 * L::kTile);
#pragma unroll
    for (int p = 0; p < L::NP; ++p) {
      tma_load(k_s(st) + p * L::kPanelB, tk, bar_kv(st), kPanel * p, hi, j * kWide, bi);
      tma_load(v_s(st) + p * L::kPanelB, tv, bar_kv(st), kPanel * p, hi, j * kWide, bi);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + kBwStages; ++i) mbar_init(bar_q + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(bar_q, 2 * L::kTile);
#pragma unroll
    for (int p = 0; p < L::NP; ++p) {
      tma_load(q_s + p * L::kPanelB, tq, bar_q, kPanel * p, hi, q0, bi);
      tma_load(do_s + p * L::kPanelB, tdo, bar_q, kPanel * p, hi, q0, bi);
    }
    for (int j = 0; j < kAhead && j < n_k; ++j) issue(j);
  }

  // each row's LSE (and in base 2) and delta, read once; rows at or past
  // t get LSE = 1e30 (p == 0) and delta 0
  const float* bias = a.bias ? a.bias + (long long)bh * t : nullptr;
  float lse[2], lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < t;
    lse[r] = in ? a.lse[(long long)bh * t + row[r]] : kPos;
    lse2[r] = lse[r] * kLog2e;
    dl[r] = in ? a.delta[(long long)bh * t + row[r]] : 0.f;
  }
  const float c = a.scale * kLog2e;
  float dq[ND][4];   // this warpgroup's partial: its 32-key half of every tile
#pragma unroll
  for (int j = 0; j < ND; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  mbar_wait(bar_q, 0);

  for (int j = 0; j < n_k; ++j) {
    const int st = j % kBwStages;
    const int kw0 = j * kWide + (kWide / 2) * wg;   // this warpgroup's keys
    __syncthreads();   // tile j - 1 read by every warpgroup: its stage is free
    if (tid == 0 && j + kAhead < n_k) issue(j + kAhead);
    mbar_wait(bar_kv(st), (j / kBwStages) & 1);

    // S = Q K^T and dP = dO V^T at all 64 rows x this warpgroup's 32 keys,
    // both operands K-major
    float s[NJ][4], dp[NJ][4];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const uint32_t qa = (kk / 4) * L::kPanelB + (kk % 4) * 32;
      const uint32_t kb = qa + wg * (kWide / 2) * 128;
      Wgmma<32>::ss(s, sw128_desc(q_s + qa, 16, 1024), sw128_desc(k_s(st) + kb, 16, 1024),
                    kk > 0);
      Wgmma<32>::ss(dp, sw128_desc(do_s + qa, 16, 1024), sw128_desc(v_s(st) + kb, 16, 1024),
                    kk > 0);
    }
    wg_commit();
    wg_wait0();
    keep(s);
    keep(dp);

    // P from each row's LSE in base 2, dS * scale = P (dP - delta) scale;
    // interior halves (no bias, every key below t and, causal, at or below
    // the block's first row) are branch-free, the rest mask
    const bool interior =
        !bias && (a.causal ? kw0 + kWide / 2 - 1 <= q0 : kw0 + kWide / 2 <= t);
    if (interior) {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = ex2(fmaf(s[jj][e], c, -lse2[r]));
          s[jj][e] = p * (dp[jj][e] - dl[r]) * a.scale;
        }
    } else {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int col0 = kw0 + 8 * jj + 2 * qd;
        const float b0 = bias && col0 < t ? bias[col0] : 0.f;
        const float b1 = bias && col0 + 1 < t ? bias[col0 + 1] : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = col0 + (e & 1);
          const float p =
              col >= t || row[r] >= t || (a.causal && col > row[r])
                  ? 0.f
                  : ex2((fmaf(s[jj][e], a.scale, (e & 1) ? b1 : b0) - lse[r]) * kLog2e);
          s[jj][e] = p * (dp[jj][e] - dl[r]) * a.scale;
        }
      }
    }

    // dQ += (dS scale) K over this warpgroup's 32 keys: dS * scale rounded
    // to bf16 as the register A operand; K MN-major through the transpose
    // bit — a k-step is 16 key rows (2048 bytes), the next 64 head columns
    // a panel further (LBO)
    uint32_t sf[NJ / 2][4];
#pragma unroll
    for (int kc = 0; kc < NJ / 2; ++kc) pack_a<NJ>(sf[kc], s, kc);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < NJ / 2; ++kc)
      Wgmma<DH>::rs(dq, sf[kc],
                    sw128_desc(k_s(st) + ((kWide / 2) * wg + 16 * kc) * 128, L::kPanelB, 1024),
                    1);
    wg_commit();
    wg_wait0();
    keep(dq);
    keep(sf);
  }

  // warpgroup 1's partial through shared memory (the K ring, free now),
  // element (j, e) of thread i at [4 j + e][i]; warpgroup 0 adds and writes
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem + L::kRing0);
  if (wg == 1) {
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[(4 * j + e) * 128 + tid - 128] = dq[j][e];
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[j][e] += part[(4 * j + e) * 128 + tid];
    store_frag_rows<ND>(static_cast<bf16*>(a.dq) + bi * a.sdq.b + hi * a.sdq.h, a.sdq.t, dq,
                        row, t, qd);
  }
}

// ---------------------------------------------------------------------------
// plain route (f32): f32 tiles in shared memory, FMAs
// ---------------------------------------------------------------------------
template <int DH>
struct F32BwdLayout {
  static constexpr int BR = kF32Tile, BC = kF32Tile;
  static constexpr int LDT = DH + 4;   // q, k, v, dO tiles and accumulators
  static constexpr int LDS = BC + 4;   // [BR, BC] tiles
  static constexpr int kTileT = BR * LDT, kTileS = BR * LDS;
  // q, dO, k, v; S (then dS), dP, P, dS * scale; acc0 (dK or dQ), acc1
  // (dV); LSE, delta, dBias
  static constexpr size_t kBytes =
      sizeof(float) * (6 * kTileT + 4 * kTileS + 3 * BR);
};

template <typename T, int DH>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_plain_kernel(BwdArgs a,
                                                                      bool dq_pass) {
  using L = F32BwdLayout<DH>;
  constexpr int BR = L::BR, BC = L::BC, LDT = L::LDT, LDS = L::LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* do_s = q_s + L::kTileT;
  float* k_s = do_s + L::kTileT;
  float* v_s = k_s + L::kTileT;
  float* acc0 = v_s + L::kTileT;
  float* acc1 = acc0 + L::kTileT;
  float* s_s = acc1 + L::kTileT;      // scores, then dS
  float* dp_s = s_s + L::kTileS;
  float* p_s = dp_s + L::kTileS;
  float* ds_s = p_s + L::kTileS;      // dS * scale
  float* lse_s = ds_s + L::kTileS;
  float* dl_s = lse_s + BR;
  float* db_s = dl_s + BR;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int bi = bh / a.h, hi = bh - bi * a.h;
  const int t = a.t;
  const T* qp = static_cast<const T*>(a.q) + bi * a.sq.b + hi * a.sq.h;
  const T* kp = static_cast<const T*>(a.k) + bi * a.sk.b + hi * a.sk.h;
  const T* vp = static_cast<const T*>(a.v) + bi * a.sv.b + hi * a.sv.h;
  const T* dop = static_cast<const T*>(a.dout) + bi * a.sdo.b + hi * a.sdo.h;
  const float* bias = a.bias ? a.bias + (long long)bh * t : nullptr;
  const bool want_db = !dq_pass && a.dbias != nullptr;
  const int n_tiles = (t + BR - 1) / BR;
  // K6 owns a query tile (heaviest causal first), K5 a key tile
  const int own0 = dq_pass ? (n_tiles - 1 - (int)blockIdx.x) * BR
                           : (int)blockIdx.x * BC;
  for (int i = tid; i < 2 * L::kTileT; i += kF32Threads) acc0[i] = 0.f;
  for (int i = tid; i < BC; i += kF32Threads) db_s[i] = 0.f;
  if (dq_pass) {
    load_rows_f32<T, BR, DH, LDT, kF32Threads>(q_s, qp, a.sq.t, own0, t);
    load_rows_f32<T, BR, DH, LDT, kF32Threads>(do_s, dop, a.sdo.t, own0, t);
    load_stats<BR, kF32Threads>(a, bh, own0, lse_s, dl_s);
  } else {
    load_rows_f32<T, BC, DH, LDT, kF32Threads>(k_s, kp, a.sk.t, own0, t);
    load_rows_f32<T, BC, DH, LDT, kF32Threads>(v_s, vp, a.sv.t, own0, t);
  }
  // the other axis's tiles this one meets (causal: those on the diagonal's
  // unmasked side)
  const int o_begin = (!dq_pass && a.causal) ? own0 : 0;
  const int o_end = (dq_pass && a.causal) ? min(t, own0 + BR) : t;
  for (int o0 = o_begin; o0 < o_end; o0 += BR) {
    const int q0 = dq_pass ? own0 : o0, k0 = dq_pass ? o0 : own0;
    __syncthreads();
    if (dq_pass) {
      load_rows_f32<T, BC, DH, LDT, kF32Threads>(k_s, kp, a.sk.t, k0, t);
      load_rows_f32<T, BC, DH, LDT, kF32Threads>(v_s, vp, a.sv.t, k0, t);
    } else {
      load_rows_f32<T, BR, DH, LDT, kF32Threads>(q_s, qp, a.sq.t, q0, t);
      load_rows_f32<T, BR, DH, LDT, kF32Threads>(do_s, dop, a.sdo.t, q0, t);
      load_stats<BR, kF32Threads>(a, bh, q0, lse_s, dl_s);
    }
    __syncthreads();
    mm<BR, BC, DH, false, true, false>(s_s, LDS, q_s, LDT, k_s, LDT);
    mm<BR, BC, DH, false, true, false>(dp_s, LDS, do_s, LDT, v_s, LDT);
    __syncthreads();
    for (int i = tid; i < BR * BC; i += kF32Threads) {
      const int r = i / BC, c = i - r * BC;
      const float p = recompute_p(a, bias, s_s[r * LDS + c], q0 + r, k0 + c,
                                  lse_s[r]);
      const float ds = p * (dp_s[r * LDS + c] - dl_s[r]);
      p_s[r * LDS + c] = round_as<T>(p);   // as K5 rounds P for P^T dO
      s_s[r * LDS + c] = ds;
      ds_s[r * LDS + c] = round_as<T>(ds * a.scale);
    }
    __syncthreads();
    if (dq_pass) {
      mm<BR, DH, BC, false, false, true>(acc0, LDT, ds_s, LDS, k_s, LDT);
    } else {
      mm<BC, DH, BR, true, false, true>(acc1, LDT, p_s, LDS, do_s, LDT);
      mm<BC, DH, BR, true, false, true>(acc0, LDT, ds_s, LDS, q_s, LDT);
      if (want_db) {
        for (int c = tid; c < BC; c += kF32Threads) {
          float acc = 0.f;
          for (int r = 0; r < BR; ++r) acc += s_s[r * LDS + c];
          db_s[c] += acc;
        }
      }
    }
  }
  __syncthreads();
  if (dq_pass) {
    store_rows<T, BR, DH, LDT>(static_cast<T*>(a.dq) + bi * a.sdq.b + hi * a.sdq.h,
                               a.sdq.t, acc0, own0, t);
    return;
  }
  store_rows<T, BC, DH, LDT>(static_cast<T*>(a.dk) + bi * a.sdk.b + hi * a.sdk.h,
                             a.sdk.t, acc0, own0, t);
  store_rows<T, BC, DH, LDT>(static_cast<T*>(a.dv) + bi * a.sdv.b + hi * a.sdv.h,
                             a.sdv.t, acc1, own0, t);
  if (want_db) {
    for (int c = tid; c < BC; c += kF32Threads)
      if (own0 + c < t) a.dbias[(long long)bh * t + own0 + c] = db_s[c];
  }
}

// ---------------------------------------------------------------------------
// chunked route (f32 and bf16 past dh 256): the plain route's arithmetic
// with the head dim in chunks
// ---------------------------------------------------------------------------
// S = Q K^T and dP = dO V^T sum over 64-column chunks of Q, K, dO and V
// staged in turn, so the [32, 32] tiles of P, dS and dBias are the plain
// route's; each block owns kOutCols output columns (grid z) of dQ (K6) or
// of dK and dV (K5), multiplies dS or P by just those columns of K, Q or
// dO, and recomputes S and dP for them.  dBias is written by the blocks
// of the first output chunk.  ~118 KB of shared memory at any head dim.
struct ChunkBwdLayout {
  static constexpr int BR = kF32Tile, BC = kF32Tile;
  static constexpr int LDC = kDhChunk + 4;   // q, dO, k, v column chunks
  static constexpr int LDO = kOutCols + 4;   // output-column operands, accumulators
  static constexpr int LDS = BC + 4;         // [BR, BC] tiles
  static constexpr int kTileC = BR * LDC, kTileO = BR * LDO, kTileS = BR * LDS;
  // q, dO, k, v chunks; two operand tiles (K, or dO and Q, at this
  // block's columns); acc0 (dK or dQ), acc1 (dV); S (then dS), dP, P,
  // dS * scale; LSE, delta, dBias
  static constexpr size_t kBytes =
      sizeof(float) * (4 * kTileC + 4 * kTileO + 4 * kTileS + 3 * BR);
};

template <typename T>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_chunked_kernel(BwdArgs a,
                                                                        bool dq_pass,
                                                                        int dh) {
  using L = ChunkBwdLayout;
  constexpr int BR = L::BR, BC = L::BC, LDC = L::LDC, LDO = L::LDO, LDS = L::LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* do_s = q_s + L::kTileC;
  float* k_s = do_s + L::kTileC;
  float* v_s = k_s + L::kTileC;
  float* oa_s = v_s + L::kTileC;      // K (K6) or dO (K5) at this block's columns
  float* ob_s = oa_s + L::kTileO;     // Q at this block's columns (K5)
  float* acc0 = ob_s + L::kTileO;
  float* acc1 = acc0 + L::kTileO;
  float* s_s = acc1 + L::kTileO;      // scores, then dS
  float* dp_s = s_s + L::kTileS;
  float* p_s = dp_s + L::kTileS;
  float* ds_s = p_s + L::kTileS;      // dS * scale
  float* lse_s = ds_s + L::kTileS;
  float* dl_s = lse_s + BR;
  float* db_s = dl_s + BR;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int bi = bh / a.h, hi = bh - bi * a.h;
  const int t = a.t;
  const int c0 = (int)blockIdx.z * kOutCols;   // this block's output columns
  const int w = min(kOutCols, dh - c0);
  const T* qp = static_cast<const T*>(a.q) + bi * a.sq.b + hi * a.sq.h;
  const T* kp = static_cast<const T*>(a.k) + bi * a.sk.b + hi * a.sk.h;
  const T* vp = static_cast<const T*>(a.v) + bi * a.sv.b + hi * a.sv.h;
  const T* dop = static_cast<const T*>(a.dout) + bi * a.sdo.b + hi * a.sdo.h;
  const float* bias = a.bias ? a.bias + (long long)bh * t : nullptr;
  const bool want_db = !dq_pass && a.dbias != nullptr && blockIdx.z == 0;
  const int n_tiles = (t + BR - 1) / BR;
  // K6 owns a query tile (heaviest causal first), K5 a key tile
  const int own0 = dq_pass ? (n_tiles - 1 - (int)blockIdx.x) * BR
                           : (int)blockIdx.x * BC;
  for (int i = tid; i < 2 * L::kTileO; i += kF32Threads) acc0[i] = 0.f;
  for (int i = tid; i < BC; i += kF32Threads) db_s[i] = 0.f;
  if (dq_pass) load_stats<BR, kF32Threads>(a, bh, own0, lse_s, dl_s);
  const int o_begin = (!dq_pass && a.causal) ? own0 : 0;
  const int o_end = (dq_pass && a.causal) ? min(t, own0 + BR) : t;
  for (int o0 = o_begin; o0 < o_end; o0 += BR) {
    const int q0 = dq_pass ? own0 : o0, k0 = dq_pass ? o0 : own0;
    if (!dq_pass) load_stats<BR, kF32Threads>(a, bh, q0, lse_s, dl_s);
    for (int d0 = 0; d0 < dh; d0 += kDhChunk) {
      __syncthreads();
      load_rows_f32<T, BR, kDhChunk, LDC, kF32Threads>(q_s, qp + d0, a.sq.t, q0, t);
      load_rows_f32<T, BR, kDhChunk, LDC, kF32Threads>(do_s, dop + d0, a.sdo.t, q0, t);
      load_rows_f32<T, BC, kDhChunk, LDC, kF32Threads>(k_s, kp + d0, a.sk.t, k0, t);
      load_rows_f32<T, BC, kDhChunk, LDC, kF32Threads>(v_s, vp + d0, a.sv.t, k0, t);
      __syncthreads();
      if (d0 == 0) {
        mm<BR, BC, kDhChunk, false, true, false>(s_s, LDS, q_s, LDC, k_s, LDC);
        mm<BR, BC, kDhChunk, false, true, false>(dp_s, LDS, do_s, LDC, v_s, LDC);
      } else {
        mm<BR, BC, kDhChunk, false, true, true>(s_s, LDS, q_s, LDC, k_s, LDC);
        mm<BR, BC, kDhChunk, false, true, true>(dp_s, LDS, do_s, LDC, v_s, LDC);
      }
    }
    if (dq_pass) {
      load_cols_f32<T, BC, kOutCols, LDO, kF32Threads>(oa_s, kp + c0, a.sk.t, k0, t, w);
    } else {
      load_cols_f32<T, BR, kOutCols, LDO, kF32Threads>(oa_s, dop + c0, a.sdo.t, q0, t, w);
      load_cols_f32<T, BR, kOutCols, LDO, kF32Threads>(ob_s, qp + c0, a.sq.t, q0, t, w);
    }
    __syncthreads();
    for (int i = tid; i < BR * BC; i += kF32Threads) {
      const int r = i / BC, c = i - r * BC;
      const float p = recompute_p(a, bias, s_s[r * LDS + c], q0 + r, k0 + c,
                                  lse_s[r]);
      const float ds = p * (dp_s[r * LDS + c] - dl_s[r]);
      p_s[r * LDS + c] = round_as<T>(p);   // as K5 rounds P for P^T dO
      s_s[r * LDS + c] = ds;
      ds_s[r * LDS + c] = round_as<T>(ds * a.scale);
    }
    __syncthreads();
    if (dq_pass) {
      mm<BR, kOutCols, BC, false, false, true>(acc0, LDO, ds_s, LDS, oa_s, LDO);
    } else {
      mm<BC, kOutCols, BR, true, false, true>(acc1, LDO, p_s, LDS, oa_s, LDO);
      mm<BC, kOutCols, BR, true, false, true>(acc0, LDO, ds_s, LDS, ob_s, LDO);
      if (want_db) {
        for (int c = tid; c < BC; c += kF32Threads) {
          float acc = 0.f;
          for (int r = 0; r < BR; ++r) acc += s_s[r * LDS + c];
          db_s[c] += acc;
        }
      }
    }
  }
  __syncthreads();
  if (dq_pass) {
    store_cols<T, BR, kOutCols, LDO>(
        static_cast<T*>(a.dq) + bi * a.sdq.b + hi * a.sdq.h + c0, a.sdq.t, acc0, own0, t, w);
    return;
  }
  store_cols<T, BC, kOutCols, LDO>(
      static_cast<T*>(a.dk) + bi * a.sdk.b + hi * a.sdk.h + c0, a.sdk.t, acc0, own0, t, w);
  store_cols<T, BC, kOutCols, LDO>(
      static_cast<T*>(a.dv) + bi * a.sdv.b + hi * a.sdv.h + c0, a.sdv.t, acc1, own0, t, w);
  if (want_db) {
    for (int c = tid; c < BC; c += kF32Threads)
      if (own0 + c < t) a.dbias[(long long)bh * t + own0 + c] = db_s[c];
  }
}

template <typename Kernel, typename... Args>
int launch(Kernel kern, size_t bytes, bool& configured, dim3 grid,
           int threads, cudaStream_t s, const Args&... args) {
  // once per instantiation, on the first (uncaptured) launch
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  kern<<<grid, threads, bytes, s>>>(args...);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_plain(const BwdArgs& a, int b, bool dq_pass, cudaStream_t s) {
  static bool configured = false;
  const dim3 grid((a.t + kF32Tile - 1) / kF32Tile, b * a.h);
  return launch(flash_bwd_plain_kernel<float, DH>, F32BwdLayout<DH>::kBytes,
                configured, grid, kF32Threads, s, a, dq_pass);
}

// the TMA maps of q, dO (boxes of q_rows rows) and k, v (k_rows rows)
template <int DH>
int make_maps(const BwdArgs& a, int b, int q_rows, int k_rows, CUtensorMap (&m)[4]) {
  int rc = make_map(&m[0], a.q, a.sq, b, a.h, a.t, DH, q_rows);
  if (!rc) rc = make_map(&m[1], a.k, a.sk, b, a.h, a.t, DH, k_rows);
  if (!rc) rc = make_map(&m[2], a.v, a.sv, b, a.h, a.t, DH, k_rows);
  if (!rc) rc = make_map(&m[3], a.dout, a.sdo, b, a.h, a.t, DH, q_rows);
  return rc;
}

// bf16 at head dims 192 and 256: 64-row tiles of every operand, one
// block a 64-key (K5) or 64-row (K6) tile
template <int DH>
int launch_wide(const BwdArgs& a, int b, bool dq_pass, cudaStream_t s) {
  CUtensorMap m[4];
  if (int rc = make_maps<DH>(a, b, kWide, kWide, m)) return rc;
  const dim3 grid(b * a.h, (a.t + kWide - 1) / kWide);
  if (dq_pass) {
    static bool configured = false;
    return launch(flash_bwd_dq_wide_kernel<DH>, WideLayout<DH>::kBytesDq, configured, grid,
                  kBwThreads, s, m[0], m[1], m[2], m[3], a);
  }
  static bool configured = false;
  return launch(flash_bwd_dkdv_wide_kernel<DH>, WideLayout<DH>::kBytesDkdv, configured, grid,
                kBwThreads, s, m[0], m[1], m[2], m[3], a);
}

// bf16 up to head dim 128 (v3): K5 reads Q/dO in 64-row tiles beside
// 128-key blocks, K6 Q/dO in 128-row blocks beside 64-key tiles
template <int DH>
int launch_v3(const BwdArgs& a, int b, bool dq_pass, cudaStream_t s) {
  CUtensorMap m[4];
  const int q_rows = dq_pass ? kDqRows : kBwRows, k_rows = dq_pass ? kDqKeys : kBwKeys;
  if (int rc = make_maps<DH>(a, b, q_rows, k_rows, m)) return rc;
  if (dq_pass) {
    static bool configured = false;
    const dim3 grid(b * a.h, (a.t + kDqRows - 1) / kDqRows);
    return launch(flash_bwd_dq_bf16_kernel<DH>, DqLayout<DH>::kBytes, configured, grid,
                  kBwThreads, s, m[0], m[1], m[2], m[3], a);
  }
  static bool configured = false;
  const dim3 grid(b * a.h, (a.t + kBwKeys - 1) / kBwKeys);
  return launch(flash_bwd_dkdv_bf16_kernel<DH>, DkdvLayout<DH>::kBytes, configured, grid,
                kBwThreads, s, m[0], m[1], m[2], m[3], a);
}

template <int DH>
int launch_dh(const BwdArgs& a, int b, int is_bf16, bool dq_pass, cudaStream_t s) {
  if (!is_bf16) return launch_plain<DH>(a, b, dq_pass, s);
  if constexpr (DH > 128)
    return launch_wide<DH>(a, b, dq_pass, s);
  else
    return launch_v3<DH>(a, b, dq_pass, s);
}

template <typename T>
int launch_chunked(const BwdArgs& a, int b, int dh, bool dq_pass, cudaStream_t s) {
  static bool configured = false;
  const dim3 grid((a.t + kF32Tile - 1) / kF32Tile, b * a.h, (dh + kOutCols - 1) / kOutCols);
  return launch(flash_bwd_chunked_kernel<T>, ChunkBwdLayout::kBytes, configured, grid,
                kF32Threads, s, a, dq_pass, dh);
}

int launch_any(const BwdArgs& a, int b, int dh, int is_bf16, bool dq_pass,
               cudaStream_t s) {
  if (dh > 256)
    return is_bf16 ? launch_chunked<__nv_bfloat16>(a, b, dh, dq_pass, s)
                   : launch_chunked<float>(a, b, dh, dq_pass, s);
  switch (dh) {
    case 64: return launch_dh<64>(a, b, is_bf16, dq_pass, s);
    case 128: return launch_dh<128>(a, b, is_bf16, dq_pass, s);
    case 192: return launch_dh<192>(a, b, is_bf16, dq_pass, s);
    default: return launch_dh<256>(a, b, is_bf16, dq_pass, s);
  }
}

int fill(BwdArgs& a, const void* q, const void* k, const void* v,
         const void* dout, const void* bias, const void* lse,
         const void* delta, const long long* strides, int b, int h, int t,
         int dh, float scale, int causal) {
  if (b <= 0 || h <= 0 || t <= 0 || !valid_head_dim(dh) || b * h > 65535)
    return (int)cudaErrorInvalidValue;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.bias = static_cast<const float*>(bias);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = a.dk = a.dv = nullptr;
  a.dbias = nullptr;
  Strides* st[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 7; ++i) *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.h = h;
  a.t = t;
  a.scale = scale;
  a.causal = causal;
  return 0;
}

}  // namespace

// Plain-C entries for ctypes.  `strides` holds the (batch, time, head)
// element strides of q, k, v, dO, dQ, dK and dV, in that order (21
// values; each entry ignores the strides of outputs it does not write).
// Each launches on `stream`, allocates nothing, does not synchronise, and
// returns cudaGetLastError() (0 on success).

// K5: dK, dV and (when dbias is non-null) dBias.
extern "C" int dl4j_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* bias,
                                   const void* lse, const void* delta, void* dk,
                                   void* dv, void* dbias,
                                   const long long* strides, int b, int h,
                                   int t, int dh, float scale, int causal,
                                   int is_bf16, void* stream) {
  BwdArgs a;
  const int rc = fill(a, q, k, v, dout, bias, lse, delta, strides, b, h, t,
                      dh, scale, causal);
  if (rc) return rc;
  a.dk = dk;
  a.dv = dv;
  a.dbias = static_cast<float*>(dbias);
  return launch_any(a, b, dh, is_bf16, false, static_cast<cudaStream_t>(stream));
}

// K6: dQ.
extern "C" int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* bias,
                                 const void* lse, const void* delta, void* dq,
                                 const long long* strides, int b, int h, int t,
                                 int dh, float scale, int causal, int is_bf16,
                                 void* stream) {
  BwdArgs a;
  const int rc = fill(a, q, k, v, dout, bias, lse, delta, strides, b, h, t,
                      dh, scale, causal);
  if (rc) return rc;
  a.dq = dq;
  return launch_any(a, b, dh, is_bf16, true, static_cast<cudaStream_t>(stream));
}
